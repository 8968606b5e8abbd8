"""Device layer of the PyTorch port: field, curve, kernels, MSM, engine."""
