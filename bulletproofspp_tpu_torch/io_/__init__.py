"""Config / JSON schema layer (reference: app/Parse.hs)."""
