"""The MSM sharded over a ('win', 'pts') mesh of torch devices.

The port of ``bulletproofspp_tpu/ops/sharded.py``.  The mesh axes are the
JAX package's:

  * ``pts``: data parallelism over MSM lanes.  Each entry builds tables
    and sums digit rows for its slice of the lanes;
  * ``win``: parallelism over digit-row windows.  Each entry runs a
    contiguous block of the signed-digit rows, and the window sums are
    combined by Horner with 4 x rows_local doublings between them.

Entry (w, p) runs the port's single-device ``ops.msm.msm`` on rows
[w rows_local, (w + 1) rows_local) and lanes [p L / npts, (p + 1) L /
npts), on its own device.  Point addition is a group operation, not a
ring sum, so the partials are gathered and folded by complete additions:
over ``pts`` in the JAX package's order (``_reduce_lanes``), then over
``win`` through the horner kernel, whose sum_r 16^(R-1-r) row_r with
window partial w at row w rows_local + rows_local - 1 (the other rows the
identity) is exactly sum_w 16^(rows_local (nwin-1-w)) P_w.

A mesh's entries may repeat one device: on the CPU every entry is
``cpu`` (the JAX tests' virtual CPU devices), on a box with one card
every entry can be ``cuda:0``.  Each entry is held by a rank of
``torch.distributed``; ``sharded_msm`` here runs a mesh that this
process holds whole, ``ops.dist.sharded_msm_global`` one spread over
processes.
"""

from __future__ import annotations

import dataclasses

import torch

from . import curve, kernels, limb, msm


def own_rank() -> int:
    """This process's rank in torch.distributed's group, 0 outside one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """torch devices on a (win, pts) grid and the rank that holds each entry
    (``devices[w][p]`` is held by ``ranks[w][p]``)."""

    devices: tuple
    ranks: tuple

    @property
    def shape(self) -> dict:
        return {"win": len(self.devices), "pts": len(self.devices[0])}

    def held_by(self, rank: int):
        """[(w, p, device)] of the entries ``rank`` holds, in mesh order."""
        return [(w, p, d) for w, row in enumerate(self.devices) for p, d in enumerate(row)
                if self.ranks[w][p] == rank]

    def span(self) -> set:
        """The ranks that hold an entry."""
        return {r for row in self.ranks for r in row}


def make_mesh(devices, win: int = 1, ranks=None) -> Mesh:
    """('win', 'pts') mesh over ``devices`` (torch devices or their names)
    in the order given, reshaped to (win, n / win) as ``make_mesh`` reshapes
    ``jax.devices()``.  ``ranks``: the rank holding each entry, by default
    this process."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    ranks = [own_rank()] * n if ranks is None else list(ranks)
    if len(ranks) != n:
        raise ValueError(f"{len(ranks)} ranks for {n} devices")
    if n == 0 or win < 1 or n % win != 0:
        raise ValueError(f"device count {n} not divisible by win={win}")
    npts = n // win
    if npts & (npts - 1):
        raise ValueError(
            f"'pts' axis size {npts} must be a power of two: sharded_msm splits the "
            f"(power-of-two) padded lane bucket evenly across point shards.  Use a win "
            f"factor that leaves a power-of-two pts axis, or drop extra devices.")
    grid = [tuple(range(w * npts, (w + 1) * npts)) for w in range(win)]
    return Mesh(tuple(tuple(devices[i] for i in row) for row in grid),
                tuple(tuple(ranks[i] for i in row) for row in grid))


def device_entries(device, n: int, start: int = 0) -> list:
    """n mesh entries of ``device``'s kind: ``cpu`` n times, a CUDA card
    named by index n times, and plain ``cuda`` the cards in turn from entry
    ``start`` (``cuda:0`` for every entry on a box with one card)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device] * n
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("mesh entries on cuda: CUDA is not available")
    return [torch.device("cuda", (start + i) % cards) for i in range(n)]


def pad_rows(absd, sgn, win: int):
    """Pad (B, ROWS, L) digit rows with zero rows on the most significant
    side (zero digits are no-ops) so the row count divides ``win``."""
    batch, rows, L = absd.shape
    pad = -(-rows // win) * win - rows
    if pad:
        z = torch.zeros((batch, pad, L), dtype=absd.dtype, device=absd.device)
        absd = torch.cat([z, absd], 1)
        sgn = torch.cat([z.to(sgn.dtype), sgn], 1)
    return absd, sgn


def shard_sizes(mesh: Mesh, absd):
    """(rows_local, lanes a shard) of (B, ROWS, L) digits on ``mesh``; raises
    where they do not split."""
    nwin, npts = mesh.shape["win"], mesh.shape["pts"]
    _, rows, L = absd.shape
    width = L // npts
    if rows % nwin:
        raise ValueError(f"{rows} digit rows do not divide win={nwin} (pad_rows)")
    if L % npts or width & (width - 1):
        raise ValueError(f"{L} lanes do not split into a power of two a shard over pts={npts}")
    return rows // nwin, width


def shard_partials(mesh: Mesh, rank: int, px, py, pz, absd, sgn) -> list:
    """Projective (3, 16, B) partial of each entry ``rank`` holds, in mesh
    order, each on its entry's device: ``msm.msm`` over the entry's rows
    and lanes.  px/py/pz (16, B, L) on any device; absd/sgn (B, ROWS, L)
    integers on any device (each entry's share goes to its device as the
    kernels' uint8 planes)."""
    rows_local, width = shard_sizes(mesh, absd)
    out = []
    for w, p, dev in mesh.held_by(rank):
        lanes = slice(p * width, (p + 1) * width)
        rows = slice(w * rows_local, (w + 1) * rows_local)
        pts = (c[:, :, lanes].to(dev).contiguous() for c in (px, py, pz))
        dig = (d[:, rows, lanes].to(dev, torch.uint8).contiguous() for d in (absd, sgn))
        out.append(torch.stack(msm.msm(*pts, *dig)))
    return out


def reduce_lanes(p, width: int):
    """Complete additions over the last axis in the order of the JAX
    package's ``_reduce_lanes`` (``bulletproofspp_tpu/ops/msm.py:81``):
    radix-8 levels (4 or 2 where 8 does not divide), each level's groups
    of adjacent lanes summed pairwise.  (16, ..., width) -> (16, ...)."""
    if width & (width - 1):
        raise ValueError(f"lane count {width} must be a power of two")
    while width > 1:
        radix = 8 if width % 8 == 0 else (4 if width % 4 == 0 else 2)
        groups = width // radix
        resh = tuple(t.reshape(*t.shape[:-1], groups, radix) for t in p)
        parts = [tuple(t[..., i] for t in resh) for i in range(radix)]
        while len(parts) > 1:
            parts = [curve.padd(parts[i], parts[i + 1]) for i in range(0, len(parts), 2)]
        p = parts[0]
        width = groups
    return tuple(t[..., 0] for t in p)


def combine(mesh: Mesh, partials, rows_local: int):
    """All entries' (3, 16, B) partials, in mesh order (one (n, 3, 16, B)
    tensor), -> projective (16, B) planes on the partials' device: the
    ``pts`` fold, then Horner over ``win`` (the horner kernel)."""
    nwin, npts = mesh.shape["win"], mesh.shape["pts"]
    parts = partials.reshape(nwin, npts, 3, limb.NLIMB, -1)
    # (16, nwin, B, npts) planes: the pts fold runs over the last axis
    acc = reduce_lanes(tuple(parts[:, :, c].permute(2, 0, 3, 1) for c in range(3)), npts)
    if nwin == 1:
        return tuple(t[:, 0] for t in acc)
    batch = acc[0].shape[2]
    rows = curve.identity((batch, nwin * rows_local), partials.device)
    for c, a in zip(rows, acc):
        c[:, :, rows_local - 1::rows_local] = a.permute(0, 2, 1)
    return kernels.horner(*rows)


def sharded_msm(mesh: Mesh, px, py, pz, absd, sgn):
    """MSM sharded over ('win', 'pts') on a mesh this process holds whole;
    returns projective (16, B) planes on the mesh's first device.

    px/py/pz: (16, B, L) projective lanes; absd/sgn: (B, ROWS, L) digit
    magnitudes and signs.  The lane count must split over 'pts' into a
    power of two a shard; the row count must divide 'win' (``pad_rows``)."""
    rank = own_rank()
    if mesh.span() != {rank}:
        raise ValueError(f"sharded_msm runs a mesh held by this process (rank {rank}) alone; "
                         f"this one spans ranks {sorted(mesh.span())}: use "
                         f"ops.dist.sharded_msm_global")
    rows_local, _ = shard_sizes(mesh, absd)
    home = mesh.devices[0][0]
    parts = [t.to(home) for t in shard_partials(mesh, rank, px, py, pz, absd, sgn)]
    return combine(mesh, torch.stack(parts), rows_local)
