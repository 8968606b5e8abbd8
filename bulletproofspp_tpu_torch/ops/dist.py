"""The multi-process runtime of the sharded MSM on ``torch.distributed``.

The port of ``bulletproofspp_tpu/ops/dist.py``.  Fiat-Shamir stays
replicated on the host: every process derives the same challenges from
the same transcripts and so holds the same MSM inputs.  A process slices
the lanes and rows of the mesh entries it holds from its own copy, so the
only traffic between processes is the MSM's partials, 3 x 16 int64 words
a shard, gathered over gloo through host tensors.  That also serves ranks
that share one card; no NCCL is needed.

Importing this module starts no process group: ``initialize_from_env``
does, where the environment names a coordinator.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .. import metrics
from . import sharded

# a rank that never joins a rendezvous or a collective fails the others
# after this long (torch's own default is 30 minutes)
TIMEOUT = datetime.timedelta(minutes=5)


def initialize_from_env() -> bool:
    """Join a gloo process group if ``BPPP_COORDINATOR`` is set (host:port,
    with ``BPPP_NUM_PROCS`` and ``BPPP_PROC_ID``); returns whether it did."""
    coord = os.environ.get("BPPP_COORDINATOR")
    if not coord:
        return False
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}", world_size=int(os.environ["BPPP_NUM_PROCS"]),
        rank=int(os.environ["BPPP_PROC_ID"]), timeout=TIMEOUT,
    )
    return True


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(win: int, local_devices) -> sharded.Mesh:
    """('win', 'pts') mesh over every process's ``local_devices``, process-
    major (rank 0's entries first), as ``global_mesh`` orders
    ``jax.devices()``: with win = the process count the 'win' axis spans the
    processes, with win = 1 the 'pts' axis does.  Every rank passes as many
    local devices; their names are gathered so that each rank's mesh is the
    same."""
    local = [str(torch.device(d)) for d in local_devices]
    if not is_multiprocess():
        return sharded.make_mesh(local, win)
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, local)
    if len({len(n) for n in names}) != 1:
        raise ValueError(f"ranks hold different numbers of mesh entries: {names}")
    return sharded.make_mesh([d for per in names for d in per], win,
                             [r for r, per in enumerate(names) for _ in per])


def require_global(mesh: sharded.Mesh):
    """Raises unless ``mesh`` spans every rank, process-major, with as many
    entries on each: the layout the gather of ``sharded_msm_global``
    assumes (``global_mesh`` builds it)."""
    world = dist.get_world_size() if is_multiprocess() else 1
    flat = [r for row in mesh.ranks for r in row]
    if flat != [r for r in range(world) for _ in range(len(flat) // world)]:
        raise ValueError(f"a mesh over all {world} processes, process-major, is needed (this one "
                         f"holds ranks {flat}); build it with ops.dist.global_mesh()")


def sharded_msm_global(mesh: sharded.Mesh, px, py, pz, absd, sgn):
    """``sharded.sharded_msm`` over a mesh spread across processes: this
    rank runs its own entries, the partials of all entries are gathered
    through host tensors, and every rank folds them in the same order on
    its first entry's device, so the (16, B) result is the same on every
    rank.  A mesh held by this process alone skips the gather."""
    if not is_multiprocess():
        return sharded.sharded_msm(mesh, px, py, pz, absd, sgn)
    require_global(mesh)
    rank = dist.get_rank()
    mine = mesh.held_by(rank)
    rows_local, _ = sharded.shard_sizes(mesh, absd)
    local = torch.stack([t.cpu() for t in sharded.shard_partials(mesh, rank, px, py, pz, absd,
                                                                  sgn)])
    gathered = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    with metrics.timer("dist.all_gather"):
        dist.all_gather(gathered, local)
    # process-major: rank r's entries are the r-th block of mesh order
    return sharded.combine(mesh, torch.cat(gathered).to(mine[0][2]), rows_local)
