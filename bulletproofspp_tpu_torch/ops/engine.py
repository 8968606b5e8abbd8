"""TorchEngine: the protocol layer's engine on PyTorch tensors.

The port of ``bulletproofspp_tpu/ops/engine.py: JaxEngine``.  The
port's protocol layer (``bulletproofspp_tpu_torch.core``) calls it through
the engine interface of ``core/engine.py``; ``core.engine.default_engine``
makes one on the CUDA card, and ``set_default_engine(TorchEngine(device))``
picks another device.  Host work per
call is the exact-integer GLV split and digit recoding (``native`` /
``ops.glv``) and limb packing; all field and curve arithmetic runs on
the engine's device, for every size (there is no host shortcut).

Base vectors are ``DevicePoints``: projective (16, n) strict planes that
stay on the device across argument rounds.  Lane counts are padded to
power-of-two buckets (at least 16) with identity lanes and zero digits.
Every padding, concatenation, stacking, even/odd split and [P, phi(P)]
interleave of base vectors runs in one ``kernels.assemble`` launch a call
(the JAX package's compiled ``_assemble_many_body`` / ``_assemble_fold``;
none where every base already is a contiguous bucket): slices stay views
until it reads them.  Results equal ``HostEngine``'s exactly.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import metrics, native
from ..core import ec
from ..core.fields import Q, R
from . import curve, glv, kernels, limb, msm

BV_CACHE_MAX = 64


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class DevicePoints:
    """Projective point lanes resident on the engine's device."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def __len__(self):
        return self.x.shape[-1]

    def coords(self):
        return self.x, self.y, self.z

    def to_host(self):
        return curve.to_affine_host(self.coords())

    @classmethod
    def from_numpy(cls, x, y, z, device):
        """From the JAX package's layout: numpy (16, n) uint32 planes."""
        return cls(*(limb.planes_from_numpy(a, device) for a in (x, y, z)))


def _assemble(outputs, L: int, interleave: bool = False):
    """``kernels.assemble`` over DevicePoints: ``outputs`` holds S lists of K
    entries, an entry a list of DevicePoints laid end to end; returns S
    (16, K, L) coords, each entry padded with the identity (one launch)."""
    return kernels.assemble([[[dp.coords() for dp in entry] for entry in entries]
                             for entries in outputs], L, interleave)


def _padded(dps, L: int) -> list:
    """Each DevicePoints padded with the identity to L lanes, contiguous:
    one assemble launch for all of them, or none where each already is
    one."""
    if all(len(dp) == L and all(c.is_contiguous() for c in dp.coords()) for dp in dps):
        return list(dps)
    return [DevicePoints(*(c[:, 0] for c in out)) for out in _assemble([[[dp]] for dp in dps], L)]


def _dp_pad(dp: DevicePoints, m: int) -> DevicePoints:
    return dp if m <= len(dp) else _padded([dp], m)[0]


def _dp_slice(dp: DevicePoints, n: int) -> DevicePoints:
    if n >= len(dp):
        return dp
    return DevicePoints(*(c[:, :n] for c in dp.coords()))


def _dp_stacks(stacks, L: int):
    """Each list of DevicePoints of ``stacks`` padded to L lanes each, end to
    end, in one assemble launch: a (16, B L) coords triple a list."""
    return [tuple(c.reshape(limb.NLIMB, -1) for c in out)
            for out in _assemble([[[dp] for dp in dps] for dps in stacks], L)]


def _dp_unstack(coords, count: int, L: int, n: int):
    """(16, B L) coords -> B DevicePoints, the first n of each L lanes."""
    return [DevicePoints(*(c[:, i * L:i * L + n] for c in coords)) for i in range(count)]


def _interleave_endo(x, y, z):
    """(16, ..., n) lanes -> (16, ..., 2n) [P_i, phi(P_i)] interleaved lanes
    (one endo launch on the card)."""
    return curve.endo((x, y, z), interleave=True)


class TorchEngine:
    """Device-backed engine; ``device`` ("cuda", "cuda:0", "cpu") is required."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchEngine({device!r}): CUDA is not available")
        self._bv_cache: OrderedDict = OrderedDict()
        # the lockstep prover's threads share the engine, and with it the cache
        self._bv_lock = threading.Lock()

    # -- point decompression -------------------------------------------------
    def decompress(self, xs, signs):
        """[(x, sign)] -> [affine point | None]: one batched device sqrt."""
        n = len(xs)
        if n == 0:
            return []
        L = _bucket(n)
        xs_pad = [int(x) % Q for x in xs] + [0] * (L - n)
        x = limb.from_ints(xs_pad, self.device)
        sg = limb.planes_from_numpy([1 if s else 0 for s in signs] + [0] * (L - n), self.device)
        y, ok = curve.decompress(x, sg)
        ys = limb.unpack_ints(y)
        oks = ok.cpu().tolist()
        return [((xs_pad[i], ys[i]) if oks[i] else None) for i in range(n)]

    # -- base-vector ops -----------------------------------------------------
    def basevec_cached(self, points):
        """DevicePoints for a STABLE host-side basis (a setup's base list or
        a single point), packed once and kept in a bounded LRU.  The cache
        holds a strong reference to the keyed object, so a dead list's id
        can never be reused for a different basis."""
        if isinstance(points, DevicePoints):
            return points
        if isinstance(points, tuple):  # single affine point
            key, pts = points, [points]
        else:
            key, pts = id(points), points
        with self._bv_lock:
            hit = self._bv_cache.get(key)
            if hit is not None and hit[0] is points:
                self._bv_cache.move_to_end(key)
                return hit[1]
        bv = self.basevec(pts)  # outside the lock: two misses of one key both pack it
        with self._bv_lock:
            self._bv_cache[key] = (points, bv)
            self._bv_cache.move_to_end(key)
            while len(self._bv_cache) > BV_CACHE_MAX:
                self._bv_cache.popitem(last=False)
        return bv

    def basevec(self, points) -> DevicePoints:
        if isinstance(points, DevicePoints):
            return points
        return DevicePoints(*curve.from_affine_host(list(points), self.device))

    def bv_pad(self, bv, m: int) -> DevicePoints:
        return _dp_pad(self.basevec(bv), m)

    def bv_split(self, bv):
        """Even and odd lanes, the odd padded to the even's count: both
        halves read in place (stride 2) by one assemble launch."""
        bv = self.basevec(bv)
        even, odd = (DevicePoints(*(c[:, s::2] for c in bv.coords())) for s in (0, 1))
        out = _assemble([[[even]], [[odd]]], len(even))
        return tuple(DevicePoints(*(c[:, 0] for c in half)) for half in out)

    # -- msm -----------------------------------------------------------------
    def msm_groups(self, groups):
        return self.msm_many([groups])[0]

    def msm_pair(self, groups_a, groups_b):
        return tuple(self.msm_many([groups_a, groups_b]))

    def msm_many(self, groups_list):
        """K independent MSMs behind ONE stacked digit upload and ONE
        device-to-host copy of normalized planes; affine conversion on the
        host.  Entry assembly (slice, concatenate, [P, phi(P)] interleave,
        identity padding, stacking) is one assemble launch for all K
        (``bulletproofspp_tpu/ops/engine.py:186-220``)."""
        entries = []
        empty = set()
        all_scalars: list = []
        for idx, groups in enumerate(groups_list):
            comps = []
            count = 0
            for svec, bv in groups:
                svals = [int(s) % R for s in svec]
                bv = self.basevec(bv)
                n = min(len(svals), len(bv))
                if n == 0:
                    continue
                comps.append((bv, n))
                all_scalars.extend(svals[:n])
                count += n
            if not comps:  # empty MSM: the identity (None)
                empty.add(idx)
            else:
                entries.append((comps, count))
        if not entries:
            return [None] * len(groups_list)
        metrics.count("engine.msm.lanes", 2 * len(all_scalars))

        absd_all, sgn_all = native.glv_recode_batch(all_scalars)
        K = len(entries)
        L = _bucket(2 * max(c for _, c in entries))
        digits = np.zeros((2, K, glv.ROWS, L), np.uint8)  # 1/8 of int64's upload
        off = 0
        for k, (comps, count) in enumerate(entries):
            w = 2 * count
            digits[0, k, :, :w] = absd_all[:, 2 * off : 2 * off + w]
            digits[1, k, :, :w] = sgn_all[:, 2 * off : 2 * off + w]
            off += count
        (px, py, pz), = _assemble(
            [[[_dp_slice(bv, n) for bv, n in comps] for comps, _ in entries]], L, interleave=True)
        dig = torch.from_numpy(digits).to(self.device)  # uint8: every kernel reads bytes
        acc = msm.msm(px, py, pz, dig[0], dig[1], canonical=True)
        pts = curve.affine_from_normalized(limb.planes_to_numpy(acc))
        if not empty:
            return pts
        it = iter(pts)
        return [None if idx in empty else next(it) for idx in range(len(groups_list))]

    def msm(self, pairs):
        """One MSM over host (scalar, affine point | None) pairs."""
        flt = [(int(s) % R, p) for s, p in pairs]
        flt = [(s, p) for s, p in flt if s != 0 and p is not None]
        if not flt:
            return None
        return self.msm_many([[([s for s, _ in flt], [p for _, p in flt])]])[0]

    # -- basis folding and square completion ---------------------------------
    def _fold_args(self, b: int, a: int, even, odd):
        """``msm.fold_mul``'s arguments for b E_i + a O_i (the lanes padded
        to their bucket with the identity, the digit rows of b and a), and
        the lane count n."""
        even = self.basevec(even)
        odd = self.basevec(odd)
        n = len(even)
        L = _bucket(n)
        de, se = native.recode_signed(int(b))
        do, so = native.recode_signed(int(a))
        pe, po = _padded([even, odd], L)
        return (pe.coords(), po.coords(), de, se, do, so), n

    def fold_bv(self, b: int, a: int, even, odd):
        """b E_i + a O_i lanes, projective, kept on the device."""
        args, n = self._fold_args(b, a, even, odd)
        return _dp_slice(DevicePoints(*msm.fold_mul(*args)), n)

    def complete_square(self, r: int, g0s, g1s):
        """(g1 + r g0, g1 - r g0) as device base vectors: one complete_square
        launch."""
        g0, g1 = self.basevec(g0s), self.basevec(g1s)
        k1, k2 = glv.split(int(r) % R)
        de, se = native.recode_signed(k1)
        do, so = native.recode_signed(k2)
        n = len(g0)
        L = _bucket(n)
        p0, p1 = _padded([g0, g1], L)  # g1 padded to len(g0), then both to L
        gx, hy = msm.complete_square(p0.coords(), p1.coords(), de, se, do, so)
        return _dp_slice(DevicePoints(*gx), n), _dp_slice(DevicePoints(*hy), n)

    # -- the same on host affine lists (``bulletproofspp_tpu/ops/engine.py:547-587``)
    def fold_bases(self, b: int, a: int, g_even, g_odd):
        """b E_i + a O_i lanes as host affine points / None (None lanes are
        the identity): one fold and one affine conversion on the device
        (``msm.run_fold``), then one copy."""
        if len(g_even) == 0:
            return []
        args, n = self._fold_args(b, a, g_even, g_odd)
        return curve.affine_lanes_to_host(*msm.run_fold(*args))[:n]

    def shared_mul(self, k: int, pts):
        """k P_i lanes as host affine points / None: k split into its GLV
        halves (k1, k2), one fold of (P_i, phi(P_i)) with them and one affine
        conversion on the device, then one copy."""
        if len(pts) == 0:
            return []
        p = self.basevec(pts)
        n = len(p)
        pe = _padded([p], _bucket(n))[0].coords()
        k1, k2 = glv.split(int(k) % R)
        out = msm.run_fold(pe, curve.endo(pe), *native.recode_signed(k1), *native.recode_signed(k2))
        return curve.affine_lanes_to_host(*out)[:n]

    # -- the same for N lockstep provers at once -------------------------------
    def fold_bv_many(self, calls):
        """``fold_bv`` for N lockstep provers: calls is a list of (b, a, even,
        odd) with identical shapes; one table_flat launch a basis and one
        batched fold launch for all of them
        (``bulletproofspp_tpu/ops/engine.py:511``)."""
        if len(calls) == 1:
            return [self.fold_bv(*calls[0])]
        evens, odds, digits = [], [], []
        for b, a, even, odd in calls:
            even, odd = self.basevec(even), self.basevec(odd)
            if evens and len(even) != len(evens[0]):
                raise ValueError("lockstep fold requires identical shapes across provers")
            evens.append(even)
            odds.append(odd)
            digits.append(np.stack([*native.recode_signed(int(b)), *native.recode_signed(int(a))]))
        n = len(evens[0])
        L = _bucket(n)
        out = msm.fold_mul_many(*_dp_stacks([evens, odds], L), np.stack(digits))
        return _dp_unstack(out, len(calls), L, n)

    def complete_square_many(self, calls):
        """``complete_square`` for N lockstep provers: calls is a list of (r,
        g0s, g1s) with identical shapes; one complete_square launch a 16 of
        them (``bulletproofspp_tpu/ops/engine.py:477``)."""
        if len(calls) == 1:
            return [self.complete_square(*calls[0])]
        g0s, g1s, digits = [], [], []
        for r, g0, g1 in calls:
            g0, g1 = self.basevec(g0), self.basevec(g1)
            # g1 counts as padded to len(g0), as in complete_square
            shape = (len(g0), max(len(g0), len(g1)))
            if g0s and shape != (len(g0s[0]), max(len(g0s[0]), len(g1s[0]))):
                raise ValueError("lockstep complete_square requires identical shapes")
            g0s.append(g0)
            g1s.append(g1)
            k1, k2 = glv.split(int(r) % R)
            digits.append(np.stack([*native.recode_signed(k1), *native.recode_signed(k2)]))
        n = len(g0s[0])
        L = _bucket(n)
        gx, hy = msm.complete_square_many(*_dp_stacks([g0s, g1s], L), np.stack(digits))
        return list(zip(_dp_unstack(gx, len(calls), L, n), _dp_unstack(hy, len(calls), L, n)))


class ShardedTorchEngine(TorchEngine):
    """TorchEngine whose big MSMs run sharded over a mesh of devices
    (``ops.sharded``): lanes data-parallel over the 'pts' axis, digit rows
    over the 'win' axis.  MSMs under ``shard_above`` lanes, and every other
    engine call, take TorchEngine's single-device path on ``device``
    (``bulletproofspp_tpu/ops/engine.py: ShardedJaxEngine``).

    ``mesh``: an ``ops.sharded.make_mesh`` mesh, or in a multi-process run
    ``ops.dist.global_mesh``'s, which must span every process; by default
    one entry on ``device``, or on each card for plain ``cuda``.  This is
    the batch-verification engine: N merged proofs make one MSM over the
    mesh."""

    def __init__(self, device, mesh=None, shard_above: int = 256):
        super().__init__(device)
        from . import dist, sharded

        if mesh is None:
            n = torch.cuda.device_count() if self.device.type == "cuda" else 1
            mesh = sharded.make_mesh(sharded.device_entries(self.device, n))
        npts = mesh.shape["pts"]
        if npts & (npts - 1):
            raise ValueError(f"'pts' mesh axis size {npts} must be a power of two "
                             "(lane buckets are powers of two and must split evenly)")
        # a multi-process mesh that leaves out a process cannot run the gather
        # at all: refuse it here rather than at the first msm
        if dist.is_multiprocess():
            dist.require_global(mesh)
        mine = mesh.held_by(sharded.own_rank())
        if not mine:
            raise ValueError(f"this process (rank {sharded.own_rank()}) holds no entry of the mesh")
        self.mesh = mesh
        self._home = mine[0][2]  # where the lanes are built and the partials folded
        self.shard_above = shard_above

    def msm(self, pairs):
        """One MSM over host (scalar, affine point | None) pairs: sharded over
        the mesh from ``shard_above`` lanes (2 a pair), lanes padded to
        max(bucket, 16 x npts) with G and zero digits, rows to a multiple of
        'win' with zero rows."""
        flt = [(int(s) % R, p) for s, p in pairs]
        flt = [(s, p) for s, p in flt if s != 0 and p is not None]
        if 2 * len(flt) < max(self.shard_above, 1):
            return super().msm(flt)
        from . import dist, sharded

        metrics.count("engine.msm.lanes", 2 * len(flt))
        n = len(flt)
        L = max(_bucket(2 * n), 16 * self.mesh.shape["pts"])
        absd, sgn = native.glv_recode_batch([s for s, _ in flt])
        digits = np.zeros((2, 1, glv.ROWS, L), np.uint8)
        digits[0, 0, :, :2 * n], digits[1, 0, :, :2 * n] = absd, sgn
        absd, sgn = sharded.pad_rows(*torch.from_numpy(digits), self.mesh.shape["win"])
        pts = [p for _, p in flt] + [ec.G] * (L // 2 - n)
        lanes = _interleave_endo(*curve.from_affine_host(pts, self._home))
        acc = dist.sharded_msm_global(self.mesh, *(c.unsqueeze(1) for c in lanes), absd, sgn)
        return curve.to_affine_host(acc)[0]
