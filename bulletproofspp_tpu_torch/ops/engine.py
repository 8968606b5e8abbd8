"""TorchEngine: the protocol layer's engine on PyTorch tensors.

The port of ``bulletproofspp_tpu/ops/engine.py: JaxEngine``.  The
protocol layer (``bulletproofspp_tpu.core``) calls it through the engine
interface of ``core/engine.py``; it plugs in with
``core.engine.set_default_engine(TorchEngine(device))``.  Host work per
call is the exact-integer GLV split and digit recoding (``native`` /
``ops.glv``) and limb packing; all field and curve arithmetic runs on
the engine's device, for every size (there is no host shortcut).

Base vectors are ``DevicePoints``: projective (16, n) strict planes that
stay on the device across argument rounds.  Lane counts are padded to
power-of-two buckets (at least 16) with identity lanes and zero digits.
Results equal ``HostEngine``'s exactly.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from bulletproofspp_tpu import metrics
from bulletproofspp_tpu.core.fields import Q, R

from .. import native
from . import curve, glv, limb, msm

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


def _dp_cat(parts):
    return DevicePoints(*(torch.cat([p.coords()[c] for p in parts], -1) for c in range(3)))


def _dp_pad(dp: DevicePoints, m: int) -> DevicePoints:
    k = m - len(dp)
    if k <= 0:
        return dp
    return _dp_cat([dp, DevicePoints(*curve.identity((k,), dp.x.device))])


def _dp_slice(dp: DevicePoints, n: int) -> DevicePoints:
    if n >= len(dp):
        return dp
    return DevicePoints(*(c[:, :n] for c in dp.coords()))


def _interleave_endo(x, y, z):
    """(16, ..., n) lanes -> (16, ..., 2n) [P_i, phi(P_i)] interleaved lanes."""
    e = curve.endo((x, y, z))
    return tuple(
        torch.stack([a, b], -1).reshape(*a.shape[:-1], -1) for a, b in zip((x, y, z), e)
    )


class TorchEngine:
    """Device-backed engine; ``device`` ("cuda", "cuda:0", "cpu") is required."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchEngine({device!r}): CUDA is not available")
        self._bv_cache: OrderedDict = OrderedDict()

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
        hit = self._bv_cache.get(key)
        if hit is not None and hit[0] is points:
            self._bv_cache.move_to_end(key)
            return hit[1]
        bv = self.basevec(pts)
        self._bv_cache[key] = (points, bv)
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
        bv = self.basevec(bv)
        even = DevicePoints(*(c[:, 0::2] for c in bv.coords()))
        odd = DevicePoints(*(c[:, 1::2] for c in bv.coords()))
        return even, _dp_pad(odd, len(even))

    # -- msm -----------------------------------------------------------------
    def msm_groups(self, groups):
        return self.msm_many([groups])[0]

    def msm_pair(self, groups_a, groups_b):
        return tuple(self.msm_many([groups_a, groups_b]))

    def msm_many(self, groups_list):
        """K independent MSMs behind ONE stacked digit upload and ONE
        device-to-host copy of normalized planes; affine conversion on the
        host.  Entry assembly (slice, concatenate, [P, phi(P)] interleave,
        identity padding, stacking) runs on the device."""
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
        digits = np.zeros((2, K, glv.ROWS, L), np.int64)
        lanes = []
        off = 0
        for k, (comps, count) in enumerate(entries):
            w = 2 * count
            digits[0, k, :, :w] = absd_all[:, 2 * off : 2 * off + w]
            digits[1, k, :, :w] = sgn_all[:, 2 * off : 2 * off + w]
            off += count
            lanes.append(_dp_pad(_dp_cat([_dp_slice(bv, n) for bv, n in comps]), L // 2))
        # one endomorphism over all K entries (identity padding maps to itself)
        px, py, pz = _interleave_endo(
            *(torch.stack([dp.coords()[c] for dp in lanes], 1) for c in range(3))
        )
        dig = limb.planes_from_numpy(digits, self.device)
        acc = msm.msm(px, py, pz, dig[0], dig[1])
        pts = curve.affine_from_normalized(limb.planes_to_numpy(curve.normalize3(*acc)))
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
    def fold_bv(self, b: int, a: int, even, odd):
        """b E_i + a O_i lanes, projective, kept on the device."""
        even = self.basevec(even)
        odd = self.basevec(odd)
        n = len(even)
        L = _bucket(n)
        de, se = native.recode_signed(int(b))
        do, so = native.recode_signed(int(a))
        out = msm.fold_mul(_dp_pad(even, L).coords(), _dp_pad(odd, L).coords(), de, se, do, so)
        return _dp_slice(DevicePoints(*out), n)

    def complete_square(self, r: int, g0s, g1s):
        """(g1 + r g0, g1 - r g0) as device base vectors."""
        g0 = self.basevec(g0s)
        g1 = self.bv_pad(self.basevec(g1s), len(g0))
        k1, k2 = glv.split(int(r) % R)
        de, se = native.recode_signed(k1)
        do, so = native.recode_signed(k2)
        n = len(g0)
        L = _bucket(n)
        gx, hy = msm.complete_square(
            _dp_pad(g0, L).coords(), _dp_pad(g1, L).coords(), de, se, do, so
        )
        return _dp_slice(DevicePoints(*gx), n), _dp_slice(DevicePoints(*hy), n)
