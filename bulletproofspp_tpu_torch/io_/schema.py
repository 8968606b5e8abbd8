"""JSON proof-schema and witness parsing (reference: app/Parse.hs).

The schema is part of the verification contract: proofs cannot be decoded
or verified without it (reference: README.md:147-149).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.fields import Q
from ..core.utils import approx_log_w
from ..core import binary_rp, typed_reciprocal
from ..core.norm_linear import NormLinearNL
from ..core.inner_product import NormLinearIP


class SchemaError(ValueError):
    pass


@dataclass
class PublicSpec:
    """(reference: Parse.hs:218-235)."""

    amount: int
    kind: int = 0
    blind: int | None = None
    is_output: bool = False


@dataclass
class ProofSpec:
    """Parsed schema (reference: Parse.hs:88-172)."""

    is_binary: bool
    arg_cls: type
    basis_seed: str | None  # None => read points from basis_file
    basis_file: str
    random_seed: str
    conserved: bool  # typed || conserved for reciprocal proofs
    ranges: list  # RangeDataB or RangeDataT, already replicated by count
    publics: list


def _parse_arg(s: str):
    s = s.lower()
    if s in ("ip", "innerproduct"):
        return NormLinearIP
    if s in ("nl", "normlinear"):
        return NormLinearNL
    raise SchemaError(f"Unsupported Argument: {s}")


def parse_spec(obj: dict) -> ProofSpec:
    curve = obj.get("curve", "secp256k1")
    if str(curve).lower() != "secp256k1":
        raise SchemaError(f"Unsupported Curve: {curve}")
    arg_cls = _parse_arg(obj.get("argument", "IP"))
    basis_seed = obj.get("basisSeed")
    basis_file = obj.get("basisFile")
    if basis_seed is not None and basis_file is not None:
        raise SchemaError("Cannot specify both point file and seed")
    if basis_file is None:
        basis_file = "points.bin"
    random_seed = obj.get("randomSeed", "default random seed")
    typed = bool(obj.get("typed", False))
    conserved = bool(obj.get("conserved", False))
    is_binary = bool(obj.get("binary", False))
    if typed and is_binary:
        raise SchemaError("Can't make typed binary proof")

    publics = []
    for pub in obj.get("public", []):
        ps = PublicSpec(
            amount=int(pub["amount"]),
            kind=int(pub.get("type", 0)),
            blind=pub.get("blind"),
            is_output=bool(pub.get("isOutput", False)),
        )
        if ps.blind is not None:
            raise SchemaError("Cannot have blinding on public value")
        if is_binary and ps.kind != 0:
            raise SchemaError("Cannot have type of public value in binary proof")
        publics.append(ps)

    ranges = []
    for r in obj["ranges"]:
        count = int(r.get("count", 1))
        rmin = int(r.get("min", 0))
        rmax = int(r.get("max", 2**64))
        is_o = bool(r.get("isOutput", False))
        is_a = bool(r.get("isAssumed", False))
        if is_binary:
            base = r.get("base")
            if base is not None and int(base) != 2:
                raise SchemaError("Invalid base for binary range proof")
            if r.get("isShared"):
                raise SchemaError("Cannot share digits in binary range proof")
            rd = binary_rp.make_range_data_binary(Q, rmin, rmax, is_o, is_a)
        else:
            # dict.get evaluates its default eagerly: approx_log_w raises
            # ZeroDivisionError on tiny widths even when "base" is present
            base = int(r["base"]) if "base" in r else approx_log_w(rmax - rmin)
            is_s = bool(r.get("isShared", False))
            rd = typed_reciprocal.make_range_data(Q, base, rmin, rmax, is_s, is_o, is_a)
        if rd is None:
            raise SchemaError(f"Invalid range: {r}")
        ranges.extend([rd] * count)

    return ProofSpec(
        is_binary=is_binary,
        arg_cls=arg_cls,
        basis_seed=basis_seed,
        basis_file=basis_file,
        random_seed=random_seed,
        conserved=typed or conserved,
        ranges=ranges,
        publics=publics,
    )


def parse_witness(obj: list) -> list[PublicSpec]:
    """Witness JSON: list of {amount, type?, blind?} (reference: Parse.hs:218-235)."""
    return [
        PublicSpec(
            amount=int(w["amount"]),
            kind=int(w.get("type", 0)),
            blind=(int(w["blind"]) if "blind" in w and w["blind"] is not None else None),
            is_output=bool(w.get("isOutput", False)),
        )
        for w in obj
    ]


def build_setup(spec: ProofSpec, points: list):
    """Construct the protocol setup from a parsed spec + basis points
    (reference: app/Main.hs:283-335)."""
    if spec.is_binary:
        net_pub = sum(-p.amount if p.is_output else p.amount for p in spec.publics)
        setup = binary_rp.SetupBRP.make(spec.arg_cls, points, spec.conserved, spec.ranges, net_pub)
    else:
        pub_vt = [(p.is_output, p.kind, p.amount) for p in spec.publics]
        setup = typed_reciprocal.SetupTRRP.make(spec.arg_cls, points, spec.conserved, pub_vt, spec.ranges)
    if setup is None:
        raise SchemaError("setup failed (insufficient basis points or invalid ranges)")
    return setup


def points_needed(spec: ProofSpec) -> int:
    """Upper bound on basis points the setup consumes."""
    if spec.is_binary:
        return 4 + sum(len(rd.base_coeffs) for rd in spec.ranges)
    nrm = sum(typed_reciprocal._nrm_rows(rd) + 1 for rd in spec.ranges)
    shared = set(rd.base for rd in spec.ranges if rd.is_shared and not rd.is_assumed)
    lin = 6 + sum(b - 1 for b in shared) + 1  # +1 slack for a shared bit base
    return 2 + lin + nrm
