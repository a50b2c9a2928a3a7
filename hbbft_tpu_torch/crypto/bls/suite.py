"""BLSSuite: plugs BLS12-381 into the suite-generic threshold scheme."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

from hbbft_tpu_torch.crypto.bls import curve as C
from hbbft_tpu_torch.crypto.bls import fields as F
from hbbft_tpu_torch.crypto.bls import pairing as PR
from hbbft_tpu_torch.crypto.suite import Suite


class _PointElem:
    """Group-element wrapper satisfying the suite element protocol.

    Wraps a Jacobian point; affine form (for serialization/equality) is
    computed lazily and cached.
    """

    __slots__ = ("jac", "_affine", "_bytes", "_subgroup_ok")

    ops: C.FieldOps  # set on subclasses
    tag: bytes

    def __init__(self, jac: C.Jac) -> None:
        self.jac = jac
        self._affine: Any = _UNSET
        self._bytes: Optional[bytes] = None
        # Memo: r-torsion membership, once proven.  The check costs a
        # full scalar mult; serde decode, protocol validation, and the
        # eager backend may each ask — only the first pays.
        self._subgroup_ok = False

    def __getstate__(self):
        # Drop the lazy caches: the _UNSET sentinel does not survive
        # pickling by identity (a round-trip would resurrect it as an
        # arbitrary object that affine() then hands out as coordinates).
        # _subgroup_ok is also dropped: a pickle round-trip must not
        # carry a trust assertion.
        return self.jac

    def __setstate__(self, state):
        self.jac = state
        self._affine = _UNSET
        self._bytes = None
        self._subgroup_ok = False

    # -- group ops -----------------------------------------------------
    def __add__(self, other: "_PointElem"):
        return type(self)(C.jac_add(self.ops, self.jac, other.jac))

    def __neg__(self):
        return type(self)(C.jac_neg(self.ops, self.jac))

    def __sub__(self, other: "_PointElem"):
        return self + (-other)

    def __mul__(self, scalar: int):
        return type(self)(C.jac_mul(self.ops, self.jac, scalar % F.R))

    __rmul__ = __mul__

    def is_identity(self) -> bool:
        return C.jac_is_identity(self.ops, self.jac)

    # -- representation ------------------------------------------------
    def affine(self):
        if self._affine is _UNSET:
            self._affine = C.jac_to_affine(self.ops, self.jac)
        return self._affine

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, _PointElem) or self.tag != other.tag:
            return NotImplemented
        return C.jac_eq(self.ops, self.jac, other.jac)

    def __hash__(self) -> int:
        return hash(self.to_bytes())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_bytes().hex()[:16]}…)"


_UNSET = object()


class G1Elem(_PointElem):
    ops = C.FQ_OPS
    tag = b"g1"
    serde_suite_name = "bls12-381"
    serde_group = 1

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            aff = self.affine()
            if aff is None:
                self._bytes = b"\x00" * 97
            else:
                self._bytes = (
                    b"\x01" + aff[0].to_bytes(48, "big") + aff[1].to_bytes(48, "big")
                )
        return self._bytes


class G2Elem(_PointElem):
    ops = C.FQ2_OPS
    tag = b"g2"
    serde_suite_name = "bls12-381"
    serde_group = 2

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            aff = self.affine()
            if aff is None:
                self._bytes = b"\x00" * 193
            else:
                (x0, x1), (y0, y1) = aff
                self._bytes = (
                    b"\x01"
                    + x0.to_bytes(48, "big")
                    + x1.to_bytes(48, "big")
                    + y0.to_bytes(48, "big")
                    + y1.to_bytes(48, "big")
                )
        return self._bytes


class BLSSuite(Suite):
    """Real BLS12-381 suite (pure-Python oracle backend)."""

    name = "bls12-381"
    scalar_modulus = F.R

    def g1_generator(self) -> G1Elem:
        return G1Elem(C.G1_GEN)

    def g2_generator(self) -> G2Elem:
        return G2Elem(C.G2_GEN)

    def g1_identity(self) -> G1Elem:
        return G1Elem(C.jac_identity(C.FQ_OPS))

    def g2_identity(self) -> G2Elem:
        return G2Elem(C.jac_identity(C.FQ2_OPS))

    def is_g1(self, obj: Any, check_subgroup: bool = True) -> bool:
        """Membership: structure, on-curve, and (optionally) r-torsion.

        Byzantine peers can hand us arbitrary point objects; the subgroup
        check defeats small-subgroup confinement of the RLC batch
        verification (a torsion component could otherwise cancel with
        noticeable probability).  Cost (one scalar mult) is acceptable in
        this oracle backend; the TPU backend batches the same check.
        The on-curve test runs in Jacobian form (no inversion — the
        affine conversion's ``pow`` dominated structural validation at
        flush batch sizes).
        """
        return (
            isinstance(obj, G1Elem)
            and _coords_valid(obj.jac, fq2=False)
            and _on_curve_and_torsion(
                C.FQ_OPS, obj, C.g1_on_curve_jac, check_subgroup
            )
        )

    def is_g2(self, obj: Any, check_subgroup: bool = True) -> bool:
        return (
            isinstance(obj, G2Elem)
            and _coords_valid(obj.jac, fq2=True)
            and _on_curve_and_torsion(
                C.FQ2_OPS, obj, C.g2_on_curve_jac, check_subgroup
            )
        )

    def g1_from_bytes(self, data: bytes) -> G1Elem:
        """Decode the 97-byte affine encoding; full membership validation
        (coordinate range, on-curve, r-torsion) — decoded elements come
        from committed-but-attacker-authored bytes and go straight into
        pairing checks, so the wire policy of :meth:`is_g1` applies."""
        elem = G1Elem(_jac_from_bytes(data, fq2=False))
        if not self.is_g1(elem):
            raise ValueError("not a valid G1 element")
        return elem

    def g2_from_bytes(self, data: bytes) -> G2Elem:
        elem = G2Elem(_jac_from_bytes(data, fq2=True))
        if not self.is_g2(elem):
            raise ValueError("not a valid G2 element")
        return elem

    def hash_to_g2(self, data: bytes) -> G2Elem:
        return G2Elem(C.hash_to_g2(bytes(data)))

    def pairing_product_is_one(
        self, pairs: Sequence[Tuple[G1Elem, G2Elem]]
    ) -> bool:
        aff_pairs = [(a.affine(), b.affine()) for a, b in pairs]
        return PR.multi_pairing_is_one(aff_pairs)

    def batch_affine(self, elems: Sequence[Any]) -> None:
        """Warm the affine caches of many points with ONE field inversion
        per group (Montgomery's batch-inversion trick).

        ``to_bytes``/``affine`` otherwise cost two ``pow(·, -1, p)`` per
        point, which dominates Fiat-Shamir coefficient derivation at
        flush batch sizes (BASELINE.md round-1 measurements).  Non-point
        objects and already-cached/identity points are skipped.
        """
        for cls, ops in ((G1Elem, C.FQ_OPS), (G2Elem, C.FQ2_OPS)):
            todo = []
            for e in elems:
                if (
                    type(e) is cls
                    and e._affine is _UNSET
                    and isinstance(e.jac, tuple)
                    and len(e.jac) == 3
                ):
                    todo.append(e)
            if not todo:
                continue
            finite = []
            for e in todo:
                if ops.is_zero(e.jac[2]):
                    e._affine = None
                else:
                    finite.append(e)
            if not finite:
                continue
            # prefix[i] = z_0 · … · z_{i-1}; one inversion of the total.
            prefix = [ops.one]
            for e in finite:
                prefix.append(ops.mul(prefix[-1], e.jac[2]))
            inv_acc = ops.inv(prefix[-1])
            for e in reversed(finite):
                z_inv = ops.mul(inv_acc, prefix[len(prefix) - 2])
                prefix.pop()
                inv_acc = ops.mul(inv_acc, e.jac[2])
                zi2 = ops.sqr(z_inv)
                x, y, _ = e.jac
                e._affine = (
                    ops.mul(x, zi2),
                    ops.mul(y, ops.mul(zi2, z_inv)),
                )


def _jac_from_bytes(data: Any, fq2: bool) -> C.Jac:
    """Parse the affine wire encoding produced by ``to_bytes`` into a
    Jacobian point (z = 1).  Structural checks only — curve/subgroup
    membership is the caller's job."""
    coords = 4 if fq2 else 2
    if not isinstance(data, bytes) or len(data) != 1 + 48 * coords:
        raise ValueError("bad point encoding length")
    flag, body = data[0], data[1:]
    if flag == 0:
        if any(body):
            raise ValueError("non-canonical identity encoding")
        return C.jac_identity(C.FQ2_OPS if fq2 else C.FQ_OPS)
    if flag != 1:
        raise ValueError("bad point flag")
    vals = [int.from_bytes(body[i * 48 : (i + 1) * 48], "big") for i in range(coords)]
    if any(v >= F.P for v in vals):
        raise ValueError("coordinate out of field range")
    if fq2:
        return ((vals[0], vals[1]), (vals[2], vals[3]), C.FQ2_OPS.one)
    return (vals[0], vals[1], C.FQ_OPS.one)


def _fq_valid(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and 0 <= v < F.P


def _fq2_valid(v: Any) -> bool:
    return (
        isinstance(v, tuple) and len(v) == 2 and _fq_valid(v[0]) and _fq_valid(v[1])
    )


def _coords_valid(jac: Any, fq2: bool) -> bool:
    if not (isinstance(jac, tuple) and len(jac) == 3):
        return False
    check = _fq2_valid if fq2 else _fq_valid
    return all(check(c) for c in jac)


def _on_curve_and_torsion(
    ops: C.FieldOps, elem: _PointElem, on_curve_jac, check_subgroup: bool
) -> bool:
    jac = elem.jac
    if C.jac_is_identity(ops, jac):
        return True
    if not on_curve_jac(jac):
        return False
    if not check_subgroup or elem._subgroup_ok:
        return True
    # Endomorphism membership tests (curve.py): ~2x (G1) / ~4x (G2)
    # fewer group ops than the definitional [r]P == O, same verdict
    # (equivalence pinned by tests/test_bls.py against in_subgroup_slow).
    ok = C.g2_in_subgroup(jac) if ops is C.FQ2_OPS else C.g1_in_subgroup(jac)
    if ok:
        elem._subgroup_ok = True
    return ok
