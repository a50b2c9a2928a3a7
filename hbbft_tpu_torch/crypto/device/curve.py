"""Batched Jacobian point arithmetic for G1 (Fq) and G2 (Fq2) in PyTorch.

Counterpart of ``hbbft_tpu/crypto/tpu/curve.py``: the same branch-free
formulas over an explicit batch dimension, with ``lax.scan`` written as
Python loops.  The reference split its scans into segments only to get
round an XLA compile failure; here each scan is one plain loop.

Point representation: ``(x, y, z, inf)`` — Jacobian coordinates as limb
tensors plus an explicit int64 infinity flag (1 = identity).  Carrying
the flag avoids data-dependent field-equality tests in the hot paths.

``add_unsafe`` is branch-free and WRONG when both inputs are the same
non-identity point or exact negatives.  Its callers guarantee that can't
happen (or happens with cryptographically negligible probability):

* ``scalar_mul``: acc = m·B meets addend B only if m ≡ ±1 (mod r); after
  the first set bit m ∈ [2, 2^255) and the scalars here are either
  Fiat-Shamir RLC coefficients (< 2^128 ≪ r) or Lagrange coefficients we
  derive ourselves — hitting (r±1)/2 prefixes is a 2^-250-class event an
  adversary cannot steer.
* tree reduction over RLC-scaled points: points are c_i·P_i with c_i
  Fiat-Shamir coefficients fixed only after the P_i are committed, so
  engineered cancellations/collisions are negligible.

``add_safe`` (field-equality corrected) exists for tests and cold paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto.bls import fields as F
from hbbft_tpu_torch.crypto.device import fq, fq2

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

I64 = torch.int64


@dataclass(frozen=True)
class Ops:
    """Field-op namespace a curve works over (G1: fq, G2: fq2)."""

    add: Callable
    sub: Callable
    mul: Callable
    sqr: Callable
    small_mul: Callable
    is_zero: Callable
    one: np.ndarray
    zero: np.ndarray
    elem_ndim: int  # trailing dims of one field element
    const_prefix: str  # names of one/zero in the fq constant cache


G1_OPS = Ops(fq.add, fq.sub, fq.mont_mul, fq.mont_sqr, fq.small_mul,
             fq.is_zero, fq.ONE_MONT, fq.ZERO, 1, "")
G2_OPS = Ops(fq2.add, fq2.sub, fq2.mul, fq2.sqr, fq2.small_mul,
             fq2.is_zero, fq2.ONE, fq2.ZERO, 2, "fq2_")


def identity(ops: Ops, batch: Tuple[int, ...] = (), device=None) -> Point:
    dev = torch.device("cpu") if device is None else torch.device(device)
    one = fq.const(ops.const_prefix + "one", dev).expand(*batch, *ops.one.shape)
    zero = fq.const(ops.const_prefix + "zero", dev).expand(*batch, *ops.zero.shape)
    return (one, one, zero, torch.ones(batch, dtype=I64, device=dev))


def double(ops: Ops, p: Point) -> Point:
    """Jacobian doubling (a = 0 curve).  Correct for all inputs: the
    subgroup has prime order, so y = 0 never occurs on valid points, and
    the identity flag rides through unchanged (z' = 2yz keeps z = 0)."""
    x, y, z, inf = p
    a = ops.sqr(x)
    b = ops.sqr(y)
    c = ops.sqr(b)
    d = ops.small_mul(ops.sub(ops.sub(ops.sqr(ops.add(x, b)), a), c), 2)
    e = ops.small_mul(a, 3)
    f = ops.sqr(e)
    x3 = ops.sub(f, ops.small_mul(d, 2))
    y3 = ops.sub(ops.mul(e, ops.sub(d, x3)), ops.small_mul(c, 8))
    z3 = ops.small_mul(ops.mul(y, z), 2)
    return (x3, y3, z3, inf)


def _sel(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor, ndim: int) -> torch.Tensor:
    """where(flag, a, b) with flag broadcast over trailing element dims."""
    f = flag.reshape(flag.shape + (1,) * ndim).bool()
    return torch.where(f, a, b)


def select(flag: torch.Tensor, p: Point, q: Point, ops: Ops) -> Point:
    """Pointwise where(flag, p, q)."""
    return (
        _sel(flag, p[0], q[0], ops.elem_ndim),
        _sel(flag, p[1], q[1], ops.elem_ndim),
        _sel(flag, p[2], q[2], ops.elem_ndim),
        torch.where(flag.bool(), p[3], q[3]),
    )


def add_unsafe(ops: Ops, p: Point, q: Point) -> Point:
    """General Jacobian addition; identity flags handled, p == ±q NOT
    (see module docstring for why callers may rely on that)."""
    x1, y1, z1, inf1 = p
    x2, y2, z2, inf2 = q
    z1z1 = ops.sqr(z1)
    z2z2 = ops.sqr(z2)
    u1 = ops.mul(x1, z2z2)
    u2 = ops.mul(x2, z1z1)
    s1 = ops.mul(y1, ops.mul(z2, z2z2))
    s2 = ops.mul(y2, ops.mul(z1, z1z1))
    h = ops.sub(u2, u1)
    i = ops.sqr(ops.small_mul(h, 2))
    j = ops.mul(h, i)
    rr = ops.small_mul(ops.sub(s2, s1), 2)
    v = ops.mul(u1, i)
    x3 = ops.sub(ops.sub(ops.sqr(rr), j), ops.small_mul(v, 2))
    y3 = ops.sub(ops.mul(rr, ops.sub(v, x3)), ops.small_mul(ops.mul(s1, j), 2))
    z3 = ops.mul(ops.small_mul(ops.mul(z1, z2), 2), h)
    out: Point = (x3, y3, z3, torch.zeros_like(inf1))
    out = select(inf1, q, out, ops)
    out = select(inf2 & (1 - inf1), p, out, ops)
    return out


def add_safe(ops: Ops, p: Point, q: Point) -> Point:
    """Addition correct for ALL inputs (uses field-equality tests; slow —
    keep out of scans/hot loops)."""
    x1, y1, z1, inf1 = p
    x2, y2, z2, inf2 = q
    z1z1 = ops.sqr(z1)
    z2z2 = ops.sqr(z2)
    u1 = ops.mul(x1, z2z2)
    u2 = ops.mul(x2, z1z1)
    s1 = ops.mul(y1, ops.mul(z2, z2z2))
    s2 = ops.mul(y2, ops.mul(z1, z1z1))
    h_zero = ops.is_zero(ops.sub(u2, u1)).to(I64)
    r_zero = ops.is_zero(ops.sub(s2, s1)).to(I64)
    both = (1 - inf1) * (1 - inf2)
    is_dbl = both * h_zero * r_zero
    is_cancel = both * h_zero * (1 - r_zero)
    # safety: the two select()s below replace exactly the lanes where
    # add_unsafe's P == ±Q precondition fails (is_dbl / is_cancel).
    out = add_unsafe(ops, p, q)
    out = select(is_dbl, double(ops, p), out, ops)
    out = select(
        is_cancel, identity(ops, tuple(inf1.shape), inf1.device), out, ops
    )
    return out


def neg(ops: Ops, p: Point) -> Point:
    x, y, z, inf = p
    return (x, ops.sub(torch.zeros_like(y), y), z, inf)


def scalar_mul(ops: Ops, base: Point, bits: torch.Tensor) -> Point:
    """Batched double-and-add: bits ``(..., nbits)`` int64, MSB first.
    See module docstring for the add_unsafe safety argument."""
    batch = tuple(bits.shape[:-1])
    acc = identity(ops, batch, bits.device)
    started = torch.zeros(batch, dtype=I64, device=bits.device)
    for k in range(bits.shape[-1]):
        bit = bits[..., k]
        acc = double(ops, acc)
        # "acc is identity" is exactly "no set bit yet": use the flag
        # instead of a field test.
        # safety: module docstring, first bullet (scalar_mul prefixes).
        summed = add_unsafe(ops, (acc[0], acc[1], acc[2], 1 - started), base)
        acc = select(bit, summed, acc, ops)
        started = started | bit
    x, y, z, _ = acc
    inf = (1 - started) | base[3]
    return (x, y, z, inf)


def jac_eq_dev(ops: Ops, p: Point, q: Point) -> torch.Tensor:
    """Batched projective equality (cross-multiplied), device-side.

    Points whose z is zero but whose infinity flag is unset (the garbage
    add_unsafe produces on forbidden inputs) compare UNEQUAL to
    everything, so downstream checks fail closed.
    """
    x1, y1, z1, i1 = p
    x2, y2, z2, i2 = q
    z1z1 = ops.sqr(z1)
    z2z2 = ops.sqr(z2)
    ex = ops.is_zero(ops.sub(ops.mul(x1, z2z2), ops.mul(x2, z1z1)))
    ey = ops.is_zero(
        ops.sub(
            ops.mul(y1, ops.mul(z2, z2z2)), ops.mul(y2, ops.mul(z1, z1z1))
        )
    )
    z_ok = (~ops.is_zero(z1)) & (~ops.is_zero(z2))
    both_fin = (i1 == 0) & (i2 == 0)
    both_inf = (i1 == 1) & (i2 == 1)
    return both_inf | (both_fin & z_ok & ex & ey)


# ---------------------------------------------------------------------------
# Endomorphism subgroup checks — device mirror of bls.curve.g1_in_subgroup /
# g2_in_subgroup (derivation and soundness notes there).
#
#   G1: phi(P) == -[x^2]P   (phi: X *= beta; x^2 is 127 bits)
#   G2: psi(Q) == -[|x|]Q   (psi: conjugate coords, X *= cx, Y *= cy)
#
# Fail-closed safety with add_unsafe: an adversarial SMALL-ORDER point
# can steer the fixed-scalar chain into add_unsafe's forbidden P == ±Q
# cases, but those produce z = 0 outputs and z stays 0 through every
# subsequent double/add (z3 always carries a factor of the incoming z),
# and jac_eq_dev treats unflagged z == 0 as UNEQUAL — so a corrupted
# chain can only REJECT, which is the correct verdict for any point
# that could steer it (subgroup points can't: the prefix-coincidence
# argument in the flush-scan notes below).
# ---------------------------------------------------------------------------

ENDO_NBITS = 128


@lru_cache(maxsize=1)
def _endo_consts() -> None:
    """Register the device forms of the oracle-derived endomorphism
    constants (beta, psi's cx and cy) in the fq constant cache."""
    from hbbft_tpu_torch.crypto.bls import curve as OC

    cx, cy = OC.psi_consts()
    fq.register_const("beta", fq.to_mont_np(OC.g1_beta()))
    fq.register_const("psi_cx", fq2.to_mont_np(cx))
    fq.register_const("psi_cy", fq2.to_mont_np(cy))


def phi_g1(p: Point) -> Point:
    """GLV endomorphism on batched G1 Jacobian points: X *= beta."""
    _endo_consts()
    x, y, z, inf = p
    return (fq.mont_mul(x, fq.const("beta", x.device)), y, z, inf)


def psi_g2(p: Point) -> Point:
    """Untwist-Frobenius-twist on batched G2 Jacobian points:
    (cx*conj(X), cy*conj(Y), conj(Z))."""
    _endo_consts()
    x, y, z, inf = p
    return (
        fq2.mul(fq.const("psi_cx", x.device), fq2.conj(x)),
        fq2.mul(fq.const("psi_cy", y.device), fq2.conj(y)),
        fq2.conj(z),
        inf,
    )


def endo_subgroup_eq(ops: Ops, pts: Point, chain_out: Point) -> torch.Tensor:
    """Batched membership verdicts given ``chain_out`` = [x^2]P (G1) or
    [|x|]Q (G2) from the shared scan: endo(P) == -chain_out."""
    endo = psi_g2(pts) if ops is G2_OPS else phi_g1(pts)
    return jac_eq_dev(ops, endo, neg(ops, chain_out))


def scalars_to_bits_lsb(scalars, nbits: int, device=None) -> torch.Tensor:
    """Host: list of ints -> (N, nbits) int64 LSB-first bit matrix."""
    return torch.as_tensor(_scalars_to_bits_np(scalars, nbits), device=device)


# ---------------------------------------------------------------------------
# Static-endo flush scans — the per-row cost cut (reference notes in
# hbbft_tpu/crypto/tpu/curve.py, "Static-endo flush scans").
#
#   * the endomorphism-check scalars are FIXED — x^2 (hamming weight 17)
#     on G1, |x| (hamming weight 6) on G2 — so the check chain collects
#     the doubling-chain points [2^k]P at those static positions and sums
#     them with one tree reduction;
#   * on G2 a 128-bit RLC coefficient c splits as c = q·|x| + s (q ≤ 65
#     bits, s < 64), and [c]Q = [s]Q + [q](-psi(Q)) — a 65-step
#     two-scalar scan.  Using psi(Q) as a base is sound exactly when
#     psi(Q) == [x]Q, which is the subgroup check verified in the same
#     flush: if it fails, the aggregate verdict is already False.
#
# add_unsafe safety for these uses:
#
#   * LSB-first RLC adds (G1 scan): after k steps the accumulator holds
#     (m mod 2^k)·P for a committed coefficient m < 2^128 and the addend
#     is 2^k·P; coincidence needs m mod 2^k ≡ ±2^k (mod r), impossible as
#     m mod 2^k < 2^k and r - 2^k > 2^128.  For small-ORDER inputs a
#     coincidence CAN occur, but then z becomes and stays 0, jac_eq_dev
#     reports unequal, and the membership check fails closed;
#   * check-chain tree sum (both groups): every partial sum is [m1]P for
#     m1 a sub-mask of the fixed scalar's set bits, every addend [m2]P for
#     a DISJOINT nonzero sub-mask; coincidence needs m1 ≡ ±m2 (mod r) with
#     m1 ≠ m2, both < 2^128 ≪ r — impossible.
#   * B01 = Q + (-psi(Q)) precompute: forbidden iff psi(Q) == ±Q, i.e.
#     [x ∓ 1]Q = O — impossible for genuine G2 points (0 < |x ∓ 1| < 2^65
#     < r); adversarial non-subgroup points can poison it, but they fail
#     the psi check in the same flush (fail-closed z = 0 argument above).
#   * MSB accumulator adds (G2 RLC scan): deterministically impossible.
#     After the step's double the accumulator is [2m]Q with m = s_k +
#     |x|*q_k (k-bit MSB prefixes, k <= 64, so 2m < 2^131 << r).  The
#     addend scalars are 1 and |x|+1 (odd — never equal to the even 2m)
#     or |x| (even: needs m = |x|/2, which forces q_k = 0 and s_k =
#     |x|/2; but |x|/2 has 63 bits, so k >= 63 and s >= 2^(64-k) * |x|/2
#     >= |x|, contradicting the decomposition's 0 <= s < |x|).
# ---------------------------------------------------------------------------

XSQ = F.BLS_X * F.BLS_X  # 128-bit G1 endo-check scalar (positive)


def _lsb_set_positions(value: int, nbits: int) -> Tuple[int, ...]:
    return tuple(i for i in range(nbits) if (value >> i) & 1)


def _stack_points(pts_list) -> Point:
    """Stack batched points along a new leading axis."""
    return tuple(torch.stack([p[c] for p in pts_list]) for c in range(4))


def _tree_sum_axis0(ops: Ops, pts: Point) -> Point:
    """Pairwise-halving sum over a SMALL static leading axis.  add_unsafe
    safety is the CALLER's obligation for the pair sums it induces."""
    m = pts[0].shape[0]
    while m > 1:
        half = m // 2
        lo = tuple(x[:half] for x in pts)
        hi = tuple(x[half : 2 * half] for x in pts)
        # safety: caller's obligation (check-chain sub-mask argument).
        summed = add_unsafe(ops, lo, hi)
        if m % 2:
            tail = tuple(x[2 * half :] for x in pts)
            pts = tuple(torch.cat([s, t]) for s, t in zip(summed, tail))
            m = half + 1
        else:
            pts = summed
            m = half
    return tuple(x[0] for x in pts)


def scalar_mul_rlc_g1(base: Point, bits_lsb: torch.Tensor) -> Tuple[Point, Point]:
    """([c]P, [x^2]P) per row — LSB-first shared-doubling scan.

    ``bits_lsb``: (..., 128) LSB-first RLC coefficient bits.  One base
    doubling chain serves both results; the [x^2]P check chain is the
    tree sum of the chain points [2^k]P collected at x^2's 17 static set
    bits (section notes above).
    """
    ops = G1_OPS
    nbits = bits_lsb.shape[-1]
    # A narrower scan would silently truncate the check scalar and reject
    # every genuine point: an explicit raise, not an assert.
    if nbits < XSQ.bit_length():
        raise ValueError(
            f"RLC bit width {nbits} < x^2 width {XSQ.bit_length()}"
        )
    batch = tuple(bits_lsb.shape[:-1])
    dev = bits_lsb.device
    acc = identity(ops, batch, dev)
    started = torch.zeros(batch, dtype=I64, device=dev)
    positions = set(_lsb_set_positions(XSQ, nbits))
    cur = base
    curs = []
    for k in range(nbits):
        if k in positions:
            curs.append(cur)  # cur = [2^k]P
        bit = bits_lsb[..., k]
        # safety: section notes below, first bullet (LSB-first prefixes).
        summed = add_unsafe(ops, (acc[0], acc[1], acc[2], 1 - started), cur)
        acc = select(bit, summed, acc, ops)
        started = started | bit
        cur = double(ops, cur)
    inf = (1 - started) | base[3]
    scaled = (acc[0], acc[1], acc[2], inf)
    chain = _tree_sum_axis0(ops, _stack_points(curs))
    chain = (chain[0], chain[1], chain[2], chain[3] | base[3])
    return scaled, chain


G2_SCAN_NBITS = 65  # max(|x| bits, q = c div |x| bits) for c < 2^128


def decompose_g2_scalar(c: int) -> Tuple[int, int]:
    """Host: RLC coefficient c -> (s, q) with c = q·|x| + s, 0 ≤ s < |x|.

    Then [c]Q = [s]Q + [q][|x|]Q = [s]Q + [q](-psi(Q)) for subgroup Q
    (psi(Q) = [x]Q, x < 0).  For c < 2^128: q < 2^65, s < 2^64.
    """
    q, s = divmod(c, -F.BLS_X)
    return s, q


def scalar_mul_rlc_g2(
    base: Point, bits_s: torch.Tensor, bits_q: torch.Tensor
) -> Tuple[Point, Point]:
    """([c]Q, [|x|]Q) per row via the psi decomposition (section notes).

    ``bits_s``/``bits_q``: (..., 65) MSB-first bits of s and q from
    :func:`decompose_g2_scalar`.  The RLC sum is ONE MSB-first scan — per
    step one accumulator double and one add_unsafe of the addend selected
    from {O, Q, -psi(Q), Q-psi(Q)}; the [|x|]Q check chain is the tree sum
    of [2^j]Q collected from a double-only chain at |x|'s 6 set bits.
    """
    ops = G2_OPS
    nbits = bits_s.shape[-1]
    if bits_s.shape != bits_q.shape or nbits != G2_SCAN_NBITS:
        raise ValueError(f"G2 scan needs two (..., {G2_SCAN_NBITS}) bit matrices")
    batch = tuple(bits_s.shape[:-1])
    dev = bits_s.device
    b0 = base
    b1 = neg(ops, psi_g2(base))
    b01 = add_unsafe(ops, b0, b1)  # safety: section notes (psi(Q) != ±Q)
    acc = identity(ops, batch, dev)
    for k in range(nbits):
        sbit, qbit = bits_s[..., k], bits_q[..., k]
        acc = double(ops, acc)
        both = sbit & qbit
        addend = select(both, b01, select(sbit, b0, b1, ops), ops)
        # Identity addend when neither bit is set (and inherit the base's
        # own identity flag) — add_unsafe routes on the flag.
        addend = (
            addend[0],
            addend[1],
            addend[2],
            (1 - (sbit | qbit)) | addend[3],
        )
        # safety: MSB accumulator adds — deterministically impossible
        # coincidence (section notes above, third bullet).
        acc = add_unsafe(ops, acc, addend)

    # [|x|]Q check chain: double-only chain over the base, collecting
    # [2^j]Q at |x|'s set bits, then one tree reduction.
    curs = []
    cur = base
    prev = 0
    for j in _lsb_set_positions(-F.BLS_X, 64):
        for _ in range(j - prev):
            cur = double(ops, cur)
        prev = j
        curs.append(cur)
    chain = _tree_sum_axis0(ops, _stack_points(curs))

    # Identity flags: acc started as identity and add_unsafe tracked
    # flags through every add; the chain inherits the base's flag.
    scaled = (acc[0], acc[1], acc[2], acc[3] | base[3])
    chain = (chain[0], chain[1], chain[2], chain[3] | base[3])
    return scaled, chain


def tree_sum(ops: Ops, pts: Point) -> Point:
    """Sum a batch of points over axis 0 (log2 rounds of add_unsafe)."""
    n = pts[0].shape[0]
    while n > 1:
        half = (n + 1) // 2
        top = _slice_or_identity(pts, half, n, ops)
        bottom = tuple(x[:half] for x in pts)
        # safety: tree reduction over RLC-scaled points (module
        # docstring, second bullet — committed-coefficient partial sums).
        pts = add_unsafe(ops, bottom, top)
        n = half
    return tuple(x[0] for x in pts)


def _slice_or_identity(pts: Point, half: int, n: int, ops: Ops) -> Point:
    """pts[half:n] padded with identities up to length half (any
    trailing batch dims ride along)."""
    if n - half == half:
        return tuple(x[half:n] for x in pts)
    shape = (half - (n - half), *pts[3].shape[1:])
    ident = identity(ops, shape, pts[0].device)
    return tuple(torch.cat([x[half:n], i]) for x, i in zip(pts, ident))


# ---------------------------------------------------------------------------
# Host conversions to/from the oracle's Jacobian-int representation
# ---------------------------------------------------------------------------


def g1_to_dev(jacs, device=None) -> Point:
    """Host: list of oracle G1 Jacobian points -> batched device point."""
    n = len(jacs)
    xs, ys, zs = [], [], []
    infs = np.zeros(n, dtype=np.int64)
    for i, (x, y, z) in enumerate(jacs):
        if z % F.P == 0:
            infs[i] = 1
            x, y, z = 1, 1, 0
        xs.append(x)
        ys.append(y)
        zs.append(z)
    flat = torch.as_tensor(fq.to_mont_batch(xs + ys + zs), device=device)
    return (flat[:n], flat[n : 2 * n], flat[2 * n :],
            torch.as_tensor(infs, device=device))


def g2_to_dev(jacs, device=None) -> Point:
    n = len(jacs)
    infs = np.zeros(n, dtype=np.int64)
    pts = []
    for i, (x, y, z) in enumerate(jacs):
        if z[0] % F.P == 0 and z[1] % F.P == 0:
            infs[i] = 1
            x, y, z = (1, 0), (1, 0), (0, 0)
        pts.append((x, y, z))
    coords: list = []
    for sel in range(3):
        for c in range(2):
            coords.extend(p[sel][c] for p in pts)
    flat = fq.to_mont_batch(coords)  # (6n, NL): x0 x1 y0 y1 z0 z1 blocks
    elems = flat.reshape(3, 2, n, fq.NL).transpose(0, 2, 1, 3)  # (3, n, 2, NL)
    dev = torch.as_tensor(np.ascontiguousarray(elems), device=device)
    return (dev[0], dev[1], dev[2], torch.as_tensor(infs, device=device))


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def g1_from_dev(p: Point, idx=None):
    """Host: one device G1 point -> oracle Jacobian int tuple."""
    x, y, z, inf = [_host(v) for v in p]
    if idx is not None:
        x, y, z, inf = x[idx], y[idx], z[idx], inf[idx]
    if int(inf):
        return (1, 1, 0)
    return (fq.from_mont_int(x), fq.from_mont_int(y), fq.from_mont_int(z))


def g2_from_dev(p: Point, idx=None):
    x, y, z, inf = [_host(v) for v in p]
    if idx is not None:
        x, y, z, inf = x[idx], y[idx], z[idx], inf[idx]
    if int(inf):
        return ((1, 0), (1, 0), (0, 0))
    return (fq2.from_mont_int(x), fq2.from_mont_int(y), fq2.from_mont_int(z))


def _scalars_to_bits_np(scalars, nbits: int) -> np.ndarray:
    """(N, nbits) int64 LSB-first bit matrix, vectorized."""
    nbytes = (nbits + 7) // 8
    for s in scalars:
        if not 0 <= s < (1 << nbits):
            raise ValueError(f"scalar does not fit {nbits} bits")
    if not scalars:
        return np.zeros((0, nbits), dtype=np.int64)
    data = np.frombuffer(
        b"".join(s.to_bytes(nbytes, "little") for s in scalars), dtype=np.uint8
    ).reshape(len(scalars), nbytes)
    return np.unpackbits(data, axis=1, bitorder="little")[:, :nbits].astype(
        np.int64
    )


def scalars_to_bits(scalars, nbits: int, device=None) -> torch.Tensor:
    """Host: list of ints -> (N, nbits) int64 MSB-first bit matrix."""
    return torch.as_tensor(
        _scalars_to_bits_np(scalars, nbits)[:, ::-1].copy(), device=device
    )
