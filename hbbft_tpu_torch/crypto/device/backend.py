"""TorchBackend: the share-verification flush on the card.

Counterpart of ``hbbft_tpu/crypto/tpu/backend.py`` ``TpuBackend``: the
same random-linear-combination batch verification as
:class:`hbbft_tpu_torch.crypto.backend.BatchedBackend` — identical
Fiat-Shamir coefficients, identical leg algebra, bisection fallback on
failure — with the group algebra in PyTorch on ``device``:

* the SCAN stage (:func:`scan_stage`, the reference's ``_scan_kernel``):
  every share/key/ciphertext point is scaled by its 128-bit RLC
  coefficient while the endomorphism subgroup chain runs off the same
  doubling chain (``[x^2]P`` on G1, ``[|x|]Q`` on G2 via the psi
  decomposition), the subgroup verdicts are reduced to one flag, and the
  legs are summed by masked tree reductions;
* the PAIR stage (:func:`pair_stage`, the reference's ``_pair_kernel``):
  the batched Miller loop over every pair of every chunk and ONE shared
  final exponentiation.

The reference bucketed every shape to a power of two only to bound XLA
recompiles; PyTorch compiles nothing, so the port runs at exact sizes.
On a CUDA device the scan stage is the hand-written K2 kernels
(:mod:`.scan`, ``csrc/scan.cu``) and the pair stage the K3 kernels
(:mod:`.pair`, ``csrc/pair.cu``); on the CPU both stages are the plain
versions here (:func:`scan_stage`, :func:`pair_stage_plain`).

``TorchBackend(devices=[...])`` is the counterpart of the reference's
sharded flush (``TpuBackend(shard=True)`` over ``_shard_mesh``, K7): the
scan stage's chunks go to the listed devices in turn and their pairs
are gathered on the first for one pair stage.  :class:`HybridBackend`
routes each flush by size between ``TorchBackend`` and the host
``BatchedBackend``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch.crypto.backend import (
    DEC_SHARE,
    SIG_SHARE,
    BatchedBackend,
    CryptoBackend,
    EagerBackend,
    VerifyRequest,
    _batch_coefficients,
    request_well_formed,
)
from hbbft_tpu_torch.crypto.bls import curve as ocurve
from hbbft_tpu_torch.crypto.bls.suite import BLSSuite
from hbbft_tpu_torch.crypto.device import curve as dcurve
from hbbft_tpu_torch.crypto.device import fq
from hbbft_tpu_torch.crypto.device import pair as dpair
from hbbft_tpu_torch.crypto.device import pairing as dpairing
from hbbft_tpu_torch.crypto.device import scan as dscan
from hbbft_tpu_torch.device import DeviceLike, resolve
from hbbft_tpu_torch.utils import canonical_bytes

DEFAULT_CHUNK = 2048  # the reference backend's chunk default; untuned here

def scan_stage(
    g1_pts, g1_bits, g1_chk, seg, g1_sub,
    g2_pts, g2_bits_s, g2_bits_q, g2_chk, g2_sub, rhs_g2, gen_pt,
) -> Tuple[torch.Tensor, dcurve.Point, dcurve.Point]:
    """Per-row work of one or more independent RLC subsets in one pass.

    Rows of all subsets are concatenated; ``g1_sub``/``g2_sub`` are
    (n_sub, rows) one-hot subset memberships and ``seg`` the (n_legs,
    n_g1) one-hot leg membership (legs are numbered across subsets).
    Returns (sub_ok, lhs, rhs): ``sub_ok`` (n_sub,) is each subset's
    aggregate subgroup verdict over its masked wire-sourced points;
    (lhs, rhs) are the pairing pairs — first the n_sub pairs (G1
    generator, subset's G2 generator-leg sum), then (leg sum l, rhs_l)
    for every leg.  With one subset this is the reference's
    ``_scan_kernel``.
    """
    scaled1, chain1 = dcurve.scalar_mul_rlc_g1(g1_pts, g1_bits)
    scaled2, chain2 = dcurve.scalar_mul_rlc_g2(g2_pts, g2_bits_s, g2_bits_q)
    sub1 = dcurve.endo_subgroup_eq(dcurve.G1_OPS, g1_pts, chain1)
    sub2 = dcurve.endo_subgroup_eq(dcurve.G2_OPS, g2_pts, chain2)
    bad1 = (~sub1) & (g1_chk != 0)
    bad2 = (~sub2) & (g2_chk != 0)
    sub_ok = ~((bad1 & g1_sub.bool()).any(1) | (bad2 & g2_sub.bool()).any(1))
    gen_legs = _masked_sums(dcurve.G2_OPS, scaled2, g2_sub)
    leg_sums = _masked_sums(dcurve.G1_OPS, scaled1, seg)
    n_sub = g2_sub.shape[0]
    gen = tuple(c[None].expand(n_sub, *c.shape) for c in gen_pt)
    lhs = tuple(torch.cat([gen[c], leg_sums[c]]) for c in range(4))
    rhs = tuple(torch.cat([gen_legs[c], rhs_g2[c]]) for c in range(4))
    return sub_ok, lhs, rhs


# Most (mask x row) points one masked tree reduction holds at once.  A
# chunk with many distinct ciphertexts has many legs; past this size the
# masks are summed in groups, so memory stays bounded (about 1 GiB of G1
# points) whatever the leg count.
MASKED_SUM_POINTS = 1 << 20


def _masked_sums(ops: dcurve.Ops, pts: dcurve.Point, mask: torch.Tensor) -> dcurve.Point:
    """Row sums of ``pts`` under each of the (m, rows) one-hot masks: the
    reference's per-leg masked ``tree_sum``, batched over as many masks
    at a time as :data:`MASKED_SUM_POINTS` allows."""
    m, rows = mask.shape
    step = max(1, MASKED_SUM_POINTS // rows)
    sums = []
    for lo in range(0, m, step):
        part = mask[lo : lo + step]
        k = part.shape[0]
        ident = dcurve.identity(ops, (k, rows), mask.device)
        expanded = tuple(c.unsqueeze(0).expand(k, *c.shape) for c in pts)
        masked = dcurve.select(part, expanded, ident, ops)
        sums.append(dcurve.tree_sum(ops, tuple(c.transpose(0, 1) for c in masked)))
    if len(sums) == 1:
        return sums[0]
    return tuple(torch.cat([p[c] for p in sums]) for c in range(4))


def pair_stage(
    lhs: dcurve.Point, rhs: dcurve.Point, pair_sub: Sequence[int], n_sub: int
) -> torch.Tensor:
    """(n_sub,) verdicts "the product of the subset's pairings is 1" —
    the K3 kernels (:func:`.pair.pair_stage_kernel`) for CUDA tensors,
    the plain :func:`pair_stage_plain` for CPU tensors; no fallback."""
    if lhs[0].device.type == "cuda":
        return dpair.pair_stage_kernel(lhs, rhs, pair_sub, n_sub)
    return pair_stage_plain(lhs, rhs, pair_sub, n_sub)


def pair_stage_plain(
    lhs: dcurve.Point, rhs: dcurve.Point, pair_sub: Sequence[int], n_sub: int
) -> torch.Tensor:
    """Batched Miller loop over every pair, the per-subset products, and
    ONE batched final exponentiation -> (n_sub,) verdicts "product == 1".

    ``pair_sub[i]`` is the subset of pair i.  With one subset this is the
    reference's ``_pair_kernel`` (``pairing_product_is_one``), product
    order included.
    """
    fs = dpairing.miller_values(lhs, rhs)
    one = fq.const("fq12_one", fs.device)
    # (depth, n_sub) gather of each subset's pairs in order, padded with
    # a trailing FQ12 one, then a running product down the depth axis.
    members: List[List[int]] = [[] for _ in range(n_sub)]
    for i, s in enumerate(pair_sub):
        members[s].append(i)
    depth = max(len(m) for m in members)
    pad = fs.shape[0]
    index = torch.tensor(
        [[m[d] if d < len(m) else pad for m in members] for d in range(depth)],
        device=fs.device,
    )
    table = torch.cat([fs, one[None]])
    acc = table[index[0]]
    for d in range(1, depth):
        acc = dpairing.mul(acc, table[index[d]])
    return dpairing.final_exp_is_one(acc)


class TorchBackend(CryptoBackend):
    """RLC batch verification with the group algebra on ``device``.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` to run the plain PyTorch path on the host.
    ``chunk`` bounds the rows of one scan stage (default 2048, the
    reference's TPU-tuned value, not yet tuned for this card).

    ``devices`` (instead of ``device``) shards the flush: chunk k's scan
    stage runs on ``devices[k % len(devices)]``, and every chunk's pairs
    are gathered on ``devices[0]``, which runs the pair stage, the
    per-chunk rechecks and the bisection.  A list may repeat a device.
    The verdicts are the unsharded flush's: each chunk's scan is the same
    function of the same requests wherever it runs.
    """

    on_device = True

    def __init__(
        self,
        suite: BLSSuite | None = None,
        device: DeviceLike = None,
        chunk: int = DEFAULT_CHUNK,
        devices: Sequence[DeviceLike] | None = None,
    ) -> None:
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        if devices is not None:
            if device is not None:
                raise ValueError("pass device or devices, not both")
            if not devices:
                raise ValueError("devices must name at least one device")
        if suite is not None and not isinstance(suite, BLSSuite):
            raise TypeError(
                f"TorchBackend verifies BLS12-381 shares only; got the suite "
                f"{getattr(suite, 'name', type(suite).__name__)!r} (use BLSSuite, "
                f"or BatchedBackend for any suite)"
            )
        self.devices = [resolve(d) for d in devices] if devices is not None else [resolve(device)]
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"devices mix types: {self.devices}")
        self.device = self.devices[0]
        self.suite = suite or BLSSuite()
        self.chunk = chunk
        self._eager = EagerBackend(self.suite)

    def load_kernels(self) -> None:
        """Initialise every device and load the kernels the flush
        launches (building them first if needed), so the first flush
        pays neither; nothing to do on the CPU."""
        if self.device.type != "cuda":
            return
        from hbbft_tpu_torch import build

        for dev in self.devices:
            torch.zeros(1, device=dev)
        build.load("scan")
        build.load("pair")

    # -- leg construction (host, cheap): mirrors backend._rlc_pairs ----

    def _build_legs(self, reqs: Sequence[VerifyRequest], coeffs: Sequence[int]):
        """Returns (g2_entries, g1_entries, rhs_points).

        g2_entries: list of (scalar, oracle G2 jac, check) summed against
        the G1 generator.  g1_entries: (scalar, oracle G1 jac, leg_id,
        check).  rhs_points[leg_id]: oracle G2 jac each G1 leg pairs with.
        ``check`` = 1 marks wire-sourced points that need the device-side
        r-torsion check (shares, ciphertext points); locally-derived
        points (public-key shares, hash-to-curve outputs) are exempt.
        """
        g2_entries: List[Tuple[int, Any, int]] = []
        g1_entries: List[Tuple[int, Any, int, int]] = []
        rhs: List[Any] = []
        leg_of: Dict[bytes, int] = {}

        def leg(key: bytes, point_jac: Any) -> int:
            if key not in leg_of:
                leg_of[key] = len(rhs)
                rhs.append(point_jac)
            return leg_of[key]

        for r, c in zip(reqs, coeffs):
            if r.kind == SIG_SHARE:
                pk, msg, share = r.payload
                g2_entries.append((c, share.g2.jac, 1))
                l = leg(canonical_bytes(b"m", msg), self.suite.hash_to_g2(msg).jac)
                g1_entries.append((c, (-pk.g1).jac, l, 0))
            elif r.kind == DEC_SHARE:
                pk, ct, share = r.payload
                l = leg(
                    canonical_bytes(b"c", ct.hash_input()),
                    self.suite.hash_to_g2(ct.hash_input()).jac,
                )
                g1_entries.append((c, share.g1.jac, l, 1))
                lw = leg(canonical_bytes(b"w", ct.w.to_bytes()), ct.w.jac)
                g1_entries.append((c, (-pk.g1).jac, lw, 0))
            else:
                (ct,) = r.payload
                g2_entries.append((c, ct.w.jac, 1))
                l = leg(
                    canonical_bytes(b"c", ct.hash_input()),
                    self.suite.hash_to_g2(ct.hash_input()).jac,
                )
                # -U is in the subgroup iff U is.
                g1_entries.append((c, (-ct.u).jac, l, 1))
        return g2_entries, g1_entries, rhs

    def _scan_prep(self, subsets: Sequence[Sequence[VerifyRequest]], kernel: bool | None = None,
                   dev: torch.device | None = None):
        """Host prep for one scan over independent RLC subsets (one chunk,
        or the halves of one bisection level): returns the scan stage's
        inputs on ``dev`` (default ``self.device``) and ``pair_sub``, the
        subset of each pair the stage will emit.  The inputs are a :class:`.scan.ScanInputs`
        for the K2 kernels when ``kernel`` (default: on a CUDA device),
        else the :func:`scan_stage` arguments.  Each subset gets its own
        Fiat-Shamir coefficients, exactly as if it were checked alone.
        A subset with no G1 (or G2) rows gets one identity row (scalar 0)
        so every stage sees a nonempty batch."""
        dev = self.device if dev is None else dev
        if kernel is None:
            kernel = dev.type == "cuda"
        ident1 = (1, 1, 0)
        ident2 = ((1, 0), (1, 0), (0, 0))
        g1e: List[Tuple[int, Any, int, int]] = []
        g1_sub: List[int] = []
        g2e: List[Tuple[int, Any, int]] = []
        g2_sub: List[int] = []
        rhs: List[Any] = []
        leg_sub: List[int] = []
        for s, reqs in enumerate(subsets):
            coeffs = _batch_coefficients(self.suite, reqs)
            s_g2e, s_g1e, s_rhs = self._build_legs(reqs, coeffs)
            if not s_rhs:
                s_rhs = [ident2]
            if not s_g1e:
                s_g1e = [(0, ident1, 0, 0)]
            if not s_g2e:
                s_g2e = [(0, ident2, 0)]
            off = len(rhs)
            g1e += [(c, p, l + off, chk) for c, p, l, chk in s_g1e]
            g1_sub += [s] * len(s_g1e)
            g2e += s_g2e
            g2_sub += [s] * len(s_g2e)
            rhs += s_rhs
            leg_sub += [s] * len(s_rhs)
        n_sub, nl = len(subsets), len(rhs)
        pair_sub = list(range(n_sub)) + leg_sub
        rhs_pts = dcurve.g2_to_dev(rhs, dev)
        gen_pt = tuple(x[0] for x in dcurve.g1_to_dev([ocurve.G1_GEN], dev))
        if kernel:
            inputs = dscan.prepare(
                [(c, p, chk) for c, p, _, chk in g1e], [l for _, _, l, _ in g1e], g1_sub,
                g2e, g2_sub, nl, n_sub, rhs_pts, gen_pt, dev,
            )
            return inputs, pair_sub

        def onehot(rows: int, cols: Sequence[int]) -> torch.Tensor:
            m = np.zeros((rows, len(cols)), dtype=np.int64)
            m[np.asarray(cols), np.arange(len(cols))] = 1
            return torch.as_tensor(m, device=dev)

        g1_pts = dcurve.g1_to_dev([p for _, p, _, _ in g1e], dev)
        g1_bits = dcurve.scalars_to_bits_lsb(
            [c for c, _, _, _ in g1e], dcurve.ENDO_NBITS, dev
        )
        g1_chk = torch.as_tensor([chk for _, _, _, chk in g1e], device=dev)
        seg = onehot(nl, [l for _, _, l, _ in g1e])
        g2_pts = dcurve.g2_to_dev([p for _, p, _ in g2e], dev)
        sq = [dcurve.decompose_g2_scalar(c) for c, _, _ in g2e]
        g2_bits_s = dcurve.scalars_to_bits([s for s, _ in sq], dcurve.G2_SCAN_NBITS, dev)
        g2_bits_q = dcurve.scalars_to_bits([q for _, q in sq], dcurve.G2_SCAN_NBITS, dev)
        g2_chk = torch.as_tensor([chk for _, _, chk in g2e], device=dev)
        args = (
            g1_pts, g1_bits, g1_chk, seg, onehot(n_sub, g1_sub),
            g2_pts, g2_bits_s, g2_bits_q, g2_chk, onehot(n_sub, g2_sub),
            rhs_pts, gen_pt,
        )
        return args, pair_sub

    def _scan(self, subsets: Sequence[Sequence[VerifyRequest]], dev: torch.device | None = None):
        """One scan stage over ``subsets`` on ``dev`` (default
        ``self.device``) — the K2 kernels on a CUDA device, the plain
        :func:`scan_stage` on the CPU; returns (sub_ok, lhs, rhs,
        pair_sub) with the tensors on ``dev`` and no host sync, so chunks
        queue back to back."""
        dev = self.device if dev is None else dev
        inputs, pair_sub = self._scan_prep(subsets, dev=dev)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return (*dscan.scan_stage_kernel(inputs), pair_sub)
        return (*scan_stage(*inputs), pair_sub)

    def _check_parts(self, parts) -> bool:
        """Combine one or more single-subset scan outputs into a single
        verdict: batched Miller loop over ALL pairs + ONE final
        exponentiation, AND of every part's subgroup bit.

        Soundness of the cross-chunk product check: each chunk is an RLC
        with Fiat-Shamir coefficients committed to that chunk's request
        contents, so the combined product == 1 test is one RLC over the
        union with blockwise-committed coefficients — an adversary must
        still grind the hash for an exact mod-r cancellation across the
        union.  On any False the caller re-checks per chunk, so verdicts
        are identical to the per-chunk path.  Parts scanned on other
        devices are gathered on ``self.device`` first.
        """
        dev = self.device
        lhs = tuple(torch.cat([p[1][c].to(dev) for p in parts]) for c in range(4))
        rhs = tuple(torch.cat([p[2][c].to(dev) for p in parts]) for c in range(4))
        ok = pair_stage(lhs, rhs, [0] * lhs[3].shape[0], 1)
        for p in parts:
            ok = ok & p[0].to(dev)
        return bool(ok.all())

    def _aggregate_ok_many(self, subsets: Sequence[Sequence[VerifyRequest]]) -> List[bool]:
        """Each subset's RLC verdict, all subsets in one scan stage and one
        pair stage (the same verdicts as checking each subset alone)."""
        sub_ok, lhs, rhs, pair_sub = self._scan(subsets)
        ok = pair_stage(lhs, rhs, pair_sub, len(subsets)) & sub_ok
        return [bool(v) for v in ok.cpu()]

    # -- public API ----------------------------------------------------

    @torch.inference_mode()
    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> List[bool]:
        reqs = list(reqs)
        if not reqs:
            return []
        out = [False] * len(reqs)
        # Host: structure + on-curve only; the r-torsion checks run
        # batched in the scan stage (subgroup=False here).
        idxs = [
            i
            for i, r in enumerate(reqs)
            if request_well_formed(self.suite, r, subgroup=False)
        ]
        chunks = [idxs[s : s + self.chunk] for s in range(0, len(idxs), self.chunk)]
        # Queue every chunk's scan before reading any verdict: the card
        # runs them back to back and the host syncs once.  Sharded, chunk
        # k scans on devices[k % len(devices)].
        devs = self.devices
        scans = [
            self._scan([[reqs[i] for i in c]], devs[k % len(devs)])
            for k, c in enumerate(chunks)
        ]
        if len(chunks) > 1:
            # Fast path: ALL chunks' pairs through one batched Miller
            # loop + one final exponentiation.
            if self._check_parts(scans):
                for c in chunks:
                    for i in c:
                        out[i] = True
                return out
        for c, part in zip(chunks, scans):
            if self._check_parts([part]):
                for i in c:
                    out[i] = True
            else:
                self._bisect(reqs, c, out)
        return out

    def _bisect(
        self, all_reqs: List[VerifyRequest], idxs: List[int], out: List[bool]
    ) -> None:
        """Bisection fallback — the caller knows idxs' aggregate FAILED.

        The reference recurses depth-first, one aggregate check (a scan
        and a pair stage) per half.  Here every half of one bisection
        level is checked in one scan and one pair stage: the same halves,
        the same coefficients and the same verdicts.  Each stage has a
        floor whatever its rows (a K3 pair stage takes ~7.4 ms on an H100
        at 10 pairs, ``pair_miller`` a warp per pair and ``pair_final`` a
        warp per subset; ``PERF.md`` §6), so this pays one stage per level
        instead of one per half.
        ``benchmarks_torch/bisect_ab.py`` times the two orders against
        each other on the mixed-512 batch; ``PERF.md`` keeps its numbers.
        Single failing requests go to :class:`EagerBackend`.
        """
        failing = [idxs]
        while failing:
            halves = []
            for group in failing:
                if len(group) == 1:
                    i = group[0]
                    out[i] = self._eager.verify_batch([all_reqs[i]])[0]
                else:
                    mid = len(group) // 2
                    halves += [group[:mid], group[mid:]]
            if not halves:
                return
            oks = self._aggregate_ok_many(
                [[all_reqs[i] for i in h] for h in halves]
            )
            failing = []
            for half, ok in zip(halves, oks):
                if ok:
                    for i in half:
                        out[i] = True
                else:
                    failing.append(half)


class HybridBackend(CryptoBackend):
    """Route each flush by size: ``min_device_batch`` requests or more to
    the card's :class:`TorchBackend`, smaller ones to the host
    :class:`~hbbft_tpu_torch.crypto.backend.BatchedBackend` (small flushes
    are latency-bound either way).

    Counterpart of ``hbbft_tpu/crypto/tpu/backend.py`` ``HybridBackend``
    without its two failovers: ``device=None`` builds ``TorchBackend`` on
    ``cuda``, which raises without a card (the reference probed for an
    accelerator and went host-only when none answered), and a device
    flush that raises propagates (the reference served that flush and
    every later one from the host).  Host-only is the caller's explicit
    choice: ``device=HybridBackend.NO_DEVICE``.  :attr:`on_device` is true
    only with a device backend, so a crypto service fails a host-only
    flush that raises over to its clients' fallback, as the reference
    does, and lets a device backend's error reach its callers.

    Verdict-identical to both constituents by construction: every
    backend implements the same RLC/bisection semantics.
    """

    # Pass as ``device=`` for host-only mode (None means "the card").
    NO_DEVICE: Any = object()

    def __init__(
        self,
        suite: BLSSuite | None = None,
        min_device_batch: int = 64,
        device: CryptoBackend | None = None,
        host: CryptoBackend | None = None,
    ) -> None:
        self.suite = suite or BLSSuite()
        self.min_device_batch = min_device_batch
        self.host = host or BatchedBackend(self.suite)
        if device is HybridBackend.NO_DEVICE:
            self.device: CryptoBackend | None = None
        elif device is not None:
            self.device = device
        else:
            self.device = TorchBackend(self.suite)

    @property
    def on_device(self) -> bool:
        return self.device is not None

    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> List[bool]:
        reqs = list(reqs)
        if self.device is not None and len(reqs) >= self.min_device_batch:
            return self.device.verify_batch(reqs)
        return self.host.verify_batch(reqs)
