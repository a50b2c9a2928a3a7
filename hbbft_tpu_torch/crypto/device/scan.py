"""The flush's scan stage on the card: the K2 kernels (``csrc/scan.cu``).

Counterpart of the reference's ``hbbft_tpu/crypto/tpu/backend.py``
``_scan_kernel`` and of the port's plain :func:`backend.scan_stage`, with
the same outputs: ``(sub_ok, lhs, rhs)`` in the port's limb format, the
pairs :func:`backend.pair_stage` takes.

The kernel takes its inputs in its own layout, made on the host by
:func:`prepare`:

* the RLC coefficients as packed 32-bit words — ``(n, 4)`` words of c
  for G1, ``(n, 5)`` words of s then q (c = q·|x| + s) for G2 — not the
  plain scan's bit matrices;
* the G1 rows ordered by leg (legs are numbered subset by subset, so this
  is the (subset, leg) order) and the G2 rows by subset, so every sum is
  a contiguous range of rows;
* each sum cut into pieces of at most :data:`PIECE_ROWS` rows that never
  cross a segment: the first sum launch adds the rows of each piece, the
  second the pieces of each segment (blocks cannot carry a sum across).
  ``scan_g1_sums`` and ``scan_g2_sums`` run a block per piece or segment,
  whose teams of lanes (four for G1, six for G2) add its points by a
  pairwise tree (64 points at a time; a segment of more pieces is summed
  63 more at a time).

:func:`scan_stage_kernel` checks device, dtype, shape and contiguity,
launches the four kernels and counts each launch in
``build.LAUNCHES[name]``.  It runs only on CUDA tensors; there is no
fallback (the plain ``scan_stage`` is the CPU path).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from hbbft_tpu_torch import build
from hbbft_tpu_torch.crypto.device import curve as dcurve
from hbbft_tpu_torch.crypto.device import fq

G1_ROWS = "scan_g1_rows"
G2_ROWS = "scan_g2_rows"
G1_SUMS = "scan_g1_sums"
G2_SUMS = "scan_g2_sums"
KERNELS = (G1_ROWS, G2_ROWS, G1_SUMS, G2_SUMS)

PIECE_ROWS = 32  # rows of a piece: one block's in the first sum launch
G1_REC = 3 * 12 + 1  # 32-bit words of one internal G1 point record
G2_REC = 6 * 12 + 1

I32 = torch.int32
I64 = torch.int64


@dataclass
class ScanInputs:
    """One scan stage's inputs in the kernels' layout (see module notes).

    ``*_pts`` are port points ``(x, y, z, inf)``; ``*_words`` the packed
    coefficients; ``*_chk``/``*_sub`` per-row int32 check mask and
    subset; ``*_pieces`` int32 row offsets of the pieces and
    ``*_segments`` int32 piece offsets of the segments (legs for G1,
    subsets for G2).  ``rhs_g2`` and ``gen_pt`` pass through to the pairs.
    """

    g1_pts: dcurve.Point
    g1_words: torch.Tensor
    g1_chk: torch.Tensor
    g1_sub: torch.Tensor
    g1_pieces: torch.Tensor
    g1_segments: torch.Tensor
    g2_pts: dcurve.Point
    g2_words: torch.Tensor
    g2_chk: torch.Tensor
    g2_sub: torch.Tensor
    g2_pieces: torch.Tensor
    g2_segments: torch.Tensor
    rhs_g2: dcurve.Point
    gen_pt: dcurve.Point
    n_sub: int


def pack_words(values: Sequence[int], nbytes: int) -> np.ndarray:
    """Host: nonnegative ints -> (n, nbytes/4) little-endian 32-bit words,
    as int32 (the kernel reads them as uint32)."""
    limit = 1 << (8 * nbytes)
    for v in values:
        if not 0 <= v < limit:
            raise ValueError(f"value does not fit {8 * nbytes} bits")
    data = b"".join(v.to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(data, dtype="<u4").reshape(len(values), nbytes // 4).view(np.int32)


def cut_pieces(segment_of_row: Sequence[int], n_segments: int,
               piece_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host: the pieces of sorted rows.  ``segment_of_row`` is
    nondecreasing and every segment has at least one row.  Returns the
    row offsets of the pieces (n_pieces + 1,) and the piece offsets of the
    segments (n_segments + 1,), both int32; no piece crosses a segment."""
    seg = np.asarray(segment_of_row, dtype=np.int64)
    counts = np.bincount(seg, minlength=n_segments)
    if len(counts) != n_segments or (counts == 0).any() or (np.diff(seg) < 0).any():
        raise ValueError("rows must be sorted by segment and cover every segment")
    row_starts = [0]
    seg_starts = [0]
    for c in counts.tolist():
        base = row_starts[-1]
        row_starts += [base + k for k in range(piece_rows, c, piece_rows)]
        row_starts.append(base + c)
        seg_starts.append(len(row_starts) - 1)
    return np.asarray(row_starts, dtype=np.int32), np.asarray(seg_starts, dtype=np.int32)


def prepare(g1_rows, g1_legs: Sequence[int], g1_sub: Sequence[int],
            g2_rows, g2_sub: Sequence[int], n_legs: int, n_sub: int,
            rhs_g2: dcurve.Point, gen_pt: dcurve.Point, device) -> ScanInputs:
    """Host prep for :func:`scan_stage_kernel`.

    ``g1_rows``: (coefficient, oracle G1 jac, check) per row, with leg
    ``g1_legs[i]`` and subset ``g1_sub[i]``; ``g2_rows``: (coefficient,
    oracle G2 jac, check) with subset ``g2_sub[i]``.  Rows are reordered
    here (stable) by leg and by subset."""
    order1 = sorted(range(len(g1_rows)), key=lambda i: g1_legs[i])
    order2 = sorted(range(len(g2_rows)), key=lambda i: g2_sub[i])
    r1 = [g1_rows[i] for i in order1]
    r2 = [g2_rows[i] for i in order2]
    pieces1, segs1 = cut_pieces([g1_legs[i] for i in order1], n_legs, PIECE_ROWS)
    pieces2, segs2 = cut_pieces([g2_sub[i] for i in order2], n_sub, PIECE_ROWS)
    sq = [dcurve.decompose_g2_scalar(c) for c, _, _ in r2]

    def dev(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a), device=device)

    return ScanInputs(
        g1_pts=dcurve.g1_to_dev([p for _, p, _ in r1], device),
        g1_words=dev(pack_words([c for c, _, _ in r1], 16)),
        g1_chk=dev(np.asarray([chk for _, _, chk in r1], dtype=np.int32)),
        g1_sub=dev(np.asarray([g1_sub[i] for i in order1], dtype=np.int32)),
        g1_pieces=dev(pieces1),
        g1_segments=dev(segs1),
        g2_pts=dcurve.g2_to_dev([p for _, p, _ in r2], device),
        g2_words=dev(pack_words([s + (q << 64) for s, q in sq], 20)),
        g2_chk=dev(np.asarray([chk for _, _, chk in r2], dtype=np.int32)),
        g2_sub=dev(np.asarray([g2_sub[i] for i in order2], dtype=np.int32)),
        g2_pieces=dev(pieces2),
        g2_segments=dev(segs2),
        rhs_g2=rhs_g2,
        gen_pt=gen_pt,
        n_sub=n_sub,
    )


@lru_cache(maxsize=None)
def _launcher(name: str):
    """One of the kernels' C entry points, built and loaded at first use."""
    fn = getattr(build.load("scan"), f"hbbft_{name}")
    ptr = ctypes.c_void_p
    if name in (G1_ROWS, G2_ROWS):
        fn.argtypes = [ptr] * 7 + [ctypes.c_int, ptr, ptr, ptr]
    else:
        fn.argtypes = [ptr, ptr, ctypes.c_int] + [ptr] * 6
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_points(pts: dcurve.Point, what: str, n: int, elem: Tuple[int, ...], device) -> None:
    for c, name in zip(pts[:3], "xyz"):
        _check(c, f"{what}.{name}", I64, (n, *elem), device)
    _check(pts[3], f"{what}.inf", I64, (n,), device)


def _launch(name: str, *args) -> None:
    fn = _launcher(name)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*ptrs, stream)
    build.LAUNCHES[name] += 1
    build.check(rc, f"hbbft_{name}")


def rows(group: int, inp: ScanInputs, sub_ok: torch.Tensor) -> torch.Tensor:
    """One row launch (``group`` 1 or 2): every row's [c]P as an internal
    record, clearing ``sub_ok[subset]`` where a checked row fails."""
    pts, words, chk, sub, name, rec = (
        (inp.g1_pts, inp.g1_words, inp.g1_chk, inp.g1_sub, G1_ROWS, G1_REC) if group == 1
        else (inp.g2_pts, inp.g2_words, inp.g2_chk, inp.g2_sub, G2_ROWS, G2_REC))
    n = words.shape[0]
    scaled = torch.empty((n, rec), dtype=I32, device=words.device)
    _launch(name, pts[0], pts[1], pts[2], pts[3], words, chk, sub, n, scaled, sub_ok)
    return scaled


def sums(group: int, inp: ScanInputs, scaled: torch.Tensor) -> dcurve.Point:
    """The two sum launches (``group`` 1 or 2): rows -> pieces -> one
    sum per segment, in the port's limb format."""
    pieces, segments, name, rec, elem = (
        (inp.g1_pieces, inp.g1_segments, G1_SUMS, G1_REC, (fq.NL,)) if group == 1
        else (inp.g2_pieces, inp.g2_segments, G2_SUMS, G2_REC, (2, fq.NL)))
    dev = scaled.device
    n_pieces, n_seg = pieces.shape[0] - 1, segments.shape[0] - 1
    partial = torch.empty((n_pieces, rec), dtype=I32, device=dev)
    _launch(name, scaled, pieces, n_pieces, partial, None, None, None, None)
    x, y, z = (torch.empty((n_seg, *elem), dtype=I64, device=dev) for _ in range(3))
    inf = torch.empty((n_seg,), dtype=I64, device=dev)
    _launch(name, partial, segments, n_seg, None, x, y, z, inf)
    return (x, y, z, inf)


def check_inputs(inp: ScanInputs) -> None:
    """Raise unless ``inp`` is what the kernels take: one CUDA device,
    int32/int64 as listed, consistent shapes, contiguous."""
    dev = inp.g1_pts[0].device
    if dev.type != "cuda":
        raise ValueError("the scan kernels need CUDA tensors")
    n1, n2, n_sub = inp.g1_words.shape[0], inp.g2_words.shape[0], inp.n_sub
    n_legs = inp.g1_segments.shape[0] - 1
    g2e = (2, fq.NL)
    _check_points(inp.g1_pts, "g1_pts", n1, (fq.NL,), dev)
    _check(inp.g1_words, "g1_words", I32, (n1, 4), dev)
    _check(inp.g1_chk, "g1_chk", I32, (n1,), dev)
    _check(inp.g1_sub, "g1_sub", I32, (n1,), dev)
    _check(inp.g1_pieces, "g1_pieces", I32, inp.g1_pieces.shape, dev)
    _check(inp.g1_segments, "g1_segments", I32, inp.g1_segments.shape, dev)
    _check_points(inp.g2_pts, "g2_pts", n2, g2e, dev)
    _check(inp.g2_words, "g2_words", I32, (n2, 5), dev)
    _check(inp.g2_chk, "g2_chk", I32, (n2,), dev)
    _check(inp.g2_sub, "g2_sub", I32, (n2,), dev)
    _check(inp.g2_pieces, "g2_pieces", I32, inp.g2_pieces.shape, dev)
    _check(inp.g2_segments, "g2_segments", I32, (n_sub + 1,), dev)
    _check_points(inp.rhs_g2, "rhs_g2", n_legs, g2e, dev)
    if min(n1, n2, n_sub, n_legs) < 1:
        raise ValueError("a scan stage needs at least one G1 row, G2 row, subset and leg")
    if inp.g1_pieces.shape[0] < 2 or inp.g2_pieces.shape[0] < 2:
        raise ValueError("a scan stage needs at least one piece per group")


def scan_stage_kernel(inp: ScanInputs) -> Tuple[torch.Tensor, dcurve.Point, dcurve.Point]:
    """The scan stage on the card: (sub_ok (n_sub,) bool, lhs, rhs) with
    the pairs ordered as :func:`backend.scan_stage` orders them — first
    (G1 generator, subset's G2 generator-leg sum) per subset, then (leg
    sum l, rhs_l) per leg.  Launches on the current stream; no sync."""
    check_inputs(inp)
    dev, n_sub = inp.g1_pts[0].device, inp.n_sub
    with torch.cuda.device(dev):
        sub_ok = torch.ones((n_sub,), dtype=I32, device=dev)
        scaled1 = rows(1, inp, sub_ok)
        scaled2 = rows(2, inp, sub_ok)
        leg_sums = sums(1, inp, scaled1)
        gen_legs = sums(2, inp, scaled2)
    gen = tuple(c[None].expand(n_sub, *c.shape) for c in inp.gen_pt)
    lhs = tuple(torch.cat([gen[c], leg_sums[c]]) for c in range(4))
    rhs = tuple(torch.cat([gen_legs[c], inp.rhs_g2[c]]) for c in range(4))
    return sub_ok.bool(), lhs, rhs
