"""Native (C++) protocol-plane engine: bindings + the engine-backed net.

Reference behavior: the reference's consensus stack is native code end to
end; ``csrc/native/engine.cpp`` is this framework's equivalent for the
message-intensive layers (Broadcast, SBV/BA + coin, ThresholdDecrypt,
Subset, the HoneyBadger epoch loop) over the scalar test suite, running
a whole simulated network (the VirtualNet crank loop) inside one C++
queue.  The per-BATCH layers stay in Python and are REUSED, not
reimplemented: :class:`NativeDhb` subclasses the real
``DynamicHoneyBadger`` (votes, DKG, era logic) and plugs an engine
facade in place of its inner HoneyBadger; ``QueueingHoneyBadger`` runs
unmodified on top.

Fidelity: the engine commits byte-identical batches and fault logs to
the pure-Python VirtualNet at the same seed (tests/test_native_engine.py
pins this at several N).  Randomness stays in Python — the engine calls
back / is called at exactly the points the Python stack would consume
the node rng, so the streams match by construction.

Scope: int node ids 0..N-1, no adversary (FIFO delivery, silent
crash-faulty nodes).  Two crypto configurations:

* **ScalarSuite (native)** — the engine computes the scalar-suite
  checks itself; protocol-plane benchmark configuration (BASELINE
  configs 3/4).  Round 7: COIN/DECRYPT share checks are verified per
  Ts/Td instance GROUP with one random-linear-combination check at the
  pool flush (``HBBFT_TORCH_COIN_RLC=0`` / ``rlc=False`` restores the
  per-share submit-time path), and ``flush_every`` now also governs the
  scalar cadence when RLC is on — 1 keeps the pre-round-7 per-unit
  flush points byte-for-byte, 0 defers to queue-dry for maximal
  grouping with identical protocol outputs and fault sets (the
  deferred-verification invariant; tests/test_native_rlc.py).
* **External crypto (round 3)** — any real :class:`Suite` (BLS12-381):
  group elements travel through the engine as opaque bytes; signing,
  combining and ciphertext parsing call back into Python per instance,
  and verifications accumulate in the engine's per-node pools until a
  flush routes them through a pluggable
  :class:`~hbbft_tpu_torch.crypto.backend.CryptoBackend` (Eager / Batched RLC
  / TorchBackend) — the reference runs real ``threshold_crypto`` under
  its native stack throughout (SURVEY.md §2 #14); this is the
  device-batched equivalent with the deferred-verify flush.
  ``flush_every`` mirrors the VirtualNet knob; 0 = flush only when the
  delivery queue runs dry (maximal amortization — identical outputs by
  the deferred-verification invariant).

Copy of ``hbbft_tpu/native_engine.py`` over the port's protocols, serde,
keys and pool.  The engine is ``csrc/native/engine.cpp`` (a copy of the
reference's, its edits listed at its top), built by
:func:`hbbft_tpu_torch.build.build_host` at first use.  Where it differs:

* **The default backend** of external crypto is
  :func:`~hbbft_tpu_torch.crypto.backend.default_backend`: the card's
  ``TorchBackend`` for BLS (which raises with no card), the host
  ``BatchedBackend`` for the scalar suite.
* **A failed flush stops the run.**  The reference traps an exception
  raised inside the verify callback, leaves that flush's verdicts
  False, and re-raises only after ``hbe_run`` returns, so honest shares
  meanwhile count as rejected.  Here the callback stops the engine at
  that flush (``hbe_abort``): none of its verdicts is acted on, no fault
  is recorded, and the original error (``DeviceFlushError`` or the
  kernel's own) reaches the caller of ``run``, ``run_until``, ``flush``
  or ``send_input``.  The engine stays stopped; later calls raise.
* **The sanitizer tier's override** is a function, not an environment
  variable: :func:`use_engine_build` selects an ASan, UBSan or TSan
  build of the engine before the first net is made, and every width is
  then built and loaded under that sanitizer (the reference loads one
  pre-built library, named by an environment variable, whatever width
  a net asks for).
"""

from __future__ import annotations

import ctypes
import os
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.crypto.backend import (
    CryptoBackend,
    VerifyRequest,
    default_backend,
)
from hbbft_tpu_torch.crypto.keys import (
    Ciphertext,
    DecryptionShare,
    SecretKey,
    SecretKeySet,
    SignatureShare,
)
from hbbft_tpu_torch.crypto.pool import VerifySink
from hbbft_tpu_torch.crypto.suite import ScalarSuite, Suite
from hbbft_tpu_torch.protocols.dynamic_honey_badger import (
    DhbBatch,
    DynamicHoneyBadger,
    InternalContrib,
    SignedKeyGenMsg,
)
from hbbft_tpu_torch.protocols.honey_badger import Batch, EncryptionSchedule
from hbbft_tpu_torch.protocols.network_info import NetworkInfo
from hbbft_tpu_torch.protocols.queueing_honey_badger import QueueingHoneyBadger
from hbbft_tpu_torch.protocols.traits import Step
from hbbft_tpu_torch.utils import canonical_bytes, serde

# One shared library per NodeSet width (-DHBE_WORDS): the 4-word build
# serves the common <= 256-node range at full speed; wider builds are
# compiled on demand for larger networks (see engine.cpp's NodeSet).


def _words_for(n: int) -> int:
    w = 4
    while 64 * w < n:
        w *= 2
    return w

_BATCH_CB = ctypes.CFUNCTYPE(None, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32)
_CONTRIB_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_int32,
    ctypes.c_int32,
    ctypes.c_int32,
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_uint64,
)
_VERIFY_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)
)
_SIGN_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_int32,
    ctypes.c_int32,
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_uint64,
    ctypes.c_void_p,
)
_COMBINE_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.c_int32,
    ctypes.c_int32,
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_uint64,
    ctypes.c_int32,
    ctypes.c_void_p,
)
_CT_PARSE_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64
)
_PRE_CRANK_CB = ctypes.CFUNCTYPE(None, ctypes.c_uint64)
_TAMPER_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_int32, ctypes.c_int32,
)


# The engine build every later load takes: None for the normal build, or
# a sanitizer of build.SANITIZERS (use_engine_build).
_ENGINE_BUILD: Optional[str] = None
# A symbol each sanitizer's runtime defines: present in the process's
# global namespace only when the runtime was LD_PRELOADed (an ASan or
# TSan runtime that a dlopen pulls in later kills the process instead).
_RUNTIME_SYMBOL = {"address": "__asan_init", "thread": "__tsan_init"}


def use_engine_build(sanitizer: Optional[str]) -> None:
    """Select the engine build that nets made from now on load:
    ``"address"``, ``"undefined"`` or ``"thread"`` for the sanitizer tier
    (the engine compiled ``-O1 -g`` under that sanitizer, built at first
    use at the NodeSet width each net needs), or None for the normal
    build.  Call it before the first engine is loaded.  The python that
    loads an ASan or TSan build must have the sanitizer's runtime
    ``LD_PRELOAD``ed (``build.sanitizer_runtime``); a sanitized build
    that cannot be built or loaded raises ``RuntimeError`` from the net's
    constructor and never reads as "unavailable"."""
    global _ENGINE_BUILD
    from hbbft_tpu_torch import build

    if sanitizer is not None and sanitizer not in build.SANITIZERS:
        raise ValueError(f"no sanitizer {sanitizer!r}; one of {sorted(build.SANITIZERS)}")
    if _LIBS and sanitizer != _ENGINE_BUILD:
        raise RuntimeError("an engine is loaded already: select its build before the first net")
    _ENGINE_BUILD = sanitizer


def _open_sanitized(words: int, sanitizer: str) -> ctypes.CDLL:
    """Build and load the ``sanitizer`` engine of width ``words``."""
    from hbbft_tpu_torch import build

    runtime = build.SANITIZER_RUNTIMES[sanitizer]
    symbol = _RUNTIME_SYMBOL.get(sanitizer)
    if symbol is not None and not hasattr(ctypes.CDLL(None), symbol):
        raise RuntimeError(
            f"the {sanitizer} engine build needs its runtime first in the process: "
            f"LD_PRELOAD={runtime} (build.sanitizer_runtime({sanitizer!r}))"
        )
    path = build.build_host("engine", words, sanitizer=sanitizer)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        raise RuntimeError(
            f"the {sanitizer} engine build {path.name} failed to load; its runtime "
            f"{runtime} must be LD_PRELOADed"
        ) from exc
    lib.hbe_words.restype = ctypes.c_int32
    lib.hbe_words.argtypes = []
    if lib.hbe_words() != words:
        raise RuntimeError(f"{path.name} was built with -DHBE_WORDS={lib.hbe_words()}, "
                           f"not {words}")
    return lib


def _load(words: int) -> ctypes.CDLL:
    """Build (at first use) and load the engine of NodeSet width
    ``words`` of the build :func:`use_engine_build` selected; raises
    ``RuntimeError`` when it cannot be built."""
    from hbbft_tpu_torch import build

    # The vectorized field plane: field_ifma.cpp is the only unit
    # compiled with -mavx512ifma (dropped on toolchains without it — the
    # stub arm compiles instead, and the runtime dispatch keeps scalar);
    # field_plane.h / sha3_plane.h are header deps of engine.cpp, so
    # edits rebuild every width (build.host_library_path hashes them).
    if _ENGINE_BUILD is None:
        lib = ctypes.CDLL(str(build.build_host("engine", words)))
    else:
        lib = _open_sanitized(words, _ENGINE_BUILD)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.hbe_create.restype = ctypes.c_void_p
    lib.hbe_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.hbe_destroy.argtypes = [ctypes.c_void_p]
    lib.hbe_set_callbacks.argtypes = [ctypes.c_void_p, _BATCH_CB, _CONTRIB_CB]
    lib.hbe_set_silent.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    init_args = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_uint64,
        i32p, ctypes.c_int32, ctypes.c_int32, u8p, u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.hbe_init_node.argtypes = init_args
    lib.hbe_restart_node.argtypes = init_args
    lib.hbe_replay_era.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hbe_propose.restype = ctypes.c_int32
    lib.hbe_propose.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_uint64,
    ]
    lib.hbe_run.restype = ctypes.c_uint64
    lib.hbe_run.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.hbe_abort.restype = None
    lib.hbe_abort.argtypes = [ctypes.c_void_p]
    lib.hbe_run_mt.restype = ctypes.c_uint64
    lib.hbe_run_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32,
    ]
    lib.hbe_queue_len.restype = ctypes.c_uint64
    lib.hbe_queue_len.argtypes = [ctypes.c_void_p]
    lib.hbe_delivered.restype = ctypes.c_uint64
    lib.hbe_delivered.argtypes = [ctypes.c_void_p]
    for name in ("hbe_epoch", "hbe_era", "hbe_has_proposed"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hbe_batch_size.restype = ctypes.c_int32
    lib.hbe_batch_size.argtypes = [ctypes.c_void_p]
    lib.hbe_batch_proposer.restype = ctypes.c_int32
    lib.hbe_batch_proposer.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hbe_batch_payload_len.restype = ctypes.c_uint64
    lib.hbe_batch_payload_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hbe_batch_payload.argtypes = [ctypes.c_void_p, ctypes.c_int32, u8p]
    lib.hbe_fault_count.restype = ctypes.c_int32
    lib.hbe_fault_count.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hbe_fault_subject.restype = ctypes.c_int32
    lib.hbe_fault_subject.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.hbe_fault_kind.restype = ctypes.c_char_p
    lib.hbe_fault_kind.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    # external-crypto mode
    lib.hbe_set_ext_crypto.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _VERIFY_CB, _SIGN_CB, _COMBINE_CB,
        _CT_PARSE_CB,
    ]
    lib.hbe_set_flush_every.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hbe_set_rlc.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hbe_set_pre_crank.argtypes = [ctypes.c_void_p, _PRE_CRANK_CB]
    lib.hbe_queue_swap.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.hbe_queue_dest.restype = ctypes.c_int32
    lib.hbe_queue_dest.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    # tampering adversary (TamperingAdversary mirror)
    lib.hbe_set_tamper.restype = None
    lib.hbe_set_tamper.argtypes = [ctypes.c_void_p, _TAMPER_CB]
    lib.hbe_set_tampered.restype = None
    lib.hbe_set_tampered.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.hbe_tamper_bval.restype = ctypes.c_int32
    lib.hbe_tamper_bval.argtypes = [ctypes.c_void_p]
    lib.hbe_tamper_set_bval.restype = None
    lib.hbe_tamper_set_bval.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ("hbe_tamper_flip_root", "hbe_tamper_corrupt_proof"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p]
    lib.hbe_tamper_share_len.restype = ctypes.c_uint64
    lib.hbe_tamper_share_len.argtypes = [ctypes.c_void_p]
    lib.hbe_tamper_share.restype = None
    lib.hbe_tamper_share.argtypes = [ctypes.c_void_p, u8p]
    lib.hbe_tamper_set_share.restype = None
    lib.hbe_tamper_set_share.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    # delivery profiling counters (BASELINE.md round-3 workflow)
    for name in ("hbe_prof_cycles", "hbe_prof_count"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.hbe_pending_verifies.restype = ctypes.c_uint64
    lib.hbe_pending_verifies.argtypes = [ctypes.c_void_p]
    # scalar-suite KEM fast path (stateless; used by crypto/keys.py)
    lib.hbe_kem_decrypt.restype = ctypes.c_int32
    lib.hbe_kem_decrypt.argtypes = [u8p, u8p, ctypes.c_uint64, u8p, u8p, u8p]
    lib.hbe_kem_encrypt.restype = None
    lib.hbe_kem_encrypt.argtypes = [
        u8p, u8p, ctypes.c_uint64, u8p, u8p, u8p, u8p,
    ]
    # scalar DKG fast path (stateless registry; bytes args pass as
    # c_char_p so Python bytes cross zero-copy)
    cp = ctypes.c_char_p
    lib.hbe_kem_encrypt_batch.restype = None
    lib.hbe_kem_encrypt_batch.argtypes = [
        cp, cp, ctypes.c_int32, cp, u8p, u8p, u8p,
    ]
    lib.hbe_dkg_register.restype = ctypes.c_int64
    lib.hbe_dkg_register.argtypes = [cp, ctypes.c_int32, cp, cp]
    lib.hbe_dkg_registry_size.restype = ctypes.c_uint64
    lib.hbe_dkg_registry_size.argtypes = []
    lib.hbe_dkg_clear.restype = None
    lib.hbe_dkg_clear.argtypes = []
    lib.hbe_serde_scan.restype = ctypes.c_int64
    lib.hbe_serde_scan.argtypes = [
        cp, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64), ctypes.c_uint64,
        ctypes.c_int64, ctypes.c_uint64,
    ]
    # cluster (one-engine-per-node) mode + wire codec (round 9): the
    # message-boundary API — batch frame ingress, epoch-gated egress
    # drain, and the decode/roundtrip test surface.
    lib.hbe_set_local.restype = None
    lib.hbe_set_local.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.hbe_node_egress_bytes.restype = ctypes.c_uint64
    lib.hbe_node_egress_bytes.argtypes = [ctypes.c_void_p]
    lib.hbe_node_egress_drain.restype = ctypes.c_int64
    lib.hbe_node_egress_drain.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    # MSGB wire fast path (round 20 coalescing)
    lib.hbe_node_ingest_wire.restype = ctypes.c_int64
    lib.hbe_node_ingest_wire.argtypes = [
        ctypes.c_void_p, i32p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32, cp,
    ]
    lib.hbe_node_egress_drain_msgb.restype = ctypes.c_int64
    lib.hbe_node_egress_drain_msgb.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u8p, ctypes.c_uint64,
    ]
    lib.hbe_node_stat.restype = ctypes.c_uint64
    lib.hbe_node_stat.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    # flight recorder (round 12): bounded milestone event ring
    lib.hbe_trace_enable.restype = None
    lib.hbe_trace_enable.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.hbe_trace_drain.restype = ctypes.c_int64
    lib.hbe_trace_drain.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    lib.hbe_trace_pending.restype = ctypes.c_uint64
    lib.hbe_trace_pending.argtypes = [ctypes.c_void_p]
    lib.hbe_trace_dropped.restype = ctypes.c_uint64
    lib.hbe_trace_dropped.argtypes = [ctypes.c_void_p]
    lib.hbe_wire_classify.restype = ctypes.c_int32
    lib.hbe_wire_classify.argtypes = [cp, ctypes.c_uint64]
    lib.hbe_wire_roundtrip.restype = ctypes.c_int64
    lib.hbe_wire_roundtrip.argtypes = [cp, ctypes.c_uint64, u8p, ctypes.c_uint64]
    lib.hbe_dkg_ack_check.restype = ctypes.c_int32
    lib.hbe_dkg_ack_check.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, cp, cp, cp, cp, u8p,
    ]
    lib.hbe_dkg_row_check.restype = ctypes.c_int32
    lib.hbe_dkg_row_check.argtypes = [
        ctypes.c_int64, ctypes.c_int32, cp, ctypes.c_int32,
    ]
    # batch DKG digest (round 6): whole-batch ack/part checks + the
    # vectorized Lagrange/combine entry points
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hbe_dkg_ack_check_batch.restype = ctypes.c_int32
    lib.hbe_dkg_ack_check_batch.argtypes = [
        i64p, i32p, ctypes.c_int32, ctypes.c_int32, cp, cp, cp, cp,
        i32p, u8p,
    ]
    lib.hbe_dkg_part_check_batch.restype = ctypes.c_int32
    lib.hbe_dkg_part_check_batch.argtypes = [
        i64p, ctypes.c_int32, ctypes.c_int32, cp, cp, cp, ctypes.c_int32,
        cp, i32p, u8p,
    ]
    lib.hbe_scalar_interp_sum.restype = ctypes.c_int32
    lib.hbe_scalar_interp_sum.argtypes = [
        i32p, cp, i32p, ctypes.c_int32, cp, u8p,
    ]
    lib.hbe_scalar_combine_unmask.restype = ctypes.c_int32
    lib.hbe_scalar_combine_unmask.argtypes = [
        i32p, ctypes.c_int32, cp, cp, cp, ctypes.c_uint64, u8p,
    ]
    lib.hbe_dkg_row_evals.restype = None
    lib.hbe_dkg_row_evals.argtypes = [
        cp, ctypes.c_int32, ctypes.c_int32, u8p,
    ]
    # SIMD field-plane dispatch + kernel fuzz surface:
    # hbe_simd_mode reports the resolved arm (1 = AVX-512 IFMA, 0 =
    # scalar), hbe_simd_force pins it in-process for both-arm
    # equivalence tests (-1 = back to HBBFT_TORCH_SIMD/auto).
    for name in ("hbe_simd_mode", "hbe_simd_compiled"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = []
    lib.hbe_simd_force.restype = ctypes.c_int32
    lib.hbe_simd_force.argtypes = [ctypes.c_int32]
    lib.hbe_field_mul_batch.restype = None
    lib.hbe_field_mul_batch.argtypes = [cp, cp, ctypes.c_int32, u8p]
    lib.hbe_field_dot.restype = None
    lib.hbe_field_dot.argtypes = [cp, cp, ctypes.c_int32, u8p]
    lib.hbe_field_lagrange.restype = None
    lib.hbe_field_lagrange.argtypes = [i32p, ctypes.c_int32, u8p]
    lib.hbe_field_rlc_accum.restype = None
    lib.hbe_field_rlc_accum.argtypes = [cp, cp, ctypes.c_int32, u8p]
    # Batched sha3 plane + epoch arena: the sha3 fuzz/stats
    # surface and the arena high-water-mark telemetry.
    lib.hbe_sha3_batch.restype = None
    lib.hbe_sha3_batch.argtypes = [
        cp, ctypes.c_uint64, ctypes.c_uint64, u8p,
    ]
    lib.hbe_sha3_stats.restype = None
    lib.hbe_sha3_stats.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
    lib.hbe_arena_stats.restype = None
    lib.hbe_arena_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.hbe_flush.restype = None
    lib.hbe_flush.argtypes = [ctypes.c_void_p]
    lib.hbe_ret_bytes.restype = None
    lib.hbe_ret_bytes.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64]
    for name in ("hbe_vreq_kind", "hbe_vreq_era", "hbe_vreq_sender",
                 "hbe_comb_index"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ("hbe_vreq_doc_len", "hbe_vreq_ct_len", "hbe_vreq_share_len",
                 "hbe_comb_share_len"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name in ("hbe_vreq_doc", "hbe_vreq_ct", "hbe_vreq_share",
                 "hbe_comb_share"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, u8p]
    return lib


_LIBS: Dict[int, Optional[ctypes.CDLL]] = {}
# Why a width's engine could not be built or loaded (for the error of
# the entry points that need it).
_LOAD_ERRORS: Dict[int, BaseException] = {}


def get_lib(words: int = 4) -> Optional[ctypes.CDLL]:
    """The engine of NodeSet width ``words``, or None when it cannot be
    built (the host fast paths of keys, SyncKeyGen and serde then take
    their pure-Python paths; the engine-backed nets raise).  A sanitized
    build (:func:`use_engine_build`) that fails raises instead."""
    if words not in _LIBS:
        try:
            _LIBS[words] = _load(words)
        except (RuntimeError, OSError) as exc:
            if _ENGINE_BUILD is not None:
                raise
            _LIBS[words] = None
            _LOAD_ERRORS[words] = exc
        else:
            serde.use_native_scan(_LIBS[words])
    return _LIBS[words]


def _require_lib(words: int) -> ctypes.CDLL:
    lib = get_lib(words)
    if lib is None:
        err = _LOAD_ERRORS.get(words)
        raise RuntimeError(f"native engine unavailable: {err}") from err
    return lib


def available() -> bool:
    return get_lib() is not None


def simd_mode(lib: Optional[ctypes.CDLL] = None) -> str:
    """Resolved field-plane dispatch arm of the (default) engine build:
    ``"ifma"`` or ``"scalar"``.  Benchmarks stamp this into their JSON
    lines so A/B rows are self-describing (CLAUDE.md clock-drift
    rules)."""
    lib = lib if lib is not None else get_lib()
    if lib is None:
        return "unavailable"
    return "ifma" if lib.hbe_simd_mode() else "scalar"


def sha3_plane_stats(lib: Optional[ctypes.CDLL] = None) -> Dict[str, int]:
    """Batched sha3-plane counters since process start (library-global):
    batch calls/messages, messages hashed by the 8-lane IFMA
    arm, and single-message (``sha3_256_one``) calls.  Module-level so
    benchmarks without a net handle (config6 clusters) can stamp them;
    per-run only when one engine build hashed in this process."""
    lib = lib if lib is not None else get_lib()
    if lib is None:
        return {}
    buf = (ctypes.c_uint64 * 4)()
    lib.hbe_sha3_stats(buf)
    return {
        "batch_calls": int(buf[0]),
        "batch_msgs": int(buf[1]),
        "ifma_msgs": int(buf[2]),
        "single_msgs": int(buf[3]),
    }


_SCHED_KINDS = {"always": 0, "never": 1, "every_nth": 2, "tick_tock": 3}
_DECODE_FAILED = object()
_DECODE_CACHE_MAX = 65536


def _cache_put(cache: Dict[Any, Any], key: Any, value: Any,
               cap: int = _DECODE_CACHE_MAX) -> None:
    """Insert with FIFO eviction (insertion-ordered dict): every engine
    cache holds pure-function results, so evicting a live entry is
    always correct — a later lookup recomputes it."""
    cache[key] = value
    if len(cache) > cap:
        cache.pop(next(iter(cache)))


def _share_decoders(suite: Suite):
    """(g1, g2) wire decoders for share bytes arriving via the engine.

    Structural decode only where the suite supports it (BLS): the
    membership policy is the backend's job (request_well_formed /
    on-device checks) — matching the in-process Python net, where shares
    arrive as objects and are policed exclusively at flush.  Suites
    without a structural decoder fall back to the strict codec entry
    points (cheap for ScalarSuite).
    """
    if getattr(suite, "name", "") == "bls12-381":
        from hbbft_tpu_torch.crypto.bls import suite as _bls

        def dec_g1(data: bytes) -> Any:
            return _bls.G1Elem(_bls._jac_from_bytes(data, fq2=False))

        def dec_g2(data: bytes) -> Any:
            return _bls.G2Elem(_bls._jac_from_bytes(data, fq2=True))

        return dec_g1, dec_g2
    return suite.g1_from_bytes, suite.g2_from_bytes


def _be32(x: int) -> bytes:
    return int(x).to_bytes(32, "big")


class _NullSink(VerifySink):
    """DHB itself never submits verifications (vote signatures verify
    inline); the engine handles everything below HB internally."""

    def submit(self, req: Any, cb: Any) -> None:  # pragma: no cover
        raise AssertionError("native DHB layer should not submit verifies")


class EngineHb:
    """Facade standing in for DynamicHoneyBadger's inner HoneyBadger.

    Mirrors honey_badger.HoneyBadger._propose_now's data preparation
    byte-for-byte (serde.dumps + threshold-encrypt with the node rng),
    then hands the payload to the engine.
    """

    def __init__(self, net: "NativeQhbNet", node_id: int, era: int,
                 netinfo: NetworkInfo, schedule: EncryptionSchedule) -> None:
        self._net = net
        self._node_id = node_id
        self._era = era
        self._netinfo = netinfo
        self._schedule = schedule

    @property
    def epoch(self) -> int:
        return self._net.lib.hbe_epoch(self._net.handle, self._node_id)

    @property
    def has_input(self) -> bool:
        return bool(self._net.lib.hbe_has_proposed(self._net.handle, self._node_id))

    def handle_input(self, input: Any, rng: Any) -> Step:
        if not self._netinfo.is_validator():
            return Step.empty()
        if self.has_input:
            raise AssertionError(
                "engine HB cannot hold proposals; guard with has_input"
            )
        data = serde.dumps(input)
        if self._schedule.encrypt_on(self.epoch):
            pk = self._netinfo.public_key_set.public_key()
            data = serde.dumps(pk.encrypt(data, rng))
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        accepted = self._net.lib.hbe_propose(
            self._net.handle, self._node_id, self._era, buf, len(data)
        )
        assert accepted, "propose rejected (era/epoch mismatch)"
        return Step.empty()

    def handle_message(self, sender: Any, message: Any, rng: Any) -> Step:
        raise AssertionError("messages are engine-internal")


class NativeDhb(DynamicHoneyBadger):
    """DynamicHoneyBadger whose inner HoneyBadger runs in the engine.

    All vote / DKG / era logic is the REUSED parent implementation;
    only _make_hb (engine node init / era restart) and _replay_next_era
    (engine-buffered messages) differ.
    """

    def __init__(self, net: "NativeQhbNet", node_id: int,
                 netinfo: NetworkInfo, **kwargs: Any) -> None:
        self._net = net
        self._node_id = node_id
        self._engine_inited = False
        super().__init__(netinfo, _NullSink(), **kwargs)

    def _make_hb(self) -> EngineHb:
        net, nid = self._net, self._node_id
        netinfo = self._netinfo
        session = canonical_bytes(self._session_id, self._era)
        val_ids = list(netinfo.all_ids)
        arr = (ctypes.c_int32 * len(val_ids))(*val_ids)
        sk = netinfo.secret_key_share
        if net.ext:
            # External crypto: the engine never touches key material —
            # it only needs the has-share flag; sign/verify/combine go
            # through the Python callbacks, which look keys up here.
            net._node_era_info[(nid, self._era)] = netinfo
            net._era_netinfo.setdefault(self._era, netinfo)
            sk_buf = (
                (ctypes.c_uint8 * 32)() if sk is not None else None
            )
            pk_buf = (ctypes.c_uint8 * (32 * net.n))()
        else:
            sk_buf = (
                (ctypes.c_uint8 * 32).from_buffer_copy(_be32(sk.x))
                if sk is not None
                else None
            )
            pk_flat = bytearray(32 * net.n)
            for vid in val_ids:
                pk_flat[32 * vid : 32 * (vid + 1)] = _be32(
                    netinfo.public_key_share(vid).g1.value
                )
            pk_buf = (ctypes.c_uint8 * len(pk_flat)).from_buffer_copy(bytes(pk_flat))
        sess_buf = (ctypes.c_uint8 * len(session)).from_buffer_copy(session)
        fn = net.lib.hbe_init_node if not self._engine_inited else net.lib.hbe_restart_node
        fn(
            net.handle, nid, self._era, sess_buf, len(session),
            arr, len(val_ids), netinfo.num_faulty,
            sk_buf, pk_buf, self.max_future_epochs,
            _SCHED_KINDS[self.encryption_schedule.kind], self.encryption_schedule.n,
            1 if self.subset_handling == "all_at_end" else 0,
        )
        self._engine_inited = True
        return EngineHb(net, nid, self._era, netinfo, self.encryption_schedule)

    def _replay_next_era(self) -> Step:
        self._net.lib.hbe_replay_era(self._net.handle, self._node_id)
        return Step.empty()

    def handle_message(self, sender: Any, message: Any, rng: Any) -> Step:
        raise AssertionError("messages are engine-internal")


class _NativeNode:
    __slots__ = ("id", "qhb", "rng", "outputs", "contrib_cache")

    def __init__(self, nid: int, qhb: QueueingHoneyBadger, rng: random.Random):
        self.id = nid
        self.qhb = qhb
        self.rng = rng
        self.outputs: List[DhbBatch] = []
        self.contrib_cache: Dict[tuple, Any] = {}


class _EngineNetBase:
    """Shared engine-callback core: everything a Python runtime needs to
    host engine batch events, whether it drives a whole simulated
    network (:class:`NativeQhbNet`) or one cluster node over real
    sockets (:class:`NativeNodeEngine`).

    Subclass contract — attributes the callbacks read: ``lib``,
    ``handle``, ``nodes`` (engine id -> :class:`_NativeNode`),
    ``_suite``, ``_decode_cache`` / ``_slot_cache`` (shared
    committed-payload decode caches), ``_cb_error``.  The decode-cache
    purity rules documented on :class:`NativeQhbNet` apply to every
    subclass.
    """

    lib: Any
    handle: Any
    nodes: Dict[int, "_NativeNode"]

    # -- engine callbacks ----------------------------------------------
    def _on_contrib(self, node, era, epoch, proposer, data, length) -> int:
        # Committed payloads for a (era, epoch, proposer) slot are
        # byte-identical across every node (Subset agreement — the
        # engine's equivalence tests pin this), so after the first node
        # decodes a slot, later nodes skip both the payload copy and
        # the content-keyed lookup (DKG payloads are hundreds of KB).
        slot = (era, epoch, proposer, length)
        hit = self._slot_cache.get(slot)
        if hit is not None:
            if hit is _DECODE_FAILED:
                return 0
            self.nodes[node].contrib_cache[(era, epoch, proposer)] = hit
            return 1
        # ctypes.string_at = one memcpy; pointer slicing (data[:length])
        # is per-element and cost ~12 ms on DKG-sized (~100 KB) payloads.
        payload = ctypes.string_at(data, length) if length else b""
        if payload in self._decode_cache:
            obj = self._decode_cache[payload]
            if obj is _DECODE_FAILED:
                _cache_put(self._slot_cache, slot, _DECODE_FAILED)
                return 0
        else:
            try:
                obj = serde.loads(payload, suite=self._suite)
            except serde.DecodeError:
                _cache_put(self._decode_cache, payload, _DECODE_FAILED)
                _cache_put(self._slot_cache, slot, _DECODE_FAILED)
                return 0
            _cache_put(self._decode_cache, payload, obj)
        _cache_put(self._slot_cache, slot, obj)
        self.nodes[node].contrib_cache[(era, epoch, proposer)] = obj
        return 1

    def _on_batch(self, node, era, epoch) -> None:
        nd = self.nodes[node]
        lib = self.lib
        size = lib.hbe_batch_size(self.handle)
        contribs = []
        for i in range(size):
            proposer = lib.hbe_batch_proposer(self.handle, i)
            obj = nd.contrib_cache.pop((era, epoch, proposer), None)
            contribs.append((proposer, obj))
        batch = Batch(epoch, tuple(contribs))
        dhb: NativeDhb = nd.qhb.dhb  # type: ignore[assignment]
        dhb._rng = nd.rng
        # Batch-digest fast path: hand the whole batch's DKG private
        # checks to ONE native call before the per-message processing
        # walks it (the round-5 continuation-tail lever).  Per-item
        # misses fall back inside handle_part/handle_ack; a nested
        # batch event (a proposal fired from inside _process_batch)
        # clears the outer digests early, which only costs speed.
        skg = self._predigest_dkg(dhb, batch)
        try:
            step = dhb._process_batch(batch)
        finally:
            if skg is not None:
                skg.clear_predigest()
        step = nd.qhb._absorb(step, nd.rng)
        nd.outputs.extend(o for o in step.output if isinstance(o, DhbBatch))

    @staticmethod
    def _predigest_dkg(dhb: "NativeDhb", batch: Batch) -> Any:
        """Collect the batch's in-era key-gen messages and batch their
        private checks into the node's SyncKeyGen (no-op without a DKG
        in flight).  Returns the SyncKeyGen whose digests must be
        cleared after the batch, or None."""
        state = dhb._key_gen
        if state is None or state.key_gen is None:
            return None
        skg = state.key_gen
        msgs = []
        for _, contrib in batch.contributions:
            if not isinstance(contrib, InternalContrib):
                continue
            for kg in contrib.key_gen_messages:
                if isinstance(kg, SignedKeyGenMsg) and kg.era == dhb._era:
                    msgs.append((kg.sender, kg.payload))
        if msgs:
            try:
                skg.predigest_batch(msgs)
            except Exception:
                # Digesting is an optimization only: any failure leaves
                # the per-item paths to re-derive every verdict.
                skg.clear_predigest()
        return skg

    # Engine MsgType names for the typed delivery profiling slots 0..10
    # (csrc/native/engine.cpp enum MsgType order).
    MSG_TYPE_NAMES = (
        "VALUE", "ECHO", "READY", "ECHO_HASH", "CAN_DECODE",
        "BVAL", "AUX", "CONF", "COIN", "TERM", "DECRYPT",
    )

    def prof_stats(self) -> Dict[str, Dict[str, int]]:
        """Delivery profiling counters: per-message-type cycles/counts
        (slots 0..10) plus the claimed literal slots by registry name
        (tools/lint/slot_registry.py).  Under the deferred RLC cadence
        the engine folds flush-side continuation cycles back into the
        COIN/DECRYPT typed slots, so ``cycles/count`` stays an honest
        cyc/delivery across the HBBFT_TORCH_COIN_RLC A/B."""
        lib, h = self.lib, self.handle
        out: Dict[str, Dict[str, int]] = {}
        for i, name in enumerate(self.MSG_TYPE_NAMES):
            out[name] = {
                "cycles": int(lib.hbe_prof_cycles(h, i)),
                "count": int(lib.hbe_prof_count(h, i)),
            }
        for slot, name in (
            (11, "rlc_groups"),
            (12, "batch_cb"),
            (13, "epoch_advance"),
            (14, "combine_kernel"),  # round 15: the SIMD combine wall
            # Round 17: slot 15 retired its round-6 contrib_cb stamp for
            # the epoch-arena stats (cycles = max per-node high-water
            # mark in BYTES, count = watermark resets).
            (15, "arena"),
        ):
            out[name] = {
                "cycles": int(lib.hbe_prof_cycles(h, slot)),
                "count": int(lib.hbe_prof_count(h, slot)),
            }
        return out

    def arena_stats(self) -> Dict[str, int]:
        """Epoch-arena telemetry: max/sum of the per-node
        high-water marks (bytes carved per epoch), total watermark
        resets, and the recycle knob (``HBBFT_TORCH_ARENA``; 0 = the
        free-every-epoch A/B arm)."""
        buf = (ctypes.c_uint64 * 4)()
        self.lib.hbe_arena_stats(self.handle, buf)
        return {
            "hwm_max": int(buf[0]),
            "hwm_sum": int(buf[1]),
            "resets": int(buf[2]),
            "recycle": int(buf[3]),
        }

    def sha3_stats(self) -> Dict[str, int]:
        """Batched sha3-plane counters since process start (library-
        global): batch calls/messages, messages hashed by the
        8-lane IFMA arm, and single-message (``sha3_256_one``) calls."""
        return sha3_plane_stats(self.lib)

    # Engine TraceKind values (csrc/native/engine.cpp enum TraceKind) -> the
    # shared milestone taxonomy (docs/OBSERVABILITY.md).  d packs
    # (round << 1) | value for input/coin/decide records.  Parity with
    # the enum is machine-checked (tools/lint HBC005).
    TRACE_KIND_NAMES = {
        1: "epoch.open",
        2: "epoch.commit",
        3: "rbc.value",
        4: "rbc.ready",
        5: "rbc.deliver",
        6: "ba.round",
        7: "ba.coin",
        8: "ba.decide",
        9: "decrypt.start",
        10: "decrypt.done",
        11: "ba.input",
    }

    def enable_trace(self, capacity: int = 8192) -> None:
        """Enable the engine's bounded milestone event ring (0 turns it
        off).  Emitting is allocation-free; drain with
        :meth:`drain_trace` (owner thread only, like every engine
        call)."""
        self.lib.hbe_trace_enable(self.handle, capacity)

    @property
    def trace_dropped(self) -> int:
        return int(self.lib.hbe_trace_dropped(self.handle))

    def drain_trace(self) -> List[Any]:
        """Drain engine trace records into :class:`~hbbft_tpu_torch.obs.trace.
        TraceEvent`s (ns stamps -> float wall seconds; kind/abcd -> the
        taxonomy's named args)."""
        import struct

        from hbbft_tpu_torch.obs.trace import TraceEvent

        lib = self.lib
        pending = int(lib.hbe_trace_pending(self.handle))
        if not pending:
            return []
        buf = (ctypes.c_uint8 * (32 * pending))()
        nrec = int(lib.hbe_trace_drain(self.handle, buf, len(buf)))
        out: List[Any] = []
        raw = bytes(buf)
        for i in range(max(nrec, 0)):
            ts_ns, node, kind, a, b, c, d = struct.unpack_from(
                "<q6i", raw, 32 * i
            )
            name = self.TRACE_KIND_NAMES.get(kind)
            if name is None:  # future-proof: unknown kinds still surface
                name, args = f"engine.k{kind}", {"a": a, "b": b, "c": c, "d": d}
            else:
                args = {"node": node, "era": a, "epoch": b}
                if name.startswith(("rbc.", "decrypt.")):
                    args["proposer"] = c
                elif name == "ba.round":
                    args["proposer"] = c
                    args["round"] = d
                elif name in ("ba.coin", "ba.decide", "ba.input"):
                    args["proposer"] = c
                    args["round"] = d >> 1
                    args["value"] = d & 1
                elif name == "epoch.commit":
                    args["contribs"] = c
            out.append(TraceEvent(ts_ns / 1e9, name, args))
        return out

    # -- external-crypto mode ------------------------------------------
    #
    # The opaque-bytes crypto plane (round 3), shared by BOTH engine
    # runtimes: the simulated net (NativeQhbNet external_crypto=True)
    # and the cluster-node engine (NativeNodeEngine with an attached
    # backend — the crypto-service arm, round 13).  The callbacks run
    # inside hbe_run / hbe_flush; exceptions must not cross the ctypes
    # boundary: they are trapped, recorded, and re-raised by the
    # caller's _raise_cb_error — with verdicts left False / results
    # left empty, which the protocol tolerates structurally.

    def _init_ext_crypto(
        self, suite: Suite, backend: CryptoBackend, flush_every: int
    ) -> None:
        """Arm the engine's external (opaque-bytes) crypto mode: share
        signing, verification, combining and ciphertext parsing route
        through the Python callbacks below, and verify requests
        accumulate in the engine's per-node pools until a flush hands
        the whole batch to ``backend.verify_batch`` (``flush_every``
        mirrors VirtualNet's knob; 0 = flush only on queue-dry)."""
        self.ext = True
        self._suite = suite
        self.backend = backend
        self._node_era_info: Dict[Tuple[int, int], NetworkInfo] = {}
        self._era_netinfo: Dict[int, NetworkInfo] = {}
        self._ct_cache: Dict[bytes, Any] = {}
        self._h2g2_cache: Dict[bytes, Any] = {}
        self._elem_cache: Dict[Tuple[bool, bytes], Any] = {}
        self._verdict_memo: Dict[tuple, bool] = {}
        self._dec_g1, self._dec_g2 = _share_decoders(suite)
        self.flush_stats: Dict[str, int] = {
            "flushes": 0,          # verify-batch callback invocations
            "requests": 0,         # raw requests (incl. memo hits)
            "backend_requests": 0, # requests actually sent to the backend
            "max_batch": 0,        # largest single backend batch
        }
        # keep callback objects alive for the engine's lifetime
        self._verify_cb = _VERIFY_CB(self._on_verify)
        self._sign_cb = _SIGN_CB(self._on_sign)
        self._combine_cb = _COMBINE_CB(self._on_combine)
        self._ct_parse_cb = _CT_PARSE_CB(self._on_ct_parse)
        self.lib.hbe_set_ext_crypto(
            self.handle, flush_every, self._verify_cb, self._sign_cb,
            self._combine_cb, self._ct_parse_cb,
        )

    def _read_vreq_bytes(self, len_fn: Any, get_fn: Any, i: int) -> bytes:
        ln = int(len_fn(self.handle, i))
        if not ln:
            return b""
        buf = (ctypes.c_uint8 * ln)()
        get_fn(self.handle, i, buf)
        return bytes(buf)

    def _on_verify(self, node: int, count: int, verdicts: Any) -> None:
        try:
            lib = self.lib
            pending = []  # (slot, memo key, VerifyRequest or None)
            for i in range(count):
                kind = lib.hbe_vreq_kind(self.handle, i)
                era = lib.hbe_vreq_era(self.handle, i)
                sender = lib.hbe_vreq_sender(self.handle, i)
                share = self._read_vreq_bytes(
                    lib.hbe_vreq_share_len, lib.hbe_vreq_share, i
                )
                if kind == 0:
                    ctx = self._read_vreq_bytes(
                        lib.hbe_vreq_doc_len, lib.hbe_vreq_doc, i
                    )
                else:
                    ctx = self._read_vreq_bytes(
                        lib.hbe_vreq_ct_len, lib.hbe_vreq_ct, i
                    )
                # Verdicts are pure functions of the request content, so
                # identical requests observed by different nodes verify
                # once (the backend still sees the whole UNIQUE batch).
                key = (kind, era, sender, ctx, share)
                memo = self._verdict_memo.get(key)
                if memo is not None:
                    verdicts[i] = 1 if memo else 0
                    continue
                pending.append(
                    (i, key, self._build_request(kind, era, sender, ctx, share))
                )
            reqs = [r for (_, _, r) in pending if r is not None]
            results = self.backend.verify_batch(reqs) if reqs else []
            st = self.flush_stats
            st["flushes"] += 1
            st["requests"] += count
            st["backend_requests"] += len(reqs)
            if len(reqs) > st["max_batch"]:
                st["max_batch"] = len(reqs)
            it = iter(results)
            for i, key, req in pending:
                ok = bool(next(it)) if req is not None else False
                _cache_put(self._verdict_memo, key, ok)
                verdicts[i] = 1 if ok else 0
        except BaseException as exc:
            # A failed flush stops the engine here (module docstring):
            # none of these verdicts is acted on, and the caller of the
            # engine call in flight gets ``exc`` itself.
            self.lib.hbe_abort(self.handle)
            self._stopped_by = exc
            if self._cb_error is None:
                self._cb_error = exc

    def _build_request(
        self, kind: int, era: int, sender: int, ctx: bytes, share: bytes
    ) -> Optional[VerifyRequest]:
        """Reconstruct a VerifyRequest from engine wire bytes.

        Share points are decoded STRUCTURALLY only (no subgroup check):
        the backend applies the wire membership policy itself
        (request_well_formed / on-device torsion checks), exactly as for
        in-process Python-net requests.  Undecodable bytes verify False.
        """
        ni = self._era_netinfo.get(era)
        if ni is None:
            return None
        try:
            if kind == 0:
                return VerifyRequest.sig_share(
                    ni.public_key_share(sender),
                    ctx,
                    SignatureShare(self._elem(share, g2=True), self._suite),
                )
            ct = self._ct_lookup(ctx)
            if not isinstance(ct, Ciphertext):
                return None
            if kind == 1:
                return VerifyRequest.dec_share(
                    ni.public_key_share(sender),
                    ct,
                    DecryptionShare(self._elem(share, g2=False), self._suite),
                )
            return VerifyRequest.ciphertext(ct)
        except Exception:
            return None

    def _elem(self, data: bytes, g2: bool) -> Any:
        """Decode (and cache) a group element; cached points also keep
        their memoized subgroup/affine state across verify+combine."""
        key = (g2, data)
        el = self._elem_cache.get(key)
        if el is None:
            el = (self._dec_g2 if g2 else self._dec_g1)(data)
            _cache_put(self._elem_cache, key, el)
        return el

    def _ct_lookup(self, payload: bytes) -> Any:
        """Ciphertext for a serde payload — cache, or re-decode after an
        eviction (the payload IS the full encoding, so entries are
        always re-derivable)."""
        obj = self._ct_cache.get(payload)
        if obj is None:
            obj = serde.try_loads(payload, suite=self._suite)
            _cache_put(
                self._ct_cache, payload,
                obj if isinstance(obj, Ciphertext) else _DECODE_FAILED,
            )
        return obj

    def _on_sign(
        self, node: int, era: int, kind: int, ctx_ptr: Any, ctx_len: int, ret: Any
    ) -> None:
        try:
            ctx = ctypes.string_at(ctx_ptr, ctx_len) if ctx_len else b""
            ni = self._node_era_info[(node, era)]
            if kind == 0:
                h = self._h2g2_cache.get(ctx)
                if h is None:
                    h = self._suite.hash_to_g2(ctx)
                    _cache_put(self._h2g2_cache, ctx, h)
                share = ni.secret_key_share.sign_hash_point(h)
            else:
                share = ni.secret_key_share.decryption_share(self._ct_lookup(ctx))
            data = share.to_bytes()
            buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
            self.lib.hbe_ret_bytes(ret, buf, len(data))
        except BaseException as exc:  # pragma: no cover - defensive
            if self._cb_error is None:
                self._cb_error = exc

    def _on_combine(
        self, node: int, era: int, kind: int, ctx_ptr: Any, ctx_len: int,
        count: int, ret: Any,
    ) -> None:
        try:
            ctx = ctypes.string_at(ctx_ptr, ctx_len) if ctx_len else b""
            lib = self.lib
            ni = self._era_netinfo[era]
            pks = ni.public_key_set
            shares: Dict[int, Any] = {}
            for i in range(count):
                idx = lib.hbe_comb_index(self.handle, i)
                data = self._read_vreq_bytes(
                    lib.hbe_comb_share_len, lib.hbe_comb_share, i
                )
                if kind == 0:
                    shares[idx] = SignatureShare(
                        self._elem(data, g2=True), self._suite
                    )
                else:
                    shares[idx] = DecryptionShare(
                        self._elem(data, g2=False), self._suite
                    )
            if kind == 0:
                out = pks.combine_signatures(shares).to_bytes()
            else:
                out = pks.combine_decryption_shares(shares, self._ct_lookup(ctx))
            buf = (ctypes.c_uint8 * len(out)).from_buffer_copy(out)
            self.lib.hbe_ret_bytes(ret, buf, len(out))
        except BaseException as exc:  # pragma: no cover - defensive
            if self._cb_error is None:
                self._cb_error = exc

    def _on_ct_parse(self, node: int, ptr: Any, length: int) -> int:
        """serde decode gate for subset-accepted payloads — the exact
        ``serde.try_loads`` + isinstance verdict of
        honey_badger._start_decrypt, memoized per distinct payload."""
        try:
            payload = ctypes.string_at(ptr, length) if length else b""
            return 1 if isinstance(self._ct_lookup(payload), Ciphertext) else 0
        except BaseException as exc:  # pragma: no cover - defensive
            if self._cb_error is None:
                self._cb_error = exc
            return 0

    #: The error of the verify flush that stopped the engine, if one did.
    _stopped_by: Optional[BaseException] = None

    def _raise_cb_error(self) -> None:
        if self._cb_error is not None:
            exc, self._cb_error = self._cb_error, None
            if exc is self._stopped_by:
                raise exc
            raise RuntimeError("engine crypto callback failed") from exc
        if self._stopped_by is not None:
            raise RuntimeError(
                "the engine stopped at a failed verify flush"
            ) from self._stopped_by

    def faults(self, nid: int) -> List[tuple]:
        out = []
        for i in range(self.lib.hbe_fault_count(self.handle, nid)):
            out.append(
                (
                    self.lib.hbe_fault_subject(self.handle, nid, i),
                    self.lib.hbe_fault_kind(self.handle, nid, i).decode(),
                )
            )
        return out

    def close(self) -> None:
        if self.handle:
            self.lib.hbe_destroy(self.handle)
            self.handle = None

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeQhbNet(_EngineNetBase):
    """Engine-backed QueueingHoneyBadger network (NetBuilder-compatible
    key generation and rng seeding, so runs are comparable to the
    Python VirtualNet at the same seed).

    ``threads=N`` (N > 1) runs the engine's generation-parallel
    multicore scheduler (``engine_run_mt``).  Its byte-identity with
    ``threads=1`` rests on an obligation this class's own callbacks
    honor and any SUBCLASS/EXTENSION must too: **Python batch/contrib
    callbacks may only touch per-node state** (per-node rngs, per-node
    protocol instances) or pure-function caches keyed by all of their
    inputs.  Cross-node mutable state in a callback — e.g. one shared
    rng, or a node-dependent memo on a shared decoded object — would
    make outputs depend on the worker interleaving and silently diverge
    from ``threads=1`` (the C++-side argument lives at engine_run_mt in
    csrc/native/engine.cpp; the Python-side contract is stated here because
    callbacks are where users extend the net).  Scalar internal-crypto
    mode only; external crypto and adversaries are rejected."""

    def __init__(
        self,
        n: int,
        seed: int = 0,
        batch_size: int = 8,
        num_faulty: Optional[int] = None,
        session_id: bytes = b"qhb-test",
        encryption_schedule: EncryptionSchedule = EncryptionSchedule.always(),
        subset_handling: str = "incremental",
        suite: Optional[Suite] = None,
        backend: Optional[CryptoBackend] = None,
        flush_every: int = 1,
        external_crypto: Optional[bool] = None,
        adversary: Any = None,
        threads: int = 1,
        rlc: Optional[bool] = None,
        engine_words: Optional[int] = None,
    ) -> None:
        # engine_words forces a wider NodeSet build than the network
        # needs (e.g. the -DHBE_WORDS=8 era-change smoke test runs a
        # small N on the wide build to pin width-independence).
        words = engine_words if engine_words is not None else _words_for(n)
        if words < _words_for(n):
            raise ValueError(
                f"engine_words={words} cannot serve n={n} "
                f"(needs {_words_for(n)})"
            )
        lib = _require_lib(words)
        self.lib = lib
        self.n = n
        # Multicore generation-parallel delivery (engine_run_mt): scalar
        # mode only — the external-crypto flush cadence (one verify
        # callback per flush_every deliveries) and adversary replay are
        # inherently sequential orderings.  Byte-identity with threads=1
        # is pinned by tests/test_native_engine.py.
        self.threads = int(threads)
        if self.threads > 1:
            if external_crypto or (
                external_crypto is None
                and suite is not None
                and not isinstance(suite, ScalarSuite)
            ):
                raise ValueError(
                    "threads > 1 requires the scalar-suite internal "
                    "crypto mode (external-crypto flush cadence is "
                    "sequential)"
                )
            if adversary is not None:
                raise ValueError("threads > 1 does not support adversaries")
        f = num_faulty if num_faulty is not None else (n - 1) // 3
        assert 3 * f < n
        self.f = f
        suite = suite if suite is not None else ScalarSuite()
        # External (opaque-bytes) crypto is required for any non-scalar
        # suite; for ScalarSuite it is optional (used to pin the external
        # path's equivalence cheaply).
        self.ext = (
            external_crypto
            if external_crypto is not None
            else not isinstance(suite, ScalarSuite)
        )
        if not self.ext and not isinstance(suite, ScalarSuite):
            raise ValueError("native-scalar mode requires ScalarSuite")
        # Scalar RLC deferred verification (round 7): group COIN/DECRYPT
        # share checks at flush instead of per-share mulmods at submit.
        # Default from HBBFT_TORCH_COIN_RLC (on unless "0"); the kwarg
        # overrides.  flush_every now also governs the SCALAR flush
        # cadence when RLC is on (1 = the pre-round-7 per-unit flush
        # points exactly; 0 = flush on queue-dry — maximal grouping,
        # identical protocol outputs by the deferred-verification
        # invariant, pinned by tests/test_native_rlc.py).
        self.rlc = (
            bool(rlc)
            if rlc is not None
            else os.environ.get("HBBFT_TORCH_COIN_RLC", "1") != "0"
        )
        self.flush_every = flush_every
        if not self.ext and flush_every != 1:
            if not self.rlc:
                raise ValueError(
                    "scalar flush_every != 1 requires the RLC deferred "
                    "path (rlc=True / HBBFT_TORCH_COIN_RLC=1); the legacy "
                    "per-share path only flushes per unit"
                )
            if self.threads > 1:
                raise ValueError(
                    "threads > 1 requires flush_every=1 in scalar mode "
                    "(the deferred scalar flush cadence is a sequential "
                    "ordering, like external crypto's)"
                )
        rng = random.Random(seed)
        sks = SecretKeySet.random(f, rng, suite)
        pks = sks.public_keys()
        node_sks = {i: SecretKey.random(rng, suite) for i in range(n)}
        node_pks = {i: node_sks[i].public_key() for i in range(n)}
        val_ids = list(range(n))
        faulty = val_ids[n - f :] if f else []
        self.faulty_ids = list(faulty)
        self.correct_ids = [i for i in range(n) if i not in faulty]
        # VirtualNet.node_order (Target.all expansion + NodeOrderAdversary)
        self.node_order = sorted(self.correct_ids) + sorted(self.faulty_ids)

        self.handle = lib.hbe_create(n, f)
        assert self.handle
        if rlc is not None:
            lib.hbe_set_rlc(self.handle, 1 if self.rlc else 0)
        if not self.ext and flush_every != 1:
            lib.hbe_set_flush_every(self.handle, flush_every)
        # keep callback objects alive for the engine's lifetime
        self._batch_cb = _BATCH_CB(self._on_batch)
        self._contrib_cb = _CONTRIB_CB(self._on_contrib)
        lib.hbe_set_callbacks(self.handle, self._batch_cb, self._contrib_cb)

        self.backend: Optional[CryptoBackend] = None
        self._cb_error: Optional[BaseException] = None
        # The net-level rng continues past key generation exactly like
        # NetBuilder's, so a seeded adversary replayed against the
        # engine queue consumes the SAME stream as the VirtualNet's.
        self._net_rng = rng
        self._adversary = adversary
        self._tampering = False
        if adversary is not None:
            from hbbft_tpu_torch.net.adversary import (
                NodeOrderAdversary,
                NullAdversary,
                RandomAdversary,
                ReorderingAdversary,
                TamperingAdversary,
            )

            # EXACT stock types only: the replay reproduces these
            # implementations' rng consumption precisely; a subclass
            # with an overridden pre_crank would silently diverge.
            if type(adversary) is TamperingAdversary:
                # Byzantine mode: faulty nodes run the real algorithm and
                # the engine offers every outgoing message to _on_tamper,
                # which consumes the SAME net-rng stream as the Python
                # TamperingAdversary._drive at the same seed.
                self._tampering = True
                self._tamper_cb = _TAMPER_CB(self._on_tamper)
                lib.hbe_set_tamper(self.handle, self._tamper_cb)
            elif type(adversary) is not NullAdversary:
                if type(adversary) not in (
                    ReorderingAdversary, RandomAdversary, NodeOrderAdversary
                ):
                    raise ValueError(
                        "engine supports the stock scheduling adversaries "
                        "(Reordering/Random/NodeOrder) and "
                        "TamperingAdversary; subclasses run on the Python "
                        "VirtualNet"
                    )
                if (
                    type(adversary) is RandomAdversary
                    and adversary.replay_p > 0
                ):
                    raise ValueError(
                        "RandomAdversary replay (replay_p > 0) consumes rng "
                        "on faulty-destined deliveries and injects messages; "
                        "run it on the Python VirtualNet"
                    )
                self._pre_crank_cb = _PRE_CRANK_CB(self._on_pre_crank)
                lib.hbe_set_pre_crank(self.handle, self._pre_crank_cb)
        if self.ext:
            self._init_ext_crypto(
                suite,
                backend if backend is not None else default_backend(suite),
                flush_every,
            )

        self.nodes: Dict[int, _NativeNode] = {}
        self._suite = suite
        # Committed payload bytes are identical across all N nodes; decode
        # once per distinct payload instead of once per node.  Consumers
        # may attach ONLY pure-function memos keyed by all of their
        # inputs to the shared objects (e.g. SignedVote/_KeyGenMsg
        # `_sp_bytes`/`_sig_ok`, Ciphertext `_verify_ok`); node-local or
        # impure state on a shared decoded object would silently couple
        # nodes and is forbidden.
        self._decode_cache: Dict[bytes, Any] = {}
        self._slot_cache: Dict[tuple, Any] = {}  # (era, epoch, proposer, len)
        for i in range(n):
            netinfo = NetworkInfo(
                our_id=i,
                val_ids=val_ids,
                public_key_set=pks,
                secret_key_share=sks.secret_key_share(i),
                public_keys={j: node_pks[j] for j in val_ids},
                secret_key=node_sks[i],
            )
            node_rng = random.Random((seed << 16) ^ (i + 1))
            dhb = NativeDhb(
                self, i, netinfo,
                session_id=session_id,
                encryption_schedule=encryption_schedule,
                subset_handling=subset_handling,
            )
            qhb = QueueingHoneyBadger(
                netinfo, _NullSink(), batch_size=batch_size,
                session_id=session_id, dhb=dhb,
            )
            self.nodes[i] = _NativeNode(i, qhb, node_rng)
            if i in faulty:
                if self._tampering:
                    lib.hbe_set_tampered(self.handle, i, 1)
                else:
                    lib.hbe_set_silent(self.handle, i, 1)

    # The external-crypto callbacks (_on_verify / _on_sign / _on_combine
    # / _on_ct_parse and their helpers) live on _EngineNetBase: the
    # cluster-node engine's crypto-service arm (round 13) shares them
    # verbatim — only the ingress/egress runtime differs.

    # Engine MsgType values (csrc/native/engine.cpp enum MsgType).
    _MT_VALUE, _MT_ECHO, _MT_READY, _MT_ECHO_HASH, _MT_CAN_DECODE = range(5)
    _MT_BVAL, _MT_AUX, _MT_CONF, _MT_COIN, _MT_TERM, _MT_DECRYPT = range(5, 11)

    def _on_tamper(
        self, sender: int, mtype: int, era: int, epoch: int,
        proposer: int, rnd: int,
    ) -> None:
        """Mirror of TamperingAdversary._tamper against the engine's
        outgoing-message clone — one net-rng draw per TargetedMessage,
        the same rewrites (flipped bvals/aux/term/conf, doubled shares,
        corrupted roots/proofs), so a tampered native run consumes the
        exact rng stream of the Python net at the same seed."""
        try:
            adv = self._adversary
            rng = self._net_rng
            if rng.random() >= adv.tamper_p:
                return
            lib, h = self.lib, self.handle
            if mtype in (self._MT_BVAL, self._MT_AUX, self._MT_TERM):
                lib.hbe_tamper_set_bval(h, 0 if lib.hbe_tamper_bval(h) else 1)
            elif mtype == self._MT_CONF:
                # BoolSet mask: 1 = {False}, 2 = {True}, 3 = both.
                if lib.hbe_tamper_bval(h) == 3:
                    lib.hbe_tamper_set_bval(h, 2 if rng.getrandbits(1) else 1)
                else:
                    lib.hbe_tamper_set_bval(h, 3)
            elif mtype in (self._MT_COIN, self._MT_DECRYPT):
                # SignatureShare(s.g2 * 2) / DecryptionShare(s.g1 * 2).
                ln = int(lib.hbe_tamper_share_len(h))
                buf = (ctypes.c_uint8 * ln)()
                lib.hbe_tamper_share(h, buf)
                data = bytes(buf)
                if self.ext:
                    el = (
                        self._dec_g2 if mtype == self._MT_COIN else self._dec_g1
                    )(data)
                    out = (el * 2).to_bytes()
                else:
                    s = int.from_bytes(data, "big")
                    out = (2 * s % self._suite.scalar_modulus).to_bytes(
                        32, "big"
                    )
                ob = (ctypes.c_uint8 * len(out)).from_buffer_copy(out)
                lib.hbe_tamper_set_share(h, ob, len(out))
            elif mtype in (
                self._MT_READY, self._MT_ECHO_HASH, self._MT_CAN_DECODE
            ):
                lib.hbe_tamper_flip_root(h)
            elif mtype in (self._MT_VALUE, self._MT_ECHO):
                lib.hbe_tamper_corrupt_proof(h)
            else:  # pragma: no cover - no other engine message types
                return
            adv.tampered_count += 1
        except BaseException as exc:  # pragma: no cover - defensive
            if self._cb_error is None:
                self._cb_error = exc

    def _on_pre_crank(self, qlen: int) -> None:
        """Replay the seeded scheduling adversary against the engine
        queue — the exact per-crank rng consumption of the Python
        Adversary.pre_crank hooks, so schedules match at the same seed."""
        try:
            adv = self._adversary
            rng = self._net_rng
            lib, h = self.lib, self.handle
            from hbbft_tpu_torch.net.adversary import (
                NodeOrderAdversary,
                RandomAdversary,
                ReorderingAdversary,
            )

            if isinstance(adv, ReorderingAdversary):
                for _ in range(min(adv.swaps_per_crank, qlen)):
                    i = rng.randrange(qlen)
                    j = rng.randrange(qlen)
                    lib.hbe_queue_swap(h, i, j)
            elif isinstance(adv, RandomAdversary):
                if qlen > 1:
                    i = rng.randrange(qlen)
                    lib.hbe_queue_swap(h, 0, i)
            elif isinstance(adv, NodeOrderAdversary):
                if qlen:
                    order = {nid: k for k, nid in enumerate(self.node_order)}
                    dests = [lib.hbe_queue_dest(h, i) for i in range(qlen)]
                    perm = sorted(range(qlen), key=lambda i: order[dests[i]])
                    self._apply_queue_perm(perm)
        except BaseException as exc:  # pragma: no cover - defensive
            if self._cb_error is None:
                self._cb_error = exc

    def _apply_queue_perm(self, perm: List[int]) -> None:
        """Reorder the engine queue to `perm` (perm[new] = old) with
        swaps (mirrors a stable in-place sort result)."""
        lib, h = self.lib, self.handle
        pos = list(range(len(perm)))  # old index -> current position
        at = list(range(len(perm)))   # position -> old index
        for new, old in enumerate(perm):
            p = pos[old]
            if p == new:
                continue
            lib.hbe_queue_swap(h, new, p)
            displaced = at[new]
            at[new], at[p] = old, displaced
            pos[old], pos[displaced] = new, p

    # -- driving --------------------------------------------------------
    def send_input(self, nid: int, input: Any) -> None:
        nd = self.nodes[nid]
        if nid in self.faulty_ids and not self._tampering:
            return  # silent (crash-faulty) nodes never act
        step = nd.qhb.handle_input(input, nd.rng)
        nd.outputs.extend(o for o in step.output if isinstance(o, DhbBatch))
        # An input-triggered flush (flush_every=1) runs crypto callbacks;
        # surface their failures here, not at the next run() call.
        self._raise_cb_error()

    def run(self, max_deliveries: int = 1 << 62) -> int:
        if self.threads > 1:
            done = int(
                self.lib.hbe_run_mt(self.handle, max_deliveries, self.threads)
            )
        else:
            done = int(self.lib.hbe_run(self.handle, max_deliveries))
        self._raise_cb_error()
        return done

    def flush(self) -> None:
        """Force a verify flush of all pending pools (external mode)."""
        self.lib.hbe_flush(self.handle)
        self._raise_cb_error()

    @property
    def pending_verifies(self) -> int:
        return int(self.lib.hbe_pending_verifies(self.handle))

    def run_until(self, pred: Callable[["NativeQhbNet"], bool],
                  chunk: int = 50_000, max_total: int = 1 << 40) -> None:
        total = 0
        while not pred(self):
            done = self.run(chunk)
            total += done
            if done == 0 and not pred(self):
                raise RuntimeError("engine idle but condition not met")
            if total > max_total:
                raise RuntimeError("delivery limit exceeded")

    @property
    def delivered(self) -> int:
        return int(self.lib.hbe_delivered(self.handle))


class NativeNodeEngine(_EngineNetBase):
    """ONE cluster node's engine: the message-boundary runtime behind
    ``LocalCluster(node_impl="native")`` (round 9).

    Where :class:`NativeQhbNet` simulates all N nodes behind one
    internal queue, this engine runs in CLUSTER mode
    (``hbe_set_local``): only ``node_id`` is initialized and driven;
    every emission toward another id is serde-encoded in C (byte-
    identical to ``serde.dumps(SqMessage.algo(...))`` — pinned by the
    ``hbe_wire_roundtrip`` tests) and epoch-gated per peer with
    SenderQueue's admit rules, and ingress frames are decoded + handled
    natively in one ctypes call per read burst
    (``hbe_node_ingest_wire``).  The per-BATCH layers are the same
    reused Python stack as everywhere else: ``QueueingHoneyBadger``
    over :class:`NativeDhb`, fed through the shared batch callbacks.

    Scalar suite only (the cluster WIRE grammar pins the scalar-suite
    32-byte share encoding — ``wenc_share_struct`` in native/
    engine.cpp), in one of two crypto configurations:

    * **internal scalar** (default, ``backend=None``) — the engine
      computes the scalar-suite checks itself; ``flush_every`` is
      pinned to 1 (the byte-identical eager cadence) so committed
      batches match the Python-node oracle exactly.
    * **external backend** (round 13, ``backend=...``) — the ext-crypto
      mode under the cluster loop: shares travel as opaque bytes,
      verification accumulates in the engine pool and flushes through
      the attached :class:`~hbbft_tpu_torch.crypto.backend.CryptoBackend`
      (the cluster crypto-service arm routes this to the shared
      :class:`~hbbft_tpu_torch.cryptoplane.CryptoPlaneService`).  The
      deferred cadence is accepted here (``flush_every=0`` = flush on
      queue-dry, i.e. once per ingest sweep) — identical protocol
      outputs by the standing deferred-verification invariant
      (tests/test_cryptoplane.py pins ``batches_sha`` against the
      scalar arm).

    ``threads > 1`` composes only with the internal scalar mode at
    ``flush_every=1`` — the same sequential-cadence rules as
    :class:`NativeQhbNet` (and cluster mode runs sequentially in the
    engine regardless; the option exists for rule consistency).

    Threading: NOT thread-safe.  One owner thread makes every call
    (ingest_wire / handle_input / run / drain_egress); the transport thread
    only ever touches the inbox queue in front of it
    (transport/native_node.py).
    """

    #: SenderQueue max_future_epochs mirror (the egress send gate).
    SQ_WINDOW = 3

    #: hbe_node_stat slot names (engine ClStat order).
    STAT_NAMES = (
        "handled", "bad_payload", "ignored", "dropped_stale",
        "held", "released", "sent", "announces",
    )

    def __init__(
        self,
        node_id: int,
        netinfo: NetworkInfo,
        seed: int = 0,
        batch_size: int = 8,
        session_id: bytes = b"tcp-cluster",
        encryption_schedule: EncryptionSchedule = EncryptionSchedule.always(),
        subset_handling: str = "incremental",
        suite: Optional[Suite] = None,
        rlc: Optional[bool] = None,
        trace_capacity: int = 8192,
        backend: Optional[CryptoBackend] = None,
        flush_every: int = 1,
        threads: int = 1,
    ) -> None:
        n = len(netinfo.all_ids)
        lib = _require_lib(_words_for(n))
        suite = suite if suite is not None else ScalarSuite()
        if not isinstance(suite, ScalarSuite):
            raise ValueError(
                "NativeNodeEngine requires ScalarSuite (the cluster wire "
                "grammar pins the scalar-suite share encoding; attach a "
                "backend= for the external-crypto service arm)"
            )
        ext = backend is not None
        self.threads = int(threads)
        # The same cadence rules as NativeQhbNet: the external flush
        # cadence and the deferred scalar cadence are sequential
        # orderings, so they reject threads > 1; and WITHOUT an ext
        # backend the node pins flush_every=1 — the byte-identical eager
        # cadence the Python-node oracle equivalence rests on.
        if self.threads > 1:
            if ext:
                raise ValueError(
                    "threads > 1 requires the scalar-suite internal "
                    "crypto mode (external-crypto flush cadence is "
                    "sequential)"
                )
            if flush_every != 1:
                raise ValueError(
                    "threads > 1 requires flush_every=1 in scalar mode "
                    "(the deferred scalar flush cadence is a sequential "
                    "ordering, like external crypto's)"
                )
        if not ext and flush_every != 1:
            raise ValueError(
                "NativeNodeEngine pins flush_every=1 in scalar mode (the "
                "Python-oracle byte-identity cadence); attach an external "
                "CryptoBackend (backend=...) for the deferred cadence"
            )
        self.lib = lib
        self.n = n
        self.f = netinfo.num_faulty
        self.ext = False
        self.node_id = node_id
        self._suite = suite
        self.flush_every = flush_every
        self._cb_error: Optional[BaseException] = None
        self._decode_cache: Dict[bytes, Any] = {}
        self._slot_cache: Dict[tuple, Any] = {}
        self.handle = lib.hbe_create(n, self.f)
        assert self.handle
        if rlc is not None:
            lib.hbe_set_rlc(self.handle, 1 if rlc else 0)
        lib.hbe_set_local(self.handle, node_id, self.SQ_WINDOW)
        if ext:
            # Must precede NativeDhb construction below: _make_hb
            # branches on self.ext (era-info registration, keyless
            # engine init) during DynamicHoneyBadger.__init__.
            self._init_ext_crypto(suite, backend, flush_every)
        # Flight recorder (round 12): default-on for cluster nodes —
        # milestone-rate emits into a preallocated ring, drained by the
        # runtime once per sweep (trace_capacity=0 disables).
        if trace_capacity:
            self.enable_trace(trace_capacity)
        # keep callback objects alive for the engine's lifetime
        self._batch_cb = _BATCH_CB(self._on_batch)
        self._contrib_cb = _CONTRIB_CB(self._on_contrib)
        lib.hbe_set_callbacks(self.handle, self._batch_cb, self._contrib_cb)
        # Same rng ritual as ClusterNode / NativeQhbNet, so a native
        # cluster at seed s proposes the exact contribution stream of
        # the Python-node cluster at seed s (the cross-arm byte-identity
        # contract, tests/test_transport_native.py).
        rng = random.Random((seed << 16) ^ (node_id + 1))
        dhb = NativeDhb(
            self, node_id, netinfo,
            session_id=session_id,
            encryption_schedule=encryption_schedule,
            subset_handling=subset_handling,
        )
        qhb = QueueingHoneyBadger(
            netinfo, _NullSink(), batch_size=batch_size,
            session_id=session_id, dhb=dhb,
        )
        self.nodes = {node_id: _NativeNode(node_id, qhb, rng)}

    # -- driving (owner thread only) -----------------------------------
    def handle_input(self, input: Any) -> None:
        """Submit one local input (txn or vote) to the QHB stack; any
        resulting proposal lands in the egress buffer."""
        nd = self.nodes[self.node_id]
        step = nd.qhb.handle_input(input, nd.rng)
        nd.outputs.extend(o for o in step.output if isinstance(o, DhbBatch))
        self._raise_cb_error()

    def ingest_wire(self, senders: List[int], records: List[Tuple[int, bytes]]) -> int:
        """Decode + enqueue one transport read burst in WIRE form: record
        i is ``(nmsg, data)`` — ``nmsg == 0`` a plain MSG payload,
        ``nmsg >= 1`` a validated raw MSGB body carrying that many
        messages, walked entirely in C (no Python slicing).  Returns the
        consumable-MESSAGE count.  Follow with :meth:`run`."""
        k = len(records)
        if k == 0:
            return 0
        offs = (ctypes.c_uint64 * (k + 1))()
        nmsgs = (ctypes.c_uint32 * k)()
        pos = 0
        for i, (nm, data) in enumerate(records):
            offs[i] = pos
            nmsgs[i] = nm
            pos += len(data)
        offs[k] = pos
        handled = int(
            self.lib.hbe_node_ingest_wire(
                self.handle,
                (ctypes.c_int32 * k)(*senders),
                nmsgs, offs, k, b"".join(d for _, d in records),
            )
        )
        self._raise_cb_error()
        return handled

    def run(self, max_deliveries: int = 1 << 62) -> int:
        """Drain the local delivery queue (returns when it is empty;
        in ext mode the queue-dry flush hands pending verifications to
        the backend before returning)."""
        if self.threads > 1:
            done = int(
                self.lib.hbe_run_mt(self.handle, max_deliveries, self.threads)
            )
        else:
            done = int(self.lib.hbe_run(self.handle, max_deliveries))
        self._raise_cb_error()
        return done

    def drain_egress(self, send: Callable[[int, bytes], None]) -> int:
        """Hand every pending egress frame to ``send(dest, payload)``;
        returns the frame count.  One C call moves the whole batch."""
        lib = self.lib
        size = int(lib.hbe_node_egress_bytes(self.handle))
        if not size:
            return 0
        buf = (ctypes.c_uint8 * size)()
        nrec = int(lib.hbe_node_egress_drain(self.handle, buf, size))
        if nrec <= 0:
            return 0
        data = memoryview(buf)  # zero-copy view; payload slices copy once
        pos = 0
        for _ in range(nrec):
            dest = int.from_bytes(data[pos:pos + 4], "little")
            ln = int.from_bytes(data[pos + 4:pos + 8], "little")
            send(dest, bytes(data[pos + 8:pos + 8 + ln]))
            pos += 8 + ln
        return nrec

    def drain_egress_msgb(
        self, emit: Callable[[int, int, bytes], None], max_body: int,
    ) -> int:
        """Drain every pending egress payload as per-destination MSGB
        bodies built in C (round 20 coalescing): one
        ``emit(dest, nmsg, body)`` per group, where ``body`` is the
        framing MSGB grammar and groups split at ``max_body`` payload
        bytes.  Returns the group count.  Callers strip ``nmsg == 1``
        groups to plain MSG frames (``body[8:]``) so singletons stay
        byte-identical to the uncoalesced arm."""
        lib = self.lib
        size = int(lib.hbe_node_egress_bytes(self.handle))
        if not size:
            return 0
        # Worst case per entry is 20B overhead + payload vs the 8B the
        # sizing entry reports, so 3x + slack provably covers it.
        cap = 3 * size + 64
        buf = (ctypes.c_uint8 * cap)()
        nbytes = int(
            lib.hbe_node_egress_drain_msgb(self.handle, max_body, buf, cap)
        )
        if nbytes <= 0:
            return 0
        data = memoryview(buf)  # zero-copy view; body slices copy once
        pos = 0
        groups = 0
        while pos < nbytes:
            dest = int.from_bytes(data[pos:pos + 4], "little")
            nmsg = int.from_bytes(data[pos + 4:pos + 8], "little")
            ln = int.from_bytes(data[pos + 8:pos + 12], "little")
            emit(dest, nmsg, bytes(data[pos + 12:pos + 12 + ln]))
            pos += 12 + ln
            groups += 1
        return groups

    def stats(self) -> Dict[str, int]:
        return {
            name: int(self.lib.hbe_node_stat(self.handle, i))
            for i, name in enumerate(self.STAT_NAMES)
        }

    @property
    def outputs(self) -> List[DhbBatch]:
        return self.nodes[self.node_id].outputs
