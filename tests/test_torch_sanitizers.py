"""The sanitizer tier over the port's own native code: the engine of
``hbbft_tpu_torch/csrc/native/`` under ASan, UBSan and TSan.

``build.build_host("engine", 4, sanitizer=...)`` builds an instrumented
engine (the reference's ``native/Makefile`` flags) and
``native_engine.use_engine_build`` makes the nets load it.  Python itself
is not instrumented, so the sanitizer's runtime is ``LD_PRELOAD``ed into a
fresh interpreter that runs :data:`DRIVER`: every section of the
reference's sanitized driver (``tests/test_sanitizers.py``) over the
port's modules, and one of the port's own, ``SANITIZED-ABORT-OK``: a
backend whose third flush raises stops the engine through ``hbe_abort``
(the copy's ``[port]`` lines), the error reaches the caller, no fault is
recorded, later calls raise and ``close()`` frees the engine.  The
driver's first committed batches equal the reference's ``NativeQhbNet``
at the same arguments, serialized by each package's own ``serde``.

ASan and UBSan run in tier-1; TSan drives ``threads=2`` and is ``slow``.
The builds and the driver run at nice 10, so the timing-sensitive process
tests beside them keep their cores.

The hand CUDA kernels' tier, ``compute-sanitizer`` over every kernel
(``tools.kernel_sanitizer``), needs a card: its test is marked ``cuda``.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

MARKERS = ["EPOCH", "ERA", "RLC-BISECT", "WIRE", "MSGB", "CHAOS", "SIMD", "ARENA-SHA3", "ABORT"]

DRIVER = """
import sys
from hbbft_tpu_torch import native_engine
from hbbft_tpu_torch.utils import serde

native_engine.use_engine_build(sys.argv[1])
assert native_engine.available(), "sanitized engine failed to load"
threads = int(sys.argv[2]) if len(sys.argv) > 2 else 0
kw = {"threads": threads} if threads else {}
chunk = 1 if threads == 0 else 256
nat = native_engine.NativeQhbNet(
    4, seed=1, batch_size=3, session_id=b"sanitizer", **kw
)
assert f"_w4_{sys.argv[1]}-" in nat.lib._name, nat.lib._name
for i in range(4):
    nat.send_input(i, ("tx", i))
# chunk must batch MANY deliveries per engine call in threaded mode:
# engine_run_mt takes one generation per call of at most `chunk` queue
# items, and a generation with a single destination runs inline on the
# calling thread, so chunk=1 would make the TSan run single-threaded.
nat.run_until(
    lambda e: all(len(e.nodes[i].outputs) >= 1 for i in e.correct_ids),
    chunk=chunk,
)
keys = [
    [(b.era, b.epoch, b.contributions) for b in nat.nodes[i].outputs[:1]]
    for i in nat.correct_ids
]
assert all(k == keys[0] for k in keys), "correct nodes diverged"
print("SANITIZED-BATCHES", serde.dumps(keys).hex())
print("SANITIZED-EPOCH-OK")

# A full era change: the batch-digest entry points (DKG ack/part batch
# checks, scalar interpolation and combine, the shared ct-hash cache).
from hbbft_tpu_torch.protocols.dynamic_honey_badger import Change
from hbbft_tpu_torch.protocols.queueing_honey_badger import Input

keep = dict(nat.nodes[0].qhb.dhb.netinfo.public_key_map)
keep.pop(3)
for i in nat.correct_ids:
    nat.send_input(i, Input.change(Change.node_change(keep)))

def era_done(e):
    return all(
        any(b.change.kind == "complete" for b in e.nodes[i].outputs)
        for i in e.correct_ids
    )

rounds = 1
while not era_done(nat) and rounds < 12:
    for i in nat.correct_ids:
        nat.send_input(i, Input.user(("era-tx", rounds, i)))
    rounds += 1
    nat.run_until(
        lambda e, w=rounds: all(
            len(e.nodes[i].outputs) >= w for i in e.correct_ids
        ),
        chunk=chunk,
    )
assert era_done(nat), "sanitized era change did not complete"
print("SANITIZED-ERA-OK")

# A deferred-RLC epoch with corrupt COIN/DECRYPT shares from node 0:
# every group holding one of its shares fails the RLC check and runs the
# bisection down to single items, ending in real fault entries.
import ctypes
from hbbft_tpu_torch.native_engine import _TAMPER_CB

nat2 = native_engine.NativeQhbNet(
    4, seed=1, batch_size=3, session_id=b"sanitizer-rlc",
    rlc=True, flush_every=0,
)
lib, h = nat2.lib, nat2.handle
mod = nat2._suite.scalar_modulus

def corrupt(sender, mtype, era, epoch, proposer, rnd):
    if mtype not in (8, 10):  # BA_COIN / HB_DECRYPT
        return
    buf = (ctypes.c_uint8 * 32)()
    lib.hbe_tamper_share(h, buf)
    out = (2 * int.from_bytes(bytes(buf), "big") % mod).to_bytes(32, "big")
    ob = (ctypes.c_uint8 * 32).from_buffer_copy(out)
    lib.hbe_tamper_set_share(h, ob, 32)

cb = _TAMPER_CB(corrupt)
lib.hbe_set_tamper(h, cb)
lib.hbe_set_tampered(h, 0, 1)
for i in nat2.correct_ids:
    nat2.send_input(i, ("rlc-tx", i))
nat2.run_until(
    lambda e: all(len(e.nodes[i].outputs) >= 1 for i in (1, 2)),
    chunk=256,
)
kinds = {k for i in (1, 2) for (_, k) in nat2.faults(i)}
assert "threshold_sign:invalid-share" in kinds, kinds
assert int(lib.hbe_prof_count(h, 11)) > 0, "RLC verdict pass never ran"
print("SANITIZED-RLC-BISECT-OK")

# The message-boundary wire API on hostile input: every truncation and a
# bit-flip sweep of a real egress frame through hbe_wire_classify, and a
# mixed good/corrupt/short burst of plain MSG records through
# hbe_node_ingest_wire, where an out-of-bounds read hides most easily.
import random as _wrng
from hbbft_tpu_torch.crypto.suite import ScalarSuite
from hbbft_tpu_torch.native_engine import NativeNodeEngine
from hbbft_tpu_torch.transport.cluster import build_netinfo

_suite = ScalarSuite()
node = NativeNodeEngine(
    0, build_netinfo(4, 1, 0, _suite, 0), seed=0, batch_size=3,
    session_id=b"san-wire",
)
node.handle_input(Input.user("wire-tx"))
node.run()
frames = []
node.drain_egress(lambda d, p: frames.append(p))
assert frames, "cluster-mode engine produced no egress"
payload = frames[0]
wl = node.lib
for cut in range(len(payload) + 1):
    wl.hbe_wire_classify(payload[:cut], cut)
rng9 = _wrng.Random(5)
mut = payload
for _ in range(500):
    i = rng9.randrange(len(payload))
    mut = payload[:i] + bytes([payload[i] ^ (1 << rng9.randrange(8))]) + payload[i + 1:]
    wl.hbe_wire_classify(mut, len(mut))
batch = [payload[: len(payload) // 2], b"", bytes([255]) * 9, mut, payload]
node.ingest_wire([1, 2, 99, 0, 2], [(0, p) for p in batch])  # 99 out of range, 0 local
node.run()
assert node.stats()["bad_payload"] >= 2, node.stats()
print("SANITIZED-WIRE-OK")

# The MSGB fast path on hostile input: real per-destination MSGB bodies
# back through hbe_node_ingest_wire among structurally corrupt records,
# then a clamped max_body drain (the group-split path).
nodeb = NativeNodeEngine(
    0, build_netinfo(4, 1, 0, _suite, 0), seed=0, batch_size=3,
    session_id=b"san-msgb",
)
nodeb.handle_input(Input.user("msgb-tx"))
nodeb.run()
groups = []
nodeb.drain_egress_msgb(lambda d, nm, b: groups.append((nm, b)), 1 << 20)
assert any(nm > 1 for nm, _ in groups), "no MSGB groups drained"
gnm, gbody = next((nm, b) for nm, b in groups if nm > 1)
records = [
    (gnm, gbody),                                     # clean batch
    (gnm + 1, gbody),                                 # claim mismatch
    (gnm, gbody[: len(gbody) // 2]),                  # truncated
    (gnm, gbody + bytes([0, 7])),                     # trailing garbage
    (gnm + 9, (gnm + 9).to_bytes(4, "big") + gbody[4:]),  # inflated count
    (1, b""),                                         # empty body
    (0, gbody),                                       # MSGB bytes as MSG
]
before20 = nodeb.stats()
nodeb.ingest_wire([1, 2, 3, 1, 2, 3, 1], records)
nodeb.run()
after20 = nodeb.stats()
assert after20["handled"] - before20["handled"] >= gnm, after20
assert after20["bad_payload"] - before20["bad_payload"] >= 5, after20
nodeb.drain_egress_msgb(lambda d, nm, b: None, 1)  # clamped split drain
print("SANITIZED-MSGB-OK")

# One mixed good/equivocating/corrupt burst: the chaos plane's variants
# are valid wire traffic and must be classified and ingested among
# corrupt and truncated frames.
from hbbft_tpu_torch.chaos.strategies import (
    EQUIVOCABLE_KINDS, SHARE_KINDS, tamper_payload,
)

rng11 = _wrng.Random(11)
node3 = NativeNodeEngine(
    0, build_netinfo(4, 1, 0, _suite, 0), seed=0, batch_size=3,
    session_id=b"san-chaos",
)
node3.handle_input(Input.user("chaos-tx"))
node3.run()
frames3 = []
node3.drain_egress(lambda d, p: frames3.append(p))
variants = []
for p in frames3:
    v = tamper_payload(p, rng11, _suite, EQUIVOCABLE_KINDS | SHARE_KINDS)
    if v is not None:
        variants.append(v)
assert variants, "no equivocable egress traffic produced"
for v in variants:
    assert int(wl.hbe_wire_classify(v, len(v))) > 0, "variant rejected"
good = frames3[0]
corrupt = bytes([good[0] ^ 0xFF]) + good[1:]
mixed = [
    good,
    variants[0],
    corrupt,
    variants[-1][: max(1, len(variants[-1]) // 2)],
    variants[0] + b"\\x00",  # trailing garbage: reject path
]
node3.ingest_wire([1, 2, 3, 1, 2], [(0, m) for m in mixed])
node3.run()
assert node3.stats()["handled"] >= 2, node3.stats()
print("SANITIZED-CHAOS-OK")

# The vectorized field plane, both dispatch arms forced in-process
# (hbe_simd_force): products, dots and Lagrange weights at odd tails and
# non-canonical inputs, and an epoch per arm with identical batches.  On
# a host without IFMA, force(1) resolves to the scalar arm.
import random as _frng

flib = nat.lib
mod_r = (0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001)
rng15 = _frng.Random(15)
lag_idxs = _frng.Random(99).sample(range(200), 33)
arm_results = []
for arm in (0, 1):
    got = int(flib.hbe_simd_force(arm))
    for trial in range(6):
        n = rng15.choice([1, 3, 7, 8, 9, 17, 40])
        a = [rng15.randrange(mod_r) for _ in range(n)]
        b = [
            v + mod_r
            if rng15.random() < 0.4 and v + mod_r < (1 << 256)
            else v
            for v in (rng15.randrange(mod_r) for _ in range(n))
        ]
        ab = b"".join(x.to_bytes(32, "big") for x in a)
        bb = b"".join(x.to_bytes(32, "big") for x in b)
        out = (ctypes.c_uint8 * (32 * n))()
        flib.hbe_field_mul_batch(ab, bb, n, out)
        got_v = [
            int.from_bytes(bytes(out[32 * i : 32 * i + 32]), "big")
            for i in range(n)
        ]
        assert got_v == [(x * y) % mod_r for x, y in zip(a, b)], (arm, trial)
        o32 = (ctypes.c_uint8 * 32)()
        flib.hbe_field_dot(ab, bb, n, o32)
        assert int.from_bytes(bytes(o32), "big") == (
            sum(x * y for x, y in zip(a, b)) % mod_r
        ), (arm, trial)
    k = 33
    outl = (ctypes.c_uint8 * (32 * k))()
    flib.hbe_field_lagrange((ctypes.c_int32 * k)(*lag_idxs), k, outl)
    nat15 = native_engine.NativeQhbNet(
        4, seed=3, batch_size=3, session_id=b"sanitizer-simd", **kw
    )
    for i in nat15.correct_ids:
        nat15.send_input(i, ("simd-tx", i))
    nat15.run_until(
        lambda e: all(len(e.nodes[i].outputs) >= 1 for i in e.correct_ids),
        chunk=chunk,
    )
    arm_results.append(
        (
            bytes(outl),
            [
                [(b.era, b.epoch, b.contributions) for b in nat15.nodes[i].outputs[:1]]
                for i in nat15.correct_ids
            ],
        )
    )
    nat15.close()
flib.hbe_simd_force(-1)
assert arm_results[0] == arm_results[1], "SIMD arms diverged"
print("SANITIZED-SIMD-OK")

# The epoch arena and the batched sha3 plane: the recycling arm (every
# stage above; ASan poisons recycled blocks) and the free-every-epoch arm
# (HBBFT_TORCH_ARENA=0, read at hbe_create) give the same first batch,
# and the sha3 batch kernel is fuzzed at the SHA3-256 rate boundaries in
# both dispatch arms against hashlib.
import hashlib as _hl
import os as _os

for _arm in (0, 1):
    flib.hbe_simd_force(_arm)
    for _mlen in (0, 1, 135, 136, 137, 271, 272):
        for _cnt in (1, 7, 8, 9, 17):
            _msgs = [
                bytes((_arm * 31 + i + j) & 0xFF for j in range(_mlen))
                for i in range(_cnt)
            ]
            _out = (ctypes.c_uint8 * (32 * _cnt))()
            flib.hbe_sha3_batch(b"".join(_msgs), _mlen, _cnt, _out)
            for i in range(_cnt):
                assert (
                    bytes(_out[32 * i : 32 * i + 32])
                    == _hl.sha3_256(_msgs[i]).digest()
                ), (_arm, _mlen, _cnt, i)
flib.hbe_simd_force(-1)

_os.environ["HBBFT_TORCH_ARENA"] = "0"
try:
    nat17 = native_engine.NativeQhbNet(
        4, seed=1, batch_size=3, session_id=b"sanitizer", **kw
    )
    for i in range(4):
        nat17.send_input(i, ("tx", i))
    nat17.run_until(
        lambda e: all(len(e.nodes[i].outputs) >= 1 for i in e.correct_ids),
        chunk=chunk,
    )
    keys17 = [
        [(b.era, b.epoch, b.contributions) for b in nat17.nodes[i].outputs[:1]]
        for i in nat17.correct_ids
    ]
    assert keys17 == keys, "ARENA=0 arm diverged from the recycling arm"
    assert nat17.arena_stats()["recycle"] == 0
    nat17.close()
finally:
    _os.environ.pop("HBBFT_TORCH_ARENA", None)
print("SANITIZED-ARENA-SHA3-OK")

# The port's own lines: external crypto over the scalar suite with a
# backend whose third flush raises.  The verify callback stops the engine
# (hbe_abort); the error reaches the caller, no fault is recorded, later
# calls raise, and close() frees the stopped engine.
from hbbft_tpu_torch.crypto.backend import BatchedBackend
from hbbft_tpu_torch.cryptoplane.service import DeviceFlushError


class FailingBackend:
    on_device = True

    def __init__(self, inner, k):
        self.inner, self.k, self.calls = inner, k, 0

    def verify_batch(self, reqs):
        self.calls += 1
        if self.calls == self.k:
            raise DeviceFlushError(f"flush {self.k} failed on the device")
        return self.inner.verify_batch(reqs)


fb = FailingBackend(BatchedBackend(_suite), 3)
nat_a = native_engine.NativeQhbNet(
    4, seed=3, batch_size=8, num_faulty=0, session_id=b"qhb-test", suite=_suite,
    backend=fb, external_crypto=True, flush_every=1,
)
for i in range(4):
    nat_a.send_input(i, Input.user(f"tx-{i}"))
try:
    nat_a.run_until(lambda e: all(len(e.nodes[i].outputs) >= 2 for i in e.correct_ids))
except DeviceFlushError as exc:
    assert "flush 3 failed" in str(exc), exc
else:
    raise AssertionError("the failed flush did not reach the caller")
assert fb.calls == 3, fb.calls
assert [nat_a.faults(i) for i in range(4)] == [[], [], [], []]
delivered = nat_a.delivered
for call in (nat_a.run, nat_a.flush):
    try:
        call()
    except RuntimeError as exc:
        assert "stopped at a failed verify flush" in str(exc), exc
    else:
        raise AssertionError(f"{call.__name__} ran on after the abort")
assert nat_a.delivered == delivered and fb.calls == 3
nat_a.close()
assert nat_a.handle is None
print("SANITIZED-ABORT-OK")
"""


def _nice() -> list:
    nice = shutil.which("nice")
    return [nice, "-n", "10"] if nice else []


def _runtime(sanitizer: str) -> str:
    from hbbft_tpu_torch import build

    try:
        return build.sanitizer_runtime(sanitizer)
    except RuntimeError as exc:
        pytest.skip(str(exc))


def _build(sanitizer: str) -> None:
    """The sanitized engine of width 4, built at nice 10 in a process of
    its own (no runtime preloaded into g++)."""
    code = (
        "from hbbft_tpu_torch import build\n"
        f"print(build.build_host('engine', 4, sanitizer={sanitizer!r}))\n"
    )
    res = subprocess.run(_nice() + [sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]


def _drive(sanitizer: str, extra_env: dict, threads: int = 0) -> subprocess.CompletedProcess:
    _build(sanitizer)
    env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "PYTHONPATH": REPO,
        "LD_PRELOAD": _runtime(sanitizer),
        **extra_env,
    }
    cmd = _nice() + [sys.executable, "-c", DRIVER, sanitizer]
    if threads:
        cmd.append(str(threads))
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=900)


def _check(res: subprocess.CompletedProcess, report: str, markers=MARKERS) -> None:
    assert res.returncode == 0, res.stderr[-4000:]
    for marker in markers:
        assert f"SANITIZED-{marker}-OK" in res.stdout, (marker, res.stdout[-2000:])
    assert report not in res.stderr, res.stderr[-4000:]
    _same_batches_as_the_reference(res.stdout, threads=0)


def _same_batches_as_the_reference(stdout: str, threads: int) -> None:
    """The driver's first committed batches are the reference's
    ``NativeQhbNet`` ones at the same arguments, run in this process."""
    from hbbft_tpu import native_engine as ref
    from hbbft_tpu.utils import serde as ref_serde

    line = next(ln for ln in stdout.splitlines() if ln.startswith("SANITIZED-BATCHES "))
    got = bytes.fromhex(line.split()[1])
    if not ref.available():
        pytest.fail("the reference's native engine did not build")
    kw = {"threads": threads} if threads else {}
    nat = ref.NativeQhbNet(4, seed=1, batch_size=3, session_id=b"sanitizer", **kw)
    for i in range(4):
        nat.send_input(i, ("tx", i))
    nat.run_until(lambda e: all(len(e.nodes[i].outputs) >= 1 for i in e.correct_ids),
                  chunk=1 if threads == 0 else 256)
    want = [[(b.era, b.epoch, b.contributions) for b in nat.nodes[i].outputs[:1]]
            for i in nat.correct_ids]
    nat.close()
    assert got == ref_serde.dumps(want)


def test_asan_native_epoch():
    # Python's own allocations "leak" by ASan's lights; the checks that
    # matter are the engine's heap misuse.
    res = _drive("address", {"ASAN_OPTIONS": "detect_leaks=0"})
    _check(res, "AddressSanitizer")


def test_ubsan_native_epoch():
    res = _drive("undefined", {})
    _check(res, "runtime error")


@pytest.mark.slow
def test_tsan_multithread_epoch():
    res = _drive("thread", {"TSAN_OPTIONS": "report_thread_leaks=0"}, threads=2)
    assert res.returncode == 0, res.stderr[-4000:]
    for marker in [m for m in MARKERS if m != "CHAOS"]:
        assert f"SANITIZED-{marker}-OK" in res.stdout, (marker, res.stdout[-2000:])
    assert "WARNING: ThreadSanitizer" not in res.stderr, res.stderr[-4000:]
    _same_batches_as_the_reference(res.stdout, threads=2)


@pytest.mark.parametrize("sanitizer", ["address", "thread"])
def test_sanitized_build_needs_its_runtime_preloaded(sanitizer):
    """Selecting an ASan or TSan engine in a python without the runtime
    preloaded raises ``RuntimeError`` naming the runtime, before any
    build, and the engine never reads as "unavailable"."""
    code = (
        "from hbbft_tpu_torch import native_engine\n"
        f"native_engine.use_engine_build({sanitizer!r})\n"
        "try:\n"
        "    native_engine.available()\n"
        "except RuntimeError as exc:\n"
        "    print('RAISED', exc)\n"
        "try:\n"
        "    native_engine.NativeQhbNet(4, seed=1)\n"
        "except RuntimeError as exc:\n"
        "    print('RAISED', exc)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    runtime = {"address": "libasan.so", "thread": "libtsan.so"}[sanitizer]
    assert len(lines) == 2 and all(ln.startswith("RAISED") and f"LD_PRELOAD={runtime}" in ln
                                   for ln in lines), res.stdout


def test_engine_build_is_chosen_before_the_first_engine():
    """``use_engine_build`` refuses an unknown sanitizer, and refuses to
    switch builds once an engine is loaded."""
    code = (
        "from hbbft_tpu_torch import native_engine\n"
        "try:\n"
        "    native_engine.use_engine_build('memory')\n"
        "except ValueError:\n"
        "    print('UNKNOWN')\n"
        "assert native_engine.available()\n"
        "native_engine.use_engine_build(None)\n"
        "try:\n"
        "    native_engine.use_engine_build('undefined')\n"
        "except RuntimeError:\n"
        "    print('LOADED')\n"
    )
    res = subprocess.run(_nice() + [sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=900, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["UNKNOWN", "LOADED"], res.stdout


@pytest.mark.parametrize("sanitizer", ["address", "undefined", "thread"])
def test_sanitized_build_steps_take_the_reference_flags(sanitizer):
    """Both compile steps of a sanitized engine carry the reference's
    ``SAN_FLAGS`` and the sanitizer's own flags (``field_ifma.cpp``
    included), and each sanitizer and width has a library of its own."""
    from hbbft_tpu_torch import build

    want = {"address": ["-fsanitize=address"],
            "undefined": ["-fsanitize=undefined", "-fno-sanitize-recover=all"],
            "thread": ["-fsanitize=thread"]}[sanitizer]
    steps = build._host_steps("engine", 4, sanitizer)
    assert [s[-1].rsplit("/", 1)[-1] for s in steps] == ["field_ifma.cpp", "engine.cpp"]
    for step in steps:
        assert step[:5] == ["-O1", "-g", "-fno-omit-frame-pointer", "-fPIC", "-std=c++17"]
        assert step[5:5 + len(want)] == want and "-O3" not in step
    assert "-DHBE_WORDS=4" in steps[1] and "-shared" in steps[1] and "-pthread" in steps[1]
    paths = {build.host_library_path("engine", w, s) for w in (4, 8)
             for s in (None, *build.SANITIZERS)}
    assert len(paths) == 8
    assert build.host_library_path("engine", 4, sanitizer).name.startswith(
        f"libhbbft_engine_w4_{sanitizer}-")
    with pytest.raises(ValueError):
        build._host_steps("native", 4, sanitizer)



@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_sanitizer_launches_hold_every_kernel_to_its_plain_version(card):
    """The launches each compute-sanitizer child makes (one of every hand
    kernel at the shapes that take its branches: a 130-leaf tree, 3-block
    sponge messages, a 34-row leg, an identity row and identity pairs)
    equal the plain versions, with no tool attached."""
    from hbbft_tpu_torch.tools import kernel_sanitizer as ks

    assert sorted(ks.exercise()) == sorted(ks.KERNELS)


@pytest.mark.cuda
def test_hand_kernels_under_compute_sanitizer(card):
    """Every hand kernel, launched at the smallest shapes that take its
    branches and held to its plain version, under memcheck, racecheck,
    synccheck and initcheck (``tools.kernel_sanitizer.run``): each tool's
    summary counts 0 errors.  Skips without a card, and where
    the card's driver does not let the tool attach."""
    from hbbft_tpu_torch.tools import kernel_sanitizer as ks

    if ks.sanitizer_path() is None:
        pytest.skip("the CUDA toolkit has no compute-sanitizer")
    results = ks.run()
    blocked = [r for r in results if not r["supported"]]
    if blocked:
        pytest.skip(f"compute-sanitizer cannot attach to this card ({ks.UNSUPPORTED!r}, "
                    f"{[r['tool'] for r in blocked]})")
    for r in results:
        assert r["clean"], (r["tool"], r["summary"], r["report"][:20], r["stderr"])
        assert sorted(r["kernels"]) == sorted(ks.KERNELS), r


HELD = "".join(f"HELD {name} -\n" for name in (
    "sha3_256_kernel", "merkle_tree_kernel", "fq_mont_mul_kernel", "scan_g1_rows",
    "scan_g2_rows", "scan_g1_sums", "scan_g2_sums", "pair_miller", "pair_final"))
BANNER = "========= COMPUTE-SANITIZER\n"
UNSUPPORTED = (BANNER + "========= Error: Device not supported. Please refer to the "
               "\"Supported Devices\" section of the sanitizer documentation\n")


@pytest.mark.parametrize("tool,rc,stdout,clean,supported", [
    ("memcheck", 0, HELD + BANNER + "========= ERROR SUMMARY: 0 errors\n", True, True),
    ("racecheck", 0, HELD + BANNER
     + "========= RACECHECK SUMMARY: 0 hazards displayed (0 errors, 0 warnings)\n", True, True),
    ("racecheck", 1, HELD + BANNER
     + "========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 warnings)\n", False, True),
    ("initcheck", 1, HELD + BANNER + "========= ERROR SUMMARY: 10 errors\n", False, True),
    ("synccheck", 0, HELD.split("HELD pair_final")[0] + BANNER
     + "========= ERROR SUMMARY: 0 errors\n", False, True),
    ("memcheck", 1, UNSUPPORTED + "========= ERROR SUMMARY: 3 errors\n", False, False),
], ids=["memcheck-clean", "racecheck-clean", "racecheck-hazard", "initcheck-errors",
        "kernel-missing", "unsupported"])
def test_compute_sanitizer_verdict(tool, rc, stdout, clean, supported):
    """A tool's run is clean only with rc 0, every kernel held to its
    plain version and a summary of 0 errors (racecheck's summary line is
    its own); "Device not supported" reads as not supported."""
    from hbbft_tpu_torch.tools import kernel_sanitizer as ks

    got = ks.verdict(tool, rc, stdout, "", 1.0)
    assert (got["clean"], got["supported"]) == (clean, supported), got
    assert "SUMMARY:" in got["summary"]
