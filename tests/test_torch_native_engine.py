"""The port's native engine against the JAX package's, run by run.

``hbbft_tpu_torch.native_engine.NativeQhbNet`` (the C++ message loop of
``hbbft_tpu_torch/csrc/native/engine.cpp``, built by ``build.build_host``)
and the reference's ``hbbft_tpu.native_engine.NativeQhbNet`` are built
from the same seed and driven with the same inputs.  The runs are
compared at plain-data level: every correct node's batches as (era,
epoch, contributions, change state) with change and join plan as each
package's ``serde.dumps`` bytes, each node's (accused id, fault kind)
list, ``delivered``, ``flush_stats`` (external crypto), the epoch arena's
statistics and the sha3 plane's counters over the run.  Every comparison
is exact.  The sha3 counters are compared on one engine thread only:
under the multicore scheduler the engine's shared pure-function caches
(decoded roots, masks) make the hashing work depend on the threads'
interleaving, in either package, while every output stays the same.

Each package builds its engine once (the port's into
``hbbft_tpu_torch/build/``, content-hashed and shared by every test
process under the build lock), about half a minute of g++ a width.
"""

import importlib

import pytest

from torch_low_priority import low_priority

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")
BATCH_SIZE = 8

# Build the port's engine and host data plane while the tests are
# collected, as the reference's native tests build theirs (their
# module-level skipif): every test process then finds both built before
# any test runs, so no cluster test's commit deadline waits on g++ (the
# scalar KEM and the RS codec load them at their first use).
from hbbft_tpu_torch import native_engine as _port_engine  # noqa: E402
from hbbft_tpu_torch.ops import native as _port_native  # noqa: E402

assert _port_engine.get_lib() is not None, "the port's engine did not build"
assert _port_native.available(), "the port's host data plane did not build"
SESSION = b"qhb-test"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _dumps(pkg, value):
    return None if value is None else _mod(pkg, "utils.serde").dumps(value)


def _plain(pkg, b):
    change = (b.change.kind, _dumps(pkg, b.change.change))
    return (b.era, b.epoch, b.contributions, change, _dumps(pkg, b.join_plan))


def _sha3_delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def _summary(pkg, nat, sha3_before):
    ne = _mod(pkg, "native_engine")
    return {
        "batches": {
            i: [_plain(pkg, b) for b in nat.nodes[i].outputs] for i in nat.correct_ids
        },
        "faults": {i: nat.faults(i) for i in range(nat.n)},
        "delivered": nat.delivered,
        "flush_stats": dict(getattr(nat, "flush_stats", {})),
        "arena": nat.arena_stats(),
        "sha3": _sha3_delta(sha3_before, ne.sha3_plane_stats(nat.lib)),
        "eras": {i: nat.nodes[i].qhb.dhb.era for i in nat.correct_ids},
    }


def _net(pkg, n, seed, **kw):
    ne = _mod(pkg, "native_engine")
    words = kw.get("engine_words") or ne._words_for(n)
    lib = ne.get_lib(words)
    assert lib is not None, f"{pkg}: engine of width {words} did not build"
    before = ne.sha3_plane_stats(lib)
    nat = ne.NativeQhbNet(n, seed=seed, batch_size=BATCH_SIZE, session_id=SESSION, **kw)
    return nat, before


def _run_epochs(pkg, n, seed, epochs, chunk=50_000, **kw):
    """User transactions on every correct node, then run until every
    correct node has ``epochs`` batches."""
    qhb = _mod(pkg, "protocols.queueing_honey_badger")
    nat, before = _net(pkg, n, seed, **kw)
    for k in range(epochs):
        for nid in nat.correct_ids:
            nat.send_input(nid, qhb.Input.user(f"tx-{nid}-{k}"))
    nat.run_until(
        lambda e: all(len(e.nodes[i].outputs) >= epochs for i in e.correct_ids),
        chunk=chunk,
    )
    out = _summary(pkg, nat, before)
    nat.close()
    return out


def _run_era_change(pkg, seed, **kw):
    """Vote validator 3 out of a 4-node network (the reference's
    ``test_equivalence_era_change``): the DKG rides through consensus and
    the era restarts."""
    qhb = _mod(pkg, "protocols.queueing_honey_badger")
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    nat, before = _net(pkg, 4, seed, num_faulty=0, **kw)
    keep = dict(nat.nodes[0].qhb.dhb.netinfo.public_key_map)
    keep.pop(3)
    change = dhb.Change.node_change(keep)
    for nid in range(4):
        nat.send_input(nid, qhb.Input.change(change))

    def done(e):
        return all(
            any(b.change.kind == "complete" for b in e.nodes[i].outputs)
            for i in e.correct_ids
        )

    for r in range(8):
        if done(nat):
            break
        for nid in range(4):
            nat.send_input(nid, qhb.Input.user(f"e{r}-{nid}"))
        nat.run_until(
            lambda e, w=r + 1: all(len(e.nodes[i].outputs) >= w for i in e.correct_ids),
            chunk=1,
        )
    assert done(nat)
    out = _summary(pkg, nat, before)
    nat.close()
    return out


def _same(runs, threads=1):
    ref, port = runs
    assert port["batches"] == ref["batches"]
    assert port["faults"] == ref["faults"]
    assert port["delivered"] == ref["delivered"]
    assert port["flush_stats"] == ref["flush_stats"]
    assert port["arena"] == ref["arena"]
    if threads == 1:
        assert port["sha3"] == ref["sha3"]
    assert port["eras"] == ref["eras"]


# (n, seed, num_faulty, epochs, engine options): threads 1 and 2, rlc on
# and off, flush_every 0 and 1, the external scalar mode, and the wide
# NodeSet build.
PLAIN_CASES = [
    pytest.param(4, 1, 0, 3, dict(threads=1, rlc=True, flush_every=1), id="n4-t1-rlc-f1"),
    pytest.param(4, 2, 0, 2, dict(threads=2, rlc=True, flush_every=1), id="n4-t2-rlc-f1"),
    pytest.param(7, 5, 2, 2, dict(threads=1, rlc=False, flush_every=1), id="n7-t1-norlc-f1"),
    pytest.param(7, 6, 2, 2, dict(threads=1, rlc=True, flush_every=0), id="n7-t1-rlc-f0"),
    pytest.param(16, 3, None, 1, dict(threads=2, rlc=True, flush_every=1), id="n16-t2-rlc-f1"),
    pytest.param(16, 4, 0, 1, dict(threads=1, rlc=True, flush_every=0), id="n16-t1-rlc-f0"),
    pytest.param(4, 7, 1, 2, dict(external_crypto=True, flush_every=0), id="n4-ext-f0"),
    pytest.param(7, 8, 2, 1, dict(external_crypto=True, flush_every=1), id="n7-ext-f1"),
    pytest.param(4, 9, 0, 2, dict(engine_words=8), id="n4-words8"),
]


@pytest.mark.parametrize("n,seed,f,epochs,opts", PLAIN_CASES)
@low_priority
def test_engine_epochs_match_reference(n, seed, f, epochs, opts):
    kw = dict(opts)
    if f is not None:
        kw["num_faulty"] = f
    _same([_run_epochs(pkg, n, seed, epochs, **kw) for pkg in PKGS], kw.get("threads", 1))


@pytest.mark.parametrize("seed,opts", [
    pytest.param(11, {}, id="internal-scalar"),
    pytest.param(12, dict(external_crypto=True), id="external-scalar"),
])
@low_priority
def test_engine_era_change_matches_reference(seed, opts):
    runs = [_run_era_change(pkg, seed, **opts) for pkg in PKGS]
    _same(runs)
    assert runs[1]["eras"][0] >= 1


@low_priority
def test_engine_bls_epoch_matches_reference():
    """One real BLS12-381 epoch at N = 4, seed 1 (the reference's
    ``test_native_ext_crypto.py::test_bls_native_matches_python_net``
    run), each package over its own host ``BatchedBackend``."""
    runs = []
    for pkg in PKGS:
        suite = _mod(pkg, "crypto.bls.suite").BLSSuite()
        backend = _mod(pkg, "crypto.backend").BatchedBackend(suite)
        qhb = _mod(pkg, "protocols.queueing_honey_badger")
        nat, before = _net(pkg, 4, 1, num_faulty=1, suite=suite, backend=backend,
                           flush_every=1)
        for k in range(2):
            for nid in range(3):
                nat.send_input(nid, qhb.Input.user(f"tx-{nid}-{k}"))
        nat.run_until(
            lambda e: all(len(e.nodes[i].outputs) >= 1 for i in e.correct_ids), chunk=1
        )
        runs.append(_summary(pkg, nat, before))
        nat.close()
    _same(runs)
    assert runs[1]["flush_stats"]["flushes"] > 0


def test_engine_builds_once_into_the_port_build_dir():
    """The engine library is the content-hashed file of ``build.py``, and
    a second request for it returns the same path without building."""
    from hbbft_tpu_torch import build

    path = build.build_host("engine", 4)
    assert path.parent == build.BUILD_DIR
    assert path == build.host_library_path("engine", 4)
    mtime = path.stat().st_mtime_ns
    assert build.build_host("engine", 4) == path
    assert path.stat().st_mtime_ns == mtime
    assert build.host_library_path("engine", 8) != path


class _FailingBackend:
    """The host ``BatchedBackend`` until its ``k``-th flush, which raises
    the crypto service's ``DeviceFlushError`` (what a failed device flush
    raises) instead of returning verdicts."""

    on_device = True

    def __init__(self, inner, k):
        self.inner, self.k, self.calls, self.answered = inner, k, 0, 0

    def verify_batch(self, reqs):
        self.calls += 1
        if self.calls == self.k:
            from hbbft_tpu_torch.cryptoplane.service import DeviceFlushError

            raise DeviceFlushError(f"flush {self.k} failed on the device")
        self.answered += len(reqs)
        return self.inner.verify_batch(reqs)


@pytest.mark.parametrize("k,flush_every,how", [
    pytest.param(3, 1, "run_until", id="third-flush-run_until"),
    pytest.param(None, 0, "flush", id="forced-flush"),
    pytest.param(2, 0, "run", id="second-flush-run"),
])
def test_failed_flush_stops_the_run_at_that_flush(k, flush_every, how):
    """A backend that raises on its k-th flush: the error itself reaches
    the caller of the engine call in flight, the engine acts on none of
    that flush's verdicts (no fault against any node, no later flush),
    and every later call raises instead of running on."""
    from hbbft_tpu_torch import native_engine as ne
    from hbbft_tpu_torch.crypto.backend import BatchedBackend
    from hbbft_tpu_torch.crypto.suite import ScalarSuite
    from hbbft_tpu_torch.cryptoplane.service import DeviceFlushError
    from hbbft_tpu_torch.protocols.queueing_honey_badger import Input

    suite = ScalarSuite()
    # "flush": the first flush that fails is the one flush() forces.
    backend = _FailingBackend(BatchedBackend(suite), k or 1 << 30)
    nat = ne.NativeQhbNet(4, seed=3, batch_size=BATCH_SIZE, num_faulty=0,
                          session_id=SESSION, suite=suite, backend=backend,
                          external_crypto=True, flush_every=flush_every)
    for nid in range(4):
        nat.send_input(nid, Input.user(f"tx-{nid}"))

    def committed(e):
        return all(len(e.nodes[i].outputs) >= 2 for i in e.correct_ids)

    if how == "flush":
        for _ in range(100):
            if nat.pending_verifies:
                break
            nat.run(50)
        assert nat.pending_verifies > 0
        k = backend.k = backend.calls + 1
    with pytest.raises(DeviceFlushError, match=f"flush {k} failed"):
        if how == "run_until":
            nat.run_until(committed)
        elif how == "flush":
            nat.flush()
        else:
            nat.run()
    assert backend.calls == k
    assert nat.flush_stats["backend_requests"] == backend.answered
    assert [nat.faults(i) for i in range(4)] == [[], [], [], []]
    delivered = nat.delivered
    with pytest.raises(RuntimeError, match="stopped at a failed verify flush"):
        nat.run()
    with pytest.raises(RuntimeError, match="stopped at a failed verify flush"):
        nat.flush()
    assert nat.delivered == delivered and backend.calls == k
    nat.close()
