"""The port's consensus plane against the JAX package's, run by run.

The same net is built in both packages from the same seed — ScalarSuite,
the host ``BatchedBackend``, the same adversary and flush policy — and
driven with the same inputs.  The two packages' dataclasses are different
classes, so the runs are compared at plain-data level: outputs (batches as
(epoch, ((proposer, contribution), ...)), other values as their
``serde.dumps`` bytes in each package), the ``delivered`` count, the
verify requests and pool flushes the net counted, and each correct node's
fault multiset as sorted (``Fault.node_id``, ``Fault.kind``) pairs.  Every
comparison is exact.

Also here: ``batch_propose`` on the plain versions (``device="cpu"``)
equals per-instance ``handle_input`` and launches no kernel, and one small
BLS run verifies every share through ``TorchBackend(device="cpu")`` against
the reference's host ``BatchedBackend``.
"""

import importlib
import random

import pytest

from torch_low_priority import low_priority

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _plain(pkg, out):
    """An output as plain data comparable across the two packages."""
    kind = type(out).__name__
    if kind == "Batch":
        return ("batch", out.epoch, tuple(out.contributions))
    if kind == "SubsetOutput":
        return ("subset", out.kind, out.proposer, out.value)
    if isinstance(out, (bool, bytes)):
        return out
    return (kind, _mod(pkg, "utils.serde").dumps(out))


def _summary(pkg, net):
    return {
        "outputs": {
            nid: [_plain(pkg, o) for o in net.node(nid).outputs]
            for nid in net.correct_ids
        },
        "delivered": net.delivered,
        "flushes": (net.metrics.counters.get("verify_requests", 0),
                    net.metrics.timers["verify_flush"].count
                    if "verify_flush" in net.metrics.timers else 0),
        "faults": {
            nid: sorted((f.node_id, f.kind) for f in net.node(nid).faults)
            for nid in net.correct_ids
        },
    }


def _adversary(pkg, name):
    net = _mod(pkg, "net")
    if name == "TamperingAdversary":
        return net.TamperingAdversary(tamper_p=0.5)
    return getattr(net, name)()


def _threshold_sign(pkg):
    net_m = _mod(pkg, "net")
    ts = _mod(pkg, "protocols.threshold_sign")
    net = (
        net_m.NetBuilder(7, seed=7)
        .protocol(lambda ni, sink, rng: ts.ThresholdSign(ni, b"doc", sink))
        .adversary(net_m.ReorderingAdversary())
        .build()
    )
    net.broadcast_input(lambda nid: None)
    net.run_to_termination()
    return net


def _threshold_decrypt(pkg):
    net_m = _mod(pkg, "net")
    td = _mod(pkg, "protocols.threshold_decrypt")
    net = (
        net_m.NetBuilder(7, seed=3)
        .protocol(lambda ni, sink, rng: td.ThresholdDecrypt(ni, sink))
        .adversary(net_m.ReorderingAdversary())
        .build()
    )
    pk = net.node(0).netinfo.public_key_set.public_key()
    ct = pk.encrypt(b"batch contribution: txns 17, 42", random.Random(99))
    net.broadcast_input(lambda nid: ct)
    net.run_to_termination()
    return net


def _broadcast(pkg):
    net_m = _mod(pkg, "net")
    bc = _mod(pkg, "protocols.broadcast")
    net = (
        net_m.NetBuilder(7, seed=31)
        .protocol(lambda ni, sink, rng: bc.Broadcast(ni, 0))
        .adversary(net_m.ReorderingAdversary())
        .build()
    )
    net.send_input(0, random.Random(5).randbytes(700))
    net.run_to_termination()
    return net


def _binary_agreement(pkg):
    net_m = _mod(pkg, "net")
    ba = _mod(pkg, "protocols.binary_agreement")
    net = (
        net_m.NetBuilder(4, seed=2)
        .protocol(lambda ni, sink, rng: ba.BinaryAgreement(ni, b"aba-session", sink))
        .adversary(net_m.RandomAdversary())
        .build()
    )
    net.broadcast_input(lambda nid: nid % 2 == 0)
    net.run_to_termination()
    return net


def _subset(pkg):
    net_m = _mod(pkg, "net")
    sub = _mod(pkg, "protocols.subset")
    net = (
        net_m.NetBuilder(4, seed=1)
        .protocol(lambda ni, sink, rng: sub.Subset(ni, b"acs-0", sink))
        .adversary(net_m.ReorderingAdversary())
        .build()
    )
    for nid in net.correct_ids:
        net.send_input(nid, f"contrib-{nid}".encode())
    net.run_to_termination(max_cranks=500_000)
    return net


def _honey_badger(adversary, epochs, flush):
    def run(pkg):
        net_m = _mod(pkg, "net")
        hb = _mod(pkg, "protocols.honey_badger")
        b = (
            net_m.NetBuilder(4, seed=11)
            .flush_every(flush)
            .protocol(lambda ni, sink, rng: hb.HoneyBadger(
                ni, sink, session_id=b"hb-test",
                encryption_schedule=hb.EncryptionSchedule.always()))
            .adversary(_adversary(pkg, adversary))
        )
        if adversary == "TamperingAdversary":
            b = b.num_faulty(1)
        net = b.build()
        for e in range(epochs):
            for nid in net.correct_ids:
                net.send_input(nid, [f"tx-{nid}-{e}-{i}" for i in range(3)])
            net.crank_until(
                lambda n: all(len(n.node(i).outputs) > e for i in n.correct_ids),
                max_cranks=2_000_000,
            )
        return net

    return run


CASES = {
    "threshold_sign_n7": _threshold_sign,
    "threshold_decrypt_n7": _threshold_decrypt,
    "broadcast_n7": _broadcast,
    "binary_agreement_n4": _binary_agreement,
    "subset_n4": _subset,
}
for _adv in ("NullAdversary", "ReorderingAdversary", "RandomAdversary", "TamperingAdversary"):
    for _epochs in (1, 3):
        for _flush in (1, 16):
            CASES[f"honey_badger_n4_{_adv}_e{_epochs}_f{_flush}"] = _honey_badger(
                _adv, _epochs, _flush
            )


@pytest.mark.parametrize("case", sorted(CASES))
@low_priority
def test_run_identity(case):
    ref, port = (_summary(pkg, CASES[case](pkg)) for pkg in PKGS)
    assert port == ref
    # The runs did something: every correct node has an output.
    assert all(ref["outputs"].values())


def test_tampering_run_records_faults_against_the_faulty_node_only():
    """The identity above also covers faults; this pins that the tampered
    HoneyBadger runs record some, all against the faulty node."""
    net = _honey_badger("TamperingAdversary", 1, 1)("hbbft_tpu_torch")
    faults = [f for nid in net.correct_ids for f in net.node(nid).faults]
    assert faults
    assert {f.node_id for f in faults} == set(net.faulty_ids)
    assert net.correct_faults() == []


def test_batch_propose_on_the_plain_data_plane_equals_handle_input():
    """Port of ``tests/test_broadcast.py::test_batch_propose_matches_individual``
    on ``device="cpu"``: the same proof bytes as per-instance
    ``handle_input`` in the port and in the reference, no kernel launched,
    no instance sent down the host route."""
    from hbbft_tpu_torch import build
    from hbbft_tpu_torch.protocols import broadcast as pbc
    from hbbft_tpu_torch.utils import serde as pserde
    from hbbft_tpu.utils import serde as rserde

    def nets(pkg):
        net_m = _mod(pkg, "net")
        bc = _mod(pkg, "protocols.broadcast")
        return [
            net_m.NetBuilder(7, seed=40 + i)
            .protocol(lambda ni, sink, rng: bc.Broadcast(ni, 0))
            .build()
            for i in range(4)
        ]

    payloads = [random.Random(i).randbytes(300) for i in range(4)]
    build.reset_launches()
    pbc.HOST_ROUTE.clear()
    nets_a = nets("hbbft_tpu_torch")
    steps = pbc.batch_propose(
        [net.node(0).protocol for net in nets_a], payloads, device="cpu"
    )
    assert dict(build.LAUNCHES) == {}
    assert dict(pbc.HOST_ROUTE) == {}

    def wire(serde, step):
        return [(repr(tm.target), serde.dumps(tm.message)) for tm in step.messages]

    batched = [wire(pserde, s) for s in steps]
    one_by_one = [
        wire(pserde, net.node(0).protocol.handle_input(p, None))
        for net, p in zip(nets("hbbft_tpu_torch"), payloads)
    ]
    reference = [
        wire(rserde, net.node(0).protocol.handle_input(p, None))
        for net, p in zip(nets("hbbft_tpu"), payloads)
    ]
    assert batched == one_by_one
    assert [[m for _, m in w] for w in batched] == [[m for _, m in w] for w in reference]

    for net, step, payload in zip(nets_a, steps, payloads):
        net._process_step(net.node(0), step)
        net.run_to_termination()
        assert all(net.node(nid).outputs == [payload] for nid in net.correct_ids)
        assert net.correct_faults() == []


def test_batch_propose_counts_the_host_route():
    """Values alone at their shard length, and nets over 255 validators
    (GF(2^16), host only), take the per-instance path, counted."""
    from hbbft_tpu_torch.protocols import broadcast as pbc
    from hbbft_tpu_torch.protocols.network_info import NetworkInfo

    def instance(n):
        ni = NetworkInfo(our_id=0, val_ids=list(range(n)), public_key_set=None,
                         secret_key_share=None, public_keys={}, secret_key=None)
        return pbc.Broadcast(ni, 0)

    pbc.HOST_ROUTE.clear()
    steps = pbc.batch_propose(
        [instance(4), instance(300), instance(300)], [b"a" * 10, b"b" * 40, b"c" * 40],
        device="cpu",
    )
    assert dict(pbc.HOST_ROUTE) == {"single": 1, "gf16": 2}
    assert [len(s.messages) for s in steps] == [4, 300, 300]


def test_metrics_trace_captures_with_torch_profiler(tmp_path):
    """``Metrics.trace`` writes a ``torch.profiler`` trace into its logdir
    (the reference's captures with ``jax.profiler``)."""
    import torch

    from hbbft_tpu_torch.utils.metrics import Metrics

    with Metrics().trace(str(tmp_path)):
        torch.ones(8).add_(1)
    assert any(p.name.endswith(".pt.trace.json") for p in tmp_path.iterdir())


@pytest.mark.slow  # ~100 s: four flushes plus bisection, each plain stage seconds
@low_priority
def test_bls_threshold_sign_under_tampering_through_torch_backend_on_cpu():
    """ThresholdSign N = 4 over BLS12-381 with a tampering validator: the
    port with ``TorchBackend(device="cpu")`` (plain scan and pair stages,
    bisection down to ``EagerBackend``) and the reference with its host
    ``BatchedBackend`` give the same signature bytes, delivered count and
    fault multisets, and the forged shares are rejected."""
    from hbbft_tpu_torch.crypto.device.backend import TorchBackend

    def run(pkg):
        net_m = _mod(pkg, "net")
        ts = _mod(pkg, "protocols.threshold_sign")
        suite = _mod(pkg, "crypto.bls.suite").BLSSuite()
        if pkg == "hbbft_tpu_torch":
            factory = lambda s: TorchBackend(s, device="cpu")  # noqa: E731
        else:
            factory = _mod(pkg, "crypto.backend").BatchedBackend
        net = (
            net_m.NetBuilder(4, seed=101)
            .num_faulty(1)
            .suite(suite)
            .backend(factory)
            .flush_every(100_000)
            .protocol(lambda ni, sink, rng: ts.ThresholdSign(ni, b"bls-doc", sink))
            .adversary(net_m.TamperingAdversary(tamper_p=1.0))
            .build()
        )
        net.broadcast_input(lambda nid: None)
        net.run_to_termination()
        return net

    ref_net, port_net = run("hbbft_tpu"), run("hbbft_tpu_torch")
    assert _summary("hbbft_tpu_torch", port_net) == _summary("hbbft_tpu", ref_net)
    pks = port_net.node(0).netinfo.public_key_set
    sig = port_net.node(0).outputs[0]
    assert pks.verify_signature(b"bls-doc", sig)
    assert port_net.correct_faults() == []
    faults = [f for nid in port_net.correct_ids for f in port_net.node(nid).faults]
    assert {f.node_id for f in faults} <= set(port_net.faulty_ids)
