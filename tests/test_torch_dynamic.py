"""The port's dynamic stack against the JAX package's, run by run.

DynamicHoneyBadger, QueueingHoneyBadger and SenderQueue (with
JoiningSenderQueue) through era changes: the scenarios of
``tests/test_dynamic_honey_badger.py``, ``tests/test_queueing_honey_badger.py``
and ``tests/test_sender_queue_churn.py``, each built in both packages from
the same seed (ScalarSuite, the host ``BatchedBackend``) and driven with
the same inputs.  The runs are compared at plain-data level: batches as
(era, epoch, contributions, change state), join plans and other outputs
as each package's ``serde.dumps`` bytes, ``net.delivered``, the verify
requests and flushes the net counted, each correct node's sorted
(``Fault.node_id``, ``Fault.kind``) pairs, and each node's era, validator
role and ``PublicKeySet`` bytes at the end.  Every comparison is exact.
"""

import importlib
import random

import pytest

from torch_low_priority import low_priority

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _dumps(pkg, value):
    return None if value is None else _mod(pkg, "utils.serde").dumps(value)


def _plain(pkg, out):
    """An output as plain data comparable across the two packages."""
    kind = type(out).__name__
    if kind == "DhbBatch":
        change = (out.change.kind, _dumps(pkg, out.change.change))
        return ("dhb", out.era, out.epoch, out.contributions, change,
                _dumps(pkg, out.join_plan))
    if kind == "Batch":
        return ("batch", out.epoch, tuple(out.contributions))
    return (kind, _dumps(pkg, out))


def _dhb_of(proto):
    """The DynamicHoneyBadger under SenderQueue / QueueingHoneyBadger
    wrappers, or None (a JoiningSenderQueue that has not joined)."""
    while proto is not None and type(proto).__name__ in ("SenderQueue", "JoiningSenderQueue"):
        proto = proto.inner
    if type(proto).__name__ == "QueueingHoneyBadger":
        proto = proto.dhb
    return proto


def _era_view(proto):
    dhb = _dhb_of(proto)
    if dhb is None or not hasattr(dhb, "era"):
        return None
    ni = dhb.netinfo
    return (dhb.era, ni.is_validator(), tuple(ni.all_ids), ni.public_key_set.to_bytes())


def _summary(pkg, net, extra=None):
    out = {
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
        "eras": {nid: _era_view(net.node(nid).protocol) for nid in net.correct_ids},
    }
    if extra is not None:
        out["extra"] = extra
    return out


def _batches(pkg, net, nid):
    cls = _mod(pkg, "protocols.dynamic_honey_badger").DhbBatch
    return [o for o in net.node(nid).outputs if isinstance(o, cls)]


def _complete_everywhere(pkg, ids, era=None):
    def done(net):
        return all(
            any(b.change.kind == "complete" and (era is None or b.era == era)
                for b in _batches(pkg, net, i))
            for i in ids
        )
    return done


# -- DynamicHoneyBadger (tests/test_dynamic_honey_badger.py) ----------------


def _dhb_net(pkg, n, seed, adversary=None, observers=0, schedule=None):
    net_m = _mod(pkg, "net")
    hb = _mod(pkg, "protocols.honey_badger")
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    schedule = schedule or hb.EncryptionSchedule.always()
    b = (net_m.NetBuilder(n, seed=seed).num_faulty(0)
         .protocol(lambda ni, sink, rng: dhb.DynamicHoneyBadger(
             ni, sink, session_id=b"dhb-test", encryption_schedule=schedule)))
    if observers:
        b = b.observers(observers)
    if adversary is not None:
        b = b.adversary(getattr(net_m, adversary)())
    return b.build()


def _drive_epoch(pkg, net, epoch_idx, proposers=None):
    proposers = proposers if proposers is not None else net.correct_ids
    for nid in proposers:
        net.send_input(nid, [f"tx-{nid}-{epoch_idx}"])
    net.crank_until(
        lambda n: all(len(_batches(pkg, n, i)) > epoch_idx for i in n.correct_ids),
        max_cranks=2_000_000,
    )


def _vote_all(net, change, ids):
    for nid in ids:
        node = net.node(nid)
        net._process_step(node, node.protocol.vote_for(change, node.rng))


def _drive_until(pkg, net, done, proposers=None, max_epochs=12):
    epoch = 0
    while not done(net):
        assert epoch < max_epochs, "era change did not complete"
        _drive_epoch(pkg, net, epoch, proposers)
        epoch += 1
    return epoch


def dhb_no_change(pkg):
    net = _dhb_net(pkg, 4, 3, adversary="ReorderingAdversary")
    _drive_epoch(pkg, net, 0)
    _drive_epoch(pkg, net, 1)
    return net, None


def dhb_remove_validator(pkg):
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    net = _dhb_net(pkg, 4, 4)
    ni = net.node(0).netinfo
    _vote_all(net, dhb.Change.node_change(
        {i: ni.public_key(i) for i in ni.all_ids if i != 3}), net.correct_ids)
    _drive_until(pkg, net, _complete_everywhere(pkg, net.correct_ids))
    remaining = [0, 1, 2]
    start = len(_batches(pkg, net, 0))
    for nid in remaining:
        net.send_input(nid, [f"era1-tx-{nid}"])
    net.crank_until(lambda n: all(len(_batches(pkg, n, i)) > start for i in remaining),
                    max_cranks=2_000_000)
    return net, None


def dhb_add_observer(pkg):
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    net = _dhb_net(pkg, 5, 5, observers=1)
    base = net.node(0).netinfo
    new_map = {i: base.public_key(i) for i in base.all_ids}
    new_map[4] = net.node(4).protocol.netinfo.secret_key.public_key()
    _vote_all(net, dhb.Change.node_change(new_map), base.all_ids)
    _drive_until(pkg, net, _complete_everywhere(pkg, net.correct_ids),
                 proposers=list(base.all_ids))
    for nid in net.correct_ids:
        net.send_input(nid, [f"era1-{nid}"])
    net.crank_until(
        lambda n: any(b.era == 1 and 4 in b.contribution_map()
                      for i in n.correct_ids for b in _batches(pkg, n, i)),
        max_cranks=2_000_000,
    )
    return net, None


def dhb_encryption_schedule(pkg):
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    hb = _mod(pkg, "protocols.honey_badger")
    net = _dhb_net(pkg, 4, 6)
    _vote_all(net, dhb.Change.encryption_schedule(hb.EncryptionSchedule.never()),
              net.correct_ids)
    _drive_epoch(pkg, net, 0)
    _drive_epoch(pkg, net, 1)
    schedule = net.node(0).protocol.encryption_schedule
    return net, (schedule.kind, schedule.n)


def dhb_join_plan(pkg):
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    suite = _mod(pkg, "crypto.suite").ScalarSuite()
    net = _dhb_net(pkg, 4, 7)
    ni = net.node(0).netinfo
    _vote_all(net, dhb.Change.node_change(
        {i: ni.public_key(i) for i in ni.all_ids if i != 3}), net.correct_ids)
    _drive_until(pkg, net, lambda n: any(
        b.change.kind == "complete" for b in _batches(pkg, n, 0)))
    plan = [b for b in _batches(pkg, net, 0) if b.change.kind == "complete"][0].join_plan
    sk = _mod(pkg, "crypto.keys").SecretKey.random(random.Random(99), suite)
    joiner = dhb.DynamicHoneyBadger.from_join_plan(
        "joiner", sk, plan, _mod(pkg, "crypto.pool").VerifyPool(), session_id=b"dhb-test")
    return net, (_dumps(pkg, plan), _era_view(joiner))


# -- QueueingHoneyBadger (tests/test_queueing_honey_badger.py) --------------


def _qhb_net(pkg, n, seed, batch_size=8, adversary=None, sender_queue=False,
             subset_handling="incremental", session_id=b"qhb-test"):
    net_m = _mod(pkg, "net")
    qhb = _mod(pkg, "protocols.queueing_honey_badger")
    sq = _mod(pkg, "protocols.sender_queue")

    def make(ni, sink):
        return qhb.QueueingHoneyBadger(ni, sink, batch_size=batch_size, session_id=session_id,
                                       subset_handling=subset_handling)

    def factory(ni, sink, rng):
        if sender_queue:
            return sq.SenderQueue.wrap(lambda s: make(ni, s), sink, peers=list(range(n)))
        return make(ni, sink)

    b = net_m.NetBuilder(n, seed=seed).num_faulty(0).protocol(factory)
    if adversary is not None:
        b = b.adversary(getattr(net_m, adversary)())
    return b.build()


def _committed(pkg, net, nid):
    return [t for b in _batches(pkg, net, nid) for _, c in b.contributions for t in c]


def _push_all(pkg, net, per_node, prefix):
    Input = _mod(pkg, "protocols.queueing_honey_badger").Input
    txns = [f"{prefix}-{nid}-{k}" for nid in net.correct_ids for k in range(per_node)]
    for nid in net.correct_ids:
        for k in range(per_node):
            net.send_input(nid, Input.user(f"{prefix}-{nid}-{k}"))
    net.crank_until(
        lambda n: all(set(txns) <= set(_committed(pkg, n, i)) for i in n.correct_ids),
        max_cranks=2_000_000,
    )


def qhb_all_transactions_commit(pkg):
    net = _qhb_net(pkg, 4, 11, adversary="ReorderingAdversary")
    _push_all(pkg, net, 6, "txn")
    return net, None


def qhb_change_via_input(pkg):
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    Input = _mod(pkg, "protocols.queueing_honey_badger").Input
    net = _qhb_net(pkg, 4, 12)
    ni = net.node(0).protocol.netinfo
    new_map = {i: ni.public_key(i) for i in ni.all_ids if i != 3}
    for nid in net.correct_ids:
        net.send_input(nid, Input.change(dhb.Change.node_change(new_map)))
        net.send_input(nid, Input.user(f"seed-{nid}"))
    net.crank_until(_complete_everywhere(pkg, net.correct_ids), max_cranks=2_000_000)
    return net, None


def qhb_sender_queue_progress(pkg):
    net = _qhb_net(pkg, 4, 13, sender_queue=True)
    _push_all(pkg, net, 3, "sq")
    return net, None


def qhb_sender_queue_gating(pkg):
    """One SenderQueue-wrapped epoch, then the send/hold/drop verdicts
    of node 0's queue for peer and message epochs around its window."""
    net = _qhb_net(pkg, 4, 14, sender_queue=True)
    _push_all(pkg, net, 1, "gate")
    sq = net.node(0).protocol
    points = [(era, epoch) for era in (0, 1, 2) for epoch in (0, 1, 3, 4, 5, 99)]
    return net, [sq._admits(peer, msg) for peer in points for msg in points]


def qhb_subset_all_at_end(pkg):
    net = _qhb_net(pkg, 4, 31, subset_handling="all_at_end", session_id=b"qhb")
    _push_all(pkg, net, 1, "txn")
    return net, None


def hb_subset_all_at_end(pkg):
    net_m = _mod(pkg, "net")
    hb = _mod(pkg, "protocols.honey_badger")
    net = (net_m.NetBuilder(4, seed=29).num_faulty(0)
           .protocol(lambda ni, sink, rng: hb.HoneyBadger(ni, sink, subset_handling="all_at_end"))
           .build())
    net.broadcast_input(lambda nid: [f"tx-{nid}-{i}" for i in range(3)])
    net.crank_until(lambda n: all(len(n.node(i).outputs) >= 1 for i in n.correct_ids))
    return net, None


# -- SenderQueue churn (tests/test_sender_queue_churn.py) -------------------


def _sq_net(pkg, n, seed):
    return _qhb_net(pkg, n, seed, sender_queue=True, session_id=b"sq-churn")


def _drive_epochs(pkg, net, prefix, rounds=8, stop=None):
    SenderQueue = _mod(pkg, "protocols.sender_queue").SenderQueue
    Input = _mod(pkg, "protocols.queueing_honey_badger").Input

    def sq_ids(n):
        return [i for i in n.correct_ids if isinstance(n.node(i).protocol, SenderQueue)]

    for r in range(rounds):
        if stop is not None and stop(net):
            return
        base = min((len(_batches(pkg, net, i)) for i in sq_ids(net)), default=0)
        for nid in sorted(net.nodes):
            net.send_input(nid, Input.user(f"{prefix}-{r}-{nid}"))
        net.crank_until(
            lambda n, want=base + 1: all(len(_batches(pkg, n, i)) >= want for i in sq_ids(n)),
            max_cranks=400_000,
        )
    assert stop is None or stop(net), "condition not reached within driven epochs"


def _joiner(pkg, sk, **kwargs):
    sq = _mod(pkg, "protocols.sender_queue")
    qhb = _mod(pkg, "protocols.queueing_honey_badger")

    def factory(sink, rng):
        return sq.JoiningSenderQueue(
            4, sk, sink, peers=[0, 1, 2, 3],
            make_inner=lambda plan, s: qhb.QueueingHoneyBadger.from_join_plan(
                4, sk, plan, s, batch_size=8, session_id=b"sq-churn"),
            **kwargs)
    return factory


def _vote_in(pkg, net, new_map, ids):
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    Input = _mod(pkg, "protocols.queueing_honey_badger").Input
    for nid in ids:
        net.send_input(nid, Input.change(dhb.Change.node_change(new_map)))


def _joined_in_era(pkg, era):
    return lambda n: n.node(4).protocol.joined and any(
        b.era >= era for b in _batches(pkg, n, 4))


def sq_join_mid_era_change(pkg):
    suite = _mod(pkg, "crypto.suite").ScalarSuite()
    net = _sq_net(pkg, 4, 71)
    sk4 = _mod(pkg, "crypto.keys").SecretKey.random(random.Random(999), suite)
    net.add_node(4, _joiner(pkg, sk4))
    new_map = dict(net.node(0).netinfo.public_key_map)
    new_map[4] = sk4.public_key()
    _vote_in(pkg, net, new_map, [0, 1, 2, 3])
    _drive_epochs(pkg, net, "tx", stop=_joined_in_era(pkg, 1))
    sq0 = net.node(0).protocol
    return net, (sorted(sq0._peers), sorted(sq0._join_plan_sent))


def sq_deferred_removal(pkg):
    net = _sq_net(pkg, 4, 73)
    keep = dict(net.node(0).netinfo.public_key_map)
    keep.pop(3)
    _vote_in(pkg, net, keep, [0, 1, 2, 3])
    _drive_epochs(pkg, net, "rm", stop=_complete_everywhere(pkg, [0, 1, 2, 3]))
    net.crank_until(lambda n: all(3 not in n.node(i).protocol._peers for i in [0, 1, 2]),
                    max_cranks=200_000)
    Input = _mod(pkg, "protocols.queueing_honey_badger").Input
    for r in range(2):
        for nid in [0, 1, 2]:
            net.send_input(nid, Input.user(f"post-{r}-{nid}"))
        net.crank_until(
            lambda n, want=len(_batches(pkg, net, 0)) + 1: all(
                len(_batches(pkg, n, i)) >= want for i in [0, 1, 2]),
            max_cranks=200_000,
        )
    return net, [(sorted(net.node(i).protocol._peers), sorted(net.node(i).protocol._departing))
                 for i in [0, 1, 2]]


def sq_rejoin_fresh_join_plan(pkg):
    net = _sq_net(pkg, 5, 77)
    keep = dict(net.node(0).netinfo.public_key_map)
    removed_pk = keep.pop(4)
    _vote_in(pkg, net, keep, [0, 1, 2, 3, 4])
    _drive_epochs(pkg, net, "rm", stop=_complete_everywhere(pkg, [0, 1, 2, 3], era=0))
    net.crank_until(lambda n: all(4 not in n.node(i).protocol._peers for i in [0, 1, 2, 3]),
                    max_cranks=400_000)
    sk4 = net.node(4).netinfo.secret_key
    old_outputs = [_plain(pkg, o) for o in net.node(4).outputs]
    net.nodes.pop(4)
    net.node_order = sorted(net.nodes) + sorted(net.faulty_ids)
    net.add_node(4, _joiner(pkg, sk4))
    back = dict(keep)
    back[4] = removed_pk
    _vote_in(pkg, net, back, [0, 1, 2, 3])
    _drive_epochs(pkg, net, "re", stop=_complete_everywhere(pkg, [0, 1, 2, 3], era=1))
    _drive_epochs(pkg, net, "post", stop=_joined_in_era(pkg, 2))
    return net, old_outputs


def sq_forged_join_plan(pkg):
    suite = _mod(pkg, "crypto.suite").ScalarSuite()
    keys = _mod(pkg, "crypto.keys")
    dhb = _mod(pkg, "protocols.dynamic_honey_badger")
    hb = _mod(pkg, "protocols.honey_badger")
    sq = _mod(pkg, "protocols.sender_queue")
    NetMessage = _mod(pkg, "net.virtual_net").NetMessage
    net = _sq_net(pkg, 4, 79)
    sk4 = keys.SecretKey.random(random.Random(321), suite)
    pk4 = sk4.public_key()
    net.add_node(4, _joiner(pkg, sk4, join_quorum=2))
    forged_keys = keys.SecretKeySet.random(1, random.Random(99), suite).public_keys()
    forged = dhb.JoinPlan(1, forged_keys, tuple(sorted({i: pk4 for i in range(4)}.items())),
                          hb.EncryptionSchedule.always())
    net.inject(NetMessage(sender=2, dest=4, payload=sq.SqMessage.join_plan(forged)))
    while net.queue:
        net.crank()
    joined_early = net.node(4).protocol.joined
    new_map = dict(net.node(0).netinfo.public_key_map)
    new_map[4] = pk4
    _vote_in(pkg, net, new_map, [0, 1, 2, 3])
    _drive_epochs(pkg, net, "q", stop=_joined_in_era(pkg, 1))
    joined_pks = net.node(4).protocol.inner.dhb.netinfo.public_key_set
    return net, (joined_early, joined_pks.to_bytes() == forged_keys.to_bytes())


CASES = {
    f.__name__: f
    for f in (
        dhb_no_change, dhb_remove_validator, dhb_add_observer, dhb_encryption_schedule,
        dhb_join_plan, qhb_all_transactions_commit, qhb_change_via_input,
        qhb_sender_queue_progress, qhb_sender_queue_gating, qhb_subset_all_at_end,
        hb_subset_all_at_end, sq_join_mid_era_change, sq_deferred_removal,
        sq_rejoin_fresh_join_plan, sq_forged_join_plan,
    )
}


@pytest.mark.parametrize("case", sorted(CASES))
@low_priority
def test_run_identity(case):
    ref, port = (_summary(pkg, *CASES[case](pkg)) for pkg in PKGS)
    assert port == ref
    # The runs did something: every correct node has an output, and no
    # correct node blamed another.
    assert all(ref["outputs"].values())
    assert not any(ref["faults"].values())


@pytest.mark.parametrize("case", ["dhb_remove_validator", "qhb_change_via_input",
                                  "sq_deferred_removal"])
@low_priority
def test_era_change_moves_every_node_to_the_new_key_set(case):
    """The identity above covers it; this pins that the port's era change
    happened: every correct node reached era 1 with one new key set that
    differs from the net's initial one, node 3 no longer validates, and
    the new key set's threshold is that of three validators."""
    net, _ = CASES[case]("hbbft_tpu_torch")
    views = {nid: _era_view(net.node(nid).protocol) for nid in net.correct_ids}
    assert {v[0] for v in views.values()} == {1}
    assert len({v[3] for v in views.values()}) == 1
    assert views[0][3] != net.node(0).netinfo.public_key_set.to_bytes()
    assert views[3][1] is False and all(views[i][1] for i in (0, 1, 2))
    assert _dhb_of(net.node(0).protocol).netinfo.public_key_set.threshold == 0


def test_transaction_queue_matches_the_reference():
    """``TransactionQueue``: multiset removal (hashable and not) and the
    seeded random sample equal the reference's step by step."""
    def run(pkg):
        TQ = _mod(pkg, "protocols.transaction_queue").TransactionQueue
        q = TQ(["a", "b", "a", "c", "a"])
        seen = []
        for committed in (["a", "c", "zzz"], [], ["a", "a", "a", "b"]):
            q.remove_multiple(committed)
            seen.append(list(q._txns))
        q2 = TQ([["x"], ["y"], ["x"]])
        q2.remove_multiple([["x"]])
        seen.append(list(q2._txns))
        q3 = TQ(f"t{i}" for i in range(50))
        rng = random.Random(3)
        seen += [q3.choose(rng, k) for k in (1, 7, 49, 50, 80)]
        return seen

    assert run("hbbft_tpu_torch") == run("hbbft_tpu")


def test_sizeof_estimates_match_the_reference():
    """``utils.sizeof.estimate`` over plain values and protocol messages
    of both suites gives the reference's byte counts."""
    def run(pkg):
        est = _mod(pkg, "utils.sizeof").estimate
        sq = _mod(pkg, "protocols.sender_queue")
        out = [est(v) for v in (None, True, 2**70, 1.5, b"abc", "héllo", (1, [2, b"x"]),
                                {"k": (3,)}, frozenset({4}))]
        for suite in (_mod(pkg, "crypto.suite").ScalarSuite(),
                      _mod(pkg, "crypto.bls.suite").BLSSuite()):
            keys = _mod(pkg, "crypto.keys")
            rng = random.Random(6)
            sks = keys.SecretKeySet.random(1, rng, suite)
            ct = sks.public_keys().public_key().encrypt(b"payload", rng)
            out += [est(ct), est(sks.secret_key_share(0).sign(b"doc")),
                    est(sq.SqMessage.epoch_started((1, 2)))]
        return out

    assert run("hbbft_tpu_torch") == run("hbbft_tpu")
