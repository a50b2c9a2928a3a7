"""Run a real N=4 hbbft cluster over localhost TCP sockets.

Unlike :mod:`hbbft_tpu_torch.examples.simulation` (virtual-time, one
process, one thread), every node here is a thread pair (protocol +
socket event loop) and every protocol message crosses a real kernel
socket as a length-prefixed serde frame.  The demo commits a few epochs,
severs one node mid-run, shows the cluster committing without it,
reconnects it, and prints the per-peer transport stats + a Prometheus
metrics sample.

    python3 -m hbbft_tpu_torch.examples.cluster

``--traffic`` runs the traffic plane instead: a seeded open-loop client
fleet offers paced load through per-node mempools for a few seconds
(optionally under a WAN link shape with ``--profile wan``), then prints
submit→commit latency percentiles — the served-system view of the same
cluster.

    python3 -m hbbft_tpu_torch.examples.cluster --traffic
    python3 -m hbbft_tpu_torch.examples.cluster --traffic --profile wan

Copy of the reference's ``examples/cluster.py``: the same flags and the
same output.  The cluster runs the scalar suite, as the reference's does,
so it does no device work and needs no card.
"""

from __future__ import annotations

import argparse

from hbbft_tpu_torch.transport import FaultInjector, LocalCluster
from hbbft_tpu_torch.transport.faults import wan_profile


def main() -> None:
    n = 4
    print(f"starting {n}-node TCP cluster on localhost ...")
    with LocalCluster(n, seed=1) as cluster:
        for i, addr in sorted(cluster.addr_map.items()):
            print(f"  node {i} listening on {addr[0]}:{addr[1]}")

        cluster.drive_to(range(n), 3, tag="warm")
        print("\nall 4 nodes committed 3 epochs; batches agree:",
              all(
                  cluster.batches(i)[0].contributions
                  == cluster.batches(0)[0].contributions
                  for i in range(n)
              ))

        print("\nsevering node 3's network (process stays alive) ...")
        cluster.disconnect(3)
        target = len(cluster.batches(0)) + 2
        cluster.drive_to([0, 1, 2], target, tag="outage")
        print("  majority committed to", target, "epochs; node 3 at",
              len(cluster.batches(3)))

        print("reconnecting node 3 ...")
        cluster.reconnect(3)
        if not cluster.wait(lambda c: len(c.batches(3)) >= target, 60):
            raise RuntimeError(
                f"node 3 never caught up ({len(cluster.batches(3))}/{target})"
            )
        print("  node 3 caught up to", len(cluster.batches(3)), "epochs")

        print("\nper-peer transport stats (node 0):")
        for peer, st in sorted(cluster.nodes[0].transport.stats().items()):
            print(
                f"  ->{peer}: frames_out={st['frames_out']}"
                f" bytes_out={st['bytes_out']} frames_in={st['frames_in']}"
                f" reconnects={st['reconnects']}"
            )

        m = cluster.merged_metrics()
        print("\nPrometheus sample (first 8 lines):")
        for line in m.prometheus_text().splitlines()[:8]:
            print(" ", line)


def main_traffic(profile: str, duration_s: float) -> None:
    from hbbft_tpu_torch.traffic import ClientFleet, TrafficDriver

    n = 4
    lf = wan_profile(profile)
    injector = FaultInjector(seed=9, default=lf) if lf is not None else None
    fleet = ClientFleet(num_clients=8, rate_tps_each=5.0, seed=42)
    print(
        f"starting {n}-node TCP cluster ({profile} links), offering "
        f"{fleet.offered_tps:g} txns/s from {len(fleet.clients)} open-loop "
        f"clients for {duration_s:g}s ..."
    )
    with LocalCluster(n, seed=1, injector=injector) as cluster:
        driver = TrafficDriver(cluster, fleet)
        res = driver.run_open_loop(duration_s, drain_timeout_s=60.0)
        hist = driver.recorder.hist
        print(f"\n  arrived   {res['arrived']}")
        print(f"  admitted  {res['admitted']}")
        print(f"  committed {res['committed']}  "
              f"(outstanding {res['outstanding']})")
        epochs = min(cluster.batch_count(i) for i in cluster.nodes)
        print(f"  epochs    {epochs}  ({epochs / res['wall_s']:.2f}/s)")
        print("\nsubmit→commit latency:")
        for q in (0.5, 0.9, 0.99):
            print(f"  p{q * 100:g}  {hist.quantile(q) * 1e3:8.1f} ms")
        print(f"  max  {hist.max * 1e3:8.1f} ms")
        if injector is not None:
            print(f"\n{injector.stats.shaped} frames paid the WAN shape "
                  f"({injector.stats.dropped} dropped)")
        print("\nPrometheus latency summary:")
        for line in cluster.merged_metrics().prometheus_text().splitlines():
            if "traffic" in line or "faults" in line:
                print(" ", line)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--traffic", action="store_true",
                    help="run the open-loop traffic-plane demo")
    ap.add_argument("--profile", default="clean",
                    choices=("clean", "wan", "wan-lossy"),
                    help="link shape for --traffic (default clean)")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="offered-load window in seconds (default 3)")
    args = ap.parse_args()
    if args.traffic:
        main_traffic(args.profile, args.duration)
    else:
        main()
