"""``python -m hbbft_tpu_torch.examples.cluster`` in both of its modes,
against the reference's ``examples/cluster.py`` with the same flags.

Both print the same lines once every number (ports, counts, latencies) is
masked and runs of blanks are one: the demo's outage and catch-up story,
and the traffic report (arrived, admitted, committed, epochs, latency
percentiles).  In both, every admitted transaction commits
(``outstanding 0``).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cmd):
    """``cmd`` from the repo root at nice 10 (as ``torch_low_priority``
    runs CPU-bound port tests), on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    nice = shutil.which("nice")
    prefix = [nice, "-n", "10"] if nice else []
    res = subprocess.run(prefix + [sys.executable] + cmd, cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def _masked(text, upto=None):
    lines = text.splitlines()
    if upto is not None:
        lines = lines[: next(i for i, ln in enumerate(lines) if ln.startswith(upto))]
    return [" ".join(re.sub(r"[0-9]+(\.[0-9]+)?", "#", ln).split()) for ln in lines]


@pytest.mark.parametrize("flags", [[], ["--traffic", "--duration", "1.5"]])
def test_cluster_example_matches_reference(flags):
    port = _run(["-m", "hbbft_tpu_torch.examples.cluster"] + flags)
    ref = _run([os.path.join("examples", "cluster.py")] + flags)
    if flags:
        assert "(outstanding 0)" in port and "(outstanding 0)" in ref
        got = re.search(r"admitted +([0-9]+)\n +committed ([0-9]+)", port)
        assert got and got.group(1) == got.group(2) != "0"
        assert _masked(port, "Prometheus") == _masked(ref, "Prometheus")
        assert 'hbbft_summary{name="traffic.latency_s",quantile="0.5"}' in port
    else:
        assert "batches agree: True" in port and "node 3 caught up" in port
        assert _masked(port, "per-peer") == _masked(ref, "per-peer")
