"""The port's simulation example against the reference's ``examples/simulation.py``.

Both run in this process at ``--nodes 4 --txns 8 --batch-size 4`` over the
scalar suite and the host ``BatchedBackend``, and their printed epoch
tables and traffic lines are compared: the same epochs, per-epoch and
cumulative transaction counts, virtual completion times, message count,
megabytes on the wire and verify requests.  The virtual clock adds each
handler's measured CPU time, so event order could follow this machine's
load; ``--cpu-factor inf`` takes CPU time off the clock (links alone set
it) and makes the comparison exact.  Without a card, ``--backend torch``
exits non-zero with a message and prints nothing, and the reference's
``--backend tpu`` is not accepted.
"""

import contextlib
import importlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import pytest

from torch_low_priority import low_priority

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--nodes", "4", "--txns", "8", "--batch-size", "4", "--cpu-factor", "inf"]


def _reference_main(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "reference_simulation", os.path.join(REPO, "examples", "simulation.py"))
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)  # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod.main


def _port_main():
    return importlib.import_module("hbbft_tpu_torch.examples.simulation").main


def _run(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["simulation"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    return out.getvalue()


def _counts(text, requests=True):
    """The epoch table and the counts of the summary (no host times); the
    verify requests counted by per-delivery flushes where ``requests``."""
    rows = re.findall(r"^\s*(\d+\.\d+)\s+([\d.]+)\s+(\d+)\s+(\d+)\s+[\d.]+$", text, re.M)
    traffic = re.search(r"committed (\d+) txns in ([\d.]+) sim-s .*?; (\d+) msgs, ([\d.]+) MB",
                        text)
    assert rows and traffic, text
    if not requests:
        return rows, traffic.groups()
    found = re.search(r"verify_requests\s+(\d+)", text)
    assert found, text
    return rows, traffic.groups(), found.group(1)


@low_priority
def test_simulation_counts_match_the_reference(monkeypatch):
    argv = ARGS + ["--suite", "scalar"]
    ref = _counts(_run(_reference_main(monkeypatch), argv, monkeypatch))
    port = _counts(_run(_port_main(), argv, monkeypatch))
    assert port == ref
    rows, traffic, _ = port
    assert int(rows[-1][3]) == 8 and traffic[0] == "8"


def test_simulation_torch_backend_refuses_without_a_card():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "hbbft_tpu_torch.examples.simulation",
            "--nodes", "4", "--txns", "4", "--batch-size", "4", "--suite", "bls"]
    res = subprocess.run(base + ["--backend", "torch"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr
    res = subprocess.run(base + ["--backend", "tpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 2 and res.stdout == ""
    assert "invalid choice: 'tpu'" in res.stderr
    # --device cpu reaches TorchBackend too, which refuses a non-BLS suite
    # rather than handing the run to the host backend.
    res = subprocess.run(base[:-1] + ["scalar", "--backend", "torch", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "TypeError" in res.stderr


@pytest.mark.slow  # ~4 min: the plain scan and pair stages take seconds a flush on the CPU
@low_priority
def test_simulation_on_torch_backend_plain_stages_matches_the_reference(monkeypatch):
    """``--suite bls --backend torch --device cpu`` (``TorchBackend``'s
    plain stages) commits what the reference commits with its host
    ``BatchedBackend``: the same epochs, counts, messages and bytes."""
    argv = ["--nodes", "4", "--txns", "4", "--batch-size", "4", "--cpu-factor", "inf",
            "--flush-every", "100000", "--suite", "bls"]
    ref = _counts(_run(_reference_main(monkeypatch), argv + ["--backend", "batched"],
                       monkeypatch), requests=False)
    port = _counts(_run(_port_main(), argv + ["--backend", "torch", "--device", "cpu"],
                        monkeypatch), requests=False)
    assert port == ref
