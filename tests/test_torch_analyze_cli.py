"""The port's trace-analysis CLI (``python -m hbbft_tpu_torch.tools.analyze``)
held to the reference's ``tools/analyze.py``.

* On the golden sim-net traces (``tests/fixtures/golden_trace_*.json``),
  both as committed and dumped as the Chrome-trace document the recorder
  writes, the two CLIs print the same bytes: critical paths as text and
  as ``--json``, with and without the post-mortem ``--diag``.
* The error paths the reference's tests pin (missing, truncated and
  wrong-shape files, an event-free dump, no argument) exit the same way
  with the same stderr.
* A trace path loads no ``torch``.
* ``--demo 4`` on the port's ``LocalCluster`` ends in a stalled diagnosis
  once f + 1 nodes are severed, and its critical-path records carry the
  reference's keys (a set-level check: live timings differ).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from hbbft_tpu.obs.analyze import critical_path
from hbbft_tpu.obs.export import chrome_trace as ref_chrome_trace
from hbbft_tpu.obs.trace import TraceEvent as RefTraceEvent
from hbbft_tpu_torch.obs.export import chrome_trace as port_chrome_trace
from hbbft_tpu_torch.obs.trace import TraceEvent as PortTraceEvent
from hbbft_tpu_torch.tools import analyze as port_cli
from tools import analyze as ref_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
IMPLS = ["python", "native"]
FLAGS = [[], ["--json"], ["--diag"], ["--diag", "--json"]]


def _fixture(impl: str) -> str:
    return os.path.join(FIXDIR, f"golden_trace_{impl}.json")


def _tracks(impl: str, event):
    with open(_fixture(impl)) as fh:
        doc = json.load(fh)
    return {t: [event(ts, name, args) for ts, name, args in evs]
            for t, evs in doc["tracks"].items()}


@pytest.fixture(scope="module")
def chrome_dumps(tmp_path_factory):
    """impl -> path of the golden trace as a recorder ``trace.json``,
    written by the port's exporter (the reference's writes the same)."""
    out = {}
    for impl in IMPLS:
        port_doc = port_chrome_trace(_tracks(impl, PortTraceEvent))
        assert port_doc == ref_chrome_trace(_tracks(impl, RefTraceEvent))
        path = tmp_path_factory.mktemp("dump") / f"{impl}.trace.json"
        path.write_text(json.dumps(port_doc))
        out[impl] = str(path)
    return out


def _run(capsys, main, argv):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _both(capsys, argv):
    ref = _run(capsys, ref_cli.main, argv)
    port = _run(capsys, port_cli.main, argv)
    assert port == ref
    return port


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "text")
@pytest.mark.parametrize("impl", IMPLS)
def test_cli_prints_the_reference_bytes_on_the_golden_dumps(capsys, chrome_dumps, impl, flags):
    rc, out, err = _both(capsys, [chrome_dumps[impl], *flags])
    assert rc == 0 and err == ""
    if "--json" in flags:
        doc = json.loads(out)
        want = critical_path(_tracks(impl, RefTraceEvent))
        assert doc["critical_path"] == json.loads(json.dumps(want))
        assert doc["summary"]["epochs"] == len(want) > 0
        assert ("diag" in doc) == ("--diag" in flags)
    else:
        assert out.startswith("epoch (era 0, ")
        assert ("stalled: " in out) == ("--diag" in flags)


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "text")
@pytest.mark.parametrize("impl", IMPLS)
def test_cli_prints_the_reference_bytes_on_the_committed_fixtures(capsys, impl, flags):
    # The committed fixture holds raw tracks, not a Chrome document: both
    # CLIs read it as a dump with no recorder events.
    rc, out, err = _both(capsys, [_fixture(impl), *flags])
    assert rc == 0
    assert "empty tracks" in err


def test_cli_missing_trace_file(tmp_path, capsys):
    rc, out, err = _both(capsys, [str(tmp_path / "nope.json")])
    assert rc == 2 and "cannot read" in err and "Traceback" not in err


def test_cli_truncated_trace_file(tmp_path, capsys):
    p = tmp_path / "trunc.json"
    good = json.dumps({"traceEvents": [], "otherData": {"t0_unix_s": 1.0}})
    p.write_text(good[: len(good) // 2])
    rc, out, err = _both(capsys, [str(p)])
    assert rc == 2 and "truncated" in err


def test_cli_wrong_shape_trace_file(tmp_path, capsys):
    p = tmp_path / "list.json"
    p.write_text("[1, 2, 3]")
    rc, out, err = _both(capsys, [str(p)])
    assert rc == 2 and "not a Chrome-trace document" in err


@pytest.mark.parametrize("diag", [False, True])
def test_cli_empty_tracks(tmp_path, capsys, diag):
    p = tmp_path / "empty.json"
    p.write_text(json.dumps({"traceEvents": [], "otherData": {"t0_unix_s": 0}}))
    rc, out, err = _both(capsys, [str(p), "--json", *(["--diag"] if diag else [])])
    assert rc == 0 and "empty tracks" in err
    doc = json.loads(out)
    assert doc["critical_path"] == [] and doc["summary"] == {"epochs": 0}
    if diag:
        assert doc["diag"]["stalled"] is False and doc["diag"]["open_epochs"] == {}


def test_cli_needs_an_argument(capsys):
    codes = []
    for main in (ref_cli.main, port_cli.main):
        with pytest.raises(SystemExit) as exc:
            main([])
        codes.append(exc.value.code)
    cap = capsys.readouterr()
    assert codes == [2, 2]
    assert cap.err.count("need a trace.json path, --url, or --demo N") == 2


def test_cli_on_a_trace_path_loads_no_torch(chrome_dumps):
    code = (
        "import sys\n"
        "from hbbft_tpu_torch.tools.analyze import main\n"
        f"rc = main([{chrome_dumps['python']!r}, '--diag'])\n"
        "print('TORCH', 'torch' in sys.modules, rc)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("TORCH False 0")


def test_cli_demo_stalls_after_severing_f_plus_one(capsys):
    with open(os.path.join(FIXDIR, "golden_cp_python.json")) as fh:
        ref_records = json.load(fh)
    rc, out, _ = _run(capsys, port_cli.main, ["--demo", "4", "--json"])
    assert rc == 0
    doc = json.loads(out)
    records, diag = doc["critical_path"], doc["diag"]
    assert len(records) >= 3
    assert {frozenset(r) for r in records} == {frozenset(r) for r in ref_records}
    assert {k for r in records for p in r["path"] for k in p} <= {
        k for r in ref_records for p in r["path"] for k in p}
    assert diag["stalled"] is True and diag["verdict"] is not None
