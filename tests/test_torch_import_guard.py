"""The port stands alone: importing ``hbbft_tpu_torch`` loads neither
``jax`` nor any module of the JAX package, no port source imports the JAX
package, and without a card every entry point refuses to run unless the
caller asks for the CPU.  Checks run in a fresh interpreter so this test
process's own imports do not leak in.  Every check is exact."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hbbft_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "build")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _run(code: str) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter with no card, at nice 10 (as
    ``torch_low_priority`` runs CPU-bound port tests) where ``nice``
    exists, so timing-sensitive tests beside it keep their cores."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    nice = shutil.which("nice")
    prefix = [nice, "-n", "10"] if nice else []
    return subprocess.run(
        prefix + [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_import_loads_no_jax_and_no_reference_module():
    mods = _port_modules()
    assert "hbbft_tpu_torch.crypto.device.backend" in mods
    assert "hbbft_tpu_torch.crypto.device.pair" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'hbbft_tpu' or m.startswith('hbbft_tpu.'))\n"
        "print('LOADED', bad)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


def test_no_source_imports_the_reference_package():
    offenders = []
    for dirpath, _dirnames, filenames in os.walk(PKG):
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            tree = ast.parse(open(path, encoding="utf-8").read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for name in names:
                    root = name.split(".")[0]
                    if root in ("hbbft_tpu", "jax", "jaxlib"):
                        offenders.append((path, node.lineno, name))
    assert offenders == []


def test_no_source_loads_the_host_build_of_the_kernels():
    """``csrc/host_check.cc`` and ``csrc/keccak_check.cc`` (the kernels'
    headers built for the host) are for the tests only, and
    ``csrc/keccak_probe.cu`` for ``benchmarks_torch/keccak_rate.py``: no
    module of the port names them."""
    names = ("host_check", "keccak_check", "keccak_probe")
    offenders = []
    for dirpath, _dirnames, filenames in os.walk(PKG):
        for fn in filenames:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                src = open(path, encoding="utf-8").read()
                offenders += [(path, name) for name in names if name in src]
    assert offenders == []
    assert os.path.exists(os.path.join(PKG, "csrc", "host_check.cc"))
    assert os.path.exists(os.path.join(PKG, "csrc", "keccak_check.cc"))


def test_entry_points_refuse_without_a_card():
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from hbbft_tpu_torch.crypto.device.backend import TorchBackend\n"
        "from hbbft_tpu_torch.ops.device.dataplane import encode_and_prove\n"
        "from hbbft_tpu_torch.ops.device.keccak import sha3_256_batch\n"
        "from hbbft_tpu_torch.ops.device.gf256 import ReedSolomonTorch\n"
        "import numpy as np\n"
        "calls = [lambda: TorchBackend(), lambda: encode_and_prove([b'x'], 1, 3),\n"
        "         lambda: sha3_256_batch(np.zeros((1, 3), np.uint8)),\n"
        "         lambda: ReedSolomonTorch(2, 3)]\n"
        "n = 0\n"
        "for c in calls:\n"
        "    try:\n"
        "        c()\n"
        "    except RuntimeError:\n"
        "        n += 1\n"
        "TorchBackend(device='cpu')\n"
        "encode_and_prove([b'x'], 1, 3, device='cpu')\n"
        "print('REFUSED', n)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "REFUSED 4" in res.stdout, res.stdout


def test_consensus_plane_modules_are_checked_above():
    """The consensus plane's modules are among those the fresh interpreter
    above imports, so none of them loads ``jax`` or the JAX package."""
    mods = set(_port_modules())
    want = {
        "hbbft_tpu_torch.utils", "hbbft_tpu_torch.utils.serde",
        "hbbft_tpu_torch.utils.metrics", "hbbft_tpu_torch.obs",
        "hbbft_tpu_torch.obs.trace", "hbbft_tpu_torch.crypto.pool",
        "hbbft_tpu_torch.wire", "hbbft_tpu_torch.net",
        "hbbft_tpu_torch.net.adversary", "hbbft_tpu_torch.net.virtual_net",
        "hbbft_tpu_torch.protocols", "hbbft_tpu_torch.utils.sizeof",
        "hbbft_tpu_torch.examples", "hbbft_tpu_torch.examples.simulation",
    } | {
        f"hbbft_tpu_torch.protocols.{m}"
        for m in ("errors", "fault_log", "traits", "network_info", "bool_set",
                  "threshold_sign", "threshold_decrypt", "broadcast", "sbv_broadcast",
                  "binary_agreement", "subset", "honey_badger", "transaction_queue",
                  "sync_key_gen", "dynamic_honey_badger", "queueing_honey_badger",
                  "sender_queue")
    }
    assert want <= mods, sorted(want - mods)


def test_consensus_entry_points_refuse_without_a_card():
    """``batch_propose`` without ``device=`` and a ``NetBuilder`` built on
    ``TorchBackend`` with no device raise with no card; ``TorchBackend``
    refuses a suite that is not BLS."""
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from hbbft_tpu_torch.crypto.bls.suite import BLSSuite\n"
        "from hbbft_tpu_torch.crypto.suite import ScalarSuite\n"
        "from hbbft_tpu_torch.crypto.device.backend import TorchBackend\n"
        "from hbbft_tpu_torch.net import NetBuilder\n"
        "from hbbft_tpu_torch.protocols.broadcast import Broadcast, batch_propose\n"
        "from hbbft_tpu_torch.protocols.threshold_sign import ThresholdSign\n"
        "def builder():\n"
        "    return NetBuilder(1, seed=1).suite(BLSSuite()).protocol(\n"
        "        lambda ni, sink, rng: ThresholdSign(ni, b'doc', sink))\n"
        "bcs = [NetBuilder(4).protocol(lambda ni, sink, rng: Broadcast(ni, 0)).build()\n"
        "       .node(0).protocol for _ in range(2)]\n"
        "calls = [lambda: batch_propose(bcs, [b'x', b'y']),\n"
        "         lambda: builder().backend(lambda s: TorchBackend(s)).build()]\n"
        "n = 0\n"
        "for c in calls:\n"
        "    try:\n"
        "        c()\n"
        "    except RuntimeError:\n"
        "        n += 1\n"
        "try:\n"
        "    TorchBackend(ScalarSuite(), device='cpu')\n"
        "except TypeError:\n"
        "    n += 1\n"
        "builder().backend(lambda s: TorchBackend(s, device='cpu')).build()\n"
        "batch_propose(bcs, [b'x', b'y'], device='cpu')\n"
        "print('REFUSED', n)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "REFUSED 3" in res.stdout, res.stdout


def test_crypto_plane_modules_are_checked_above():
    """The crypto plane's modules are among those the fresh interpreter
    above imports, so none of them loads ``jax`` or the JAX package."""
    mods = set(_port_modules())
    want = {
        "hbbft_tpu_torch.traffic", "hbbft_tpu_torch.traffic.latency",
        "hbbft_tpu_torch.cryptoplane", "hbbft_tpu_torch.cryptoplane.service",
        "hbbft_tpu_torch.cryptoplane.proc_service", "hbbft_tpu_torch.transport",
        "hbbft_tpu_torch.transport.framing", "hbbft_tpu_torch.transport.transport",
        "hbbft_tpu_torch.transport.cluster", "hbbft_tpu_torch.obs.export",
        "hbbft_tpu_torch.obs.analyze",
    }
    assert want <= mods, sorted(want - mods)


def test_traffic_and_chaos_modules_are_checked_above():
    """The traffic plane's, the fault injector's, the scrape server's and
    the chaos plane's modules, and the cluster example, are among those
    the fresh interpreter above imports, so none of them loads ``jax`` or
    the JAX package."""
    mods = set(_port_modules())
    want = {
        "hbbft_tpu_torch.transport.faults", "hbbft_tpu_torch.traffic.clients",
        "hbbft_tpu_torch.traffic.mempool", "hbbft_tpu_torch.traffic.driver",
        "hbbft_tpu_torch.obs.server", "hbbft_tpu_torch.chaos",
        "hbbft_tpu_torch.chaos.strategies", "hbbft_tpu_torch.chaos.nodes",
        "hbbft_tpu_torch.chaos.oracle", "hbbft_tpu_torch.chaos.scheduler",
        "hbbft_tpu_torch.examples.cluster",
    }
    assert want <= mods, sorted(want - mods)


def test_crypto_plane_entry_points_refuse_without_a_card():
    """``HybridBackend()`` and a sharded ``TorchBackend`` raise with no
    card; a service worker asked for the torch backend on ``cuda``, or a
    BLS worker asked for no backend, exits nonzero before it reports
    ready."""
    code = (
        "import subprocess, sys, torch\n"
        "assert not torch.cuda.is_available()\n"
        "from hbbft_tpu_torch.crypto.device.backend import HybridBackend, TorchBackend\n"
        "n = 0\n"
        "for c in (lambda: HybridBackend(), lambda: TorchBackend(devices=['cuda', 'cuda'])):\n"
        "    try:\n"
        "        c()\n"
        "    except RuntimeError:\n"
        "        n += 1\n"
        "p = subprocess.run([sys.executable, '-m', 'hbbft_tpu_torch.cryptoplane.proc_service',\n"
        "                    '--suite', 'bls', '--backend', 'torch', '--device', 'cuda'],\n"
        "                   stdin=subprocess.DEVNULL, capture_output=True, text=True)\n"
        "n += p.returncode != 0 and '\"ready\"' not in p.stdout\n"
        "p = subprocess.run([sys.executable, '-m', 'hbbft_tpu_torch.cryptoplane.proc_service',\n"
        "                    '--suite', 'bls'], stdin=subprocess.DEVNULL, capture_output=True,\n"
        "                   text=True)\n"
        "n += p.returncode != 0 and '\"ready\"' not in p.stdout\n"
        "HybridBackend(device=HybridBackend.NO_DEVICE)\n"
        "TorchBackend(devices=['cpu', 'cpu'])\n"
        "print('REFUSED', n)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "REFUSED 4" in res.stdout, res.stdout


@pytest.mark.parametrize("mod", [
    "hbbft_tpu_torch.cryptoplane.proc_service", "hbbft_tpu_torch.transport.cluster",
    "hbbft_tpu_torch.transport",
])
def test_crypto_plane_module_imports_first(mod):
    """Each entry module of the crypto plane is importable as the first
    import of a fresh interpreter (no circular import)."""
    res = _run(f"import {mod}\nprint('OK')\n")
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout, res.stdout


@pytest.mark.parametrize("mod", [
    "hbbft_tpu_torch.transport.faults", "hbbft_tpu_torch.traffic",
    "hbbft_tpu_torch.traffic.driver", "hbbft_tpu_torch.obs.server",
    "hbbft_tpu_torch.chaos", "hbbft_tpu_torch.chaos.nodes",
    "hbbft_tpu_torch.chaos.scheduler", "hbbft_tpu_torch.examples.cluster",
])
def test_traffic_and_chaos_module_imports_first(mod):
    """Each module of the traffic and chaos planes is importable as the
    first import of a fresh interpreter (no circular import)."""
    res = _run(f"import {mod}\nprint('OK')\n")
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout, res.stdout


@pytest.mark.parametrize("mod", [
    "hbbft_tpu_torch.protocols.sender_queue", "hbbft_tpu_torch.protocols.sync_key_gen",
    "hbbft_tpu_torch.protocols.dynamic_honey_badger",
    "hbbft_tpu_torch.protocols.queueing_honey_badger", "hbbft_tpu_torch.wire",
    "hbbft_tpu_torch.examples.simulation",
])
def test_dynamic_stack_module_imports_first(mod):
    """Each module of the dynamic stack is importable as the first import
    of a fresh interpreter (no circular import), and its serde registry
    then holds every tag."""
    res = _run(f"import {mod}\n"
               "from hbbft_tpu_torch.utils import serde\n"
               "serde.dumps(None)\n"
               "print('TAGS', len(serde._STRUCTS))\n")
    assert res.returncode == 0, res.stderr
    assert "TAGS 35" in res.stdout, res.stdout


def test_native_engine_and_process_runtime_modules_are_checked_above():
    """The native engine's modules, its cluster node and the
    process-per-node runtime are among those the fresh interpreter above
    imports, so none of them loads ``jax`` or the JAX package."""
    mods = set(_port_modules())
    want = {
        "hbbft_tpu_torch.native_engine", "hbbft_tpu_torch.ops.native",
        "hbbft_tpu_torch.transport.native_node",
        "hbbft_tpu_torch.transport.cluster_worker",
        "hbbft_tpu_torch.transport.proc_cluster",
    }
    assert want <= mods, sorted(want - mods)


@pytest.mark.parametrize("mod", [
    "hbbft_tpu_torch.native_engine", "hbbft_tpu_torch.ops.native",
    "hbbft_tpu_torch.transport.native_node", "hbbft_tpu_torch.transport.cluster_worker",
    "hbbft_tpu_torch.transport.proc_cluster",
])
def test_native_module_imports_first(mod):
    """Each module of the native engine and the process runtime is
    importable as the first import of a fresh interpreter (no circular
    import), and importing it builds nothing."""
    res = _run(f"import {mod}\n"
               "from hbbft_tpu_torch import native_engine\n"
               "from hbbft_tpu_torch.ops import native\n"
               "print('OK', native_engine._LIBS, native._LOADED)\n")
    assert res.returncode == 0, res.stderr
    assert "OK {} False" in res.stdout, res.stdout


def test_native_engine_over_bls_refuses_without_a_card():
    """``NativeQhbNet`` over BLS with no backend named verifies on the
    card (``TorchBackend``), which raises with no card; a host backend
    named by the caller runs."""
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "from hbbft_tpu_torch.crypto.backend import BatchedBackend\n"
        "from hbbft_tpu_torch.crypto.bls.suite import BLSSuite\n"
        "from hbbft_tpu_torch.native_engine import NativeQhbNet\n"
        "n = 0\n"
        "try:\n"
        "    NativeQhbNet(4, seed=1, suite=BLSSuite())\n"
        "except RuntimeError:\n"
        "    n += 1\n"
        "suite = BLSSuite()\n"
        "NativeQhbNet(4, seed=1, suite=suite, backend=BatchedBackend(suite)).close()\n"
        "print('REFUSED', n)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "REFUSED 1" in res.stdout, res.stdout


HOST_ONLY = [
    "hbbft_tpu_torch.native_engine", "hbbft_tpu_torch.transport.cluster_worker",
    "hbbft_tpu_torch.transport.native_node", "hbbft_tpu_torch.transport.cluster",
    "hbbft_tpu_torch.chaos.strategies", "hbbft_tpu_torch.obs.analyze",
    "hbbft_tpu_torch.obs.server", "hbbft_tpu_torch.tools.analyze",
]


def test_host_only_modules_load_no_torch():
    """The modules a process-per-node worker, a sanitized interpreter or
    the trace-analysis CLI import load no ``torch`` (``protocols.broadcast``
    imports the device module only inside ``batch_propose``), and
    ``batch_propose`` still refuses to run with no card unless it is
    given ``device="cpu"``."""
    code = (
        "import importlib, sys\n"
        f"for m in {HOST_ONLY!r}:\n"
        "    importlib.import_module(m)\n"
        "    if 'torch' in sys.modules:\n"
        "        print('TORCH BY', m)\n"
        "        break\n"
        "else:\n"
        "    print('NO TORCH')\n"
        "from hbbft_tpu_torch.net import NetBuilder\n"
        "from hbbft_tpu_torch.protocols.broadcast import Broadcast, batch_propose\n"
        "bcs = [NetBuilder(4).protocol(lambda ni, sink, rng: Broadcast(ni, 0)).build()\n"
        "       .node(0).protocol for _ in range(2)]\n"
        "assert 'torch' not in sys.modules\n"
        "try:\n"
        "    batch_propose(bcs, [b'x', b'y'])\n"
        "except RuntimeError:\n"
        "    print('REFUSED')\n"
        "steps = batch_propose(bcs, [b'x', b'y'], device='cpu')\n"
        "print('CPU', len(steps))\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["NO", "TORCH", "REFUSED", "CPU", "2"], res.stdout
