"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` at
first use, then loaded with :mod:`ctypes`.  The hash covers the source,
every header of ``csrc/`` it includes (``#include "..."``, followed
through the headers) and the flags, so an edited source or header builds
anew and an unchanged one is reused.  Nothing here runs at import time.

Every wrapper that launches a kernel adds one to :data:`LAUNCHES` under
the kernel's name, and nowhere else, so a run can show which kernels its
path went through.

The host C++ of ``csrc/native/`` (the protocol engine and the host data
plane) is built here too, with ``g++`` (:func:`build_host`): one engine
library per NodeSet width (``-DHBE_WORDS=w``), ``field_ifma.cpp`` alone
compiled with ``-mavx512ifma`` where the compiler takes it, each output
named by the hash of its sources and flags, at first use.  The sanitizer
tier builds the engine under ASan, UBSan or TSan (``sanitizer=`` of
:func:`build_host`) with the reference's ``native/Makefile`` flags;
``native_engine.use_engine_build`` loads such a build.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# kernel name -> launches since the last reset (plain integers).
LAUNCHES: Counter = Counter()

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location.  Raises if there is none."""
    found = shutil.which("nvcc") or shutil.which("nvcc", path="/usr/local/cuda/bin")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header it includes, directly
    or through another header, in a fixed order."""
    return _with_includes(CSRC / f"{name}.cu")


def _with_includes(main: Path) -> List[Path]:
    """``main`` and every header of its folder it includes, directly or
    through another header: ``main`` first, then the headers sorted."""
    seen: List[Path] = []
    todo = [main]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep.exists():
                todo.append(dep)
    return [seen[0]] + sorted(seen[1:])


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path, extra: List[str]) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(out), str(CSRC / f"{name}.cu")]


@contextlib.contextmanager
def _build_lock(name: str = ".lock"):
    """An exclusive lock on the build directory, held across processes
    (a crypto-service worker and its parent may both load the kernels):
    one process builds, the other then finds the libraries built.  The
    host C++ builds take a lock file of their own, so a host build and
    the ``nvcc`` builds can run side by side."""
    with open(BUILD_DIR / name, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build_all(names: Iterable[str], verbose: bool = False) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together; returns name -> shared library path.
    ``verbose`` adds ``-Xptxas -v`` (a report only; the code is the
    same) and prints the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    if all(p.exists() for p in paths.values()):
        return paths
    with _build_lock():
        _compile(paths, ["-Xptxas", "-v"] if verbose else [], verbose)
    return paths


def _compile(paths: Dict[str, Path], extra: List[str], verbose: bool) -> None:
    """``build_all``'s compile step, under the build lock."""
    procs = {}
    for n, p in paths.items():
        if p.exists():
            continue
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (
            subprocess.Popen(
                _nvcc_cmd(n, tmp, extra),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {n}]\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


# -- host C++ (csrc/native/) -----------------------------------------------

NATIVE = CSRC / "native"
GXX_FLAGS = ["-O3", "-fPIC", "-std=c++17"]
IFMA_FLAGS = ("-mavx512ifma",)
# The sanitizer builds' flags (native/Makefile SAN_FLAGS): -O1 keeps
# stacks honest, frame pointers keep reports readable.  field_ifma.cpp is
# compiled under the same sanitizer as the engine it is linked into.
SAN_FLAGS = ["-O1", "-g", "-fno-omit-frame-pointer", "-fPIC", "-std=c++17"]
SANITIZERS = {
    "address": ["-fsanitize=address"],
    "undefined": ["-fsanitize=undefined", "-fno-sanitize-recover=all"],
    "thread": ["-fsanitize=thread"],
}
# Each sanitizer's runtime, which an uninstrumented python must
# LD_PRELOAD before it loads such an engine (UBSan's loads as a
# dependency too; the tier preloads it all the same).
SANITIZER_RUNTIMES = {"address": "libasan.so", "undefined": "libubsan.so",
                      "thread": "libtsan.so"}


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host C++ of csrc/native/ needs a C++ compiler")
    return found


@functools.lru_cache(maxsize=None)
def _gxx_takes(flags: tuple) -> bool:
    """Whether g++ accepts ``flags`` on an empty input (the feature gate
    of the AVX-512 IFMA arm; without it ``field_ifma.cpp`` compiles its
    scalar stub)."""
    try:
        subprocess.run([gxx_path(), *flags, "-x", "c++", "-c", os.devnull, "-o", os.devnull],
                       check=True, capture_output=True, timeout=60)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def _host_steps(name: str, words: int, sanitizer: Optional[str] = None) -> List[List[str]]:
    """The compile steps of library ``name`` (``"engine"`` or
    ``"native"``), each a g++ argument list without its output path;
    the last links the shared library.  ``sanitizer`` (a key of
    :data:`SANITIZERS`, engine only) builds it instrumented."""
    if sanitizer is not None and name != "engine":
        raise ValueError(f"only the engine has sanitized builds, not {name!r}")
    if name == "native":
        return [[*GXX_FLAGS, "-shared", "-pthread", str(NATIVE / "hbbft_native.cpp")]]
    if name != "engine":
        raise ValueError(f"no host library {name!r}")
    if sanitizer is None:
        flags = GXX_FLAGS
    elif sanitizer in SANITIZERS:
        flags = [*SAN_FLAGS, *SANITIZERS[sanitizer]]
    else:
        raise ValueError(f"no sanitizer {sanitizer!r}; one of {sorted(SANITIZERS)}")
    ifma = list(IFMA_FLAGS) if _gxx_takes(IFMA_FLAGS) else []
    return [
        [*flags, "-c", *ifma, str(NATIVE / "field_ifma.cpp")],
        [*flags, "-shared", "-pthread", f"-DHBE_WORDS={words}", str(NATIVE / "engine.cpp")],
    ]


def host_library_path(name: str, words: int = 4, sanitizer: Optional[str] = None) -> Path:
    """Where :func:`build_host` puts library ``name``: the hash covers
    every source and header it compiles and every flag."""
    steps = _host_steps(name, words, sanitizer)
    h = hashlib.sha256(repr(steps).encode())
    mains = ["hbbft_native.cpp"] if name == "native" else ["field_ifma.cpp", "engine.cpp"]
    for main in mains:
        for path in _with_includes(NATIVE / main):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    tag = f"engine_w{words}" if name == "engine" else "native"
    if sanitizer is not None:
        tag += f"_{sanitizer}"
    return BUILD_DIR / f"libhbbft_{tag}-{h.hexdigest()[:16]}.so"


def sanitizer_runtime(sanitizer: str) -> str:
    """The full path of ``sanitizer``'s runtime as g++ links it (what
    ``LD_PRELOAD`` names).  Raises if g++ has none."""
    name = SANITIZER_RUNTIMES[sanitizer]
    out = subprocess.run([gxx_path(), f"-print-file-name={name}"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    if not os.path.isabs(out) or not os.path.exists(out):
        raise RuntimeError(f"g++ has no {name}: the {sanitizer} sanitizer's runtime is not installed")
    return out


def build_host(name: str, words: int = 4, timeout: float = 600.0,
               sanitizer: Optional[str] = None) -> Path:
    """Build host library ``name`` from ``csrc/native/`` unless it is
    built already, and return its path; ``sanitizer`` as in
    :func:`_host_steps`.  Raises ``RuntimeError`` with the compiler's
    output when a step fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = host_library_path(name, words, sanitizer)
    if so.exists():
        return so
    with _build_lock(".host.lock"):
        if so.exists():
            return so
        steps = _host_steps(name, words, sanitizer)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        objs: List[str] = []
        for i, step in enumerate(steps):
            last = i == len(steps) - 1
            out = tmp if last else so.with_suffix(f".{i}.{os.getpid()}.o")
            cmd = [gxx_path(), *step, *(objs if last else []), "-o", str(out)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"host build of {name} failed: g++ exited {proc.returncode}\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            if not last:
                objs.append(str(out))
        for obj in objs:
            os.unlink(obj)
        os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
