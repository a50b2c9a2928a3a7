"""The port's copy of the reference's C++ (``hbbft_tpu_torch/csrc/native/``)
held to its original, and the port's module list to the reference's.

* Every file under ``csrc/native/`` equals its ``native/`` original with
  the edits its header lists and no other: the environment names'
  prefix, the work-item tags taken out of comments, and (engine.cpp
  only) the lines tagged ``[port]`` that stop the engine at a failed
  verify flush, each of them added, and the comment above ``hbe_words``
  naming the port's sanitizer override in place of the reference's.
* The copy's serde scan limits equal the port's ``utils/serde.py``
  ``MAX_DEPTH``/``_MAX_LEN``, and the wire tags the copy encodes and
  decodes are those the port's ``wire.py`` registers (the checks
  ``tools/lint/contracts.py`` makes for the reference alone).
* No file of the port, and not ``chip_smoke.py``, names an environment
  knob with the reference's prefix.
* The port has a counterpart of every reference module except the JAX
  ones.

Every comparison is exact.
"""

import difflib
import os
import re

import pytest

from tools.lint import contracts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(REPO, "hbbft_tpu_torch", "csrc", "native")
ORIG = os.path.join(REPO, "native")
SOURCES = ["engine.cpp", "field_ifma.cpp", "field_plane.h", "sha3_plane.h",
           "sha3_gf.h", "hbbft_native.cpp"]
HEADER_END = "// ---- end of the port's header ----\n"
OLD_PREFIX = "HBBFT_" + "TPU_"


# Edit 4 of engine.cpp's header: the comment above hbe_words names the
# port's sanitizer override in place of the reference's library variable.
WORDS_COMMENT = (
    "// This build's NodeSet width (for HBBFT_TORCH_ENGINE_LIB overrides: the\n"
    "// loader verifies a pre-built library is wide enough for the requested\n"
    "// network instead of letting hbe_create fail opaquely).\n",
    "// This build's NodeSet width (for the sanitized builds that\n"
    "// native_engine.use_engine_build selects: the loader verifies the library\n"
    "// has the width the network needs instead of letting hbe_create fail\n"
    "// opaquely).\n",
)


def _port_edits(text: str, name: str) -> str:
    """The listed edits of copy ``name`` but its added ``[port]`` lines,
    applied to its original."""
    text = text.replace(OLD_PREFIX, "HBBFT_TORCH_")
    text = re.sub(r" ?\(ISSUE \d+\)", "", text)
    text = re.sub(r"\(ISSUE \d+(?: satellite)?[;:] ", "(", text)
    text = re.sub(r" — ISSUE \d+", "", text)
    text = text.replace("//: ", "// ")
    if name == "engine.cpp":
        assert text.count(WORDS_COMMENT[0]) == 1
        text = text.replace(*WORDS_COMMENT)
    return text


def _split(name):
    with open(os.path.join(COPY, name), encoding="utf-8") as f:
        text = f.read()
    assert text.count(HEADER_END) == 1, name
    header, body = text.split(HEADER_END)
    return header, body


def test_copy_holds_exactly_the_reference_sources():
    assert sorted(os.listdir(COPY)) == sorted(SOURCES)
    for name in SOURCES:
        assert os.path.isfile(os.path.join(ORIG, name)), name


@pytest.mark.parametrize("name", SOURCES)
def test_copy_equals_original_but_for_its_listed_edits(name):
    header, body = _split(name)
    assert header.startswith(f"// Copy of native/{name} for the PyTorch port")
    assert "  1. Every name that began HBBFT_TPU and an underscore" in header
    assert "  2. The reference's numbered work-item tags" in header
    with open(os.path.join(ORIG, name), encoding="utf-8") as f:
        want = _port_edits(f.read(), name).splitlines(keepends=True)
    got = body.splitlines(keepends=True)
    added = []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, want, got,
                                                      autojunk=False).get_opcodes():
        if op == "equal":
            continue
        assert op == "insert", (name, op, want[i1:i2], got[j1:j2])
        added += got[j1:j2]
    if name == "engine.cpp":
        assert "  3. A device flush that fails stops the run" in header
        assert "  4. The comment above hbe_words names the port's sanitizer override" in header
        assert added and all("[port]" in line for line in added), added
        assert any("void hbe_abort(void* h)" in line for line in added)
    else:
        assert added == [], (name, added)


def test_copy_serde_scan_limits_equal_the_port_serde():
    _, body = _split("engine.cpp")
    code = contracts._cxx_strip_comments(body)
    limits = contracts.engine_scan_limits(code)
    with open(os.path.join(REPO, "hbbft_tpu_torch", "utils", "serde.py"), encoding="utf-8") as f:
        (depth, _), (length, _) = contracts.python_serde_limits(f.read())
    from hbbft_tpu_torch.utils import serde

    assert (depth, length) == (serde.MAX_DEPTH, serde._MAX_LEN) == (64, 1 << 28)
    assert limits and all((d, n) == (depth, length) for d, n, _ in limits), limits


def test_copy_wire_tags_equal_the_port_wire_registry():
    _, body = _split("engine.cpp")
    enc, dec = contracts.engine_wire_tags(contracts._cxx_strip_comments(body))
    with open(os.path.join(REPO, "hbbft_tpu_torch", "wire.py"), encoding="utf-8") as f:
        py_tags = contracts.python_wire_registry(f.read())
    assert enc and set(enc) <= set(py_tags) and set(enc) <= set(dec)
    assert set(dec) <= set(py_tags)


def test_no_reference_knob_prefix_in_the_port():
    offenders = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, "hbbft_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "build")]
        paths += [os.path.join(dirpath, fn) for fn in filenames]
    for path in paths:
        with open(path, "rb") as f:
            if OLD_PREFIX.encode() in f.read():
                offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
    assert len(paths) > 100


def _modules(pkg):
    root = os.path.join(REPO, pkg)
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "build")]
        for fn in filenames:
            if fn.endswith(".py"):
                out.add(os.path.relpath(os.path.join(dirpath, fn), root))
    return out


def test_port_has_every_reference_module_but_the_jax_ones():
    missing = _modules("hbbft_tpu") - _modules("hbbft_tpu_torch")
    jax_only = {m for m in missing if m.startswith(("crypto/tpu/", "ops/jaxops/"))
                or m == "utils/jaxcache.py"}
    assert missing == jax_only
    assert {"crypto/tpu/backend.py", "ops/jaxops/keccak_pallas.py",
            "utils/jaxcache.py"} <= jax_only
