"""Safe self-describing codec for committed/wire bytes.

The reference serializes contributions with ``bincode`` — a schema-driven
codec that can only ever produce instances of the expected types
(upstream ``src/honey_badger/honey_badger.rs``).  This module is the
equivalent trust boundary here: Subset-committed payloads include bytes
*authored by a Byzantine proposer* and faithfully RBC'd, so arbitrary-
object deserialization (pickle) is out of the question.

Format: one tag byte per value, length-prefixed payloads, strict bounds
checking, and a bounded recursion depth.  Composite application types
(Ciphertext, SignedVote, DKG Parts, ...) are encoded through an explicit
registry (:mod:`hbbft_tpu_torch.wire`): each registered type packs to a tuple
of primitive values and unpacks through a validating constructor — an
attacker can choose *which* registered type to decode and its field
values, but never what code runs.

Wire grammar (all integers big-endian):

    value   := NONE | TRUE | FALSE | int | bytes | str
             | tuple | list | dict | struct | group
    int     := 0x03 sign:u8 len:u32 magnitude[len]
    bytes   := 0x04 len:u32 raw[len]
    str     := 0x05 len:u32 utf8[len]
    tuple   := 0x06 count:u32 value*count
    list    := 0x07 count:u32 value*count
    dict    := 0x08 count:u32 (value value)*count
    struct  := 0x10 nlen:u8 name[nlen] fields:tuple
    group   := 0x11 nlen:u8 suite[nlen] g:u8 len:u32 raw[len]

Copy of ``hbbft_tpu/utils/serde.py``.  Its native token scan runs only
with an engine library this process has already loaded
(:mod:`hbbft_tpu_torch.native_engine`); the pure decoder gives the same
objects and raises the same :class:`DecodeError` exceptions.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Tuple, Type

# mirror: serde-scan-limits — these two constants are passed verbatim
#     to the native token scan (`_native_scan` below) and duplicated as
#     literals at engine.cpp's own hbe_serde_scan call site; HBX001
#     checks the values match, HBX003 keeps the anchors paired.
MAX_DEPTH = 64
_MAX_LEN = 1 << 28  # 256 MiB hard cap on any single length field


class EncodeError(TypeError):
    """Object (or one of its fields) is not encodable."""


class DecodeError(ValueError):
    """Malformed, truncated, oversized, or type-invalid input bytes."""


_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03
_T_BYTES = 0x04
_T_STR = 0x05
_T_TUPLE = 0x06
_T_LIST = 0x07
_T_DICT = 0x08
_T_STRUCT = 0x10
_T_GROUP = 0x11


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

# name -> (cls, pack(obj) -> tuple, unpack(fields_tuple) -> obj)
_STRUCTS: Dict[str, Tuple[Type, Callable[[Any], tuple], Callable[[tuple], Any]]] = {}
_STRUCT_BY_CLS: Dict[Type, str] = {}

# name -> token-level fast builder for the native-scan path (see
# register_token_struct).  Purely an accelerator: absence or a None
# return changes nothing.
_TOKEN_STRUCTS: Dict[str, Callable] = {}

# suite name -> suite instance (for group-element decoding)
_SUITES: Dict[str, Any] = {}

_bootstrapped = False


def register_struct(
    name: str,
    cls: Type,
    pack: Callable[[Any], tuple],
    unpack: Callable[[tuple], Any],
) -> None:
    """Register an application type.  ``unpack`` MUST validate its input
    (field count, field types, value ranges) and raise :class:`DecodeError`
    on anything off — it is the trust boundary for that type."""
    _STRUCTS[name] = (cls, pack, unpack)
    _STRUCT_BY_CLS[cls] = name


def register_suite(suite: Any) -> None:
    _SUITES[suite.name] = suite


def register_token_struct(name: str, fast: Callable) -> None:
    """Register a token-level fast builder for struct ``name`` on the
    native-scan decode path (hot committed types; wire.py registers one
    for the scalar ``"ct"`` — DKG-epoch payloads carry ~N^2 of them).

    ``fast(tokens, ti, data, suite_name)`` is called at the struct's
    FIELDS node and must either return ``(obj, next_ti)`` — with ``obj``
    EXACTLY what the generic ``_build`` + registered unpack would
    construct and ``next_ti`` just past the fields subtree — or return
    None for anything even slightly unusual (other suite, pin mismatch,
    malformed shape), deferring to the generic path so the canonical
    validation and DecodeError behavior apply.  The scan/pure
    fuzz-equivalence tests (tests/test_serde.py) pin both properties.
    """
    _TOKEN_STRUCTS[name] = fast


def get_suite(name: str) -> Any:
    """Suite registered under ``name`` (raises :class:`DecodeError`)."""
    suite = _SUITES.get(name)
    if suite is None:
        raise DecodeError(f"unknown suite {name!r}")
    return suite


def _bootstrap() -> None:
    """Load the module that registers all boundary types (lazy to avoid
    an import cycle: protocols import serde).  The flag is only set after
    a successful import so a transient failure stays loud and retryable
    instead of silently leaving the registry empty."""
    global _bootstrapped
    if not _bootstrapped:
        import hbbft_tpu_torch.wire  # noqa: F401  (registers on import)

        _bootstrapped = True


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _u32(n: int) -> bytes:
    return n.to_bytes(4, "big")


def _encode(obj: Any, out: bytearray, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise EncodeError("nesting too deep")
    if obj is None:
        out.append(_T_NONE)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif type(obj) is int:
        mag = abs(obj)
        raw = mag.to_bytes((mag.bit_length() + 7) // 8, "big") if mag else b""
        out.append(_T_INT)
        out.append(1 if obj < 0 else 0)
        out += _u32(len(raw))
        out += raw
    elif type(obj) in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        out.append(_T_BYTES)
        out += _u32(len(raw))
        out += raw
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        out.append(_T_STR)
        out += _u32(len(raw))
        out += raw
    elif type(obj) is tuple:
        out.append(_T_TUPLE)
        out += _u32(len(obj))
        for item in obj:
            _encode(item, out, depth + 1)
    elif type(obj) is list:
        out.append(_T_LIST)
        out += _u32(len(obj))
        for item in obj:
            _encode(item, out, depth + 1)
    elif type(obj) is dict:
        out.append(_T_DICT)
        out += _u32(len(obj))
        for k, v in obj.items():
            _encode(k, out, depth + 1)
            _encode(v, out, depth + 1)
    else:
        name = _STRUCT_BY_CLS.get(type(obj))
        if name is not None:
            # Pre-rendered encoding memo: producers that construct hot
            # struct objects natively (the scalar KEM's DKG ciphertexts)
            # attach the exact bytes this branch would emit — the memo
            # is a pure function of the frozen fields, and producers pin
            # byte-equality with this recursive path by test.
            try:
                cached = obj.__dict__.get("_serde_cache")
            except AttributeError:
                cached = None
            # depth + 2: the memo'd struct subtree reaches two levels
            # below this node (fields tuple -> leaf values); splicing it
            # deeper would let dumps emit bytes loads rejects.
            if cached is not None and depth + 2 <= MAX_DEPTH:
                out += cached
                return
            _, pack, _ = _STRUCTS[name]
            nraw = name.encode("utf-8")
            out.append(_T_STRUCT)
            out.append(len(nraw))
            out += nraw
            _encode(pack(obj), out, depth + 1)
            return
        # Group element of a registered suite?
        suite_name = getattr(obj, "serde_suite_name", None)
        group = getattr(obj, "serde_group", None)
        if suite_name is not None and group in (1, 2):
            raw = obj.to_bytes()
            nraw = suite_name.encode("utf-8")
            out.append(_T_GROUP)
            out.append(len(nraw))
            out += nraw
            out.append(group)
            out += _u32(len(raw))
            out += raw
            return
        raise EncodeError(f"unencodable type: {type(obj).__name__}")


def dumps(obj: Any) -> bytes:
    _bootstrap()
    out = bytearray()
    _encode(obj, out, 0)
    return bytes(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("data", "pos", "suite_name")

    def __init__(self, data: bytes, suite_name: Any = None) -> None:
        self.data = data
        self.pos = 0
        self.suite_name = suite_name

    def take(self, n: int) -> bytes:
        if n > _MAX_LEN or self.pos + n > len(self.data):
            raise DecodeError("truncated")
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "big")


def _decode(r: _Reader, depth: int) -> Any:
    if depth > MAX_DEPTH:
        raise DecodeError("nesting too deep")
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        sign = r.u8()
        if sign not in (0, 1):
            raise DecodeError("bad int sign")
        raw = r.take(r.u32())
        if raw[:1] == b"\x00":
            raise DecodeError("non-minimal int")  # canonical form only
        mag = int.from_bytes(raw, "big")
        if sign and mag == 0:
            raise DecodeError("negative zero")
        return -mag if sign else mag
    if tag == _T_BYTES:
        return r.take(r.u32())
    if tag == _T_STR:
        try:
            return r.take(r.u32()).decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError("bad utf-8") from e
    if tag in (_T_TUPLE, _T_LIST):
        count = r.u32()
        if count > len(r.data) - r.pos:  # each element costs >= 1 byte
            raise DecodeError("count exceeds input")
        items = [_decode(r, depth + 1) for _ in range(count)]
        return tuple(items) if tag == _T_TUPLE else items
    if tag == _T_DICT:
        count = r.u32()
        if 2 * count > len(r.data) - r.pos:
            raise DecodeError("count exceeds input")
        d: Dict[Any, Any] = {}
        for _ in range(count):
            k = _decode(r, depth + 1)
            v = _decode(r, depth + 1)
            try:
                if k in d:
                    raise DecodeError("duplicate dict key")
                d[k] = v
            except TypeError as e:
                raise DecodeError("unhashable dict key") from e
        return d
    if tag == _T_STRUCT:
        name_raw = r.take(r.u8())
        try:
            name = name_raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError("bad struct name") from e
        entry = _STRUCTS.get(name)
        if entry is None:
            raise DecodeError(f"unknown struct {name!r}")
        fields = _decode(r, depth + 1)
        if not isinstance(fields, tuple):
            raise DecodeError("struct fields must be a tuple")
        try:
            return entry[2](fields)  # validating unpack
        except DecodeError:
            raise
        except Exception as e:  # unpack bug or missed validation: still safe
            raise DecodeError(f"invalid {name}: {e}") from e
    if tag == _T_GROUP:
        name_raw = r.take(r.u8())
        try:
            suite_name = name_raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError("bad suite name") from e
        if r.suite_name is not None and suite_name != r.suite_name:
            raise DecodeError(
                f"suite {suite_name!r} not allowed (expected {r.suite_name!r})"
            )
        suite = get_suite(suite_name)
        group = r.u8()
        raw = r.take(r.u32())
        try:
            if group == 1:
                return suite.g1_from_bytes(raw)
            if group == 2:
                return suite.g2_from_bytes(raw)
        except ValueError as e:
            raise DecodeError(str(e)) from e
        raise DecodeError("bad group id")
    raise DecodeError(f"unknown tag 0x{tag:02x}")


def loads(data: bytes, suite: Any = None) -> Any:
    """Decode; raises :class:`DecodeError` on any malformed input.

    ``suite`` pins the deployment's crypto suite: group elements naming
    any other registered suite are rejected at the frame level.  Without
    the pin, attacker-authored bytes could select the INSECURE
    ``ScalarSuite`` for objects that later reach signature checks — every
    caller decoding wire/committed bytes in a real deployment MUST pass
    its network's suite.
    """
    _bootstrap()
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise DecodeError("not bytes")
    data = bytes(data)
    suite_name = None if suite is None else suite.name
    # Native token scan (C does all byte-level structural validation in
    # one pass; the Python builder below only constructs objects and
    # applies the semantic checks).  Any unavailability falls back to
    # the recursive pure-Python decoder — identical accept/reject
    # behavior either way, pinned by tests/test_serde.py.
    tokens = _native_scan(data)
    if tokens is not None:
        if tokens is _SCAN_MALFORMED:
            raise DecodeError("malformed (native scan)")
        obj, ti = _build(tokens, 0, data, suite_name, 0)
        return obj
    r = _Reader(data, suite_name)
    obj = _decode(r, 0)
    if r.pos != len(r.data):
        raise DecodeError("trailing bytes")
    return obj


def try_loads(data: bytes, suite: Any = None) -> Any:
    """Returns None on any malformed input (Byzantine-supplied bytes)."""
    try:
        return loads(data, suite=suite)
    except DecodeError:
        return None


# ---------------------------------------------------------------------------
# Native-scan decode path (C tokenizer in native/engine.cpp + this builder)
# ---------------------------------------------------------------------------

_SCAN_MALFORMED = object()
# The engine library whose ``hbe_serde_scan`` decodes, set by
# :mod:`hbbft_tpu_torch.native_engine` when it loads one (decoding never
# triggers the engine's g++ build).  Any width works: the scan does not
# depend on the NodeSet width.
_NATIVE_SCAN_LIB: Any = None


def use_native_scan(lib: Any) -> None:
    """Decode through ``lib``'s token scan from now on (the first loaded
    engine library; later ones are ignored)."""
    global _NATIVE_SCAN_LIB
    if _NATIVE_SCAN_LIB is None:
        _NATIVE_SCAN_LIB = lib


def _native_scan(data: bytes):
    """Token triples from the C scanner, _SCAN_MALFORMED on structural
    rejection, or None when no engine is loaded (fall back).
    """
    lib = _NATIVE_SCAN_LIB
    if lib is None:
        return None
    n = len(data)
    # Optimistic buffer: typical values cost >= 4 input bytes per token
    # triple; pathological inputs (runs of 1-byte values) retry with the
    # exact worst case (one triple per input byte, +1 for the root).
    for triples in (n // 2 + 64, n + 2):
        buf = (ctypes.c_int64 * (3 * triples))()
        rc = int(
            lib.hbe_serde_scan(data, n, buf, triples, MAX_DEPTH, _MAX_LEN)
        )
        if rc == -2:
            continue
        if rc < 0:
            return _SCAN_MALFORMED
        return buf
    return _SCAN_MALFORMED  # unreachable: second buffer is worst-case


def _build(t: Any, ti: int, data: bytes, suite_name: Any, depth: int):
    """Construct the value at token index ``ti``; returns (value, next).

    Semantic twin of ``_decode`` over the pre-validated token stream:
    registries, utf-8, dict-key and unpack validation live here, byte
    structure was validated by the scanner.
    """
    if depth > MAX_DEPTH:  # scanner enforces this too; belt-and-braces
        raise DecodeError("nesting too deep")
    base = 3 * ti
    tag = t[base]
    off = t[base + 1]
    ln = t[base + 2]
    ti += 1
    if tag == _T_NONE:
        return None, ti
    if tag == _T_TRUE:
        return True, ti
    if tag == _T_FALSE:
        return False, ti
    low = tag & 0xFF
    if low == _T_INT:
        mag = int.from_bytes(data[off : off + ln], "big")
        return (-mag if tag >> 8 else mag), ti
    if tag == _T_BYTES:
        return data[off : off + ln], ti
    if tag == _T_STR:
        try:
            return data[off : off + ln].decode("utf-8"), ti
        except UnicodeDecodeError as e:
            raise DecodeError("bad utf-8") from e
    if tag in (_T_TUPLE, _T_LIST):
        items = []
        for _ in range(off):  # off = count
            v, ti = _build(t, ti, data, suite_name, depth + 1)
            items.append(v)
        return (tuple(items) if tag == _T_TUPLE else items), ti
    if tag == _T_DICT:
        d: Dict[Any, Any] = {}
        for _ in range(off):
            k, ti = _build(t, ti, data, suite_name, depth + 1)
            v, ti = _build(t, ti, data, suite_name, depth + 1)
            try:
                if k in d:
                    raise DecodeError("duplicate dict key")
                d[k] = v
            except TypeError as e:
                raise DecodeError("unhashable dict key") from e
        return d, ti
    if tag == _T_STRUCT:
        try:
            name = data[off : off + ln].decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError("bad struct name") from e
        entry = _STRUCTS.get(name)
        if entry is None:
            raise DecodeError(f"unknown struct {name!r}")
        fast = _TOKEN_STRUCTS.get(name)
        if fast is not None:
            res = fast(t, ti, data, suite_name)
            if res is not None:
                return res
        fields, ti = _build(t, ti, data, suite_name, depth + 1)
        if not isinstance(fields, tuple):
            raise DecodeError("struct fields must be a tuple")
        try:
            return entry[2](fields), ti
        except DecodeError:
            raise
        except Exception as e:
            raise DecodeError(f"invalid {name}: {e}") from e
    if tag == _T_GROUP:
        try:
            sname = data[off : off + ln].decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError("bad suite name") from e
        if suite_name is not None and sname != suite_name:
            raise DecodeError(
                f"suite {sname!r} not allowed (expected {suite_name!r})"
            )
        suite = get_suite(sname)
        base = 3 * ti
        group, poff, plen = t[base], t[base + 1], t[base + 2]
        ti += 1
        raw = data[poff : poff + plen]
        try:
            if group == 1:
                return suite.g1_from_bytes(raw), ti
            if group == 2:
                return suite.g2_from_bytes(raw), ti
        except ValueError as e:
            raise DecodeError(str(e)) from e
        raise DecodeError("bad group id")
    raise DecodeError(f"unknown tag 0x{tag:02x}")
