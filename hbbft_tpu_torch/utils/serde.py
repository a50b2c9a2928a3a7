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

Copy of ``hbbft_tpu/utils/serde.py`` without its native token-scan
decode path and without the pre-rendered encoding memo that only native
producers fill: the pure decoder below gives the same objects and raises
the same :class:`DecodeError` exceptions, and ``dumps`` gives the same
bytes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Type

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
