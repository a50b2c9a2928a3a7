"""Approximate wire-size estimator for protocol messages.

The virtual-time simulation (``examples/simulation.py``, the analog of
upstream ``examples/simulation.rs``'s bandwidth model) needs a byte size
for every in-flight message to drive its bandwidth/latency model.  The
strict committed-bytes codec (:mod:`hbbft_tpu_torch.utils.serde`) deliberately
refuses protocol envelopes — they never cross a byte boundary in-process
— so sizing uses this structural walk instead: dataclass-ish objects
contribute their fields, group elements their encoding length, plain
containers their contents, everything gets a small per-object framing
overhead comparable to a real codec's tags.
"""

from __future__ import annotations

from typing import Any

_FRAME = 4  # per-object tag/length overhead, bincode-ish


def estimate(obj: Any, _depth: int = 0) -> int:
    if _depth > 32:
        return _FRAME
    if obj is None or isinstance(obj, bool):
        return 1
    if isinstance(obj, int):
        return _FRAME + max(1, (obj.bit_length() + 7) // 8)
    if isinstance(obj, float):
        return 8
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return _FRAME + len(obj)
    if isinstance(obj, str):
        return _FRAME + len(obj.encode("utf-8"))
    if isinstance(obj, (tuple, list, set, frozenset)):
        return _FRAME + sum(estimate(i, _depth + 1) for i in obj)
    if isinstance(obj, dict):
        return _FRAME + sum(
            estimate(k, _depth + 1) + estimate(v, _depth + 1)
            for k, v in obj.items()
        )
    to_bytes = getattr(obj, "to_bytes", None)
    if callable(to_bytes):
        try:
            return _FRAME + len(to_bytes())
        except Exception:
            pass
    # dataclasses / slotted protocol envelopes: walk their fields
    fields = getattr(obj, "__dict__", None)
    if fields:
        return _FRAME + sum(estimate(v, _depth + 1) for v in fields.values())
    slots = getattr(type(obj), "__slots__", None)
    if slots:
        return _FRAME + sum(
            estimate(getattr(obj, s, None), _depth + 1) for s in slots
        )
    return _FRAME
