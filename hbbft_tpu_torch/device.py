"""Device selection for every entry point of the port.

The rule: an entry point runs on ``cuda`` unless the caller passes
``device="cpu"``.  There is no fallback — with no card and no explicit
CPU request, :func:`resolve` raises, so a run never drifts onto the CPU
without saying so.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hbbft_tpu_torch: CUDA requested but no CUDA device is available; "
            'pass device="cpu" to run the plain PyTorch path'
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
