"""hbbft_tpu_torch — the PyTorch/CUDA port of the hbbft_tpu device planes.

The JAX package :mod:`hbbft_tpu` stays the reference; this package sits
beside it and imports none of it (nor ``jax``).  Host modules the port
needs are kept here as copies under the same relative paths; the device
modules live under ``crypto/device`` (the BLS share-verification flush)
and ``ops/device`` (the reliable-broadcast data plane), with the
hand-written CUDA kernels in ``csrc/``.

Every entry point takes ``device=`` and runs on ``cuda`` unless the
caller asks for ``"cpu"`` (:func:`hbbft_tpu_torch.device.resolve`).
"""
