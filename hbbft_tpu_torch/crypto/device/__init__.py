"""The BLS share-verification flush in PyTorch: Fq/Fq2 limb arithmetic,
Jacobian curve ops and RLC scans, the optimal-ate pairing, and
:class:`~hbbft_tpu_torch.crypto.device.backend.TorchBackend`.

Counterpart of ``hbbft_tpu/crypto/tpu``; plain PyTorch in this slice.
"""
