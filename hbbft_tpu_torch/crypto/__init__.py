"""Threshold BLS crypto: host copies of the reference's jax-free modules
(``suite``, ``poly``, ``keys``, ``backend``, ``bls/``) and the torch
device flush in :mod:`hbbft_tpu_torch.crypto.device`."""
