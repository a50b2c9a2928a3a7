"""Data-plane ops: host Reed-Solomon and Merkle copies, and the device
data plane in :mod:`hbbft_tpu_torch.ops.device`."""
