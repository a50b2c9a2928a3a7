"""Runnable examples of the port (``python3 -m hbbft_tpu_torch.examples.<name>``)."""
