"""Command-line tools over the port (``python -m hbbft_tpu_torch.tools.<name>``)."""
