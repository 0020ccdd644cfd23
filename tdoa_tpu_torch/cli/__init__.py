"""Command-line tools of the port (``python -m tdoa_tpu_torch.cli.<name>``)."""
