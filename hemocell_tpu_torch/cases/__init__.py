"""Cases runnable on the port (``python -m hemocell_tpu_torch.cases.<name>``)."""
