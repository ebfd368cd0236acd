"""Examples that run on this package's names (``python -m
attosecondraytracing_tpu_torch.examples.<name>``)."""
