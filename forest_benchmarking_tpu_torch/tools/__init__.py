"""Command-line tools of the port (``python -m
forest_benchmarking_tpu_torch.tools.<name>``)."""
