"""CLI entry points of the port: serve (test's build_tracker so far). Each
runs as `python -m uvltrack_tpu_torch.cli.<name>`."""
