"""CLI entry points of the port: train, prewarm, test, analyze, pack and
serve. Each runs as `python -m uvltrack_tpu_torch.cli.<name>`."""
