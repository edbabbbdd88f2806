"""Entry points of the port: ``python -m repro_torch.launch.serve`` (the
serving CLI, a copy of the JAX package's)."""
