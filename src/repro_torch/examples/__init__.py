"""Runnable examples of the port (twins of the reference's ``examples/``):
``python -m repro_torch.examples.<name> [--device cpu]``."""
