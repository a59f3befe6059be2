"""Optimizers of the PyTorch port (PEFT-masked AdamW)."""
