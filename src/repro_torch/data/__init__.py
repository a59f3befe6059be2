"""Synthetic data pipeline of the PyTorch port (numpy, host side)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, SyntheticLMDataset, make_input_specs, prefetch_iterator,
)
