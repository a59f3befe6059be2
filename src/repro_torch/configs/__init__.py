"""Model/PEFT configs of the PyTorch port (its own copy of the registry)."""
from repro_torch.configs.base import (  # noqa: F401
    DTYPES, PEFT_METHODS, DataConfig, ModelConfig, MoEConfig, PEFTConfig,
    SSMConfig, TrainConfig, get_config, register, torch_dtype,
)
