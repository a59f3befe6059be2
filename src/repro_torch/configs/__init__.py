"""Model/PEFT configs of the PyTorch port (its own copy of the registry)."""
from repro_torch.configs.base import (  # noqa: F401
    DTYPES, LM_SHAPES, PEFT_METHODS, DataConfig, InputShape, MeshConfig,
    ModelConfig, MoEConfig, PEFTConfig, SSMConfig, TrainConfig, get_config,
    register, shape_applicable, torch_dtype,
)

#: the architectures the dry-run roofline covers (the reference's set)
ASSIGNED_ARCHS = (
    "mamba2-1.3b", "starcoder2-15b", "granite-8b", "internlm2-1.8b",
    "nemotron-4-15b", "internvl2-26b", "dbrx-132b", "deepseek-moe-16b",
    "zamba2-1.2b", "seamless-m4t-medium",
)
