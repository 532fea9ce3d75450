# the arch modules' imports populate the registry
from repro_torch.configs import (granite_8b, mixtral_8x22b, olmo_1b, qwen2_72b,  # noqa: F401
                                 qwen3_moe_30b_a3b, recurrentgemma_9b, starcoder2_3b)
from repro_torch.configs.base import ModelConfig, MoEConfig, RGLRUConfig, get_config, reduced
from repro_torch.configs.chef_lr import ChefConfig, DatasetSpec, paper_dataset_specs

__all__ = ["ChefConfig", "DatasetSpec", "paper_dataset_specs", "ModelConfig", "MoEConfig",
           "RGLRUConfig", "get_config", "reduced"]
