from repro_torch.configs import olmo_1b, starcoder2_3b  # noqa: F401  (populates the registry)
from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.configs.chef_lr import ChefConfig, DatasetSpec, paper_dataset_specs

__all__ = ["ChefConfig", "DatasetSpec", "paper_dataset_specs", "ModelConfig", "get_config",
           "reduced"]
