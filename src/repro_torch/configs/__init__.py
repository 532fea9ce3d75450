from repro_torch.configs.chef_lr import ChefConfig, DatasetSpec, paper_dataset_specs

__all__ = ["ChefConfig", "DatasetSpec", "paper_dataset_specs"]
