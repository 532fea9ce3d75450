from repro_torch.data.synth import ChefDataset, make_dataset, make_paper_dataset

__all__ = ["ChefDataset", "make_dataset", "make_paper_dataset"]
