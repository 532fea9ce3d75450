"""CHEF core in PyTorch, module for module with `repro.core`.

  backend    — Backend dispatch (reference | cuda)
  lr_head    — the strongly-convex LR head (closed-form grad/HVP/loss, SGD)
  influence  — INFL (Eq. 6), INFL-D (Eq. 2), INFL-Y (Eq. 7)
  cg         — conjugate-gradient H⁻¹g
  increm     — Increm-INFL (Theorem 1 bounds + Algorithm 1 pruning)
  deltagrad  — DeltaGrad-L replay (Algorithm 2)
  baselines  — the Exp1 sample-selector baselines
  annotation — simulated annotators, majority vote, INFL-as-annotator
  metrics    — F1 and accuracy
  pipeline   — `run_chef` and `train_head`
"""
from repro_torch.core.backend import BACKENDS, Backend, get_backend
from repro_torch.core.increm import algorithm1, build_provenance, increm_infl, theorem1_bounds
from repro_torch.core.influence import InflResult, infl, infl_scores, influence_vector
from repro_torch.core.pipeline import ChefResult, RoundRecord, run_chef, train_head

__all__ = [
    "Backend", "BACKENDS", "get_backend", "ChefResult", "RoundRecord", "run_chef", "train_head",
    "infl", "infl_scores", "influence_vector", "InflResult", "build_provenance", "increm_infl",
    "theorem1_bounds", "algorithm1",
]
