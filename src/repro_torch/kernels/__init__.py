"""Hand-written CUDA kernels for Hopper (sm_90a) of the CHEF cleaning loop.

  lr_grad         Eq. 1 batch gradient (validation gradient)
  lr_hvp          H(w)v, the CG inner loop
  minibatch_grad  gathered mini-batch gradient, the sgd_train step
  infl_scores     Eq. 6 score matrix

Each module holds the kernel's wrapper, its plain PyTorch version and a note
on what it replaces and what bounds it. `build` compiles `csrc/` with nvcc;
`common.LAUNCHES` counts each kernel's launches.
"""
from repro_torch.kernels.common import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
