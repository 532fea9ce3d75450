"""repro_torch — the PyTorch/CUDA port of CHEF for one NVIDIA H100.

It sits beside the JAX package `repro`, which stays the reference, keeps its
module names, and imports neither JAX nor anything of `repro`. Entry points
run on the card unless the caller passes `device="cpu"`.

  configs   ChefConfig, dataset specs, ModelConfig and the registry (own copies)
  kernels   hand-written CUDA kernels (sm_90a) with their plain versions
  core      Backend, lr_head, cg, influence, increm, deltagrad, baselines,
            annotation, metrics, pipeline (run_chef, train_head)
  data      synthetic weak-label datasets
  cleaning  CleaningSession, phases, the blocking RoundScheduler
  ckpt      atomic, async checkpoints in the JAX package's layout
  models    the serving model: layers, attention + paged KV cache, Model
  serving   ServeEngine: paged continuous batching with prefix sharing
  launch    the serve CLI
  convert   numpy state from the JAX package -> the port's objects

Float32 matrix products run in full float32: TF32 keeps about three decimal
digits, which would push the CG solve and the Theorem-1 bounds past any
tight tolerance against the reference, so both switches are off.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
