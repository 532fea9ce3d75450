// Full-batch Eq. 1 gradient of the LR head (replaces the TPU kernel
// repro/kernels/lr_grad.py::lr_grad_pallas):
//     out = ((softmax(Xa.w^T) - Y) * g)^T . Xa / N + l2 * w        [C, D]
// One launch a call that reads each row of Xa once: lr_gather.cuh in its
// kGrad mode over contiguous rows (idx null: row i is slot i) on
// kernels/common.py's gather_plan, the few-rows kernel for a handful of rows,
// else the many-rows grid, its [C, D] partials added in CTA order after a
// grid barrier, so a result repeats bit for bit. Bound on the H100:
// device-memory bytes, one read of Xa (at mimic's 579 validation rows,
// D 2049: 4.75 MB, 1.4 us at 3.35 TB/s), under a launch's latency.
#include "lr_gather.cuh"

extern "C" int chef_lr_grad(const float* w, const float* Xa, const float* Y, const float* gw,
                            int n, int d, int c, int grid, int few, float l2, float* partial,
                            float* out, void* stream) {
  chef::gather::Args a{};
  a.Xa = Xa;
  a.w = w;
  a.Y = Y;
  a.g = gw;
  a.base = w;
  a.partial = partial;
  a.out = out;
  a.D = d;
  a.n_rows = n;
  a.denom = static_cast<float>(n);
  a.l2 = l2;
  return static_cast<int>(chef::gather::launch<chef::kGrad>(a, c, grid, few,
                                                            static_cast<cudaStream_t>(stream)));
}
