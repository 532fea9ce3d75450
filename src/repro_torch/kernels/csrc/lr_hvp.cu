// Hessian-vector product of the LR head, the CG inner loop (replaces the TPU
// kernel repro/kernels/lr_hvp.py::lr_hvp_pallas):
//     p = softmax(Xa.w^T), u = Xa.v^T, s = g * (p*u - p*(p.u))
//     out = s^T . Xa / N + l2 * v                                   [C, D]
// One launch a call that reads each row of Xa once: lr_gather.cuh's many_rows
// grid in its kHvp mode (row i is slot i, no ids), the [C, D] partials of its
// CTAs added in CTA order after a grid barrier, so a CG solve repeats bit for
// bit. Bound on the H100: device-memory bytes, one read of Xa (at the mimic
// widths, N = 78,487 and D = 2049, 643 MB: 0.192 ms at 3.35 TB/s).
#include "lr_gather.cuh"

extern "C" int chef_lr_hvp(const float* w, const float* v, const float* Xa, const float* gw,
                           int n, int d, int c, int grid, float l2, float* partial, float* out,
                           void* stream) {
  chef::gather::Args a{};
  a.Xa = Xa;
  a.w = w;
  a.v = v;
  a.g = gw;
  a.base = v;
  a.partial = partial;
  a.out = out;
  a.D = d;
  a.n_rows = n;
  a.denom = static_cast<float>(n);
  a.l2 = l2;
  return static_cast<int>(chef::gather::launch<chef::kHvp>(a, c, grid, 0,
                                                           static_cast<cudaStream_t>(stream)));
}
