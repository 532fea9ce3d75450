// Hessian-vector product of the LR head, the CG inner loop (replaces the TPU
// kernel repro/kernels/lr_hvp.py::lr_hvp_pallas):
//     p = softmax(Xa.w^T), u = Xa.v^T, s = g * (p*u - p*(p.u))
//     out = s^T . Xa / N + l2 * v                                   [C, D]
// Design and bound: lr_rowcol.cuh.
#include "lr_rowcol.cuh"

extern "C" int chef_lr_hvp(const float* w, const float* v, const float* Xa, const float* gw,
                           int n, int d, int c, int chunk_rows, float l2, float* R,
                           float* partial, float* out, void* stream) {
  return static_cast<int>(chef::launch_rowcol<chef::kHvp>(
      Xa, d, nullptr, n, c, chunk_rows, w, v, nullptr, gw, chef::CorrInputs{},
      static_cast<float>(n), l2, v, R, partial, out, static_cast<cudaStream_t>(stream)));
}
