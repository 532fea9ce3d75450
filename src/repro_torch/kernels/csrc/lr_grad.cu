// Full-batch Eq. 1 gradient of the LR head (replaces the TPU kernel
// repro/kernels/lr_grad.py::lr_grad_pallas):
//     out = ((softmax(Xa.w^T) - Y) * g)^T . Xa / N + l2 * w        [C, D]
// Design and bound: lr_rowcol.cuh.
#include "lr_rowcol.cuh"

extern "C" int chef_lr_grad(const float* w, const float* Xa, const float* Y, const float* gw,
                            int n, int d, int c, int chunk_rows, float l2, float* R,
                            float* partial, float* out, void* stream) {
  return static_cast<int>(chef::launch_rowcol<chef::kGrad>(
      Xa, d, n, c, chunk_rows, w, nullptr, Y, gw, static_cast<float>(n), l2, w, R, partial, out,
      static_cast<cudaStream_t>(stream)));
}
