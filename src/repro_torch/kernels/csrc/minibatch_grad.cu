// Gathered mini-batch gradient, the step of sgd_train (replaces the TPU kernel
// repro/kernels/minibatch_grad.py::minibatch_grad_pallas):
//     B = idx; out = ((softmax(Xa[B].w^T) - Y[B]) * g[B])^T . Xa[B] / |B| + l2 * w
// Both passes read the rows through idx inside the kernel, so the gathered
// batch is never written to device memory. Design and bound: lr_rowcol.cuh.
#include "lr_rowcol.cuh"

extern "C" int chef_minibatch_grad(const float* w, const float* Xa, const float* Y,
                                   const float* gw, const int64_t* idx, int bs, int d, int c,
                                   int chunk_rows, float l2, float* R, float* partial,
                                   float* out, void* stream) {
  return static_cast<int>(chef::launch_rowcol<chef::kGrad>(
      Xa, d, idx, bs, c, chunk_rows, w, nullptr, Y, gw, chef::CorrInputs{},
      static_cast<float>(bs), l2, w, R, partial, out, static_cast<cudaStream_t>(stream)));
}
