// Gathered mini-batch gradient, the step of sgd_train (replaces the TPU kernel
// repro/kernels/minibatch_grad.py::minibatch_grad_pallas):
//     B = idx; out = ((softmax(Xa[B].w^T) - Y[B]) * g[B])^T . Xa[B] / |B| + l2 * w
// One launch a call, each batch row read once through idx, so the gathered
// batch never reaches device memory. Bound on the H100: device-memory bytes,
// one read of the bs rows (at bs 2000, D 2049: 16.4 MB, 4.9 us at 3.35 TB/s).
// Design, regimes and the fixed summation order (shapes and SM count only):
// lr_gather.cuh.
#include "lr_gather.cuh"

extern "C" int chef_minibatch_grad(const float* w, const float* Xa, const float* Y,
                                   const float* gw, const int64_t* idx, int bs, int d, int c,
                                   int grid, int few, float l2, float* partial, float* out,
                                   void* stream) {
  chef::gather::Args a{};
  a.Xa = Xa;
  a.idx = idx;
  a.w = w;
  a.Y = Y;
  a.g = gw;
  a.base = w;
  a.partial = partial;
  a.out = out;
  a.D = d;
  a.n_rows = bs;
  a.denom = static_cast<float>(bs);
  a.l2 = l2;
  return static_cast<int>(chef::gather::launch<chef::kGrad>(a, c, grid, few,
                                                            static_cast<cudaStream_t>(stream)));
}
