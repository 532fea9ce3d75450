// DeltaGrad-L replay correction over the changed rows of one batch (paper
// Eq. 4, right term; replaces the TPU kernel
// repro/kernels/replay_correction.py::replay_correction_pallas):
//     p = softmax(Xa[ci].w^T)                                    [r, C]
//     out = ((p - Y_new[ci]) * (g_new[ci] * cm)
//            - (p - Y_old[ci]) * (g_old[ci] * cm))^T . Xa[ci] / batch_size   [C, D]
// One softmax feeds both label branches; a padded slot (cm = 0, ci = 0) gets
// a zero residual and adds exactly zero. One launch a call. Bound on the
// H100: at a replay step's 1-3 changed rows (about 25 KB) the launch and two
// dependent loads (the ids, then the rows), not the bytes; with many slots,
// device-memory bytes. Design, regimes and the fixed summation order (shapes
// and SM count only, so a replay repeats bit for bit): lr_gather.cuh.
#include "lr_gather.cuh"

extern "C" int chef_replay_correction(const float* w, const float* Xa, const float* Y_old,
                                      const float* Y_new, const float* g_old,
                                      const float* g_new, const int64_t* ci, const float* cm,
                                      int r, int d, int c, int grid, int few, float batch_size,
                                      float* partial, float* out, void* stream) {
  chef::gather::Args a{};
  a.Xa = Xa;
  a.idx = ci;
  a.w = w;
  a.Y = Y_old;
  a.g = g_old;
  a.Y_new = Y_new;
  a.g_new = g_new;
  a.mask = cm;
  a.partial = partial;
  a.out = out;
  a.D = d;
  a.n_rows = r;
  a.denom = batch_size;
  return static_cast<int>(chef::gather::launch<chef::kCorr>(a, c, grid, few,
                                                            static_cast<cudaStream_t>(stream)));
}
