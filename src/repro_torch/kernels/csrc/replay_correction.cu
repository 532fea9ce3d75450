// DeltaGrad-L replay correction over the changed rows of one batch (paper
// Eq. 4, right term; replaces the TPU kernel
// repro/kernels/replay_correction.py::replay_correction_pallas):
//     p = softmax(Xa[ci].w^T)                                    [r, C]
//     out = ((p - Y_new[ci]) * (g_new[ci] * cm)
//            - (p - Y_old[ci]) * (g_old[ci] * cm))^T . Xa[ci] / batch_size   [C, D]
// One softmax feeds both label branches. A padded slot (cm = 0, ci = 0)
// gets a zero residual and adds exactly zero. Both passes read the rows
// through ci, so the gathered rows never reach device memory; the sum runs in
// a fixed order with no atomics, so a replay repeats bit for bit. Design and
// bound: lr_rowcol.cuh (no l2 term here).
#include "lr_rowcol.cuh"

extern "C" int chef_replay_correction(const float* w, const float* Xa, const float* Y_old,
                                      const float* Y_new, const float* g_old,
                                      const float* g_new, const int64_t* ci, const float* cm,
                                      int r, int d, int c, int chunk_rows, float batch_size,
                                      float* R, float* partial, float* out, void* stream) {
  return static_cast<int>(chef::launch_rowcol<chef::kCorr>(
      Xa, d, ci, r, c, chunk_rows, w, nullptr, Y_old, g_old, chef::CorrInputs{Y_new, g_new, cm},
      batch_size, 0.f, nullptr, R, partial, out, static_cast<cudaStream_t>(stream)));
}
