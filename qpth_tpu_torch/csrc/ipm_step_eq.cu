// Kernel 7: one whole Mehrotra iteration per QP with equality constraints:
// the S11 / S21 / W Schur algebra, the y update and the direct x update.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::ipm_step_eq_lanes
// (_ipm_step_eq_kernel). It runs every iteration of an inverse-mode solve
// with neq > 0 (the float32 default). The body is ipm_step_body.cuh in mode
// kStepEq.
//
// What bounds it on an H100: bytes. At B = 4096, m = nz = 100, neq = 50,
// float32 it reads R (symmetric: its triangle, 83 MB), Q^-1 G^T (164 MB),
// S21, W, Q^-1 A^T (82 MB each), S11 and S11^-1 (41 MB each) once, 575 MB,
// >= 0.18 ms at 3.35 TB/s; its
// flops (~1/3 m^3 for the factor, a few m^2 and m neq products) take ~0.05 ms
// at 67 TFLOP/s. The equality operands do not fit in shared memory beside
// the m x m tile, so W is read again for every solve (from L2 when it is
// shared or recently used); the panels' chains and barriers still set the
// time.
#include "ipm_step_body.cuh"

namespace qpth {

template <typename T>
static int launch(const void* const* mats, const void* const* vecs,
                  void* const* outs, int B, int m, int nz, int neq, int batched,
                  int n_correctors, void* stream) {
  StepArgs<T> a = {};
  a.R = static_cast<const T*>(mats[0]);
  a.iGT = static_cast<const T*>(mats[1]);
  a.S21 = static_cast<const T*>(mats[2]);
  a.W = static_cast<const T*>(mats[3]);
  a.iS11 = static_cast<const T*>(mats[4]);
  a.S11 = static_cast<const T*>(mats[5]);
  a.iAT = static_cast<const T*>(mats[6]);
  a.x = static_cast<const T*>(vecs[0]);
  a.s = static_cast<const T*>(vecs[1]);
  a.z = static_cast<const T*>(vecs[2]);
  a.y = static_cast<const T*>(vecs[3]);
  a.q = static_cast<const T*>(vecs[4]);
  a.ip = static_cast<const T*>(vecs[5]);
  a.rb = static_cast<const T*>(vecs[6]);
  a.x_out = static_cast<T*>(outs[0]);
  a.s_out = static_cast<T*>(outs[1]);
  a.z_out = static_cast<T*>(outs[2]);
  a.y_out = static_cast<T*>(outs[3]);
  a.a_out = static_cast<T*>(outs[4]);
  a.m = m;
  a.nz = nz;
  a.neq = neq;
  a.batched = batched;
  a.n_correctors = n_correctors;
  return launch_step<T, kStepEq>(a, B, stream);
}

}  // namespace qpth

// Matrices, each with batch 1 or B (bit of `batched` set when B, in the
// order of StepOperand): R (m, m), iGT = Q^-1 G^T (nz, m), S21 (m, neq),
// W (neq, m), iS11 and S11 (neq, neq), iAT = Q^-1 A^T (nz, neq).
// Vectors: x, ip, x_out (B, nz); s, z, q, s_out, z_out (B, m); y, rb, y_out
// (B, neq); alpha (B,). Returns the cudaError_t of the launch (0 on success).
#define QPTH_STEP_EQ(SUFFIX, TYPE)                                             \
  extern "C" int qpth_ipm_step_eq_##SUFFIX(                                    \
      const void* R, const void* iGT, const void* S21, const void* W,          \
      const void* iS11, const void* S11, const void* iAT, const void* x,       \
      const void* s, const void* z, const void* y, const void* q,              \
      const void* ip, const void* rb, void* x_out, void* s_out, void* z_out,   \
      void* y_out, void* alpha, int B, int m, int nz, int neq, int batched,    \
      int n_correctors, void* stream) {                                        \
    const void* mats[] = {R, iGT, S21, W, iS11, S11, iAT};                     \
    const void* vecs[] = {x, s, z, y, q, ip, rb};                              \
    void* outs[] = {x_out, s_out, z_out, y_out, alpha};                        \
    return qpth::launch<TYPE>(mats, vecs, outs, B, m, nz, neq, batched,        \
                              n_correctors, stream);                           \
  }

QPTH_STEP_EQ(f32, float)
QPTH_STEP_EQ(f64, double)

QPTH_STEP_SHAPE(qpth::kStepEq)
