// Kernel 6: one whole Mehrotra iteration (neq = 0) per QP with the direct x
// update, dx = -(x + Q^-1 p) - Q^-1 G^T (z + dz).
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::ipm_step_lanes
// (_ipm_step_kernel). It runs where the solver keeps the reference's own x
// recurrence: untracked residuals (resid_every = 1) or coeff_x = False. The
// body is ipm_step_body.cuh in mode kStepX.
//
// What bounds it on an H100: bytes. At B = 4096, m = nz = 100, float32 it
// reads R (symmetric: its triangle, 83 MB) and Q^-1 G^T (164 MB) once each
// plus a few vectors, >= 0.078 ms at 3.35 TB/s; its ~1/3 m^3 + 2 m^2
// (2 + n_correctors) + 2 nz m flops per QP take ~0.03 ms at 67 TFLOP/s. As
// in the x-free kernel the panels' chains and barriers set its time (2 more
// barriers than its step_barriers); the Q^-1 G^T pass at the end adds one
// coalesced read.
#include "ipm_step_body.cuh"

namespace qpth {

template <typename T>
static int launch(const void* R, const void* iGT, const void* x, const void* s,
                  const void* z, const void* q, const void* ip, void* x_out,
                  void* s_out, void* z_out, void* alpha, int B, int m, int nz,
                  int batched, int n_correctors, void* stream) {
  StepArgs<T> a = {};
  a.R = static_cast<const T*>(R);
  a.iGT = static_cast<const T*>(iGT);
  a.x = static_cast<const T*>(x);
  a.s = static_cast<const T*>(s);
  a.z = static_cast<const T*>(z);
  a.q = static_cast<const T*>(q);
  a.ip = static_cast<const T*>(ip);
  a.x_out = static_cast<T*>(x_out);
  a.s_out = static_cast<T*>(s_out);
  a.z_out = static_cast<T*>(z_out);
  a.a_out = static_cast<T*>(alpha);
  a.m = m;
  a.nz = nz;
  a.neq = 0;
  a.batched = batched;
  a.n_correctors = n_correctors;
  return launch_step<T, kStepX>(a, B, stream);
}

}  // namespace qpth

// R: (bR, m, m); iGT = Q^-1 G^T: (bG, nz, m); bR, bG in {1, B}, bit kOpR /
// kOpIGT of `batched` set when the operand has batch B. x, ip, x_out:
// (B, nz); s, z, q, s_out, z_out: (B, m); alpha: (B,). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int qpth_ipm_step_f32(const void* R, const void* iGT, const void* x,
                                 const void* s, const void* z, const void* q,
                                 const void* ip, void* x_out, void* s_out,
                                 void* z_out, void* alpha, int B, int m, int nz,
                                 int batched, int n_correctors, void* stream) {
  return qpth::launch<float>(R, iGT, x, s, z, q, ip, x_out, s_out, z_out, alpha,
                             B, m, nz, batched, n_correctors, stream);
}

extern "C" int qpth_ipm_step_f64(const void* R, const void* iGT, const void* x,
                                 const void* s, const void* z, const void* q,
                                 const void* ip, void* x_out, void* s_out,
                                 void* z_out, void* alpha, int B, int m, int nz,
                                 int batched, int n_correctors, void* stream) {
  return qpth::launch<double>(R, iGT, x, s, z, q, ip, x_out, s_out, z_out, alpha,
                              B, m, nz, batched, n_correctors, stream);
}

QPTH_STEP_SHAPE(qpth::kStepX)
