// Kernel B: one whole x-free Mehrotra iteration (neq = 0) per QP.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::ipm_step_xfree_lanes
// (_ipm_step_xfree_kernel). Outputs zeta = z + dz (masked on a frozen QP), s',
// z' and alpha; the NaN freeze reads (dz, ds) only. x never enters: the caller
// carries it as recurrence coefficients (core/pdipm.py). The body is
// ipm_step_body.cuh in mode kStepXFree.
//
// What bounds it on an H100: at B = 4096, m = 100 it must read R (symmetric:
// its triangle, 83 MB) plus a few (B, m) vectors, >= 0.028 ms at 3.35 TB/s;
// its ~1/3 m^3 + 2 m^2 (2 + n_correctors) flops per QP (the factor, R z and
// the solves; no inverse) take ~0.025 ms at 67 TFLOP/s. The device-memory
// traffic is near that floor (R read once, whole, for R z; nothing but
// vectors written). The factor runs on kernel C's 32-row panels and each
// solve is two substitutions by panels (the body's notes): the 32-step
// chains of one warp per panel and the block barriers between them
// (step_barriers: 33 at m = 100, n_correctors = 0) set a block's time, and
// the blocks an SM holds at once the kernel's: float32 up to m = 100 runs
// blocks of 6 warps, 5 an SM, against 4 of 8 warps
// (ipm_step_body.cuh::step_warps); float64 8 warps, 2 an SM.
#include "ipm_step_body.cuh"

namespace qpth {

template <typename T>
static int launch(const void* R, const void* s, const void* z, const void* q,
                  void* zeta, void* s_out, void* z_out, void* alpha, int B,
                  int m, int r_batched, int n_correctors, void* stream) {
  StepArgs<T> a = {};
  a.R = static_cast<const T*>(R);
  a.s = static_cast<const T*>(s);
  a.z = static_cast<const T*>(z);
  a.q = static_cast<const T*>(q);
  a.zeta_out = static_cast<T*>(zeta);
  a.s_out = static_cast<T*>(s_out);
  a.z_out = static_cast<T*>(z_out);
  a.a_out = static_cast<T*>(alpha);
  a.m = m;
  a.batched = r_batched ? kOpR : 0;
  a.n_correctors = n_correctors;
  return launch_step<T, kStepXFree>(a, B, stream);
}

}  // namespace qpth

// R: (bR, m, m), bR in {1, B}; s, z, q, zeta, s_out, z_out: (B, m);
// alpha: (B,). Returns the cudaError_t of the launch (0 on success).
extern "C" int qpth_ipm_step_xfree_f32(const void* R, const void* s,
                                       const void* z, const void* q,
                                       void* zeta, void* s_out, void* z_out,
                                       void* alpha, int B, int m,
                                       int r_batched, int n_correctors,
                                       void* stream) {
  return qpth::launch<float>(R, s, z, q, zeta, s_out, z_out, alpha, B, m,
                             r_batched, n_correctors, stream);
}

extern "C" int qpth_ipm_step_xfree_f64(const void* R, const void* s,
                                       const void* z, const void* q,
                                       void* zeta, void* s_out, void* z_out,
                                       void* alpha, int B, int m,
                                       int r_batched, int n_correctors,
                                       void* stream) {
  return qpth::launch<double>(R, s, z, q, zeta, s_out, z_out, alpha, B, m,
                              r_batched, n_correctors, stream);
}

// Block barriers one QP of width m passes in this kernel with n_correctors
// Gondzio passes (ipm_step_body.cuh::step_barriers).
extern "C" int qpth_ipm_step_barriers(int m, int n_correctors) {
  return qpth::step_barriers(m, n_correctors);
}

QPTH_STEP_SHAPE(qpth::kStepXFree)
