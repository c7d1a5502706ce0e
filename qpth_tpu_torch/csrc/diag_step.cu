// Kernel 11: one whole Mehrotra iteration of the diagonal-Q/G tier per QP,
// on the assembled M = A diag(1/H) A^T (neq x neq, SPD).
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/diagstep.py::diag_step_lanes
// (_kernel) and follows it line by line:
//   factor and invert M in place in one neq x neq tile with no diagonal
//   shift (chol_inv_smem of common.cuh with dinv = 0);
//   Newton solve of rt:  dy = M^-1 (A (rt/H) [+ ry]),  dx = (rt - A^T dy)/H;
//   predictor rt = -rx + g z - g d rz (d = z/s), ds = -rz - g dx,
//   dz = -z - d ds; sigma = (t1/t2)^3, mu = |sum s z| / n;
//   corrector rs = (-mu sigma + ds_a dz_a)/s, rt = g rs, ds = -g dx,
//   dz = -rs - d ds; n_correctors Gondzio passes, each accepted per QP when
//   it lengthens the step; alpha = min(0.999 step, 1); a NaN in dx, ds, dz
//   or dy freezes the QP (alpha = 0, every direction masked).
//
// One thread block per QP. M, then its inverse factor, sits in one neq x neq
// shared-memory tile, with kDiagEqVectors neq-vectors and kDiagNVectors
// n-vectors; the n-vectors are walked with strided loops, so n is not tied
// to the thread count. A is read from device memory where it is used: one
// warp per row for A v, thread k down column k for A^T v (neighbouring
// threads on neighbouring addresses); a shared A stays in L2. M, A and g each
// carry their own batch flag.
//
// What bounds it on an H100: bytes. At the sudoku layer's width (B = 4096,
// n = 64, neq = 40, float32) it reads M's triangle (13.4 MB), A once, six
// n-vectors and two neq-vectors and writes four vectors: ~25 MB, ~7.4 us at
// 3.35 TB/s. Its flops (neq^3 / 3 for the factor, ~neq^3 / 3 for the inverse,
// 2 + 2 (1 + n_correctors) products with A and the triangular applies) take
// ~3 us at 67 TFLOP/s. The neq dependent pivot steps (one barrier each)
// set the time.
//
// Block size: the common.cuh helpers (block_reduce, smem_matvec,
// chol_inv_smem) are written for kThreads = 256, which also covers the
// n-loops of box-constrained layers at large n in one or two passes.
#include "common.cuh"

namespace qpth {

constexpr int kDiagNVectors = 10;
constexpr int kDiagEqVectors = 5;

// Bits of DiagArgs::batched: the operand has batch B (else 1).
enum DiagOperand { kDiagM = 1, kDiagA = 2, kDiagG = 4 };

template <typename T>
struct DiagArgs {
  const T *M, *A, *g;                       // (1 or B) x ...
  const T *H, *rx, *rz, *ry, *x, *s, *z, *y;  // per QP
  T *x_out, *s_out, *z_out, *y_out;
  int n, neq, batched, n_correctors;
};

template <typename T>
constexpr size_t diag_smem_bytes(int n, int neq) {
  return (size_t(neq) * neq + size_t(kDiagEqVectors) * neq +
          size_t(kDiagNVectors) * n) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) diag_step_kernel(DiagArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kWarps];
  const int n = a.n, q = a.neq;
  T* Tm = reinterpret_cast<T*>(smem_raw);  // M, then inv(L)
  T* isqv = Tm + q * q;                    // neq-vectors
  T* rhs = isqv + q;
  T* w = rhs + q;
  T* ndy = w + q;
  T* dy = ndy + q;
  T* ss = dy + q;                          // n-vectors
  T* zs = ss + n;
  T* Hs = zs + n;
  T* gs = Hs + n;
  T* rt = gs + n;
  T* nx = rt + n;
  T* dx = nx + n;
  T* ds = dx + n;
  T* dz = ds + n;
  T* rs = dz + n;

  const long long b = blockIdx.x;
  const int i = threadIdx.x;
  const size_t vb = size_t(b) * n, yb = size_t(b) * q;
  const T* Mb = operand(a.M, a.batched, kDiagM, b, size_t(q) * q);
  const T* Ab = operand(a.A, a.batched, kDiagA, b, size_t(q) * n);
  const T* gb = operand(a.g, a.batched, kDiagG, b, size_t(n));
  for (int k = i; k < q * q; k += blockDim.x) Tm[k] = Mb[k];
  for (int c = i; c < q; c += blockDim.x) w[c] = T(0);  // no diagonal shift
  for (int k = i; k < n; k += blockDim.x) {
    ss[k] = a.s[vb + k];
    zs[k] = a.z[vb + k];
    Hs[k] = a.H[vb + k];
    gs[k] = gb[k];
  }
  __syncthreads();
  chol_inv_smem(Tm, w, isqv, q);

  // Newton solve of the rt in shared memory: nx = dx, ndy = dy.
  auto newton = [&](bool with_ry) {
    for (int k = i; k < n; k += blockDim.x) nx[k] = rt[k] / Hs[k];
    __syncthreads();
    gmem_matvec(Ab, nx, rhs, q, n);  // A (rt / H)
    __syncthreads();
    if (with_ry) {
      for (int c = i; c < q; c += blockDim.x) rhs[c] += a.ry[yb + c];
      __syncthreads();
    }
    const T dyc = apply_inv(Tm, rhs, w, q);
    if (i < q) ndy[i] = dyc;
    __syncthreads();
    for (int k = i; k < n; k += blockDim.x) {
      T acc = T(0);
      for (int c = 0; c < q; ++c) acc += Ab[size_t(c) * n + k] * ndy[c];
      nx[k] = (rt[k] - acc) / Hs[k];
    }
    __syncthreads();
  };

  const MinOp mn;
  const SumOp sm;
  const T one = T(1);
  const T inf = inf_t<T>();

  // Step to the boundary of the current direction plus (ddz, dds) per
  // coordinate (thread k reads its own entries: no barrier needed).
  auto step_part = [&](int k, T ddz, T dds) {
    return nan_min(step_of(zs[k], dz[k] + ddz), step_of(ss[k], ds[k] + dds));
  };

  // Predictor: rs = z.
  for (int k = i; k < n; k += blockDim.x) {
    const T z = zs[k], g = gs[k], d = z / ss[k];
    rt[k] = (-a.rx[vb + k] + g * z) - g * d * a.rz[vb + k];
  }
  __syncthreads();
  newton(true);
  T part_a = inf, part_t2 = T(0);
  for (int k = i; k < n; k += blockDim.x) {
    const T s = ss[k], z = zs[k], d = z / s;
    const T dsa = -a.rz[vb + k] - gs[k] * nx[k];
    dx[k] = nx[k];
    ds[k] = dsa;
    dz[k] = -z - d * dsa;
    part_a = nan_min(part_a, step_part(k, T(0), T(0)));
    part_t2 += s * z;
  }
  for (int c = i; c < q; c += blockDim.x) dy[c] = ndy[c];
  const T alpha = nan_min(block_reduce(part_a, mn, red), one);
  const T t2 = block_reduce(part_t2, sm, red);
  T part_t1 = T(0);
  for (int k = i; k < n; k += blockDim.x)
    part_t1 += (ss[k] + alpha * ds[k]) * (zs[k] + alpha * dz[k]);
  const T t1 = block_reduce(part_t1, sm, red);
  const T ratio = t1 / t2;
  const T sig = ratio * ratio * ratio;
  const T mu = fabs(t2) / T(n);

  // Corrector: RHS zero except rs.
  for (int k = i; k < n; k += blockDim.x) {
    const T rsc = (-(mu * sig) + ds[k] * dz[k]) / ss[k];
    rs[k] = rsc;
    rt[k] = gs[k] * rsc;
  }
  __syncthreads();
  newton(false);
  for (int k = i; k < n; k += blockDim.x) {
    const T d = zs[k] / ss[k];
    const T dsc = -gs[k] * nx[k];
    dx[k] += nx[k];
    ds[k] += dsc;
    dz[k] += -rs[k] - d * dsc;
  }
  for (int c = i; c < q; c += blockDim.x) dy[c] += ndy[c];

  // Gondzio centrality correctors.
  for (int it = 0; it < a.n_correctors; ++it) {
    T part = inf;
    for (int k = i; k < n; k += blockDim.x) part = nan_min(part, step_part(k, T(0), T(0)));
    const T a_g = nan_min(block_reduce(part, mn, red), one);
    const T a_t = nan_min(T(1.08) * a_g + T(0.08), one);
    const T mu_t = sig * mu;
    for (int k = i; k < n; k += blockDim.x) {
      const T v = (ss[k] + a_t * ds[k]) * (zs[k] + a_t * dz[k]);
      const T rsg = (v - nan_min(nan_max(v, T(0.1) * mu_t), T(10.0) * mu_t)) / ss[k];
      rs[k] = rsg;
      rt[k] = gs[k] * rsg;
    }
    __syncthreads();
    newton(false);
    part = inf;
    for (int k = i; k < n; k += blockDim.x) {
      const T dsg = -gs[k] * nx[k];
      part = nan_min(part, step_part(k, -rs[k] - (zs[k] / ss[k]) * dsg, dsg));
    }
    const T a_n = nan_min(block_reduce(part, mn, red), one);
    if (a_n > a_g) {  // uniform across the block; false on NaN
      for (int k = i; k < n; k += blockDim.x) {
        const T dsg = -gs[k] * nx[k];
        dz[k] += -rs[k] - (zs[k] / ss[k]) * dsg;
        ds[k] += dsg;
        dx[k] += nx[k];
      }
      for (int c = i; c < q; c += blockDim.x) dy[c] += ndy[c];
    }
  }

  T part = inf;
  bool bad = false;
  for (int k = i; k < n; k += blockDim.x) {
    part = nan_min(part, step_part(k, T(0), T(0)));
    bad = bad || isnan(dz[k]) || isnan(ds[k]) || isnan(dx[k]);
  }
  for (int c = i; c < q; c += blockDim.x) bad = bad || isnan(dy[c]);
  T alpha2 = nan_min(T(0.999) * block_reduce(part, mn, red), one);
  const bool frozen = __syncthreads_or(bad);
  if (frozen) alpha2 = T(0);
  for (int k = i; k < n; k += blockDim.x) {
    a.x_out[vb + k] = a.x[vb + k] + alpha2 * (frozen ? T(0) : dx[k]);
    a.s_out[vb + k] = ss[k] + alpha2 * (frozen ? T(0) : ds[k]);
    a.z_out[vb + k] = zs[k] + alpha2 * (frozen ? T(0) : dz[k]);
  }
  for (int c = i; c < q; c += blockDim.x)
    a.y_out[yb + c] = a.y[yb + c] + alpha2 * (frozen ? T(0) : dy[c]);
}

template <typename T>
static int launch(const void* const* ins, void* const* outs, int B, int n,
                  int neq, int batched, int n_correctors, void* stream) {
  DiagArgs<T> a = {};
  const T** fields[] = {&a.M, &a.A, &a.g, &a.H, &a.rx, &a.rz,
                        &a.ry, &a.x, &a.s, &a.z, &a.y};
  for (int k = 0; k < 11; ++k) *fields[k] = static_cast<const T*>(ins[k]);
  a.x_out = static_cast<T*>(outs[0]);
  a.s_out = static_cast<T*>(outs[1]);
  a.z_out = static_cast<T*>(outs[2]);
  a.y_out = static_cast<T*>(outs[3]);
  a.n = n;
  a.neq = neq;
  a.batched = batched;
  a.n_correctors = n_correctors;
  auto kern = diag_step_kernel<T>;
  const size_t smem = diag_smem_bytes<T>(n, neq);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return int(err);
  kern<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // namespace qpth

// M (neq, neq), A (neq, n), g (n), each with batch 1 or B (bits 1, 2, 4 of
// `batched` set when B). H, rx, rz, x, s, z and x_out, s_out, z_out: (B, n);
// ry, y, y_out: (B, neq). Returns the cudaError_t of the launch (0 on
// success).
#define QPTH_DIAG_STEP(SUFFIX, TYPE)                                           \
  extern "C" int qpth_diag_step_##SUFFIX(                                      \
      const void* M, const void* A, const void* g, const void* H,              \
      const void* rx, const void* rz, const void* ry, const void* x,           \
      const void* s, const void* z, const void* y, void* x_out, void* s_out,   \
      void* z_out, void* y_out, int B, int n, int neq, int batched,            \
      int n_correctors, void* stream) {                                        \
    const void* ins[] = {M, A, g, H, rx, rz, ry, x, s, z, y};                  \
    void* outs[] = {x_out, s_out, z_out, y_out};                               \
    return qpth::launch<TYPE>(ins, outs, B, n, neq, batched, n_correctors,     \
                              stream);                                         \
  }

QPTH_DIAG_STEP(f32, float)
QPTH_DIAG_STEP(f64, double)
