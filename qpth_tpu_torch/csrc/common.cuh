// Shared device code of the port's Hopper kernels: one thread block per QP,
// the matrices of that QP held in dynamic shared memory.
//
// Layout: one row-major m x m tile per QP with leading dimension m; every
// vector is an m-array in shared memory or one register per thread (thread
// i <-> row i).
// Compiled without --use_fast_math: a lane whose T is not SPD must produce
// NaN (rsqrt of a negative pivot) and the NaN must propagate to the caller,
// which freezes that lane.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace qpth {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// m-vectors a kernel may keep in shared memory beside its m x m tile, and
// the neq-vectors of the equality-constrained step. The fused steps with the
// direct x update also keep one nz-vector (dx). The Python wrappers use the
// same counts in their fit predicate.
constexpr int kSmemVectors = 8;
constexpr int kSmemEqVectors = 4;
// Shared memory one block may use on Hopper, dynamic and static together
// (227 KB; kernels.py::SMEM_LIMIT).
constexpr size_t kSmemLimit = 232448;

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int m, int nz = 0, int neq = 0) {
  return (size_t(m) * m + size_t(kSmemVectors) * m + size_t(nz) +
          size_t(kSmemEqVectors) * neq) * sizeof(T);
}

// Opt a kernel into `smem` bytes of dynamic shared memory and the largest
// shared-memory carve-out, so that as many of its blocks as fit share an SM.
template <typename Kernel>
cudaError_t set_smem(Kernel kern, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

// One element copied from device to shared memory by cp.async (zero-filled
// where ok is false: no byte is read then), so that every copy of a block is
// in flight at once and none holds a register.
template <typename T>
__device__ __forceinline__ void cp_async_elt(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)), "r"(ok ? int(sizeof(T)) : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T> __device__ __forceinline__ T inf_t();
template <> __device__ __forceinline__ float inf_t<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double inf_t<double>() { return CUDART_INF; }

// min / max that propagate NaN, as jnp.minimum / jnp.min and torch.minimum /
// torch.amin do (fminf would drop it and let a NaN lane look healthy).
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (a != a || a < b) ? a : b; }
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (a != a || a > b) ? a : b; }

struct MinOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return nan_min(a, b); }
};
struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Reduce one value per thread over the whole block of NW warps; every
// thread gets the result. `red` holds NW entries. All threads of the block
// must call it.
template <int NW = kWarps, typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < NW; ++w) r = op(r, red[w]);
  __syncthreads();  // red may be reused right away
  return r;
}

// out[i] = sum_c M[i][c] v[c] over c < ncols(i), one warp per row.
// ncols(i) = m for a full matvec, i + 1 for the lower triangle.
template <typename T, bool kLower>
__device__ void smem_matvec(const T* M, const T* v, T* out, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < m; i += kWarps) {
    const int nc = kLower ? i + 1 : m;
    T acc = T(0);
    for (int c = lane; c < nc; c += 32) acc += M[i * m + c] * v[c];
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

// out[i] = sum_c M[i][c] v[c] for a row-major rows x cols matrix M in device
// memory, v and out in shared memory. One warp per row (of a block of NW
// warps), its lanes on consecutive addresses. The caller places the
// barriers.
template <int NW = kWarps, typename T>
__device__ void gmem_matvec(const T* __restrict__ M, const T* v, T* out, int rows, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < rows; i += NW) {
    const T* row = M + size_t(i) * cols;
    T acc = T(0);
    for (int c = lane; c < cols; c += 32) acc += row[c] * v[c];
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

// Cholesky of T + diag(dinv) interleaved with the inverse G = inv(L) of its
// factor, in one m x m tile (the recurrence of the TPU kernel's
// _chol_inv_inplace). It and apply_inv serve kernel 11 (diag_step.cu) and
// kernel A at small m (factor_inv.cu::factor_inv_tile_kernel, m <= 17 in
// float32, <= 50 in float64); kernel A past those widths, kernels C and E
// and the fused steps factor on panel.cuh's 32-row panels.
//   pivot step j:  isq = rsqrt(T[j][j] + dinv[j]),  L[k][j] = T[j][k] isq,
//                  G[k][e] -= L[k][j] (G[j][e] isq)     (k > j, e <= j),
//                  T[k][e] -= L[k][j] (T[j][e] isq)     (j < k <= e).
// The tile holds T's trailing block in its upper triangle and diagonal and
// G's rows, unscaled, in its strictly lower triangle; G's diagonal is an
// implicit 1 until the last pass (T's diagonal holds those words), and the
// pivots' rsqrt go to isqv. Step j reads row j and writes rows k > j only,
// G's columns [0, j] and T's [k, m) of row k in one pass of a warp: one
// barrier per pivot step, and m^3 / 3 multiply-adds per QP in all.
//
// On entry Tm holds T whole, published behind a barrier. Only its lower
// triangle is read: a first pass mirrors it onto the upper triangle and
// clears the strictly lower part (R = G Q^-1 G^T from a product need not be
// bitwise symmetric; the plain version reads the lower triangle too). On
// exit Tm holds inv(L), lower triangular with exact zeros above the
// diagonal. A negative pivot gives NaN (rsqrt), which spreads over the rest
// of that QP's factor only.
//
// The products are those of ops/cuda/kernels.py::factor_inv_plain: L[k][j]
// = T[k][j] isq, G's row j scaled by isq where it is used, the last scale
// by isq_k. The result is not bit-identical to the plain version in
// float64: nvcc contracts each update into one fused multiply-add (one
// rounding where the plain version rounds the product and the difference);
// chip_smoke.py phase 2 prints the float64 difference at m = 100.
template <typename T>
__device__ void chol_inv_smem(T* Tm, const T* dinv, T* isqv, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
    const int r = i / m, c = i - r * m;
    if (c < r) {  // each (r, c), c < r, moves to (c, r): no two threads meet
      Tm[c * m + r] = Tm[i];
      Tm[i] = T(0);
    }
  }
  __syncthreads();
  for (int j = 0; j < m; ++j) {
    const T* rowj = Tm + j * m;
    const T isq = rsqrt_t(rowj[j] + dinv[j]);
    if (threadIdx.x == 0) isqv[j] = isq;
    for (int k = j + 1 + warp; k < m; k += nwarps) {
      const T lk = rowj[k] * isq;
      T* rowk = Tm + k * m;
      const int gap = k - j - 1;  // columns (j, k) of row k: not this step's
      for (int t = lane; t < m - gap; t += 32) {
        const int e = t <= j ? t : t + gap;
        const T src = e == j ? T(1) : rowj[e];
        rowk[e] -= lk * (src * isq);
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
    const int r = i / m, c = i - r * m;
    if (c < r) Tm[i] *= isqv[r];
    else Tm[i] = c == r ? isqv[r] : T(0);
  }
  __syncthreads();
}

// x = G^T (G r) = T^-1 r from the inverse factor G. Thread c returns x[c]
// (0 for c >= m). `w` is an m-vector of scratch. Ends with a barrier, so the
// caller may overwrite r and w right after.
template <typename T>
__device__ T apply_inv(const T* Gm, const T* r, T* w, int m) {
  smem_matvec<T, true>(Gm, r, w, m);
  __syncthreads();
  T x = T(0);
  const int c = threadIdx.x;
  if (c < m)
    for (int i = c; i < m; ++i) x += Gm[i * m + c] * w[i];
  __syncthreads();
  return x;
}

// The block's slice of an operand with batch 1 or B: bit `bit` of `batched`
// set means batch B (else the one copy is read with batch stride 0).
template <typename T>
__device__ __forceinline__ const T* operand(const T* base, int batched, int bit,
                                            long long b, size_t size) {
  return base + ((batched & bit) ? size_t(b) * size : size_t(0));
}

// Largest step a with v + a dv >= 0 for one coordinate.
template <typename T>
__device__ __forceinline__ T step_of(T v, T dv) {
  return dv < T(0) ? -v / dv : inf_t<T>();
}

}  // namespace qpth
