// Kernel 5: x = Linv^T (Linv rhs) = T^-1 rhs from the cached inverse factor
// Linv = inv(chol(T)) that kernel A wrote.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::inv_solve_lanes
// (:567, body _inv_apply :382): the same function, x = sum_i Linv[i]^T w_i
// with w_i = Linv[i] . rhs, each row of Linv used for both products and read
// from device memory once. Its 8-row slabs and two accumulators are TPU
// facts. It serves every solve on a factor after the first: the corrector
// and the Gondzio corrections of the composed IPM step, and every solve on
// M of the diagonal tier.
//
// What bounds it on an H100: bytes. Only the lower triangle of Linv is read.
// At B = 4096 that is 83 MB in float32 at m = 100 (166 MB in float64, which
// the float64 default runs) and 13.4 MB at m = 40 (path 5's M), plus two
// (B, m) vectors: >= 0.026 ms (0.051 ms; 0.0044 ms) at 3.35 TB/s. Its
// 2 m (m + 1) flops per QP take 0.001 ms at 67 TFLOP/s.
//
// Design: no shared memory and no block barrier; each QP is a warp's work,
// or half a warp's, and Linv streams through registers.
//   * Lanes per QP G: 32, or 16 when one 16-byte vector per lane of a half
//     warp covers a row (m <= 16 V: f32 m <= 64 and f64 m <= 32 on the
//     16-byte path, m <= 16 on the scalar one), so that path 5's m = 40
//     keeps 10 of 16 lanes busy instead of 10 of 32. 8 or 16 QPs per
//     256-thread block; at <= 64 registers a thread four blocks share an SM
//     and all 4096 QPs of the main shapes are in flight at once. A warp
//     whose QPs are all past B leaves at once; a half warp past B runs on
//     zeros and loads and stores nothing.
//   * Lane l of a QP owns columns V l + G V t + j (j < V, slot t < K): rhs
//     and the x accumulator live in registers, K V values each, with
//     K = ceil(m / G V) a template parameter.
//   * Rows in flight: the row loop takes R rows at a time, unrolled, all R
//     rows' loads issued before the first product; R rows' K V values fill
//     kRowWords registers (R = 4 at f32 m = 40 and 100, 2 at f64 m = 100).
//     With 32 warps (32 or 64 QPs) on each SM that covers the memory
//     latency: the next R rows loaded before these rows' sums was no
//     faster, and twice the rows slower (benchmarks/inv_solve_designs.py).
//   * The R dot products w_i are reduced by R butterflies over the QP's G
//     lanes, independent chains the unrolled loop interleaves. A transposed
//     butterfly (the R sums halved across lanes, then broadcast: 2 R - 1 +
//     log2 G - log2 R shuffles for R rows, not R log2 G) adds the same
//     pairs in the same order but was slower at m = 40 (the same script).
//   * 16-byte loads (float4, double2) when Linv, rhs and x start on 16-byte
//     boundaries and a row is a whole number of 16-byte vectors (f32 m % 4
//     == 0, f64 m % 2 == 0: m = 40 and 100 in both); V = 1 otherwise. Both
//     are this kernel, instantiated per V.
// Only Linv's lower triangle reaches the result: a lane loads a vector only
// if its first column is on or before the diagonal, and the entries of that
// vector past the diagonal (at most V - 1 of them, in the same row) are
// replaced by zero before any product, so whatever the upper triangle holds,
// NaN included, is never used. A QP whose Linv holds NaN gives NaN in that
// QP alone: every shuffle stays inside the QP's G lanes.
#include <cstdint>

#include "common.cuh"

namespace qpth {

constexpr int kMaxM = 256;       // the wrapper's limit (kernel A fits 237 / 166)
constexpr int kRowWords = 16;    // registers a lane gives to R rows
constexpr int kMaxRows = 8;
constexpr int kBlocksPerSM = 4;  // __launch_bounds__: <= 64 registers a thread
constexpr unsigned kFullMask = 0xffffffffu;

// Rows in flight: the largest power of two whose K V values of type T fit
// kRowWords 32-bit registers, between 1 and kMaxRows.
template <typename T, int E>
constexpr int rows_in_flight() {
  int r = 1;
  while (2 * r <= kMaxRows && 2 * r * E * int(sizeof(T) / 4) <= kRowWords) r *= 2;
  return r;
}

__device__ __forceinline__ void load_vec(float (&o)[1], const float* p) { o[0] = __ldg(p); }
__device__ __forceinline__ void load_vec(double (&o)[1], const double* p) { o[0] = __ldg(p); }
__device__ __forceinline__ void load_vec(float (&o)[4], const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_vec(double (&o)[2], const double* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void store_vec(float* p, const float (&o)[1]) { *p = o[0]; }
__device__ __forceinline__ void store_vec(double* p, const double (&o)[1]) { *p = o[0]; }
__device__ __forceinline__ void store_vec(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_vec(double* p, const double (&o)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
}

// Sum v over the G lanes of a QP (G = 16 or 32: offsets below G stay inside
// it); every lane gets the sum.
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

template <typename T, int V, int K, int R>
__device__ __forceinline__ void load_rows(T (&rows)[R][K][V], const T* L,
                                          int i0, int m, int sub, int G,
                                          bool live) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = i0 + q;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int c0 = V * sub + G * V * t;
      if (live && i < m && c0 <= i) {
        load_vec(rows[q][t], L + size_t(i) * m + c0);
#pragma unroll
        for (int j = 1; j < V; ++j)
          if (c0 + j > i) rows[q][t][j] = T(0);  // past the diagonal
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) rows[q][t][j] = T(0);
      }
    }
  }
}

// x += sum over the R rows of row^T (row . rhs), rhs and x in registers.
// Float32 sums the R rows' terms of each x entry in pairs before they meet
// the accumulator (m / R + log2 R roundings in a row, not m); float64 adds
// them one after another. The two orders are equally accurate against the
// exact result and cost the same (benchmarks/inv_solve_designs.py, PERF.md
// §6). Rounding decides two checks of chip_smoke.py that the solves
// feed, path 5b's z in float32 and path 5c's gradients in float64; each
// order fails one of them, so each type takes the order that holds its own.
template <typename T, int V, int K, int R, int G>
__device__ __forceinline__ void apply_rows(const T (&rows)[R][K][V],
                                           const T (&r)[K][V], T (&xa)[K][V]) {
  T w[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    w[q] = T(0);
#pragma unroll
    for (int t = 0; t < K; ++t)
#pragma unroll
      for (int j = 0; j < V; ++j) w[q] += rows[q][t][j] * r[t][j];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) w[q] = group_sum<G>(w[q]);
  constexpr bool kPairs = sizeof(T) == 4;
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (kPairs) {
        T s[R];
#pragma unroll
        for (int q = 0; q < R; ++q) s[q] = rows[q][t][j] * w[q];
#pragma unroll
        for (int h = R / 2; h >= 1; h /= 2)
#pragma unroll
          for (int q = 0; q < h; ++q) s[q] += s[q + h];
        xa[t][j] += s[0];
      } else {
#pragma unroll
        for (int q = 0; q < R; ++q) xa[t][j] += rows[q][t][j] * w[q];
      }
    }
}

template <typename T, int V, int K, int R, int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
inv_solve_kernel(const T* __restrict__ Linv, const T* __restrict__ rhs,
                 T* __restrict__ x, int B, int m) {
  const int lane = threadIdx.x & 31, sub = lane & (G - 1);
  const long long first = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / G);
  if (first >= B) return;  // the whole warp: no block barrier follows
  const long long b = first + lane / G;
  const bool live = b < B;
  const T* L = Linv + size_t(live ? b : 0) * m * m;

  T r[K][V], xa[K][V];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int c0 = V * sub + G * V * t;
    if (live && c0 < m) {
      load_vec(r[t], rhs + size_t(b) * m + c0);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) r[t][j] = T(0);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) xa[t][j] = T(0);
  }

  for (int i0 = 0; i0 < m; i0 += R) {
    T rows[R][K][V];
    load_rows(rows, L, i0, m, sub, G, live);
    apply_rows<T, V, K, R, G>(rows, r, xa);
  }

#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int c0 = V * sub + G * V * t;
    if (live && c0 < m) store_vec(x + size_t(b) * m + c0, xa[t]);
  }
}

// Instantiates K = 1 .. kMaxM / (32 V) and launches the one m needs, with
// a half warp per QP where one slot of 16 lanes covers m.
template <typename T, int V, int K = 1>
static void launch_cols(int k, const T* Linv, const T* rhs, T* x, int B,
                        int m, cudaStream_t s) {
  if constexpr (K * 32 * V < kMaxM) {
    if (k > K) return launch_cols<T, V, K + 1>(k, Linv, rhs, x, B, m, s);
  }
  constexpr int R = rows_in_flight<T, K * V>();
  if constexpr (K == 1) {
    if (m <= 16 * V) {  // a half warp per QP
      constexpr int per_block = 2 * kWarps;
      inv_solve_kernel<T, V, 1, R, 16>
          <<<(B + per_block - 1) / per_block, kThreads, 0, s>>>(Linv, rhs, x, B, m);
      return;
    }
  }
  inv_solve_kernel<T, V, K, R, 32><<<(B + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      Linv, rhs, x, B, m);
}

template <typename T>
static int launch(const void* Linv, const void* rhs, void* x, int B, int m,
                  void* stream) {
  if (m < 1 || m > kMaxM) return int(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const T* Lp = static_cast<const T*>(Linv);
  const T* rp = static_cast<const T*>(rhs);
  T* xp = static_cast<T*>(x);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(Linv) | reinterpret_cast<uintptr_t>(rhs) |
        reinterpret_cast<uintptr_t>(x)) % 16 == 0) && m % kVec == 0;
  if (aligned)
    launch_cols<T, kVec>((m + 32 * kVec - 1) / (32 * kVec), Lp, rp, xp, B, m, s);
  else
    launch_cols<T, 1>((m + 31) / 32, Lp, rp, xp, B, m, s);
  return int(cudaGetLastError());
}

}  // namespace qpth

// Linv: (B, m, m), read below and on the diagonal only; rhs, x: (B, m);
// 1 <= m <= 256. Returns the cudaError_t of the launch (0 on success).
extern "C" int qpth_inv_solve_f32(const void* Linv, const void* rhs, void* x,
                                  int B, int m, void* stream) {
  return qpth::launch<float>(Linv, rhs, x, B, m, stream);
}

extern "C" int qpth_inv_solve_f64(const void* Linv, const void* rhs, void* x,
                                  int B, int m, void* stream) {
  return qpth::launch<double>(Linv, rhs, x, B, m, stream);
}
