// Kernel D: x solving (L L^T) x = v from a Cholesky factor, by two
// triangular substitutions.
//
// Replaces the TPU kernels qpth_tpu/ops/pallas/cholesky.py::
// cho_solve_vec_t_pallas (:316, body :289) and qpth_tpu/ops/pallas/lanes.py::
// cho_solve_lanes (:1240, body _solve_from_rows :145): the same function; their
// (BT, n, n) tiles and lanes layout are TPU facts. It is the blocked
// backend's solve2: every solve on T's factor Lt after the first, and, in
// substitution mode, every Q and S11 solve on their factors.
//
// The factor comes as Lt = L^T (upper, kernel C's output) or as L (lower, the
// layout of KKTFactors.L_Q and L_S11), with batch B or 1. Both substitutions
// run in column (SAXPY) order, whatever the layout:
//   forward   y_j = r_j / U[j][j],  r_k -= U[j][k] y_j   (k > j, j ascending)
//   backward  x_k = r_k / U[k][k],  r_i -= U[i][k] x_k   (i < k, k descending)
// with U = L^T, each division a product with the pivot's reciprocal (taken
// off the chain of dependent steps) and each update one fused multiply-add.
// The forward pass adds in the plain version's order; the backward pass, a
// dot product per row in the plain version, adds the same products in
// another order. The rows are cut into panels of 32: the chain runs only
// over a panel's 32 x 32 diagonal block, and the panel's solution then
// updates the panels not yet solved as independent multiply-adds.
//
// Two regimes, chosen by the factor's batch stride:
//
// * A factor for each lane (Lt of T; batched L_Q and L_S11). Bound by bytes:
//   the triangle read once is >= 0.026 ms at B = 4096, n = 100 in float32
//   (0.051 ms in float64) on an H100. One warp per QP, four QPs per block,
//   32 QPs per SM in float32 (24 in float64, where shared memory allows 6
//   blocks): B = 4096 is in flight at once. The right-hand side lives in
//   registers, element 32 t + lane in slot t of that lane. Each 32 x 32
//   block of the factor is copied from device memory by cp.async (every
//   copy in flight at once, no register held) into a 32 x 33 tile of the
//   warp's shared memory, rows of Lt as they are and rows of L transposed,
//   so that both passes read either layout the way round they need; the
//   odd leading dimension keeps the transposing stores and the column reads
//   free of bank conflicts. A diagonal block is copied only up to the
//   diagonal. Nothing waits for a whole factor to be staged. The backward
//   pass reads the triangle again, twice the bytes: a packed triangle for
//   each of 32 QPs per SM (20 KB in float32 at n = 100) does not fit in
//   shared memory, and fewer QPs per SM would leave the latency of each
//   block's copy without cover. The chain and the updates cost nothing
//   beside the copies: the time is the rate at which device memory serves
//   these 128-byte row segments (PERF.md §6, PR 7).
//
// * One shared factor (batch 1, the OptNet pattern's L_Q and L_S11): a solve
//   with B right-hand sides. Each block copies the factor's triangle once,
//   packed, into shared memory, with a tile of 32 right-hand sides beside it
//   (lane = right-hand side, so every read of L is a broadcast) and the
//   pivots' reciprocals. Per panel, warp 0 copies the diagonal block into a
//   dense 32 x 32 tile and runs the 32 dependent steps on it for its 32
//   right-hand sides, every read at a fixed offset; then all eight warps
//   apply the panel to the remaining rows, four rows per warp at a time.
//   Products are in full precision (no tensor cores, no TF32). B = 4096
//   gives 128 blocks, one per SM: the bytes are nothing (the triangle is
//   20 KB), and the time is the 2 n / 32 panels' chains and barriers.
//
// A lane whose factor has NaN (kernel C's non-SPD lane) gives NaN in that
// lane alone; a NaN right-hand side stays in its own column. Only the
// factor's triangle is read: entries across the diagonal may hold anything.
#include "common.cuh"

namespace qpth {

constexpr int kPanel = 32;               // rows per panel = lanes per warp
constexpr int kTileLd = kPanel + 1;      // odd leading dimension of a tile
constexpr int kMaxSlots = 8;             // panels of n <= 256 (chol_fits: n <= 239)
constexpr int kLaneWarps = 4;            // QPs per block, per-lane factors
constexpr int kRhsWarps = 8;             // warps per block, shared factor
constexpr unsigned kFull = 0xffffffffu;

// Blocks per SM the per-lane kernel aims at: 8 x 4 QPs in float32 (64
// registers a thread, 17 KB of shared memory a block); 6 x 4 in float64,
// where shared memory allows 6 blocks of 35 KB.
template <typename T> struct LaneBlocks;
template <> struct LaneBlocks<float> { static constexpr int value = 8; };
template <> struct LaneBlocks<double> { static constexpr int value = 6; };

// tile[a][b] = U[32 s + a][32 t + b] (U = L^T; zero beyond n and, in a
// diagonal block, across the diagonal), copied from F (Lt if !LOWER, L if
// LOWER) by coalesced rows: rows of Lt as they are, rows of L transposed.
template <typename T, bool LOWER>
__device__ __forceinline__ void stage_block(T* tile, const T* __restrict__ F,
                                            int n, int s, int t, int lane) {
  __syncwarp();  // earlier reads of the tile are done
#pragma unroll
  for (int q = 0; q < kPanel; ++q) {
    const int row = (LOWER ? kPanel * t : kPanel * s) + q;
    const int col = (LOWER ? kPanel * s : kPanel * t) + lane;
    const bool ok = row < n && col < n &&
                    (s != t || (LOWER ? col <= row : col >= row));
    cp_async_elt(tile + (LOWER ? lane * kTileLd + q : q * kTileLd + lane),
                 ok ? F + size_t(row) * n + col : F, ok);
  }
  cp_async_wait_all();
  __syncwarp();  // every lane's copies are visible to the warp
}

// The dependent steps over diagonal block s (staged in tile), forward:
// y_i = r_i / U[i][i], r_l -= U[i][l] y_i for lanes l > i; the division is a
// product with the pivot's reciprocal, each lane taking its own beforehand.
template <typename T>
__device__ __forceinline__ void chain_forward(const T* tile, T& r, int rows,
                                              int lane) {
  const T inv = T(1) / tile[lane * kTileLd + lane];
#pragma unroll 4
  for (int i = 0; i < rows; ++i) {
    const T u = tile[i * kTileLd + lane];  // U[32 s + i][32 s + lane]
    if (lane == i) r *= inv;
    const T y = __shfl_sync(kFull, r, i);
    if (lane > i) r -= u * y;
  }
}

// Backward: x_k = r_k / U[k][k], r_l -= U[l][k] x_k for lanes l < k, k
// descending.
template <typename T>
__device__ __forceinline__ void chain_backward(const T* tile, T& r, int rows,
                                               int lane) {
  const T inv = T(1) / tile[lane * kTileLd + lane];
#pragma unroll 4
  for (int k = rows - 1; k >= 0; --k) {
    const T u = tile[lane * kTileLd + k];  // U[32 s + lane][32 s + k]
    if (lane == k) r *= inv;
    const T xk = __shfl_sync(kFull, r, k);
    if (lane < k) r -= u * xk;
  }
}

// Both passes run right-looking: panel p solves its diagonal block, then
// its block row (forward) or block column (backward) of U updates the
// panels not yet solved, so every element receives its updates in column
// order (j ascending forward, as the plain version adds; k descending
// backward).
template <typename T, bool LOWER>
__global__ void __launch_bounds__(kLaneWarps * 32, LaneBlocks<T>::value)
cho_solve_lanes_kernel(const T* __restrict__ L, const T* __restrict__ v,
                       T* __restrict__ x, int B, int n) {
  __shared__ T smem[kLaneWarps][kPanel * kTileLd + kPanel];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kLaneWarps + warp;
  if (b >= B) return;  // the whole warp: no block-wide barrier follows
  T* tile = smem[warp];
  T* ys = tile + kPanel * kTileLd;  // the solved panel, for broadcast
  const T* F = L + size_t(b) * n * n;
  const int ns = (n + kPanel - 1) / kPanel;

  T r[kMaxSlots];
#pragma unroll
  for (int t = 0; t < kMaxSlots; ++t) {
    const int k = kPanel * t + lane;
    r[t] = (t < ns && k < n) ? v[size_t(b) * n + k] : T(0);
  }

  // Forward: L y = v, panels ascending; then every later panel t takes
  // U[32 p + i][32 t + lane] y_(32 p + i), i ascending.
#pragma unroll
  for (int p = 0; p < kMaxSlots; ++p) {
    if (p >= ns) break;
    const int rows = min(kPanel, n - kPanel * p);
    stage_block<T, LOWER>(tile, F, n, p, p, lane);
    chain_forward(tile, r[p], rows, lane);
    ys[lane] = r[p];
#pragma unroll
    for (int t = p + 1; t < kMaxSlots; ++t) {
      if (t >= ns) break;
      stage_block<T, LOWER>(tile, F, n, p, t, lane);
#pragma unroll 8
      for (int i = 0; i < rows; ++i) r[t] -= tile[i * kTileLd + lane] * ys[i];
    }
  }

  // Backward: L^T x = y, panels descending; then every earlier panel t
  // takes U[32 t + lane][32 p + k] x_(32 p + k), k descending.
#pragma unroll
  for (int p = kMaxSlots - 1; p >= 0; --p) {
    if (p >= ns) continue;
    const int rows = min(kPanel, n - kPanel * p);
    stage_block<T, LOWER>(tile, F, n, p, p, lane);
    chain_backward(tile, r[p], rows, lane);
    ys[lane] = r[p];
#pragma unroll
    for (int t = p - 1; t >= 0; --t) {
      stage_block<T, LOWER>(tile, F, n, t, p, lane);
#pragma unroll 8
      for (int k = rows - 1; k >= 0; --k) r[t] -= tile[lane * kTileLd + k] * ys[k];
    }
  }

#pragma unroll
  for (int t = 0; t < kMaxSlots; ++t) {
    const int k = kPanel * t + lane;
    if (t < ns && k < n) x[size_t(b) * n + k] = r[t];
  }
}

__host__ __device__ constexpr int tri_words(int n) { return n * (n + 1) / 2; }

// Shared memory of the shared-factor kernel: the packed triangle, the
// pivots' reciprocals, one dense 32 x 32 diagonal block, and n x 33
// right-hand sides.
template <typename T>
__host__ __device__ constexpr size_t shared_smem_bytes(int n) {
  return (size_t(tri_words(n)) + size_t(n) + size_t(kPanel) * kPanel +
          size_t(n) * kTileLd) * sizeof(T);
}

template <typename T, bool LOWER>
__global__ void __launch_bounds__(kRhsWarps * 32)
cho_solve_shared_kernel(const T* __restrict__ L, const T* __restrict__ v,
                        T* __restrict__ x, int B, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* D = reinterpret_cast<T*>(smem_raw);   // a diagonal block, dense
  T* X = D + kPanel * kPanel;              // X[i][c] at i * kTileLd + c
  T* Lp = X + n * kTileLd;                 // L[k][j] at k (k + 1) / 2 + j
  T* inv = Lp + tri_words(n);              // 1 / L[k][k]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b0 = (long long)blockIdx.x * kPanel;
  const int cols = int(min((long long)kPanel, B - b0));

  // Every copy in flight at once: the triangle by coalesced rows of L (or
  // of Lt), the right-hand sides transposed into X.
  if (LOWER) {
    for (int k = warp; k < n; k += kRhsWarps)
      for (int j = lane; j <= k; j += 32)
        cp_async_elt(Lp + tri_words(k) + j, L + size_t(k) * n + j, true);
  } else {
    for (int j = warp; j < n; j += kRhsWarps)
      for (int k = j + lane; k < n; k += 32)
        cp_async_elt(Lp + tri_words(k) + j, L + size_t(j) * n + k, true);
  }
  for (int c = warp; c < kPanel; c += kRhsWarps)
    for (int i = lane; i < n; i += 32)
      cp_async_elt(X + i * kTileLd + c, c < cols ? v + size_t(b0 + c) * n + i : v,
                   c < cols);
  cp_async_wait_all();
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) inv[k] = T(1) / Lp[tri_words(k) + k];
  __syncthreads();

  // Forward, panel by panel: warp 0 solves the diagonal block for its 32
  // columns (from D, the block transposed: D[j][i] = L[p0 + i][p0 + j],
  // every read a broadcast at a fixed offset), then every warp updates
  // its rows below the panel, four rows at a time.
  for (int p0 = 0; p0 < n; p0 += kPanel) {
    const int rows = min(kPanel, n - p0);
    if (warp == 0) {
      for (int e = lane; e < kPanel * kPanel; e += 32) {
        const int j = e / kPanel, i = e - j * kPanel;
        D[e] = (i < rows && j <= i) ? Lp[tri_words(p0 + i) + p0 + j] : T(0);
      }
      __syncwarp();
      T yr[kPanel];
#pragma unroll
      for (int i = 0; i < kPanel; ++i)
        yr[i] = i < rows ? X[(p0 + i) * kTileLd + lane] : T(0);
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        if (j >= rows) break;
        const T y = yr[j] * inv[p0 + j];
        yr[j] = y;
#pragma unroll
        for (int i = j + 1; i < kPanel; ++i) yr[i] -= D[j * kPanel + i] * y;
      }
#pragma unroll
      for (int i = 0; i < kPanel; ++i)
        if (i < rows) X[(p0 + i) * kTileLd + lane] = yr[i];
    }
    __syncthreads();
    for (int i0 = p0 + rows + warp; i0 < n; i0 += 4 * kRhsWarps) {
      T acc[4];
      const T* Li[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = min(i0 + u * kRhsWarps, n - 1);
        acc[u] = X[i * kTileLd + lane];
        Li[u] = Lp + tri_words(i) + p0;
      }
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        const T y = X[(p0 + j) * kTileLd + lane];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] -= Li[u][j] * y;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kRhsWarps < n) X[(i0 + u * kRhsWarps) * kTileLd + lane] = acc[u];
    }
    __syncthreads();
  }

  // Backward, panels descending: warp 0 solves L^T's diagonal block (D
  // holds it as it is: D[k][i] = L[p0 + k][p0 + i]), then every warp
  // updates its rows above the panel, four rows at a time.
  for (int p0 = ((n - 1) / kPanel) * kPanel; p0 >= 0; p0 -= kPanel) {
    const int rows = min(kPanel, n - p0);
    if (warp == 0) {
      for (int e = lane; e < kPanel * kPanel; e += 32) {
        const int k = e / kPanel, i = e - k * kPanel;
        D[e] = (k < rows && i <= k) ? Lp[tri_words(p0 + k) + p0 + i] : T(0);
      }
      __syncwarp();
      T xr[kPanel];
#pragma unroll
      for (int i = 0; i < kPanel; ++i)
        xr[i] = i < rows ? X[(p0 + i) * kTileLd + lane] : T(0);
#pragma unroll
      for (int k = kPanel - 1; k >= 0; --k) {
        if (k >= rows) continue;
        const T xk = xr[k] * inv[p0 + k];
        xr[k] = xk;
#pragma unroll
        for (int i = 0; i < k; ++i) xr[i] -= D[k * kPanel + i] * xk;
      }
#pragma unroll
      for (int i = 0; i < kPanel; ++i)
        if (i < rows) X[(p0 + i) * kTileLd + lane] = xr[i];
    }
    __syncthreads();
    for (int i0 = warp; i0 < p0; i0 += 4 * kRhsWarps) {
      T acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = X[min(i0 + u * kRhsWarps, p0 - 1) * kTileLd + lane];
#pragma unroll 4
      for (int k = rows - 1; k >= 0; --k) {
        const T* Lk = Lp + tri_words(p0 + k);
        const T xk = X[(p0 + k) * kTileLd + lane];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] -= Lk[min(i0 + u * kRhsWarps, p0 - 1)] * xk;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kRhsWarps < p0) X[(i0 + u * kRhsWarps) * kTileLd + lane] = acc[u];
    }
    __syncthreads();
  }

  for (int c = warp; c < cols; c += kRhsWarps)
    for (int i = lane; i < n; i += 32) x[size_t(b0 + c) * n + i] = X[i * kTileLd + c];
}

// Hopper's shared memory per block, opted into.
constexpr size_t kSmemOptIn = 232448;

// A kernel's attributes (common.cuh::set_smem), set once per device:
// `done` holds one bit per device already configured.
template <typename Kernel>
static cudaError_t configure_once(Kernel kern, size_t dyn_smem, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || ((done >> (dev & 31)) & 1u)) return err;
  err = set_smem(kern, dyn_smem);
  if (err == cudaSuccess) done |= 1u << (dev & 31);
  return err;
}

template <typename T, bool LOWER>
static int launch(const void* L, const void* v, void* x, int B, int n,
                  int l_batched, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const T* Lp = static_cast<const T*>(L);
  const T* vp = static_cast<const T*>(v);
  T* xp = static_cast<T*>(x);
  if (n < 1 || n > kPanel * kMaxSlots) return int(cudaErrorInvalidValue);
  if (l_batched) {
    static unsigned configured = 0;
    auto kern = cho_solve_lanes_kernel<T, LOWER>;
    const cudaError_t err = configure_once(kern, 0, configured);
    if (err != cudaSuccess) return int(err);
    const int grid = (B + kLaneWarps - 1) / kLaneWarps;
    kern<<<grid, kLaneWarps * 32, 0, s>>>(Lp, vp, xp, B, n);
  } else {
    static unsigned configured = 0;
    auto kern = cho_solve_shared_kernel<T, LOWER>;
    const size_t smem = shared_smem_bytes<T>(n);
    const cudaError_t err = configure_once(kern, kSmemOptIn, configured);
    if (err != cudaSuccess) return int(err);
    const int grid = (B + kPanel - 1) / kPanel;
    kern<<<grid, kRhsWarps * 32, smem, s>>>(Lp, vp, xp, B, n);
  }
  return int(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* L, const void* v, void* x, int B, int n,
                    int l_batched, int lower, void* stream) {
  if (lower) return launch<T, true>(L, v, x, B, n, l_batched, stream);
  return launch<T, false>(L, v, x, B, n, l_batched, stream);
}

}  // namespace qpth

// L: (bL, n, n) with bL in {1, B} (l_batched = bL > 1; bL = 1 takes the
// shared-factor kernel): Lt = L^T (upper, lower = 0) or L (lower = 1); v, x:
// (B, n), 1 <= n <= 256. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int qpth_cho_solve_f32(const void* L, const void* v, void* x, int B,
                                  int n, int l_batched, int lower,
                                  void* stream) {
  return qpth::dispatch<float>(L, v, x, B, n, l_batched, lower, stream);
}

extern "C" int qpth_cho_solve_f64(const void* L, const void* v, void* x, int B,
                                  int n, int l_batched, int lower,
                                  void* stream) {
  return qpth::dispatch<double>(L, v, x, B, n, l_batched, lower, stream);
}
