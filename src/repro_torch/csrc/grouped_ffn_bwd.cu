// Backward of the grouped SwiGLU expert FFN with plain (BF16, or f32 for
// parity checks) expert weights: the gradient of the MoE layer's expert
// compute in training.
//
// Replaces no Pallas kernel.  The reference trains through XLA's transpose
// of the three jax.lax.ragged_dot calls of _grouped_ffn
// (src/repro/core/ep_moe.py:325-335, the BF16 branch that train=True
// takes); the port's forward is the hand-written grouped_ffn kernel, so its
// gradient is a kernel too.  For the rows of slot g (counts gs[g], rows in
// slot order), with T the rounding to the input type and every product
// accumulated in f32, the chain of jax.vjp (each cotangent in its primal's
// type, the two cotangents of x added in T):
//   g = T(x.Wg), u = T(x.Wu), a = T(silu(g)), h = T(a * u)   the forward's
//   dh = T(dy.Wd^T)
//   da = T(dh * u), du = T(dh * a)
//   dg = T(da * s * (1 + g * (1 - s))), s = sigmoid(g)       derivative in f32
//   dx = T(T(dg.Wg^T) + T(du.Wu^T))
//   dWg = T(x^T.dg), dWu = T(x^T.du), dWd = T(h^T.dy) over the slot's rows.
// Rows past sum(gs) and rows of slots g >= Gw give dx = 0 and add nothing
// to any weight gradient (slots past Gw have no weights: the MoE layer's
// pad slot of unfilled capacity rows).
//
// Two designs.  The bf16 entry, the training path's, is the Hopper design
// on the tensor cores in grouped_ffn_bwd_sm90.cuh (its header says what
// bounds it and how).  The f32 entry is the parity path (f32 training of
// small models, the card-against-CPU checks), in which every T is the
// identity: the first design below, on the f32 FMA units.
//  * three kernels.  (a) one block per (64-row tile of one slot, 64
//    columns of F) recomputes g and u over D and dh over D in one loop,
//    applies the SwiGLU derivative and writes dg, du and h to f32 [M, F]
//    scratch; (b) one block per (row tile, 64 columns of D) computes dx
//    over F from dg and du; (c) one block per (slot, 64 x 64 tile of the
//    weight gradient, which of the three) loops over the slot's rows 16 at
//    a time.
//  * a tile schedule built on the device: block x of (a) and (b) walks the
//    counts and takes the x-th 64-row tile of the slot sequence, so no
//    tile mixes two slots and empty slots cost nothing; the grid is sized
//    by the bound ceil(M / 64) + G and surplus blocks exit.  A slot of (c)
//    with no rows exits at once.  The caller zeroes dx and the weight
//    gradients.
//  * each block of 256 threads holds a 64 x 64 f32 tile, 4 x 4 a thread,
//    from 16-deep operand tiles in shared memory.
//  * compensated depth sums: each 16-deep slice of a product is summed
//    apart and folded into the running sum with Kahan's compensation, so
//    the running sum's rounding does not grow with the depth.  A plain
//    FMA chain over D = 2048 (moonshot's width) put dx 2.9x as far from
//    an f64 evaluation as cuBLAS's f32 GEMMs, and 5.8x as far as the
//    reference's f32 jax.vjp.
// No cuBLAS and no library GEMM: every product is written here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped_ffn_bwd_sm90.cuh"

namespace {

constexpr int BM = 64;   // rows per tile (a, b); rows of m (c)
constexpr int BN = 64;   // columns per tile
constexpr int BK = 16;   // depth of one operand tile
constexpr int NT = 256;  // threads: 16 x 16, 4 x 4 outputs each
constexpr int LDT = BM + 4;  // shared row stride, float4 aligned

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// v rounded to T and back (the forward's casts between its stages).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// The 64-row tile that block `tile` owns: its slot, first row and row
// count; slot -1 when the block has no tile (past the last one, or in a
// slot without weights).  Rows are laid out slot after slot.
struct Tile {
  int slot;
  int nrows;
  int64_t row0;
};

__device__ Tile find_tile(const int* __restrict__ gs, int G, int Gw,
                          int64_t M, int64_t tile) {
  int64_t row0 = 0;
  for (int g = 0; g < min(G, Gw); ++g) {
    const int64_t n = max64(gs[g], 0);
    const int64_t tiles = (n + BM - 1) / BM;
    if (tile < tiles) {
      Tile t;
      t.slot = g;
      t.row0 = row0 + tile * BM;
      const int64_t left = min64(n - tile * BM, M - t.row0);
      t.nrows = static_cast<int>(min64(left, BM));
      if (t.nrows <= 0) t.slot = -1;
      return t;
    }
    tile -= tiles;
    row0 += n;
  }
  Tile t;
  t.slot = -1;
  t.nrows = 0;
  t.row0 = 0;
  return t;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// part[i][j] += a[k][ty*4+i] * b[k][tx*4+j] over the tile's depth.
__device__ __forceinline__ void mma_tile(float (*a)[LDT], float (*b)[LDT],
                                         float (&part)[4][4], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float av[4], bv[4];
    load4(&a[k][ty * 4], av);
    load4(&b[k][tx * 4], bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[i][j] = fmaf(av[i], bv[j], part[i][j]);
  }
}

// A running depth sum of 4 x 4 outputs with Kahan's compensation.
struct KahanTile {
  float sum[4][4];
  float comp[4][4];
  float part[4][4];  // the slice being summed (mma_tile's target)

  __device__ __forceinline__ KahanTile() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[i][j] = comp[i][j] = part[i][j] = 0.0f;
  }

  // sum += part, compensated; part = 0.
  __device__ __forceinline__ void fold() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = part[i][j] - comp[i][j];
        const float t = sum[i][j] + y;
        comp[i][j] = (t - sum[i][j]) - y;
        sum[i][j] = t;
        part[i][j] = 0.0f;
      }
  }
};

// dst[k][r] = src[(row0 + r) * ld + k0 + k] for r < nrows (0 past them):
// a 64 x 16 tile of rows, transposed.
template <typename S>
__device__ __forceinline__ void load_rows_t(float (*dst)[LDT],
                                            const S* __restrict__ src,
                                            int64_t row0, int nrows,
                                            int64_t ld, int64_t k0,
                                            int64_t kmax) {
  for (int e = threadIdx.x; e < BM * BK; e += NT) {
    const int r = e / BK, k = e % BK;
    float v = 0.0f;
    if (r < nrows && k0 + k < kmax) v = to_f32<S>(src[(row0 + r) * ld + k0 + k]);
    dst[k][r] = v;
  }
}

// dst[k][c] = w[(k0 + k) * ld + c0 + c] for c0 + c < cmax: a 16 x 64 tile
// of a row-major matrix whose rows are the depth.
template <typename S>
__device__ __forceinline__ void load_depth_rows(float (*dst)[LDT],
                                                const S* __restrict__ w,
                                                int64_t ld, int64_t k0,
                                                int64_t kmax, int64_t c0,
                                                int64_t cmax) {
  for (int e = threadIdx.x; e < BK * BN; e += NT) {
    const int k = e / BN, c = e % BN;
    float v = 0.0f;
    if (c0 + c < cmax && k0 + k < kmax) v = to_f32<S>(w[(k0 + k) * ld + c0 + c]);
    dst[k][c] = v;
  }
}

// dst[k][c] = w[(c0 + c) * ld + k0 + k]: a 16 x 64 tile of a row-major
// matrix whose columns are the depth (the transposed operand).
template <typename S>
__device__ __forceinline__ void load_depth_cols(float (*dst)[LDT],
                                                const S* __restrict__ w,
                                                int64_t ld, int64_t k0,
                                                int64_t kmax, int64_t c0,
                                                int64_t cmax) {
  for (int e = threadIdx.x; e < BK * BN; e += NT) {
    const int c = e / BK, k = e % BK;
    float v = 0.0f;
    if (c0 + c < cmax && k0 + k < kmax) v = to_f32<S>(w[(c0 + c) * ld + k0 + k]);
    dst[k][c] = v;
  }
}

// (a): g, u and dh of a [64, 64] tile of [rows, F]; writes dg, du and h.
template <typename T>
__global__ void __launch_bounds__(NT)
    bwd_act_kernel(const T* __restrict__ xs, const T* __restrict__ dy,
                   const int* __restrict__ gs, int G, int Gw,
                   const T* __restrict__ wg, const T* __restrict__ wu,
                   const T* __restrict__ wd, float* __restrict__ dg_out,
                   float* __restrict__ du_out, float* __restrict__ h_out,
                   int64_t M, int64_t D, int64_t F) {
  __shared__ Tile tile;
  __shared__ __align__(16) float x_t[BK][LDT];
  __shared__ __align__(16) float dy_t[BK][LDT];
  __shared__ __align__(16) float wg_s[BK][LDT];
  __shared__ __align__(16) float wu_s[BK][LDT];
  __shared__ __align__(16) float wd_s[BK][LDT];
  if (threadIdx.x == 0) tile = find_tile(gs, G, Gw, M, blockIdx.x);
  __syncthreads();
  const Tile t = tile;
  if (t.slot < 0) return;  // block-uniform
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * BN;
  const T* wg_g = wg + static_cast<int64_t>(t.slot) * D * F;
  const T* wu_g = wu + static_cast<int64_t>(t.slot) * D * F;
  const T* wd_g = wd + static_cast<int64_t>(t.slot) * F * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  KahanTile accg, accu, accd;
  for (int64_t k0 = 0; k0 < D; k0 += BK) {
    load_rows_t<T>(x_t, xs, t.row0, t.nrows, D, k0, D);
    load_rows_t<T>(dy_t, dy, t.row0, t.nrows, D, k0, D);
    load_depth_rows<T>(wg_s, wg_g, F, k0, D, f0, F);   // Wg [D, F]
    load_depth_rows<T>(wu_s, wu_g, F, k0, D, f0, F);
    load_depth_cols<T>(wd_s, wd_g, D, k0, D, f0, F);   // Wd [F, D]
    __syncthreads();
    mma_tile(x_t, wg_s, accg.part, ty, tx);
    mma_tile(x_t, wu_s, accu.part, ty, tx);
    mma_tile(dy_t, wd_s, accd.part, ty, tx);
    accg.fold();
    accu.fold();
    accd.fold();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= t.nrows) continue;
    const int64_t row = t.row0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t f = f0 + tx * 4 + j;
      if (f >= F) continue;
      const float g = round_to<T>(accg.sum[i][j]);
      const float u = round_to<T>(accu.sum[i][j]);
      const float s = 1.0f / (1.0f + expf(-g));
      const float a = round_to<T>(g * s);
      const float h = round_to<T>(a * u);
      const float dh = accd.sum[i][j];
      dg_out[row * F + f] = dh * u * (s * (1.0f + g * (1.0f - s)));
      du_out[row * F + f] = dh * a;
      h_out[row * F + f] = h;
    }
  }
}

// (b): dx of a [64, 64] tile of [rows, D] from dg and du.
template <typename T>
__global__ void __launch_bounds__(NT)
    bwd_dx_kernel(const float* __restrict__ dg, const float* __restrict__ du,
                  const int* __restrict__ gs, int G, int Gw,
                  const T* __restrict__ wg, const T* __restrict__ wu,
                  T* __restrict__ dx, int64_t M, int64_t D, int64_t F) {
  __shared__ Tile tile;
  __shared__ __align__(16) float dg_t[BK][LDT];
  __shared__ __align__(16) float du_t[BK][LDT];
  __shared__ __align__(16) float wg_s[BK][LDT];
  __shared__ __align__(16) float wu_s[BK][LDT];
  if (threadIdx.x == 0) tile = find_tile(gs, G, Gw, M, blockIdx.x);
  __syncthreads();
  const Tile t = tile;
  if (t.slot < 0) return;  // block-uniform
  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * BN;
  const T* wg_g = wg + static_cast<int64_t>(t.slot) * D * F;
  const T* wu_g = wu + static_cast<int64_t>(t.slot) * D * F;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  KahanTile acc;
  for (int64_t k0 = 0; k0 < F; k0 += BK) {
    load_rows_t<float>(dg_t, dg, t.row0, t.nrows, F, k0, F);
    load_rows_t<float>(du_t, du, t.row0, t.nrows, F, k0, F);
    load_depth_cols<T>(wg_s, wg_g, F, k0, F, d0, D);   // Wg^T: Wg [D, F]
    load_depth_cols<T>(wu_s, wu_g, F, k0, F, d0, D);
    __syncthreads();
    mma_tile(dg_t, wg_s, acc.part, ty, tx);
    mma_tile(du_t, wu_s, acc.part, ty, tx);
    acc.fold();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= t.nrows) continue;
    const int64_t row = t.row0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t d = d0 + tx * 4 + j;
      if (d < D) dx[row * D + d] = from_f32<T>(acc.sum[i][j]);
    }
  }
}

// One weight gradient: out[slot] [Ma, Nb] = A[rows]^T . B[rows], A [M, Ma]
// and B [M, Nb] row-major, each of type T or f32.
struct DwJob {
  const void* a;
  const void* b;
  void* out;
  int64_t ma, nb;
  bool a_f32, b_f32;
};

struct DwJobs {
  DwJob job[3];
};

template <typename T>
__device__ __forceinline__ float load_as(const void* p, bool f32, int64_t i) {
  return f32 ? static_cast<const float*>(p)[i]
             : to_f32<T>(static_cast<const T*>(p)[i]);
}

// (c): one 64 x 64 tile of one weight gradient of one slot.
template <typename T>
__global__ void __launch_bounds__(NT)
    bwd_dw_kernel(DwJobs jobs, const int* __restrict__ gs, int G, int64_t M) {
  __shared__ __align__(16) float a_s[BK][LDT];
  __shared__ __align__(16) float b_s[BK][LDT];
  __shared__ int64_t s_row0, s_rows;
  const DwJob job = jobs.job[blockIdx.z];
  const int slot = blockIdx.y;
  if (threadIdx.x == 0) {
    int64_t row0 = 0;
    for (int g = 0; g < min(slot, G); ++g) row0 += max64(gs[g], 0);
    const int64_t n = slot < G ? max64(gs[slot], 0) : 0;
    s_row0 = row0;
    s_rows = max64(min64(n, M - row0), 0);
  }
  __syncthreads();
  const int64_t row0 = s_row0, rows = s_rows;
  if (rows == 0) return;  // block-uniform; the caller zeroed the output
  const int64_t tiles_n = (job.nb + BN - 1) / BN;
  const int64_t m0 = (blockIdx.x / tiles_n) * BM;
  const int64_t n0 = (blockIdx.x % tiles_n) * BN;
  if (m0 >= job.ma) return;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  KahanTile acc;
  for (int64_t r0 = 0; r0 < rows; r0 += BK) {
    for (int e = threadIdx.x; e < BK * BM; e += NT) {
      const int k = e / BM, c = e % BM;
      const int64_t row = row0 + r0 + k;
      const bool in = r0 + k < rows;
      a_s[k][c] = in && m0 + c < job.ma
                      ? load_as<T>(job.a, job.a_f32, row * job.ma + m0 + c)
                      : 0.0f;
      b_s[k][c] = in && n0 + c < job.nb
                      ? load_as<T>(job.b, job.b_f32, row * job.nb + n0 + c)
                      : 0.0f;
    }
    __syncthreads();
    mma_tile(a_s, b_s, acc.part, ty, tx);
    acc.fold();
    __syncthreads();
  }
  T* out = static_cast<T*>(job.out) + static_cast<int64_t>(slot) * job.ma * job.nb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= job.ma) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx * 4 + j;
      if (n < job.nb) out[m * job.nb + n] = from_f32<T>(acc.sum[i][j]);
    }
  }
}

template <typename T>
int launch(const void* xs, const void* gs, int64_t G, int64_t Gw,
           const void* w_gate, const void* w_up, const void* w_down,
           const void* dy, void* dg, void* du, void* h, void* dxs,
           void* dw_gate, void* dw_up, void* dw_down, int64_t M, int64_t D,
           int64_t F, void* stream) {
  if (M == 0 || G == 0 || Gw == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gsi = static_cast<const int*>(gs);
  const int g = static_cast<int>(G), gw = static_cast<int>(Gw);
  // upper bound of sum_g ceil(gs[g] / BM) when sum_g gs[g] <= M
  const unsigned row_tiles = static_cast<unsigned>((M + BM - 1) / BM + G);
  const dim3 grid_a(row_tiles, static_cast<unsigned>((F + BN - 1) / BN));
  bwd_act_kernel<T><<<grid_a, NT, 0, s>>>(
      static_cast<const T*>(xs), static_cast<const T*>(dy), gsi, g, gw,
      static_cast<const T*>(w_gate), static_cast<const T*>(w_up),
      static_cast<const T*>(w_down), static_cast<float*>(dg),
      static_cast<float*>(du), static_cast<float*>(h), M, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(row_tiles, static_cast<unsigned>((D + BN - 1) / BN));
  bwd_dx_kernel<T><<<grid_b, NT, 0, s>>>(
      static_cast<const float*>(dg), static_cast<const float*>(du), gsi, g,
      gw, static_cast<const T*>(w_gate), static_cast<const T*>(w_up),
      static_cast<T*>(dxs), M, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  DwJobs jobs;
  jobs.job[0] = DwJob{xs, dg, dw_gate, D, F, false, true};
  jobs.job[1] = DwJob{xs, du, dw_up, D, F, false, true};
  jobs.job[2] = DwJob{h, dy, dw_down, F, D, true, false};
  // the same tile count for [D, F] and [F, D]
  const unsigned tiles = static_cast<unsigned>(((D + BM - 1) / BM) *
                                               ((F + BN - 1) / BN));
  const dim3 grid_c(tiles, static_cast<unsigned>(Gw), 3);
  bwd_dw_kernel<T><<<grid_c, NT, 0, s>>>(jobs, gsi, g, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xs, dy: [M, D] rows sorted by slot, of type T; gs: int32 [G] rows per
// slot (sum <= M), slots g >= Gw have no weights; w_gate, w_up [Gw, D, F]
// and w_down [Gw, F, D] of type T; scratch dg, du, h: [M, F] of type T
// (bf16) or f32 (f32); outputs dxs [M, D] and dw_gate, dw_up [Gw, D, F],
// dw_down [Gw, F, D] of type T.  D and F multiples of 32; all arrays
// contiguous and 16-byte aligned.  bf16: M > 0, Gw > 0, Gw <= G <= 512;
// every element of the outputs is written.  f32: the caller zeroes the
// outputs (rows and slots without work are not written).  Returns
// cudaGetLastError() after the launches.
int grouped_ffn_bwd_bf16(const void* xs, const void* gs, int64_t G,
                         int64_t Gw, const void* w_gate, const void* w_up,
                         const void* w_down, const void* dy, void* dg,
                         void* du, void* h, void* dxs, void* dw_gate,
                         void* dw_up, void* dw_down, int64_t M, int64_t D,
                         int64_t F, void* stream) {
  return sm90::bwd::launch(xs, gs, G, Gw, w_gate, w_up, w_down, dy, dg, du,
                           h, dxs, dw_gate, dw_up, dw_down, M, D, F,
                           static_cast<cudaStream_t>(stream));
}

int grouped_ffn_bwd_f32(const void* xs, const void* gs, int64_t G, int64_t Gw,
                        const void* w_gate, const void* w_up,
                        const void* w_down, const void* dy, void* dg,
                        void* du, void* h, void* dxs, void* dw_gate,
                        void* dw_up, void* dw_down, int64_t M, int64_t D,
                        int64_t F, void* stream) {
  return launch<float>(xs, gs, G, Gw, w_gate, w_up, w_down, dy, dg, du, h,
                       dxs, dw_gate, dw_up, dw_down, M, D, F, stream);
}

}  // extern "C"
