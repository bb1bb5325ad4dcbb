// Grouped W4A4 SwiGLU expert FFN for Hopper (sm_90a): the FP4 expert compute
// of ReaLB's prefill MoE layer, over tokens sorted by expert slot.
//
// Replaces: src/repro/kernels/grouped_fp4_ffn.py, grouped_fp4_ffn_kernel
// (Pallas body _ffn_kernel, _dequant_tile).  Same function: for the rows of
// slot g (counts gs[g], rows in slot order),
//   xq = a4(x); gate, up = xq . deq(W)^T (f32 accumulate, cast to T);
//   h  = T(silu(gate)) * up;  hq = a4(h);  y = T(hq . deq(Wd)^T);
// with deq(W) = T((level * local_scale) * global_scale) and a4 the dynamic
// group-16 activation fake-quant.  Rows outside every slot stay 0.
//
// What bounds it on the H100: at the serving shapes (M ~ 7.7k slot rows of
// a 1024-token prefill chunk, D = 2048, F = 1408, 65 slots) bytes and
// operations about evenly: the packed weights (4.25 bits each) take
// ~0.145 ms at 3.35 TB/s, the bf16 products ~0.134 ms at 989 TFLOP/s.
// H100 has no FP4 tensor cores, so each weight is decoded to bf16 in shared
// memory and multiplied on the bf16 tensor cores (WMMA 16x16x16, f32
// accumulate).  The f32 instantiation (parity checks) multiplies with
// plain f32 FMAs.
//
// Design:
//  * the down product is a kernel of its own.  The Pallas kernel keeps a
//    [bm, D] f32 accumulator resident (1 MiB at bm = 128), which does not
//    fit in 227 KB of shared memory.  Kernel A computes gate/up/SwiGLU/a4
//    for a [64, 64] tile of h and writes hq (type T) to device memory;
//    kernel B computes the down product.  This is numerically the same,
//    because the reference casts hq to T before the down product.
//  * a tile schedule built on the device: block x walks the per-slot counts
//    and takes the x-th 64-row tile of the slot sequence, so empty slots
//    cost nothing and no tile mixes two slots.  The grid is sized by the
//    upper bound ceil(M / 64) + G; surplus blocks exit at once.  The host
//    never reads gs.
//  * a prep kernel applies a4 to x once (xq, type T, to device memory) and
//    flags the rows that hold a nonzero value; a4 of h runs in kernel A's
//    epilogue (a 64-column tile holds whole groups).
//  * a tile whose rows are all zero is skipped by A and B: its output rows
//    are exactly 0 (a4(0) = 0, finite weights), which the caller's zeroed
//    output already holds.  On the serving path these are the pad slot's
//    unfilled capacity rows, most of a prefill chunk's dispatch buffer.
//  * no cp.async/TMA pipelining and no wgmma yet: loads, decode and MMA
//    alternate, separated by __syncthreads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "nvfp4.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;   // rows (tokens) per tile
constexpr int BN = 64;   // output columns per tile
constexpr int NT = 128;  // threads per block: 4 warps, 32 x 32 of C each
constexpr int LDE = BN + 4;  // f32 epilogue row stride

template <typename T>
struct Tiling;
template <>
struct Tiling<__nv_bfloat16> {
  static constexpr int BK = 64;
  static constexpr int LDS = BK + 8;  // keeps WMMA rows 32-byte aligned
};
template <>
struct Tiling<float> {
  static constexpr int BK = 32;
  static constexpr int LDS = BK + 1;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Rounds v to T and back (the reference's .astype(dtype) between stages).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// 16 consecutive T from a 16-byte-aligned address, as f32.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* v) {
  constexpr int PER_VEC = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < nvfp4::GROUP / PER_VEC; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER_VEC; ++i) v[c * PER_VEC + i] = to_f32<T>(e[i]);
  }
}

// 16 consecutive T to a 16-byte-aligned address, from f32.
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* v) {
  constexpr int PER_VEC = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < nvfp4::GROUP / PER_VEC; ++c) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < PER_VEC; ++i) e[i] = from_f32<T>(v[c * PER_VEC + i]);
    reinterpret_cast<uint4*>(dst)[c] = raw;
  }
}

struct Tile {
  int slot;
  int64_t row0;  // first row of the tile in xs
  int nrows;     // rows of the slot in this tile (<= BM)
};

// The blockIdx.x-th 64-row tile of the slot sequence; false past the last.
__device__ bool find_tile(const int* __restrict__ gs, int G, Tile& t) {
  int tile = static_cast<int>(blockIdx.x);
  int64_t off = 0;
  for (int g = 0; g < G; ++g) {
    const int c = max(gs[g], 0);
    const int nt = (c + BM - 1) / BM;
    if (tile < nt) {
      t.slot = g;
      t.row0 = off + static_cast<int64_t>(tile) * BM;
      t.nrows = min(BM, c - tile * BM);
      return true;
    }
    tile -= nt;
    off += c;
  }
  return false;
}

// True when some row of the tile holds a nonzero value (block-uniform).
__device__ bool tile_live(const int* __restrict__ nz, int64_t M,
                          const Tile& t) {
  const int64_t row = t.row0 + threadIdx.x;
  return __syncthreads_or(static_cast<int>(threadIdx.x) < t.nrows && row < M &&
                          nz[row] != 0);
}

// Activation tile [BM rows][BK] of a [M, K] row-major matrix into shared
// memory; rows outside the tile's slot and columns past K are zero.
template <typename T>
__device__ void load_act(const T* __restrict__ src, int64_t M, int64_t K,
                         const Tile& t, int64_t k0, T* __restrict__ dst) {
  constexpr int BK = Tiling<T>::BK, LDS = Tiling<T>::LDS;
  constexpr int NG = BK / nvfp4::GROUP;
  for (int task = threadIdx.x; task < BM * NG; task += NT) {
    const int r = task / NG, gi = task % NG;
    const int64_t row = t.row0 + r;
    const int64_t k = k0 + gi * nvfp4::GROUP;
    float v[nvfp4::GROUP];
    if (r < t.nrows && row < M && k < K) {
      load16<T>(src + row * K + k, v);
    } else {
#pragma unroll
      for (int i = 0; i < nvfp4::GROUP; ++i) v[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i)
      dst[r * LDS + gi * nvfp4::GROUP + i] = from_f32<T>(v[i]);
  }
}

// Weight tile [BN rows n][BK along K] of slot `slot`, decoded from packed
// [G, N, K/2] codes and [G, N, K/16] scales: T((level * s) * gsc).
template <typename T>
__device__ void load_weight(const uint8_t* __restrict__ packed,
                            const float* __restrict__ scales, float gsc,
                            int64_t N, int64_t K, int slot, int64_t n0,
                            int64_t k0, T* __restrict__ dst) {
  constexpr int BK = Tiling<T>::BK, LDS = Tiling<T>::LDS;
  constexpr int NG = BK / nvfp4::GROUP;
  for (int task = threadIdx.x; task < BN * NG; task += NT) {
    const int r = task / NG, gi = task % NG;
    const int64_t n = n0 + r;
    const int64_t k = k0 + gi * nvfp4::GROUP;
    float v[nvfp4::GROUP];
    if (n < N && k < K) {
      const int64_t row = static_cast<int64_t>(slot) * N + n;
      const uint2 raw =
          *reinterpret_cast<const uint2*>(packed + row * (K / 2) + k / 2);
      const float s = scales[row * (K / nvfp4::GROUP) + k / nvfp4::GROUP];
#pragma unroll
      for (int i = 0; i < nvfp4::GROUP; ++i) {
        const uint32_t word = i < 8 ? raw.x : raw.y;
        const uint32_t code = (word >> (4 * (i % 8))) & 0xFu;
        v[i] = (nvfp4::decode_level(code) * s) * gsc;
      }
    } else {
#pragma unroll
      for (int i = 0; i < nvfp4::GROUP; ++i) v[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i)
      dst[r * LDS + gi * nvfp4::GROUP + i] = from_f32<T>(v[i]);
  }
}

// C[BM][BN] += A[BM][BK] . B[BN][BK]^T over one K tile, for NB products that
// share A (gate and up share xq).  bf16: WMMA on the tensor cores, each warp
// a 32 x 32 quarter of C.  f32: FMAs, each thread 8 rows x 4 columns.
template <typename T, int NB>
struct Mma;

template <int NB>
struct Mma<__nv_bfloat16, NB> {
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  FragC acc[NB][2][2];

  __device__ void zero() {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[b][i][j], 0.0f);
  }

  __device__ void step(const __nv_bfloat16* A,
                       const __nv_bfloat16* const* B) {
    constexpr int BK = Tiling<__nv_bfloat16>::BK;
    constexpr int LDS = Tiling<__nv_bfloat16>::LDS;
    const int warp = threadIdx.x / 32;
    const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], A + (wr + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fb, B[b] + (wc + j * 16) * LDS + kk, LDS);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[b][i][j], a[i], fb, acc[b][i][j]);
        }
    }
  }

  __device__ void store(float* const* C) {
    const int warp = threadIdx.x / 32;
    const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(C[b] + (wr + i * 16) * LDE + wc + j * 16,
                                  acc[b][i][j], LDE, wmma::mem_row_major);
  }
};

template <int NB>
struct Mma<float, NB> {
  float acc[NB][8][4];

  __device__ void zero() {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][i][j] = 0.0f;
  }

  __device__ void step(const float* A, const float* const* B) {
    constexpr int BK = Tiling<float>::BK, LDS = Tiling<float>::LDS;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int kk = 0; kk < BK; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(ty * 8 + i) * LDS + kk];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = B[b][(tx * 4 + j) * LDS + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[b][i][j] = fmaf(a[i], bv[j], acc[b][i][j]);
      }
    }
  }

  __device__ void store(float* const* C) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          C[b][(ty * 8 + i) * LDE + tx * 4 + j] = acc[b][i][j];
  }
};

template <typename T>
__host__ __device__ constexpr int input_tile_bytes(int n_tiles) {
  return n_tiles * BM * Tiling<T>::LDS * static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr int epilogue_bytes(int n_tiles) {
  return n_tiles * BM * LDE * static_cast<int>(sizeof(float));
}
__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}

constexpr int PREP_ROWS = 8;  // one warp per row

// Prep: xq = T(a4(x)) and nz[row] = any(x[row] != 0).
template <typename T>
__global__ void __launch_bounds__(PREP_ROWS * 32)
    ffn_prep_kernel(const T* __restrict__ xs, T* __restrict__ xq,
                    int* __restrict__ nz, int64_t M, int64_t D) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * PREP_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;  // whole warps
  bool any = false;
  for (int64_t k = lane * nvfp4::GROUP; k < D; k += 32 * nvfp4::GROUP) {
    float v[nvfp4::GROUP];
    load16<T>(xs + row * D + k, v);
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i) any |= v[i] != 0.0f;
    nvfp4::fake_quant_a4_group(v);
    store16<T>(xq + row * D + k, v);
  }
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) nz[row] = any ? 1 : 0;
}

// Kernel A: hq[rows, f0:f0+64] = a4(T(silu(T(xq.Wg^T))) * T(xq.Wu^T)).
template <typename T>
__global__ void __launch_bounds__(NT)
    ffn_gate_up_kernel(const T* __restrict__ xq, const int* __restrict__ nz,
                       const int* __restrict__ gs,
                       int G, const uint8_t* __restrict__ gate_packed,
                       const float* __restrict__ gate_scales,
                       const uint8_t* __restrict__ up_packed,
                       const float* __restrict__ up_scales,
                       const float* __restrict__ gscales, T* __restrict__ hq,
                       int64_t M, int64_t D, int64_t F) {
  constexpr int BK = Tiling<T>::BK, LDS = Tiling<T>::LDS;
  constexpr int SMEM = cmax(input_tile_bytes<T>(3), epilogue_bytes(2));
  __shared__ __align__(128) unsigned char smem[SMEM];
  Tile t;
  if (!find_tile(gs, G, t) || !tile_live(nz, M, t)) return;
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * BN;
  T* xt = reinterpret_cast<T*>(smem);
  T* wg = xt + BM * LDS;
  T* wu = wg + BN * LDS;
  const T* wts[2] = {wg, wu};
  const float g_scale = gscales[0], u_scale = gscales[1];

  Mma<T, 2> mma;
  mma.zero();
  for (int64_t k0 = 0; k0 < D; k0 += BK) {
    load_act<T>(xq, M, D, t, k0, xt);
    load_weight<T>(gate_packed, gate_scales, g_scale, F, D, t.slot, f0, k0,
                   wg);
    load_weight<T>(up_packed, up_scales, u_scale, F, D, t.slot, f0, k0, wu);
    __syncthreads();
    mma.step(xt, wts);
    __syncthreads();
  }
  float* gate = reinterpret_cast<float*>(smem);  // aliases the input tiles
  float* up = gate + BM * LDE;
  float* outs[2] = {gate, up};
  mma.store(outs);
  __syncthreads();

  constexpr int NG = BN / nvfp4::GROUP;
  for (int task = threadIdx.x; task < BM * NG; task += NT) {
    const int r = task / NG, gi = task % NG;
    const int64_t row = t.row0 + r;
    const int64_t f = f0 + gi * nvfp4::GROUP;
    if (r >= t.nrows || row >= M || f >= F) continue;
    float v[nvfp4::GROUP];
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i) {
      const float g = round_to<T>(gate[r * LDE + gi * nvfp4::GROUP + i]);
      const float u = round_to<T>(up[r * LDE + gi * nvfp4::GROUP + i]);
      const float act = round_to<T>(g * (1.0f / (1.0f + expf(-g))));
      v[i] = round_to<T>(act * u);
    }
    nvfp4::fake_quant_a4_group(v);
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i)
      hq[row * F + f + i] = from_f32<T>(v[i]);
  }
}

// Kernel B: out[rows, d0:d0+64] = T(hq . Wd^T).
template <typename T>
__global__ void __launch_bounds__(NT)
    ffn_down_kernel(const T* __restrict__ hq, const int* __restrict__ nz,
                    const int* __restrict__ gs, int G, const uint8_t* __restrict__ down_packed,
                    const float* __restrict__ down_scales,
                    const float* __restrict__ gscales, T* __restrict__ out,
                    int64_t M, int64_t D, int64_t F) {
  constexpr int BK = Tiling<T>::BK, LDS = Tiling<T>::LDS;
  constexpr int SMEM = cmax(input_tile_bytes<T>(2), epilogue_bytes(1));
  __shared__ __align__(128) unsigned char smem[SMEM];
  Tile t;
  if (!find_tile(gs, G, t) || !tile_live(nz, M, t)) return;
  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * BN;
  T* ht = reinterpret_cast<T*>(smem);
  T* wd = ht + BM * LDS;
  const T* wts[1] = {wd};
  const float d_scale = gscales[2];

  Mma<T, 1> mma;
  mma.zero();
  for (int64_t k0 = 0; k0 < F; k0 += BK) {
    load_act<T>(hq, M, F, t, k0, ht);
    load_weight<T>(down_packed, down_scales, d_scale, D, F, t.slot, d0, k0,
                   wd);
    __syncthreads();
    mma.step(ht, wts);
    __syncthreads();
  }
  float* y = reinterpret_cast<float*>(smem);
  float* outs[1] = {y};
  mma.store(outs);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    const int64_t row = t.row0 + r;
    const int64_t d = d0 + c;
    if (r < t.nrows && row < M && d < D)
      out[row * D + d] = from_f32<T>(y[r * LDE + c]);
  }
}

template <typename T>
int launch(const void* xs, const void* gs, int64_t G, const void* gate_packed,
           const void* gate_scales, const void* up_packed,
           const void* up_scales, const void* down_packed,
           const void* down_scales, const void* gscales, void* xq, void* nz,
           void* hq, void* out, int64_t M, int64_t D, int64_t F,
           void* stream) {
  if (M == 0 || G == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ffn_prep_kernel<T><<<static_cast<unsigned>((M + PREP_ROWS - 1) / PREP_ROWS),
                       PREP_ROWS * 32, 0, s>>>(
      static_cast<const T*>(xs), static_cast<T*>(xq), static_cast<int*>(nz),
      M, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // upper bound of sum_g ceil(gs[g] / BM) when sum_g gs[g] <= M
  const unsigned row_tiles = static_cast<unsigned>((M + BM - 1) / BM + G);
  const dim3 grid_a(row_tiles, static_cast<unsigned>((F + BN - 1) / BN));
  ffn_gate_up_kernel<T><<<grid_a, NT, 0, s>>>(
      static_cast<const T*>(xq), static_cast<const int*>(nz),
      static_cast<const int*>(gs), static_cast<int>(G),
      static_cast<const uint8_t*>(gate_packed),
      static_cast<const float*>(gate_scales),
      static_cast<const uint8_t*>(up_packed),
      static_cast<const float*>(up_scales),
      static_cast<const float*>(gscales), static_cast<T*>(hq), M, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(row_tiles, static_cast<unsigned>((D + BN - 1) / BN));
  ffn_down_kernel<T><<<grid_b, NT, 0, s>>>(
      static_cast<const T*>(hq), static_cast<const int*>(nz),
      static_cast<const int*>(gs), static_cast<int>(G),
      static_cast<const uint8_t*>(down_packed),
      static_cast<const float*>(down_scales),
      static_cast<const float*>(gscales), static_cast<T*>(out), M, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xs: [M, D] rows sorted by slot; gs: int32 [G] rows per slot (sum <= M);
// gate/up: u8 [G, F, D/2] + f32 [G, F, D/16]; down: u8 [G, D, F/2] + f32
// [G, D, F/16]; gscales: f32 [3] (gate, up, down) on the device; scratch:
// xq [M, D] and hq [M, F] of the input type, nz int32 [M]; out: [M, D],
// zeroed by the caller (rows outside every slot, and all-zero tiles, are not
// written).  D and F must be multiples of 32; all arrays contiguous.
// Returns cudaGetLastError() after the launches.
int grouped_fp4_ffn_bf16(const void* xs, const void* gs, int64_t G,
                         const void* gate_packed, const void* gate_scales,
                         const void* up_packed, const void* up_scales,
                         const void* down_packed, const void* down_scales,
                         const void* gscales, void* xq, void* nz, void* hq,
                         void* out, int64_t M, int64_t D, int64_t F,
                         void* stream) {
  return launch<__nv_bfloat16>(xs, gs, G, gate_packed, gate_scales, up_packed,
                               up_scales, down_packed, down_scales, gscales,
                               xq, nz, hq, out, M, D, F, stream);
}

int grouped_fp4_ffn_f32(const void* xs, const void* gs, int64_t G,
                        const void* gate_packed, const void* gate_scales,
                        const void* up_packed, const void* up_scales,
                        const void* down_packed, const void* down_scales,
                        const void* gscales, void* xq, void* nz, void* hq,
                        void* out, int64_t M, int64_t D, int64_t F,
                        void* stream) {
  return launch<float>(xs, gs, G, gate_packed, gate_scales, up_packed,
                       up_scales, down_packed, down_scales, gscales, xq, nz,
                       hq, out, M, D, F, stream);
}

}  // extern "C"
