// Grouped SwiGLU expert FFN for Hopper (sm_90a): the expert compute of
// ReaLB's MoE layer over tokens sorted by expert slot, with FP4 (W4A4) or
// plain (BF16, or f32 for parity checks) expert weights.
//
// Replaces, FP4 entries: src/repro/kernels/grouped_fp4_ffn.py,
// grouped_fp4_ffn_kernel (Pallas body _ffn_kernel, _dequant_tile).  Same
// function: for the rows of slot g (counts gs[g], rows in slot order),
//   xq = a4(x); gate, up = xq . deq(W)^T (f32 accumulate, cast to T);
//   h  = T(silu(gate)) * up;  hq = a4(h);  y = T(hq . deq(Wd)^T);
// with deq(W) = T((level * local_scale) * global_scale) and a4 the dynamic
// group-16 activation fake-quant.
// Plain entries (grouped_ffn_*): the reference's BF16 branch _grouped_ffn
// (src/repro/core/ep_moe.py:328), three jax.lax.ragged_dot calls, which XLA
// and not Pallas computes: the same schedule and rounding without a4, with
// weights w_gate/w_up [G, D, F] and w_down [G, F, D] of type T.
// Rows outside every slot stay 0, and so do the rows of slots g >= Gw (slots
// without weights: the MoE layer's pad slot of unfilled capacity rows, whose
// rows are zero, so the reference's output there is 0 too).
//
// The device-side branch.  ReaLB picks FP4 or BF16 per MoE layer on the
// device (the reference's lax.cond).  The MoE layer launches both variants,
// the FP4 one with counts gs * f and the plain one with gs * (1 - f); with
// all-zero counts every block finds no work and exits, and the prep kernel
// stops at row sum(gs) = 0.  The host never reads gs or f.
//
// What bounds it on the H100: bytes.  At the serving shapes (D = 2048,
// F = 1408, 64 slots with weights plus the pad slot) the codes and their
// f32 scales (6 bits a weight, 0.415 GB over 64 live slots) and x and y of
// the 15360-row dispatch buffer (0.126 GB) take 0.16 ms at 3.35 TB/s,
// while the bf16 products of a prefill chunk's 1-6k routed rows need
// 0.02-0.1 ms at 989 TFLOP/s.  H100 has no FP4 tensor cores, so every
// weight is decoded to bf16 in shared memory; that decode (~4 instructions
// a weight) costs about as much issue time as the bytes take, so it has to
// run while the loads and the tensor cores work.
//
// The bf16 FP4 entry (grouped_fp4_ffn_sm90.cuh), the serving path:
//  * swap A and B: Y^T = W . X^T.  Weight rows take wgmma's 64-row M side,
//    a slot's tokens its N side, rounded up to 8, 16, 32 or 64 (a slot of
//    17 rows pads to 32, not to a 64-row tile, and decode's 8 rows a slot
//    fill N = 8 exactly).  Both operands are K-major bf16 in the 128-byte
//    swizzle, read by wgmma.mma_async m64nNk16 with f32 accumulators.
//  * a work item is two parts of 64 weight rows, one a warpgroup: 64 rows
//    of gate and the same rows of up (warpgroup 1 hands its accumulators
//    to warpgroup 0 through shared memory for the epilogue), or 128 rows
//    of down.  One accumulator of N/2 registers a thread keeps a block
//    under 128 registers and 113 KB, so two blocks share an SM and each
//    fills the other's waits (one block per SM, each warpgroup holding
//    gate and up of 64 rows: 0.44 ms on the decode shape, against 0.37
//    with two blocks).
//  * a pipeline per work item, stages of 64 along K: thread 0 brings the
//    packed codes of both parts, 128 along K at a time (64 bytes a row),
//    into a ring of 3 and each stage's token tile into a ring of 4 with
//    TMA (tensor maps encoded on the host, cuTensorMapEncodeTiled taken
//    through cudaGetDriverEntryPoint, so no -lcuda; the token tile lands
//    in the 128-byte swizzle that wgmma reads), completing on mbarriers;
//    the scales come by 8-byte cp.async, two a thread, as TMA takes row
//    strides in multiples of 16 bytes and theirs are K/4.  At stage s all
//    256 threads decode stage s+1 into the other of two swizzled bf16
//    tiles while the tensor cores multiply stage s; one barrier a stage.  (clock64 marks in a test build, on the decode shape
//    with 16-byte cp.async for every copy: of ~2250 cycles a stage, 630
//    went to issuing the copies, 1100 to the decode, 230 to the wgmma
//    issue and 300 to the barrier and waits; TMA took 8-13 % off the
//    launch.)  The decode takes, per group of 16, the bf16 bits of its
//    eight magnitudes T((level * s) * gsc) from a table that each block
//    builds once for all 127 E4M3 scales (built on the spot for a scale
//    off that grid), and looks codes up with byte permutes: no
//    int-to-float or float-to-bf16 conversion per weight (conversions
//    issue at a quarter of the rate; a first version converting each
//    weight ran 2x slower).  A slot with more than 64 rows loops over its
//    token tiles; otherwise each weight is decoded once per launch.
//  * a persistent schedule built on the device: two blocks per SM; warp 0
//    scans the counts into item and row offsets in shared memory and the
//    block walks the items (slot < Gw, weight tile, token tile) by a
//    stride of the grid.  With all-zero counts every block scans and
//    exits: one wave.
//  * gate/up's epilogue applies SwiGLU and a4 of h on the accumulators (a
//    warp holds 16 consecutive F rows of each token column: one a4 group,
//    reduced over the 8 lanes with equal lane % 4 by three shuffles) and
//    writes hq [M, F]; the down product is a second persistent kernel of
//    the same design.
//  * a4 of x runs once per routed row in a grid-stride prep kernel (4
//    blocks per SM) into xq: in the token-tile loader it would be computed
//    again for every weight tile (22 times for gate/up), and the token
//    tiles could not come by cp.async.
// The bf16 plain entry (grouped_ffn_sm90.cuh), the serving path's BF16
// branch: the same schedule and swap, with the bf16 weights streamed by TMA
// straight from device memory into wgmma's MN-major A operand (that
// header says why); the code both designs share is in sm90_common.cuh.
// The f32 entries (parity checks only) keep the first design below.
//
// First design (f32 entries):
//  * the down product is a kernel of its own.  The Pallas kernel keeps a
//    [bm, D] f32 accumulator resident (1 MiB at bm = 128), which does not
//    fit in 227 KB of shared memory.  Kernel A computes gate/up/SwiGLU(/a4)
//    for a [64, 64] tile of h and writes hq (type T) to device memory;
//    kernel B computes the down product.  This is numerically the same,
//    because the reference casts h to T before the down product.
//  * a tile schedule built on the device: block x walks the per-slot counts
//    and takes the x-th 64-row tile of the slot sequence, so empty slots
//    cost nothing and no tile mixes two slots.  The grid is sized by the
//    upper bound ceil(M / 64) + G; surplus blocks exit at once.
//  * a prep kernel flags the rows that hold a nonzero value and, for FP4,
//    applies a4 to x once (xq, type T, to device memory); a4 of h runs in
//    kernel A's epilogue (a 64-column tile holds whole groups).  It stops at
//    the last row of the last slot with weights.
//  * a tile whose rows are all zero is skipped by A and B: its output rows
//    are exactly 0 (a4(0) = 0, finite weights), which the caller's zeroed
//    output already holds.
//  * FP4 weight tiles are decoded into [n][k] shared-memory tiles; plain
//    weight tiles, [k][n] in device memory, are copied as they are into
//    [k][n] tiles with 16-byte loads; f32 FMAs multiply them; loads, decode
//    and MMA alternate, separated by __syncthreads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped_ffn_sm90.cuh"
#include "grouped_fp4_ffn_sm90.cuh"
#include "nvfp4.cuh"

namespace {

constexpr int BM = 64;   // rows (tokens) per tile
constexpr int BN = 64;   // output columns per tile
constexpr int NT = 128;  // threads per block: 4 warps, 32 x 32 of C each
constexpr int LDE = BN + 4;  // f32 epilogue row stride

template <typename T>
struct Tiling;
template <>
struct Tiling<float> {
  static constexpr int BK = 32;
  static constexpr int LDS = BK + 1;
  static constexpr int LDN = BN + 4;  // rows stay 16-byte aligned
};

// Elements of one weight tile: [BN][LDS] decoded FP4, [BK][LDN] plain.
template <typename T, bool FP4>
__host__ __device__ constexpr int weight_tile_elems() {
  return FP4 ? BN * Tiling<T>::LDS : Tiling<T>::BK * Tiling<T>::LDN;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

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

// Weight tile [BK along K][BN columns n] of slot `slot` from plain weights
// w [G, K, N] (type T, N contiguous) into a [k][n] tile, 16 bytes at a time;
// columns past N and rows past K are zero.  N must be a multiple of 8.
template <typename T>
__device__ void load_weight_plain(const T* __restrict__ w, int64_t N,
                                  int64_t K, int slot, int64_t n0,
                                  int64_t k0, T* __restrict__ dst) {
  constexpr int BK = Tiling<T>::BK, LDN = Tiling<T>::LDN;
  constexpr int PER_VEC = 16 / sizeof(T);
  constexpr int NV = BN / PER_VEC;
  for (int task = threadIdx.x; task < BK * NV; task += NT) {
    const int kk = task / NV, nv = task % NV;
    const int64_t k = k0 + kk, n = n0 + nv * PER_VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (k < K && n < N)
      raw = *reinterpret_cast<const uint4*>(
          w + (static_cast<int64_t>(slot) * K + k) * N + n);
    *reinterpret_cast<uint4*>(dst + kk * LDN + nv * PER_VEC) = raw;
  }
}

// One weight tile in the layout of the variant.
template <typename T, bool FP4>
__device__ __forceinline__ void load_w(const void* __restrict__ w,
                                       const float* __restrict__ scales,
                                       float gsc, int64_t N, int64_t K,
                                       int slot, int64_t n0, int64_t k0,
                                       T* __restrict__ dst) {
  if constexpr (FP4)
    load_weight<T>(static_cast<const uint8_t*>(w), scales, gsc, N, K, slot,
                   n0, k0, dst);
  else
    load_weight_plain<T>(static_cast<const T*>(w), N, K, slot, n0, k0, dst);
}

// C[BM][BN] += A[BM][BK] . B^T over one K tile, for NB products that
// share A (gate and up share xq).  B is a [BN][LDS] tile ([n][k]) or, with
// KMAJOR, a [BK][LDN] tile ([k][n]).  FMAs, each thread 8 rows x 4 columns.
template <typename T, int NB, bool KMAJOR>
struct Mma;

template <int NB, bool KMAJOR>
struct Mma<float, NB, KMAJOR> {
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
    constexpr int LDN = Tiling<float>::LDN;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int kk = 0; kk < BK; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(ty * 8 + i) * LDS + kk];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = KMAJOR ? B[b][kk * LDN + tx * 4 + j]
                         : B[b][(tx * 4 + j) * LDS + kk];
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

// one activation tile [BM][LDS] and n_w weight tiles
template <typename T, bool FP4>
__host__ __device__ constexpr int input_tile_bytes(int n_w) {
  return (BM * Tiling<T>::LDS + n_w * weight_tile_elems<T, FP4>()) *
         static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr int epilogue_bytes(int n_tiles) {
  return n_tiles * BM * LDE * static_cast<int>(sizeof(float));
}
__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}

constexpr int PREP_ROWS = 8;  // one warp per row

// Rows of the slots that have weights: sum of gs[g] for g < min(G, Gw)
// (slots are laid out in order, so these are the first rows).
__device__ __forceinline__ int64_t live_rows(const int* __restrict__ gs,
                                             int G, int Gw) {
  int64_t n = 0;
  for (int g = 0; g < min(G, Gw); ++g) n += max(gs[g], 0);
  return n;
}

// Prep: nz[row] = any(x[row] != 0) and, with A4, xq = T(a4(x)), over the
// rows of the slots that have weights (no other row is read later).
template <typename T, bool A4>
__global__ void __launch_bounds__(PREP_ROWS * 32)
    ffn_prep_kernel(const T* __restrict__ xs, const int* __restrict__ gs,
                    int G, int Gw, T* __restrict__ xq, int* __restrict__ nz,
                    int64_t M, int64_t D) {
  __shared__ int64_t live;
  if (threadIdx.x == 0) live = live_rows(gs, G, Gw);
  __syncthreads();
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * PREP_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M || row >= live) return;  // whole warps
  bool any = false;
  for (int64_t k = lane * nvfp4::GROUP; k < D; k += 32 * nvfp4::GROUP) {
    float v[nvfp4::GROUP];
    load16<T>(xs + row * D + k, v);
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i) any |= v[i] != 0.0f;
    if constexpr (A4) {
      nvfp4::fake_quant_a4_group(v);
      store16<T>(xq + row * D + k, v);
    }
  }
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) nz[row] = any ? 1 : 0;
}

// Kernel A: hq[rows, f0:f0+64] = a4?(T(silu(T(x.Wg^T))) * T(x.Wu^T)), x
// being xq (FP4) or xs (plain).
template <typename T, bool FP4>
__global__ void __launch_bounds__(NT)
    ffn_gate_up_kernel(const T* __restrict__ x, const int* __restrict__ nz,
                       const int* __restrict__ gs, int G, int Gw,
                       const void* __restrict__ gate_w,
                       const float* __restrict__ gate_scales,
                       const void* __restrict__ up_w,
                       const float* __restrict__ up_scales,
                       const float* __restrict__ gscales, T* __restrict__ hq,
                       int64_t M, int64_t D, int64_t F) {
  constexpr int BK = Tiling<T>::BK, LDS = Tiling<T>::LDS;
  constexpr int SMEM = cmax(input_tile_bytes<T, FP4>(2), epilogue_bytes(2));
  __shared__ __align__(128) unsigned char smem[SMEM];
  Tile t;
  if (!find_tile(gs, G, t) || t.slot >= Gw) return;  // block-uniform
  if (!tile_live(nz, M, t)) return;
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * BN;
  T* xt = reinterpret_cast<T*>(smem);
  T* wg = xt + BM * LDS;
  T* wu = wg + weight_tile_elems<T, FP4>();
  const T* wts[2] = {wg, wu};
  const float g_scale = FP4 ? gscales[0] : 1.0f;
  const float u_scale = FP4 ? gscales[1] : 1.0f;

  Mma<T, 2, !FP4> mma;
  mma.zero();
  for (int64_t k0 = 0; k0 < D; k0 += BK) {
    load_act<T>(x, M, D, t, k0, xt);
    load_w<T, FP4>(gate_w, gate_scales, g_scale, F, D, t.slot, f0, k0, wg);
    load_w<T, FP4>(up_w, up_scales, u_scale, F, D, t.slot, f0, k0, wu);
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
    if constexpr (FP4) nvfp4::fake_quant_a4_group(v);
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i)
      hq[row * F + f + i] = from_f32<T>(v[i]);
  }
}

// Kernel B: out[rows, d0:d0+64] = T(hq . Wd^T).
template <typename T, bool FP4>
__global__ void __launch_bounds__(NT)
    ffn_down_kernel(const T* __restrict__ hq, const int* __restrict__ nz,
                    const int* __restrict__ gs, int G, int Gw,
                    const void* __restrict__ down_w,
                    const float* __restrict__ down_scales,
                    const float* __restrict__ gscales, T* __restrict__ out,
                    int64_t M, int64_t D, int64_t F) {
  constexpr int BK = Tiling<T>::BK, LDS = Tiling<T>::LDS;
  constexpr int SMEM = cmax(input_tile_bytes<T, FP4>(1), epilogue_bytes(1));
  __shared__ __align__(128) unsigned char smem[SMEM];
  Tile t;
  if (!find_tile(gs, G, t) || t.slot >= Gw) return;  // block-uniform
  if (!tile_live(nz, M, t)) return;
  const int64_t d0 = static_cast<int64_t>(blockIdx.y) * BN;
  T* ht = reinterpret_cast<T*>(smem);
  T* wd = ht + BM * LDS;
  const T* wts[1] = {wd};
  const float d_scale = FP4 ? gscales[2] : 1.0f;

  Mma<T, 1, !FP4> mma;
  mma.zero();
  for (int64_t k0 = 0; k0 < F; k0 += BK) {
    load_act<T>(hq, M, F, t, k0, ht);
    load_w<T, FP4>(down_w, down_scales, d_scale, D, F, t.slot, d0, k0, wd);
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

// Weights of one variant: FP4 packed codes + scales + device global scales,
// or plain [G, K, N] stacks of type T (scales and gscales null).
struct FfnWeights {
  const void* gate;
  const void* gate_scales;
  const void* up;
  const void* up_scales;
  const void* down;
  const void* down_scales;
  const void* gscales;
};

template <typename T, bool FP4>
int launch(const void* xs, const void* gs, int64_t G, int64_t Gw,
           const FfnWeights& w, void* xq, void* nz, void* hq, void* out,
           int64_t M, int64_t D, int64_t F, void* stream) {
  if (M == 0 || G == 0 || Gw == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gsi = static_cast<const int*>(gs);
  ffn_prep_kernel<T, FP4>
      <<<static_cast<unsigned>((M + PREP_ROWS - 1) / PREP_ROWS),
         PREP_ROWS * 32, 0, s>>>(static_cast<const T*>(xs), gsi,
                                 static_cast<int>(G), static_cast<int>(Gw),
                                 static_cast<T*>(xq), static_cast<int*>(nz),
                                 M, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* x = FP4 ? static_cast<const T*>(xq) : static_cast<const T*>(xs);
  // upper bound of sum_g ceil(gs[g] / BM) when sum_g gs[g] <= M
  const unsigned row_tiles = static_cast<unsigned>((M + BM - 1) / BM + G);
  const dim3 grid_a(row_tiles, static_cast<unsigned>((F + BN - 1) / BN));
  ffn_gate_up_kernel<T, FP4><<<grid_a, NT, 0, s>>>(
      x, static_cast<const int*>(nz), gsi, static_cast<int>(G),
      static_cast<int>(Gw), w.gate, static_cast<const float*>(w.gate_scales),
      w.up, static_cast<const float*>(w.up_scales),
      static_cast<const float*>(w.gscales), static_cast<T*>(hq), M, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(row_tiles, static_cast<unsigned>((D + BN - 1) / BN));
  ffn_down_kernel<T, FP4><<<grid_b, NT, 0, s>>>(
      static_cast<const T*>(hq), static_cast<const int*>(nz), gsi,
      static_cast<int>(G), static_cast<int>(Gw), w.down,
      static_cast<const float*>(w.down_scales),
      static_cast<const float*>(w.gscales), static_cast<T*>(out), M, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// FP4 entries.  xs: [M, D] rows sorted by slot; gs: int32 [G] rows per slot
// (sum <= M); slots g >= Gw have no weights and give 0; gate/up: u8
// [Gw, F, D/2] + f32 [Gw, F, D/16]; down: u8 [Gw, D, F/2] + f32
// [Gw, D, F/16]; gscales: f32 [3] (gate, up, down) on the device; scratch:
// xq [M, D] and hq [M, F] of the input type, nz int32 [M] (f32 only; the
// bf16 entry takes null); out: [M, D], zeroed by the caller (rows outside
// every slot with weights, and for f32 all-zero tiles, are not written).
// D and F must be multiples of 32, the bf16 entry takes at most 512 counts;
// all arrays contiguous.  Returns cudaGetLastError() after the launches.
int grouped_fp4_ffn_bf16(const void* xs, const void* gs, int64_t G,
                         int64_t Gw, const void* gate_packed,
                         const void* gate_scales, const void* up_packed,
                         const void* up_scales, const void* down_packed,
                         const void* down_scales, const void* gscales,
                         void* xq, void* nz, void* hq, void* out, int64_t M,
                         int64_t D, int64_t F, void* stream) {
  (void)nz;  // the Hopper design needs no zero-row flags
  return sm90::launch(xs, gs, G, Gw, gate_packed, gate_scales, up_packed,
                      up_scales, down_packed, down_scales, gscales, xq, hq,
                      out, M, D, F, static_cast<cudaStream_t>(stream));
}

int grouped_fp4_ffn_f32(const void* xs, const void* gs, int64_t G, int64_t Gw,
                        const void* gate_packed, const void* gate_scales,
                        const void* up_packed, const void* up_scales,
                        const void* down_packed, const void* down_scales,
                        const void* gscales, void* xq, void* nz, void* hq,
                        void* out, int64_t M, int64_t D, int64_t F,
                        void* stream) {
  const FfnWeights w{gate_packed, gate_scales, up_packed, up_scales,
                     down_packed, down_scales, gscales};
  return launch<float, true>(xs, gs, G, Gw, w, xq, nz, hq, out, M, D, F,
                             stream);
}

// Plain entries: as above with w_gate, w_up [Gw, D, F] and w_down
// [Gw, F, D] of the input type, and no a4 (no xq scratch).
// nz: int32 [M] scratch of the f32 entry; the bf16 entry ignores it (its
// Hopper design needs no zero-row flags) and takes at most 512 counts.
int grouped_ffn_bf16(const void* xs, const void* gs, int64_t G, int64_t Gw,
                     const void* w_gate, const void* w_up, const void* w_down,
                     void* nz, void* hq, void* out, int64_t M, int64_t D,
                     int64_t F, void* stream) {
  (void)nz;
  return sm90::launch_plain(xs, gs, G, Gw, w_gate, w_up, w_down, hq, out, M,
                            D, F, static_cast<cudaStream_t>(stream));
}

int grouped_ffn_f32(const void* xs, const void* gs, int64_t G, int64_t Gw,
                    const void* w_gate, const void* w_up, const void* w_down,
                    void* nz, void* hq, void* out, int64_t M, int64_t D,
                    int64_t F, void* stream) {
  const FfnWeights w{w_gate, nullptr, w_up, nullptr, w_down, nullptr,
                     nullptr};
  return launch<float, false>(xs, gs, G, Gw, w, nullptr, nz, hq, out, M, D, F,
                              stream);
}

}  // extern "C"
