// The Hopper design of the grouped W4A4 expert FFN in bf16 (the entry
// grouped_fp4_ffn_bf16), included by grouped_fp4_ffn.cu, whose header says
// what it computes and why this design.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nvfp4.cuh"
#include "sm90_common.cuh"

// Internal linkage, as in sm90_common.cuh.
namespace {
namespace sm90 {

constexpr int RK = 128;             // K per raw stage: two decode stages
constexpr int DEC_BUFS = 2;         // decoded weight tiles
constexpr int RS = 3;               // ring of raw stages (codes, scales)
constexpr int TS = 4;               // ring of token tiles
constexpr int PART_BYTES = PART_ROWS * BK * 2;       // decoded [64][64]
constexpr int TILE_BYTES = 2 * PART_BYTES;           // both warpgroups'
constexpr int PACKED_BYTES = PART_ROWS * RK / 2;     // codes of a part
constexpr int SCALE_BYTES = PART_ROWS * (RK / 16) * 4;  // its scales
constexpr int LUT_ENTRIES = 128;    // E4M3 codes of positive scales
constexpr int LUT_BYTES = LUT_ENTRIES * (16 + 4);  // tables, then scales

// Work items as in sm90_common.cuh.  Each warpgroup keeps one accumulator
// of N/2 registers, so a block fits in 128 registers a thread and two
// blocks share an SM, each block's phases (decode, wgmma, barrier) filling
// the other's gaps.
//
// Shared-memory layout of a block with NMAT weight matrices: the scan's
// tables, the rings' mbarriers, each matrix's level tables by scale code,
// DEC_BUFS decoded tiles, TS token tiles, RS raw stages of codes (both
// parts, 64 bytes a row) and of scales (32 bytes a row).  TMA and wgmma
// tiles start on 1024-byte boundaries (the 128-byte swizzle repeats every
// 8 rows).
template <int NMAT>
struct Smem {
  static constexpr int SCAN = 0;
  static constexpr int BARS = (SCAN_BYTES + 15) / 16 * 16;
  static constexpr int LUT = (BARS + (RS + TS) * 8 + 15) / 16 * 16;
  static constexpr int A = (LUT + NMAT * LUT_BYTES + 1023) / 1024 * 1024;
  static constexpr int B = A + DEC_BUFS * TILE_BYTES;
  static constexpr int P = B + TS * TOK_BYTES;
  static constexpr int S = P + RS * 2 * PACKED_BYTES;
  static_assert(S + RS * 2 * SCALE_BYTES + 1024 <= SMEM_BYTES,
                "shared memory");
};

// 8 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The scales [Gw, NR, K/16] of one FP4 weight matrix (its codes come by
// TMA, through Maps).
struct Mat {
  const float* scales;
};

// Thread 0: the TMA loads of raw stage R (both parts' codes) into raw ring
// slot gr % RS, completing on that slot's barrier.
template <int NMAT>
__device__ __forceinline__ void tma_raw(unsigned char* sm, const Maps& maps,
                                        int gr, int R, const Item& it) {
  const uint32_t bar = smem_u32(sm + Smem<NMAT>::BARS) + (gr % RS) * 8;
  mbar_expect(bar, 2 * PACKED_BYTES);
#pragma unroll
  for (int p = 0; p < 2; ++p)
    tma_load_3d(
        smem_u32(sm + Smem<NMAT>::P + ((gr % RS) * 2 + p) * PACKED_BYTES),
        &maps.w[part_mat<NMAT>(p)], bar, R * (RK / 2),
        static_cast<int>(it.n0) + part_row0<NMAT>(p), it.slot);
}

// Thread 0: the TMA load of token stage s into token ring slot gt % TS.
template <int NMAT, int N>
__device__ __forceinline__ void tma_tok(unsigned char* sm, const Maps& maps,
                                        int gt, int s, const Item& it) {
  const uint32_t bar = smem_u32(sm + Smem<NMAT>::BARS) + (RS + gt % TS) * 8;
  mbar_expect(bar, N * BK * 2);
  tma_load_2d(smem_u32(sm + Smem<NMAT>::B + (gt % TS) * TOK_BYTES),
              tok_map<N>(maps), bar, s * BK, static_cast<int>(it.row0));
}

// This thread's scales of an item's raw stage: 8 bytes of one row of each
// part (the scales' rows are K/4 bytes apart, which TMA takes only when K
// is a multiple of 64).
struct ScaleCopy {
  const float* src[2];  // at raw stage 0
  bool row_ok[2];
  int c;                // this thread's 32-wide quarter of a raw stage
};

template <int NMAT>
__device__ __forceinline__ ScaleCopy scale_copy(const Mat* mats, int64_t NR,
                                               int64_t K, const Item& it) {
  static_assert(PART_ROWS * 4 == THREADS, "one copy of each part a thread");
  const int row = threadIdx.x / 4;
  ScaleCopy sc;
  sc.c = threadIdx.x % 4;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int64_t n = it.n0 + part_row0<NMAT>(p) + row;
    sc.row_ok[p] = n < NR;
    const int64_t wrow =
        static_cast<int64_t>(it.slot) * NR + (sc.row_ok[p] ? n : 0);
    sc.src[p] = mats[part_mat<NMAT>(p)].scales + wrow * (K / 16) + sc.c * 2;
  }
  return sc;
}

// The scales of raw stage R of both parts into raw ring slot r (zeros past
// NR and K; nothing past the last raw stage).
template <int NMAT>
__device__ __forceinline__ void load_scales(unsigned char* sm, int r, int R,
                                           int n_raw, const ScaleCopy& sc,
                                           int64_t K) {
  if (R >= n_raw) return;
  const int row = threadIdx.x / 4;
  const bool k_ok = static_cast<int64_t>(R) * RK + sc.c * 32 < K;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const bool ok = sc.row_ok[p] && k_ok;
    cp_async8(smem_u32(sm + Smem<NMAT>::S + (r * 2 + p) * SCALE_BYTES +
                       row * 32 + sc.c * 8),
              ok ? sc.src[p] + R * (RK / 16) : sc.src[p], ok);
  }
}

// The bf16 bits of the eight magnitudes T((level_i * s) * g), level_i in
// {0, .5, 1, 1.5, 2, 3, 4, 6}, as two byte tables (low and high bytes, four
// levels a word) that prmt indexes by a code's three level bits.  A
// negative code's value is the same magnitude with the sign bit set, as
// (-level * s) * g is -((level * s) * g) in IEEE arithmetic.
__device__ __forceinline__ void level_tables(float s, float g, uint32_t* lo,
                                             uint32_t* hi) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = (nvfp4::fp4_level(2 * i) * s) * g;
    const float b = (nvfp4::fp4_level(2 * i + 1) * s) * g;
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  lo[0] = __byte_perm(w[0], w[1], 0x6420);
  hi[0] = __byte_perm(w[0], w[1], 0x7531);
  lo[1] = __byte_perm(w[2], w[3], 0x6420);
  hi[1] = __byte_perm(w[2], w[3], 0x7531);
}

// The E4M3 code (0..127) of a positive scale on the E4M3 grid; anything
// else gives some code whose table entry's scale differs from it.
__device__ __forceinline__ int e4m3_code(float s) {
  const uint32_t b = __float_as_uint(s);
  const int e = static_cast<int>(b >> 23) - 127;
  if (e >= -6)
    return (((e + 7) << 3) | static_cast<int>((b >> 20) & 7u)) & 127;
  // E4M3 subnormals m * 2^-9: m sits in the low mantissa bits of s*512+2^23
  return static_cast<int>(__float_as_uint(s * 512.0f + 8388608.0f) & 127u);
}

// Level tables of every E4M3 scale for the block's matrices, built once:
// entry c of matrix m holds level_tables(s_c, gsc[m]) and s_c itself.
template <int NMAT>
__device__ void build_luts(unsigned char* lut, const float* gsc) {
  for (int t = threadIdx.x; t < NMAT * LUT_ENTRIES; t += THREADS) {
    const int m = t / LUT_ENTRIES, c = t % LUT_ENTRIES;
    const int e = c >> 3, mant = c & 7;
    const float s = e == 0 ? static_cast<float>(mant) * 0.001953125f
                           : ldexpf(1.0f + 0.125f * static_cast<float>(mant),
                                    e - 7);
    uint32_t lo[2], hi[2];
    level_tables(s, m == 0 ? gsc[0] : gsc[NMAT - 1], lo, hi);
    unsigned char* base = lut + m * LUT_BYTES;
    reinterpret_cast<uint4*>(base)[c] = make_uint4(lo[0], lo[1], hi[0], hi[1]);
    reinterpret_cast<float*>(base + LUT_ENTRIES * 16)[c] = s;
  }
}

// Decode raw ring slot r into decoded buffer `buf`: T((level * s) * gsc)
// for every weight, bitwise as the plain version computes it.  Thread t
// takes group t % 4 of row t / 4 of each part (8 bytes of codes and one
// scale), takes the group's level tables from the block's table by scale
// code (or builds them when the scale is not an E4M3 value), and writes
// two 16-byte chunks of the swizzled tile.
template <int NMAT, int N>
__device__ __forceinline__ void decode_stage(unsigned char* sm, int r, int h,
                                            int buf, const float* gsc) {
  static_assert(PART_ROWS * 4 == THREADS, "one group of each part a thread");
  const int row = threadIdx.x / 4, grp = threadIdx.x % 4;
  uint2 raw[2];
  float s[2];
  uint4 tab[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    raw[p] = *reinterpret_cast<const uint2*>(
        sm + Smem<NMAT>::P + (r * 2 + p) * PACKED_BYTES + row * 64 +
        h * 32 + grp * 8);
    s[p] = *reinterpret_cast<const float*>(
        sm + Smem<NMAT>::S + (r * 2 + p) * SCALE_BYTES + row * 32 +
        h * 16 + grp * 4);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int m = part_mat<NMAT>(p);
    const unsigned char* lut = sm + Smem<NMAT>::LUT + m * LUT_BYTES;
    const int c = e4m3_code(s[p]);
    tab[p] = reinterpret_cast<const uint4*>(lut)[c];
    if (reinterpret_cast<const float*>(lut + LUT_ENTRIES * 16)[c] != s[p]) {
      uint32_t lo[2], hi[2];
      level_tables(s[p], gsc[m], lo, hi);
      tab[p] = make_uint4(lo[0], lo[1], hi[0], hi[1]);
    }
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const uint32_t lo[2] = {tab[p].x, tab[p].y}, hi[2] = {tab[p].z, tab[p].w};
    uint32_t out[8];
    decode4(raw[p].x, lo, hi, out[0], out[1]);
    decode4(raw[p].x >> 16, lo, hi, out[2], out[3]);
    decode4(raw[p].y, lo, hi, out[4], out[5]);
    decode4(raw[p].y >> 16, lo, hi, out[6], out[7]);
    unsigned char* tile =
        sm + Smem<NMAT>::A + buf * TILE_BYTES + p * PART_BYTES;
    *reinterpret_cast<uint4*>(tile + sw128(row, 2 * grp)) =
        make_uint4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint4*>(tile + sw128(row, 2 * grp + 1)) =
        make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// Issue the wgmma of one stage: each warpgroup multiplies its part (64
// weight rows) by the token tile, four k16 steps.
template <int NMAT, int N>
__device__ __forceinline__ void mma_stage(unsigned char* sm, int r, int buf,
                                          float (&acc)[N / 2]) {
  const int wg = threadIdx.x / 128;
  const uint32_t a = smem_u32(sm + Smem<NMAT>::A + buf * TILE_BYTES +
                              wg * PART_BYTES);
  const uint32_t b =
      smem_u32(sm + Smem<NMAT>::B + r * TOK_BYTES);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma<N>(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32));
  wgmma_commit();
}

// acc = this warpgroup's part . act[tokens, :]^T over all of K.  Decode
// stages are 64 deep, raw stages two of them.  gr and gt count the
// block's raw and token stages before this item: raw stage R of the item
// uses ring slot (gr + R) % RS and completes that barrier's phase
// (gr + R) / RS, token stage s slot (gt + s) % TS likewise.  At stage s
// thread 0 issues the TMA loads of token stage s+TS-1 and, at even s, of
// raw stage s/2+RS-1, into slots that earlier stages freed, every thread
// copies its scales of that raw stage, and the tensor cores multiply stage
// s while the block decodes stage s+1 into the other decoded buffer; then
// the block waits for its wgmma and for the scales of stage s+2; one
// barrier a stage.
template <int NMAT, int N>
__device__ void mainloop(unsigned char* sm, const Maps& maps,
                         const Mat* mats, const float* gsc, int64_t NR,
                         int64_t K, const Item& it, int gr, int gt,
                         float (&acc)[N / 2]) {
  const int n_stages = static_cast<int>((K + BK - 1) / BK);
  const int n_raw = static_cast<int>((K + RK - 1) / RK);
  const uint32_t bars = smem_u32(sm + Smem<NMAT>::BARS);
  const ScaleCopy sc = scale_copy<NMAT>(mats, NR, K, it);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  if (threadIdx.x == 0) {
    for (int R = 0; R < RS - 1 && R < n_raw; ++R)
      tma_raw<NMAT>(sm, maps, gr + R, R, it);
    for (int s = 0; s < TS - 1 && s < n_stages; ++s)
      tma_tok<NMAT, N>(sm, maps, gt + s, s, it);
  }
#pragma unroll
  for (int R = 0; R < RS - 1; ++R)
    load_scales<NMAT>(sm, (gr + R) % RS, R, n_raw, sc, K);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  mbar_wait(bars + (gr % RS) * 8, (gr / RS) & 1);
  decode_stage<NMAT, N>(sm, gr % RS, 0, 0, gsc);
  fence_async_smem();
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int ts = gt + s;
    mbar_wait(bars + (RS + ts % TS) * 8, (ts / TS) & 1);
    mma_stage<NMAT, N>(sm, ts % TS, s % DEC_BUFS, acc);
    if (s % 2 == 0) {
      const int R = s / 2 + RS - 1;  // into the slot of raw stage s/2-1
      if (threadIdx.x == 0 && R < n_raw) tma_raw<NMAT>(sm, maps, gr + R, R, it);
      load_scales<NMAT>(sm, (gr + R) % RS, R, n_raw, sc, K);
    }
    if (threadIdx.x == 0 && s + TS - 1 < n_stages)
      tma_tok<NMAT, N>(sm, maps, ts + TS - 1, s + TS - 1, it);
    cp_async_commit();
    if (s + 1 < n_stages) {
      const int r1 = gr + (s + 1) / 2;
      mbar_wait(bars + (r1 % RS) * 8, (r1 / RS) & 1);
      decode_stage<NMAT, N>(sm, r1 % RS, (s + 1) % 2, (s + 1) % DEC_BUFS,
                            gsc);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_reg(acc[i]);
    cp_async_wait<2 * RS - 4>();  // the scales of stage s+2
    fence_async_smem();
    __syncthreads();
  }
}

// Accumulators are laid out as sm90_common.cuh says.
//
// Gate/up epilogue, on warpgroup 0 (gate) with up from warpgroup 1 through
// shared memory: h = T(T(silu(T(gate))) * T(up)), then a4 over each group
// of 16 rows along F (one warp's rows of one token column, held by the 8
// lanes with equal l%4), written to hq [M, F].
template <int N>
__device__ void epilogue_gate_up(const float (&acc)[N / 2],
                                 const float* __restrict__ up,
                                 const Item& it,
                                 __nv_bfloat16* __restrict__ hq, int64_t M,
                                 int64_t F) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int64_t f_lo = it.n0 + w * 16 + l / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * e + h;
        const float g = round_bf16(acc[i]);
        const float u = round_bf16(up[i * 128 + threadIdx.x]);
        const float act = round_bf16(g * (1.0f / (1.0f + expf(-g))));
        v[e] = round_bf16(act * u);
      }
      float amax = fmaxf(fabsf(v[0]), fabsf(v[1]));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 4));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 8));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 16));
      const float gs = fmaxf(amax * nvfp4::INV_FP4_MAX, 1e-20f);
      const int t = 8 * j + 2 * (l % 4) + h;
      const int64_t row = it.row0 + t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float r = v[e] / gs;
        const float sg = r > 0.0f ? 1.0f : (r < 0.0f ? -1.0f : r);
        const float q = (sg * nvfp4::fp4_level(nvfp4::fp4_index(fabsf(r)))) *
                        gs;
        const int64_t f = f_lo + 8 * e;
        if (t < it.ntok && row < M && f < F)
          hq[row * F + f] = __float2bfloat16_rn(q);
      }
    }
  }
}

template <int NMAT, int N>
__device__ void run_item(unsigned char* sm, const Maps& maps, const Mat* mats,
                         const float* gsc, int64_t NR, int64_t K,
                         const Item& it, int gr, int gt, __nv_bfloat16* dst,
                         int64_t M) {
  float acc[N / 2];
  mainloop<NMAT, N>(sm, maps, mats, gsc, NR, K, it, gr, gt, acc);
  if constexpr (NMAT == 2) {
    // up's accumulators to warpgroup 0 through the (idle) token ring
    float* up = reinterpret_cast<float*>(sm + Smem<NMAT>::B);
    static_assert(NTOK / 2 * 128 * 4 <= TS * TOK_BYTES, "exchange fits");
    if (threadIdx.x >= 128) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) up[i * 128 + threadIdx.x - 128] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x < 128) epilogue_gate_up<N>(acc, up, it, dst, M, NR);
    __syncthreads();
  } else {
    epilogue_down<N>(acc, it, dst, M, NR);
  }
}

// Persistent grouped product: block b takes work items b, b + grid, ...
// (slot, weight tile, token tile), ordered by slot, so that the blocks
// working at one time share a slot's tokens in L2.  NMAT 2: gate and up of
// xq into hq; NMAT 1: down of hq into out.  With all-zero counts a block
// scans the counts and exits.
template <int NMAT>
__global__ void __launch_bounds__(THREADS, 2)
    ffn_kernel(const __grid_constant__ Maps maps,
               const int* __restrict__ gs, int G, int Gw, Mat m0, Mat m1,
               const float* __restrict__ gscales, int gsc0,
               __nv_bfloat16* __restrict__ dst, int64_t M, int64_t NR,
               int64_t K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  int* tstart = reinterpret_cast<int*>(sm + Smem<NMAT>::SCAN);
  int* rstart = tstart + MAX_SLOTS + 1;
  const int n_slots = min(G, Gw);
  const int nwt = static_cast<int>((NR + item_rows<NMAT>() - 1) /
                                   item_rows<NMAT>());
  float gsc[NMAT];
#pragma unroll
  for (int m = 0; m < NMAT; ++m) gsc[m] = gscales[gsc0 + m];
  scan_slots(gs, n_slots, nwt, tstart, rstart);  // ends in a barrier
  if (static_cast<int>(blockIdx.x) >= tstart[n_slots]) return;
  build_luts<NMAT>(sm + Smem<NMAT>::LUT, gsc);
  if (threadIdx.x == 0) {
    for (int i = 0; i < RS + TS; ++i)
      mbar_init(smem_u32(sm + Smem<NMAT>::BARS + i * 8));
    fence_mbar_init();
  }
  __syncthreads();
  const Mat mats[2] = {m0, m1};
  const int n_stages = static_cast<int>((K + BK - 1) / BK);
  const int n_raw = static_cast<int>((K + RK - 1) / RK);
  // the block's j-th item starts at raw stage j * n_raw and token stage
  // j * n_stages of its rings
  for_each_item<NMAT>(tstart, rstart, n_slots,
                      [&](const Item& it, int j, auto width) {
    run_item<NMAT, decltype(width)::value>(sm, maps, mats, gsc, NR, K, it,
                                           j * n_raw, j * n_stages, dst, M);
  });
}

constexpr int PREP_THREADS = 256;

// xq = T(a4(x)) over the rows of the slots with weights, grid-stride over
// groups of 16 (a few blocks per SM; the a4 of a row is computed once, not
// once per weight tile, and the token tiles then come by cp.async).
__global__ void __launch_bounds__(PREP_THREADS)
    a4_rows_kernel(const __nv_bfloat16* __restrict__ xs,
                   const int* __restrict__ gs, int G, int Gw,
                   __nv_bfloat16* __restrict__ xq, int64_t M, int64_t D) {
  __shared__ int64_t live;
  if (threadIdx.x == 0) {
    int64_t n = 0;
    for (int g = 0; g < min(G, Gw); ++g) n += max(gs[g], 0);
    live = min(n, M);
  }
  __syncthreads();
  const int64_t ng = D / nvfp4::GROUP;
  const int64_t total = live * ng;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * PREP_THREADS +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * PREP_THREADS) {
    const int64_t off = (idx / ng) * D + (idx % ng) * nvfp4::GROUP;
    const uint4* src = reinterpret_cast<const uint4*>(xs + off);
    uint4 raw[2] = {src[0], src[1]};
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(raw);
    float v[nvfp4::GROUP];
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i) v[i] = __bfloat162float(e[i]);
    nvfp4::fake_quant_a4_group(v);
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i) e[i] = __float2bfloat16_rn(v[i]);
    uint4* dst = reinterpret_cast<uint4*>(xq + off);
    dst[0] = raw[0];
    dst[1] = raw[1];
  }
}

// Codes [Gw, NR, K/2] bytes, boxes of 64 bytes by 64 rows of one slot.
bool packed_map(CUtensorMap* map, const void* packed, int64_t Gw, int64_t NR,
                int64_t K) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K / 2),
                              static_cast<cuuint64_t>(NR),
                              static_cast<cuuint64_t>(Gw)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K / 2),
                                 static_cast<cuuint64_t>(NR * (K / 2))};
  const cuuint32_t box[3] = {RK / 2, PART_ROWS, 1}, step[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                   const_cast<void*>(packed), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool maps_for(Maps* maps, const void* packed0, const void* packed1,
              const void* act, int64_t Gw, int64_t NR, int64_t K, int64_t M) {
  if (encoder() == nullptr) return false;
  return packed_map(&maps->w[0], packed0, Gw, NR, K) &&
         packed_map(&maps->w[1], packed1, Gw, NR, K) &&
         token_maps(maps, act, M, K);
}

// The three launches of the bf16 FP4 FFN: a4 of x, gate/up, down.
int launch(const void* xs, const void* gs, int64_t G, int64_t Gw,
           const void* gate, const void* gate_scales, const void* up,
           const void* up_scales, const void* down, const void* down_scales,
           const void* gscales, void* xq, void* hq, void* out, int64_t M,
           int64_t D, int64_t F, cudaStream_t s) {
  if (M == 0 || G == 0 || Gw == 0) return 0;
  if (G > MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  // the tensor maps below are encoded on this thread, which may not have
  // the device's context bound yet
  cudaError_t err = bind_device();
  if (err == cudaSuccess) err = allow_smem<&ffn_kernel<2>>();
  if (err == cudaSuccess) err = allow_smem<&ffn_kernel<1>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  const int* gsi = static_cast<const int*>(gs);
  const auto* x = static_cast<const __nv_bfloat16*>(xs);
  auto* xqb = static_cast<__nv_bfloat16*>(xq);
  auto* hqb = static_cast<__nv_bfloat16*>(hq);
  const auto* gsc = static_cast<const float*>(gscales);
  a4_rows_kernel<<<sms * 4, PREP_THREADS, 0, s>>>(
      x, gsi, static_cast<int>(G), static_cast<int>(Gw), xqb, M, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps mgu, mdn;
  if (!maps_for(&mgu, gate, up, xq, Gw, F, D, M) ||
      !maps_for(&mdn, down, down, hq, Gw, D, F, M))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mat mg{static_cast<const float*>(gate_scales)};
  const Mat mu{static_cast<const float*>(up_scales)};
  const Mat md{static_cast<const float*>(down_scales)};
  ffn_kernel<2><<<2 * sms, THREADS, SMEM_BYTES, s>>>(
      mgu, gsi, static_cast<int>(G), static_cast<int>(Gw), mg, mu, gsc, 0,
      hqb, M, F, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_kernel<1><<<2 * sms, THREADS, SMEM_BYTES, s>>>(
      mdn, gsi, static_cast<int>(G), static_cast<int>(Gw), md, md, gsc, 2,
      static_cast<__nv_bfloat16*>(out), M, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
