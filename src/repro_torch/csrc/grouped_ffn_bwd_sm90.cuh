// The Hopper design of the grouped FFN's backward in bf16 (the entry
// grouped_ffn_bwd_bf16, the training path's), included by
// grouped_ffn_bwd.cu, whose header gives the chain it computes.
//
// What bounds it on the H100: operations.  Eight products of 2.rows.D.F,
// ~1.13 TFLOP at a training step's 24.6k routed rows (D = 2048, F = 1408):
// 1.15 ms at 989 TFLOP/s, against ~2.6 GB of operands (~0.8 ms at 3.35
// TB/s).  With the reference's roundings every operand of the eight
// products is bf16, so all of them run on the tensor cores, from tiles
// that TMA brings into shared memory as they lie in device memory.  The
// three launches are built from the forward's blocks (sm90_common.cuh):
// the device-built schedule over persistent blocks, 128-byte-swizzled TMA
// tiles, mbarriers and wgmma with weight rows on its 64-row M side.
//  (a) act: an item is 64 F-rows of one slot x a token tile of up to 64 of
//      its rows (16, 32 or 64 wide).  Over D it runs g^T = Wg^T.x^T and
//      u^T (A: Wg/Wu [D, F] as they lie, MN-major, the transpose flag as
//      the forward's gate/up stage reads them) and dh^T = Wd.dy^T (A: Wd
//      [F, D] by rows, K-major); B: the token tiles of xs and dy, K-major.
//      Three 64 x 64 accumulators would take 96 f32 registers a thread of
//      one warpgroup; instead the two warpgroups share an item by tokens:
//      each takes half of the tile's columns for all three products (48
//      registers a thread at a 64-row tile), so each thread holds g, u and
//      dh of the same elements and the epilogue needs no exchange.  It
//      applies the chain and writes dg, du and h as bf16 [M, F] scratch.
//  (b) dx: an item is 64 D-rows x a token tile; A: Wg/Wu rows (K-major
//      along F), B: the token tile of dg/du (K-major), one accumulator
//      each, split between the warpgroups by tokens as in (a).  It writes
//      T(T(acc_g) + T(acc_u)), and zeros to every row past the slots with
//      weights (rows past sum(gs) and rows of slots >= Gw: one range).
//  (c) dW: an item is (slot, which of the three, a 128 x 128 output tile),
//      K the slot's rows.  A: xs or h rows, MN-major, one 64-row half a
//      warpgroup; B: dg, du or dy rows, MN-major (the transpose flag for
//      B), two 64-wide halves, one accumulator each.  A TMA box does not
//      stop at the slot's last row: the last K-tile also holds the next
//      slot's rows (rows past M come as zeros), so the block zeroes them
//      in shared memory, fences the generic stores for the async proxy and
//      meets at a barrier before the wgmma that reads them.  One block owns
//      a tile and sums its slot's rows in order: no atomics, the same bits
//      on every run.  A slot without rows writes its zero tiles in 16-byte
//      stores.
// Each launch runs a ring of stages in shared memory with a full and an
// empty mbarrier a stage.  Thread 0 keeps S - 1 stages in flight, across
// the block's items; the consumers keep one wgmma group in flight and free
// a stage once the next stage's products are in flight.  One block an SM.
// The launches write every element of dxs and of the three gradients
// (zeros where no row contributes), so the wrapper allocates them with
// torch.empty.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

// Internal linkage, as in sm90_common.cuh.
namespace {
namespace sm90 {
namespace bwd {

constexpr int TILE_BYTES = 64 * 128;  // a [64][64] bf16 tile
constexpr int MAX_SMEM = 232448;      // dynamic shared memory of a block
constexpr int S_A = 5, STAGE_A = 5 * TILE_BYTES;  // Wg, Wu, Wd, xs, dy
constexpr int S_B = 6, STAGE_B = 4 * TILE_BYTES;  // Wg, Wu, dg, du
constexpr int S_C = 6, STAGE_C = 4 * TILE_BYTES;  // A halves, B halves

// Shared memory of a launch: the scan's tables, S full and S empty
// barriers, the ring of S stages of STAGE bytes from a 1024-byte boundary.
template <int S, int STAGE>
struct Layout {
  static constexpr int SCAN = 0;
  static constexpr int FULL = (SCAN_BYTES + 15) / 16 * 16;
  static constexpr int EMPTY = FULL + S * 8;
  static constexpr int RING = (EMPTY + S * 8 + 1023) / 1024 * 1024;
  static constexpr int BYTES = RING + S * STAGE + 1024;  // + the alignment
  static_assert(BYTES <= MAX_SMEM, "shared memory");
};

// The ring: stage q of the block's sequence lies in slot q % S.  The full
// barrier of a slot completes on thread 0's arrival and the TMA bytes, the
// empty one on one arrival of each of the 8 warps once their wgmma have
// read the slot.
template <int S, int STAGE>
struct Ring {
  using L = Layout<S, STAGE>;
  unsigned char* sm;  // the aligned dynamic shared memory
  uint32_t base;      // its shared-memory address

  __device__ uint32_t full(int q) const { return base + L::FULL + (q % S) * 8; }
  __device__ uint32_t empty(int q) const {
    return base + L::EMPTY + (q % S) * 8;
  }
  __device__ uint32_t stage(int q) const {
    return base + L::RING + (q % S) * STAGE;
  }
  __device__ unsigned char* stage_ptr(int q) const {
    return sm + L::RING + (q % S) * STAGE;
  }
  __device__ void init() const {  // thread 0
    for (int i = 0; i < S; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 8);
    }
    fence_mbar_init();
  }
  __device__ void wait_full(int q) const { mbar_wait(full(q), (q / S) & 1); }
  // This warp's wgmma have read stage q.
  __device__ void release(int q) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(q));
  }
};

// Thread 0's loads, in the order the block's items consume them: next()
// loads the next stage into the slot that stage L - S freed, past the end
// of one item into the next.  Src gives the block's j-th item (get), its
// number of stages (stages, 0 for an item without loads) and the TMA
// loads of one stage (load).
template <int S, int STAGE, class Src>
struct Loader {
  const Src& src;
  typename Src::Item it;
  int j = 0, s = 0, n = 0, L = 0;
  bool live = false;

  __device__ explicit Loader(const Src& source) : src(source) { seek(); }
  __device__ void seek() {  // the first item from j on with a stage
    live = false;
    for (; src.get(j, it); ++j) {
      n = src.stages(it);
      if (n > 0) {
        s = 0;
        live = true;
        return;
      }
    }
  }
  __device__ void next(const Ring<S, STAGE>& ring) {
    if (!live) return;
    if (L >= S) mbar_wait(ring.empty(L), ((L / S) + 1) & 1);
    src.load(it, s, ring.stage(L), ring.full(L));
    ++L;
    if (++s == n) {
      ++j;
      seek();
    }
  }
};

// The first S - 1 loads, before the block's first item (thread 0).
template <int S, int STAGE, class Src>
__device__ __forceinline__ void prime(Loader<S, STAGE, Src>& ld,
                                      const Ring<S, STAGE>& ring) {
  if (threadIdx.x == 0)
    for (int i = 0; i < S - 1; ++i) ld.next(ring);
  __syncwarp();
}

// After stage q's wgmma are committed: free stage q - 1 (unless q opens
// an item) and let thread 0 load the next stage.
template <int S, int STAGE, class Src>
__device__ __forceinline__ void advance(Loader<S, STAGE, Src>& ld,
                                        const Ring<S, STAGE>& ring, int q,
                                        bool first) {
  if (!first) {
    wgmma_wait<1>();
    ring.release(q - 1);
  }
  if (threadIdx.x == 0) ld.next(ring);
  __syncwarp();
}

// The block's j-th item of the scanned schedule (64 weight rows x a token
// tile of up to NTOK rows of one slot); false past the last.
__device__ __forceinline__ bool sched_item(const int* tstart,
                                           const int* rstart, int n_slots,
                                           int j, Item& it) {
  const int item = static_cast<int>(blockIdx.x) + j * gridDim.x;
  if (item >= tstart[n_slots]) return false;
  int lo = 0, hi = n_slots;  // the last slot with tstart <= item
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (tstart[mid] <= item) lo = mid;
    else hi = mid;
  }
  const int c = rstart[lo + 1] - rstart[lo];
  const int ntt = (c + NTOK - 1) / NTOK;
  const int local = item - tstart[lo];
  it.slot = lo;
  it.n0 = static_cast<int64_t>(local / ntt) * PART_ROWS;
  it.row0 = rstart[lo] + static_cast<int64_t>(local % ntt) * NTOK;
  it.ntok = min(NTOK, c - (local % ntt) * NTOK);
  return true;
}

// Token-tile map index of an item of ntok rows: 1, 2, 3 for 16, 32, 64
// rows (the box is 8 << index rows), so that each warpgroup takes 8, 16
// or 32 of them.
__device__ __forceinline__ int tok_index(int ntok) {
  return ntok <= 16 ? 1 : ntok <= 32 ? 2 : 3;
}

// ---------------------------------------------------------------- (a) act
struct ActMaps {
  CUtensorMap wg, wu, wd;  // [Gw, D, F], [Gw, D, F], [Gw, F, D]
  CUtensorMap x[4], dy[4];  // [M, D] by 8, 16, 32, 64 rows
};

struct ActSrc {
  using Item = sm90::Item;
  const ActMaps* maps;
  const int* tstart;
  const int* rstart;
  int n_slots, n_k;

  __device__ bool get(int j, Item& it) const {
    return sched_item(tstart, rstart, n_slots, j, it);
  }
  __device__ int stages(const Item&) const { return n_k; }
  // Stage s (D from 64 s): Wg and Wu [64 D][64 F], Wd [64 F][64 D], the
  // token rows of xs and dy [rows][64 D].
  __device__ void load(const Item& it, int s, uint32_t dst,
                       uint32_t bar) const {
    const int w = tok_index(it.ntok);
    mbar_expect(bar, 3 * TILE_BYTES + 2 * ((8 << w) * 128));
    const int n0 = static_cast<int>(it.n0), k0 = s * BK;
    const int r0 = static_cast<int>(it.row0);
    tma_load_3d(dst, &maps->wg, bar, n0, k0, it.slot);
    tma_load_3d(dst + TILE_BYTES, &maps->wu, bar, n0, k0, it.slot);
    tma_load_3d(dst + 2 * TILE_BYTES, &maps->wd, bar, k0, n0, it.slot);
    tma_load_2d(dst + 3 * TILE_BYTES, &maps->x[w], bar, k0, r0);
    tma_load_2d(dst + 4 * TILE_BYTES, &maps->dy[w], bar, k0, r0);
  }
};

// Accumulator element i of thread (warp w of its warpgroup, lane l) sits
// at row w*16 + l/4 + 8*((i/2)%2) of the 64 weight rows and column
// 8*(i/4) + 2*(l%4) + i%2 of the warpgroup's NW columns (sm90_common.cuh).
template <int NW>
__device__ void act_epilogue(const float (&ag)[NW / 2],
                             const float (&au)[NW / 2],
                             const float (&ad)[NW / 2], const Item& it,
                             __nv_bfloat16* __restrict__ dg,
                             __nv_bfloat16* __restrict__ du,
                             __nv_bfloat16* __restrict__ h, int64_t M,
                             int64_t F) {
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int l = threadIdx.x % 32;
  const int64_t f_lo = it.n0 + w * 16 + l / 4;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int t = wg * NW + 8 * (i / 4) + 2 * (l % 4) + i % 2;
    const int64_t f = f_lo + 8 * ((i / 2) % 2);
    const int64_t row = it.row0 + t;
    if (t < it.ntok && row < M && f < F) {
      const float g = round_bf16(ag[i]), u = round_bf16(au[i]);
      const float dh = round_bf16(ad[i]);
      const float s = 1.0f / (1.0f + expf(-g));
      const float a = round_bf16(g * s);
      const float da = round_bf16(dh * u);
      const int64_t o = row * F + f;
      h[o] = __float2bfloat16_rn(a * u);
      du[o] = __float2bfloat16_rn(dh * a);
      dg[o] = __float2bfloat16_rn(da * (s * (1.0f + g * (1.0f - s))));
    }
  }
}

// One item of (a): each warpgroup NW token columns, three products over D.
template <int NW, class LD>
__device__ void act_item(const Ring<S_A, STAGE_A>& ring, LD& ld, int& q,
                         int n_k, const Item& it, __nv_bfloat16* dg,
                         __nv_bfloat16* du, __nv_bfloat16* h, int64_t M,
                         int64_t F) {
  float ag[NW / 2], au[NW / 2], ad[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) ag[i] = au[i] = ad[i] = 0.0f;
  const uint32_t half = (threadIdx.x / 128) * NW * 128;
  for (int s = 0; s < n_k; ++s, ++q) {
    ring.wait_full(q);
    const uint32_t st = ring.stage(q);
    const uint32_t bx = st + 3 * TILE_BYTES + half;
    const uint32_t bd = st + 4 * TILE_BYTES + half;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t x = desc_sw128(bx + kk * 32);
      wgmma<NW, 1>(ag, desc_sw128(st + kk * 2048), x);
      wgmma<NW, 1>(au, desc_sw128(st + TILE_BYTES + kk * 2048), x);
      wgmma<NW, 0>(ad, desc_sw128(st + 2 * TILE_BYTES + kk * 32),
                   desc_sw128(bd + kk * 32));
    }
    wgmma_commit();
    advance(ld, ring, q, s == 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    fence_reg(ag[i]);
    fence_reg(au[i]);
    fence_reg(ad[i]);
  }
  ring.release(q - 1);
  act_epilogue<NW>(ag, au, ad, it, dg, du, h, M, F);
}

__global__ void __launch_bounds__(THREADS, 1)
    act_kernel(const __grid_constant__ ActMaps maps,
               const int* __restrict__ gs, int G, int Gw,
               __nv_bfloat16* __restrict__ dg, __nv_bfloat16* __restrict__ du,
               __nv_bfloat16* __restrict__ h, int64_t M, int64_t D,
               int64_t F) {
  using Lay = Layout<S_A, STAGE_A>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  int* tstart = reinterpret_cast<int*>(sm + Lay::SCAN);
  int* rstart = tstart + MAX_SLOTS + 1;
  const int n_slots = min(G, Gw);
  scan_slots(gs, n_slots, static_cast<int>((F + PART_ROWS - 1) / PART_ROWS),
             tstart, rstart);  // ends in a barrier
  if (static_cast<int>(blockIdx.x) >= tstart[n_slots]) return;
  const Ring<S_A, STAGE_A> ring{sm, smem_u32(sm)};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int n_k = static_cast<int>((D + BK - 1) / BK);
  const ActSrc src{&maps, tstart, rstart, n_slots, n_k};
  Loader<S_A, STAGE_A, ActSrc> ld(src);
  prime(ld, ring);
  int q = 0;
  Item it;
  for (int j = 0; src.get(j, it); ++j) {
    if (it.ntok <= 16)
      act_item<8>(ring, ld, q, n_k, it, dg, du, h, M, F);
    else if (it.ntok <= 32)
      act_item<16>(ring, ld, q, n_k, it, dg, du, h, M, F);
    else
      act_item<32>(ring, ld, q, n_k, it, dg, du, h, M, F);
  }
}

// ----------------------------------------------------------------- (b) dx
struct DxMaps {
  CUtensorMap wg, wu;       // [Gw, D, F]
  CUtensorMap dg[4], du[4];  // [M, F] by 8, 16, 32, 64 rows
};

struct DxSrc {
  using Item = sm90::Item;
  const DxMaps* maps;
  const int* tstart;
  const int* rstart;
  int n_slots, n_k;

  __device__ bool get(int j, Item& it) const {
    return sched_item(tstart, rstart, n_slots, j, it);
  }
  __device__ int stages(const Item&) const { return n_k; }
  // Stage s (F from 64 s): Wg and Wu [64 D][64 F], the token rows of dg
  // and du [rows][64 F].
  __device__ void load(const Item& it, int s, uint32_t dst,
                       uint32_t bar) const {
    const int w = tok_index(it.ntok);
    mbar_expect(bar, 2 * TILE_BYTES + 2 * ((8 << w) * 128));
    const int n0 = static_cast<int>(it.n0), k0 = s * BK;
    const int r0 = static_cast<int>(it.row0);
    tma_load_3d(dst, &maps->wg, bar, k0, n0, it.slot);
    tma_load_3d(dst + TILE_BYTES, &maps->wu, bar, k0, n0, it.slot);
    tma_load_2d(dst + 2 * TILE_BYTES, &maps->dg[w], bar, k0, r0);
    tma_load_2d(dst + 3 * TILE_BYTES, &maps->du[w], bar, k0, r0);
  }
};

template <int NW, class LD>
__device__ void dx_item(const Ring<S_B, STAGE_B>& ring, LD& ld, int& q,
                        int n_k, const Item& it,
                        __nv_bfloat16* __restrict__ dx, int64_t M,
                        int64_t D) {
  float ag[NW / 2], au[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) ag[i] = au[i] = 0.0f;
  const uint32_t half = (threadIdx.x / 128) * NW * 128;
  for (int s = 0; s < n_k; ++s, ++q) {
    ring.wait_full(q);
    const uint32_t st = ring.stage(q);
    const uint32_t bg = st + 2 * TILE_BYTES + half;
    const uint32_t bu = st + 3 * TILE_BYTES + half;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma<NW, 0>(ag, desc_sw128(st + kk * 32), desc_sw128(bg + kk * 32));
      wgmma<NW, 0>(au, desc_sw128(st + TILE_BYTES + kk * 32),
                   desc_sw128(bu + kk * 32));
    }
    wgmma_commit();
    advance(ld, ring, q, s == 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    fence_reg(ag[i]);
    fence_reg(au[i]);
  }
  ring.release(q - 1);
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int l = threadIdx.x % 32;
  const int64_t d_lo = it.n0 + w * 16 + l / 4;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int t = wg * NW + 8 * (i / 4) + 2 * (l % 4) + i % 2;
    const int64_t d = d_lo + 8 * ((i / 2) % 2);
    const int64_t row = it.row0 + t;
    if (t < it.ntok && row < M && d < D)
      dx[row * D + d] =
          __float2bfloat16_rn(round_bf16(ag[i]) + round_bf16(au[i]));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    dx_kernel(const __grid_constant__ DxMaps maps,
              const int* __restrict__ gs, int G, int Gw,
              __nv_bfloat16* __restrict__ dx, int64_t M, int64_t D,
              int64_t F) {
  using Lay = Layout<S_B, STAGE_B>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  int* tstart = reinterpret_cast<int*>(sm + Lay::SCAN);
  int* rstart = tstart + MAX_SLOTS + 1;
  const int n_slots = min(G, Gw);
  scan_slots(gs, n_slots, static_cast<int>((D + PART_ROWS - 1) / PART_ROWS),
             tstart, rstart);  // ends in a barrier
  // zeros past the slots with weights: rows [R, M), D a multiple of 8
  const int64_t r_end = min(static_cast<int64_t>(rstart[n_slots]), M);
  uint4* tail = reinterpret_cast<uint4*>(dx + r_end * D);
  const int64_t n_vec = (M - r_end) * D / 8;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n_vec; i += static_cast<int64_t>(gridDim.x) * THREADS)
    tail[i] = make_uint4(0, 0, 0, 0);
  if (static_cast<int>(blockIdx.x) >= tstart[n_slots]) return;
  const Ring<S_B, STAGE_B> ring{sm, smem_u32(sm)};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const int n_k = static_cast<int>((F + BK - 1) / BK);
  const DxSrc src{&maps, tstart, rstart, n_slots, n_k};
  Loader<S_B, STAGE_B, DxSrc> ld(src);
  prime(ld, ring);
  int q = 0;
  Item it;
  for (int j = 0; src.get(j, it); ++j) {
    if (it.ntok <= 16)
      dx_item<8>(ring, ld, q, n_k, it, dx, M, D);
    else if (it.ntok <= 32)
      dx_item<16>(ring, ld, q, n_k, it, dx, M, D);
    else
      dx_item<32>(ring, ld, q, n_k, it, dx, M, D);
  }
}

// ----------------------------------------------------------------- (c) dW
// Gradient `which` of slot g: out[g] [Ma, Nb] = A[rows]^T . B[rows] with
// (A, B, out) = (xs, dg, dWg), (xs, du, dWu), (h, dy, dWd).
struct DwMaps {
  CUtensorMap a[3], b[3];  // [M, Ma] and [M, Nb] by 64 rows
};

struct DwItem {
  int slot, which, rows;
  int64_t m0, n0, row0, ma, nb;
};

struct DwSrc {
  using Item = DwItem;
  const DwMaps* maps;
  const int* rstart;
  int n_slots, n_items, tiles;
  int64_t D, F;

  // Items slot-major, then by gradient, then by tile, so that the blocks
  // at work at one time share the slot's rows through L2.
  __device__ bool get(int j, DwItem& it) const {
    const int id = static_cast<int>(blockIdx.x) + j * gridDim.x;
    if (id >= n_items) return false;
    it.slot = id / (3 * tiles);
    it.which = (id / tiles) % 3;
    const int t = id % tiles;
    it.ma = it.which == 2 ? F : D;
    it.nb = it.which == 2 ? D : F;
    const int tn = static_cast<int>((it.nb + 127) / 128);
    it.m0 = static_cast<int64_t>(t / tn) * 128;
    it.n0 = static_cast<int64_t>(t % tn) * 128;
    const bool live = it.slot < n_slots;
    it.row0 = live ? rstart[it.slot] : 0;
    it.rows = live ? rstart[it.slot + 1] - rstart[it.slot] : 0;
    return true;
  }
  __device__ int stages(const DwItem& it) const {
    return (it.rows + 63) / 64;
  }
  // Stage s (the slot's rows from 64 s): A [64 rows][64 of Ma] at m0 and
  // m0 + 64, B [64 rows][64 of Nb] at n0 and n0 + 64; a half wholly past
  // its matrix is not loaded (its products land outside the output).
  __device__ void load(const DwItem& it, int s, uint32_t dst,
                       uint32_t bar) const {
    const bool a1 = it.m0 + 64 < it.ma, b1 = it.n0 + 64 < it.nb;
    mbar_expect(bar, (2 + a1 + b1) * TILE_BYTES);
    const int r = static_cast<int>(it.row0) + s * 64;
    const int m0 = static_cast<int>(it.m0), n0 = static_cast<int>(it.n0);
    const CUtensorMap* a = &maps->a[it.which];
    const CUtensorMap* b = &maps->b[it.which];
    tma_load_2d(dst, a, bar, m0, r);
    if (a1) tma_load_2d(dst + TILE_BYTES, a, bar, m0 + 64, r);
    tma_load_2d(dst + 2 * TILE_BYTES, b, bar, n0, r);
    if (b1) tma_load_2d(dst + 3 * TILE_BYTES, b, bar, n0 + 64, r);
  }
};

// Rows [valid, 64) of the stage's four tiles to zero (the next slot's
// rows), visible to the wgmma of both warpgroups.
__device__ __forceinline__ void zero_rows_past(unsigned char* stage,
                                               int valid) {
  const int per_tile = (64 - valid) * 8;  // 16-byte chunks
  for (int e = threadIdx.x; e < 4 * per_tile; e += THREADS) {
    const int tile = e / per_tile, c = e % per_tile;
    *reinterpret_cast<uint4*>(stage + tile * TILE_BYTES + valid * 128 +
                              c * 16) = make_uint4(0, 0, 0, 0);
  }
  fence_async_smem();
  __syncthreads();
}

// The zero tile of a slot without rows, row by row in 16-byte stores (Nb
// a multiple of 32, so a store lies wholly inside or outside the output).
__device__ __forceinline__ void zero_tile(const DwItem& it,
                                          __nv_bfloat16* __restrict__ o) {
  for (int e = threadIdx.x; e < 128 * 16; e += THREADS) {
    const int64_t m = it.m0 + e / 16, c = it.n0 + (e % 16) * 8;
    if (m < it.ma && c < it.nb)
      *reinterpret_cast<uint4*>(o + m * it.nb + c) = make_uint4(0, 0, 0, 0);
  }
}

template <class LD>
__device__ void dw_item(const Ring<S_C, STAGE_C>& ring, LD& ld, int& q,
                        const DwItem& it, __nv_bfloat16* const* out) {
  __nv_bfloat16* o = out[it.which] + static_cast<int64_t>(it.slot) * it.ma *
                                         it.nb;
  const int n = (it.rows + 63) / 64;
  if (n == 0) {  // block-uniform
    zero_tile(it, o);
    return;
  }
  float a0[32], a1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a0[i] = a1[i] = 0.0f;
  const uint32_t half = (threadIdx.x / 128) * TILE_BYTES;
  for (int s = 0; s < n; ++s, ++q) {
    ring.wait_full(q);
    if (s == n - 1 && it.rows - s * 64 < 64)  // block-uniform
      zero_rows_past(ring.stage_ptr(q), it.rows - s * 64);
    const uint32_t st = ring.stage(q);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a = desc_sw128(st + half + kk * 2048);
      wgmma<64, 1, 1>(a0, a, desc_sw128(st + 2 * TILE_BYTES + kk * 2048));
      wgmma<64, 1, 1>(a1, a, desc_sw128(st + 3 * TILE_BYTES + kk * 2048));
    }
    wgmma_commit();
    advance(ld, ring, q, s == 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    fence_reg(a0[i]);
    fence_reg(a1[i]);
  }
  ring.release(q - 1);
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int l = threadIdx.x % 32;
  const int64_t m_lo = it.m0 + wg * 64 + w * 16 + l / 4;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int64_t m = m_lo + 8 * ((i / 2) % 2);
    const int64_t c = it.n0 + 8 * (i / 4) + 2 * (l % 4);
    if (m >= it.ma) continue;
    if (c < it.nb)
      *reinterpret_cast<__nv_bfloat162*>(o + m * it.nb + c) =
          __floats2bfloat162_rn(a0[i], a0[i + 1]);
    if (c + 64 < it.nb)
      *reinterpret_cast<__nv_bfloat162*>(o + m * it.nb + c + 64) =
          __floats2bfloat162_rn(a1[i], a1[i + 1]);
  }
}

struct DwOut {
  __nv_bfloat16* p[3];  // dWg, dWu, dWd
};

__global__ void __launch_bounds__(THREADS, 1)
    dw_kernel(const __grid_constant__ DwMaps maps,
              const int* __restrict__ gs, int G, int Gw, DwOut out,
              int64_t D, int64_t F) {
  using Lay = Layout<S_C, STAGE_C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  int* tstart = reinterpret_cast<int*>(sm + Lay::SCAN);
  int* rstart = tstart + MAX_SLOTS + 1;
  const int n_slots = min(G, Gw);
  scan_slots(gs, n_slots, 1, tstart, rstart);  // ends in a barrier
  const int tiles = static_cast<int>(((D + 127) / 128) * ((F + 127) / 128));
  const int n_items = Gw * 3 * tiles;
  if (static_cast<int>(blockIdx.x) >= n_items) return;
  const Ring<S_C, STAGE_C> ring{sm, smem_u32(sm)};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const DwSrc src{&maps, rstart, n_slots, n_items, tiles, D, F};
  Loader<S_C, STAGE_C, DwSrc> ld(src);
  prime(ld, ring);
  int q = 0;
  DwItem it;
  for (int j = 0; src.get(j, it); ++j) dw_item(ring, ld, q, it, out.p);
}

// ---------------------------------------------------------------- launch
// The three launches; M > 0 and Gw > 0 (the wrapper zeroes otherwise),
// G <= MAX_SLOTS.
int launch(const void* xs, const void* gs, int64_t G, int64_t Gw,
           const void* w_gate, const void* w_up, const void* w_down,
           const void* dy, void* dg, void* du, void* h, void* dxs,
           void* dw_gate, void* dw_up, void* dw_down, int64_t M, int64_t D,
           int64_t F, cudaStream_t stream) {
  if (M <= 0 || Gw <= 0 || G > MAX_SLOTS || G < Gw || encoder() == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int BYTES_A = Layout<S_A, STAGE_A>::BYTES;
  constexpr int BYTES_B = Layout<S_B, STAGE_B>::BYTES;
  constexpr int BYTES_C = Layout<S_C, STAGE_C>::BYTES;
  cudaError_t err = bind_device();
  if (err == cudaSuccess) err = allow_smem<&act_kernel, BYTES_A>();
  if (err == cudaSuccess) err = allow_smem<&dx_kernel, BYTES_B>();
  if (err == cudaSuccess) err = allow_smem<&dw_kernel, BYTES_C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows[4] = {8, 16, 32, 64};
  ActMaps am;
  DxMaps xm;
  DwMaps wm;
  bool ok = plain_weight_map(&am.wg, w_gate, Gw, F, D) &&
            plain_weight_map(&am.wu, w_up, Gw, F, D) &&
            plain_weight_map(&am.wd, w_down, Gw, D, F);
  for (int i = 0; i < 4; ++i)
    ok = ok && token_map(&am.x[i], xs, M, D, rows[i]) &&
         token_map(&am.dy[i], dy, M, D, rows[i]) &&
         token_map(&xm.dg[i], dg, M, F, rows[i]) &&
         token_map(&xm.du[i], du, M, F, rows[i]);
  xm.wg = am.wg;
  xm.wu = am.wu;
  wm.a[0] = wm.a[1] = am.x[3];
  wm.b[0] = xm.dg[3];
  wm.b[1] = xm.du[3];
  wm.b[2] = am.dy[3];
  ok = ok && token_map(&wm.a[2], h, M, F, 64);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count(), g = static_cast<int>(G);
  const int gw = static_cast<int>(Gw);
  const int* gsi = static_cast<const int*>(gs);
  act_kernel<<<sms, THREADS, BYTES_A, stream>>>(
      am, gsi, g, gw, static_cast<__nv_bfloat16*>(dg),
      static_cast<__nv_bfloat16*>(du), static_cast<__nv_bfloat16*>(h), M, D,
      F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_kernel<<<sms, THREADS, BYTES_B, stream>>>(
      xm, gsi, g, gw, static_cast<__nv_bfloat16*>(dxs), M, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwOut out{{static_cast<__nv_bfloat16*>(dw_gate),
                   static_cast<__nv_bfloat16*>(dw_up),
                   static_cast<__nv_bfloat16*>(dw_down)}};
  dw_kernel<<<sms, THREADS, BYTES_C, stream>>>(wm, gsi, g, gw, out, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace sm90
}  // namespace
