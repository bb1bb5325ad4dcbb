// The Hopper design of the grouped SwiGLU expert FFN with bf16 weights (the
// entry grouped_ffn_bf16, the MoE layer's BF16 branch), included by
// grouped_fp4_ffn.cu, whose header says what it computes.
//
// What bounds it on the H100: bytes.  Every slot with a routed row reads
// its three [2048, 1408] bf16 matrices once (17.3 MB a slot, 1.1 GB with
// all 64 experts live: 0.33 ms at 3.35 TB/s), while the products of a
// prefill chunk's 50-6000 routed rows need 0.002-0.1 ms at 989 TFLOP/s.
// So the design keeps enough weight bytes in flight and does nothing else
// to them:
//  * swap A and B and persistent work items, as sm90_common.cuh says.  A
//    slot of 17 rows pads to a 32-wide token tile, not to a 64-row one,
//    and a slot without rows costs nothing.
//  * the weights come straight from device memory by TMA, as they lie:
//    w_gate/w_up [Gw, D, F] and w_down [Gw, F, D] have the weight-row side
//    (F, or D for down) contiguous, so after the swap A is MN-major.  A
//    TMA box of 64 weight rows (128 bytes) by 64 along K lands as 64 rows
//    of 128 bytes, one per K, in the 128-byte swizzle, which wgmma reads
//    with its transpose flag for A (desc_sw128 says how the descriptor
//    steps).  No copy, decode or relayout of the parameters: the MoE
//    layer's decode path and the quantizer read them in this layout too.
//  * a ring of 4 stages, each the two parts' weight tiles and the token
//    tile (24 KB): thread 0 keeps 3 stages in flight, 72 KB a block and
//    144 KB an SM (about 25 KB an SM cover 3.35 TB/s at ~1 us of latency).
//    Each stage's wgmma is waited for at once and one barrier a stage frees
//    its slot; the tensor cores are idle most of the time anyway.
//  * all-zero counts (the branch the decision did not take): every block
//    scans the counts and exits, one wave, no prep kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

// Internal linkage, as in sm90_common.cuh.
namespace {
namespace sm90 {

constexpr int PLAIN_STAGES = 4;
constexpr int W_TILE_BYTES = BK * PART_ROWS * 2;  // [64 K][64 rows] bf16
constexpr int PLAIN_STAGE_BYTES = 2 * W_TILE_BYTES + TOK_BYTES;

// Shared-memory layout: the scan's tables, the ring's mbarriers, the ring
// (a stage: part 0's and part 1's weight tiles, then the token tile), from
// a 1024-byte boundary.
struct PlainSmem {
  static constexpr int SCAN = 0;
  static constexpr int BARS = (SCAN_BYTES + 15) / 16 * 16;
  static constexpr int RING =
      (BARS + PLAIN_STAGES * 8 + 1023) / 1024 * 1024;
  static_assert(RING + PLAIN_STAGES * PLAIN_STAGE_BYTES + 1024 <= SMEM_BYTES,
                "shared memory");
};

// Thread 0: the TMA loads of stage s of an item (both parts' weight tiles
// and the token tile) into ring slot q % PLAIN_STAGES, q counting the
// block's stages, completing on that slot's barrier.
template <int NMAT, int N>
__device__ __forceinline__ void load_plain_stage(unsigned char* sm,
                                                 const Maps& maps, int q,
                                                 int s, const Item& it) {
  const int slot = q % PLAIN_STAGES;
  const uint32_t bar = smem_u32(sm + PlainSmem::BARS) + slot * 8;
  const uint32_t base =
      smem_u32(sm + PlainSmem::RING + slot * PLAIN_STAGE_BYTES);
  mbar_expect(bar, 2 * W_TILE_BYTES + N * BK * 2);
#pragma unroll
  for (int p = 0; p < 2; ++p)
    tma_load_3d(base + p * W_TILE_BYTES, &maps.w[part_mat<NMAT>(p)], bar,
                static_cast<int>(it.n0) + part_row0<NMAT>(p), s * BK,
                it.slot);
  tma_load_2d(base + 2 * W_TILE_BYTES, tok_map<N>(maps), bar, s * BK,
              static_cast<int>(it.row0));
}

// The wgmma of ring slot `slot`: each warpgroup multiplies its part (64
// weight rows, MN-major) by the token tile (K-major), four k16 steps.
template <int N>
__device__ __forceinline__ void mma_plain_stage(unsigned char* sm, int slot,
                                                float (&acc)[N / 2]) {
  const uint32_t base =
      smem_u32(sm + PlainSmem::RING + slot * PLAIN_STAGE_BYTES);
  const uint32_t a = base + (threadIdx.x / 128) * W_TILE_BYTES;
  const uint32_t b = base + 2 * W_TILE_BYTES;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma<N, 1>(acc, desc_sw128(a + kk * 16 * 128),
                desc_sw128(b + kk * 32));
  wgmma_commit();
}

// acc = this warpgroup's part . act[tokens, :]^T over all of K; the item's
// stage s is the block's stage q = q0 + s.  At stage s thread 0 loads stage
// s + 3 into the slot that stage s - 1 freed, the block waits for stage s,
// multiplies it, waits for its wgmma and meets at a barrier.
template <int NMAT, int N>
__device__ void plain_mainloop(unsigned char* sm, const Maps& maps,
                               int64_t K, const Item& it, int q0,
                               float (&acc)[N / 2]) {
  const int n_stages = static_cast<int>((K + BK - 1) / BK);
  const uint32_t bars = smem_u32(sm + PlainSmem::BARS);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  if (threadIdx.x == 0)
    for (int s = 0; s < PLAIN_STAGES - 1 && s < n_stages; ++s)
      load_plain_stage<NMAT, N>(sm, maps, q0 + s, s, it);
  for (int s = 0; s < n_stages; ++s) {
    const int q = q0 + s;
    if (threadIdx.x == 0 && s + PLAIN_STAGES - 1 < n_stages)
      load_plain_stage<NMAT, N>(sm, maps, q + PLAIN_STAGES - 1,
                                s + PLAIN_STAGES - 1, it);
    mbar_wait(bars + (q % PLAIN_STAGES) * 8, (q / PLAIN_STAGES) & 1);
    mma_plain_stage<N>(sm, q % PLAIN_STAGES, acc);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_reg(acc[i]);
    __syncthreads();
  }
}

// Gate/up epilogue, on warpgroup 0 (gate) with up from warpgroup 1 through
// shared memory: h = bf16(bf16(silu(bf16(gate))) * bf16(up)), written to
// hq [M, F] (no a4: the BF16 branch).
template <int N>
__device__ void plain_gate_up_epilogue(const float (&acc)[N / 2],
                                       const float* __restrict__ up,
                                       const Item& it,
                                       __nv_bfloat16* __restrict__ hq,
                                       int64_t M, int64_t F) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int64_t f_lo = it.n0 + w * 16 + l / 4;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int t = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    const int64_t f = f_lo + 8 * ((i / 2) % 2);
    const int64_t row = it.row0 + t;
    const float g = round_bf16(acc[i]);
    const float u = round_bf16(up[i * 128 + threadIdx.x]);
    const float act = round_bf16(g * (1.0f / (1.0f + expf(-g))));
    if (t < it.ntok && row < M && f < F)
      hq[row * F + f] = __float2bfloat16_rn(act * u);
  }
}

template <int NMAT, int N>
__device__ void run_plain_item(unsigned char* sm, const Maps& maps,
                               int64_t NR, int64_t K, const Item& it, int q0,
                               __nv_bfloat16* dst, int64_t M) {
  float acc[N / 2];
  plain_mainloop<NMAT, N>(sm, maps, K, it, q0, acc);
  if constexpr (NMAT == 2) {
    // up's accumulators to warpgroup 0 through the ring, idle between items
    float* up = reinterpret_cast<float*>(sm + PlainSmem::RING);
    static_assert(NTOK / 2 * 128 * 4 <= PLAIN_STAGES * PLAIN_STAGE_BYTES,
                  "exchange fits");
    if (threadIdx.x >= 128) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) up[i * 128 + threadIdx.x - 128] = acc[i];
    }
    __syncthreads();
    if (threadIdx.x < 128)
      plain_gate_up_epilogue<N>(acc, up, it, dst, M, NR);
    fence_async_smem();  // before the next item's TMA loads overwrite `up`
    __syncthreads();
  } else {
    epilogue_down<N>(acc, it, dst, M, NR);
  }
}

// Persistent grouped product with bf16 weights: NMAT 2, gate and up of xs
// into hq; NMAT 1, down of hq into out.  With all-zero counts a block scans
// the counts and exits.
template <int NMAT>
__global__ void __launch_bounds__(THREADS, 2)
    plain_ffn_kernel(const __grid_constant__ Maps maps,
                     const int* __restrict__ gs, int G, int Gw,
                     __nv_bfloat16* __restrict__ dst, int64_t M, int64_t NR,
                     int64_t K) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  int* tstart = reinterpret_cast<int*>(sm + PlainSmem::SCAN);
  int* rstart = tstart + MAX_SLOTS + 1;
  const int n_slots = min(G, Gw);
  const int nwt = static_cast<int>((NR + item_rows<NMAT>() - 1) /
                                   item_rows<NMAT>());
  scan_slots(gs, n_slots, nwt, tstart, rstart);  // ends in a barrier
  if (static_cast<int>(blockIdx.x) >= tstart[n_slots]) return;
  if (threadIdx.x == 0) {
    for (int i = 0; i < PLAIN_STAGES; ++i)
      mbar_init(smem_u32(sm + PlainSmem::BARS + i * 8));
    fence_mbar_init();
  }
  __syncthreads();
  const int n_stages = static_cast<int>((K + BK - 1) / BK);
  // the block's j-th item starts at stage j * n_stages of its ring
  for_each_item<NMAT>(tstart, rstart, n_slots,
                      [&](const Item& it, int j, auto width) {
    run_plain_item<NMAT, decltype(width)::value>(sm, maps, NR, K, it,
                                                 j * n_stages, dst, M);
  });
}

bool plain_maps(Maps* maps, const void* w0, const void* w1, const void* act,
                int64_t Gw, int64_t NR, int64_t K, int64_t M) {
  if (encoder() == nullptr) return false;
  return plain_weight_map(&maps->w[0], w0, Gw, NR, K) &&
         plain_weight_map(&maps->w[1], w1, Gw, NR, K) &&
         token_maps(maps, act, M, K);
}

// The two launches of the bf16 plain FFN: gate/up into hq, down into out.
int launch_plain(const void* xs, const void* gs, int64_t G, int64_t Gw,
                 const void* w_gate, const void* w_up, const void* w_down,
                 void* hq, void* out, int64_t M, int64_t D, int64_t F,
                 cudaStream_t s) {
  if (M == 0 || G == 0 || Gw == 0) return 0;
  if (G > MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  // the tensor maps below are encoded on this thread, which may not have
  // the device's context bound yet (autograd's worker thread)
  cudaError_t err = bind_device();
  if (err == cudaSuccess) err = allow_smem<&plain_ffn_kernel<2>>();
  if (err == cudaSuccess) err = allow_smem<&plain_ffn_kernel<1>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps mgu, mdn;
  if (!plain_maps(&mgu, w_gate, w_up, xs, Gw, F, D, M) ||
      !plain_maps(&mdn, w_down, w_down, hq, Gw, D, F, M))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  const int* gsi = static_cast<const int*>(gs);
  plain_ffn_kernel<2><<<2 * sms, THREADS, SMEM_BYTES, s>>>(
      mgu, gsi, static_cast<int>(G), static_cast<int>(Gw),
      static_cast<__nv_bfloat16*>(hq), M, F, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plain_ffn_kernel<1><<<2 * sms, THREADS, SMEM_BYTES, s>>>(
      mdn, gsi, static_cast<int>(G), static_cast<int>(Gw),
      static_cast<__nv_bfloat16*>(out), M, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
