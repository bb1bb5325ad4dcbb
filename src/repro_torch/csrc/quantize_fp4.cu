// NVFP4 weight quantizer for Hopper (sm_90a): ReaLB's precision
// transformation, BF16 expert weights -> packed E2M1 codes + E4M3-valued
// group-16 scales.
//
// Replaces: src/repro/kernels/quantize_fp4.py, quantize_fp4_kernel (Pallas
// body _quantize_kernel).  It computes the same function, bitwise: per group
// of 16 along K, s = max(e4m3_round(amax * (1/6) / gs), 2^-9), codes of
// w / (s * gs), two codes per byte with the even index in the low nibble.
//
// What bounds it on the H100: bytes, closely followed by issue slots.  It
// reads 2 B (bf16) and writes 0.5 + 0.25 B per weight: 507.5 MB, 0.15 ms at
// 3.35 TB/s for a [64, 1408, 2048] stack.  Its ~25 instructions per
// weight (a true IEEE division, the level search, the packing) come to
// about as much at the SMs' issue rate, so the loads must stay in flight
// while it computes; on the card the arithmetic sets its pace (0.33 ms at
// the serving views, 0.26 ms K contiguous, where all 2048 threads an SM
// fit).
// The input is any strided [G, N, K] view: the serving path quantizes
// w.transpose(-1, -2) of the [E, D, F] parameter in place, without a
// transposed copy.  Outputs are contiguous [G, N, K/2] u8 and [G, N, K/16]
// f32.  Two kernels, both on a grid sized from the SM count:
//  * sn == 1 (the serving views, any layout but sk == 1): tiles of 64 along
//    N by 128 along K, loaded with 16-byte loads along N into shared
//    memory, quantized there one group per thread, and stored as whole row
//    runs (64 bytes of codes, 32 of scales per row) from a staging buffer
//    padded against bank conflicts.  One thread per group straight from
//    device memory (the previous design) wrote 8-byte codes and 4-byte
//    scales a row apart, one 32-byte sector each: 4x and 8x their bytes.
//    A persistent grid of 6 blocks per SM walks the tiles.
//  * sk == 1 (a contiguous [N, K] weight): one thread per group with two
//    16-byte loads, grid-stride over at most 16 blocks per SM.
// Under a 0 predicate a launch is one short wave of blocks that read it and
// exit (the previous grid was sized for the work: 45,056 blocks).

// The device predicate.  ReaLB decides per MoE layer, on the device,
// whether to quantize (the reference's lax.cond).  Both entries below take
// an optional int32[1] predicate: every block reads it once and returns
// when it is 0, so the host enqueues the launch without reading the flag.
//
// The global scale.  global_scale_fp4_* computes the reference's
// global_scale_for(w) = max(max|w| * (1 / (6 * 448)), 1e-20) (jitted: a
// multiply by the f32 reciprocal) under the same predicate, in one launch.
// Bytes bound it: it reads the stack once (369 MB, 0.110 ms at 3.35 TB/s
// for a serving view).
//  * Every serving view, and fp4_linear's w.transpose(0, 1)[None], is a
//    permutation of one contiguous block (its strides, sorted, are 1,
//    s0, s0 s1).  Then max|w| is the max over numel contiguous elements in
//    any order: a grid from the SM count reads them flat, four 16-byte
//    loads in flight a thread, with a head and a tail for a base that is
//    not 16-byte aligned or a numel that is not a multiple of the vector.
//    Other views walk groups of 16 along K, as the quantizer addresses
//    them; on the serving views that walk makes 16 scalar loads a thread,
//    sk apart (64 bytes a warp load), and issue slots, not bytes, set its
//    pace.
//  * The max is taken on bits: for non-negative floats integer order is
//    float order, so |v| is the bits with the sign cleared and two bf16
//    magnitudes a word reduce with one __vmaxu2.  A NaN's bits lie above
//    infinity's, so a NaN wins, as in the plain version (torch.amax and
//    jnp.max propagate it; fmaxf would drop it).
//  * Blocks meet in a two-word scratch in device memory: each raises word 0
//    with atomicMax and takes a ticket from word 1; the last block reads
//    the max, zeroes both words for the next launch and applies the
//    multiply and the clamp.  max is exact in any order, so the scale is
//    bitwise equal to the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nvfp4.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// f32(1) / f32(6 * 448), the reciprocal XLA multiplies by
constexpr float INV_FP4_E4M3 = 1.0f / 2688.0f;
constexpr int AMAX_THREADS = 256;
constexpr int AMAX_BLOCKS_PER_SM = 4;  // 1024 threads an SM
constexpr int AMAX_UNROLL = 4;         // 16-byte loads in flight a thread

// False when the optional device predicate is present and 0.
__device__ __forceinline__ bool enabled(const int* pred) {
  return pred == nullptr || *pred != 0;
}

struct Group {
  int64_t g, n, kg;
};

// The idx-th group of 16 along K: neighbouring indices walk the unit-stride
// dimension (K when contiguous, N otherwise).
__device__ __forceinline__ Group group_at(int64_t idx, int64_t N, int64_t ng,
                                          int64_t sk) {
  Group r;
  if (sk == 1) {
    r.kg = idx % ng;
    const int64_t q = idx / ng;
    r.n = q % N;
    r.g = q / N;
  } else {
    r.n = idx % N;
    const int64_t q = idx / N;
    r.kg = q % ng;
    r.g = q / ng;
  }
  return r;
}

// The 16 values of a group as f32 (16-byte loads when K is contiguous).
template <typename T>
__device__ __forceinline__ void load_group(const T* src, int64_t sk,
                                           float* v) {
  if (sk == 1 && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    constexpr int PER_VEC = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < nvfp4::GROUP / PER_VEC; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER_VEC; ++i) v[c * PER_VEC + i] = to_f32<T>(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i) v[i] = to_f32<T>(src[i * sk]);
  }
}

// Running max of magnitudes as integer bits: bf16 keeps two magnitudes a
// word (one a half), f32 one.
template <typename T>
struct AbsMax;
template <>
struct AbsMax<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t word(uint32_t m, uint32_t w) {
    return __vmaxu2(m, w & 0x7fff7fffu);
  }
  static __device__ __forceinline__ uint32_t elem(uint32_t m,
                                                  __nv_bfloat16 v) {
    return __vmaxu2(m, __bfloat16_as_ushort(v) & 0x7fffu);
  }
  // the larger half as the bits of the f32 of the same value
  static __device__ __forceinline__ uint32_t f32_bits(uint32_t m) {
    return max(m & 0xffffu, m >> 16) << 16;
  }
};
template <>
struct AbsMax<float> {
  static __device__ __forceinline__ uint32_t word(uint32_t m, uint32_t w) {
    return max(m, w & 0x7fffffffu);
  }
  static __device__ __forceinline__ uint32_t elem(uint32_t m, float v) {
    return max(m, __float_as_uint(v) & 0x7fffffffu);
  }
  static __device__ __forceinline__ uint32_t f32_bits(uint32_t m) {
    return m;
  }
};

template <typename T>
__device__ __forceinline__ uint32_t max_vec(uint32_t m, uint4 v) {
  m = AbsMax<T>::word(m, v.x);
  m = AbsMax<T>::word(m, v.y);
  m = AbsMax<T>::word(m, v.z);
  return AbsMax<T>::word(m, v.w);
}

// Every block: its max into scratch[0] and a ticket from scratch[1]; the
// last block writes the scale and leaves the scratch zeroed.
template <typename T>
__device__ void finish_scale(uint32_t m, unsigned* __restrict__ scratch,
                             float* __restrict__ gscale) {
  __shared__ unsigned warp_max[AMAX_THREADS / 32];
  unsigned bits = __reduce_max_sync(0xffffffffu, AbsMax<T>::f32_bits(m));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = bits;
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < AMAX_THREADS / 32; ++i) bits = max(bits, warp_max[i]);
  atomicMax(&scratch[0], bits);
  __threadfence();  // the max lands before the ticket
  if (atomicAdd(&scratch[1], 1u) != gridDim.x - 1) return;
  __threadfence();  // every block's max is seen after every ticket
  const float s = __uint_as_float(atomicExch(&scratch[0], 0u)) *
                  INV_FP4_E4M3;
  scratch[1] = 0u;
  *gscale = s != s ? s : fmaxf(s, 1e-20f);  // a NaN stays a NaN
}

// A dense view: n elements from w, flat.
template <typename T>
__global__ void __launch_bounds__(AMAX_THREADS)
    amax_flat_kernel(const T* __restrict__ w, int64_t n,
                     const int* __restrict__ pred,
                     unsigned* __restrict__ scratch,
                     float* __restrict__ gscale) {
  if (!enabled(pred)) return;
  constexpr int VEC = 16 / sizeof(T);
  const int64_t head = min(
      n, static_cast<int64_t>(
             ((16u - (reinterpret_cast<uintptr_t>(w) & 15u)) & 15u) /
             sizeof(T)));
  const int64_t nvec = (n - head) / VEC;
  const int64_t tail = head + nvec * VEC;  // first element after the body
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * AMAX_THREADS +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * AMAX_THREADS;
  uint32_t m = 0;
  // head and tail, fewer than 2 * VEC elements: the grid's first threads
  if (tid < head + (n - tail))
    m = AbsMax<T>::elem(m, w[tid < head ? tid : tail + (tid - head)]);
  const uint4* body = reinterpret_cast<const uint4*>(w + head);
  int64_t i = tid;
  for (; i + (AMAX_UNROLL - 1) * stride < nvec; i += AMAX_UNROLL * stride) {
    uint4 v[AMAX_UNROLL];
#pragma unroll
    for (int u = 0; u < AMAX_UNROLL; ++u) v[u] = __ldg(body + i + u * stride);
#pragma unroll
    for (int u = 0; u < AMAX_UNROLL; ++u) m = max_vec<T>(m, v[u]);
  }
  for (; i < nvec; i += stride) m = max_vec<T>(m, __ldg(body + i));
  finish_scale<T>(m, scratch, gscale);
}

// Any other view (K a multiple of 16): groups of 16 along K, neighbouring
// indices along the unit-stride dimension, as the quantizer addresses them.
template <typename T>
__global__ void __launch_bounds__(AMAX_THREADS)
    amax_groups_kernel(const T* __restrict__ w, const int* __restrict__ pred,
                       unsigned* __restrict__ scratch,
                       float* __restrict__ gscale, int64_t G, int64_t N,
                       int64_t K, int64_t sg, int64_t sn, int64_t sk) {
  if (!enabled(pred)) return;
  const int64_t ng = K / nvfp4::GROUP;
  const int64_t total = G * N * ng;
  uint32_t m = 0;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * AMAX_THREADS +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * AMAX_THREADS) {
    const Group q = group_at(idx, N, ng, sk);
    const T* src = w + q.g * sg + q.n * sn + q.kg * nvfp4::GROUP * sk;
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i)
      m = AbsMax<T>::elem(m, src[i * sk]);
  }
  finish_scale<T>(m, scratch, gscale);
}

// Quantize the 16 values v of one group: its E4M3-valued scale and its 16
// codes, two per byte, the even index in the low nibble.
__device__ __forceinline__ float quantize_group(const float* v, float gs,
                                                uint2& packed) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < nvfp4::GROUP; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float t = amax * nvfp4::INV_FP4_MAX;
  const float s = fmaxf(nvfp4::e4m3_round(t / gs), 0.001953125f);  // 2^-9
  const float denom = s * gs;
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < nvfp4::GROUP; ++i) {
    const uint32_t code = nvfp4::fp4_code(v[i] / denom);
    word[i / 8] |= code << (4 * (i % 8));
  }
  packed = make_uint2(word[0], word[1]);
  return s;
}

// K contiguous (sk == 1): one thread per group, grid-stride; neighbouring
// threads take neighbouring groups of a row, so the two 16-byte loads of a
// thread and its 8-byte and 4-byte stores are contiguous across the warp.
template <typename T>
__global__ void __launch_bounds__(256)
    quantize_rows_kernel(const T* __restrict__ w,
                         const float* __restrict__ gscale,
                         const int* __restrict__ pred,
                         uint8_t* __restrict__ packed,
                         float* __restrict__ scales, int64_t G, int64_t N,
                         int64_t K, int64_t sg, int64_t sn) {
  if (!enabled(pred)) return;
  const float gs = *gscale;
  const int64_t ng = K / nvfp4::GROUP;
  const int64_t total = G * N * ng;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const Group q = group_at(idx, N, ng, 1);
    float v[nvfp4::GROUP];
    load_group<T>(w + q.g * sg + q.n * sn + q.kg * nvfp4::GROUP, 1, v);
    uint2 pk;
    const float s = quantize_group(v, gs, pk);
    const int64_t row = q.g * N + q.n;
    reinterpret_cast<uint2*>(packed + row * (K / 2))[q.kg] = pk;
    scales[row * ng + q.kg] = s;
  }
}

// Any other layout (the serving views w.transpose(-1, -2), sn == 1): a
// persistent grid walks [TN x TK] tiles of the view.  A tile is read along
// the unit-stride dimension N (16-byte loads when the view allows, else
// element loads, both coalesced when sn == 1), held as [TK][TN] in shared
// memory, quantized one group of 16 along K per thread (neighbouring
// threads on neighbouring n: no bank conflicts), and its codes and scales
// are staged per row and stored as whole row runs (64 bytes of codes and
// 32 of scales per row of a full tile).  Six blocks per SM keep loads in
// flight while others quantize (measured on the [64, 1408, 2048] view:
// holding the next tile in registers at four blocks per SM was 7 % slower;
// four blocks per SM, or tiles 256 deep along K, no faster or slower).
constexpr int TN = 64, TK = 128;
constexpr int Q_THREADS = 256;
constexpr int Q_BLOCKS_PER_SM = 6;
constexpr int PK_LD = TK / 2 + 8;   // bytes per staged row of codes
constexpr int SC_LD = TK / 16 + 1;  // floats per staged row of scales

template <typename T>
struct TileLoad {
  static constexpr int VEC = 16 / sizeof(T);            // elements a chunk
  static constexpr int CHUNKS = TK * TN / VEC / Q_THREADS;  // per thread
  uint4 r[CHUNKS];

  // chunk c of this thread: row k = q / (TN / VEC) of the tile, columns
  // (q % (TN / VEC)) * VEC onwards; zeros outside the view
  __device__ void load(const T* __restrict__ w, int64_t N, int64_t K,
                       int64_t sg, int64_t sn, int64_t sk, bool vec,
                       int64_t g, int64_t n0, int64_t k0) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int q = threadIdx.x + c * Q_THREADS;
      const int64_t k = k0 + q / (TN / VEC);
      const int64_t n = n0 + (q % (TN / VEC)) * VEC;
      const T* src = w + g * sg + k * sk + n * sn;
      if (vec && k < K && n + VEC <= N) {
        r[c] = *reinterpret_cast<const uint4*>(src);
      } else {
        T* e = reinterpret_cast<T*>(&r[c]);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          e[i] = (k < K && n + i < N) ? src[i * sn] : T(0.0f);
      }
    }
  }

  __device__ void store(T* tile) const {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
      reinterpret_cast<uint4*>(tile)[threadIdx.x + c * Q_THREADS] = r[c];
  }
};

template <typename T>
__global__ void __launch_bounds__(Q_THREADS, Q_BLOCKS_PER_SM)
    quantize_tiles_kernel(const T* __restrict__ w,
                          const float* __restrict__ gscale,
                          const int* __restrict__ pred,
                          uint8_t* __restrict__ packed,
                          float* __restrict__ scales, int64_t G, int64_t N,
                          int64_t K, int64_t sg, int64_t sn, int64_t sk,
                          bool vec) {
  __shared__ __align__(16) T tile[TK * TN];
  __shared__ __align__(16) uint8_t pk_st[TN * PK_LD];
  __shared__ float sc_st[TN * SC_LD];
  if (!enabled(pred)) return;
  const float gs = *gscale;
  const int64_t ntn = (N + TN - 1) / TN, ntk = (K + TK - 1) / TK;
  const int64_t total = G * ntk * ntn;
  const int64_t ng = K / nvfp4::GROUP;
  int64_t t = blockIdx.x;
  if (t >= total) return;
  TileLoad<T> ld;
  auto origin = [&](int64_t tt, int64_t& g, int64_t& n0, int64_t& k0) {
    n0 = (tt % ntn) * TN;  // neighbouring blocks: neighbouring n tiles
    k0 = ((tt / ntn) % ntk) * TK;
    g = tt / (ntn * ntk);
  };
  int64_t g, n0, k0;
  for (; t < total; t += gridDim.x) {
    origin(t, g, n0, k0);
    ld.load(w, N, K, sg, sn, sk, vec, g, n0, k0);
    ld.store(tile);
    __syncthreads();
    const int n = threadIdx.x % TN;
#pragma unroll
    for (int j = 0; j < TK / nvfp4::GROUP * TN / Q_THREADS; ++j) {
      const int kg = threadIdx.x / TN + j * (Q_THREADS / TN);
      float v[nvfp4::GROUP];
#pragma unroll
      for (int i = 0; i < nvfp4::GROUP; ++i)
        v[i] = to_f32<T>(tile[(kg * nvfp4::GROUP + i) * TN + n]);
      uint2 pk;
      sc_st[n * SC_LD + kg] = quantize_group(v, gs, pk);
      *reinterpret_cast<uint2*>(pk_st + n * PK_LD + kg * 8) = pk;
    }
    __syncthreads();
    // whole row runs: 8 bytes of codes, then one scale, per thread
    for (int q = threadIdx.x; q < TN * (TK / 16); q += Q_THREADS) {
      const int r = q / (TK / 16), c = q % (TK / 16);
      const int64_t nn = n0 + r, kg = k0 / nvfp4::GROUP + c;
      if (nn < N && kg < ng) {
        const int64_t row = g * N + nn;
        reinterpret_cast<uint2*>(packed + row * (K / 2))[kg] =
            *reinterpret_cast<const uint2*>(pk_st + r * PK_LD + c * 8);
        scales[row * ng + kg] = sc_st[r * SC_LD + c];
      }
    }
  }
}

// Multiprocessors of the current device (read once per device).
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <typename T>
int launch(const void* w, const void* gscale, void* packed, void* scales,
           int64_t G, int64_t N, int64_t K, int64_t sg, int64_t sn,
           int64_t sk, const void* pred, void* stream) {
  const int64_t total = G * N * (K / nvfp4::GROUP);
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wt = static_cast<const T*>(w);
  const auto* gsc = static_cast<const float*>(gscale);
  const auto* p = static_cast<const int*>(pred);
  auto* pk = static_cast<uint8_t*>(packed);
  auto* sc = static_cast<float*>(scales);
  if (sk == 1) {
    const int64_t want = (total + 255) / 256;
    const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
    quantize_rows_kernel<T><<<static_cast<unsigned>(want < cap ? want : cap),
                              256, 0, s>>>(wt, gsc, p, pk, sc, G, N, K, sg,
                                           sn);
  } else {
    constexpr int VEC = 16 / sizeof(T);
    const bool vec = sn == 1 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                     sg % VEC == 0 && sk % VEC == 0;
    const int64_t tiles = G * ((N + TN - 1) / TN) * ((K + TK - 1) / TK);
    const int64_t cap = static_cast<int64_t>(sm_count()) * Q_BLOCKS_PER_SM;
    quantize_tiles_kernel<T>
        <<<static_cast<unsigned>(tiles < cap ? tiles : cap), Q_THREADS, 0,
           s>>>(wt, gsc, p, pk, sc, G, N, K, sg, sn, sk, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// True when the view [G, N, K] with these strides is a permutation of
// one contiguous block: its strides, sorted (size-1 dimensions aside), are
// 1, s0, s0 s1.
bool dense(int64_t G, int64_t N, int64_t K, int64_t sg, int64_t sn,
           int64_t sk) {
  int64_t size[3] = {G, N, K}, stride[3] = {sg, sn, sk};
  for (int a = 0; a < 3; ++a)  // sort by stride
    for (int b = a + 1; b < 3; ++b)
      if (stride[b] < stride[a]) {
        const int64_t t = stride[a], u = size[a];
        stride[a] = stride[b], size[a] = size[b];
        stride[b] = t, size[b] = u;
      }
  int64_t expect = 1;
  for (int a = 0; a < 3; ++a) {
    if (size[a] == 1) continue;
    if (stride[a] != expect) return false;
    expect *= size[a];
  }
  return true;
}

template <typename T>
int launch_scale(const void* w, const void* pred, void* scratch,
                 void* gscale, int64_t G, int64_t N, int64_t K, int64_t sg,
                 int64_t sn, int64_t sk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wt = static_cast<const T*>(w);
  const auto* p = static_cast<const int*>(pred);
  auto* sc = static_cast<unsigned*>(scratch);
  auto* gsc = static_cast<float*>(gscale);
  const int64_t cap = static_cast<int64_t>(sm_count()) * AMAX_BLOCKS_PER_SM;
  if (dense(G, N, K, sg, sn, sk)) {
    const int64_t per_block =
        static_cast<int64_t>(AMAX_THREADS) * AMAX_UNROLL * (16 / sizeof(T));
    const int64_t want = (G * N * K + per_block - 1) / per_block;
    amax_flat_kernel<T><<<static_cast<unsigned>(want < 1 ? 1
                                                : want < cap ? want : cap),
                          AMAX_THREADS, 0, s>>>(wt, G * N * K, p, sc, gsc);
  } else {
    if (K % nvfp4::GROUP) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t want = (G * N * (K / nvfp4::GROUP) + AMAX_THREADS - 1) /
                         AMAX_THREADS;
    amax_groups_kernel<T><<<static_cast<unsigned>(want < 1 ? 1
                                                  : want < cap ? want : cap),
                            AMAX_THREADS, 0, s>>>(wt, p, sc, gsc, G, N, K, sg,
                                                  sn, sk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w: [G, N, K] with element strides (sg, sn, sk); gscale: f32[1] on the
// device; packed: u8 [G, N, K/2]; scales: f32 [G, N, K/16] (contiguous);
// pred: int32[1] on the device, or null (always run): when it holds 0 the
// kernel writes nothing.  K must be a multiple of 32.  Returns
// cudaGetLastError() after the launch.
int quantize_fp4_bf16(const void* w, const void* gscale, void* packed,
                      void* scales, int64_t G, int64_t N, int64_t K,
                      int64_t sg, int64_t sn, int64_t sk, const void* pred,
                      void* stream) {
  return launch<__nv_bfloat16>(w, gscale, packed, scales, G, N, K, sg, sn,
                               sk, pred, stream);
}

int quantize_fp4_f32(const void* w, const void* gscale, void* packed,
                     void* scales, int64_t G, int64_t N, int64_t K,
                     int64_t sg, int64_t sn, int64_t sk, const void* pred,
                     void* stream) {
  return launch<float>(w, gscale, packed, scales, G, N, K, sg, sn, sk, pred,
                       stream);
}

// The global scale of w (as above, any K when the view is dense, else K a
// multiple of 16) into gscale f32[1], in one kernel launch; amax_bits:
// int32[2] scratch, zero before the first launch and left zero by each
// (launches that share it must run in order, on one stream).  With pred
// present and 0, writes nothing.
int global_scale_fp4_bf16(const void* w, const void* pred, void* amax_bits,
                          void* gscale, int64_t G, int64_t N, int64_t K,
                          int64_t sg, int64_t sn, int64_t sk, void* stream) {
  return launch_scale<__nv_bfloat16>(w, pred, amax_bits, gscale, G, N, K, sg,
                                     sn, sk, stream);
}

int global_scale_fp4_f32(const void* w, const void* pred, void* amax_bits,
                         void* gscale, int64_t G, int64_t N, int64_t K,
                         int64_t sg, int64_t sn, int64_t sk, void* stream) {
  return launch_scale<float>(w, pred, amax_bits, gscale, G, N, K, sg, sn, sk,
                             stream);
}

}  // extern "C"
