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
// global_scale_for(w) = max(max|w| * (1 / (6 * 448)), 1e-20) under the same
// predicate: a grid-stride pass takes max|w| of each group of 16 (the same
// addressing as the quantizer), reduces it over the block, and raises one
// int32 in device memory with atomicMax on the float's bits (non-negative
// floats order as their bits do); a one-thread kernel then applies the
// multiply and the clamp.  max is exact in any order, so the scale is
// bitwise equal to the plain version's.  Bytes bound it: it reads the stack
// once.
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

template <typename T>
__global__ void __launch_bounds__(AMAX_THREADS)
    amax_kernel(const T* __restrict__ w, const int* __restrict__ pred,
                unsigned* __restrict__ amax_bits, int64_t G, int64_t N,
                int64_t K, int64_t sg, int64_t sn, int64_t sk) {
  if (!enabled(pred)) return;
  const int64_t ng = K / nvfp4::GROUP;
  const int64_t total = G * N * ng;
  float amax = 0.0f;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const Group q = group_at(idx, N, ng, sk);
    float v[nvfp4::GROUP];
    load_group<T>(w + q.g * sg + q.n * sn + q.kg * nvfp4::GROUP * sk, sk, v);
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  unsigned bits = __float_as_uint(amax);
  bits = __reduce_max_sync(0xffffffffu, bits);
  __shared__ unsigned warp_max[AMAX_THREADS / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < AMAX_THREADS / 32; ++i) m = max(m, warp_max[i]);
    atomicMax(amax_bits, m);
  }
}

__global__ void global_scale_kernel(const int* __restrict__ pred,
                                    const unsigned* __restrict__ amax_bits,
                                    float* __restrict__ gscale) {
  if (!enabled(pred)) return;
  *gscale = fmaxf(__uint_as_float(*amax_bits) * INV_FP4_E4M3, 1e-20f);
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

template <typename T>
int launch_scale(const void* w, const void* pred, void* amax_bits,
                 void* gscale, int64_t G, int64_t N, int64_t K, int64_t sg,
                 int64_t sn, int64_t sk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = G * N * (K / nvfp4::GROUP);
  if (total > 0) {
    // a few blocks per SM, each looping over its share of the groups
    const int64_t want = (total + AMAX_THREADS - 1) / AMAX_THREADS;
    const int64_t blocks = want < 132 * 8 ? want : 132 * 8;
    amax_kernel<T><<<static_cast<unsigned>(blocks), AMAX_THREADS, 0, s>>>(
        static_cast<const T*>(w), static_cast<const int*>(pred),
        static_cast<unsigned*>(amax_bits), G, N, K, sg, sn, sk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  global_scale_kernel<<<1, 1, 0, s>>>(static_cast<const int*>(pred),
                                      static_cast<const unsigned*>(amax_bits),
                                      static_cast<float*>(gscale));
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

// The global scale of w (as above) into gscale f32[1]; amax_bits: int32[1]
// scratch, zeroed by the caller.  With pred present and 0, writes nothing.
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
