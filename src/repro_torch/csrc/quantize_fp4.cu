// NVFP4 weight quantizer for Hopper (sm_90a): ReaLB's precision
// transformation, BF16 expert weights -> packed E2M1 codes + E4M3-valued
// group-16 scales.
//
// Replaces: src/repro/kernels/quantize_fp4.py, quantize_fp4_kernel (Pallas
// body _quantize_kernel).  It computes the same function, bitwise: per group
// of 16 along K, s = max(e4m3_round(amax * (1/6) / gs), 2^-9), codes of
// w / (s * gs), two codes per byte with the even index in the low nibble.
//
// What bounds it on the H100: bytes.  It reads 2 B (bf16) and writes
// 0.5 + 0.25 B per weight and does some 60 simple operations per weight, far
// below the card's ~295 operations per byte of memory traffic.  Design: one
// thread per group of 16, no shared memory, no reduction across threads.
// The input is any strided [G, N, K] view, so the serving path quantizes
// w.transpose(-1, -2) of the [E, D, F] parameter in place, without a
// transposed copy.  Consecutive threads take consecutive indices of the
// unit-stride dimension: along K (two 16-byte loads per thread) when K is
// contiguous, along N otherwise (each warp load then covers 64 contiguous
// bytes).  Outputs are contiguous [G, N, K/2] u8 and [G, N, K/16] f32.
//
// The device predicate.  ReaLB decides per MoE layer, on the device,
// whether to quantize (the reference's lax.cond).  Both entries below take
// an optional int32[1] predicate: every block reads it and returns at once
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

template <typename T>
__global__ void quantize_fp4_kernel(const T* __restrict__ w,
                                    const float* __restrict__ gscale,
                                    const int* __restrict__ pred,
                                    uint8_t* __restrict__ packed,
                                    float* __restrict__ scales, int64_t G,
                                    int64_t N, int64_t K, int64_t sg,
                                    int64_t sn, int64_t sk) {
  if (!enabled(pred)) return;
  const int64_t ng = K / nvfp4::GROUP;
  const int64_t total = G * N * ng;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const Group q = group_at(idx, N, ng, sk);
  const int64_t g = q.g, n = q.n, kg = q.kg;
  float v[nvfp4::GROUP];
  load_group<T>(w + g * sg + n * sn + kg * nvfp4::GROUP * sk, sk, v);
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < nvfp4::GROUP; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float gs = *gscale;
  const float t = amax * nvfp4::INV_FP4_MAX;
  const float s = fmaxf(nvfp4::e4m3_round(t / gs), 0.001953125f);  // 2^-9
  const float denom = s * gs;
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < nvfp4::GROUP; ++i) {
    const uint32_t code = nvfp4::fp4_code(v[i] / denom);
    word[i / 8] |= code << (4 * (i % 8));
  }
  const int64_t row = g * N + n;
  reinterpret_cast<uint2*>(packed + row * (K / 2))[kg] =
      make_uint2(word[0], word[1]);
  scales[row * ng + kg] = s;
}

template <typename T>
int launch(const void* w, const void* gscale, void* packed, void* scales,
           int64_t G, int64_t N, int64_t K, int64_t sg, int64_t sn,
           int64_t sk, const void* pred, void* stream) {
  const int64_t total = G * N * (K / nvfp4::GROUP);
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  quantize_fp4_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const float*>(gscale),
      static_cast<const int*>(pred), static_cast<uint8_t*>(packed),
      static_cast<float*>(scales), G, N, K, sg, sn, sk);
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
