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

template <typename T>
__global__ void quantize_fp4_kernel(const T* __restrict__ w,
                                    const float* __restrict__ gscale,
                                    uint8_t* __restrict__ packed,
                                    float* __restrict__ scales, int64_t G,
                                    int64_t N, int64_t K, int64_t sg,
                                    int64_t sn, int64_t sk) {
  const int64_t ng = K / nvfp4::GROUP;
  const int64_t total = G * N * ng;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  int64_t g, n, kg;
  if (sk == 1) {  // K contiguous: neighbouring threads walk along K
    kg = idx % ng;
    const int64_t r = idx / ng;
    n = r % N;
    g = r / N;
  } else {        // neighbouring threads walk along N
    n = idx % N;
    const int64_t r = idx / N;
    kg = r % ng;
    g = r / ng;
  }
  const T* src = w + g * sg + n * sn + kg * nvfp4::GROUP * sk;
  float v[nvfp4::GROUP];
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
           int64_t sk, void* stream) {
  const int64_t total = G * N * (K / nvfp4::GROUP);
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  quantize_fp4_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<const float*>(gscale),
      static_cast<uint8_t*>(packed), static_cast<float*>(scales), G, N, K,
      sg, sn, sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w: [G, N, K] with element strides (sg, sn, sk); gscale: f32[1] on the
// device; packed: u8 [G, N, K/2]; scales: f32 [G, N, K/16] (contiguous).
// K must be a multiple of 32.  Returns cudaGetLastError() after the launch.
int quantize_fp4_bf16(const void* w, const void* gscale, void* packed,
                      void* scales, int64_t G, int64_t N, int64_t K,
                      int64_t sg, int64_t sn, int64_t sk, void* stream) {
  return launch<__nv_bfloat16>(w, gscale, packed, scales, G, N, K, sg, sn,
                               sk, stream);
}

int quantize_fp4_f32(const void* w, const void* gscale, void* packed,
                     void* scales, int64_t G, int64_t N, int64_t K,
                     int64_t sg, int64_t sn, int64_t sk, void* stream) {
  return launch<float>(w, gscale, packed, scales, G, N, K, sg, sn, sk,
                       stream);
}

}  // extern "C"
