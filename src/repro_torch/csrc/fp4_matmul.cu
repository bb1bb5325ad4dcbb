// W4(A4) GEMM for Hopper (sm_90a): y = a4?(x) . deq(W)^T with W stored as
// packed NVFP4 (E2M1 codes + E4M3-valued group-16 scales + a global scale).
//
// Replaces: src/repro/kernels/fp4_matmul.py, fp4_matmul_kernel (Pallas body
// _matmul_kernel).  Same function: x [M, K] (bf16 or f32) is cast to f32
// and, with a4, fake-quantized per group of 16 along K (dynamic amax/6
// scale); W [N, K] is decoded as level * (scale * global_scale), the
// Pallas kernel's order (the jnp oracle multiplies (level * scale) *
// global_scale); products accumulate in f32; y [M, N] is f32 or bf16.
//
// What bounds it on the H100: operations.  The function is an f32 product
// (the Pallas kernel casts x to f32 and decodes W to f32), which the card
// runs on its f32 FMA units at 67 TFLOP/s: at the expert projection
// x [4096, 2048] . W [1408, 2048]^T that is 23.6 GFLOP, 0.35 ms, against
// 42 MB of traffic (0.0125 ms at 3.35 TB/s).  A bf16 tensor-core form
// (0.024 ms) would round the decoded W and x to bf16 and miss the
// reference's rtol 1e-5; it is left to a later design.
//
// Design: a classic shared-memory SGEMM.  A block computes a 128 x 128
// tile of y with 256 threads, each an 8 x 8 register tile (rows
// {4ty..4ty+3, 64+4ty..}, columns likewise, so every shared-memory read is
// a conflict-free float4).  Per K step of 32 each thread loads one group of
// 16 of x (a4 applied in registers) and decodes one group of 16 of W, and
// stores both transposed into [k][m] and [k][n] f32 tiles.  M and N are
// masked at the edges; K must be a multiple of 32.  No cp.async pipelining
// yet: loads and FMAs alternate, separated by __syncthreads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "nvfp4.cuh"

namespace {

constexpr int BM = 128;       // rows of y per block
constexpr int BN = 128;       // columns of y per block
constexpr int BK = 32;        // K per step: two groups of 16
constexpr int NT = 256;       // threads: a 16 x 16 grid of 8 x 8 tiles
constexpr int LDA = BM + 4;   // [k][m] tile row stride (16-byte rows)
constexpr int LDB = BN + 4;   // [k][n] tile row stride

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// Four consecutive outputs of a row, `left` of them inside y; one vector
// store when `vec` (N % 4 == 0) and all four are inside.
__device__ __forceinline__ void store4(float* dst, const float* c,
                                       int64_t left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(c[0], c[1], c[2], c[3]);
    return;
  }
  for (int j = 0; j < 4 && j < left; ++j) dst[j] = c[j];
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* c,
                                       int64_t left, bool vec) {
  if (vec && left >= 4) {
    uint2 raw;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = __float2bfloat16_rn(c[j]);
    *reinterpret_cast<uint2*>(dst) = raw;
    return;
  }
  for (int j = 0; j < 4 && j < left; ++j) dst[j] = __float2bfloat16_rn(c[j]);
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(NT)
    fp4_matmul_kernel(const TX* __restrict__ x,
                      const uint8_t* __restrict__ packed,
                      const float* __restrict__ scales,
                      const float* __restrict__ gscale, TY* __restrict__ y,
                      int64_t M, int64_t N, int64_t K, int a4) {
  __shared__ __align__(16) float As[BK * LDA];
  __shared__ __align__(16) float Bs[BK * LDB];
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // loader: row (of x) / column (of W) r of the tile, group gi of the step
  const int r = tid % BM, gi = tid / BM;
  const float gs = *gscale;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    const int64_t k = k0 + gi * nvfp4::GROUP;
    float v[nvfp4::GROUP];
    const int64_t m = m0 + r;
    if (m < M) {
      load16<TX>(x + m * K + k, v);
      if (a4) nvfp4::fake_quant_a4_group(v);
    } else {
#pragma unroll
      for (int i = 0; i < nvfp4::GROUP; ++i) v[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i)
      As[(gi * nvfp4::GROUP + i) * LDA + r] = v[i];

    const int64_t n = n0 + r;
    if (n < N) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(packed + n * (K / 2) + k / 2);
      const float sg = scales[n * (K / nvfp4::GROUP) + k / nvfp4::GROUP] * gs;
#pragma unroll
      for (int i = 0; i < nvfp4::GROUP; ++i) {
        const uint32_t word = i < 8 ? raw.x : raw.y;
        v[i] = nvfp4::decode_level((word >> (4 * (i % 8))) & 0xFu) * sg;
      }
    } else {
#pragma unroll
      for (int i = 0; i < nvfp4::GROUP; ++i) v[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < nvfp4::GROUP; ++i)
      Bs[(gi * nvfp4::GROUP + i) * LDB + r] = v[i];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_lo =
          *reinterpret_cast<const float4*>(&As[kk * LDA + ty * 4]);
      const float4 a_hi =
          *reinterpret_cast<const float4*>(&As[kk * LDA + 64 + ty * 4]);
      const float4 b_lo =
          *reinterpret_cast<const float4*>(&Bs[kk * LDB + tx * 4]);
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&Bs[kk * LDB + 64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                          a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w,
                          b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool vec = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int64_t n = n0 + jh * 64 + tx * 4;
      if (n < N) store4(y + m * N + n, &acc[i][jh * 4], N - n, vec);
    }
  }
}

template <typename TX, typename TY>
int launch(const void* x, const void* packed, const void* scales,
           const void* gscale, void* y, int64_t M, int64_t N, int64_t K,
           int a4, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + BM - 1) / BM));
  fp4_matmul_kernel<TX, TY><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(gscale),
      static_cast<TY*>(y), M, N, K, a4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: [M, K] contiguous (bf16 or f32, by the entry's first type); packed:
// u8 [N, K/2]; scales: f32 [N, K/16]; gscale: f32[1] on the device; y:
// [M, N] contiguous (f32 or bf16, by the second type).  K must be a
// multiple of 32; a4 != 0 fake-quantizes x.  Returns cudaGetLastError().
int fp4_matmul_bf16_f32(const void* x, const void* packed, const void* scales,
                        const void* gscale, void* y, int64_t M, int64_t N,
                        int64_t K, int a4, void* stream) {
  return launch<__nv_bfloat16, float>(x, packed, scales, gscale, y, M, N, K,
                                      a4, stream);
}

int fp4_matmul_f32_f32(const void* x, const void* packed, const void* scales,
                       const void* gscale, void* y, int64_t M, int64_t N,
                       int64_t K, int a4, void* stream) {
  return launch<float, float>(x, packed, scales, gscale, y, M, N, K, a4,
                              stream);
}

int fp4_matmul_bf16_bf16(const void* x, const void* packed,
                         const void* scales, const void* gscale, void* y,
                         int64_t M, int64_t N, int64_t K, int a4,
                         void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, packed, scales, gscale, y,
                                              M, N, K, a4, stream);
}

int fp4_matmul_f32_bf16(const void* x, const void* packed, const void* scales,
                        const void* gscale, void* y, int64_t M, int64_t N,
                        int64_t K, int a4, void* stream) {
  return launch<float, __nv_bfloat16>(x, packed, scales, gscale, y, M, N, K,
                                      a4, stream);
}

}  // extern "C"
