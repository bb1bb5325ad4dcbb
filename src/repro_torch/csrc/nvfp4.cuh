// NVFP4 (E2M1 values + E4M3-valued group-16 scales) arithmetic shared by the
// kernels.  Each function repeats repro_torch/kernels/nvfp4.py element for
// element, so the kernels agree with the plain PyTorch versions bitwise:
//  * divisions by a constant are multiplications by the f32 reciprocal (the
//    reference is jitted, and XLA compiles them so);
//  * rintf rounds half to even, like jnp.round / torch.round;
//  * divisions by a runtime value are true IEEE divisions (this file must be
//    compiled without --use_fast_math, which approximates '/' and flushes
//    denormals).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nvfp4 {

constexpr int GROUP = 16;
constexpr float INV_FP4_MAX = 0.16666667163372040f;  // f32(1) / f32(6)
constexpr float E4M3_MAX = 448.0f;

// Level index in [0, 7] of a magnitude: the count of E2M1 midpoints below it.
__device__ __forceinline__ int fp4_index(float mag) {
  return (mag > 0.25f) + (mag > 0.75f) + (mag > 1.25f) + (mag > 1.75f) +
         (mag > 2.5f) + (mag > 3.5f) + (mag > 5.0f);
}

// E2M1 magnitude of a level index: {0, .5, 1, 1.5, 2, 3, 4, 6}.
__device__ __forceinline__ float fp4_level(int idx) {
  const float f = static_cast<float>(idx);
  return idx < 4 ? 0.5f * f : (idx == 7 ? 6.0f : f - 2.0f);
}

// 4-bit code of a value already divided by its scale: bit 3 sign, 0..2 index.
__device__ __forceinline__ uint32_t fp4_code(float v) {
  return (v < 0.0f ? 8u : 0u) | static_cast<uint32_t>(fp4_index(fabsf(v)));
}

// Signed E2M1 value of a 4-bit code.
__device__ __forceinline__ float decode_level(uint32_t code) {
  const float lvl = fp4_level(static_cast<int>(code & 7u));
  return (code & 8u) ? -lvl : lvl;
}

// Round a non-negative f32 onto the FP8 E4M3 grid (nearest, ties to even,
// saturating at 448, denormal step 2^-9).  The exponent comes from the bits
// of the float; the reference's floor(log2(x)) can round up just below a
// power of two, but both choices then round to that same power of two.
__device__ __forceinline__ float e4m3_round(float x) {
  const float mag = fminf(fabsf(x), E4M3_MAX);
  if (mag == 0.0f) return 0.0f;
  int e = static_cast<int>((__float_as_uint(mag) >> 23) & 0xffu) - 127;
  e = max(-6, min(8, e));
  // mag * 2^(3-e) and q * 2^(e-3) are exact power-of-two scalings, the same
  // as the reference's mag / ulp and round(.) * ulp
  const float q = fminf(ldexpf(rintf(ldexpf(mag, 3 - e)), e - 3), E4M3_MAX);
  return x < 0.0f ? -q : q;
}

// Dynamic-scale activation fake-quant of one group of 16 values, in place:
// scale = max(amax * (1/6), 1e-20), v -> sign(v/scale) * level * scale.
__device__ __forceinline__ void fake_quant_a4_group(float* v) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < GROUP; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float gs = fmaxf(amax * INV_FP4_MAX, 1e-20f);
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const float r = v[i] / gs;
    const float sg = r > 0.0f ? 1.0f : (r < 0.0f ? -1.0f : r);  // sign(r)
    v[i] = (sg * fp4_level(fp4_index(fabsf(r)))) * gs;
  }
}

}  // namespace nvfp4
