// W4(A4) GEMM for Hopper (sm_90a): y = a4?(x) . deq(W)^T with W stored as
// packed NVFP4 (E2M1 codes + E4M3-valued group-16 scales + a global scale).
//
// Replaces: src/repro/kernels/fp4_matmul.py, fp4_matmul_kernel (Pallas body
// _matmul_kernel).  Same function: x [M, K] (bf16 or f32) taken as f32
// and, with a4, fake-quantized per group of 16 along K (dynamic scale
// s = max(amax * (1/6), 1e-20)); W [N, K] decoded as level * (scale * gs),
// the Pallas kernel's order; f32 accumulation; y [M, N] f32, or bf16
// rounded once from the f32 result.
//
// The arithmetic.  Per group g of 16 along K the product splits into an
// exact part and a scale:
//   y[m,n] = sum_g c[m,n,g] * P[m,n,g],  P[m,n,g] = sum_{k in g} a[m,k] l[n,k]
// with l the E2M1 level of W's code (exact in bf16) and c = scale[n,g] * gs;
// with a4, c = s[m,g] * (scale[n,g] * gs) and a is the level of x's code,
// chosen as nvfp4::fake_quant_a4_group chooses it.  bf16 x: a = x, and each
// product a * l has at most 10 significant bits; a4: both factors are
// levels; f32 x: x = b1 + b2 + b3 exactly, three bf16 terms split by
// truncation (round-to-nearest sends |x| above 3.3962e38 to inf;
// truncation never overflows), so three products.  The tensor cores form
// P with bf16 wgmma, one k16 step a group, and the promotion acc += P * c
// rounds once per group, an f32 FFMA.
//
// What bounds it on the H100: operations.  At the expert projection
// x [4096, 2048] . W [1408, 2048]^T, 23.6 GFLOP on the bf16 tensor cores
// take 0.0239 ms at 989 TFLOP/s (f32 x: three passes, 0.0717 ms), against
// 42 MB of traffic (0.0125 ms at 3.35 TB/s); the promotion's 0.74 G FMA
// (two operations an element with a4) run on the f32 pipes beside them.
//
// Design.  A block computes a 128 x 128 tile of y with three warpgroups,
// A and B swapped: W's rows are wgmma's M side (consumer warpgroup c takes
// rows 64c..64c+63), x's rows its N side (all 128), so the scale c of a
// thread's accumulators is one per W row, two a thread (and s[m] times
// it with a4).  Stages are 64 deep along K.  The producer warpgroup's
// thread 0 keeps a ring of raw stages of x in flight by TMA (bf16: 8
// stages of [128][64] tiles; 128-byte swizzle).  For each stage the
// producer's threads, a W row each, decode the codes and scales (loaded
// from global memory a stage ahead; W is L2-resident) into a swizzled
// bf16 level tile (prmt over constant byte tables) and c = scale * gs, in
// a ring of operand slots; bf16 x without a4 is read by wgmma where TMA
// put it, otherwise a thread also turns its x row into operand tiles:
// the three truncation terms (f32 x; TMA boxes [128][32]) or the a4
// levels and s (the level from seven exact thresholds a group, no
// division a value; bf16 x: in bf16x2 pairs).  Each consumer warpgroup,
// for each group, issues one wgmma m64n128k16 (three for f32 x) into a
// temporary accumulator with scale-d 0, waits for it and promotes it;
// the other consumer warpgroup's wgmma runs meanwhile.  (Two temporaries,
// one promoted while the next group's wgmma runs, need 192 registers
// where 384 threads leave 168, and ptxas allocates one count for the
// whole kernel, so setmaxnreg cannot help; two n64 halves a group, double
// buffered in 128 registers, measured slower, and so did consumers that
// decode their own W rows.)  Ragged M, N and K (a multiple of 32) come as
// TMA's zero fill and masked codes and scales; the epilogue masks M and
// N.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "nvfp4.cuh"
#include "sm90_common.cuh"

// Internal linkage, as in sm90_common.cuh.
namespace {
namespace mm {

using namespace sm90;

constexpr int BM = 128;                    // rows of x a block: wgmma's N
constexpr int BN = 128;                    // rows of W a block: 2 x 64
constexpr int BK = 64;                     // K a stage: four groups
constexpr int GROUPS = BK / nvfp4::GROUP;  // groups a stage
constexpr int NTHREADS = 384;              // producer + two consumers
constexpr int CONSUMERS = 256;
constexpr int TILE = BM * BK * 2;          // a [128][64] bf16 operand tile
constexpr int DEC_C = GROUPS * BN * 4;     // c = scale * gs, [GROUPS][BN]

// Shared-memory layout for x of type TX: OS operand slots, RS raw slots
// of x's TMA tiles, then the barriers (raw full, operand full, operand
// empty).  Operand slot: W's level tile [BN][64] and c [GROUPS][BN], then,
// unless DIRECT, x's P operand tiles [BM][64] (P = 3 for the f32 split)
// and, with a4, s [GROUPS][BM].  Tiles start on 1024-byte boundaries (the
// 128-byte swizzle repeats every 8 rows).
template <typename TX, bool A4>
struct Cfg {
  static constexpr bool F32 = std::is_same<TX, float>::value;
  static constexpr int P = F32 && !A4 ? 3 : 1;
  // bf16 x without a4: wgmma reads x's TMA tile in the raw slot itself
  static constexpr bool DIRECT = !F32 && !A4;
  static constexpr int XRAW = BM * BK * static_cast<int>(sizeof(TX));
  static constexpr int OP_C = TILE;
  static constexpr int OP_X = TILE + DEC_C;
  static constexpr int OP_S = OP_X + (DIRECT ? 0 : P) * TILE;
  static constexpr int OPB = OP_S + (A4 ? GROUPS * BM * 4 : 0);
  static constexpr int OS = DIRECT ? 3 : 2;
  static constexpr int RAW = OS * OPB;
  static constexpr int LIMIT = 232448 - 1024 - 256;
  static constexpr int FIT = (LIMIT - RAW) / XRAW;
  static constexpr int RS = FIT < 8 ? FIT : 8;
  static constexpr int RAW_FULL = RAW + RS * XRAW;
  static constexpr int FULL = RAW_FULL + RS * 8;
  static constexpr int EMPTY = FULL + OS * 8;
  static constexpr int SMEM = EMPTY + OS * 8 + 1024;
  static_assert(OP_X % 1024 == 0 && OPB % 1024 == 0, "tile alignment");
  static_assert(RS >= 2 && (!DIRECT || RS > OS) && SMEM <= 232448,
                "shared memory");
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// The producer warpgroup's own barrier.
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The tensor map of a launch, a kernel parameter: x [M, K] in the
// 128-byte swizzle.
struct Maps {
  CUtensorMap x;
};

// Thread 0 of the producer: the TMA load of x's tile of stage s into raw
// slot s % RS, completing on that slot's barrier.
template <typename TX, bool A4>
__device__ __forceinline__ void load_raw(unsigned char* sm, const Maps& maps,
                                         int s, int m0) {
  using C = Cfg<TX, A4>;
  const uint32_t raw = smem_u32(sm + C::RAW + (s % C::RS) * C::XRAW);
  const uint32_t bar = smem_u32(sm + C::RAW_FULL) + (s % C::RS) * 8;
  mbar_expect(bar, C::XRAW);
  tma_load_2d(raw, &maps.x, bar, s * BK, m0);
  if constexpr (C::F32)  // the second 32 along K: a 128-byte box too
    tma_load_2d(raw + BM * 128, &maps.x, bar, s * BK + 32, m0);
}

// Sixteen values of a group to the bf16 bits of their a4 levels (two a
// word) and the group's scale s, the levels nvfp4::fake_quant_a4_group
// picks, without its division per value.  The level index of v counts
// the E2M1 midpoints mid with RN(|v| / s) > mid.  A midpoint has at most
// three significant bits, so its last is even and a quotient halfway to
// the next f32 rounds down onto it: RN(q) > mid iff q > mid + ulp(mid)/2
// = m, iff |v| > m * s = mid * s + s * ulp(mid)/2 (the second term exact
// in f32), iff |v| > t with t that sum rounded down to f32: one fma in
// round-down mode.  Seven thresholds a group, three compares a value (the
// same binary search as nvfp4::fp4_index).
__device__ __forceinline__ float a4_levels(const float* v, uint32_t* w) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < nvfp4::GROUP; ++i) amax = fmaxf(amax, fabsf(v[i]));
  const float s = fmaxf(amax * nvfp4::INV_FP4_MAX, 1e-20f);
  const float mid[7] = {0.25f, 0.75f, 1.25f, 1.75f, 2.5f, 3.5f, 5.0f};
  const float half_ulp[7] = {0x1p-26f, 0x1p-25f, 0x1p-24f, 0x1p-24f,
                             0x1p-23f, 0x1p-23f, 0x1p-22f};
  float t[7];
#pragma unroll
  for (int i = 0; i < 7; ++i)  // one rounding: fma's, downwards
    t[i] = __fmaf_rd(mid[i], s, s * half_ulp[i]);
  // low and high bytes of the bf16 levels {0, .5, 1, 1.5, 2, 3, 4, 6}, as
  // byte tables that prmt indexes by level index (as decode4's)
  const uint32_t lo0 = 0xC0800000u, lo1 = 0xC0804000u;
  const uint32_t hi0 = 0x3F3F3F00u, hi1 = 0x40404040u;
#pragma unroll
  for (int i = 0; i < nvfp4::GROUP / 2; ++i) {
    uint32_t sel = 0, sign = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float x = v[2 * i + e], mag = fabsf(x);
      const bool b2 = mag > t[3];
      const bool b1 = mag > (b2 ? t[5] : t[1]);
      const bool b0 = mag > (b2 ? (b1 ? t[6] : t[4]) : (b1 ? t[2] : t[0]));
      sel |= static_cast<uint32_t>((b2 ? 4 : 0) | (b1 ? 2 : 0) | (b0 ? 1 : 0))
             << (4 * e);
      sign |= (x < 0.0f ? 0x8000u : 0u) << (16 * e);
    }
    const uint32_t lb = __byte_perm(lo0, lo1, sel);
    const uint32_t hb = __byte_perm(hi0, hi1, sel);
    w[i] = __byte_perm(lb, hb, 0x5140) | sign;
  }
  return s;
}

// The same for sixteen bf16 values (two a word), in bf16x2 arithmetic: a
// bf16 magnitude exceeds an f32 threshold t iff it exceeds t rounded down
// to bf16, and the level is the sum of the steps {.5, .5, .5, .5, 1, 1,
// 2} of the thresholds it exceeds (exact in bf16), so seven compares and
// seven fmas build a pair of levels; the sign is x's.
__device__ __forceinline__ float a4_levels_bf16(const uint32_t* u,
                                                uint32_t* w) {
  uint32_t mag[8];
  __nv_bfloat162 m2 = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mag[i] = u[i] & 0x7FFF7FFFu;
    m2 = __hmax2(m2, *reinterpret_cast<const __nv_bfloat162*>(&mag[i]));
  }
  const float amax = fmaxf(__low2float(m2), __high2float(m2));
  const float s = fmaxf(amax * nvfp4::INV_FP4_MAX, 1e-20f);
  const float mid[7] = {0.25f, 0.75f, 1.25f, 1.75f, 2.5f, 3.5f, 5.0f};
  const float half_ulp[7] = {0x1p-26f, 0x1p-25f, 0x1p-24f, 0x1p-24f,
                             0x1p-23f, 0x1p-23f, 0x1p-22f};
  const uint32_t step[7] = {0x3F003F00u, 0x3F003F00u, 0x3F003F00u,
                            0x3F003F00u, 0x3F803F80u, 0x3F803F80u,
                            0x40004000u};
  uint32_t t2[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const uint32_t hi = __float_as_uint(__fmaf_rd(mid[k], s, s * half_ulp[k]))
                        >> 16;
    t2[k] = hi | (hi << 16);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 m = *reinterpret_cast<const __nv_bfloat162*>(&mag[i]);
    __nv_bfloat162 lvl = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < 7; ++k)
      lvl = __hfma2(__hgt2(m, *reinterpret_cast<const __nv_bfloat162*>(&t2[k])),
                    *reinterpret_cast<const __nv_bfloat162*>(&step[k]), lvl);
    w[i] = *reinterpret_cast<const uint32_t*>(&lvl) | (u[i] & 0x80008000u);
  }
  return s;
}

// Sixteen f32 values to three bf16 terms each, v = b1 + b2 + b3 exactly
// (each term the top 16 bits of what is left), two values a word.
__device__ __forceinline__ void split3(const float* v, uint32_t (*w)[8]) {
#pragma unroll
  for (int i = 0; i < nvfp4::GROUP / 2; ++i) {
    uint32_t t[3][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float rest = v[2 * i + e];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        t[p][e] = __float_as_uint(rest) & 0xffff0000u;
        rest -= __uint_as_float(t[p][e]);
      }
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) w[p][i] = (t[p][0] >> 16) | t[p][1];
  }
}

// Raw slot -> operand slot, x row t (producer thread t): the three
// truncation terms (f32 x) or the a4 levels and s.  Chunk j of row t of
// an operand tile holds k = 8j..8j+7.
template <typename TX, bool A4>
__device__ __forceinline__ void transform_x(unsigned char* sm, int rslot,
                                            int oslot, int t) {
  using C = Cfg<TX, A4>;
  const unsigned char* raw = sm + C::RAW + rslot * C::XRAW;
  unsigned char* op = sm + oslot * C::OPB;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    uint32_t w[C::P][8];
    float* sx = reinterpret_cast<float*>(op + C::OP_S) + g * BM + t;
    if constexpr (C::F32) {
      float v[nvfp4::GROUP];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // half g/2 of the stage, chunks 4(g%2)..
        const float4 f = *reinterpret_cast<const float4*>(
            raw + (g / 2) * (BM * 128) + sw128(t, 4 * (g % 2) + q));
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
      if constexpr (A4) *sx = a4_levels(v, w[0]);
      else split3(v, w);
    } else {  // bf16 with a4
      uint32_t u[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 q = *reinterpret_cast<const uint4*>(raw +
                                                        sw128(t, 2 * g + h));
        u[4 * h] = q.x;
        u[4 * h + 1] = q.y;
        u[4 * h + 2] = q.z;
        u[4 * h + 3] = q.w;
      }
      *sx = a4_levels_bf16(u, w[0]);
    }
#pragma unroll
    for (int p = 0; p < C::P; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(op + C::OP_X + p * TILE +
                                  sw128(t, 2 * g + h)) =
            make_uint4(w[p][4 * h], w[p][4 * h + 1], w[p][4 * h + 2],
                       w[p][4 * h + 3]);
  }
}

// What a thread decodes of one stage: half `half` of its W row's codes
// (32 codes, 16 bytes) and their two scales, zeros past N, past K and
// past the last stage.  Loaded straight from global memory (a block's W
// is L2-resident) a stage ahead, from a clamped address; the mask applies
// when they are decoded (applied at once, it would wait for the load).
// The scales' rows are K/4 bytes apart, which TMA takes only when K % 64
// == 0.
struct Codes {
  uint4 codes;
  uint2 scales;
  uint32_t mask;
};

__device__ __forceinline__ Codes load_codes(const uint8_t* __restrict__ packed,
                                            const float* __restrict__ scales,
                                            int64_t row, bool row_ok, int s,
                                            int n_stages, int half,
                                            int64_t K) {
  const int64_t k = static_cast<int64_t>(s) * BK + 32 * half;
  const uint32_t mask = row_ok && s < n_stages && k < K ? ~0u : 0u;
  const int64_t kc = k < K ? k : K - 32;
  return {__ldg(reinterpret_cast<const uint4*>(packed + row * (K / 2) +
                                              kc / 2)),
          __ldg(reinterpret_cast<const uint2*>(scales + row * (K / 16) +
                                               kc / 16)),
          mask};
}

// Decode a thread's codes into row r of operand slot `op` (chunks
// 4 half..4 half+3 of the swizzled level tile; levels {0, .5, 1, 1.5, 2,
// 3, 4, 6} by prmt over constant byte tables) and c = scale * gs of its
// two groups.
__device__ __forceinline__ void decode(const Codes& cd, unsigned char* op,
                                       int r, int half, float gs) {
  const uint32_t lo[2] = {0xC0800000u, 0xC0804000u};
  const uint32_t hi[2] = {0x3F3F3F00u, 0x40404040u};
  const uint32_t words[4] = {cd.codes.x & cd.mask, cd.codes.y & cd.mask,
                             cd.codes.z & cd.mask, cd.codes.w & cd.mask};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t o[4];
    decode4(words[j], lo, hi, o[0], o[1]);
    decode4(words[j] >> 16, lo, hi, o[2], o[3]);
    *reinterpret_cast<uint4*>(op + sw128(r, 4 * half + j)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
  float* c = reinterpret_cast<float*>(op + TILE);
  c[(2 * half) * BN + r] = __uint_as_float(cd.scales.x & cd.mask) * gs;
  c[(2 * half + 1) * BN + r] = __uint_as_float(cd.scales.y & cd.mask) * gs;
}

// The producer warpgroup, a thread a row: for stage s, once the
// consumers have released operand slot s % OS (its last stage, s - OS),
// it decodes its W row into the slot (codes loaded a stage ahead) and,
// unless DIRECT, transforms its x row there from raw slot s % RS.  Thread
// 0 keeps the raw ring filled: with stage s + RS once stage s is
// transformed, or, DIRECT (the consumers read x in the raw slot), with
// stage s - OS + RS once the consumers have released stage s - OS (RS - OS
// stages of x ahead).
template <typename TX, bool A4>
__device__ void produce(unsigned char* sm, const Maps& maps,
                        const uint8_t* __restrict__ packed,
                        const float* __restrict__ scales, float gs,
                        int n_stages, int m0, int n0, int64_t N, int64_t K) {
  using C = Cfg<TX, A4>;
  const int t = threadIdx.x;
  const uint32_t raw_full = smem_u32(sm + C::RAW_FULL);
  const uint32_t full = smem_u32(sm + C::FULL);
  const uint32_t empty = smem_u32(sm + C::EMPTY);
  const bool row_ok = n0 + t < N;
  const int64_t row = row_ok ? n0 + t : 0;
  if (t == 0)
    for (int s = 0; s < C::RS && s < n_stages; ++s)
      load_raw<TX, A4>(sm, maps, s, m0);
  Codes next[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    next[h] = load_codes(packed, scales, row, row_ok, 0, n_stages, h, K);
  for (int s = 0; s < n_stages; ++s) {
    const int rslot = s % C::RS, oslot = s % C::OS;
    if (s >= C::OS) {
      mbar_wait(empty + oslot * 8, (s / C::OS - 1) & 1);
      if (C::DIRECT && t == 0 && s - C::OS + C::RS < n_stages)
        load_raw<TX, A4>(sm, maps, s - C::OS + C::RS, m0);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      decode(next[h], sm + oslot * C::OPB, t, h, gs);
      next[h] = load_codes(packed, scales, row, row_ok, s + 1, n_stages, h,
                           K);
    }
    if constexpr (!C::DIRECT) {
      mbar_wait(raw_full + rslot * 8, (s / C::RS) & 1);
      transform_x<TX, A4>(sm, rslot, oslot, t);
    }
    fence_async_smem();
    producer_sync();
    if (t == 0) {
      mbar_arrive(full + oslot * 8);
      if (!C::DIRECT && s + C::RS < n_stages)
        load_raw<TX, A4>(sm, maps, s + C::RS, m0);
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc += d * c over 32 accumulators (x rows 64h..64h+63 of the tile): c
// is one scale a W row (c0 for row r0, c1 for r0 + 8), times s of the x
// row with a4 (sx: the half's 64 of them).
template <bool A4>
__device__ __forceinline__ void promote(float* acc, const float* d,
                                        float c0, float c1,
                                        const float* sx, int l) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float2 s2 = make_float2(1.0f, 1.0f);
    if constexpr (A4)
      s2 = *reinterpret_cast<const float2*>(sx + 8 * q + 2 * (l % 4));
#pragma unroll
    for (int i = 4 * q; i < 4 * q + 4; ++i) {
      const float cw = (i / 2) % 2 ? c1 : c0;
      const float f = A4 ? (i % 2 ? s2.y : s2.x) * cw : cw;
      acc[i] = fmaf(d[i], f, acc[i]);
    }
  }
}

// Stage s's x operand tiles: the TMA tile in its raw slot when DIRECT.
template <typename TX, bool A4>
__device__ __forceinline__ uint32_t x_tiles(unsigned char* sm, int s) {
  using C = Cfg<TX, A4>;
  if constexpr (C::DIRECT) return smem_u32(sm + C::RAW + (s % C::RS) * C::XRAW);
  return smem_u32(sm + (s % C::OS) * C::OPB + C::OP_X);
}

// A consumer warpgroup: W rows 64c..64c+63 of the tile against its 128 x
// rows.  Accumulator element i of thread (warp w of the warpgroup, lane
// l) sits at W row 64c + 16w + l/4 + 8((i/2)%2) and x row 8(i/4) +
// 2(l%4) + i%2 of the tile.  A group's wgmma is waited for at once and
// promoted; the other consumer warpgroup's wgmma runs meanwhile.
template <typename TX, bool A4, typename TY>
__device__ void consume(unsigned char* sm, int n_stages, TY* __restrict__ y,
                        int64_t M, int64_t N, int m0, int n0) {
  using C = Cfg<TX, A4>;
  const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
  const int w = t / 32, l = t % 32;
  const int r0 = c * 64 + w * 16 + l / 4;
  float acc[64], tmp[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int s = 0; s < n_stages; ++s) {
    mbar_wait(smem_u32(sm + C::FULL) + (s % C::OS) * 8, (s / C::OS) & 1);
    if constexpr (C::DIRECT)
      mbar_wait(smem_u32(sm + C::RAW_FULL) + (s % C::RS) * 8,
                (s / C::RS) & 1);
    const unsigned char* op = sm + (s % C::OS) * C::OPB;
    const uint32_t a = smem_u32(op + c * 64 * 128);
    const uint32_t b = x_tiles<TX, A4>(sm, s);
    const float* cs = reinterpret_cast<const float*>(op + C::OP_C);
    const float* sx = reinterpret_cast<const float*>(op + C::OP_S);
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < C::P; ++p)  // the f32 split's terms, summed
        wgmma_n128<0>(tmp, desc_sw128(a + g * 32),
                   desc_sw128(b + p * TILE + g * 32), p);
      wgmma_commit();
      const float c0 = cs[g * BN + r0], c1 = cs[g * BN + r0 + 8];
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(tmp[i]);
      promote<A4>(acc, tmp, c0, c1, sx + g * BM, l);
      promote<A4>(acc + 32, tmp + 32, c0, c1, sx + g * BM + 64, l);
    }
    mbar_arrive(smem_u32(sm + C::EMPTY) + (s % C::OS) * 8);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int64_t n = n0 + r0 + 8 * ((i / 2) % 2);
    const int64_t m = m0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
    if (m < M && n < N) store_out(y + m * N + n, acc[i]);
  }
}

template <typename TX, typename TY, bool A4>
__global__ void __launch_bounds__(NTHREADS, 1)
    fp4_matmul_kernel(const __grid_constant__ Maps maps,
                      const uint8_t* __restrict__ packed,
                      const float* __restrict__ scales,
                      const float* __restrict__ gscale, TY* __restrict__ y,
                      int64_t M, int64_t N, int64_t K) {
  using C = Cfg<TX, A4>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_stages = static_cast<int>((K + BK - 1) / BK);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::RS; ++i)
      mbar_init(smem_u32(sm + C::RAW_FULL) + i * 8);
    for (int i = 0; i < C::OS; ++i) {
      mbar_init(smem_u32(sm + C::FULL) + i * 8);
      mbar_init(smem_u32(sm + C::EMPTY) + i * 8, CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();
  // the warpgroup's role, uniform to the compiler (read from lane 0)
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 0)
    produce<TX, A4>(sm, maps, packed, scales, *gscale, n_stages, m0, n0, N,
                    K);
  else
    consume<TX, A4, TY>(sm, n_stages, y, M, N, m0, n0);
}

// x [M, K] (bf16: boxes of 64 along K; f32: of 32) by 128 rows.
template <typename TX>
bool maps_for(Maps* maps, const void* x, int64_t M, int64_t K) {
  constexpr bool F32 = std::is_same<TX, float>::value;
  if (encoder() == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K * sizeof(TX))};
  const cuuint32_t box[2] = {F32 ? 32u : 64u, BM}, step[2] = {1, 1};
  return encoder()(&maps->x, F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   2, const_cast<void*>(x), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TX, typename TY, bool A4>
int launch_a4(const void* x, const void* packed, const void* scales,
              const void* gscale, void* y, int64_t M, int64_t N, int64_t K,
              cudaStream_t stream) {
  using C = Cfg<TX, A4>;
  // the tensor map below is encoded on this thread, which may not have the
  // device's context bound yet
  cudaError_t err = bind_device();
  if (err == cudaSuccess)
    err = allow_smem<&fp4_matmul_kernel<TX, TY, A4>, C::SMEM>();
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps;
  if (!maps_for<TX>(&maps, x, M, K))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + BM - 1) / BM));
  fp4_matmul_kernel<TX, TY, A4><<<grid, NTHREADS, C::SMEM, stream>>>(
      maps, static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(gscale),
      static_cast<TY*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TY>
int launch(const void* x, const void* packed, const void* scales,
           const void* gscale, void* y, int64_t M, int64_t N, int64_t K,
           int a4, void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0)  // an empty sum
    return static_cast<int>(cudaMemsetAsync(y, 0, M * N * sizeof(TY), s));
  if ((M + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return a4 ? launch_a4<TX, TY, true>(x, packed, scales, gscale, y, M, N, K, s)
            : launch_a4<TX, TY, false>(x, packed, scales, gscale, y, M, N, K,
                                       s);
}

}  // namespace mm
}  // namespace

extern "C" {

// x: [M, K] contiguous (bf16 or f32, by the entry's first type); packed:
// u8 [N, K/2], the low nibble holding the even k; scales: f32 [N, K/16];
// gscale: f32[1] on the device; y: [M, N] contiguous (f32 or bf16, by the
// second type).  K must be a multiple of 32 and every pointer 16-byte
// aligned; a4 != 0 fake-quantizes x.  Returns a CUDA error code (0: none).
int fp4_matmul_bf16_f32(const void* x, const void* packed, const void* scales,
                        const void* gscale, void* y, int64_t M, int64_t N,
                        int64_t K, int a4, void* stream) {
  return mm::launch<__nv_bfloat16, float>(x, packed, scales, gscale, y, M, N,
                                          K, a4, stream);
}

int fp4_matmul_f32_f32(const void* x, const void* packed, const void* scales,
                       const void* gscale, void* y, int64_t M, int64_t N,
                       int64_t K, int a4, void* stream) {
  return mm::launch<float, float>(x, packed, scales, gscale, y, M, N, K, a4,
                                  stream);
}

int fp4_matmul_bf16_bf16(const void* x, const void* packed,
                         const void* scales, const void* gscale, void* y,
                         int64_t M, int64_t N, int64_t K, int a4,
                         void* stream) {
  return mm::launch<__nv_bfloat16, __nv_bfloat16>(x, packed, scales, gscale,
                                                  y, M, N, K, a4, stream);
}

int fp4_matmul_f32_bf16(const void* x, const void* packed, const void* scales,
                        const void* gscale, void* y, int64_t M, int64_t N,
                        int64_t K, int a4, void* stream) {
  return mm::launch<float, __nv_bfloat16>(x, packed, scales, gscale, y, M, N,
                                          K, a4, stream);
}

}  // extern "C"
