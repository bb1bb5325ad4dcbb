// What the Hopper designs share: the grouped expert FFN's two (the W4A4
// design in grouped_fp4_ffn_sm90.cuh, the BF16-weight design in
// grouped_ffn_sm90.cuh; both included by grouped_fp4_ffn.cu) their work
// items and device-built schedule; they and fp4_matmul.cu the mbarriers,
// TMA loads, the host encoder of tensor maps, the FP4 code decode, and
// wgmma on 128-byte-swizzled tiles.  The bf16 backward of the FFN
// (grouped_ffn_bwd_sm90.cuh, in grouped_ffn_bwd.cu) takes the schedule,
// the tensor maps and wgmma with either operand MN-major from here too.
//
// Both designs swap A and B (Y^T = W . X^T): weight rows take wgmma's
// 64-row M side, a slot's tokens its N side, rounded up to 8, 16, 32 or 64.
// A work item is two parts of 64 weight rows, one a warpgroup: 64 rows of
// gate (warpgroup 0) and the same rows of up (warpgroup 1), or 128 rows of
// down.  Blocks are persistent, two an SM, and walk the items (slot, weight
// tile, token tile) by a stride of the grid, so that the token tiles of
// one weight tile are neighbouring items, run at the same time and share
// the weights through L2.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link: the
                    // encoder comes through cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage throughout: two builds of these files loaded in one
// process (tools/kernel_ab.py) must not share the function-local statics
// below, nor kernel stubs.
namespace {
namespace sm90 {

constexpr int THREADS = 256;        // two warpgroups
constexpr int BK = 64;              // K per stage: one 128-byte bf16 row
constexpr int NTOK = 64;            // token columns per work item, at most
constexpr int PART_ROWS = 64;       // weight rows a warpgroup multiplies
constexpr int MAX_SLOTS = 512;      // counts per launch (the scan's table)
constexpr int TOK_BYTES = NTOK * BK * 2;  // token tile [64][64] bf16
constexpr int SMEM_BYTES = 115712;  // dynamic shared memory: two blocks/SM
constexpr int SCAN_BYTES = 2 * (MAX_SLOTS + 1) * 4;  // the scan's tables

// Rows of a work item: gate/up (NMAT = 2 matrices) 64, down (NMAT = 1) 128.
template <int NMAT>
__host__ __device__ constexpr int item_rows() {
  return NMAT == 2 ? PART_ROWS : 2 * PART_ROWS;
}

// Matrix and first row (within the item) of part p (warpgroup p's rows).
template <int NMAT>
__device__ __forceinline__ int part_mat(int p) { return NMAT == 2 ? p : 0; }
template <int NMAT>
__device__ __forceinline__ int part_row0(int p) {
  return NMAT == 2 ? 0 : p * PART_ROWS;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory of a block, from its first 1024-byte boundary
// (TMA and wgmma tiles in the 128-byte swizzle start on one).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// Shared-memory accesses of this thread (st.shared, cp.async) are ordered
// with the async proxy that wgmma and TMA use.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// A barrier whose phase completes on `count` arrivals.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// The barriers' initialisation becomes visible to the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive on a barrier and expect `bytes` of TMA transfers for its phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Arrive on a barrier (no transfer).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// TMA tile loads into shared memory, completing on a barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Byte offset of 16-byte chunk c of row r of a [rows][128 B] tile in the
// 128-byte swizzle (chunk index XOR row mod 8).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// Four codes (bits 0..15 of x, code k in bits 4k..4k+3) to four bf16
// values, two a word, with integer byte permutes only (a conversion per
// weight issues at a quarter of the rate).
__device__ __forceinline__ void decode4(uint32_t x, const uint32_t* lo,
                                        const uint32_t* hi, uint32_t& out0,
                                        uint32_t& out1) {
  const uint32_t sel = x & 0x7777u;
  const uint32_t l = __byte_perm(lo[0], lo[1], sel);
  const uint32_t h = __byte_perm(hi[0], hi[1], sel);
  // sign of code k to bit 7 of byte k: with the code itself as selector,
  // prmt replicates the sign bit of a 0x80 byte (0xff) when the code's bit
  // 3 is set and copies the byte (0x80) when not; bit 6 then says which
  uint32_t m;
  asm("prmt.b32 %0, %1, %1, %2;" : "=r"(m) : "r"(0x80808080u), "r"(x));
  const uint32_t hs = h | ((m << 1) & 0x80808080u);
  out0 = __byte_perm(l, hs, 0x5140);
  out1 = __byte_perm(l, hs, 0x7362);
}

// Orders later uses of an accumulator after the wgmma wait.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// wgmma descriptor of a bf16 operand in the 128-byte-swizzled layout:
// 8-row atoms of 128-byte rows, 1024 bytes apart (SBO).  K-major (a row
// holds 64 K of one M or N index): the start address moves 32 bytes per
// k16 step inside the atom.  MN-major (a row holds 64 M indices of one K;
// wgmma's transpose flag set): it moves 16 rows, 2048 bytes, per k16 step,
// and an operand 64 wide along M is one atom wide, so the leading offset
// between atoms along M is never used.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// wgmma m64nNk16, bf16 in, f32 accumulate, A and B from shared memory;
// TA = 1: A MN-major, TB = 1: B MN-major (K-major when 0; generated: one
// per width N); scale_d 0 overwrites d with the product.
template <int TA, int TB = 0>
__device__ __forceinline__ void wgmma_n8(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB = 0>
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB = 0>
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB = 0>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB = 0>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b) {
  if constexpr (N == 8) wgmma_n8<TA, TB>(d, a, b, 1);
  else if constexpr (N == 16) wgmma_n16<TA, TB>(d, a, b, 1);
  else if constexpr (N == 32) wgmma_n32<TA, TB>(d, a, b, 1);
  else wgmma_n64<TA, TB>(d, a, b, 1);
}

// Rounds v to bf16 and back (the reference's casts between stages).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One work item: weight rows n0.. (item_rows of them) of slot `slot`
// against tokens row0..row0+ntok-1 (ntok <= NTOK) of that slot.
struct Item {
  int slot;
  int64_t n0, row0;
  int ntok;
};

// The tensor maps of a launch, kernel parameters (TMA reads them there):
// each part's weight matrix (its FP4 codes, or its bf16 rows) and the
// token rows [M, K] bf16 in the 128-byte swizzle, boxes of 64 along K by
// 8, 16, 32 or 64 rows.
struct Maps {
  CUtensorMap w[2];
  CUtensorMap tok[4];
};

template <int N>
__device__ __forceinline__ const CUtensorMap* tok_map(const Maps& maps) {
  return &maps.tok[N == 8 ? 0 : N == 16 ? 1 : N == 32 ? 2 : 3];
}

// The schedule, built on the device by every block: warp 0 scans the
// counts of the slots with weights into item and row offsets (a slot of c
// rows has ceil(c / NTOK) token tiles times nwt weight tiles).
__device__ void scan_slots(const int* __restrict__ gs, int n_slots, int nwt,
                           int* tstart, int* rstart) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int tcarry = 0, rcarry = 0;
    for (int base = 0; base < n_slots; base += 32) {
      const int g = base + lane;
      const int c = g < n_slots ? max(gs[g], 0) : 0;
      int t = (c + NTOK - 1) / NTOK * nwt, r = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int tt = __shfl_up_sync(0xffffffffu, t, o);
        const int rr = __shfl_up_sync(0xffffffffu, r, o);
        if (lane >= o) {
          t += tt;
          r += rr;
        }
      }
      if (g < n_slots) {
        tstart[g + 1] = tcarry + t;
        rstart[g + 1] = rcarry + r;
      }
      tcarry += __shfl_sync(0xffffffffu, t, 31);
      rcarry += __shfl_sync(0xffffffffu, r, 31);
    }
    if (lane == 0) tstart[0] = rstart[0] = 0;
  }
  __syncthreads();
}

template <int N>
struct Width {
  static constexpr int value = N;
};

// The block's work items b, b + grid, ... of the scanned schedule, in
// order: run(item, j, Width<N>()) for the block's j-th item, N the item's
// token-tile width.
template <int NMAT, typename Run>
__device__ __forceinline__ void for_each_item(const int* tstart,
                                              const int* rstart, int n_slots,
                                              Run&& run) {
  const int total = tstart[n_slots];
  int j = 0;
  for (int item = blockIdx.x; item < total; item += gridDim.x, ++j) {
    int lo = 0, hi = n_slots;  // the last slot with tstart <= item
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (tstart[mid] <= item) lo = mid;
      else hi = mid;
    }
    const int c = rstart[lo + 1] - rstart[lo];
    const int ntt = (c + NTOK - 1) / NTOK;
    const int local = item - tstart[lo];
    Item it;
    it.slot = lo;
    it.n0 = static_cast<int64_t>(local / ntt) * item_rows<NMAT>();
    it.row0 = rstart[lo] + static_cast<int64_t>(local % ntt) * NTOK;
    it.ntok = min(NTOK, c - (local % ntt) * NTOK);
    if (it.ntok <= 8) run(it, j, Width<8>());
    else if (it.ntok <= 16) run(it, j, Width<16>());
    else if (it.ntok <= 32) run(it, j, Width<32>());
    else run(it, j, Width<64>());
  }
}

// Accumulator element i of thread (warp w of its warpgroup, lane l) sits
// at row w*16 + l/4 + 8*((i/2)%2) of the warpgroup's part and token column
// 8*(i/4) + 2*(l%4) + i%2.
//
// Down epilogue, both warpgroups: out [M, D] = T(acc).
template <int N>
__device__ void epilogue_down(const float (&acc)[N / 2], const Item& it,
                              __nv_bfloat16* __restrict__ out, int64_t M,
                              int64_t D) {
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int l = threadIdx.x % 32;
  const int64_t d_lo = it.n0 + wg * PART_ROWS + w * 16 + l / 4;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int t = 8 * (i / 4) + 2 * (l % 4) + i % 2;
    const int64_t d = d_lo + 8 * ((i / 2) % 2);
    const int64_t row = it.row0 + t;
    if (t < it.ntok && row < M && d < D)
      out[row * D + d] = __float2bfloat16_rn(acc[i]);
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

// Lets KERNEL take BYTES of dynamic shared memory and all of L1's
// carveout, once per device.
template <auto KERNEL, int BYTES = SMEM_BYTES>
cudaError_t allow_smem() {
  static bool done[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

// Makes the current device's primary context current on the calling host
// thread.  The tensor-map encoder is a driver call that needs one, and a
// thread whose first CUDA work is a launch of this library (autograd's
// worker thread running a backward first) may have none yet.
inline cudaError_t bind_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// cuTensorMapEncodeTiled, looked up once with cudaGetDriverEntryPoint,
// so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Token rows [M, K] bf16, boxes of 64 along K by `rows`, 128-byte swizzle.
bool token_map(CUtensorMap* map, const void* act, int64_t M, int64_t K,
               int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K * 2)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(rows)};
  const cuuint32_t step[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(act), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four token maps of a launch (one a token-tile width).
bool token_maps(Maps* maps, const void* act, int64_t M, int64_t K) {
  const int rows[4] = {8, 16, 32, 64};
  bool ok = true;
  for (int i = 0; i < 4; ++i)
    ok = ok && token_map(&maps->tok[i], act, M, K, rows[i]);
  return ok;
}

// bf16 weights [Gw, K, NR] (NR contiguous), boxes of 64 rows along NR by 64
// along K of one slot, 128-byte swizzle.
bool plain_weight_map(CUtensorMap* map, const void* w, int64_t Gw,
                      int64_t NR, int64_t K) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(NR),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(Gw)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(NR * 2),
                                 static_cast<cuuint64_t>(K * NR * 2)};
  const cuuint32_t box[3] = {PART_ROWS, BK, 1}, step[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(w), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace
