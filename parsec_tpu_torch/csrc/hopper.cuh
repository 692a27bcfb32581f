// Hopper (sm_90a) building blocks shared by the tensor-core kernels of
// matmul_bf16.cu, flash_attention_bf16.cu and flash_attention_bwd_bf16.cu:
// mbarriers, TMA loads over tensor maps, the per-thread copy into the same
// swizzled layout, wgmma descriptors and instructions, and the host's
// tensor-map encoding.  ops/kernels.py hashes this header with each source
// that includes it, so an edit to it rebuilds their libraries.
//
// The shared-memory layout every operand tile takes: rows of 64 bf16 (128
// bytes), 16-byte groups XOR-swizzled by the row's index mod 8 (the
// layout CU_TENSOR_MAP_SWIZZLE_128B writes and wgmma's 128-byte swizzle
// descriptors read), a tile wider than 64 columns as chunks of 64, each
// [rows][128 bytes], one after the other.  Tiles start on 1024 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CHUNK = 64;        // bf16 columns of a 128-byte row
constexpr int ROW_BYTES = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of the given parity has completed (the loop inside the
// asm, so the compiler sees no divergent path before a wgmma)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// the k-th use (k = 0, 1, ...) of a ring slot waits for the k-th phase of
// its barrier
__device__ __forceinline__ void ring_wait(uint32_t bar, int k) {
  mbar_wait(bar, k & 1);
}

// this warp is done with a ring slot: one arrival for the warp
__device__ __forceinline__ void warp_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// a barrier among `threads` threads of the block (whole warps), id 1..15
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// box (c0, c1, c2) of a 3-D tensor map into shared memory at `dst`,
// completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// box (c0, c1) of a 2-D tensor map
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The per-thread copy, for operands TMA cannot take: rows r0 .. r0+rows-1
// and columns c0 .. c0 + 64 chunks - 1 of a row-major [R, C] bf16 source
// (row stride ld elements) into a [chunks][rows][64] swizzled tile at
// `dst`, zeros outside [R, C], with 2-byte loads; thread t of n.  The
// tile is the one TMA would write, so the consumers read the same bits.
__device__ __forceinline__ void copy_box(uint32_t dst, const bf16* src,
                                         long long ld, int r0, int R,
                                         int rows, int c0, int C, int chunks,
                                         int t, int n) {
  const int G = chunks * 8;   // 16-byte groups a row
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  for (int u = t; u < rows * G; u += n) {
    const int row = u / G, grp = u - row * G;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + grp * 8 + 2 * e + h;
        if (r0 + row < R && col < C)
          pair |= static_cast<uint32_t>(
                      s[static_cast<long long>(r0 + row) * ld + col])
                  << (16 * h);
      }
      w[e] = pair;
    }
    const int chunk = grp >> 3, g = grp & 7;
    const uint32_t addr = dst + chunk * rows * ROW_BYTES + row * ROW_BYTES +
                          ((g ^ (row & 7)) << 4);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
                 "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                 : "memory");
  }
}

// the per-thread copy's stores made visible to wgmma (the async proxy),
// then one arrival for the warp
__device__ __forceinline__ void publish(uint32_t bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// this thread's stores into shared memory made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a wgmma descriptor of a 128-byte swizzled operand at `addr`: 8-row
// groups 1024 bytes apart (the stride byte offset).  K-major: one wgmma's
// 16 columns of K are 32 bytes of a row.  MN-major (read through the
// transpose bit): 64 columns of M or N are one row, 16 rows of K one step
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed groups are pending (they
// complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching a wgmma operand across the wait, or
// giving its register to another value before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define PTT_F8(a, i)                                                       \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),              \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d (+)= A . B, 64 x 64 x 16, A and B in shared memory; TA / TB: A / B
// MN-major, read through the transpose bit (else K-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : PTT_F8(d, 0), PTT_F8(d, 8), PTT_F8(d, 16), PTT_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d += A . B, 64 x 64 x 16: A (bf16 pairs) in registers, B MN-major in
// shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PTT_F8(d, 0), PTT_F8(d, 8), PTT_F8(d, 16), PTT_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef PTT_F8

// 2^x on the MUFU unit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 tensor of dims (d0 innermost, d1, d2), row and slab strides s1,
// s2 in bytes, as a 3-D map with boxes of 64 x box1 x 1, 128-byte
// swizzled, zeros out of bounds.  The card's context must be current on
// the calling host thread (a runtime call that needs it, such as
// cudaFuncSetAttribute, makes it so)
inline cudaError_t encode_bf16_3d(CUtensorMap* map, const void* ptr,
                                  long long d0, long long d1, long long d2,
                                  long long s1, long long s2, int box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1),
                                 static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {CHUNK, static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// n fp32 values as a 2-D map (n, 1) with boxes of `box` values, not
// swizzled, zeros past n
inline cudaError_t encode_f32_row(CUtensorMap* map, const void* ptr,
                                  long long n, int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), 1};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>((n * 4 + 15) / 16 *
                                                         16)};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(box), 1};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline bool aligned_to(const void* ptr, int bytes) {
  return reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

constexpr int MAX_DEVICES = 64;

// the current card's SMs (a persistent grid's size), asked once a card
inline cudaError_t sm_count(int* sms) {
  static int known[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) known[dev] = *sms;
  return err;
}

}  // namespace
