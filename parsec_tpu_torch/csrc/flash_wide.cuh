// Building blocks of the wide-head flash kernels (flash_attention_wide.cu,
// flash_attention_bwd_wide.cu): head widths up to 256, fp32 or bf16
// operands, every tile held in shared memory as fp32.
//
// A tile row holds D values rounded up to a float4 and is padded to an odd
// number of float4 (row_stride), so the 8 rows that a quarter warp reads
// with one 16-byte load each fall in 8 distinct bank groups.  Rows past the
// operand's end and the columns from D up to the next multiple of 4 are
// zero, so no tile size has to divide T, Tk or D.
//
// fp32 tiles arrive by cp.async (16-byte copies when D % 4 == 0 and the
// operand is 16-byte aligned, else 4-byte ones) and land at the next
// cp.async wait; bf16 tiles by plain loads (16 bytes, 8 values, when
// D % 8 == 0 and the operand is 16-byte aligned, else one value at a
// time), widened to fp32 and stored at once.  Either way a barrier makes
// them visible to the block.  Which copy a tile takes changes no
// arithmetic, so a misaligned operand gives the bits of an aligned copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt_wide {

constexpr int THREADS = 256;
constexpr int D_MAX = 256;           // the widest head the kernels take
constexpr float NEG_INF = -1e30f;    // the Pallas kernels' mask value

// a row stride holding D rounded up to a float4, and an odd number of
// float4
__host__ __device__ constexpr int row_stride(int d) {
  return ((d + 3) / 4) % 2 ? (d + 3) / 4 * 4 : (d + 3) / 4 * 4 + 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte copy; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy group but the newest N has landed (for this thread)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x in the element type: rounded to the nearest bf16 (ties to even) at
// bf16, as PyTorch's and JAX's casts round
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to the element type and widened back: p before P . V
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// whether an operand of this type takes the 16-byte path: whole 16-byte
// pieces in every row and a 16-byte aligned base
template <typename T>
bool aligned_operand(const void* p, int D) {
  return D % (16 / static_cast<int>(sizeof(T))) == 0 &&
         reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// rows r0 .. r0+ROWS-1 of a row-major [R, D] operand into the fp32 tile
// dst [ROWS][ds], columns 0 .. 4*ceil(D/4)-1, zero past R and D
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int R, int D, int ds,
                                          bool aligned) {
  if (aligned) {
    const int ch = D / 4;
    for (int idx = threadIdx.x; idx < ROWS * ch; idx += THREADS) {
      const int r = idx / ch, c = (idx - r * ch) * 4;
      const bool in = r0 + r < R;
      cp_async16(dst + r * ds + c,
                 in ? src + static_cast<long long>(r0 + r) * D + c : src,
                 in ? 16 : 0);
    }
  } else {
    const int w = (D + 3) / 4 * 4;
    for (int idx = threadIdx.x; idx < ROWS * w; idx += THREADS) {
      const int r = idx / w, c = idx - r * w;
      const bool in = r0 + r < R && c < D;
      cp_async4(dst + r * ds + c,
                in ? src + static_cast<long long>(r0 + r) * D + c : src,
                in ? 4 : 0);
    }
  }
}

template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int R, int D, int ds,
                                          bool aligned) {
  if (aligned) {
    const int ch = D / 8;
    for (int idx = threadIdx.x; idx < ROWS * ch; idx += THREADS) {
      const int r = idx / ch, c = (idx - r * ch) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (r0 + r < R) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(r0 + r) * D + c);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 a = __bfloat1622float2(h[0]),
                     b = __bfloat1622float2(h[1]),
                     e = __bfloat1622float2(h[2]),
                     f = __bfloat1622float2(h[3]);
        lo = make_float4(a.x, a.y, b.x, b.y);
        hi = make_float4(e.x, e.y, f.x, f.y);
      }
      *reinterpret_cast<float4*>(dst + r * ds + c) = lo;
      *reinterpret_cast<float4*>(dst + r * ds + c + 4) = hi;
    }
  } else {
    const int w = (D + 3) / 4 * 4;
    for (int idx = threadIdx.x; idx < ROWS * w; idx += THREADS) {
      const int r = idx / w, c = idx - r * w;
      const bool in = r0 + r < R && c < D;
      dst[r * ds + c] =
          in ? __bfloat162float(src[static_cast<long long>(r0 + r) * D + c])
             : 0.f;
    }
  }
}

// n values of a [.., T] fp32 row vector from i0 into dst[0 .. n), zero
// past T (by cp.async)
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int i0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const bool in = i0 + i < T;
    cp_async4(dst + i, in ? src + i0 + i : src, in ? 4 : 0);
  }
}

// the row's four values c .. c+3 stored in the element type, those past D
// left alone (VEC: the row is 16-byte aligned at c and c + 3 < D)
template <typename T>
__device__ __forceinline__ void store4(T* row, int c, int D, float4 x,
                                       bool vec) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(row + c) = x;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < D) narrow(row + c + e, part(x, e));
}

}  // namespace ptt_wide
