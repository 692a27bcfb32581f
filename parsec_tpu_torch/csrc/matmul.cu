// Blocked GEMM for Hopper (sm_90a), batched over gridDim.z, fp32.
//
//   Out[z] = beta * C[z] + alpha * (A[z] . op(B[z])),   op(B) = B or B^T
//
// This source builds the fp32 library (parsec_tpu_torch/ops/kernels.py):
// ptt_matmul_f32.  The bf16 GEMM is the tensor-core kernel of
// matmul_bf16.cu.
//
// Replaces the JAX package's Pallas kernel `_matmul_kernel`
// (parsec_tpu/ops/pallas_kernels.py, reached through `_matmul_impl`'s
// pl.pallas_call).  The port's tile Cholesky runs its two update classes
// through it:
//   gemm_nt  C - A.B^T   trans_b = 1, alpha = -1, beta = 1
//   syrk_ln  T - A.A^T   B = A, trans_b = 1, alpha = -1, beta = 1
//   matmul   A.B         trans_b = 0, alpha = 1, beta = 0, no C
//
// What bounds it.  Everything is fp32 on the CUDA cores, no TF32: a tile
// update of nb = 1024 is 2 nb^3 = 2.1 GFLOP over 16 MiB of traffic (A, B,
// C read once, Out written once), about 128 FLOP per byte, so the bound is
// the 67 TFLOP/s fp32 (non-tensor-core) peak of an H100 SXM, 32 us per
// tile, not the 3.35 TB/s of its memory (5 us).
//
// What the design does about it.  The TPU kernel carries an f32
// accumulator in VMEM across a sequential K grid axis; blocks on Hopper run
// in parallel and in no order, so here each block owns one 128x64 output
// tile and loops over K itself (one nb = 1024 tile is 128 blocks, so a
// single task fills all but 4 of the 132 SMs).  Its 256 threads each hold
// an 8x4 register micro-tile (rows ty + 16 i, columns tx + 16 j).  A
// and, in the trans_b form, B are both contiguous in K, so the 32-deep K
// slabs are staged k-contiguous in shared memory with a row stride of 36
// floats (9 float4, odd: the 8 rows a quarter warp reads in one 16-byte
// load fall in 8 distinct bank groups) and read as float4 along k: 12
// loads feed 128 FMAs (the first design's 8 loads fed 16).  Slabs arrive
// by 16-byte cp.async into a 3-stage ring, so slab k+2 is in flight while
// slab k is multiplied, with one barrier per slab.  The non-trans_b form
// (matmul, the gradient; off the Cholesky path) stages B k-major and
// reads it with scalar loads.  16-byte copies need 16-byte aligned rows:
// when a base pointer, row stride or batch stride is not, the same kernel
// copies with 4-byte cp.async instead (the ALIGNED = false instance); the
// arithmetic is the same.  Edges are zero-filled in the copies and masked
// in the store, so any M, N, K work.  Every output element sums its K
// products in ascending order with fmaf from 0, then alpha * acc, then
// fmaf(beta, C, .), the same in every z-slice and in both copy variants,
// so one launch over a stack of n tasks is bit-exact against n launches
// of one.  No split-K, no atomics.
//
// Measured (chip_smoke.py --ptxas, sm_90a, -O3): 122 to 128 registers a
// thread (capped at 128 so that two blocks share an SM when the batch
// has more than one tile per SM), no spills, 82,944 bytes of shared
// memory a block.  At nb = 1024 it reaches about 45 % of the fp32 bound,
// a few per cent slower than cuBLAS's fp32 kernel of the same block tile;
// PERF.md says what still holds it back.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;            // output rows per block
constexpr int BN = 64;             // output columns per block
constexpr int BK = 32;             // K slab per pipeline stage
constexpr int TX = 16;             // threads along N
constexpr int TY = 16;             // threads along M
constexpr int TM = BM / TY;        // 8 rows per thread
constexpr int TN = BN / TX;        // 4 columns per thread
constexpr int THREADS = TX * TY;   // 256
constexpr int STAGES = 3;
constexpr int LDK = BK + 4;        // k-contiguous row stride: 9 float4, odd
constexpr int LDN = BN + 4;        // n-contiguous row stride of B (!TRANS_B)
constexpr int A_STAGE = BM * LDK;  // floats per stage
constexpr int B_STAGE = BN * LDK;
static_assert(BK * LDN <= B_STAGE, "k-major B slab must fit its stage");
constexpr size_t SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * sizeof(float);

struct GemmArgs {
  const float* A;
  const float* B;
  const float* C;
  float* Out;
  int M, N, K;
  long long sA, sB, sC, sO;
  int lda, ldb, ldc, ldo;
  float alpha, beta;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; bytes past src_bytes (0..16) are zero-filled
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0.. of a row-major [R, C] source (row stride ld) into a ROWS x COLS
// fp32 shared tile (row stride lds), columns c0.., by cp.async; what lies
// outside [R, C] is zero.  ALIGNED = 16-byte copies (rows and base on 16
// bytes).
template <bool ALIGNED, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int lds,
                                          const float* src, int ld, int r0,
                                          int c0, int R, int C, int tid) {
  constexpr int CH = COLS / 4;   // chunks of 4 elements per row
  static_assert((ROWS * CH) % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int r = idx / CH, c = (idx % CH) * 4;
    const int gr = r0 + r, gc = c0 + c;
    float* d = dst + r * lds + c;
    const float* s = src + static_cast<long long>(gr) * ld + gc;
    if (ALIGNED) {
      const int n = (gr < R && gc < C) ? 4 * min(4, C - gc) : 0;
      cp_async16(d, n ? s : src, n);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = gr < R && gc + e < C;
        cp_async4(d + e, in ? s + e : src, in ? 4 : 0);
      }
    }
  }
}

template <bool TRANS_B, bool HAS_C, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const GemmArgs p) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [STAGES][BM][LDK]
  float* Bs = As + STAGES * A_STAGE;   // [STAGES][BN][LDK] or [BK][LDN]

  const long long z = blockIdx.z;
  const float* A = p.A + z * p.sA;
  const float* B = p.B + z * p.sB;
  const int M = p.M, N = p.N, K = p.K;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  auto load_slab = [&](int stage, int kt) {
    const int k0 = kt * BK;
    load_tile<ALIGNED, BM, BK>(As + stage * A_STAGE, LDK, A, p.lda, m0, k0,
                               M, K, tid);
    if (TRANS_B)   // B is [N, K]
      load_tile<ALIGNED, BN, BK>(Bs + stage * B_STAGE, LDK, B, p.ldb, n0, k0,
                                 N, K, tid);
    else           // B is [K, N]
      load_tile<ALIGNED, BK, BN>(Bs + stage * B_STAGE, LDN, B, p.ldb, k0, n0,
                                 K, N, tid);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_slab(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    // slab kt has landed, and every thread is done with slab kt - 1,
    // whose stage the next copy overwrites
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT)
      load_slab((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const float* as = As + (kt % STAGES) * A_STAGE;
    const float* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + i * TY) * LDK +
                                                4 * k4);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (TRANS_B) {
          b[j] = *reinterpret_cast<const float4*>(bs + (tx + j * TX) * LDK +
                                                  4 * k4);
        } else {
          const float* q = bs + 4 * k4 * LDN + tx + j * TX;
          b[j] = make_float4(q[0], q[LDN], q[2 * LDN], q[3 * LDN]);
        }
      }
      // k ascending for every element: .x, .y, .z, .w
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
  }

  // epilogue: 16 neighbouring threads store 16 neighbouring columns
  const float* C = HAS_C ? p.C + z * p.sC : nullptr;
  float* Out = p.Out + z * p.sO;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      float v = p.alpha * acc[i][j];
      if (HAS_C) v = fmaf(p.beta, C[static_cast<long long>(gm) * p.ldc + gn], v);
      Out[static_cast<long long>(gm) * p.ldo + gn] = v;
    }
  }
}

template <bool TRANS_B, bool HAS_C, bool ALIGNED>
int launch(const GemmArgs& p, int batch, cudaStream_t stream) {
  const auto kernel = gemm_kernel<TRANS_B, HAS_C, ALIGNED>;
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANS_B, bool HAS_C>
int launch_aligned_or_not(const GemmArgs& p, int batch, bool aligned,
                          cudaStream_t stream) {
  return aligned ? launch<TRANS_B, HAS_C, true>(p, batch, stream)
                 : launch<TRANS_B, HAS_C, false>(p, batch, stream);
}

bool aligned_to(const void* ptr, int bytes) {
  return reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// Out[z] = beta*C[z] + alpha*(A[z] . op(B[z])) for z < batch, row-major,
// fp32.  A is [M, K]; B is [N, K] when trans_b, else [K, N]; C (read only
// when non-null) and Out are [M, N].  s* are batch strides and ld* row
// strides, in elements.  Any alignment is taken: rows of A and B on 16
// bytes take 16-byte copies, others 4-byte ones.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int ptt_matmul_f32(const float* A, const float* B, const float* C, float* Out,
                   int batch, int M, int N, int K,
                   long long sA, long long sB, long long sC, long long sO,
                   int lda, int ldb, int ldc, int ldo,
                   int trans_b, float alpha, float beta, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmArgs p{A, B, C, Out, M, N, K, sA, sB, sC, sO,
                   lda, ldb, ldc, ldo, alpha, beta};
  const bool aligned = aligned_to(A, 16) && aligned_to(B, 16) &&
                       lda % 4 == 0 && ldb % 4 == 0 && sA % 4 == 0 &&
                       sB % 4 == 0;
  const bool has_c = C != nullptr;
  if (trans_b)
    return has_c ? launch_aligned_or_not<true, true>(p, batch, aligned, s)
                 : launch_aligned_or_not<true, false>(p, batch, aligned, s);
  return has_c ? launch_aligned_or_not<false, true>(p, batch, aligned, s)
               : launch_aligned_or_not<false, false>(p, batch, aligned, s);
}

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
