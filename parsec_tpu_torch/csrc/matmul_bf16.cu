// Blocked GEMM at bf16 on Hopper's tensor cores (sm_90a), batched over z.
//
//   Out[z] = A[z] . op(B[z]),   op(B) = B or B^T
//
// bf16 A and B, the products summed in fp32 by wgmma, Out rounded once to
// bf16 (nearest even): the JAX package's Pallas kernel `_matmul_kernel`
// (parsec_tpu/ops/pallas_kernels.py, reached through `_matmul_impl`'s
// pl.pallas_call) at bf16, A . B in A's dtype.  No C and alpha 1.  Built
// alone into the bf16 GEMM library (parsec_tpu_torch/ops/kernels.py):
// ptt_matmul_bf16.  The fp32 GEMM stays in matmul.cu.  Both forms are on
// its path: nn for `matmul` and the gradient A^T g, nt (trans_b) for the
// gradient g B^T.
//
// What bounds it.  A 1024^3 product is 2.1 GFLOP over 6.3 MB (A, B read
// once, Out written once): 2.2 us at the 989 TFLOP/s bf16 tensor-core rate
// of an H100 SXM against 1.9 us at its 3.35 TB/s, so the tensor cores
// bound it, by a little.  At that size the launch and the pipeline's fill
// and drain weigh as much as the products.
//
// What the design does about it.
//   - wgmma on 128 x 64 output tiles: two consumer warpgroups of 64 rows
//     each, the accumulator in fp32 registers.  The A tile and, in the nt
//     form, the B tile are K-major as they lie in memory; in the nn form
//     B [K, N] is MN-major, read through wgmma's transpose bit.
//   - A producer warp streams 64-deep K slabs of A and B through a ring of
//     STAGES stages with mbarriers: one thread issues TMA loads over 3-D
//     tensor maps (columns, rows, z), 128-byte swizzled, zero-filled past
//     the ragged edges of M, N and K, so no tile size has to divide them.
//     The consumers keep one slab's wgmmas in flight while the next is
//     issued, and release a stage when its products are done.  setmaxnreg
//     moves the producer warpgroup's registers to the consumers.
//   - A persistent grid of one block an SM walks the (z, tile) pairs; the
//     ring runs across tiles, so one tile's epilogue overlaps the next
//     one's loads.  The tile is 128 x 64 because at 1024^3, the size on
//     the path, 128 x 128 tiles would be 64 for 132 SMs and 128 x 64 tiles
//     are 128 of them.  One tile for every shape, so a batched launch gives
//     each slice the bits of its own launch.
//   - The epilogue rounds each fp32 sum once and stores bf16 pairs (single
//     values at an odd N or row stride), masked at the ragged edges.
//   - Operands TMA cannot take (a base not 16-byte aligned, a row or batch
//     stride not a multiple of 16 bytes: the ragged 999 x 1001 x 997
//     products, misaligned views) are copied by the producer warp with
//     2-byte loads into the same swizzled layout; the consumers' code is
//     the same, so misaligned and aligned operands give the same bits.
//   - No split-K and no atomics: every output tile's bits are fixed by its
//     own loop over K (16 deep a wgmma, ascending).
//
// Measured: registers, spills and shared memory are chip_smoke.py's
// [ptxas] lines and ptt_matmul_bf16_attributes; times at 1024^3 PERF.md.
#include "hopper.cuh"

#include <climits>

namespace {

constexpr int CONSUMERS = 2;                  // warpgroups of 64 rows
constexpr int BM = CONSUMERS * 64;            // output rows a tile: 128
constexpr int BN = CHUNK;                     // output columns a tile: 64
constexpr int BK = CHUNK;                     // K a slab: 64
constexpr int PRODUCER_WARP = CONSUMERS * 4;
constexpr int THREADS = (CONSUMERS + 1) * 128;   // 384
constexpr int PRODUCER_REGS = 40;             // 128 x 40 + 256 x 232 <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr int STAGES = 6;

// byte offsets from a 1024-byte aligned base: STAGES x (A [BM][64], B
// [BN][64] (nt) or [BK][64] (nn)); then the barriers (STAGES full, STAGES
// empty)
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BARS = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BARS + 16 * STAGES + 1024;

struct Args {
  const bf16* A;
  const bf16* B;
  bf16* Out;
  int batch, M, N, K;
  long long sA, sB, sO;
  int lda, ldb, ldo;
};

// tile `tile` of the (z, m tile, n tile) walk, n fastest
struct Tile {
  int z, m0, n0;
};

__device__ __forceinline__ Tile tile_of(int tile, int tiles_n, int per_z) {
  const int z = tile / per_z, rem = tile - z * per_z;
  const int tm = rem / tiles_n;
  return Tile{z, tm * BM, (rem - tm * tiles_n) * BN};
}

// TRANS_B: B is [N, K] (else [K, N]).  tma: the producer loads by TMA
// (else by the per-thread copy); o_pairs: Out takes 4-byte stores.
template <bool TRANS_B>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, const Args p,
                 int tma, int o_pairs) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + BARS, empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int per_z = ((p.M + BM - 1) / BM) * tiles_n;
  const int total = per_z * p.batch;
  const int ksteps = (p.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);   // each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // by TMA one lane issues everything; the per-thread copy takes them all
    if (warp != PRODUCER_WARP || (tma && lane != 0)) return;
    int gs = 0;   // slabs this block has loaded
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const Tile t = tile_of(tile, tiles_n, per_z);
      const bf16* A = p.A + t.z * p.sA;
      const bf16* B = p.B + t.z * p.sB;
      for (int kt = 0; kt < ksteps; ++kt, ++gs) {
        const int s = gs % STAGES;
        if (gs >= STAGES) ring_wait(empty0 + 8 * s, gs / STAGES - 1);
        const uint32_t as = base + s * STAGE_BYTES, bs = as + A_BYTES;
        const uint32_t bar = full0 + 8 * s;
        const int k0 = kt * BK;
        if (tma) {
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load_3d(as, &ta, k0, t.m0, t.z, bar);
          if constexpr (TRANS_B)
            tma_load_3d(bs, &tb, k0, t.n0, t.z, bar);
          else
            tma_load_3d(bs, &tb, t.n0, k0, t.z, bar);
        } else {
          copy_box(as, A, p.lda, t.m0, p.M, BM, k0, p.K, 1, lane, 32);
          if constexpr (TRANS_B)
            copy_box(bs, B, p.ldb, t.n0, p.N, BN, k0, p.K, 1, lane, 32);
          else
            copy_box(bs, B, p.ldb, k0, p.K, BK, t.n0, p.N, 1, lane, 32);
          publish(bar, lane);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // a consumer warpgroup: rows 64 wg .. + 63 of each tile; this thread's
    // rows are 16 ww + g and + 8, its columns of every 8 are 2 t4 and + 1
    const int wg = warp >> 2, ww = warp & 3, g = lane >> 2, t4 = lane & 3;
    float acc[32];
    int gs = 0;   // slabs this block has consumed
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const Tile t = tile_of(tile, tiles_n, per_z);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < ksteps; ++kt, ++gs) {
        const int s = gs % STAGES;
        ring_wait(full0 + 8 * s, gs / STAGES);
        const uint32_t as = base + s * STAGE_BYTES + wg * 64 * ROW_BYTES;
        const uint32_t bs = base + s * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = sw128_desc(as + kk * 32);
          if constexpr (TRANS_B)
            wgmma_ss_n64<0, 0>(acc, da, sw128_desc(bs + kk * 32), 1);
          else
            wgmma_ss_n64<0, 1>(acc, da,
                               sw128_desc(bs + kk * 16 * ROW_BYTES), 1);
        }
        wgmma_commit();
        // the last slab's products are done: release its stage
        wgmma_wait<1>();
        if (kt > 0) warp_release(empty0 + 8 * ((gs - 1) % STAGES), lane);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (ksteps > 0) warp_release(empty0 + 8 * ((gs - 1) % STAGES), lane);

      bf16* out = p.Out + t.z * p.sO;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = t.m0 + wg * 64 + 16 * ww + g + 8 * r;
        if (row >= p.M) continue;
        bf16* orow = out + static_cast<long long>(row) * p.ldo;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = t.n0 + 8 * j + 2 * t4;
          if (col >= p.N) continue;
          // one rounding, to nearest even
          const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
          if (o_pairs && col + 1 < p.N) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            orow[col] = __float2bfloat16_rn(v0);
            if (col + 1 < p.N) orow[col + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

template <bool TRANS_B>
int launch(const Args& p, int sms, cudaStream_t stream) {
  const auto kernel = gemm_bf16_kernel<TRANS_B>;
  // TMA takes 16-byte aligned bases and strides of a multiple of 16 bytes
  // (the batch stride only when there is a batch); other operands take the
  // per-thread copy
  const bool tma = p.K > 0 && aligned_to(p.A, 16) && aligned_to(p.B, 16) &&
                   p.lda % 8 == 0 && p.ldb % 8 == 0 &&
                   (p.batch == 1 || (p.sA % 8 == 0 && p.sB % 8 == 0));
  const bool o_pairs = p.ldo % 2 == 0 && p.sO % 2 == 0 &&
                       aligned_to(p.Out, 4);
  // above 48 KB a block's dynamic shared memory must be asked for.  First:
  // a runtime call makes the card's context current on this host thread,
  // which encoding a tensor map needs (autograd's backward thread had none)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta{}, tb{};
  if (tma) {
    // a single slice's batch stride is never used: any legal one
    const long long rows_b = TRANS_B ? p.N : p.K;
    const long long sA = p.batch == 1 ? (2LL * p.M * p.lda + 15) / 16 * 16
                                      : 2 * p.sA;
    const long long sB = p.batch == 1 ? (2LL * rows_b * p.ldb + 15) / 16 * 16
                                      : 2 * p.sB;
    if ((err = encode_bf16_3d(&ta, p.A, p.K, p.M, p.batch, 2LL * p.lda, sA,
                              BM)) != cudaSuccess)
      return static_cast<int>(err);
    err = TRANS_B ? encode_bf16_3d(&tb, p.B, p.K, p.N, p.batch, 2LL * p.ldb,
                                   sB, BN)
                  : encode_bf16_3d(&tb, p.B, p.N, p.K, p.batch, 2LL * p.ldb,
                                   sB, BK);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = static_cast<long long>(p.batch) *
                          ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<int>(tiles < sms ? tiles : sms), THREADS,
           SMEM_BYTES, stream>>>(ta, tb, p, tma, o_pairs);
  return static_cast<int>(cudaGetLastError());
}

struct Instance {
  const void* fn;
  const char* name;
  int smem_bytes;
};

const Instance kInstances[] = {
    {reinterpret_cast<const void*>(gemm_bf16_kernel<true>),
     "gemm_bf16_kernel<trans_b=true>", SMEM_BYTES},
    {reinterpret_cast<const void*>(gemm_bf16_kernel<false>),
     "gemm_bf16_kernel<trans_b=false>", SMEM_BYTES}};

}  // namespace

extern "C" {

// Out[z] = A[z] . op(B[z]) for z < batch, row-major bf16: A is [M, K]; B
// is [N, K] when trans_b, else [K, N]; Out is [M, N].  Each element sums
// its K products in fp32 and is rounded once to bf16 (nearest even).  s*
// are batch strides and ld* row strides, in elements.  Any alignment is
// taken.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched), or the error of building a tensor map.
int ptt_matmul_bf16(const bf16* A, const bf16* B, bf16* Out, int batch,
                    int M, int N, int K, long long sA, long long sB,
                    long long sO, int lda, int ldb, int ldo, int trans_b,
                    void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args p{A, B, Out, batch, M, N, K, sA, sB, sO, lda, ldb, ldo};
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  return trans_b ? launch<true>(p, sms, s) : launch<false>(p, sms, s);
}

// Instance i of the kernel: its name and, in out[0..4], registers a
// thread, local (spill) bytes a thread, static shared bytes, dynamic
// shared bytes, resident blocks an SM.  Returns 0, -1 past the last
// instance, or a cudaError_t.
int ptt_matmul_bf16_attributes(int i, int* out, const char** name) {
  if (i < 0 || i >= static_cast<int>(sizeof(kInstances) /
                                     sizeof(kInstances[0])))
    return -1;
  const Instance& inst = kInstances[i];
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, inst.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaFuncSetAttribute(
           inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
           inst.smem_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inst.fn,
                                                      THREADS,
                                                      inst.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = inst.smem_bytes;
  out[4] = per_sm;
  *name = inst.name;
  return 0;
}

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
