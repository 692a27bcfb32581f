// Flash attention backward at bf16 on Hopper's tensor cores (sm_90a).
//
//   O = softmax(scale * Q . K^T, masked) . V        (the forward)
//   dV = P^T dO,  dP = dO . V^T,  dS = scale * P o (dP - delta),
//   dQ = dS . K,  dK = dS^T . Q,  delta = rowsum(dO o O)
//
// with P = exp(scale * Q . K^T - m) / l recomputed from the forward's raw
// row statistics m (running max) and l (denominator), which the STATS
// form of csrc/flash_attention_bf16.cu exports.
//
// Replaces, at bf16, the VJP of the JAX package's Pallas flash attention,
// `_flash`'s custom_vjp backward `_flash_vjp_bwd`
// (parsec_tpu/ops/pallas_kernels.py), as csrc/flash_attention_bwd.cu does
// at fp32.  Built alone into the bf16 backward library
// (parsec_tpu_torch/ops/kernels.py): ptt_flash_bwd_bf16.  Arithmetic kept:
// the score is (q . k) * scale, summed in fp32; the causal mask is the
// local-index one (row i sees keys 0..i, also when T != Tk), under which a
// masked probability is exactly 0; l == 0 -> 1; scale multiplies dS;
// delta = rowsum(dO o O) in fp32 from the forward's bf16 O (so it carries
// O's rounding, where the JAX VJP's rowsum(P o dP) does not).
//
// Precision.  The JAX VJP computes p and ds in fp32 and its products on
// widened operands (preferred_element_type=float32).  The tensor cores
// take bf16 operands, so this kernel rounds P and dS to bf16 (nearest
// even) before the products that read them (dV = P^T dO; dK = dS^T Q and
// dQ = dS K), and sums every product in fp32.  The Pallas forward does the
// same to p before P . V (p.astype(v.dtype)), and so do FlashAttention-2
// and -3 and SDPA.  dK and dV are rounded once from their fp32 registers;
// dQ's sum stays fp32 in a scratch the wrapper allocates, and the key
// tile that visits a query tile last rounds it once into the bf16 dQ.
//
// What bounds it.  At the transformer's shape ([8, 12, 1024, 64], causal)
// the five products (S and dP recomputed, dV, dK, dQ) do 10 D flops for
// each visible (query, key) pair, 32.2 GFLOP, over 100.7 MB of Q, K, V, O,
// dO, dQ, dK, dV and the row statistics: 0.033 ms at the 989 TFLOP/s bf16
// tensor-core rate of an H100 SXM against 0.030 ms at its 3.35 TB/s, so
// the tensor cores bound it, by a little.  Inside an SM the exponentials
// and the elementwise dS sit between the products.
//
// What the design does about it.
//   - One persistent block an SM takes (b*h, key tile of 128 keys) work
//     items from an atomic counter in key-major order (the heaviest causal
//     items first, as csrc/flash_attention_bwd.cu does) and walks the
//     64-row query tiles that see its key tile, from the last down.  Two
//     consumer warpgroups hold 64 keys each; a producer warpgroup's first
//     warp loads, its other three are dQ writers.  setmaxnreg gives the
//     consumers 232 registers a thread, the producers 40.
//   - S and dP on wgmma as S^T = K . Q^T and dP^T = V . dO^T (the swap of
//     FlashAttention-3): A is the warpgroup's 64 rows of the K or V tile,
//     B the Q or dO tile, both K-major as they lie in memory.  P^T and
//     dS^T are formed on the fp32 accumulator fragments and rounded to
//     bf16 pairs in place, which is the register-A layout of the next
//     products: dV += P^T dO and dK += dS^T Q, with B (dO, Q) read MN-major
//     through the transpose bit.  dK and dV stay in registers across the
//     walk.  p = 2^(s scale log2 e - lse), with each query row's lse =
//     m log2 e + log2 l formed once a pair for the warpgroup; only tiles
//     that hold a masked pair (the diagonal, the ragged ends) take the
//     masked path.
//   - dQ's part of a pair, dS K: dS^T goes once into shared memory
//     (bf16, 128-byte swizzled) and is read as an MN-major A through the
//     transpose bit, K as an MN-major B.  At D <= 64 each warpgroup sums
//     its own 64 keys for all 64 columns, so the two never wait for each
//     other mid-pair (a barrier there, tried with a column split, cost a
//     third of the time, and so did a two-way hand-over of half parts at
//     the end, or the two roles below taken in turn); the first puts its
//     part in shared memory and goes on, the second adds it to its own and
//     finishes the pair.
//     At D = 128 each takes a 64-column half over all 128 keys, after a
//     barrier of both (two dS^T buffers in turn).
//   - dQ's sum is ordered: a (b*h, query tile)'s turn counter in a zeroed
//     int scratch lets key tile j add only once it reads j, and hands the
//     turn on with j + 1.  The consumers announce each pair when they
//     start it; a writer group waits for its turn (an acquire load) and
//     loads the fp32 sum so far into shared memory while the pair's
//     products run; the consumers add it onto their part in registers and
//     store the result (key tile 0 stores its part alone, so the scratch
//     needs no zeroing; the last key tile rounds it once into dQ); the
//     writer then fences and hands the turn on (a release store).  Three
//     writer groups, one a buffer, keep three pairs in flight.  No float
//     atomics: launches on the same inputs give the same bits.  Every
//     wait is on an item handed out earlier (the turns) or on the block's
//     own earlier pairs, so none is circular.
//   - K and V arrive once an item, Q, dO and the m, l, delta rows of each
//     query tile through a ring of stages, all by TMA over tensor maps
//     (3-D (D, rows, b*h) for the bf16 operands, 128-byte swizzled and
//     zero-filled past T, Tk and D; 2-D rows of fp32 for the statistics)
//     with mbarriers; at D <= 64 the next item's K and V arrive while this
//     one runs.  Operands TMA cannot take (D * 2 bytes not a multiple of
//     16, or a base not 16-byte aligned) are copied by the loader warp
//     with 2-byte loads into the same swizzled layout; the consumers' code
//     is the same, so misaligned and aligned operands give the same bits.
//   - Rows past T, keys past Tk and masked pairs take P = dS = 0 by a
//     select, so no tile size has to divide T or Tk.
//
// The delta pass is its own small kernel, launched first on the stream.
// Measured: registers, spills and shared memory of each instance are
// chip_smoke.py's `[timing] instance=` lines (ptt_flash_bwd_attributes),
// times at the transformer's shape PERF.md.
#include "hopper.cuh"

#include <climits>

namespace {

constexpr int CONSUMERS = 2;                 // warpgroups of 64 keys
constexpr int BK = CONSUMERS * 64;           // keys an item: 128
constexpr int BQ = 64;                       // query rows a tile
constexpr int LOADER_WARP = CONSUMERS * 4;   // warp 8; 9..11 write dQ
constexpr int THREADS = (CONSUMERS + 1) * 128;   // 384
constexpr int WRITERS = 96;
constexpr int PRODUCER_REGS = 40;            // 128 x 40 + 256 x 232 <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr int D_MAX = 128;
constexpr float LOG2E = 1.4426950408889634f;
// named barriers: 1 and 2 a consumer warpgroup's, 3 both consumer
// warpgroups', 4.. a dQ writer group's
constexpr int BAR_CONSUMERS = 3;
constexpr int BAR_WRITERS = 4;

// byte offsets from a 1024-byte aligned base: KV_BUFS x (K, V [DP / 64]
// [BK][64]); STAGES x (Q, dO [DP / 64][BQ][64]); DS_BUFS x dS^T [BK][64]
// bf16, one a pair in turn; DQ_BUFS x two [BQ][64] fp32 halves (at
// D <= 64 one warpgroup's part of the pair, then the dQ sum so far; at
// D = 128 the sum so far, its two column halves); STAGES x (m, l,
// delta) [BQ] fp32; each consumer warpgroup's [BQ] fp32 log-sum-exp of
// the query rows; the barriers (KV full, KV empty, stage full, stage
// empty; of each dQ buffer: pair announced, sum so far loaded, part
// stored, buffer free, a warpgroup's part written); the item of each KV
// buffer and the pair of each dQ buffer (bh, query tile, key tile, last)
template <int DP>
struct Smem {
  static constexpr int KV_BUFS = DP == 64 ? 2 : 1;
  static constexpr int STAGES = 2;
  static constexpr int DS_BUFS = DP == 64 ? 1 : 2;
  // one dQ writer group a buffer: three warps, or one group of three
  static constexpr int DQ_BUFS = DP == 64 ? 3 : 1;

  static constexpr int K_BYTES = BK * DP * 2;
  static constexpr int KV_BYTES = 2 * K_BYTES;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  static constexpr int DS_BYTES = BK * BQ * 2;
  static constexpr int HALF_BYTES = BQ * 64 * 4;
  static constexpr int DQ_BYTES = 2 * HALF_BYTES;
  static constexpr int STATS_BYTES = 3 * BQ * 4;
  static constexpr int ST = KV_BUFS * KV_BYTES;
  static constexpr int DS = ST + STAGES * STAGE_BYTES;
  static constexpr int DQ = DS + DS_BUFS * DS_BYTES;
  static constexpr int STATS = DQ + DQ_BUFS * DQ_BYTES;
  static constexpr int LSE = STATS + STAGES * STATS_BYTES;
  static constexpr int BARS = LSE + CONSUMERS * BQ * 4;
  static constexpr int SLOTS = BARS + 8 * (2 * KV_BUFS + 2 * STAGES +
                                           5 * DQ_BUFS);
  static constexpr int BYTES = SLOTS + 4 * (KV_BUFS + 4 * DQ_BUFS) + 1024;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int lds_i32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_i32(uint32_t addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// 16 and 4 bytes from device memory (through L2) into shared memory
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.wait_group 0;\n" ::
          : "memory");
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// P^T on S^T's fragments: sc[4 j + 2 r + c] is key krow + 8 r, query
// q0 + 8 j + 2 t4 + c.  p = 2^(s scale log2 e - lse) with lse = m log2 e +
// log2 l (l == 0 -> 1): exp(scale s - m) / l.  EDGE: the warpgroup's keys
// reach past Tk, the tile's queries past T, or some key lies above some
// query (causal); masked pairs take p = 0 by a select, and the mask's
// bits are returned for dS
template <bool CAUSAL, bool EDGE>
__device__ __forceinline__ uint32_t p_tile(float (&sc)[32], uint32_t lse,
                                           int q0, int krow, int t4, int T,
                                           int Tk, float sl) {
  uint32_t vis = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const float2 e2 = lds_f2(lse + 4 * col);
    const float e[2] = {e2.x, e2.y};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 4 * j + 2 * r + c;
        const float p = ex2(fmaf(sc[i], sl, -e[c]));
        if (EDGE) {
          const int qi = q0 + col + c, key = krow + 8 * r;
          const bool in = qi < T && key < Tk && (!CAUSAL || key <= qi);
          sc[i] = in ? p : 0.f;
          vis |= static_cast<uint32_t>(in) << i;
        } else {
          sc[i] = p;
        }
      }
  }
  return vis;
}

// dS^T = scale P^T o (dP^T - delta), in dP's fragments; masked pairs 0
template <bool EDGE>
__device__ __forceinline__ void ds_tile(const float (&sc)[32],
                                        float (&dp)[32], uint32_t delta,
                                        uint32_t vis, int t4, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = lds_f2(delta + 4 * (8 * j + 2 * t4));
    const float d[2] = {d2.x, d2.y};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 4 * j + 2 * r + c;
        const float x = sc[i] * (dp[i] - d[c]) * scale;
        dp[i] = !EDGE || ((vis >> i) & 1) ? x : 0.f;
      }
  }
}

// the fp32 [BQ][64] half of a dQ buffer: 16-byte groups swizzled by row
__device__ __forceinline__ uint32_t dq_addr(uint32_t half, int row,
                                            int col) {
  return half + row * 256 + ((((col >> 2) ^ (row & 7))) << 4) +
         (col & 3) * 4;
}



// delta[row] = sum_d dO[row, d] O[row, d] in fp32: LPR lanes a row, 8
// columns a lane (16-byte loads when `vec`, else 2-byte ones in the same
// order), the lanes' sums added by shuffles
template <int LPR>
__global__ void __launch_bounds__(256)
flash_bwd_delta_bf16_kernel(const bf16* __restrict__ O,
                            const bf16* __restrict__ dO,
                            float* __restrict__ Delta, long long rows, int D,
                            int vec) {
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const long long row =
      (static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5)) *
          (32 / LPR) + lane / LPR;
  const int c0 = 8 * sub;
  float acc = 0.f;
  if (row < rows && c0 < D) {
    const bf16* o = O + row * D + c0;
    const bf16* g = dO + row * D + c0;
    if (vec) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o);
      const uint4 gv = *reinterpret_cast<const uint4*>(g);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
      const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int sh = 16 * (e & 1);
        acc = fmaf(__uint_as_float((gw[e >> 1] >> sh) << 16),
                   __uint_as_float((ow[e >> 1] >> sh) << 16), acc);
      }
    } else {
      for (int e = 0; e < 8 && c0 + e < D; ++e)
        acc = fmaf(__bfloat162float(g[e]), __bfloat162float(o[e]), acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < rows) Delta[row] = acc;
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* m;
  const float* l;
  const float* delta;
  float* dq_acc;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int* counters;
  int bh, T, Tk, D;
  float scale;
  int tma, pairs, dq_vec;   // TMA loads; 4-byte bf16 pairs; 16-byte dQ
};

// DP: D padded to 64 or 128
template <bool CAUSAL, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tm,
                      const __grid_constant__ CUtensorMap tl,
                      const __grid_constant__ CUtensorMap tdl, const Args a) {
  using L = Smem<DP>;
  constexpr int NC = DP / CHUNK, KV_BUFS = L::KV_BUFS, STAGES = L::STAGES;
  constexpr int DQ_BUFS = L::DQ_BUFS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_full0 = base + L::BARS, kv_empty0 = kv_full0 + 8 * KV_BUFS;
  const uint32_t full0 = kv_empty0 + 8 * KV_BUFS;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t dq_ann0 = empty0 + 8 * STAGES;
  const uint32_t dq_old0 = dq_ann0 + 8 * DQ_BUFS;
  const uint32_t dq_done0 = dq_old0 + 8 * DQ_BUFS;
  const uint32_t dq_half0 = dq_done0 + 8 * DQ_BUFS;
  const uint32_t dq_empty0 = dq_half0 + 8 * DQ_BUFS;
  const uint32_t item_slot0 = base + L::SLOTS;
  const uint32_t pair_slot0 = item_slot0 + 4 * KV_BUFS;
  const int T = a.T, Tk = a.Tk, D = a.D, bh_n = a.bh;
  const int nq = (T + BQ - 1) / BQ, nk = (Tk + BK - 1) / BK;
  const int items = bh_n * nk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int b = 0; b < KV_BUFS; ++b) {
      mbar_init(kv_full0 + 8 * b, 1);
      mbar_init(kv_empty0 + 8 * b, CONSUMERS * 4);   // each consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);
    }
    for (int b = 0; b < DQ_BUFS; ++b) {
      mbar_init(dq_ann0 + 8 * b, 1);     // the consumer filling the slot
      mbar_init(dq_old0 + 8 * b, 1);     // a writer
      // the warps that store: at D <= 64 the second warpgroup's
      mbar_init(dq_done0 + 8 * b, (DP == 64 ? 1 : CONSUMERS) * 4);
      mbar_init(dq_half0 + 8 * b, 4);    // the first warpgroup's warps
      mbar_init(dq_empty0 + 8 * b, 1);   // a writer
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= LOADER_WARP) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == LOADER_WARP) {
      // the loader: K and V of each item, then Q, dO and the statistics of
      // each query tile it walks.  By TMA lane 0 issues everything; the
      // per-thread copy takes the whole warp
      int* work = a.counters + static_cast<long long>(bh_n) * nq;
      int gk = 0, gs = 0;   // items and query tiles loaded
      for (;; ++gk) {
        int item = 0;
        if (lane == 0) item = atomicAdd(work, 1);
        item = __shfl_sync(0xffffffffu, item, 0);
        const int kb = gk % KV_BUFS;
        if (gk >= KV_BUFS) ring_wait(kv_empty0 + 8 * kb, gk / KV_BUFS - 1);
        const uint32_t kbar = kv_full0 + 8 * kb;
        if (item >= items) {
          if (lane == 0) {
            sts_i32(item_slot0 + 4 * kb, -1);
            mbar_arrive(kbar);
          }
          break;
        }
        const int kt = item / bh_n, bh = item - kt * bh_n, k0 = kt * BK;
        const uint32_t ks = base + kb * L::KV_BYTES, vs = ks + L::K_BYTES;
        if (a.tma) {
          if (lane == 0) {
            sts_i32(item_slot0 + 4 * kb, item);
            mbar_expect_tx(kbar, L::KV_BYTES);
            for (int c = 0; c < NC; ++c) {
              tma_load_3d(ks + c * BK * ROW_BYTES, &tk, c * CHUNK, k0, bh,
                          kbar);
              tma_load_3d(vs + c * BK * ROW_BYTES, &tv, c * CHUNK, k0, bh,
                          kbar);
            }
          }
        } else {
          if (lane == 0) sts_i32(item_slot0 + 4 * kb, item);
          const long long off = static_cast<long long>(bh) * Tk * D;
          copy_box(ks, a.k + off, D, k0, Tk, BK, 0, D, NC, lane, 32);
          copy_box(vs, a.v + off, D, k0, Tk, BK, 0, D, NC, lane, 32);
          publish(kbar, lane);
        }
        const int qfirst = CAUSAL ? min(k0 / BQ, nq) : 0;
        for (int qt = nq - 1; qt >= qfirst; --qt, ++gs) {
          const int s = gs % STAGES, q0 = qt * BQ;
          if (gs >= STAGES) ring_wait(empty0 + 8 * s, gs / STAGES - 1);
          const uint32_t qs = base + L::ST + s * L::STAGE_BYTES;
          const uint32_t ds = qs + L::Q_BYTES;
          const uint32_t st = base + L::STATS + s * L::STATS_BYTES;
          const uint32_t bar = full0 + 8 * s;
          if (a.tma) {
            if (lane == 0) {
              mbar_expect_tx(bar, L::STAGE_BYTES + L::STATS_BYTES);
              for (int c = 0; c < NC; ++c) {
                tma_load_3d(qs + c * BQ * ROW_BYTES, &tq, c * CHUNK, q0, bh,
                            bar);
                tma_load_3d(ds + c * BQ * ROW_BYTES, &tdo, c * CHUNK, q0, bh,
                            bar);
              }
              // rows past T read the next (b, h)'s values or zeros: the
              // consumers mask them
              const int r0 = bh * T + q0;
              tma_load_2d(st, &tm, r0, 0, bar);
              tma_load_2d(st + 4 * BQ, &tl, r0, 0, bar);
              tma_load_2d(st + 8 * BQ, &tdl, r0, 0, bar);
            }
          } else {
            const long long off = static_cast<long long>(bh) * T;
            copy_box(qs, a.q + off * D, D, q0, T, BQ, 0, D, NC, lane, 32);
            copy_box(ds, a.dout + off * D, D, q0, T, BQ, 0, D, NC, lane, 32);
            for (int i = lane; i < 3 * BQ; i += 32) {
              const int w = i / BQ, r = i - w * BQ;
              const float* src = w == 0 ? a.m : w == 1 ? a.l : a.delta;
              const float x = q0 + r < T ? src[off + q0 + r] : 0.f;
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(st + 4 * i),
                           "f"(x)
                           : "memory");
            }
            publish(bar, lane);
          }
        }
      }
    } else {
      // the dQ writers: for each pair, announced when the consumers start
      // it, they wait for the (b*h, query tile)'s turn and load the dQ
      // sum so far into shared memory while the pair's products run; the
      // consumers add their part and store; then the writers hand the
      // turn on.  DQ_BUFS groups, group g taking buffer g's pairs; a
      // group never holds a turn while it waits for one
      constexpr int GW = WRITERS / DQ_BUFS;   // threads a group
      const int w0 = tid - (LOADER_WARP + 1) * 32;
      const int grp = w0 / GW, wt = w0 - grp * GW;
      const int bar_id = BAR_WRITERS + grp;
      const int G = DP / 4;   // float4 groups a row
      // the sum so far: at D <= 64 the buffer's second half, at D = 128
      // the whole buffer, two column halves
      const uint32_t old0 = base + L::DQ + grp * L::DQ_BYTES +
                            (DP == 64 ? L::HALF_BYTES : 0);
      for (int gp = grp;; gp += DQ_BUFS) {
        const int b = grp;
        ring_wait(dq_ann0 + 8 * b, gp / DQ_BUFS);
        const uint32_t slot = pair_slot0 + 16 * b;
        const int bh = lds_i32(slot);
        if (bh < 0) break;
        const int qt = lds_i32(slot + 4), kt = lds_i32(slot + 8);
        int* cnt = a.counters + static_cast<long long>(bh) * nq + qt;
        if (kt > 0) {
          if (wt == 0)
            while (load_acquire(cnt) != kt) __nanosleep(32);
          named_sync(bar_id, GW);
          // every load in flight at once, [row][column]
          const int q0 = qt * BQ, rows = min(BQ, T - q0);
          const long long row0 = static_cast<long long>(bh) * T + q0;
          for (int u = wt; u < rows * G; u += GW) {
            const int row = u / G, c = 4 * (u - row * G);
            if (c >= D) continue;
            const float* acc = a.dq_acc + (row0 + row) * D + c;
            const uint32_t dst =
                dq_addr(old0 + (c >> 6) * L::HALF_BYTES, row, c & 63);
            if (a.dq_vec) {
              cp_async16(dst, acc);
            } else {
              for (int i = 0; i < 4 && c + i < D; ++i)
                cp_async4(dst + 4 * i, acc + i);
            }
          }
          cp_async_wait_all();
          named_sync(bar_id, GW);
        }
        if (wt == 0) {
          mbar_arrive(dq_old0 + 8 * b);
          // the consumers' stores of the pair are done; the fence orders
          // them before the turn handed on
          ring_wait(dq_done0 + 8 * b, gp / DQ_BUFS);
          __threadfence();
          store_release(cnt, kt + 1);
          mbar_arrive(dq_empty0 + 8 * b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // a consumer warpgroup: keys 64 wg .. + 63 of each item; this thread's
    // keys are 16 ww + g and + 8 of them, its query columns of every 8 are
    // 2 t4 and + 1
    const int wg = warp >> 2, ww = warp & 3, g = lane >> 2, t4 = lane & 3;
    const float sl = a.scale * LOG2E;   // scale in the exponent's FFMA
    float dv[NC][32], dk[NC][32];
    int gs = 0, gp = 0;   // query tiles and pairs consumed
    for (int gk = 0;; ++gk) {
      const int kb = gk % KV_BUFS;
      ring_wait(kv_full0 + 8 * kb, gk / KV_BUFS);
      const int item = lds_i32(item_slot0 + 4 * kb);
      if (item < 0) {
        // no item left: tell every writer group
        for (int e = gp; e < gp + DQ_BUFS && tid == 0; ++e) {
          const int b = e % DQ_BUFS;
          if (e >= DQ_BUFS) ring_wait(dq_empty0 + 8 * b, e / DQ_BUFS - 1);
          sts_i32(pair_slot0 + 16 * b, -1);
          mbar_arrive(dq_ann0 + 8 * b);
        }
        break;
      }
      const int kt = item / bh_n, bh = item - kt * bh_n, k0 = kt * BK;
      const uint32_t ks = base + kb * L::KV_BYTES, vs = ks + L::K_BYTES;
      const uint32_t kw = ks + wg * 64 * ROW_BYTES;   // this warpgroup's keys
      const uint32_t vw = vs + wg * 64 * ROW_BYTES;
      // key = krow + 8 r
      const int krow = k0 + wg * 64 + 16 * ww + g;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) dv[c][i] = dk[c][i] = 0.f;
      const int qfirst = CAUSAL ? min(k0 / BQ, nq) : 0;
      for (int qt = nq - 1; qt >= qfirst; --qt, ++gs, ++gp) {
        const int s = gs % STAGES, q0 = qt * BQ;
        // the pair to its dQ buffer's writers, so they fetch the sum so
        // far while its products run
        const int b = gp % DQ_BUFS;
        if (gp >= DQ_BUFS) ring_wait(dq_empty0 + 8 * b, gp / DQ_BUFS - 1);
        const int last =
            kt == (CAUSAL ? min(nk - 1, (q0 + BQ - 1) / BK) : nk - 1);
        if (tid == 0) {
          const uint32_t slot = pair_slot0 + 16 * b;
          sts_i32(slot, bh);
          sts_i32(slot + 4, qt);
          sts_i32(slot + 8, kt);
          sts_i32(slot + 12, last);
          mbar_arrive(dq_ann0 + 8 * b);
        }
        ring_wait(full0 + 8 * s, gs / STAGES);
        const uint32_t qs = base + L::ST + s * L::STAGE_BYTES;
        const uint32_t dos = qs + L::Q_BYTES;
        const uint32_t st = base + L::STATS + s * L::STATS_BYTES;

        // S^T = K . Q^T and dP^T = V . dO^T: keys x queries, D in steps
        // of 16
        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_n64<0, 0>(
              sc, sw128_desc(kw + (kk >> 2) * BK * ROW_BYTES + (kk & 3) * 32),
              sw128_desc(qs + (kk >> 2) * BQ * ROW_BYTES + (kk & 3) * 32),
              kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_n64<0, 0>(
              dp, sw128_desc(vw + (kk >> 2) * BK * ROW_BYTES + (kk & 3) * 32),
              sw128_desc(dos + (kk >> 2) * BQ * ROW_BYTES + (kk & 3) * 32),
              kk > 0);
        wgmma_commit();

        // each query row's log-sum-exp, once a row for the warpgroup (the
        // barrier after the last pair's dS^T stores means every thread is
        // done reading the last pair's)
        const uint32_t lse = base + L::LSE + wg * BQ * 4;
        if ((tid & 127) < BQ) {
          const int r = tid & 127;
          const float lr = lds_f32(st + 4 * (BQ + r));
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(lse + 4 * r),
                       "f"(fmaf(lds_f32(st + 4 * r), LOG2E,
                                lg2(lr == 0.f ? 1.f : lr)))
                       : "memory");
        }
        named_sync(1 + wg, 128);
        // a mask only where some pair of the warpgroup's tile is masked
        const int kw0 = k0 + wg * 64;
        const bool edge = q0 + BQ > T || kw0 + 64 > Tk ||
                          (CAUSAL && kw0 + 63 > q0);
        wgmma_wait<1>();
        fence_regs(sc);
        const uint32_t vis =
            edge ? p_tile<CAUSAL, true>(sc, lse, q0, krow, t4, T, Tk, sl)
                 : p_tile<CAUSAL, false>(sc, lse, q0, krow, t4, T, Tk, sl);
        wgmma_wait<0>();
        fence_regs(dp);
        if (edge)
          ds_tile<true>(sc, dp, st + 8 * BQ, vis, t4, a.scale);
        else
          ds_tile<false>(sc, dp, st + 8 * BQ, vis, t4, a.scale);
        // both as bf16 pairs in wgmma's register A layout (the accumulator's
        // own order): for queries 16 kk .. + 15, (key g, 2 t4, + 1), (key g
        // + 8, the same), (key g, + 8), (key g + 8, + 8)
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
            da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
          }
        // dS^T into shared memory for dQ: row = key of the tile, 64 query
        // columns a 128-byte swizzled row
        // (at D = 128 two buffers in turn: a warpgroup past the barrier
        // below has seen the other one finish the products that read the
        // buffer it writes next)
        const uint32_t dsb =
            base + L::DS + (L::DS_BUFS > 1 ? (gp & 1) * L::DS_BYTES : 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = wg * 64 + 16 * ww + g + 8 * (i & 1);
            const int grp = 2 * kk + (i >> 1);
            sts_i32(dsb + row * ROW_BYTES + ((grp ^ (row & 7)) << 4) + 4 * t4,
                    static_cast<int>(da[kk][i]));
          }
        fence_async_smem();
        if constexpr (DP == 64)
          named_sync(1 + wg, 128);          // this warpgroup's keys alone
        else
          named_sync(BAR_CONSUMERS, 256);   // every key's dS^T

        // dV += P^T dO, dK += dS^T Q (A from registers, B transposed), and
        // this pair's dQ part, dS K: at D <= 64 over this warpgroup's 64
        // keys for all 64 columns, at D = 128 over all 128 keys for its
        // column half
        float dq[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            wgmma_rs_n64(dv[c], pa[kk],
                         sw128_desc(dos + c * BQ * ROW_BYTES +
                                    kk * 16 * ROW_BYTES));
            wgmma_rs_n64(dk[c], da[kk],
                         sw128_desc(qs + c * BQ * ROW_BYTES +
                                    kk * 16 * ROW_BYTES));
          }
        if constexpr (DP == 64) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int key = wg * 64 + 16 * kk;
            wgmma_ss_n64<1, 1>(dq, sw128_desc(dsb + key * ROW_BYTES),
                               sw128_desc(ks + key * ROW_BYTES), kk > 0);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_ss_n64<1, 1>(
                dq, sw128_desc(dsb + kk * 16 * ROW_BYTES),
                sw128_desc(ks + wg * BK * ROW_BYTES + kk * 16 * ROW_BYTES),
                kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          fence_regs(dv[c]);
          fence_regs(dk[c]);
        }
        fence_regs(dq);
        fence_regs(pa);
        fence_regs(da);
        warp_release(empty0 + 8 * s, lane);

        // the dQ sum.  At D <= 64 the first warpgroup puts its keys' part
        // in the buffer and goes on; the second adds its own onto it, then
        // the sum so far, and stores.  At D = 128 each adds the sum so far
        // onto its column half and stores.  Stores go into the fp32
        // scratch, or once rounded into dQ at the last key tile
        const uint32_t part = base + L::DQ + b * L::DQ_BYTES;
        const uint32_t old = part + (DP == 64 ? L::HALF_BYTES : 0);
        if (DP == 64 && wg == 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * j + 2 * r;
              asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                               dq_addr(part, 16 * ww + g + 8 * r,
                                       8 * j + 2 * t4)),
                           "f"(dq[i]), "f"(dq[i + 1])
                           : "memory");
            }
          warp_release(dq_half0 + 8 * b, lane);
          continue;
        }
        if (DP == 64) ring_wait(dq_half0 + 8 * b, gp / DQ_BUFS);
        ring_wait(dq_old0 + 8 * b, gp / DQ_BUFS);
        const long long row0 = static_cast<long long>(bh) * T + q0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * ww + g + 8 * r;
          if (q0 + row >= T) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int i = 4 * j + 2 * r;
            const int col = (DP == 64 ? 0 : 64 * wg) + 8 * j + 2 * t4;
            if (col >= D) continue;
            float2 x = make_float2(dq[i], dq[i + 1]);
            if (DP == 64) {   // the first warpgroup's part + this one's
              const float2 h = lds_f2(dq_addr(part, row, 8 * j + 2 * t4));
              x = make_float2(h.x + x.x, h.y + x.y);
            }
            if (kt > 0) {   // the sum so far + this key tile's part
              const float2 o = lds_f2(
                  dq_addr(old + (col >> 6) * L::HALF_BYTES, row, col & 63));
              x = make_float2(o.x + x.x, o.y + x.y);
            }
            const long long at = (row0 + row) * D + col;
            if (a.dq_vec) {
              if (last)   // one rounding, to nearest even
                *reinterpret_cast<uint32_t*>(a.dq + at) = pack_bf16(x.x, x.y);
              else
                __stcg(reinterpret_cast<float2*>(a.dq_acc + at), x);
            } else {
              if (last)
                a.dq[at] = __float2bfloat16_rn(x.x);
              else
                __stcg(a.dq_acc + at, x.x);
              if (col + 1 < D) {
                if (last)
                  a.dq[at + 1] = __float2bfloat16_rn(x.y);
                else
                  __stcg(a.dq_acc + at + 1, x.y);
              }
            }
          }
        }
        warp_release(dq_done0 + 8 * b, lane);
      }

      // dK and dV of the item's keys (zero when no query sees them), each
      // rounded once
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = krow + 8 * r;
        if (key >= Tk) continue;
        const long long off = (static_cast<long long>(bh) * Tk + key) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * CHUNK + 8 * j + 2 * t4;
            if (col >= D) continue;
            const int i = 4 * j + 2 * r;
            if (a.pairs) {
              *reinterpret_cast<__nv_bfloat162*>(a.dk + off + col) =
                  __floats2bfloat162_rn(dk[c][i], dk[c][i + 1]);
              *reinterpret_cast<__nv_bfloat162*>(a.dv + off + col) =
                  __floats2bfloat162_rn(dv[c][i], dv[c][i + 1]);
            } else {
              a.dk[off + col] = __float2bfloat16_rn(dk[c][i]);
              a.dv[off + col] = __float2bfloat16_rn(dv[c][i]);
              if (col + 1 < D) {
                a.dk[off + col + 1] = __float2bfloat16_rn(dk[c][i + 1]);
                a.dv[off + col + 1] = __float2bfloat16_rn(dv[c][i + 1]);
              }
            }
          }
      }
      warp_release(kv_empty0 + 8 * kb, lane);
    }
  }
}

struct Instance {
  const void* fn;
  const char* name;
  int smem_bytes;
};

const Instance kInstances[] = {
    {reinterpret_cast<const void*>(flash_bwd_delta_bf16_kernel<8>),
     "flash_bwd_delta_bf16_kernel<LPR=8>", 0},
    {reinterpret_cast<const void*>(flash_bwd_bf16_kernel<true, 64>),
     "flash_bwd_bf16_kernel<causal=true,DP=64>", Smem<64>::BYTES},
    {reinterpret_cast<const void*>(flash_bwd_bf16_kernel<false, 64>),
     "flash_bwd_bf16_kernel<causal=false,DP=64>", Smem<64>::BYTES},
    {reinterpret_cast<const void*>(flash_bwd_bf16_kernel<true, 128>),
     "flash_bwd_bf16_kernel<causal=true,DP=128>", Smem<128>::BYTES},
    {reinterpret_cast<const void*>(flash_bwd_bf16_kernel<false, 128>),
     "flash_bwd_bf16_kernel<causal=false,DP=128>", Smem<128>::BYTES}};

// the delta pass: lanes a row for D's 8-column groups (a power of two)
cudaError_t launch_delta(const bf16* o, const bf16* dout, float* delta,
                         long long rows, int D, cudaStream_t s) {
  const int vec = D % 8 == 0 && aligned_to(o, 16) && aligned_to(dout, 16);
  const int groups = (D + 7) / 8;
  const int lpr = groups <= 1 ? 1 : groups <= 2 ? 2 : groups <= 4 ? 4
                : groups <= 8 ? 8 : 16;
  const long long per_block = 8LL * (32 / lpr);
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) /
                                                per_block);
  switch (lpr) {
    case 1: flash_bwd_delta_bf16_kernel<1><<<blocks, 256, 0, s>>>(
                o, dout, delta, rows, D, vec); break;
    case 2: flash_bwd_delta_bf16_kernel<2><<<blocks, 256, 0, s>>>(
                o, dout, delta, rows, D, vec); break;
    case 4: flash_bwd_delta_bf16_kernel<4><<<blocks, 256, 0, s>>>(
                o, dout, delta, rows, D, vec); break;
    case 8: flash_bwd_delta_bf16_kernel<8><<<blocks, 256, 0, s>>>(
                o, dout, delta, rows, D, vec); break;
    default: flash_bwd_delta_bf16_kernel<16><<<blocks, 256, 0, s>>>(
                o, dout, delta, rows, D, vec);
  }
  return cudaGetLastError();
}

template <bool CAUSAL, int DP>
int launch(const Args& a, cudaStream_t stream) {
  const auto kernel = flash_bwd_bf16_kernel<CAUSAL, DP>;
  // above 48 KB a block's dynamic shared memory must be asked for; first,
  // so that the card's context is current for the tensor maps' encoding
  // (see matmul_bf16.cu)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DP>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq{}, tk{}, tv{}, tdo{}, tm{}, tl{}, tdl{};
  const long long D = a.D, T = a.T, Tk = a.Tk, bh = a.bh;
  if (a.tma &&
      ((err = encode_bf16_3d(&tq, a.q, D, T, bh, 2 * D, 2 * D * T, BQ)) !=
           cudaSuccess ||
       (err = encode_bf16_3d(&tdo, a.dout, D, T, bh, 2 * D, 2 * D * T,
                             BQ)) != cudaSuccess ||
       (err = encode_bf16_3d(&tk, a.k, D, Tk, bh, 2 * D, 2 * D * Tk, BK)) !=
           cudaSuccess ||
       (err = encode_bf16_3d(&tv, a.v, D, Tk, bh, 2 * D, 2 * D * Tk, BK)) !=
           cudaSuccess ||
       (err = encode_f32_row(&tm, a.m, bh * T, BQ)) != cudaSuccess ||
       (err = encode_f32_row(&tl, a.l, bh * T, BQ)) != cudaSuccess ||
       (err = encode_f32_row(&tdl, a.delta, bh * T, BQ)) != cudaSuccess))
    return static_cast<int>(err);
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return static_cast<int>(err);
  // persistent: one block an SM, or one an item
  const int items = a.bh * ((a.Tk + BK - 1) / BK);
  kernel<<<items < sms ? items : sms, THREADS, Smem<DP>::BYTES, stream>>>(
      tq, tk, tv, tdo, tm, tl, tdl, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dQ, dK, dV of O = attention(Q, K, V) for bh (batch x head) slices,
// row-major bf16: Q, O, dO and dQ are [bh, T, D], K, V, dK and dV
// [bh, Tk, D], M and L the forward's raw row max and denominator [bh, T]
// fp32, Delta a [bh, T] fp32 scratch, dq_acc an fp32 [bh, T, D] scratch
// for dQ's ordered sum (no zeroing needed), Counters a ZEROED int scratch
// of n_counters >= bh * ceil(T / 64) + 1 entries (the 64-row query tiles'
// turn counters, then the work-item counter); 1 <= D <= 128.  Two launches
// on `stream` (delta, then the persistent kernel); returns the first
// cudaGetLastError() that is not 0 (or the error of building a tensor
// map), else 0.
int ptt_flash_bwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* o, const float* m, const float* l,
                       const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
                       float* delta, float* dq_acc, int* counters,
                       long long n_counters, int bh, int T, int Tk, int D,
                       int causal, float scale, void* stream) {
  if (bh < 1 || T < 1 || Tk < 1 || D < 1 || D > D_MAX ||
      static_cast<long long>(bh) * ((Tk + BK - 1) / BK) > INT_MAX ||
      static_cast<long long>(bh) * T > INT_MAX ||
      n_counters < static_cast<long long>(bh) * ((T + BQ - 1) / BQ) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_delta(o, dout, delta,
                                       static_cast<long long>(bh) * T, D, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // TMA takes 16-byte aligned bases and row strides of a multiple of 16
  // bytes; other operands take the per-thread copy
  const bool tma = D % 8 == 0 && aligned_to(q, 16) && aligned_to(k, 16) &&
                   aligned_to(v, 16) && aligned_to(dout, 16) &&
                   aligned_to(m, 16) && aligned_to(l, 16) &&
                   aligned_to(delta, 16);
  const bool pairs = D % 2 == 0 && aligned_to(dk, 4) && aligned_to(dv, 4);
  const bool dq_vec = D % 4 == 0 && aligned_to(dq_acc, 16) &&
                      aligned_to(dq, 8);
  const Args a{q, k, v, dout, m, l, delta, dq_acc, dq, dk, dv, counters,
               bh, T, Tk, D, scale, tma, pairs, dq_vec};
  if (D <= CHUNK)
    return causal ? launch<true, 64>(a, s) : launch<false, 64>(a, s);
  return causal ? launch<true, 128>(a, s) : launch<false, 128>(a, s);
}

// Instance i of the library (0: the delta pass): its name and, in
// out[0..4], registers a thread, local (spill) bytes a thread, static
// shared bytes, dynamic shared bytes, resident blocks an SM.  Returns 0,
// -1 past the last instance, or a cudaError_t.
int ptt_flash_bwd_attributes(int i, int* out, const char** name) {
  if (i < 0 || i >= static_cast<int>(sizeof(kInstances) /
                                     sizeof(kInstances[0])))
    return -1;
  const Instance& inst = kInstances[i];
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, inst.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (inst.smem_bytes > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
           inst.smem_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  const int threads = i == 0 ? 256 : THREADS;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inst.fn,
                                                      threads,
                                                      inst.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = inst.smem_bytes;
  out[4] = per_sm;
  *name = inst.name;
  return 0;
}

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
