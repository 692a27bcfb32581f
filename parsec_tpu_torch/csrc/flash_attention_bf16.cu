// Flash attention forward at bf16 on Hopper's tensor cores (sm_90a), with
// optional export of each row's softmax statistics.
//
//   O[bh] = softmax(scale * Q[bh] . K[bh]^T, masked) . V[bh]
//   M[bh, i] = running max of row i, L[bh, i] = its denominator (raw)
//
// Replaces, at bf16, the JAX package's Pallas kernels `_flash_fwd_kernel`
// (reached through `_flash_fwd`'s pl.pallas_call) and
// `_flash_fwd_stats_kernel` (through `flash_attention_stats`), both in
// parsec_tpu/ops/pallas_kernels.py.  Built alone into the bf16 flash
// library (parsec_tpu_torch/ops/kernels.py): ptt_flash_fwd_bf16 and
// ptt_flash_fwd_stats_bf16, one kernel, whose statistics are written when
// M and L are given.  The fp32 instances stay in flash_attention.cu.  The
// building blocks it shares with the bf16 GEMM and backward (mbarriers,
// TMA, the per-thread copy, wgmma descriptors and forms, tensor-map
// encoding) are csrc/hopper.cuh's.
//
// Arithmetic kept from the Pallas kernel: the score is (q . k) * scale,
// summed in fp32; a masked score is -1e30 (not -inf) with the local-index
// causal mask (row i sees keys 0..i, also when T != Tk); a key past Tk
// adds exactly nothing; m starts at -1e30 and l at 0, and each key tile
// rescales by exp(m_prev - m_new); p is rounded to bf16 (nearest even)
// before P . V, the Pallas kernel's p.astype(v.dtype), while l sums the
// unrounded p; o = acc * (1 / l), l == 0 -> 1 on o only, rounded once to
// bf16; m and l are exported raw in fp32, m as the max of scale * q . k.
// exp(x - m) is computed as 2^(x log2 e - m log2 e) by the MUFU unit
// (ex2.approx.ftz), with m kept in natural units.  p is rounded at the
// running max of its 128-key tile (the Pallas kernel: of its 512-key
// block), so the two agree to bf16's unit roundoff, not bit for bit.
//
// What bounds it.  At the transformer's shape ([8, 12, 1024, 64], causal)
// the work is 4 D flops for each visible (query, key) pair, 12.9 GFLOP, and
// the bytes are Q, K, V read and O written once, 50.3 MB: 0.013 ms at the
// 989 TFLOP/s bf16 tensor-core rate of an H100 SXM against 0.015 ms at its
// 3.35 TB/s, so memory bounds it, by a little.  Inside an SM the limit is
// the softmax beside the tensor cores: at D = 64 a 128 x 128 tile's two
// products take as long at the tensor-core rate (1024 clocks) as its
// 16384 exponentials at the MUFU unit's 16 a clock.
//
// What the design does about it.  The TPU kernel walks key blocks along a
// sequential grid axis with m, l and acc in VMEM scratch.  Here one block
// runs on each SM and walks its share of the work items, 128 query rows
// of one (b, h) each, looping over 128-key tiles itself.  A block has two
// consumer warpgroups of 64 rows each and a producer warpgroup, whose
// registers setmaxnreg hands to the consumers (40 and 232 a thread).
//   - Products on the tensor cores with wgmma.  S = Q . K^T is
//     wgmma.m64n128k16 with Q and the K tile read from shared memory, both
//     K-major as they lie in memory, summed in fp32 registers.  O += P . V
//     is wgmma.m64n64k16 (once per 64 columns of D) with A = P from
//     registers: for 16-bit types one wgmma's accumulator layout is the
//     next one's register A layout, so the fp32 S accumulator is rounded
//     to bf16 pairs in place and P never touches shared memory.  B is the
//     V tile in shared memory, read MN-major through wgmma's transpose bit.
//   - Each step issues tile t's S and tile t - 1's P . V together, and
//     tile t's online softmax runs on the accumulator fragments while
//     P . V does.  A thread holds two rows, and a row's values lie in one
//     quad of lanes, so a row max or sum is two shuffles; maxima and sums
//     run in four chains a row.  Tiles that need no mask take a path with
//     none, and fold the scale into the exponent's FFMA.
//   - bf16 tiles in shared memory as they are, in 128-byte swizzled rows
//     (the layout wgmma's descriptors name), D zero-padded to 64 or 128.
//     K and V flow through a ring of three stages with mbarriers, across
//     work items; Q has two buffers at D <= 64, so the next item's Q and
//     first tiles arrive while this one runs.  One producer thread issues
//     TMA loads over 3-D tensor maps (D, T, BH), so a box at a ragged end
//     is zero-filled and does not bleed into the next (b, h), and each
//     consumer warp releases a stage when its products are done.
//     cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint, so the
//     library needs no -lcuda.
//   - Operands TMA cannot take (D * 2 bytes not a multiple of 16, or a
//     base not 16-byte aligned) are copied by the producer warp with
//     2-byte loads into the same swizzled layout, zeros past D and past T
//     or Tk; the consumers' code is the same, so misaligned and aligned
//     operands give the same bits.
//   - Heaviest causal items first, dealt to the blocks front to back and
//     back to front in turns, so their sums of tiles come out even.  With
//     128-row items and 128-key tiles no tile loaded lies wholly above a
//     warpgroup's rows; the diagonal and the ragged end are masked on the
//     fragments, so no block size has to divide T or Tk.  No atomics:
//     launches on the same inputs give the same bits.
//
// Measured (this build's -Xptxas -v, sm_90a, -O3; chip_smoke.py's [ptxas]
// lines): each of the four instances (causal or not, D <= 64 or <= 128)
// starts at 168 registers a thread (the launch's share of 384 threads, which
// setmaxnreg then moves), no spills, no static shared memory; dynamic
// shared memory (ptt_flash_fwd_bf16_attributes) 132176 bytes at D <= 64,
// 230464 at D <= 128, one block an SM.  Built with -DPTT_PHASE_CLOCKS
// (the flash_attention_bf16_phases library, on no path) each consumer
// warp also sums the clocks of each phase of its loop; chip_smoke.py's
// timing phase prints them.  Times and clocks at the forward's shape:
// PERF.md.
#include "hopper.cuh"

#include <climits>
#include <cmath>

namespace {

constexpr int CONSUMERS = 2;             // consumer warpgroups a block
constexpr int WG_ROWS = 64;              // query rows a consumer warpgroup
constexpr int BM = CONSUMERS * WG_ROWS;  // query rows a block: 128
constexpr int BN = 128;                  // keys a tile
constexpr int PRODUCER_WARP = CONSUMERS * 4;   // the one that works
// + a producer warpgroup, so that setmaxnreg can move its registers to
// the consumers: 384
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40;        // 128 x 40 + 256 x 232 <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr int D_MAX = 128;
constexpr float NEG_INF = -1e30f;        // the Pallas kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

// byte offsets in shared memory from a 1024-byte aligned base: QBUFS x Q
// [DP / 64][BM][64], then STAGES x (K, V) [DP / 64][BN][64], each row 128
// bytes swizzled; then the barriers (QBUFS Q full, QBUFS Q empty, STAGES
// full, STAGES empty).  Three K and V tiles in flight; at D <= 64 a second
// Q tile, for the next work item (at D = 128 it would not fit)
template <int DP>
struct Smem {
  static constexpr int QBUFS = DP == 64 ? 2 : 1;
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;   // one of K, V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int KV = QBUFS * Q_BYTES;
  static constexpr int BARS = KV + STAGES * STAGE_BYTES;
  // + the slack that aligns the base
  static constexpr int BYTES = BARS + 8 * (2 * QBUFS + 2 * STAGES) + 1024;
};

#define PTT_F8(a, i)                                                       \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),              \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// d (+)= A . B, 64 x 128 x 16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_s(float (&d)[64], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : PTT_F8(d, 0), PTT_F8(d, 8), PTT_F8(d, 16), PTT_F8(d, 24),
        PTT_F8(d, 32), PTT_F8(d, 40), PTT_F8(d, 48), PTT_F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef PTT_F8

// S = Q . K^T for one warpgroup's 64 rows and a 128-key tile, D in steps
// of 16 (32 bytes of a swizzled row, 64 columns a chunk)
template <int DP>
__device__ __forceinline__ void issue_s(float (&sc)[64], uint32_t qs,
                                        uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_s(sc, sw128_desc(qs + (kk >> 2) * BM * ROW_BYTES + (kk & 3) * 32),
            sw128_desc(ks + (kk >> 2) * BN * ROW_BYTES + (kk & 3) * 32),
            kk > 0);
}

// O += P . V over a 128-key tile, 16 keys (2048 bytes of V) a step, each
// 64-column chunk of V its own wgmma
template <int NC>
__device__ __forceinline__ void issue_pv(float (&o)[NC][32],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_rs_n64(o[c], pa[kk],
               sw128_desc(vs + c * BN * ROW_BYTES + kk * 16 * ROW_BYTES));
}

// the online softmax of a score tile on its fragments: scale, mask (EDGE:
// the tile reaches above the diagonal or past Tk), the running max m, p =
// exp(x - m) in place of the scores, l, and each row's rescale corr =
// exp(m_prev - m).  sc[4 j + 2 r + c] is row qr + 8 r, key k0 + 8 j + 2 t4
// + c; a row's values lie in one quad of lanes.  Maxima and sums run in
// four chains a row, for the latency.  Without a mask and with scale > 0
// the max is taken over the raw scores and scaled once, which is the same
// number (rounding is monotone), and the scale rides in the exponent's
// FFMA
template <bool CAUSAL, bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int qr, int t4, int Tk,
                                             float scale) {
  // key 8 j + c of this thread's columns is masked for row r past
  // vis[r], and does not exist past tk
  const int tk = Tk - k0 - 2 * t4 - 1;
  const int vis[2] = {CAUSAL ? min(qr - k0 - 2 * t4, tk) : tk,
                      CAUSAL ? min(qr + 8 - k0 - 2 * t4, tk) : tk};
  float a[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[r][q] = EDGE ? m[r] : -INFINITY;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int j = i >> 2, r = (i >> 1) & 1, c = i & 1;
    float x = sc[i];
    if (EDGE) {
      x *= scale;
      if (8 * j + c > vis[r]) x = NEG_INF;
      sc[i] = x;
    }
    a[r][j & 3] = fmaxf(a[r][j & 3], x);
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mb[r] = fmaxf(fmaxf(a[r][0], a[r][1]), fmaxf(a[r][2], a[r][3]));
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mb[r] = fmaxf(mb[r], __shfl_xor_sync(0xffffffffu, mb[r], off));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!EDGE) mb[r] = fmaxf(m[r], mb[r] * scale);
    corr[r] = ex2((m[r] - mb[r]) * LOG2E);
    m[r] = mb[r];
    mb[r] *= LOG2E;
#pragma unroll
    for (int q = 0; q < 4; ++q) a[r][q] = 0.f;
  }
  const float sl = EDGE ? LOG2E : scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int j = i >> 2, r = (i >> 1) & 1, c = i & 1;
    float p = ex2(fmaf(sc[i], sl, -mb[r]));
    // a key past Tk does not exist: it adds nothing, whatever m is
    if (EDGE && 8 * j + c > tk) p = 0.f;
    sc[i] = p;
    a[r][j & 3] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float rs = (a[r][0] + a[r][1]) + (a[r][2] + a[r][3]);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[r] = l[r] * corr[r] + rs;
  }
}

// the softmax of tile k0, masked only where the tile reaches above the
// diagonal of the warpgroup's first row or past Tk (or, rarely, where the
// scale is not positive)
template <bool CAUSAL>
__device__ __forceinline__ void softmax(float (&sc)[64], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        int k0, int row0, int qr, int t4,
                                        int Tk, float scale) {
  if ((CAUSAL && k0 + BN - 1 > row0) || k0 + BN > Tk || !(scale > 0.f))
    softmax_tile<CAUSAL, true>(sc, m, l, corr, k0, qr, t4, Tk, scale);
  else
    softmax_tile<CAUSAL, false>(sc, m, l, corr, k0, qr, t4, Tk, scale);
}

// P as bf16 pairs in wgmma's register A layout: for keys 16 kk .. + 15,
// (row g, keys 2 t4, + 1), (row g + 8, the same), (row g, + 8), (row g +
// 8, + 8), which is the accumulator's own order, so the rounding (the
// Pallas kernel's p.astype(v.dtype)) happens in place
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

#ifdef PTT_PHASE_CLOCKS
// A measurement build (the flash_attention_bf16_phases library, which no
// path launches; chip_smoke.py's timing phase reads it): each consumer
// warp sums the clocks (clock64) its loop spends in each phase and counts
// its loop steps and work items, and lane 0 adds them to the warp's own
// row of g_phase at its end.  The arithmetic is the plain build's.
enum { PH_Q, PH_TILE0, PH_FULL, PH_PRODUCTS, PH_WAIT_S, PH_SOFTMAX, PH_WAIT_PV,
       PH_RESCALE, PH_LAST_PV, PH_EPILOGUE, PH_STEPS, PH_ITEMS, PH_N };
constexpr int PH_BLOCKS = 264;           // blocks of a grid (<= the SMs)
__device__ unsigned long long g_phase[PH_BLOCKS * CONSUMERS * 4][PH_N];
#define PHASE_START              \
  long long ph_t = clock64();    \
  unsigned long long ph[PH_N] = {}
#define PHASE(i)                         \
  do {                                   \
    const long long ph_c = clock64();    \
    ph[i] += ph_c - ph_t;                \
    ph_t = ph_c;                         \
  } while (0)
#define PHASE_COUNT(i) (++ph[i])
#define PHASE_STORE(row)                           \
  do {                                             \
    if (lane == 0 && blockIdx.x < PH_BLOCKS)       \
      for (int ph_i = 0; ph_i < PH_N; ++ph_i)      \
        g_phase[row][ph_i] += ph[ph_i];            \
  } while (0)
#else
#define PHASE_START
#define PHASE(i)
#define PHASE_COUNT(i)
#define PHASE_STORE(row)
#endif

// a work item: 128 query rows of one (b, h), and its first row and key
// tiles
struct Item {
  int bh, q0, ntiles;
};

// The k-th work item of this block, or bh = -1 past the last.  Items are
// the (b * h, query tile) pairs, the heaviest causal tiles first; of each
// round of G items block b takes the b-th, from the front in even rounds
// and from the back in odd ones, so that the blocks' sums of key tiles
// come out even
template <bool CAUSAL>
__device__ __forceinline__ Item item_of(int k, int BH, int nq, int Tk) {
  const int G = gridDim.x, b = blockIdx.x;
  const int idx = k * G + ((k & 1) ? G - 1 - b : b);
  if (idx >= BH * nq) return Item{-1, 0, 0};
  const int rank = idx / BH;
  const int q0 = (CAUSAL ? nq - 1 - rank : rank) * BM;
  // with 128-row items and 128-key tiles no tile loaded lies wholly above
  // a warpgroup's rows: the last starts at q0 at most
  const int kend = CAUSAL ? min(Tk, q0 + BM) : Tk;
  return Item{idx - rank * BH, q0, (kend + BN - 1) / BN};
}

// DP: D padded to 64 or 128.  tma: the producer loads by TMA (else by the
// per-thread copy); o_pairs: O takes 4-byte stores (D even, O 4-byte
// aligned).  M and L are written when Mout is not null.  A persistent
// grid: each block walks its work items, and the producer loads the next
// item's Q and first tiles while the consumers finish the last.
template <bool CAUSAL, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const bf16* __restrict__ Q, const bf16* __restrict__ K,
                      const bf16* __restrict__ V, bf16* __restrict__ O,
                      float* __restrict__ Mout, float* __restrict__ Lout,
                      int BH, int T, int Tk, int D, float scale, int tma,
                      int o_pairs) {
  using L = Smem<DP>;
  constexpr int NC = DP / CHUNK, STAGES = L::STAGES, QBUFS = L::QBUFS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full0 = base + L::BARS, q_empty0 = q_full0 + 8 * QBUFS;
  const uint32_t full0 = q_empty0 + 8 * QBUFS, empty0 = full0 + 8 * STAGES;
  const int nq = (T + BM - 1) / BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int b = 0; b < QBUFS; ++b) {
      mbar_init(q_full0 + 8 * b, 1);
      mbar_init(q_empty0 + 8 * b, CONSUMERS * 4);   // each consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // by TMA one lane issues everything; the per-thread copy takes them all
    if (warp != PRODUCER_WARP || (tma && lane != 0)) return;
    int gt = 0;   // key tiles this block has loaded
    for (int k = 0;; ++k) {
      const Item it = item_of<CAUSAL>(k, BH, nq, Tk);
      if (it.bh < 0) break;
      const int qb = k % QBUFS;
      const uint32_t qs = base + qb * L::Q_BYTES, qbar = q_full0 + 8 * qb;
      if (k >= QBUFS) mbar_wait(q_empty0 + 8 * qb, (k / QBUFS - 1) & 1);
      if (tma) {
        mbar_expect_tx(qbar, L::Q_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(qs + c * BM * ROW_BYTES, &tq, c * CHUNK, it.q0, it.bh,
                      qbar);
      } else {
        copy_box(qs, Q + static_cast<long long>(it.bh) * T * D, D, it.q0, T,
                 BM, 0, D, NC, lane, 32);
        publish(qbar, lane);
      }
      for (int t = 0; t < it.ntiles; ++t, ++gt) {
        const int s = gt % STAGES;
        if (gt >= STAGES) mbar_wait(empty0 + 8 * s, (gt / STAGES - 1) & 1);
        const uint32_t ks = base + L::KV + s * L::STAGE_BYTES;
        const uint32_t bar = full0 + 8 * s;
        if (tma) {
          mbar_expect_tx(bar, L::STAGE_BYTES);
          for (int c = 0; c < NC; ++c) {
            tma_load_3d(ks + c * BN * ROW_BYTES, &tk, c * CHUNK, t * BN,
                        it.bh, bar);
            tma_load_3d(ks + L::KV_BYTES + c * BN * ROW_BYTES, &tv,
                        c * CHUNK, t * BN, it.bh, bar);
          }
        } else {
          const long long off = static_cast<long long>(it.bh) * Tk * D;
          copy_box(ks, K + off, D, t * BN, Tk, BN, 0, D, NC, lane, 32);
          copy_box(ks + L::KV_BYTES, V + off, D, t * BN, Tk, BN, 0, D, NC,
                   lane, 32);
          publish(bar, lane);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    PHASE_START;
    // a consumer warpgroup: rows row0 .. row0 + 63 of each item; this
    // thread's rows are qr = row0 + 16 ww + g and qr + 8, its columns of
    // every 8 are 2 t4 and 2 t4 + 1.  Rows past T hold zeros and are
    // computed, not stored
    const int wg = warp >> 2, ww = warp & 3, g = lane >> 2, t4 = lane & 3;
    auto stage = [&](int gt) {
      return base + L::KV + (gt % STAGES) * L::STAGE_BYTES;
    };
    auto wait_tile = [&](int gt) {
      mbar_wait(full0 + 8 * (gt % STAGES), (gt / STAGES) & 1);
    };
    // this warp is done with a Q tile or a stage
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float m[2], l[2], corr[2], o[NC][32], sc[64];
    uint32_t pa[BN / 16][4];
    int gt = 0;   // key tiles this block has consumed
    for (int k = 0;; ++k) {
      const Item it = item_of<CAUSAL>(k, BH, nq, Tk);
      if (it.bh < 0) break;
      const int qb = k % QBUFS;
      const int row0 = it.q0 + wg * WG_ROWS, qr = row0 + 16 * ww + g;
      const uint32_t qs = base + qb * L::Q_BYTES + wg * WG_ROWS * ROW_BYTES;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
      mbar_wait(q_full0 + 8 * qb, (k / QBUFS) & 1);
      PHASE(PH_Q);

      // tile 0's scores alone; then each step issues tile t's S and tile
      // t - 1's P . V together, and tile t's softmax runs while P . V does
      wait_tile(gt);
      wgmma_fence();
      issue_s<DP>(sc, qs, stage(gt));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax<CAUSAL>(sc, m, l, corr, 0, row0, qr, t4, Tk, scale);
      pack_p(pa, sc);
      PHASE(PH_TILE0);
      for (int t = 1; t < it.ntiles; ++t) {
        wait_tile(gt + t);
        PHASE(PH_FULL);
        wgmma_fence();
        issue_s<DP>(sc, qs, stage(gt + t));
        wgmma_commit();
        issue_pv<NC>(o, pa, stage(gt + t - 1) + L::KV_BYTES);
        wgmma_commit();
        PHASE(PH_PRODUCTS);
        wgmma_wait<1>();
        PHASE(PH_WAIT_S);
        fence_regs(sc);
        softmax<CAUSAL>(sc, m, l, corr, t * BN, row0, qr, t4, Tk, scale);
        PHASE(PH_SOFTMAX);
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(o[c]);
        fence_regs(pa);
        PHASE(PH_WAIT_PV);
        release(empty0 + 8 * ((gt + t - 1) % STAGES));
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
        pack_p(pa, sc);
        PHASE(PH_RESCALE);
        PHASE_COUNT(PH_STEPS);
      }
      wgmma_fence();
      issue_pv<NC>(o, pa, stage(gt + it.ntiles - 1) + L::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      fence_regs(pa);
      gt += it.ntiles;
      release(empty0 + 8 * ((gt - 1) % STAGES));
      release(q_empty0 + 8 * qb);
      PHASE(PH_LAST_PV);

      const long long bhT = static_cast<long long>(it.bh) * T;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qr + 8 * r;
        if (row >= T) continue;
        const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
        bf16* orow = O + (bhT + row) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * CHUNK + 8 * j + 2 * t4;
            if (col >= D) continue;
            // one rounding, to nearest even
            const float v0 = o[c][4 * j + 2 * r] * inv;
            const float v1 = o[c][4 * j + 2 * r + 1] * inv;
            if (o_pairs) {
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              orow[col] = __float2bfloat16_rn(v0);
              if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(v1);
            }
          }
        if (Mout != nullptr && t4 == 0) {
          Mout[bhT + row] = m[r];
          Lout[bhT + row] = l[r];
        }
      }
      PHASE(PH_EPILOGUE);
      PHASE_COUNT(PH_ITEMS);
    }
    PHASE_STORE(blockIdx.x * CONSUMERS * 4 + warp);
  }
}

template <bool CAUSAL, int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* m,
           float* l, int bh, int T, int Tk, int D, float scale,
           cudaStream_t stream) {
  const auto kernel = flash_fwd_bf16_kernel<CAUSAL, DP>;
  // TMA takes 16-byte aligned bases and row strides of a multiple of 16
  // bytes; other operands take the per-thread copy
  const bool tma = D % 8 == 0 && aligned_to(q, 16) && aligned_to(k, 16) &&
                   aligned_to(v, 16);
  const bool o_pairs = D % 2 == 0 && aligned_to(o, 4);
  // above 48 KB a block's dynamic shared memory must be asked for; first,
  // so that the card's context is current for the tensor maps' encoding
  // (see matmul_bf16.cu)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<DP>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq{}, tk{}, tv{};
  if (tma &&
      ((err = encode_bf16_3d(&tq, q, D, T, bh, 2LL * D, 2LL * D * T, BM)) !=
           cudaSuccess ||
       (err = encode_bf16_3d(&tk, k, D, Tk, bh, 2LL * D, 2LL * D * Tk,
                             BN)) != cudaSuccess ||
       (err = encode_bf16_3d(&tv, v, D, Tk, bh, 2LL * D, 2LL * D * Tk,
                             BN)) != cudaSuccess))
    return static_cast<int>(err);
  // one block an SM, each walking its share of the work items
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return static_cast<int>(err);
  const int items = bh * ((T + BM - 1) / BM);
  kernel<<<min(items, sms), THREADS, Smem<DP>::BYTES, stream>>>(
      tq, tk, tv, q, k, v, o, m, l, bh, T, Tk, D, scale, tma, o_pairs);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* m,
             float* l, int bh, int T, int Tk, int D, int causal, float scale,
             void* stream) {
  if (bh < 1 || bh > 65535 || T < 1 || Tk < 1 || D < 1 || D > D_MAX ||
      static_cast<long long>(bh) * ((T + BM - 1) / BM) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= CHUNK)
    return causal ? launch<true, 64>(q, k, v, o, m, l, bh, T, Tk, D, scale, s)
                  : launch<false, 64>(q, k, v, o, m, l, bh, T, Tk, D, scale,
                                      s);
  return causal ? launch<true, 128>(q, k, v, o, m, l, bh, T, Tk, D, scale, s)
                : launch<false, 128>(q, k, v, o, m, l, bh, T, Tk, D, scale,
                                     s);
}

struct Instance {
  const void* fn;
  const char* name;
  int smem_bytes;
};

const Instance kInstances[] = {
    {reinterpret_cast<const void*>(flash_fwd_bf16_kernel<true, 64>),
     "flash_fwd_bf16_kernel<causal=true,DP=64>", Smem<64>::BYTES},
    {reinterpret_cast<const void*>(flash_fwd_bf16_kernel<false, 64>),
     "flash_fwd_bf16_kernel<causal=false,DP=64>", Smem<64>::BYTES},
    {reinterpret_cast<const void*>(flash_fwd_bf16_kernel<true, 128>),
     "flash_fwd_bf16_kernel<causal=true,DP=128>", Smem<128>::BYTES},
    {reinterpret_cast<const void*>(flash_fwd_bf16_kernel<false, 128>),
     "flash_fwd_bf16_kernel<causal=false,DP=128>", Smem<128>::BYTES}};

}  // namespace

extern "C" {

// O = attention(Q, K, V) for bh (batch x head) slices, row-major bf16:
// Q and O are [bh, T, D], K and V [bh, Tk, D], 1 <= D <= 128,
// bh <= 65535.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched), or the error of building a tensor map.
int ptt_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                       int bh, int T, int Tk, int D, int causal, float scale,
                       void* stream) {
  return dispatch(q, k, v, o, nullptr, nullptr, bh, T, Tk, D, causal, scale,
                  stream);
}

// As ptt_flash_fwd_bf16, also writing each row's raw running max to M and
// denominator to L, both [bh, T] fp32.
int ptt_flash_fwd_stats_bf16(const bf16* q, const bf16* k, const bf16* v,
                             bf16* o, float* m, float* l, int bh, int T,
                             int Tk, int D, int causal, float scale,
                             void* stream) {
  return dispatch(q, k, v, o, m, l, bh, T, Tk, D, causal, scale, stream);
}

// Instance i of the kernel: its name and, in out[0..4], registers a
// thread, local (spill) bytes a thread, static shared bytes, dynamic
// shared bytes, resident blocks an SM.  Returns 0, -1 past the last
// instance, or a cudaError_t.
int ptt_flash_fwd_bf16_attributes(int i, int* out, const char** name) {
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

#ifdef PTT_PHASE_CLOCKS
// The measurement build's sums: shape[0] rows (a consumer warp's each,
// block-major) of shape[1] counts (the clocks of each phase, PH_Q ..
// PH_EPILOGUE, then loop steps and work items).  Copies them to out,
// unless it is null, and zeroes them; returns 0 or a cudaError_t.
int ptt_flash_fwd_bf16_phase_clocks(unsigned long long* out, int* shape) {
  shape[0] = PH_BLOCKS * CONSUMERS * 4;
  shape[1] = PH_N;
  if (out == nullptr) return 0;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[PH_BLOCKS * CONSUMERS * 4][PH_N] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zeros, sizeof(zeros)));
}
#endif

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
