// Flash attention backward for Hopper (sm_90a) at head widths up to 256,
// fp32 or bf16 operands.
//
//   O = softmax(scale * Q . K^T, masked) . V        (the forward)
//   dV = P^T dO,  dP = dO . V^T,  dS = P o (dP - delta) * scale,
//   dQ = dS . K,  dK = dS^T . Q,  delta = rowsum(dO o O)
//
// with P = exp(scale * Q . K^T - m) / l recomputed from the forward's raw
// row statistics m (running max) and l (denominator), which the forward
// of flash_attention_wide.cu exports.
//
// Replaces, for 128 < D <= 256, the VJP of the JAX package's Pallas flash
// attention, `_flash`'s custom_vjp backward `_flash_vjp_bwd`
// (parsec_tpu/ops/pallas_kernels.py), jnp over any head width.  The tuned
// kernels of flash_attention_bwd.cu (fp32) and flash_attention_bwd_bf16.cu
// (bf16, tensor cores) take D <= 128; the wrapper
// (parsec_tpu_torch/ops/kernels.py) sends wider heads here.  Entry points
// ptt_flash_bwd_wide_f32 and ptt_flash_bwd_wide_bf16.
//
// Arithmetic kept from the JAX VJP: the score is (q . k) * scale; the
// causal mask is the local-index one (row i sees keys 0..i, also when
// T != Tk), under which a masked probability is exactly 0, as
// exp(-1e30 - m) is; p = exp(s - m) / l with l == 0 -> 1; P, dP and dS
// stay fp32 (ds = p (dp - delta) scale), and dq, dk and dv are summed in
// fp32 and each rounded once to the element type.  At bf16 that is closer
// to the VJP than the tensor-core kernel of flash_attention_bwd_bf16.cu,
// which rounds P and dS to bf16 for its products.  delta is
// rowsum(dO o O), the VJP's rowsum(P o dP) in exact arithmetic (at bf16
// it carries o's rounding).
//
// What bounds it.  At the path's shape ([1, 8, 8192, 256], causal) the
// five products of the VJP (S and dP recomputed, dV, dK, dQ) do 10 D
// flops for each visible (query, key) pair, 688 GFLOP, over Q, K, V, O,
// dO, dQ, dK and dV (537 MB at fp32): the 67 TFLOP/s fp32 rate of an H100
// SXM outside the tensor cores bounds it (10.3 ms).  At bf16 the card's
// bound is the tensor cores' (0.70 ms), which this CUDA-core kernel does
// not use (later work, ROADMAP Queue 2(b)).
//
// What the design does about it.  This is the first design, simple and
// deterministic: three launches, no float atomics, no turn counters.
// - delta: one warp a row.
// - dK and dV: one block a (b*h, 32-key tile), which walks the query
//   tiles that see its keys (64 rows each, ascending), recomputing S^T and
//   dP^T for the pair, and adds P^T dO and dS^T Q into registers kept
//   across the walk: 256 threads as a 16 x 16 grid, a thread 2 keys x 4
//   queries of each score tile (keys ty + 16 i, queries tx + 16 j) and
//   2 keys x 16 columns of dK and of dV (columns 4 (tx + 16 g) .. + 3).
// - dQ: one block a (b*h, 64-row query tile), which walks the key tiles
//   its rows see (32 keys each, ascending), recomputes S and dP, and adds
//   dS K into registers: a thread 4 rows x 2 keys of each score tile
//   (rows ty + 16 i, keys tx + 16 j) and 4 rows x 16 columns of dQ (rows
//   4 ty .. + 3).  So dQ is summed in key-tile order, the same in every
//   run, and each block stores its own rows once.
// Recomputing S and dP in both walks makes seven products of the five
// (1.4 times the work); the persistent one-pass kernel of
// flash_attention_bwd.cu needs its dK and dV in registers for 64 keys,
// which at D = 256 would spill.  Q, dO, K and V tiles at D = 256 take
// 200 KB of shared memory, one stage each: the dQ walk copies V of the
// next key tile while the pair's softmax and dS K run; the dK/dV walk
// waits for each query tile's copy.  At bf16 the copies are plain loads,
// widened to fp32 as they are stored.  Rows past T, keys past Tk and the
// columns up to the next multiple of 4 past D are zero-filled, and masked
// probabilities are 0, so no tile size has to divide T, Tk or D.
//
// Measured: chip_smoke.py's `[ptxas]` and `[timing] instance=` lines
// (cudaFuncGetAttributes through ptt_flash_bwd_wide_attributes); its time
// at the path's shape is the timing phase's, PERF.md keeps them.
#include "flash_wide.cuh"

namespace {

using namespace ptt_wide;

constexpr int TX = 16;               // threads along a score tile's width
constexpr int TY = THREADS / TX;     // threads along its height: 16
constexpr int NG = D_MAX / (4 * TX); // float4 output columns a thread: 4
// the dK/dV walk: a block's keys, a query tile's rows
constexpr int KV_BK = 32;
constexpr int KV_BQ = 64;
constexpr int KV_KI = KV_BK / TY;    // keys a thread: ty + 16 i
constexpr int KV_QJ = KV_BQ / TX;    // queries a thread: tx + 16 j
constexpr int KV_SP = KV_BQ + 16;    // row stride of P^T and dS^T
// the dQ walk: a block's rows, a key tile's keys
constexpr int Q_BQ = 64;
constexpr int Q_BK = 32;
constexpr int Q_QI = Q_BQ / TY;      // rows a thread in S: ty + 16 i
constexpr int Q_KJ = Q_BK / TX;      // keys a thread in S: tx + 16 j
constexpr int Q_DR = Q_BQ / TY;      // dQ rows a thread: 4 ty .. + 3
constexpr int Q_SK = Q_BK + 16;      // row stride of dS
static_assert(Q_DR == 4, "dQ's product reads a row's dS as float4");

// K, V [KV_BK][ds]; Q, dO [KV_BQ][ds]; P^T, dS^T [KV_BK][KV_SP]; m, l,
// delta [3][KV_BQ]: 220928 bytes at D = 256
size_t kv_smem_bytes(int d) {
  return (static_cast<size_t>(2 * KV_BK + 2 * KV_BQ) * row_stride(d) +
          2 * KV_BK * KV_SP + 3 * KV_BQ) * sizeof(float);
}

// Q, dO [Q_BQ][ds]; K, V [Q_BK][ds]; dS [Q_BQ][Q_SK]; m, l, delta
// [3][Q_BQ]: 212736 bytes at D = 256
size_t q_smem_bytes(int d) {
  return (static_cast<size_t>(2 * Q_BQ + 2 * Q_BK) * row_stride(d) +
          Q_BQ * Q_SK + 3 * Q_BQ) * sizeof(float);
}

// delta[row] = sum_d dO[row, d] O[row, d] in fp32, one warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_wide_delta_kernel(const T* __restrict__ O, const T* __restrict__ dO,
                            float* __restrict__ Delta, long long rows,
                            int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(widen(dO[row * D + c]), widen(O[row * D + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) Delta[row] = acc;
}

// the probability of a (query, key) pair and its dS, from the pair's score
// dot, its dP, and the row's m, l and delta; 0 and 0 when the pair is
// masked or past T or Tk
__device__ __forceinline__ void prob(float dot, float dp, float mr, float lr,
                                     float dl, bool in, float scale,
                                     float& p, float& ds) {
  p = in ? expf(dot * scale - mr) / (lr == 0.f ? 1.f : lr) : 0.f;
  ds = p * (dp - dl) * scale;
}

// dK and dV of one (b*h, KV_BK-key tile) a block
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wide_dkdv_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                           const T* __restrict__ V, const T* __restrict__ dO,
                           const float* __restrict__ M,
                           const float* __restrict__ L,
                           const float* __restrict__ Delta,
                           T* __restrict__ dK, T* __restrict__ dV, int Tq,
                           int Tk, int D, float scale, int aligned_in,
                           int aligned_out) {
  const int ds = row_stride(D);
  const int dv4 = (D + 3) / 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [KV_BK][ds]
  float* Vs = Ks + KV_BK * ds;                   // [KV_BK][ds]
  float* Qs = Vs + KV_BK * ds;                   // [KV_BQ][ds]
  float* dOs = Qs + KV_BQ * ds;                  // [KV_BQ][ds]
  float* Pt = dOs + KV_BQ * ds;                  // P^T [KV_BK][KV_SP]
  float* dSt = Pt + KV_BK * KV_SP;               // dS^T [KV_BK][KV_SP]
  float* St = dSt + KV_BK * KV_SP;               // m, l, delta [3][KV_BQ]

  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * KV_BK;   // key tile 0, the heaviest, first
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const bool al = aligned_in != 0;
  Q += bh * Tq * D;
  dO += bh * Tq * D;
  K += bh * Tk * D;
  V += bh * Tk * D;
  M += bh * Tq;
  L += bh * Tq;
  Delta += bh * Tq;

  load_rows<KV_BK>(Ks, K, k0, Tk, D, ds, al);
  load_rows<KV_BK>(Vs, V, k0, Tk, D, ds, al);
  cp_async_commit();

  float dk[KV_KI][4 * NG], dv[KV_KI][4 * NG];
#pragma unroll
  for (int i = 0; i < KV_KI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) dk[i][j] = dv[i][j] = 0.f;

  // row i sees key j only when j <= i: the first query tile that sees
  // this key tile holds row k0
  const int nq = (Tq + KV_BQ - 1) / KV_BQ;
  for (int qt = CAUSAL ? k0 / KV_BQ : 0; qt < nq; ++qt) {
    const int q0 = qt * KV_BQ;
    __syncthreads();   // every thread is done with the last query tile
    load_rows<KV_BQ>(Qs, Q, q0, Tq, D, ds, al);
    load_rows<KV_BQ>(dOs, dO, q0, Tq, D, ds, al);
    load_vec(St, M, q0, KV_BQ, Tq);
    load_vec(St + KV_BQ, L, q0, KV_BQ, Tq);
    load_vec(St + 2 * KV_BQ, Delta, q0, KV_BQ, Tq);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S^T and dP^T: keys ty + 16 i, queries tx + 16 j, d ascending
    {
      float s[KV_KI][KV_QJ], dp[KV_KI][KV_QJ];
#pragma unroll
      for (int i = 0; i < KV_KI; ++i)
#pragma unroll
        for (int j = 0; j < KV_QJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d4 = 0; d4 < dv4; ++d4) {
        float4 ka[KV_KI], va[KV_KI], qb[KV_QJ], ob[KV_QJ];
#pragma unroll
        for (int i = 0; i < KV_KI; ++i) {
          ka[i] = ld4(Ks + (ty + TY * i) * ds + 4 * d4);
          va[i] = ld4(Vs + (ty + TY * i) * ds + 4 * d4);
        }
#pragma unroll
        for (int j = 0; j < KV_QJ; ++j) {
          qb[j] = ld4(Qs + (tx + TX * j) * ds + 4 * d4);
          ob[j] = ld4(dOs + (tx + TX * j) * ds + 4 * d4);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < KV_KI; ++i)
#pragma unroll
            for (int j = 0; j < KV_QJ; ++j) {
              s[i][j] = fmaf(part(ka[i], c), part(qb[j], c), s[i][j]);
              dp[i][j] = fmaf(part(va[i], c), part(ob[j], c), dp[i][j]);
            }
      }
#pragma unroll
      for (int j = 0; j < KV_QJ; ++j) {
        const int r = tx + TX * j;
        const int qi = q0 + r;
#pragma unroll
        for (int i = 0; i < KV_KI; ++i) {
          const int kj = k0 + ty + TY * i;
          const bool in = qi < Tq && kj < Tk && (!CAUSAL || kj <= qi);
          float p, dsv;
          prob(s[i][j], dp[i][j], St[r], St[KV_BQ + r], St[2 * KV_BQ + r],
               in, scale, p, dsv);
          Pt[(ty + TY * i) * KV_SP + r] = p;
          dSt[(ty + TY * i) * KV_SP + r] = dsv;
        }
      }
    }
    __syncthreads();

    // dV[key][c] += P^T[key][q] dO[q][c], dK[key][c] += dS^T[key][q] Q[q][c]
    // for keys ty + 16 i and columns 4 (tx + 16 g) .. + 3, q ascending;
    // rows past T add nothing (p = ds = 0, zero-filled rows)
    const int qn4 = (min(KV_BQ, Tq - q0) + 3) / 4;
#pragma unroll 2
    for (int q4 = 0; q4 < qn4; ++q4) {
      float4 pa[KV_KI], sa[KV_KI];
#pragma unroll
      for (int i = 0; i < KV_KI; ++i) {
        pa[i] = ld4(Pt + (ty + TY * i) * KV_SP + 4 * q4);
        sa[i] = ld4(dSt + (ty + TY * i) * KV_SP + 4 * q4);
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = 4 * (tx + TX * g);
        if (c >= D) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 ob = ld4(dOs + (4 * q4 + e) * ds + c);
          const float4 qb = ld4(Qs + (4 * q4 + e) * ds + c);
#pragma unroll
          for (int i = 0; i < KV_KI; ++i) {
            const float pe = part(pa[i], e), se = part(sa[i], e);
            dv[i][4 * g] = fmaf(pe, ob.x, dv[i][4 * g]);
            dv[i][4 * g + 1] = fmaf(pe, ob.y, dv[i][4 * g + 1]);
            dv[i][4 * g + 2] = fmaf(pe, ob.z, dv[i][4 * g + 2]);
            dv[i][4 * g + 3] = fmaf(pe, ob.w, dv[i][4 * g + 3]);
            dk[i][4 * g] = fmaf(se, qb.x, dk[i][4 * g]);
            dk[i][4 * g + 1] = fmaf(se, qb.y, dk[i][4 * g + 1]);
            dk[i][4 * g + 2] = fmaf(se, qb.z, dk[i][4 * g + 2]);
            dk[i][4 * g + 3] = fmaf(se, qb.w, dk[i][4 * g + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();   // K and V landed, also when no query tile came

  // dK and dV of the tile's keys (zero when no query sees them)
#pragma unroll
  for (int i = 0; i < KV_KI; ++i) {
    const int key = k0 + ty + TY * i;
    if (key >= Tk) continue;
    T* dkr = dK + (bh * Tk + key) * D;
    T* dvr = dV + (bh * Tk + key) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 4 * (tx + TX * g);
      if (c >= D) continue;
      store4(dkr, c, D,
             make_float4(dk[i][4 * g], dk[i][4 * g + 1], dk[i][4 * g + 2],
                         dk[i][4 * g + 3]),
             aligned_out != 0);
      store4(dvr, c, D,
             make_float4(dv[i][4 * g], dv[i][4 * g + 1], dv[i][4 * g + 2],
                         dv[i][4 * g + 3]),
             aligned_out != 0);
    }
  }
}

// dQ of one (b*h, Q_BQ-row query tile) a block
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_wide_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                         const T* __restrict__ V, const T* __restrict__ dO,
                         const float* __restrict__ M,
                         const float* __restrict__ L,
                         const float* __restrict__ Delta, T* __restrict__ dQ,
                         int Tq, int Tk, int D, float scale, int aligned_in,
                         int aligned_out) {
  const int ds = row_stride(D);
  const int dv4 = (D + 3) / 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [Q_BQ][ds]
  float* dOs = Qs + Q_BQ * ds;                   // [Q_BQ][ds]
  float* Ks = dOs + Q_BQ * ds;                   // [Q_BK][ds]
  float* Vs = Ks + Q_BK * ds;                    // [Q_BK][ds]
  float* dSs = Vs + Q_BK * ds;                   // dS [Q_BQ][Q_SK]
  float* St = dSs + Q_BQ * Q_SK;                 // m, l, delta [3][Q_BQ]

  const long long bh = blockIdx.x;
  // heaviest query tiles first: under the causal mask the last sees most
  const int qt = CAUSAL ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * Q_BQ;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const bool al = aligned_in != 0;
  Q += bh * Tq * D;
  dO += bh * Tq * D;
  dQ += bh * Tq * D;
  K += bh * Tk * D;
  V += bh * Tk * D;

  const int rows_end = min(Tq, q0 + Q_BQ);
  const int kend = CAUSAL ? min(Tk, rows_end) : Tk;
  const int nk = (kend + Q_BK - 1) / Q_BK;

  // copy groups in order: Q, dO, m, l, delta; K_0; V_0; then for each key
  // tile t: V_{t+1} (after its scores), K_{t+1} (after its dS K)
  load_rows<Q_BQ>(Qs, Q, q0, Tq, D, ds, al);
  load_rows<Q_BQ>(dOs, dO, q0, Tq, D, ds, al);
  load_vec(St, M + bh * Tq, q0, Q_BQ, Tq);
  load_vec(St + Q_BQ, L + bh * Tq, q0, Q_BQ, Tq);
  load_vec(St + 2 * Q_BQ, Delta + bh * Tq, q0, Q_BQ, Tq);
  load_rows<Q_BK>(Ks, K, 0, Tk, D, ds, al);
  cp_async_commit();
  load_rows<Q_BK>(Vs, V, 0, Tk, D, ds, al);
  cp_async_commit();

  float dq[Q_DR][4 * NG];
#pragma unroll
  for (int i = 0; i < Q_DR; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) dq[i][j] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * Q_BK;
    cp_async_wait<0>();   // K_t and V_t (and the query tile) landed
    __syncthreads();

    // S and dP: rows ty + 16 i, keys tx + 16 j, d ascending; then P and
    // dS = P o (dP - delta) * scale into shared memory
    {
      float s[Q_QI][Q_KJ], dp[Q_QI][Q_KJ];
#pragma unroll
      for (int i = 0; i < Q_QI; ++i)
#pragma unroll
        for (int j = 0; j < Q_KJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d4 = 0; d4 < dv4; ++d4) {
        float4 qa[Q_QI], oa[Q_QI], kb[Q_KJ], vb[Q_KJ];
#pragma unroll
        for (int i = 0; i < Q_QI; ++i) {
          qa[i] = ld4(Qs + (ty + TY * i) * ds + 4 * d4);
          oa[i] = ld4(dOs + (ty + TY * i) * ds + 4 * d4);
        }
#pragma unroll
        for (int j = 0; j < Q_KJ; ++j) {
          kb[j] = ld4(Ks + (tx + TX * j) * ds + 4 * d4);
          vb[j] = ld4(Vs + (tx + TX * j) * ds + 4 * d4);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < Q_QI; ++i)
#pragma unroll
            for (int j = 0; j < Q_KJ; ++j) {
              s[i][j] = fmaf(part(qa[i], c), part(kb[j], c), s[i][j]);
              dp[i][j] = fmaf(part(oa[i], c), part(vb[j], c), dp[i][j]);
            }
      }
      __syncthreads();   // every thread is done with V_t
      if (t + 1 < nk) load_rows<Q_BK>(Vs, V, k0 + Q_BK, Tk, D, ds, al);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < Q_QI; ++i) {
        const int r = ty + TY * i;
        const int qi = q0 + r;
#pragma unroll
        for (int j = 0; j < Q_KJ; ++j) {
          const int kj = k0 + tx + TX * j;
          const bool in = qi < Tq && kj < Tk && (!CAUSAL || kj <= qi);
          float p, dsv;
          prob(s[i][j], dp[i][j], St[r], St[Q_BQ + r], St[2 * Q_BQ + r], in,
               scale, p, dsv);
          dSs[r * Q_SK + tx + TX * j] = dsv;
        }
      }
    }
    __syncthreads();

    // dQ[row][c] += dS[row][key] K[key][c] for rows 4 ty .. + 3 and
    // columns 4 (tx + 16 g) .. + 3, keys ascending; keys past Tk have
    // dS = 0 and zero-filled rows, and under the causal mask keys past
    // the tile's last row add nothing
    const int kn = CAUSAL ? min(min(Q_BK, Tk - k0), q0 + Q_BQ - k0)
                          : min(Q_BK, Tk - k0);
    const int kn4 = (kn + 3) / 4;
#pragma unroll 2
    for (int k4 = 0; k4 < kn4; ++k4) {
      float4 sa[Q_DR];
#pragma unroll
      for (int i = 0; i < Q_DR; ++i)
        sa[i] = ld4(dSs + (Q_DR * ty + i) * Q_SK + 4 * k4);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = 4 * (tx + TX * g);
        if (c >= D) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 kb = ld4(Ks + (4 * k4 + e) * ds + c);
#pragma unroll
          for (int i = 0; i < Q_DR; ++i) {
            const float se = part(sa[i], e);
            dq[i][4 * g] = fmaf(se, kb.x, dq[i][4 * g]);
            dq[i][4 * g + 1] = fmaf(se, kb.y, dq[i][4 * g + 1]);
            dq[i][4 * g + 2] = fmaf(se, kb.z, dq[i][4 * g + 2]);
            dq[i][4 * g + 3] = fmaf(se, kb.w, dq[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();   // every thread is done with K_t and dS
    if (t + 1 < nk) load_rows<Q_BK>(Ks, K, k0 + Q_BK, Tk, D, ds, al);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < Q_DR; ++i) {
    const int r = q0 + Q_DR * ty + i;
    if (r >= Tq) continue;
    T* row = dQ + static_cast<long long>(r) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 4 * (tx + TX * g);
      if (c >= D) continue;
      store4(row, c, D,
             make_float4(dq[i][4 * g], dq[i][4 * g + 1], dq[i][4 * g + 2],
                         dq[i][4 * g + 3]),
             aligned_out != 0);
    }
  }
}

// the operands of one backward
template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const float* m;
  const float* l;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  float* delta;
  int bh, Tq, Tk, D;
  float scale;
};

template <typename T, bool CAUSAL>
int launch(const BwdArgs<T>& a, cudaStream_t s) {
  const bool in = aligned_operand<T>(a.q, a.D) &&
                  aligned_operand<T>(a.k, a.D) &&
                  aligned_operand<T>(a.v, a.D) &&
                  aligned_operand<T>(a.dout, a.D);
  // the float4 stores (fp32): rows of D % 4 == 0 on 16-byte bases
  const bool out = a.D % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(a.dq) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(a.dk) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(a.dv) % 16 == 0;
  const auto kv = flash_bwd_wide_dkdv_kernel<T, CAUSAL>;
  const auto dq = flash_bwd_wide_dq_kernel<T, CAUSAL>;
  const int kv_smem = static_cast<int>(kv_smem_bytes(a.D));
  const int q_smem = static_cast<int>(q_smem_bytes(a.D));
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dq, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kv<<<dim3(a.bh, (a.Tk + KV_BK - 1) / KV_BK), THREADS, kv_smem, s>>>(
      a.q, a.k, a.v, a.dout, a.m, a.l, a.delta, a.dk, a.dv, a.Tq, a.Tk, a.D,
      a.scale, in, out);
  if ((err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  dq<<<dim3(a.bh, (a.Tq + Q_BQ - 1) / Q_BQ), THREADS, q_smem, s>>>(
      a.q, a.k, a.v, a.dout, a.m, a.l, a.delta, a.dq, a.Tq, a.Tk, a.D,
      a.scale, in, out);
  return static_cast<int>(cudaGetLastError());
}

// the delta pass, then the dK/dV and the dQ walks
template <typename T>
int run(const BwdArgs<T>& a, int causal, void* stream) {
  if (a.bh < 1 || a.bh > 65535 || a.Tq < 1 || a.Tk < 1 || a.D < 1 ||
      a.D > D_MAX || (a.Tk + KV_BK - 1) / KV_BK > 65535 ||
      (a.Tq + Q_BQ - 1) / Q_BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(a.bh) * a.Tq;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  flash_bwd_wide_delta_kernel<T>
      <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(a.o, a.dout,
                                                         a.delta, rows, a.D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return causal ? launch<T, true>(a, s) : launch<T, false>(a, s);
}

struct Instance {
  const void* fn;
  const char* name;
  int smem_bytes;   // dynamic shared memory at D = 256
};

#define PTT_WIDE_ENTRY(T, NAME, C)                                          \
  {reinterpret_cast<const void*>(flash_bwd_wide_dkdv_kernel<T, C>),         \
   "flash_bwd_wide_dkdv_kernel<" NAME ",causal=" #C ">",                    \
   static_cast<int>(kv_smem_bytes(D_MAX))},                                 \
      {reinterpret_cast<const void*>(flash_bwd_wide_dq_kernel<T, C>),       \
       "flash_bwd_wide_dq_kernel<" NAME ",causal=" #C ">",                  \
       static_cast<int>(q_smem_bytes(D_MAX))},

const Instance kInstances[] = {
    {reinterpret_cast<const void*>(flash_bwd_wide_delta_kernel<float>),
     "flash_bwd_wide_delta_kernel<float>", 0},
    {reinterpret_cast<const void*>(flash_bwd_wide_delta_kernel<__nv_bfloat16>),
     "flash_bwd_wide_delta_kernel<bf16>", 0},
    PTT_WIDE_ENTRY(float, "float", true)
    PTT_WIDE_ENTRY(float, "float", false)
    PTT_WIDE_ENTRY(__nv_bfloat16, "bf16", true)
    PTT_WIDE_ENTRY(__nv_bfloat16, "bf16", false)};

}  // namespace

extern "C" {

// dQ, dK, dV of O = attention(Q, K, V) for bh (batch x head) slices,
// row-major fp32: Q, O, dO and dQ are [bh, T, D], K, V, dK and dV
// [bh, Tk, D], M and L the forward's raw row max and denominator
// [bh, T], Delta a [bh, T] fp32 scratch; 1 <= D <= 256.  Three launches
// on `stream` (delta, dK and dV, dQ); returns the first cudaGetLastError()
// that is not 0, else 0.
int ptt_flash_bwd_wide_f32(const float* q, const float* k, const float* v,
                           const float* o, const float* m, const float* l,
                           const float* dout, float* dq, float* dk,
                           float* dv, float* delta, int bh, int T, int Tk,
                           int D, int causal, float scale, void* stream) {
  const BwdArgs<float> a{q,  k,  v,  o,  m, l, dout, dq, dk,
                         dv, delta, bh, T, Tk, D, scale};
  return run(a, causal, stream);
}

// As ptt_flash_bwd_wide_f32 with bf16 Q, K, V, O, dO, dQ, dK and dV (M, L
// and Delta fp32).
int ptt_flash_bwd_wide_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, const __nv_bfloat16* o,
                            const float* m, const float* l,
                            const __nv_bfloat16* dout, __nv_bfloat16* dq,
                            __nv_bfloat16* dk, __nv_bfloat16* dv,
                            float* delta, int bh, int T, int Tk, int D,
                            int causal, float scale, void* stream) {
  const BwdArgs<__nv_bfloat16> a{q,  k,  v,  o,  m, l, dout, dq, dk,
                                 dv, delta, bh, T, Tk, D, scale};
  return run(a, causal, stream);
}

// Instance i of the library (0 and 1: the delta passes): its name and, in
// out[0..4], registers a thread, local (spill) bytes a thread, static
// shared bytes, dynamic shared bytes at D = 256, resident blocks an SM at
// that size.  Returns 0, -1 past the last instance, or a cudaError_t.
int ptt_flash_bwd_wide_attributes(int i, int* out, const char** name) {
  if (i < 0 ||
      i >= static_cast<int>(sizeof(kInstances) / sizeof(kInstances[0])))
    return -1;
  const Instance& inst = kInstances[i];
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, inst.fn);
  if (err == cudaSuccess && inst.smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(
        inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        inst.smem_bytes);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, inst.fn, THREADS, inst.smem_bytes);
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
