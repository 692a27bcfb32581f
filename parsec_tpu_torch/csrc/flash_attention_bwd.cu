// Flash attention backward for Hopper (sm_90a), fp32.
//
//   O = softmax(scale * Q . K^T, masked) . V        (the forward)
//   dV = P^T dO,  dP = dO . V^T,  dS = P o (dP - delta),
//   dQ = scale * dS . K,  dK = scale * dS^T . Q,  delta = rowsum(dO o O)
//
// with P = exp(scale * Q . K^T - m) / l recomputed from the forward's raw
// row statistics m (running max) and l (denominator), which the STATS
// instance of csrc/flash_attention.cu exports.
//
// Replaces the VJP of the JAX package's Pallas flash attention, `_flash`'s
// custom_vjp backward `_flash_vjp_bwd` (parsec_tpu/ops/pallas_kernels.py),
// which recomputes blockwise in three jnp scans: the row statistics; dV
// and delta = rowsum(P o dP); dQ and dK.  Here the statistics come from
// the forward, and delta is rowsum(dO o O), the same number (O = P V).
// Arithmetic kept: the score is (q . k) * scale; the causal mask is the
// local-index one (row i sees keys 0..i, also when T != Tk), under which
// a masked probability is exactly 0, as exp(-1e30 - m) is; l == 0 -> 1.
//
// What bounds it.  At the transformer's shape ([8, 12, 1024, 64], causal)
// the five products (S and dP recomputed, dV, dK, dQ) do 10 * D flops per
// visible (query, key) pair, 32.2 GFLOP, over 201 MB of Q, K, V, O, dO,
// dQ, dK, dV: the 67 TFLOP/s fp32 rate of an H100 SXM outside the tensor
// cores bounds it (0.48 ms), not its 3.35 TB/s memory (0.06 ms).  All of
// it is fp32 FMA: no TF32, no tensor cores.
//
// What the design does about it.  It is FlashAttention-2's backward
// without atomics, simple before fast.  Blocks run in parallel and in no
// order, so no block adds into another's output: a first pass writes
// delta ([bh, T]); a dK/dV kernel gives each block one (b, h) and one
// tile of 64 keys, which loops over the query tiles that can see it (the
// causal skip) and keeps dK and dV in registers; a dQ kernel gives each
// block one (b, h) and one tile of 64 query rows, which loops over the key
// tiles up to the diagonal and keeps dQ in registers.  S and dP are thus
// computed twice (7 products for the bound's 5), the price of having no
// float atomics: every sum runs in a fixed order, so two launches on the
// same inputs are bit-identical.  256 threads a block as a 16 x 16 grid.
// Shared-memory reads are one limit of an fp32 kernel of this shape, so
// every product reads float4 and each read feeds 4 to 16 FMAs, as in the
// forward: a thread owns rows ty + 16 i (i < 4) and columns
// tx + 16 j of each 64 x 64 score tile, whose two products read Q, K, V
// and dO as float4 along D (rows padded to an odd number of float4, so
// the 8 rows of a quarter warp hit 8 distinct bank groups); and rows
// ty + 16 i and columns 4 tx + 64 g .. + 3 of each 64 x D accumulator,
// whose products read P^T (the dK/dV kernel computes S^T and dP^T
// directly, keys as rows) or dS as float4 along the summed index and
// dO, Q or K as float4 along D.  Every copy from device memory is a
// 4-byte load, coalesced along D, so a misaligned view takes the same
// instance as an aligned one and gives the same bits.  Rows past T and
// keys past Tk, and the columns up to the next multiple of 4 past D,
// are zero-filled, and masked probabilities are 0, so no tile size has
// to divide T, Tk or D.  Heaviest tiles first: key tile 0 sees every
// query tile, the last query tile every key tile.
//
// Measured (nvcc -Xptxas -v, sm_90a, -O3): 96 to 128 registers a thread
// up to D = 64 (two blocks an SM, 105 KB of shared memory each at
// D = 64), 168 to 224 up to D = 128, no spills.  At the transformer's
// shape it takes about 1.9 ms, a quarter of its bound and 1.5 times the
// library's fp32 backward, which adds dQ up with atomics and so does 5
// products for these 7; the first design, with scalar shared-memory
// reads, gave the same bits in 2.06 ms.  PERF.md says what holds it back.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16;            // threads along a tile's columns
constexpr int RI = 4;             // rows per thread: ty + 16 i
constexpr int BQ = TX * RI;       // query rows per tile: 64
constexpr int BK = TX * RI;       // keys per tile: 64
constexpr int SJ = BK / TX;       // score columns per thread: tx + 16 j
constexpr int SP = BK + 4;        // row stride of a score tile: 17 float4
constexpr int D_MAX = 128;

// a row stride holding D rounded up to a float4, and an odd number of
// float4, so that 8 consecutive rows fall in 8 distinct bank groups
__host__ __device__ constexpr int row_stride(int d) {
  return ((d + 3) / 4) % 2 ? (d + 3) / 4 * 4 : (d + 3) / 4 * 4 + 4;
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows r0..r0+ROWS-1 of a [R, D] source into a [ROWS][ds] shared tile,
// columns 0..4*ceil(D/4)-1; rows past R and columns past D are zero
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int R, int D, int ds) {
  const int w = (D + 3) / 4 * 4;
  for (int idx = threadIdx.x; idx < ROWS * w; idx += THREADS) {
    const int r = idx / w, c = idx - r * w;
    dst[r * ds + c] = r0 + r < R && c < D
                          ? src[static_cast<long long>(r0 + r) * D + c]
                          : 0.f;
  }
}

// each row's max, reciprocal denominator and delta for rows q0..q0+BQ-1
__device__ __forceinline__ void load_row_stats(float* Ms, float* Li,
                                               float* Dl, const float* M,
                                               const float* L,
                                               const float* Delta, int q0,
                                               int T) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < T;
    const float l = in ? L[q0 + r] : 1.f;
    Ms[r] = in ? M[q0 + r] : 0.f;
    Li[r] = 1.f / (l == 0.f ? 1.f : l);
    Dl[r] = in ? Delta[q0 + r] : 0.f;
  }
}

// o[i][j] = A[ty + 16 i] . B[tx + 16 j] over the dv float4 of a row,
// d ascending for every entry
template <int DC>
__device__ __forceinline__ void dots(const float* A, const float* B,
                                     int dv_, int ds, int ty, int tx,
                                     float (&o)[RI][SJ]) {
  const int dv = DC ? DC / 4 : dv_;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) o[i][j] = 0.f;
#pragma unroll(DC ? DC / 4 : 2)
  for (int d4 = 0; d4 < dv; ++d4) {
    float4 a[RI], b[SJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = ld4(A + (ty + TX * i) * ds + 4 * d4);
#pragma unroll
    for (int j = 0; j < SJ; ++j) b[j] = ld4(B + (tx + TX * j) * ds + 4 * d4);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j)
          o[i][j] = fmaf(part(a[i], c), part(b[j], c), o[i][j]);
  }
}

// p = exp(s scale - m) / l (0 where masked) and ds = p (dp - delta) for
// the thread's entries; query rows and keys are the thread's rows or its
// columns, as QROWS says
template <bool CAUSAL, bool QROWS>
__device__ __forceinline__ void probabilities(
    float (&s)[RI][SJ], float (&dp)[RI][SJ], const float* Ms,
    const float* Li, const float* Dl, int q0, int k0, int T, int Tk,
    float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int r = QROWS ? ty + TX * i : tx + TX * j;    // query, local
      const int kj = k0 + (QROWS ? tx + TX * j : ty + TX * i);
      const int qi = q0 + r;
      const bool in = qi < T && kj < Tk && (!CAUSAL || kj <= qi);
      const float p = in ? expf(s[i][j] * scale - Ms[r]) * Li[r] : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - Dl[r]);
    }
}

// delta[row] = sum_d dO[row, d] O[row, d], one warp a row
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const float* __restrict__ O,
                       const float* __restrict__ dO,
                       float* __restrict__ Delta, long long rows, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(dO[row * D + c], O[row * D + c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) Delta[row] = acc;
}

// one block per (bh, key tile): dV = P^T dO and dK = scale dS^T Q over the
// query tiles that see the key tile.  NG float4 output columns a thread (1
// up to D = 64, 2 up to 128); DC = D fixed at compile time, or 0.
template <bool CAUSAL, int NG, int DC>
__global__ void __launch_bounds__(THREADS, NG == 1 ? 2 : 1)
flash_bwd_dkdv_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                      const float* __restrict__ V,
                      const float* __restrict__ dO,
                      const float* __restrict__ M, const float* __restrict__ L,
                      const float* __restrict__ Delta, float* __restrict__ dK,
                      float* __restrict__ dV, int T, int Tk, int D_,
                      float scale) {
  const int D = DC ? DC : D_;
  const int ds = row_stride(D);
  const int dv4 = (D + 3) / 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BK][ds]
  float* Vs = Ks + BK * ds;                      // [BK][ds]
  float* Qs = Vs + BK * ds;                      // [BQ][ds]
  float* dOs = Qs + BQ * ds;                     // [BQ][ds]
  float* Pt = dOs + BQ * ds;                     // P^T [BK][SP]
  float* dSt = Pt + BK * SP;                     // dS^T [BK][SP]
  float* Ms = dSt + BK * SP;                     // [BQ]
  float* Li = Ms + BQ;                           // [BQ]
  float* Dl = Li + BQ;                           // [BQ]

  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;   // key tile 0, the heaviest, first
  Q += bh * T * D;
  dO += bh * T * D;
  K += bh * Tk * D;
  V += bh * Tk * D;
  dK += bh * Tk * D;
  dV += bh * Tk * D;
  M += bh * T;
  L += bh * T;
  Delta += bh * T;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  load_rows<BK>(Ks, K, k0, Tk, D, ds);
  load_rows<BK>(Vs, V, k0, Tk, D, ds);

  float dk[RI][4 * NG], dv[RI][4 * NG];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) dk[i][j] = dv[i][j] = 0.f;

  // row i sees key j only when j <= i: the first query tile that sees
  // this key tile holds row k0
  const int nq = (T + BQ - 1) / BQ;
  for (int qt = CAUSAL ? k0 / BQ : 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();   // every thread is done with the last query tile
    load_rows<BQ>(Qs, Q, q0, T, D, ds);
    load_rows<BQ>(dOs, dO, q0, T, D, ds);
    load_row_stats(Ms, Li, Dl, M, L, Delta, q0, T);
    __syncthreads();

    // S^T and dP^T: keys ty + 16 i, queries tx + 16 j
    float s[RI][SJ], dp[RI][SJ];
    dots<DC>(Ks, Qs, dv4, ds, ty, tx, s);
    dots<DC>(Vs, dOs, dv4, ds, ty, tx, dp);
    probabilities<CAUSAL, false>(s, dp, Ms, Li, Dl, q0, k0, T, Tk, scale,
                                 ty, tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        Pt[(ty + TX * i) * SP + tx + TX * j] = s[i][j];
        dSt[(ty + TX * i) * SP + tx + TX * j] = dp[i][j];
      }
    __syncthreads();

    // dV[key][c] += P^T[key][q] dO[q][c], dK[key][c] += dS^T[key][q] Q[q][c]
    // for keys ty + 16 i and columns 4 (tx + 16 g) .. + 3, q ascending;
    // rows past T add nothing (p = ds = 0, zero-filled rows)
    const int qn4 = (min(BQ, T - q0) + 3) / 4;
#pragma unroll 2
    for (int q4 = 0; q4 < qn4; ++q4) {
      float4 pa[RI], sa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pa[i] = ld4(Pt + (ty + TX * i) * SP + 4 * q4);
        sa[i] = ld4(dSt + (ty + TX * i) * SP + 4 * q4);
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
          for (int i = 0; i < RI; ++i) {
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

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int key = k0 + ty + TX * i;
    if (key >= Tk) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (tx + TX * g) + e;
        if (c >= D) continue;
        dK[static_cast<long long>(key) * D + c] = dk[i][4 * g + e] * scale;
        dV[static_cast<long long>(key) * D + c] = dv[i][4 * g + e];
      }
    }
  }
}

// one block per (bh, query tile): dQ = scale dS K over the key tiles up
// to the diagonal
template <bool CAUSAL, int NG, int DC>
__global__ void __launch_bounds__(THREADS, NG == 1 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                    const float* __restrict__ V, const float* __restrict__ dO,
                    const float* __restrict__ M, const float* __restrict__ L,
                    const float* __restrict__ Delta, float* __restrict__ dQ,
                    int T, int Tk, int D_, float scale) {
  const int D = DC ? DC : D_;
  const int ds = row_stride(D);
  const int dv4 = (D + 3) / 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][ds]
  float* dOs = Qs + BQ * ds;                     // [BQ][ds]
  float* Ks = dOs + BQ * ds;                     // [BK][ds]
  float* Vs = Ks + BK * ds;                      // [BK][ds]
  float* dSs = Vs + BK * ds;                     // [BQ][SP]
  float* Ms = dSs + BQ * SP;                     // [BQ]
  float* Li = Ms + BQ;                           // [BQ]
  float* Dl = Li + BQ;                           // [BQ]

  const long long bh = blockIdx.x;
  // the last query tile, which sees every key tile, first
  const int qt = CAUSAL ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * BQ;
  Q += bh * T * D;
  dO += bh * T * D;
  dQ += bh * T * D;
  K += bh * Tk * D;
  V += bh * Tk * D;
  M += bh * T;
  L += bh * T;
  Delta += bh * T;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  load_rows<BQ>(Qs, Q, q0, T, D, ds);
  load_rows<BQ>(dOs, dO, q0, T, D, ds);
  load_row_stats(Ms, Li, Dl, M, L, Delta, q0, T);

  float dq[RI][4 * NG];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) dq[i][j] = 0.f;

  // the tile's last row sees keys up to q0 + BQ - 1
  const int kend = CAUSAL ? min(Tk, min(T, q0 + BQ)) : Tk;
  const int nk = (kend + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every thread is done with the last key tile
    load_rows<BK>(Ks, K, k0, Tk, D, ds);
    load_rows<BK>(Vs, V, k0, Tk, D, ds);
    __syncthreads();

    // S and dP: queries ty + 16 i, keys tx + 16 j
    float s[RI][SJ], dp[RI][SJ];
    dots<DC>(Qs, Ks, dv4, ds, ty, tx, s);
    dots<DC>(dOs, Vs, dv4, ds, ty, tx, dp);
    probabilities<CAUSAL, true>(s, dp, Ms, Li, Dl, q0, k0, T, Tk, scale, ty,
                                tx);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j)
        dSs[(ty + TX * i) * SP + tx + TX * j] = dp[i][j];
    __syncthreads();

    // dQ[q][c] += dS[q][key] K[key][c], keys ascending; keys past Tk
    // have dS = 0 and zero-filled rows
    const int kn4 = (min(BK, Tk - k0) + 3) / 4;
#pragma unroll 2
    for (int k4 = 0; k4 < kn4; ++k4) {
      float4 sa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        sa[i] = ld4(dSs + (ty + TX * i) * SP + 4 * k4);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = 4 * (tx + TX * g);
        if (c >= D) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 kb = ld4(Ks + (4 * k4 + e) * ds + c);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float se = part(sa[i], e);
            dq[i][4 * g] = fmaf(se, kb.x, dq[i][4 * g]);
            dq[i][4 * g + 1] = fmaf(se, kb.y, dq[i][4 * g + 1]);
            dq[i][4 * g + 2] = fmaf(se, kb.z, dq[i][4 * g + 2]);
            dq[i][4 * g + 3] = fmaf(se, kb.w, dq[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + TX * i;
    if (r >= T) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (tx + TX * g) + e;
        if (c < D)
          dQ[static_cast<long long>(r) * D + c] = dq[i][4 * g + e] * scale;
      }
    }
  }
}

// K, V, Q, dO [64][ds], P^T and dS^T [64][SP], the row stats: 105 KB at
// D = 64, so two blocks share an SM
size_t dkdv_smem_bytes(int d) {
  return ((2 * BK + 2 * BQ) * row_stride(d) + 2 * BK * SP + 3 * BQ) *
         sizeof(float);
}

size_t dq_smem_bytes(int d) {
  return ((2 * BQ + 2 * BK) * row_stride(d) + BQ * SP + 3 * BQ) *
         sizeof(float);
}

template <bool CAUSAL, int NG, int DC>
int launch(const float* q, const float* k, const float* v, const float* m,
           const float* l, const float* dout, const float* delta, float* dq,
           float* dk, float* dv, int bh, int T, int Tk, int D, float scale,
           cudaStream_t stream) {
  const auto dkdv = flash_bwd_dkdv_kernel<CAUSAL, NG, DC>;
  const auto dqk = flash_bwd_dq_kernel<CAUSAL, NG, DC>;
  const size_t smem_kv = dkdv_smem_bytes(D), smem_q = dq_smem_bytes(D);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks are issued x (the bh slice) fastest, so the heaviest tiles of
  // every (b, h) go first
  dkdv<<<dim3(bh, (Tk + BK - 1) / BK), THREADS, smem_kv, stream>>>(
      q, k, v, dout, m, l, delta, dk, dv, T, Tk, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(bh, (T + BQ - 1) / BQ), THREADS, smem_q, stream>>>(
      q, k, v, dout, m, l, delta, dq, T, Tk, D, scale);
  return static_cast<int>(cudaGetLastError());
}

// the instance for this D: one float4 of output columns a thread up to
// D = 64, two up to 128; D fixed at compile time when it is 64
template <bool CAUSAL>
int dispatch(const float* q, const float* k, const float* v, const float* m,
             const float* l, const float* dout, const float* delta,
             float* dq, float* dk, float* dv, int bh, int T, int Tk, int D,
             float scale, cudaStream_t s) {
  if (D == 64)
    return launch<CAUSAL, 1, 64>(q, k, v, m, l, dout, delta, dq, dk, dv, bh,
                                 T, Tk, D, scale, s);
  if (D <= 4 * TX)
    return launch<CAUSAL, 1, 0>(q, k, v, m, l, dout, delta, dq, dk, dv, bh,
                                T, Tk, D, scale, s);
  return launch<CAUSAL, 2, 0>(q, k, v, m, l, dout, delta, dq, dk, dv, bh, T,
                              Tk, D, scale, s);
}

}  // namespace

extern "C" {

// dQ, dK, dV of O = attention(Q, K, V) for bh (batch x head) slices,
// row-major fp32: Q, O, dO and dQ are [bh, T, D], K, V, dK and dV
// [bh, Tk, D], M and L the forward's raw row max and denominator
// [bh, T], Delta a [bh, T] scratch; 1 <= D <= 128, bh <= 65535.  Three
// launches on `stream` (delta, dK/dV, dQ); returns the first
// cudaGetLastError() that is not 0, else 0.
int ptt_flash_bwd_f32(const float* q, const float* k, const float* v,
                      const float* o, const float* m, const float* l,
                      const float* dout, float* dq, float* dk, float* dv,
                      float* delta, int bh, int T, int Tk, int D, int causal,
                      float scale, void* stream) {
  if (bh < 1 || bh > 65535 || T < 1 || Tk < 1 || D < 1 || D > D_MAX ||
      (T + BQ - 1) / BQ > 65535 || (Tk + BK - 1) / BK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(bh) * T;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  flash_bwd_delta_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      o, dout, delta, rows, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return causal ? dispatch<true>(q, k, v, m, l, dout, delta, dq, dk, dv, bh,
                                 T, Tk, D, scale, s)
                : dispatch<false>(q, k, v, m, l, dout, delta, dq, dk, dv, bh,
                                  T, Tk, D, scale, s);
}

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
