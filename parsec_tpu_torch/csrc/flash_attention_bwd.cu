// Flash attention backward for Hopper (sm_90a), fp32.
//
//   O = softmax(scale * Q . K^T, masked) . V        (the forward)
//   dV = P^T dO,  dP = dO . V^T,  dS = scale * P o (dP - delta),
//   dQ = dS . K,  dK = dS^T . Q,  delta = rowsum(dO o O)
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
// a masked probability is exactly 0, as exp(-1e30 - m) is; l == 0 -> 1;
// scale multiplies dS, as the JAX VJP's ds does.
//
// This source builds the fp32 library (parsec_tpu_torch/ops/kernels.py):
// ptt_flash_bwd_f32.  The bf16 backward is the tensor-core kernel of
// flash_attention_bwd_bf16.cu.
//
// What bounds it.  At the transformer's shape ([8, 12, 1024, 64], causal)
// the five products (S and dP recomputed, dV, dK, dQ) do 10 * D flops per
// visible (query, key) pair, 32.2 GFLOP, over 201 MB of Q, K, V, O, dO,
// dQ, dK, dV: the 67 TFLOP/s fp32 rate of an H100 SXM outside the tensor
// cores bounds it (0.48 ms), not its 3.35 TB/s memory (0.06 ms).  All of
// it is fp32 FMA: no TF32, no tensor cores.
//
// What the design does about it.  This is the second design.  The first
// (two kernels, dK/dV and dQ, each recomputing S and dP) did 7 products
// for these 5 and took 1.90 ms at that shape.
//
// - Five products.  One block takes one (b*h, key tile) work item and
//   walks the query tiles that see the key tile, computing S^T and dP^T
//   once per visible tile pair.  From them it adds dV += P^T dO and
//   dK += dS^T Q into registers kept across the walk, and forms the
//   pair's dQ contribution dS K, which it adds into dQ in device memory.
// - A deterministic dQ sum, the ordered accumulation of FlashAttention-3's
//   deterministic mode.  Each (b*h, query tile) has an int turn counter
//   in a zeroed scratch that the wrapper allocates.  Key tile j adds its
//   contribution (a load, an add and a store, through L2) only once the
//   counter reads j (an acquire load by one thread, then a barrier), and
//   hands the turn on with j + 1 (a barrier, then one thread's fence and
//   release store).  So dQ is summed in ascending key-tile order, the
//   same in every run, with no float atomics; key tile 0 stores, so dQ
//   needs no zeroing.  The turn is taken before the pair's dQ product, and
//   the sum so far is copied into shared memory by cp.async behind that
//   product; the release waits for the next barrier.  So the block no
//   longer stalls on three L2 round trips in a row (the load, every
//   thread's fence, the release), which in the first version of this
//   design made the add the largest item after the products.
// - Work items and deadlock.  Items are handed out by an atomic counter in
//   key-major order, item = j * (B*H) + bh, to a persistent grid (the
//   blocks the card holds at once).  The tile a block waits on was handed
//   out earlier, to a block that runs, so no block ever waits on one that
//   is not resident, however many items there are.  Every key tile walks
//   its query tiles from the last down, so all key tiles of a (b, h)
//   reach a query tile at the same step of their walks, in the order the
//   turns go, and a waiter rarely waits.  Key-major order also hands out
//   the heaviest items first (under the causal mask key tile 0 sees every
//   query tile, the last one only the last few), so the light ones fill
//   the last wave.  The fallback, partials in scratch summed by a second
//   pass (about 214 MB more traffic here), was not needed.
// - Asynchronous copies.  K and V of the item, then each query tile's Q,
//   dO and its m, l and delta rows, arrive by cp.async.  With D <= 64 the
//   query tiles take a 2-stage ring, tile t + 1 in flight while tile t
//   computes; with D <= 128 one stage fits, and the next tile is issued
//   once dK and dV are done with the current one, behind the dQ product.
//   16-byte copies need D % 4 == 0 and 16-byte aligned operands and
//   outputs; otherwise the same kernel copies with 4-byte cp.async and
//   reads and stores dQ with scalar accesses (ALIGNED = false), with the
//   same arithmetic, so a misaligned view gives the bits of an aligned
//   copy.
// - Larger register tiles.  256 threads as a 16 x 16 grid.  With D <= 64 a
//   key tile is 128 keys, and a thread holds 8 keys x 4 queries of each
//   score tile (keys ty + 16 i, queries tx + 16 j) and 8 keys x 4 columns
//   of dK and of dV, so each of those four products feeds 128 FMAs with
//   12 float4 loads from shared memory (the first design 64 with 8).  The
//   dQ product splits the keys between the block's two halves; a thread
//   holds 8 consecutive query rows (dS^T read as two float4 a key) x 4
//   columns, 32 FMAs for 3 loads, and the second half's sums are added to
//   the first's in shared memory, in that order.  With D <= 128 a key
//   tile is 64 keys: 4 keys a thread, 8 columns, and dQ 4 rows x 8
//   columns a thread.  Q, K, V and dO rows are padded to an odd number of
//   float4, so the 8 rows a quarter warp reads in one 16-byte load fall in
//   8 distinct bank groups; P^T and dS^T rows to BQ + 16 floats, so the
//   two rows a warp writes land 16 banks apart.  A D <= 64 instance takes
//   254 registers a thread and 218 KB of shared memory: one block an SM.
// - The diagonal.  Under the causal mask the upper half of a 128-key tile
//   sees no row of the query tile on its diagonal, so that pair computes
//   the lower half only; its dQ product stops at the tile's last row.
//
// Rows past T, keys past Tk and the columns up to the next multiple of 4
// past D are zero-filled, and masked probabilities are 0, so no tile size
// has to divide T, Tk or D.
//
// Measured: each instance's registers, spills and shared memory are
// chip_smoke.py's `[timing] instance=` lines (cudaFuncGetAttributes
// through ptt_flash_bwd_attributes), and its time at the transformer's
// shape the `[timing]` line of flash_attention_bwd; PERF.md keeps them.
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16;            // threads along a score tile's queries
constexpr int TY = THREADS / TX;  // threads along its keys: 16
constexpr int BQ = 64;            // query rows per tile
constexpr int QJ = BQ / TX;       // queries per thread: tx + 16 j
constexpr int QR = BQ / TY;       // dQ rows per thread: 4 ty .. 4 ty + 3
constexpr int SP = BQ + 16;       // row stride of P^T and dS^T
constexpr int D_MAX = 128;
static_assert(QR == 4, "dQ's product reads dS^T as one float4 a key");

// a row stride holding D rounded up to a float4, and an odd number of
// float4, so that 8 consecutive rows fall in 8 distinct bank groups
__host__ __device__ constexpr int row_stride(int d) {
  return ((d + 3) / 4) % 2 ? (d + 3) / 4 * 4 : (d + 3) / 4 * 4 + 4;
}

// floats of the dQ slots: the sum so far of a BQ x 64 NG tile, and with
// NG == 1 the second half's sums of it; and whether they fit in the P^T
// area, which is free while they are used
constexpr int XS_FLOATS = 2 * BQ * 64;
__host__ __device__ constexpr bool xs_in_pt(int bk) {
  return bk * SP >= XS_FLOATS;
}

// floats of shared memory: K, V [BK][ds]; Q, dO [STAGES][BQ][ds]; P^T and
// dS^T [BK][SP]; m, l, delta [STAGES][3][BQ]; the dQ slots unless they
// fit in P^T
__host__ __device__ constexpr int smem_floats(int bk, int stages, int d) {
  return (2 * bk + 2 * stages * BQ) * row_stride(d) + 2 * bk * SP +
         stages * 3 * BQ + (xs_in_pt(bk) ? 0 : XS_FLOATS);
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

// rows r0..r0+ROWS-1 of a [R, D] source into a [ROWS][ds] fp32 shared
// tile by cp.async, columns 0..4*ceil(D/4)-1; rows past R and columns past
// D are zero
template <bool ALIGNED, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int r0, int R, int D, int ds) {
  if (ALIGNED) {   // D % 4 == 0, 16-byte aligned rows
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

// m, l and delta of rows q0..q0+BQ-1 into St[0..3*BQ); past T they are
// zero (l = 0 reads as 1, and those rows' probabilities are 0)
__device__ __forceinline__ void copy_stats(float* St, const float* M,
                                           const float* L,
                                           const float* Delta, int q0,
                                           int T) {
  for (int idx = threadIdx.x; idx < 3 * BQ; idx += THREADS) {
    const int a = idx / BQ, r = idx - a * BQ;
    const float* src = a == 0 ? M : a == 1 ? L : Delta;
    const bool in = q0 + r < T;
    cp_async4(St + idx, in ? src + q0 + r : src, in ? 4 : 0);
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] and p[i][j] = A2[..] . B2[..]
// over the dv float4 of a row, d ascending for every entry, for the first
// RH of the RK rows i; both products in one loop, for the scheduler
template <int RH, int RK, int DC>
__device__ __forceinline__ void dots(const float* A, const float* B,
                                     const float* A2, const float* B2,
                                     int dv_, int ds, int ty, int tx,
                                     float (&s)[RK][QJ], float (&p)[RK][QJ]) {
  const int dv = DC ? DC / 4 : dv_;
#pragma unroll
  for (int i = 0; i < RH; ++i)
#pragma unroll
    for (int j = 0; j < QJ; ++j) s[i][j] = p[i][j] = 0.f;
  auto step = [&](const float* X, const float* Y, int d4,
                  float (&o)[RK][QJ]) {
    float4 a[RH], b[QJ];
#pragma unroll
    for (int i = 0; i < RH; ++i) a[i] = ld4(X + (ty + TY * i) * ds + 4 * d4);
#pragma unroll
    for (int j = 0; j < QJ; ++j) b[j] = ld4(Y + (tx + TX * j) * ds + 4 * d4);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < RH; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j)
          o[i][j] = fmaf(part(a[i], c), part(b[j], c), o[i][j]);
  };
#pragma unroll(DC ? DC / 4 : 2)
  for (int d4 = 0; d4 < dv; ++d4) {
    step(A, B, d4, s);
    step(A2, B2, d4, p);
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

// The persistent kernel: each block pulls (b*h, key tile) work items from
// Counters[bh * nq] in key-major order until none is left; dQ is the
// ordered sum.  RK keys a thread (key tile BK = 16 RK), NG float4 of
// output columns a thread (1 up to D = 64, 2 up to 128), STAGES query
// tiles in flight, DC = D fixed at compile time or 0.
template <bool CAUSAL, int RK, int NG, int STAGES, int DC, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                 const float* __restrict__ V, const float* __restrict__ dO,
                 const float* __restrict__ M, const float* __restrict__ L,
                 const float* __restrict__ Delta, float* __restrict__ dQ,
                 float* __restrict__ dK, float* __restrict__ dV,
                 int* __restrict__ Counters, int bh_n, int T, int Tk, int D_,
                 float scale) {
  constexpr int BK = TY * RK;
  const int D = DC ? DC : D_;
  const int ds = row_stride(D);
  const int dv4 = (D + 3) / 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BK][ds]
  float* Vs = Ks + BK * ds;                      // [BK][ds]
  float* Qs = Vs + BK * ds;                      // [STAGES][BQ][ds]
  float* dOs = Qs + STAGES * BQ * ds;            // [STAGES][BQ][ds]
  float* Pt = dOs + STAGES * BQ * ds;            // P^T [BK][SP]
  float* dSt = Pt + BK * SP;                     // dS^T [BK][SP]
  float* St = dSt + BK * SP;                     // [STAGES][3][BQ]
  float* Xs = xs_in_pt(BK) ? Pt : St + STAGES * 3 * BQ;   // dQ slots
  __shared__ int item_s;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int nq = (T + BQ - 1) / BQ;
  const int nk = (Tk + BK - 1) / BK;
  const int items = bh_n * nk;
  int* work = Counters + static_cast<long long>(bh_n) * nq;

  for (;;) {
    __syncthreads();   // every thread is done with the last item
    if (tid == 0) item_s = atomicAdd(work, 1);
    __syncthreads();
    const int item = item_s;
    if (item >= items) return;
    const int kt = item / bh_n;
    const long long bh = item - static_cast<long long>(kt) * bh_n;
    const int k0 = kt * BK;
    const float* q = Q + bh * T * D;
    const float* dout = dO + bh * T * D;
    const float* m = M + bh * T;
    const float* l = L + bh * T;
    const float* delta = Delta + bh * T;
    float* dq = dQ + bh * T * D;
    int* cnt = Counters + bh * nq;

    // row i sees key j only when j <= i: the first query tile that sees
    // this key tile holds row k0; the walk goes from the last one down
    const int qfirst = CAUSAL ? min(k0 / BQ, nq) : 0;
    const int n = nq - qfirst;
    auto issue = [&](int t) {
      const int s = STAGES == 2 ? t & 1 : 0;
      const int q0 = (nq - 1 - t) * BQ;
      copy_rows<ALIGNED, BQ>(Qs + s * BQ * ds, q, q0, T, D, ds);
      copy_rows<ALIGNED, BQ>(dOs + s * BQ * ds, dout, q0, T, D, ds);
      copy_stats(St + s * 3 * BQ, m, l, delta, q0, T);
    };
    if (n > 0) {
      copy_rows<ALIGNED, BK>(Ks, K + bh * Tk * D, k0, Tk, D, ds);
      copy_rows<ALIGNED, BK>(Vs, V + bh * Tk * D, k0, Tk, D, ds);
      issue(0);
      cp_async_commit();
    }

    float dk[RK][4 * NG], dv[RK][4 * NG];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NG; ++j) dk[i][j] = dv[i][j] = 0.f;

    for (int t = 0; t < n; ++t) {
      const int qt = nq - 1 - t;
      const int q0 = qt * BQ;
      const int s = STAGES == 2 ? t & 1 : 0;
      const float* qs = Qs + s * BQ * ds;
      const float* dos = dOs + s * BQ * ds;
      const float* st = St + s * 3 * BQ;
      cp_async_wait_all();
      // tile t has landed for every thread, and every thread is done with
      // tile t - 1: its stage and P^T, dS^T may be overwritten, and its dQ
      // stores are issued, which thread 0's fence orders before the turn
      // it hands on
      __syncthreads();
      if (tid == 0 && t > 0) {
        __threadfence();
        store_release(cnt + qt + 1, kt + 1);
      }
      if (STAGES == 2 && t + 1 < n) {
        issue(t + 1);
        cp_async_commit();
      }

      // S^T and dP^T: keys ty + 16 i, queries tx + 16 j; then P^T and
      // dS^T = scale P^T o (dP^T - delta) into shared memory; then
      // dV[key][c] += P^T[key][q] dO[q][c], dK[key][c] += dS^T[key][q] Q[q][c]
      // for keys ty + 16 i and columns 4 (tx + 16 g) .. + 3, q ascending;
      // rows past T add nothing (p = ds = 0, zero-filled rows).  Only the
      // thread's first RH key rows: the others see no row of this tile
      auto tile_pair = [&](auto rows) {
        constexpr int RH = decltype(rows)::value;
        {
          float p[RK][QJ], dp[RK][QJ];
          dots<RH, RK, DC>(Ks, qs, Vs, dos, dv4, ds, ty, tx, p, dp);
#pragma unroll
          for (int j = 0; j < QJ; ++j) {
            const int r = tx + TX * j;
            const int qi = q0 + r;
            const float mr = st[r];
            const float lr = st[BQ + r];
            const float li = 1.f / (lr == 0.f ? 1.f : lr);
            const float dl = st[2 * BQ + r];
#pragma unroll
            for (int i = 0; i < RH; ++i) {
              const int kj = k0 + ty + TY * i;
              const bool in = qi < T && kj < Tk && (!CAUSAL || kj <= qi);
              const float pe = in ? expf(p[i][j] * scale - mr) * li : 0.f;
              Pt[(ty + TY * i) * SP + r] = pe;
              dSt[(ty + TY * i) * SP + r] = pe * (dp[i][j] - dl) * scale;
            }
          }
        }
        __syncthreads();

        const int qn4 = (min(BQ, T - q0) + 3) / 4;
#pragma unroll 2
        for (int q4 = 0; q4 < qn4; ++q4) {
          float4 pa[RH], sa[RH];
#pragma unroll
          for (int i = 0; i < RH; ++i) {
            pa[i] = ld4(Pt + (ty + TY * i) * SP + 4 * q4);
            sa[i] = ld4(dSt + (ty + TY * i) * SP + 4 * q4);
          }
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int c = 4 * (tx + TX * g);
            if (c >= D) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 ob = ld4(dos + (4 * q4 + e) * ds + c);
              const float4 qb = ld4(qs + (4 * q4 + e) * ds + c);
#pragma unroll
              for (int i = 0; i < RH; ++i) {
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
      };
      // under the causal mask, the upper half of a 128-key tile sees no
      // row of the query tile on its diagonal (q0 == k0): half the work
      if constexpr (CAUSAL && RK == 8) {
        if (q0 + BQ <= k0 + TY * RK / 2)
          tile_pair(std::integral_constant<int, RK / 2>{});
        else
          tile_pair(std::integral_constant<int, RK>{});
      } else {
        tile_pair(std::integral_constant<int, RK>{});
      }
      if (STAGES == 1) {
        __syncthreads();   // every thread is done with Q and dO
        if (t + 1 < n) {
          issue(t + 1);
          cp_async_commit();
        }
      }

      // dQ's owners: with NG == 1 the block's two halves each sum half of
      // the keys for all 64 x 64 entries, a thread 8 consecutive rows x 4
      // columns, and the first half owns the result; with NG == 2 every
      // thread owns 4 consecutive rows x 8 columns.  Rows dr0 .. dr0+DR-1,
      // columns 4 (tx + 16 g) .. + 3
      constexpr int DR = NG == 1 ? 8 : QR;
      constexpr int DT = NG == 1 ? THREADS / 2 : THREADS;
      const int dt = tid % DT;
      const bool owner = tid < DT;
      const int dr0 = q0 + DR * (dt / TX);
      const int kn = CAUSAL ? min(min(BK, Tk - k0), q0 + BQ - k0)
                            : min(BK, Tk - k0);

      // the ordered sum, first half: key tile kt takes its turn on this
      // query tile once key tiles 0..kt-1 (all of which see it) have added
      // theirs, and an owner copies the sum so far into its own slots of
      // shared memory, where it lands behind this pair's dQ product
      if (NG == 1 || kt > 0) {
        if (tid == 0 && kt > 0)
          while (load_acquire(cnt + qt) != kt) __nanosleep(64);
        __syncthreads();   // every thread's turn; P^T is free
        if (ALIGNED && kt > 0 && owner) {
#pragma unroll
          for (int i = 0; i < DR; ++i) {
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              const int c = 4 * (tx + TX * g);
              if (dr0 + i < T && c < D)
                cp_async16(Xs + ((i * NG + g) * DT + dt) * 4,
                           dq + static_cast<long long>(dr0 + i) * D + c, 16);
            }
          }
          cp_async_commit();
        }
      }

      // this pair's dQ, keys ascending; keys past Tk have dS = 0 and
      // zero-filled rows, and under the causal mask keys past the tile's
      // last row add nothing
      float dqc[DR][4 * NG];
#pragma unroll
      for (int i = 0; i < DR; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NG; ++j) dqc[i][j] = 0.f;
      if constexpr (NG == 1) {
        const int kh = (kn + 1) / 2;
        const int kb = owner ? 0 : kh, ke = owner ? kh : kn;
        const int c = 4 * tx;
#pragma unroll 4
        for (int kk = kb; kk < ke; ++kk) {
          if (c >= D) break;
          const float4 a0 = ld4(dSt + kk * SP + DR * (dt / TX));
          const float4 a1 = ld4(dSt + kk * SP + DR * (dt / TX) + 4);
          const float4 b = ld4(Ks + kk * ds + c);
#pragma unroll
          for (int i = 0; i < DR; ++i) {
            const float ae = part(i < 4 ? a0 : a1, i % 4);
            dqc[i][0] = fmaf(ae, b.x, dqc[i][0]);
            dqc[i][1] = fmaf(ae, b.y, dqc[i][1]);
            dqc[i][2] = fmaf(ae, b.z, dqc[i][2]);
            dqc[i][3] = fmaf(ae, b.w, dqc[i][3]);
          }
        }
        // the second half's sums after the first's, in the P^T area
        float* half2 = Xs + XS_FLOATS / 2;
        if (!owner) {
#pragma unroll
          for (int i = 0; i < DR; ++i)
            *reinterpret_cast<float4*>(half2 + (i * DT + dt) * 4) =
                make_float4(dqc[i][0], dqc[i][1], dqc[i][2], dqc[i][3]);
        }
        __syncthreads();
        if (owner) {
#pragma unroll
          for (int i = 0; i < DR; ++i) {
            const float4 h = ld4(half2 + (i * DT + dt) * 4);
            dqc[i][0] += h.x;
            dqc[i][1] += h.y;
            dqc[i][2] += h.z;
            dqc[i][3] += h.w;
          }
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const float4 a = ld4(dSt + kk * SP + DR * (dt / TX));
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int c = 4 * (tx + TX * g);
            if (c >= D) continue;
            const float4 b = ld4(Ks + kk * ds + c);
#pragma unroll
            for (int i = 0; i < DR; ++i) {
              const float ae = part(a, i);
              dqc[i][4 * g] = fmaf(ae, b.x, dqc[i][4 * g]);
              dqc[i][4 * g + 1] = fmaf(ae, b.y, dqc[i][4 * g + 1]);
              dqc[i][4 * g + 2] = fmaf(ae, b.z, dqc[i][4 * g + 2]);
              dqc[i][4 * g + 3] = fmaf(ae, b.w, dqc[i][4 * g + 3]);
            }
          }
        }
      }

      // second half: sum so far + this pair's, stored through L2 (key tile
      // 0 stores its own); thread 0 releases kt + 1 after the next barrier
      if (owner) {
        if (ALIGNED && kt > 0) cp_async_wait_all();
#pragma unroll
        for (int i = 0; i < DR; ++i) {
          if (dr0 + i >= T) continue;
          float* row = dq + static_cast<long long>(dr0 + i) * D;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int c = 4 * (tx + TX * g);
            if (c >= D) continue;
            if (ALIGNED) {
              float4 x = make_float4(dqc[i][4 * g], dqc[i][4 * g + 1],
                                     dqc[i][4 * g + 2], dqc[i][4 * g + 3]);
              if (kt > 0) {
                const float4 old = ld4(Xs + ((i * NG + g) * DT + dt) * 4);
                x = make_float4(old.x + x.x, old.y + x.y, old.z + x.z,
                                old.w + x.w);
              }
              __stcg(reinterpret_cast<float4*>(row + c), x);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (c + e >= D) continue;
                const float x = dqc[i][4 * g + e];
                const float sum = kt > 0 ? __ldcg(row + c + e) + x : x;
                __stcg(row + c + e, sum);
              }
            }
          }
        }
      }
    }
    if (n > 0) {
      // the last query tile's turn: every thread's stores are issued, and
      // the fence orders them before the release
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        store_release(cnt + qfirst, kt + 1);
      }
    }

    // dK and dV of the item's keys (zero when no query sees them)
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int key = k0 + ty + TY * i;
      if (key >= Tk) continue;
      float* dkr = dK + (bh * Tk + key) * D;
      float* dvr = dV + (bh * Tk + key) * D;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = 4 * (tx + TX * g);
        if (c >= D) continue;
        if (ALIGNED) {
          *reinterpret_cast<float4*>(dkr + c) =
              make_float4(dk[i][4 * g], dk[i][4 * g + 1], dk[i][4 * g + 2],
                          dk[i][4 * g + 3]);
          *reinterpret_cast<float4*>(dvr + c) =
              make_float4(dv[i][4 * g], dv[i][4 * g + 1], dv[i][4 * g + 2],
                          dv[i][4 * g + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e >= D) continue;
            dkr[c + e] = dk[i][4 * g + e];
            dvr[c + e] = dv[i][4 * g + e];
          }
        }
      }
    }
  }
}

// the instances: (RK, NG, STAGES) is (8, 1, 2) up to D = 64 and
// (4, 2, 1) up to 128; DC = 64 for D = 64, else 0
#define PTT_BWD_INSTANCES(X)                  \
  X(true, 8, 1, 2, 64, true)                  \
  X(true, 8, 1, 2, 64, false)                 \
  X(true, 8, 1, 2, 0, true)                   \
  X(true, 8, 1, 2, 0, false)                  \
  X(true, 4, 2, 1, 0, true)                   \
  X(true, 4, 2, 1, 0, false)                  \
  X(false, 8, 1, 2, 64, true)                 \
  X(false, 8, 1, 2, 64, false)                \
  X(false, 8, 1, 2, 0, true)                  \
  X(false, 8, 1, 2, 0, false)                 \
  X(false, 4, 2, 1, 0, true)                  \
  X(false, 4, 2, 1, 0, false)

struct Instance {
  const void* fn;
  const char* name;
  int smem_bytes;   // dynamic shared memory at the instance's widest D
};

#define PTT_BWD_ENTRY(C, RK, NG, S, DC, A)                                  \
  {reinterpret_cast<const void*>(flash_bwd_kernel<C, RK, NG, S, DC, A>),    \
   "flash_bwd_kernel<float,causal=" #C ",RK=" #RK ",NG=" #NG                \
   ",STAGES=" #S ",DC=" #DC ",ALIGNED=" #A ">",                             \
   static_cast<int>(smem_floats(16 * RK, S, DC ? DC : 64 * NG) *            \
                    sizeof(float))},

const Instance kInstances[] = {
    {reinterpret_cast<const void*>(flash_bwd_delta_kernel),
     "flash_bwd_delta_kernel<float>", 0},
    PTT_BWD_INSTANCES(PTT_BWD_ENTRY)};

// the operands of one backward
struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* m;
  const float* l;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* delta;
  int* counters;
  int bh, T, Tk, D;
  float scale;
};

template <bool CAUSAL, int RK, int NG, int STAGES, int DC, bool ALIGNED>
int launch(const BwdArgs& a, cudaStream_t stream) {
  const auto kernel = flash_bwd_kernel<CAUSAL, RK, NG, STAGES, DC, ALIGNED>;
  const int smem = smem_floats(16 * RK, STAGES, a.D) * sizeof(float);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent: as many blocks as the card holds at once, or one an item
  const long long items =
      static_cast<long long>(a.bh) * ((a.Tk + 16 * RK - 1) / (16 * RK));
  const int grid = static_cast<int>(
      items < static_cast<long long>(sms) * per_sm ? items : sms * per_sm);
  kernel<<<grid, THREADS, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.m, a.l, a.delta, a.dq, a.dk, a.dv, a.counters,
      a.bh, a.T, a.Tk, a.D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool CAUSAL, bool ALIGNED>
int dispatch(const BwdArgs& a, cudaStream_t s) {
  if (a.D == 64) return launch<CAUSAL, 8, 1, 2, 64, ALIGNED>(a, s);
  if (a.D <= 64) return launch<CAUSAL, 8, 1, 2, 0, ALIGNED>(a, s);
  return launch<CAUSAL, 4, 2, 1, 0, ALIGNED>(a, s);
}

bool aligned_to(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

// the delta pass, then the persistent kernel of the instance for D, the
// mask and the operands' alignment
int run(const BwdArgs& a, int causal, long long n_counters, void* stream) {
  if (a.bh < 1 || a.T < 1 || a.Tk < 1 || a.D < 1 || a.D > D_MAX ||
      static_cast<long long>(a.bh) * ((a.Tk + 63) / 64) > INT_MAX ||
      n_counters < static_cast<long long>(a.bh) * ((a.T + BQ - 1) / BQ) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(a.bh) * a.T;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  flash_bwd_delta_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      a.o, a.dout, a.delta, rows, a.D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // four elements (16 bytes) a copy or store: every row and base on 16
  // bytes
  const bool aligned =
      a.D % 4 == 0 && aligned_to(a.q, 16) && aligned_to(a.k, 16) &&
      aligned_to(a.v, 16) && aligned_to(a.dout, 16) && aligned_to(a.dq, 16) &&
      aligned_to(a.dk, 16) && aligned_to(a.dv, 16);
  if (causal)
    return aligned ? dispatch<true, true>(a, s) : dispatch<true, false>(a, s);
  return aligned ? dispatch<false, true>(a, s) : dispatch<false, false>(a, s);
}

}  // namespace

extern "C" {

// dQ, dK, dV of O = attention(Q, K, V) for bh (batch x head) slices,
// row-major fp32: Q, O, dO and dQ are [bh, T, D], K, V, dK and dV
// [bh, Tk, D], M and L the forward's raw row max and denominator
// [bh, T], Delta a [bh, T] scratch, Counters a ZEROED int scratch of
// n_counters >= bh * ceil(T / 64) + 1 entries (the dQ tiles' turn
// counters, then the work-item counter); 1 <= D <= 128.  Two launches on
// `stream` (delta, then the persistent kernel); returns the first
// cudaGetLastError() that is not 0, else 0.
int ptt_flash_bwd_f32(const float* q, const float* k, const float* v,
                      const float* o, const float* m, const float* l,
                      const float* dout, float* dq, float* dk, float* dv,
                      float* delta, int* counters, long long n_counters,
                      int bh, int T, int Tk, int D, int causal, float scale,
                      void* stream) {
  const BwdArgs a{q, k, v, o, m, l, dout, dq, dk, dv, delta,
                  counters, bh, T, Tk, D, scale};
  return run(a, causal, n_counters, stream);
}

// Instance i of the library (0: the delta pass): its name and, in out[0..4],
// registers a thread, local (spill) bytes a thread, static shared bytes,
// dynamic shared bytes at its widest D, resident blocks an SM at that
// size.  Returns 0, -1 past the last instance, or a cudaError_t.
int ptt_flash_bwd_attributes(int i, int* out, const char** name) {
  if (i < 0 || i >= static_cast<int>(sizeof(kInstances) /
                                     sizeof(kInstances[0])))
    return -1;
  const Instance& inst = kInstances[i];
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, inst.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (inst.smem_bytes > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
           inst.smem_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  int per_sm = 0;
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
