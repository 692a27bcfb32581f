// Flash attention forward for Hopper (sm_90a), fp32, with optional
// export of each row's softmax statistics.
//
//   O[bh] = softmax(scale * Q[bh] . K[bh]^T, masked) . V[bh]
//   M[bh, i] = running max of row i, L[bh, i] = its denominator (raw)
//
// Replaces the JAX package's Pallas kernels `_flash_fwd_kernel` (reached
// through `_flash_fwd`'s pl.pallas_call, parsec_tpu/ops/pallas_kernels.py)
// and `_flash_fwd_stats_kernel` (reached through `flash_attention_stats`).
// One kernel, templated on (causal, write_stats), serves both; the
// transformer's forward runs it once per layer: attention="flash",
// "local" and "ulysses" without the statistics, attention="ring" with
// them (the ring merges blocks by m and l).
//
// This source builds the fp32 library (parsec_tpu_torch/ops/kernels.py):
// ptt_flash_fwd_f32 and ptt_flash_fwd_stats_f32.  The bf16 forward is the
// tensor-core kernel of flash_attention_bf16.cu.
//
// Arithmetic kept from the Pallas kernel: the score is (q . k) * scale;
// a causally masked score is -1e30 (not -inf) with the local-index mask
// (row i sees keys 0..i, also when T != Tk); m starts at -1e30 and l at
// 0; each k-tile rescales by exp(m_prev - m_new); o = acc / l with
// l == 0 -> 1 on o only; m and l are exported raw.  exp is expf (the
// accurate libm form, not __expf).  A key past Tk adds exactly nothing.
//
// What bounds it.  At the transformer's shape ([8, 12, 1024, 64], causal)
// the work is 4 * D flops per unmasked (query, key) pair, 12.9 GFLOP,
// over 101 MB of Q, K, V and O: about 128 flops per byte, so the bound is
// the 67 TFLOP/s fp32 rate of an H100 SXM outside the tensor cores
// (0.19 ms), not its 3.35 TB/s memory (0.03 ms).  Everything is fp32
// FMA: no TF32, no tensor cores.
//
// What the design does about it.  The TPU kernel walks k-blocks along a
// sequential grid axis, carrying m, l and acc in VMEM scratch.  Blocks on
// Hopper run in parallel and in no order, so here one block of 8 warps
// owns a tile of 64 query rows of one (b, h) and loops over 64-key tiles
// itself; m, l and the fp32 accumulator stay in registers for the whole
// loop, and the [T, Tk] scores never reach device memory.  Each warp owns
// 8 consecutive rows, the 16 lanes of a half warp sharing one row, and a
// lane holds 4 rows x 4 keys of the score tile and 4 rows x 4 (D <= 64)
// or 8 (D <= 128) columns of the output.  Both products read float4 along
// their reduction: Q.K^T takes Q[row][d..d+3] and K[key][d..d+3] (rows
// padded to a stride of an odd number of float4, so the 8 keys of a
// quarter warp hit 8 distinct bank groups), P.V takes P[row][kk..kk+3]
// and V[kk][c..c+3] with each lane's output columns contiguous: 64 FMAs
// per 8 loads (the first design's scalar tiling fed 16 FMAs with 8).  P
// passes through shared memory only within its warp (a __syncwarp, no
// block barrier).  K and V arrive by cp.async in a 2-stage ring: tile
// j + 1 loads while tile j computes, with one block barrier per tile; a
// block takes 105 KB of shared memory at D = 64, so two blocks share an SM
// and one's softmax overlaps the other's products.  The causal loop ends
// at the tile's last query row (the Pallas kernel's skip of k-blocks
// above the diagonal), a warp whose rows all lie above a tile's first key
// skips that tile (its p would be 0 and its rescale 1, exactly), and the
// heaviest query tiles of every (b, h) are issued first; on a diagonal
// tile P.V stops at the warp's last row.  Ragged T and Tk
// are masked and zero-filled, so no block size has to divide them; D is
// any value up to 128 at run time, and D = 64 and 128 on aligned inputs
// take instances with D fixed at compile time (DC), whose score loop
// unrolls fully.  16-byte copies need D % 4 == 0 and 16-byte aligned
// pointers; otherwise the same kernel copies with 4-byte cp.async and
// zero-fills the columns up to the next multiple of 4 (the ALIGNED = false
// instance), with the same arithmetic.
//
// Measured (chip_smoke.py --ptxas, sm_90a, -O3): the D <= 64 instances
// take 100 to 128 registers a thread (the forward's, causal with D = 64
// fixed, 128), the D <= 128 ones 128 to 168, none spills.  At the
// forward's shape it reaches about 40 % of the fp32 bound, a little
// faster than the library's fp32 attention; PERF.md says what still holds
// it back.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;  // 256
constexpr int TX = 16;               // lanes sharing a row (a half warp)
constexpr int RM = 4;                // rows per lane: wr + 2 i
constexpr int BQ = WARPS * 2 * RM;   // query rows per block: 64
constexpr int BK = 64;               // keys per k-tile
constexpr int CN = BK / TX;          // keys per lane: tx + 16 j
constexpr int PS = BK + 16;          // row stride of the probability tile:
                                     // the two rows a warp writes at once
                                     // land 16 banks apart
constexpr int D_MAX = 128;
constexpr float NEG_INF = -1e30f;    // the Pallas kernel's mask value

// a row stride holding D rounded up to a float4, and an odd number of
// float4 so that 8 consecutive rows fall in 8 distinct bank groups
__host__ __device__ constexpr int row_stride(int d) {
  return ((d + 3) / 4) % 2 ? (d + 3) / 4 * 4 : (d + 3) / 4 * 4 + 4;
}

// Q [BQ][ds], 2 stages of K and V [BK][ds], P [BQ][PS]: 105 KB at D = 64,
// so two blocks share an SM
size_t smem_bytes(int d) {
  const size_t ds = row_stride(d);
  return ((BQ + 4 * BK) * ds + BQ * PS) * sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

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

// rows r0..r0+ROWS-1 of a [R, D] source into a [ROWS][ds] fp32 shared
// tile by cp.async (ALIGNED: 16-byte copies), columns 0..4*ceil(D/4)-1;
// rows past R and columns past D are zero
template <bool ALIGNED, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int R, int D, int ds,
                                          int tid) {
  const int dv = (D + 3) / 4;
  if (ALIGNED) {
    for (int idx = tid; idx < ROWS * dv; idx += THREADS) {
      const int r = idx / dv, c = (idx - r * dv) * 4;
      const bool in = r0 + r < R;
      cp_async16(dst + r * ds + c,
                 in ? src + static_cast<long long>(r0 + r) * D + c : src,
                 in ? 16 : 0);
    }
  } else {
    const int w = 4 * dv;
    for (int idx = tid; idx < ROWS * w; idx += THREADS) {
      const int r = idx / w, c = idx - r * w;
      const bool in = r0 + r < R && c < D;
      cp_async4(dst + r * ds + c,
                in ? src + static_cast<long long>(r0 + r) * D + c : src,
                in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float part(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// DC: D fixed at compile time (aligned inputs only), or 0 for any D.  Up to
// D = 64 (NJ = 4) two blocks share an SM, so 128 registers a thread; the
// wider instance keeps one block an SM and more registers.
template <bool CAUSAL, bool STATS, int NJ, bool ALIGNED, int DC>
__global__ void __launch_bounds__(THREADS, NJ == 4 ? 2 : 1)
flash_fwd_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                 const float* __restrict__ V, float* __restrict__ O,
                 float* __restrict__ Mout, float* __restrict__ Lout, int T,
                 int Tk, int D_, float scale) {
  static_assert(DC == 0 || ALIGNED, "a fixed D takes 16-byte copies");
  constexpr int NG = NJ / 4;         // float4 output columns per lane
  const int D = DC ? DC : D_;
  const int ds = DC ? row_stride(DC) : row_stride(D_);
  const int dv = DC ? DC / 4 : (D_ + 3) / 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][ds]
  float* KVs = Qs + BQ * ds;                     // [2][K, V][BK][ds]
  float* Ps = KVs + 4 * BK * ds;                 // [BQ][PS]

  const long long bh = blockIdx.x;
  const int qt = CAUSAL ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * BQ;
  Q += bh * T * D;
  O += bh * T * D;
  K += bh * Tk * D;
  V += bh * Tk * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = lane & (TX - 1);
  const int wr = warp * 2 * RM + (lane >> 4);   // local rows wr + 2 i

  const int rows_end = min(T, q0 + BQ);
  const int kend = CAUSAL ? min(Tk, rows_end) : Tk;
  const int ntiles = (kend + BK - 1) / BK;
  const int warp_last_row = q0 + warp * 2 * RM + 2 * RM - 1;

  auto load_kv = [&](int stage, int k0) {
    float* kt = KVs + stage * 2 * BK * ds;
    load_rows<ALIGNED, BK>(kt, K, k0, Tk, D, ds, tid);
    load_rows<ALIGNED, BK>(kt + BK * ds, V, k0, Tk, D, ds, tid);
  };
  load_rows<ALIGNED, BQ>(Qs, Q, q0, T, D, ds, tid);
  load_kv(0, 0);
  cp_async_commit();

  float m[RM], l[RM], acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    // tile t (and Q) have landed, and every warp is done with tile t - 1,
    // whose stage the next copy overwrites
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntiles) load_kv((t + 1) & 1, k0 + BK);
    cp_async_commit();
    // every key of this tile lies above every row of the warp: each p is
    // exactly 0 and each rescale exactly 1, so the tile changes nothing
    if (CAUSAL && k0 > warp_last_row) continue;
    const float* Ks = KVs + (t & 1) * 2 * BK * ds;
    const float* Vs = Ks + BK * ds;

    // s = Q . K^T over this tile: rows wr + 2 i, keys tx + 16 j
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll(DC ? DC / 4 : 2)
    for (int d4 = 0; d4 < dv; ++d4) {
      float4 qa[RM], kb[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (wr + 2 * i) * ds +
                                                 4 * d4);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + j * TX) * ds +
                                                 4 * d4);
      // d = 4 d4 + c ascending for every score
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j)
            s[i][j] = fmaf(part(qa[i], c), part(kb[j], c), s[i][j]);
    }

    // online softmax: scale, mask, running max, rescale
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + wr + 2 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx + j * TX;
        float v = s[i][j] * scale;
        if ((CAUSAL && kj > qi) || kj >= Tk) v = NEG_INF;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        // a key past Tk does not exist: it adds nothing, whatever m is
        const float p = (k0 + tx + j * TX < Tk) ? expf(s[i][j] - mx) : 0.f;
        Ps[(wr + 2 * i) * PS + tx + j * TX] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - mx);
      l[i] = l[i] * corr + rs;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();   // the warp's P rows are written; only the warp reads them

    // acc += P . V: rows wr + 2 i, columns 4 (tx + 16 g) .. + 3.  Keys past
    // Tk (up to the next multiple of 4) have p = 0 and zero-filled V, and
    // causal keys past the warp's last row p = 0 (every row has seen key 0,
    // so its max is a real score): the loop stops there, which changes
    // nothing
    const int kn = min(CAUSAL ? min(BK, warp_last_row + 1 - k0) : BK, Tk - k0);
    const int kn4 = (kn + 3) / 4;
#pragma unroll 4
    for (int k4 = 0; k4 < kn4; ++k4) {
      float4 pa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (wr + 2 * i) * PS +
                                                 4 * k4);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = 4 * (tx + g * TX);
        if (c >= D) continue;
        const float* vr = Vs + 4 * k4 * ds + c;
        // kk = 4 k4 + e ascending for every output
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 ve = *reinterpret_cast<const float4*>(vr + e * ds);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float pe = part(pa[i], e);
            acc[i][4 * g] = fmaf(pe, ve.x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(pe, ve.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(pe, ve.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(pe, ve.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + wr + 2 * i;
    if (r >= T) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    float* orow = O + static_cast<long long>(r) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 4 * (tx + g * TX);
      if (c >= D) continue;
      const float o0 = acc[i][4 * g] / lsafe, o1 = acc[i][4 * g + 1] / lsafe,
                  o2 = acc[i][4 * g + 2] / lsafe,
                  o3 = acc[i][4 * g + 3] / lsafe;
      if (ALIGNED) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(o0, o1, o2, o3);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < D) orow[c + e] = acc[i][4 * g + e] / lsafe;
      }
    }
    if (STATS && tx == 0) {
      Mout[bh * T + r] = m[i];
      Lout[bh * T + r] = l[i];
    }
  }
}

template <bool CAUSAL, bool STATS, int NJ, bool ALIGNED, int DC>
int launch(const float* q, const float* k, const float* v, float* o,
           float* m, float* l, int bh, int T, int Tk, int D, float scale,
           cudaStream_t stream) {
  const auto kernel = flash_fwd_kernel<CAUSAL, STATS, NJ, ALIGNED, DC>;
  const size_t smem = smem_bytes(D);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // heaviest query tiles first: y is reversed in the kernel, and blocks
  // are issued x (the bh slice) fastest
  const dim3 grid(bh, (T + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, m, l, T, Tk, D, scale);
  return static_cast<int>(cudaGetLastError());
}

// the instance for this D and alignment: NJ = 4 columns per lane up to
// D = 64, 8 up to 128; D fixed at compile time when it is the widest
template <bool CAUSAL, bool STATS, int NJ>
int launch_variant(const float* q, const float* k, const float* v, float* o,
                   float* m, float* l, int bh, int T, int Tk, int D,
                   bool aligned, float scale, cudaStream_t stream) {
  if (aligned && D == TX * NJ)
    return launch<CAUSAL, STATS, NJ, true, TX * NJ>(
        q, k, v, o, m, l, bh, T, Tk, D, scale, stream);
  if (aligned)
    return launch<CAUSAL, STATS, NJ, true, 0>(q, k, v, o, m, l, bh, T, Tk, D,
                                              scale, stream);
  return launch<CAUSAL, STATS, NJ, false, 0>(q, k, v, o, m, l, bh, T, Tk, D,
                                             scale, stream);
}

bool aligned_to(const void* ptr, int bytes) {
  return reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

template <bool STATS>
int dispatch(const float* q, const float* k, const float* v, float* o,
             float* m, float* l, int bh, int T, int Tk, int D, int causal,
             float scale, void* stream) {
  if (bh < 1 || bh > 65535 || T < 1 || Tk < 1 || D < 1 || D > D_MAX ||
      (T + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // four elements (16 bytes) a copy
  const bool aligned = D % 4 == 0 && aligned_to(q, 16) && aligned_to(k, 16) &&
                       aligned_to(v, 16) && aligned_to(o, 16);
  if (D <= 4 * TX)   // 4 output columns a lane
    return causal ? launch_variant<true, STATS, 4>(
                        q, k, v, o, m, l, bh, T, Tk, D, aligned, scale, s)
                  : launch_variant<false, STATS, 4>(
                        q, k, v, o, m, l, bh, T, Tk, D, aligned, scale, s);
  return causal ? launch_variant<true, STATS, 8>(q, k, v, o, m, l, bh, T, Tk,
                                                 D, aligned, scale, s)
                : launch_variant<false, STATS, 8>(q, k, v, o, m, l, bh, T,
                                                  Tk, D, aligned, scale, s);
}

}  // namespace

extern "C" {

// O = attention(Q, K, V) for bh (batch x head) slices, row-major fp32:
// Q and O are [bh, T, D], K and V [bh, Tk, D], 1 <= D <= 128,
// bh <= 65535.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
int ptt_flash_fwd_f32(const float* q, const float* k, const float* v,
                      float* o, int bh, int T, int Tk, int D, int causal,
                      float scale, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, bh, T, Tk, D, causal,
                        scale, stream);
}

// As ptt_flash_fwd_f32, also writing each row's raw running max to M and
// denominator to L, both [bh, T] fp32.
int ptt_flash_fwd_stats_f32(const float* q, const float* k, const float* v,
                            float* o, float* m, float* l, int bh, int T,
                            int Tk, int D, int causal, float scale,
                            void* stream) {
  return dispatch<true>(q, k, v, o, m, l, bh, T, Tk, D, causal, scale,
                       stream);
}

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
