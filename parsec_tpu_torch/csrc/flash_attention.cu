// Flash attention forward for Hopper (sm_90a), fp32, with optional export
// of each row's softmax statistics.
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
// Arithmetic kept from the Pallas kernel: the score is (q . k) * scale;
// a causally masked score is -1e30 (not -inf) with the local-index mask
// (row i sees keys 0..i, also when T != Tk); m starts at -1e30 and l at
// 0; each k-tile rescales by exp(m_prev - m_new); o = acc / l with
// l == 0 -> 1 on o only; m and l are exported raw.  exp is expf (the
// accurate libm form, not __expf).
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
// Hopper run in parallel and in no order, so here one block owns a tile
// of 64 query rows of one (b, h) and loops over 64-key tiles itself,
// staging K and V through shared memory; m, l and the fp32 accumulator
// stay in registers for the whole loop, and the [T, Tk] scores never
// reach device memory.  Both products (Q.K^T into a 64x64 score tile,
// P.V into the accumulator) use the register tiling of matmul.cu: 256
// threads, each owning 4 rows x 4 keys of the score tile and 4 rows x
// up to 8 columns of the output, 16 FMAs per 8 shared-memory loads.  The
// 16 threads that share a row reduce its max and sum with warp shuffles.
// The causal loop ends at the tile's last query row (the Pallas kernel's
// skip of k-blocks above the diagonal), and causal tiles are issued
// heaviest first to shorten the tail.  Ragged T and Tk are masked, so
// no block size has to divide them; D is any value up to 128 at run
// time, with the shared-memory rows padded to an odd stride so column
// reads are free of bank conflicts.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per k-tile
constexpr int TY = 16;               // row groups
constexpr int TX = 16;               // threads sharing a row group
constexpr int THREADS = TY * TX;     // 256
constexpr int RM = BQ / TY;          // rows per thread
constexpr int CN = BK / TX;          // keys per thread
constexpr int PS = BK + 1;           // row stride of the probability tile
constexpr int D_MAX = 128;
constexpr float NEG_INF = -1e30f;    // the Pallas kernel's mask value

// an odd row stride: the 16 threads of a row group read 16 different
// rows at one column from 16 different banks
__host__ __device__ inline int row_stride(int d) { return d | 1; }

size_t smem_bytes(int d) {
  return (static_cast<size_t>(BQ + 2 * BK) * row_stride(d) +
          static_cast<size_t>(BQ) * PS) * sizeof(float);
}

template <bool CAUSAL, bool STATS, int NJ>   // D <= NJ * TX
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                     const float* __restrict__ V, float* __restrict__ O,
                     float* __restrict__ Mout, float* __restrict__ Lout,
                     int T, int Tk, int D, float scale) {
  extern __shared__ float smem[];
  const int ds = row_stride(D);
  float* Qs = smem;                  // [BQ][ds]
  float* Ks = Qs + BQ * ds;          // [BK][ds]
  float* Vs = Ks + BK * ds;          // [BK][ds]
  float* Ps = Vs + BK * ds;          // [BQ][PS]

  const long long bh = blockIdx.y;
  const int qt = CAUSAL ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int q0 = qt * BQ;
  Q += bh * T * D;
  O += bh * T * D;
  K += bh * Tk * D;
  V += bh * Tk * D;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // Q tile; rows past T are zero and never stored
  for (int r = ty; r < BQ; r += TY) {
    const bool in = q0 + r < T;
    for (int c = tx; c < D; c += TX)
      Qs[r * ds + c] = in ? Q[static_cast<long long>(q0 + r) * D + c] : 0.f;
  }

  float m[RM], l[RM], acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int rows_end = min(T, q0 + BQ);
  const int kend = CAUSAL ? min(Tk, rows_end) : Tk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // the last tile's readers are done (and Qs is written)
    for (int r = ty; r < BK; r += TY) {
      const bool in = k0 + r < Tk;
      const long long g = static_cast<long long>(k0 + r) * D;
      for (int c = tx; c < D; c += TX) {
        Ks[r * ds + c] = in ? K[g + c] : 0.f;
        Vs[r * ds + c] = in ? V[g + c] : 0.f;
      }
    }
    __syncthreads();

    // s = Q . K^T over this tile: rows ty + i*TY, keys tx + j*TX
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(ty + i * TY) * ds + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = Ks[(tx + j * TX) * ds + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // online softmax: scale, mask, running max, rescale
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty + i * TY;
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
        Ps[(ty + i * TY) * PS + tx + j * TX] = p;
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
    __syncthreads();

    // acc += P . V: rows ty + i*TY, columns tx + j*TX
    const int kn = min(BK, Tk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float p[RM], vv[NJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = Ps[(ty + i * TY) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + j * TX;
        vv[j] = c < D ? Vs[kk * ds + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + i * TY;
    if (r >= T) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + j * TX;
      if (c < D) O[static_cast<long long>(r) * D + c] = acc[i][j] / lsafe;
    }
    if (STATS && tx == 0) {
      Mout[bh * T + r] = m[i];
      Lout[bh * T + r] = l[i];
    }
  }
}

template <bool CAUSAL, bool STATS, int NJ>
int launch(const float* q, const float* k, const float* v, float* o,
           float* m, float* l, int bh, int T, int Tk, int D, float scale,
           cudaStream_t stream) {
  const auto kernel = flash_fwd_f32_kernel<CAUSAL, STATS, NJ>;
  const size_t smem = smem_bytes(D);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, bh);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, m, l, T, Tk, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS>
int dispatch(const float* q, const float* k, const float* v, float* o,
             float* m, float* l, int bh, int T, int Tk, int D, int causal,
             float scale, void* stream) {
  if (bh < 1 || bh > 65535 || T < 1 || Tk < 1 || D < 1 || D > D_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 4 * TX) {
    return causal ? launch<true, STATS, 4>(q, k, v, o, m, l, bh, T, Tk, D,
                                           scale, s)
                  : launch<false, STATS, 4>(q, k, v, o, m, l, bh, T, Tk, D,
                                            scale, s);
  }
  return causal ? launch<true, STATS, 8>(q, k, v, o, m, l, bh, T, Tk, D,
                                         scale, s)
                : launch<false, STATS, 8>(q, k, v, o, m, l, bh, T, Tk, D,
                                          scale, s);
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
