// Flash attention forward for Hopper (sm_90a) at head widths up to 256,
// fp32 or bf16 operands, with optional export of each row's statistics.
//
//   O[bh] = softmax(scale * Q[bh] . K[bh]^T, masked) . V[bh]
//   M[bh, i] = running max of row i, L[bh, i] = its denominator (raw)
//
// Replaces, for 128 < D <= 256, the JAX package's Pallas kernels
// `_flash_fwd_kernel` (reached through `_flash_fwd`'s pl.pallas_call) and
// `_flash_fwd_stats_kernel` (through `flash_attention_stats`), both in
// parsec_tpu/ops/pallas_kernels.py, whose BlockSpecs take any head width.
// The tuned kernels of flash_attention.cu (fp32) and
// flash_attention_bf16.cu (bf16, tensor cores) take D <= 128; the wrapper
// (parsec_tpu_torch/ops/kernels.py) sends wider heads here.  One kernel,
// templated on the element type and the mask, serves both types and both
// entry points of each (the statistics are written when M and L are
// given): ptt_flash_fwd_wide_f32 and ptt_flash_fwd_wide_bf16.
//
// Arithmetic kept from the Pallas kernel: the score is (q . k) * scale,
// summed in fp32 over d ascending; a masked score is -1e30 (not -inf)
// with the local-index causal mask (row i sees keys 0..i, also when
// T != Tk); a key past Tk adds exactly nothing; m starts at -1e30 and l
// at 0, and each key tile rescales by exp(m_prev - m_new); at bf16 p is
// rounded to bf16 (nearest even) before P . V, the Pallas kernel's
// p.astype(v.dtype), while l sums the unrounded p; o = acc / l with
// l == 0 -> 1 on o only, rounded once to the element type; m and l are
// exported raw in fp32.  exp is expf (not __expf).
//
// What bounds it.  At the path's shape ([1, 8, 8192, 256], causal) the
// work is 4 D flops for each visible (query, key) pair, 275 GFLOP, over
// Q, K, V and O, 268 MB at fp32: the 67 TFLOP/s fp32 rate of an H100 SXM
// outside the tensor cores bounds this kernel (4.1 ms), far above its
// 3.35 TB/s memory (0.08 ms).  At bf16 the card's bound is the tensor
// cores' 989 TFLOP/s (0.28 ms), which this CUDA-core kernel does not use:
// it sums on fp32 FMA at either type, tensor cores for bf16 being later
// work (ROADMAP Queue 2(b)).
//
// What the design does about it.  The TPU kernel walks key blocks along a
// sequential grid axis with m, l and acc in VMEM scratch.  Here one block
// of 8 warps owns 64 query rows of one (b, h) and loops over 64-key tiles
// itself; m, l and the fp32 accumulator stay in registers for the whole
// loop.  Each warp owns 8 rows, a half warp of 16 lanes a row, and a lane
// holds 4 rows x 4 keys of the score tile (rows wr + 2 i, keys tx + 16 j)
// and the same 4 rows x 16 columns of the output (columns 4 (tx + 16 g)
// .. + 3), so a row's max, sum and rescale stay inside its half warp.
// Both products read float4 along their reduction: 64 FMAs per 8 loads
// for Q . K^T, 256 per 20 for P . V (the two half warps read the same V
// addresses).  Q, K and V tiles at D = 256 take 200 KB of shared memory,
// so there is one stage of each: K of tile t + 1 is copied while tile t's
// softmax and P . V run, V of tile t + 1 while the next scores do; at
// bf16 the copies are plain loads, widened to fp32 as they are stored.
// The causal loop ends at the tile's last row, a warp whose rows all lie
// above a tile's first key skips that tile's arithmetic (its p would be 0
// and its rescale 1, exactly), P . V stops at the warp's last row, and
// the heaviest query tiles are issued first.  D is any value up to 256 at
// run time; columns past D are skipped whole where a lane has none.
//
// Measured: chip_smoke.py's `[ptxas]` lines (registers, spills) and its
// `[timing] instance=` lines (cudaFuncGetAttributes through
// ptt_flash_fwd_wide_attributes); its time at the path's shape is the
// timing phase's, PERF.md keeps them.
#include "flash_wide.cuh"

namespace {

using namespace ptt_wide;

constexpr int WARPS = THREADS / 32;  // 8
constexpr int TX = 16;               // lanes sharing a row (a half warp)
constexpr int RM = 4;                // rows per lane: wr + 2 i
constexpr int BQ = WARPS * 2 * RM;   // query rows per block: 64
constexpr int BK = 64;               // keys per tile
constexpr int CN = BK / TX;          // keys per lane: tx + 16 j
constexpr int NG = D_MAX / (4 * TX); // float4 output columns per lane: 4
constexpr int PS = BK + 16;          // row stride of the probability tile:
                                     // the two rows a warp writes at once
                                     // land 16 banks apart

// Q, K, V [BQ or BK][ds] and P [BQ][PS]: 220160 bytes at D = 256
size_t smem_bytes(int d) {
  return (static_cast<size_t>(BQ + 2 * BK) * row_stride(d) + BQ * PS) *
         sizeof(float);
}

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wide_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                      const T* __restrict__ V, T* __restrict__ O,
                      float* __restrict__ Mout, float* __restrict__ Lout,
                      int Tq, int Tk, int D, float scale, int aligned_in,
                      int aligned_out) {
  const int ds = row_stride(D);
  const int dv = (D + 3) / 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][ds]
  float* Ks = Qs + BQ * ds;                      // [BK][ds]
  float* Vs = Ks + BK * ds;                      // [BK][ds]
  float* Ps = Vs + BK * ds;                      // [BQ][PS]

  const long long bh = blockIdx.x;
  const int qt = CAUSAL ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * BQ;
  Q += bh * Tq * D;
  O += bh * Tq * D;
  K += bh * Tk * D;
  V += bh * Tk * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = lane & (TX - 1);
  const int wr = warp * 2 * RM + (lane >> 4);   // local rows wr + 2 i

  const int rows_end = min(Tq, q0 + BQ);
  const int kend = CAUSAL ? min(Tk, rows_end) : Tk;
  const int ntiles = (kend + BK - 1) / BK;
  const int warp_last_row = q0 + warp * 2 * RM + 2 * RM - 1;
  const bool al = aligned_in != 0;

  // copy groups in order: Q and K_0, V_0, then for each tile t: K_{t+1}
  // (after tile t's scores), V_{t+1} (after its P . V)
  load_rows<BQ>(Qs, Q, q0, Tq, D, ds, al);
  load_rows<BK>(Ks, K, 0, Tk, D, ds, al);
  cp_async_commit();
  load_rows<BK>(Vs, V, 0, Tk, D, ds, al);
  cp_async_commit();

  float m[RM], l[RM], acc[RM][4 * NG];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    // every key of this tile lies above every row of the warp: each p is
    // exactly 0 and each rescale exactly 1, so the tile changes nothing
    const bool skip = CAUSAL && k0 > warp_last_row;
    cp_async_wait<1>();   // K_t (and Q) landed; V_t may be in flight
    __syncthreads();

    // s = Q . K^T over this tile: rows wr + 2 i, keys tx + 16 j
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    if (!skip) {
#pragma unroll 2
      for (int d4 = 0; d4 < dv; ++d4) {
        float4 qa[RM], kb[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) qa[i] = ld4(Qs + (wr + 2 * i) * ds + 4 * d4);
#pragma unroll
        for (int j = 0; j < CN; ++j) kb[j] = ld4(Ks + (tx + j * TX) * ds + 4 * d4);
        // d = 4 d4 + c ascending for every score
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j)
              s[i][j] = fmaf(part(qa[i], c), part(kb[j], c), s[i][j]);
      }
    }
    __syncthreads();   // every warp is done with K_t
    if (t + 1 < ntiles) load_rows<BK>(Ks, K, k0 + BK, Tk, D, ds, al);
    cp_async_commit();

    if (!skip) {
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
          const float p =
              (k0 + tx + j * TX < Tk) ? expf(s[i][j] - mx) : 0.f;
          Ps[(wr + 2 * i) * PS + tx + j * TX] = round_to(p, T{});
          rs += p;
        }
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        const float corr = expf(m[i] - mx);
        l[i] = l[i] * corr + rs;
        m[i] = mx;
#pragma unroll
        for (int j = 0; j < 4 * NG; ++j) acc[i][j] *= corr;
      }
    }
    cp_async_wait<1>();   // V_t landed; K_{t+1} may be in flight
    __syncthreads();      // ... for every thread, and P is written

    if (!skip) {
      // acc += P . V: rows wr + 2 i, columns 4 (tx + 16 g) .. + 3.  Keys
      // past Tk (up to the next multiple of 4) have p = 0 and zero-filled
      // V, and causal keys past the warp's last row p = 0 (every row has
      // seen key 0, so its max is a real score): the loop stops there,
      // which changes nothing
      const int kn =
          min(CAUSAL ? min(BK, warp_last_row + 1 - k0) : BK, Tk - k0);
      const int kn4 = (kn + 3) / 4;
#pragma unroll 2
      for (int k4 = 0; k4 < kn4; ++k4) {
        float4 pa[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          pa[i] = ld4(Ps + (wr + 2 * i) * PS + 4 * k4);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int c = 4 * (tx + g * TX);
          if (c >= D) continue;
          const float* vr = Vs + 4 * k4 * ds + c;
          // kk = 4 k4 + e ascending for every output
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 ve = ld4(vr + e * ds);
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
    __syncthreads();   // every warp is done with V_t
    if (t + 1 < ntiles) load_rows<BK>(Vs, V, k0 + BK, Tk, D, ds, al);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + wr + 2 * i;
    if (r >= Tq) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    T* orow = O + static_cast<long long>(r) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = 4 * (tx + g * TX);
      if (c >= D) continue;
      store4(orow, c, D,
             make_float4(acc[i][4 * g] / lsafe, acc[i][4 * g + 1] / lsafe,
                         acc[i][4 * g + 2] / lsafe,
                         acc[i][4 * g + 3] / lsafe),
             aligned_out != 0);
    }
    if (Mout != nullptr && tx == 0) {
      Mout[bh * Tq + r] = m[i];
      Lout[bh * Tq + r] = l[i];
    }
  }
}

template <typename T, bool CAUSAL>
int launch(const T* q, const T* k, const T* v, T* o, float* m, float* l,
           int bh, int Tq, int Tk, int D, float scale, cudaStream_t stream) {
  const auto kernel = flash_fwd_wide_kernel<T, CAUSAL>;
  const size_t smem = smem_bytes(D);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool in = aligned_operand<T>(q, D) && aligned_operand<T>(k, D) &&
                  aligned_operand<T>(v, D);
  // o's float4 stores (fp32): rows of D % 4 == 0 on a 16-byte base
  const bool out = D % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(o) % 16 == 0;
  // heaviest query tiles first: y is reversed in the kernel, and blocks
  // are issued x (the bh slice) fastest
  const dim3 grid(bh, (Tq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, m, l, Tq, Tk, D, scale,
                                          in, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, float* m, float* l,
             int bh, int Tq, int Tk, int D, int causal, float scale,
             void* stream) {
  if (bh < 1 || bh > 65535 || Tq < 1 || Tk < 1 || D < 1 || D > D_MAX ||
      (Tq + BQ - 1) / BQ > 65535 || (m == nullptr) != (l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? launch<T, true>(q, k, v, o, m, l, bh, Tq, Tk, D, scale, s)
                : launch<T, false>(q, k, v, o, m, l, bh, Tq, Tk, D, scale, s);
}

struct Instance {
  const void* fn;
  const char* name;
};

const Instance kInstances[] = {
    {reinterpret_cast<const void*>(flash_fwd_wide_kernel<float, true>),
     "flash_fwd_wide_kernel<float,causal=true>"},
    {reinterpret_cast<const void*>(flash_fwd_wide_kernel<float, false>),
     "flash_fwd_wide_kernel<float,causal=false>"},
    {reinterpret_cast<const void*>(flash_fwd_wide_kernel<__nv_bfloat16, true>),
     "flash_fwd_wide_kernel<bf16,causal=true>"},
    {reinterpret_cast<const void*>(
         flash_fwd_wide_kernel<__nv_bfloat16, false>),
     "flash_fwd_wide_kernel<bf16,causal=false>"}};

}  // namespace

extern "C" {

// O = attention(Q, K, V) for bh (batch x head) slices, row-major: Q and O
// [bh, T, D], K and V [bh, Tk, D], fp32; 1 <= D <= 256, bh <= 65535.
// With M and L (both or neither; [bh, T] fp32) each row's raw running max
// and denominator are written too.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int ptt_flash_fwd_wide_f32(const float* q, const float* k, const float* v,
                           float* o, float* m, float* l, int bh, int T,
                           int Tk, int D, int causal, float scale,
                           void* stream) {
  return dispatch(q, k, v, o, m, l, bh, T, Tk, D, causal, scale, stream);
}

// As ptt_flash_fwd_wide_f32 with bf16 Q, K, V and O (m and l fp32).
int ptt_flash_fwd_wide_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, __nv_bfloat16* o,
                            float* m, float* l, int bh, int T, int Tk,
                            int D, int causal, float scale, void* stream) {
  return dispatch(q, k, v, o, m, l, bh, T, Tk, D, causal, scale, stream);
}

// Instance i of the library: its name and, in out[0..4], registers a
// thread, local (spill) bytes a thread, static shared bytes, dynamic
// shared bytes at D = 256, resident blocks an SM at that size.  Returns
// 0, -1 past the last instance, or a cudaError_t.
int ptt_flash_fwd_wide_attributes(int i, int* out, const char** name) {
  if (i < 0 ||
      i >= static_cast<int>(sizeof(kInstances) / sizeof(kInstances[0])))
    return -1;
  const Instance& inst = kInstances[i];
  const int smem = static_cast<int>(smem_bytes(D_MAX));
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, inst.fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inst.fn,
                                                        THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = smem;
  out[4] = per_sm;
  *name = inst.name;
  return 0;
}

const char* ptt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
