// Contextual-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces sketchedit_tpu/ops/attention_pallas.py::_attn_kernel (launched by
// _attention_core_raw). For each batch b and query row i:
//
//   logit_ij = keep_bj * scale * sum_d Q_bid K_bjd kscale_bd   (real j < P)
//   O_bi     = sum_j softmax_j(logit_i) V_bj,   lse_bi = logsumexp_j logit_ij
//
// kscale is a per-channel scale of the keys (the background's inverse L2
// norm on the main path, which passes K = V, so the keys are formed in
// float32 here as attention_pallas.py::_attn_shared_kernel forms them); it
// is applied to the staged Q chunk, the smaller of the two.
// A gated key (keep = 0) gets logit 0, not -inf: it still adds exp(0) to the
// denominator, so an all-gated row gives the uniform mean of V. Ragged N, P
// and D are handled by bounds checks inside the kernel, never by padded
// copies. Inputs are float32 or bfloat16; all arithmetic is float32 on the
// CUDA cores (no TF32, no tensor cores), and O is written in the input type
// or, for bfloat16 inputs, in float32 when the caller asks.
//
// What bounds it on an H100. At 256^2, B = 1 (N = P = 961, D = 1536) the two
// products are 5.67 GFLOP against 11.8 MB of float32 traffic (V, read as
// Q, K and V, and the output), so the work is arithmetic: ~85 us at the
// SXM's 67 TFLOP/s of float32 against ~4 us of memory time. In bfloat16
// the tensor cores would make it ~6 us, which this first kernel does not
// try for.
//
// Design. The TPU kernel keeps a (TQ, 1536) float32 accumulator in VMEM. On
// Hopper 64 such rows (384 KB) exceed the 227 KB of shared memory a block
// may use, so each block takes a small tile of TQ = 16 query rows (8 when
// 16-row tiles would leave SMs idle, as at 256^2 with B = 1) and keeps their
// full-width float32 accumulator in dynamic shared memory (96 KB at D = 1536
// and TQ = 16). It walks the keys in tiles of kTK = 64. S = Q K^T for a tile
// is built from kDC-wide D-chunks of Q and K staged in shared memory (the
// next chunk is loaded into registers while the current one is multiplied),
// with register micro-tiles so that each shared-memory load feeds several
// FMAs. The online softmax (running max and sum per row, in registers) turns
// S into P, and acc = acc * alpha + P V streams V straight from global
// memory. S is never recomputed. Every block re-reads K and V once; one
// image's K and V (11.8 MB in float32) stay in the 50 MB L2. Two 16-row
// blocks fit on an SM (~112 KB of shared memory each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTK = 64;                 // keys per tile
constexpr int kSS = kTK + 1;            // row stride of the S tile
constexpr int kDG = 4;                  // D-groups splitting a chunk in S
constexpr int kKPT = 4;                 // keys per thread in S
constexpr size_t kMaxSmem = 232448;     // opt-in limit per block on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// Per tile height TQ: the D-chunk staged per step (kDC), its padded row
// stride (kSD), the columns a thread carries at once in P V (kNC), and
// the blocks per SM the register budget is cut for: 8-row tiles are chosen
// when the grid is smaller than the SM count, so they run one per SM.
template <int TQ> struct Tile {
  static constexpr int kDC = TQ == 8 ? 64 : 32;
  static constexpr int kSD = kDC + 4;
  static constexpr int kNC = TQ == 8 ? 3 : 2;   // D = 1536 in whole passes
  static constexpr int kMinBlocks = TQ == 8 ? 1 : 2;
};

template <int TQ>
size_t smem_bytes(int D) {
  constexpr int kSD = Tile<TQ>::kSD;
  return sizeof(float) * ((size_t)TQ * D + TQ * kSD + kTK * kSD + kTK * TQ +
                          2 * TQ);
}

// One block: TQ query rows of one image, all keys, all of D.
//
// S phase: a warp pair owns RPT = TQ/4 rows and all 64 keys of the tile;
// each thread accumulates an RPT x 4 micro-tile (keys kg + 16 j) over its
// quarter of every staged D-chunk (its D-group g), and the four D-groups of
// a warp are summed with shuffles. The next chunk is loaded into registers
// while the current one is multiplied.
// Softmax phase: TPR = 256/TQ consecutive lanes share a row.
// P V phase: each thread owns columns tid + 256 c of every row.
template <typename T, typename TO, int TQ>
__global__ void __launch_bounds__(kThreads, Tile<TQ>::kMinBlocks)
ca_fwd_kernel(const T* Q, const T* K, const T* V, const float* keep,
              const float* kscale, TO* O, float* lse, int N, int P, int D,
              float scale) {
  constexpr int kDC = Tile<TQ>::kDC;
  constexpr int kSD = Tile<TQ>::kSD;
  constexpr int kNC = Tile<TQ>::kNC;
  constexpr int RPT = TQ / 4;
  constexpr int TPR = kThreads / TQ;
  constexpr int KPS = kTK / TPR;               // keys per thread in softmax
  constexpr int QLD = TQ * kDC / kThreads;     // staged Q values per thread
  constexpr int KLD = kTK * kDC / kThreads;    // staged K values per thread

  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                       // [TQ][D]
  float* qs = acc + (size_t)TQ * D;        // [TQ][kSD]
  float* ks = qs + TQ * kSD;               // [kTK][kSD]; S tile [TQ][kSS]
  float* ps = ks + kTK * kSD;              // [kTK][TQ]  (P transposed)
  float* alpha_s = ps + kTK * TQ;          // [TQ]
  float* l_s = alpha_s + TQ;               // [TQ]
  float* ss = ks;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const T* Vb = V + (size_t)b * P * D;
  const float* keep_b = keep + (size_t)b * P;
  const float* kscale_b = kscale + (size_t)b * D;

  for (int i = tid; i < TQ * D; i += kThreads) acc[i] = 0.f;

  const int lane = tid & 31;
  const int g = lane >> 3;                         // D-group
  const int rg = (tid >> 5) >> 1;                  // row group
  const int kg = (((tid >> 5) & 1) << 3) | (lane & 7);   // key group
  const int r = tid / TPR;                         // softmax row
  const int jg = tid % TPR;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < P; k0 += kTK) {
    // One D-chunk of Q, kscale and K, loaded raw into registers: no
    // arithmetic waits on these loads, so they stay in flight while the
    // previous chunk is multiplied. Out of range -> 0.
    T qraw[QLD], kraw[KLD];
    float qsc[QLD];
    auto load_chunk = [&](int c0) {
#pragma unroll
      for (int n = 0; n < QLD; ++n) {
        const int i = tid + n * kThreads, q = q0 + i / kDC, d = c0 + i % kDC;
        const bool in = q < N && d < D;
        qraw[n] = in ? Qb[(size_t)q * D + d] : zero<T>();
        qsc[n] = in ? kscale_b[d] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < KLD; ++n) {
        const int i = tid + n * kThreads, j = k0 + i / kDC, d = c0 + i % kDC;
        kraw[n] = (j < P && d < D) ? Kb[(size_t)j * D + d] : zero<T>();
      }
    };
    load_chunk(0);

    float s[RPT][kKPT];
#pragma unroll
    for (int a = 0; a < RPT; ++a)
#pragma unroll
      for (int c = 0; c < kKPT; ++c) s[a][c] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();  // the previous chunk (and tile) is done with smem
#pragma unroll
      for (int n = 0; n < QLD; ++n) {
        const int i = tid + n * kThreads;
        qs[(i / kDC) * kSD + i % kDC] = to_f(qraw[n]) * qsc[n];
      }
#pragma unroll
      for (int n = 0; n < KLD; ++n) {
        const int i = tid + n * kThreads;
        ks[(i / kDC) * kSD + i % kDC] = to_f(kraw[n]);
      }
      __syncthreads();
      if (d0 + kDC < D) load_chunk(d0 + kDC);  // next chunk, while this one runs
#pragma unroll
      for (int dd = 0; dd < kDC / kDG; dd += 4) {
        const int d = g * (kDC / kDG) + dd;
        float4 qv[RPT], kv[kKPT];
#pragma unroll
        for (int a = 0; a < RPT; ++a)
          qv[a] = *reinterpret_cast<const float4*>(qs + (rg * RPT + a) * kSD + d);
#pragma unroll
        for (int c = 0; c < kKPT; ++c)
          kv[c] = *reinterpret_cast<const float4*>(ks + (kg + 16 * c) * kSD + d);
#pragma unroll
        for (int a = 0; a < RPT; ++a)
#pragma unroll
          for (int c = 0; c < kKPT; ++c) {
            s[a][c] = fmaf(qv[a].x, kv[c].x, s[a][c]);
            s[a][c] = fmaf(qv[a].y, kv[c].y, s[a][c]);
            s[a][c] = fmaf(qv[a].z, kv[c].z, s[a][c]);
            s[a][c] = fmaf(qv[a].w, kv[c].w, s[a][c]);
          }
      }
    }
    // Sum the four D-groups of the warp (lane bits 3 and 4).
#pragma unroll
    for (int a = 0; a < RPT; ++a)
#pragma unroll
      for (int c = 0; c < kKPT; ++c) {
        s[a][c] += __shfl_xor_sync(0xffffffffu, s[a][c], 8);
        s[a][c] += __shfl_xor_sync(0xffffffffu, s[a][c], 16);
      }
    __syncthreads();  // every thread is done reading ks: reuse it for S
    if (g == 0) {
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < kKPT; ++c)
          ss[(rg * RPT + a) * kSS + kg + 16 * c] = s[a][c];
    }
    __syncthreads();

    // Online softmax over this tile. Padded keys (j >= P) get -inf; a tile
    // always holds at least one real key, so the running max is finite.
    float logit[KPS];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KPS; ++i) {
      const int jj = jg + i * TPR, j = k0 + jj;
      logit[i] = (j < P) ? ss[r * kSS + jj] * keep_b[j] * scale : -INFINITY;
      mx = fmaxf(mx, logit[i]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPS; ++i) {
      const float p = expf(logit[i] - m_new);
      ps[(jg + i * TPR) * TQ + r] = p;
      psum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    if (jg == 0) alpha_s[r] = alpha;
    __syncthreads();

    // acc = acc * alpha + P V. Each thread owns columns tid + kThreads * c of
    // every row, kNC at a time; the accumulator is private to its owner, so
    // only P and alpha need the barrier above.
    const int kn = min(kTK, P - k0);
    for (int c0 = tid; c0 < D; c0 += kNC * kThreads) {
      float a[kNC][TQ];
      bool has[kNC];
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int col = c0 + c * kThreads;
        has[c] = col < D;
#pragma unroll
        for (int rr = 0; rr < TQ; ++rr)
          a[c][rr] = has[c] ? acc[rr * D + col] * alpha_s[rr] : 0.f;
      }
      const T* vrow = Vb + (size_t)k0 * D + c0;
#pragma unroll 4
      for (int jj = 0; jj < kn; ++jj) {
        float v[kNC];
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          v[c] = has[c] ? to_f(vrow[(size_t)jj * D + c * kThreads]) : 0.f;
        const float4* p4 = reinterpret_cast<const float4*>(ps + jj * TQ);
#pragma unroll
        for (int q4 = 0; q4 < TQ / 4; ++q4) {
          const float4 p = p4[q4];
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            a[c][4 * q4 + 0] = fmaf(p.x, v[c], a[c][4 * q4 + 0]);
            a[c][4 * q4 + 1] = fmaf(p.y, v[c], a[c][4 * q4 + 1]);
            a[c][4 * q4 + 2] = fmaf(p.z, v[c], a[c][4 * q4 + 2]);
            a[c][4 * q4 + 3] = fmaf(p.w, v[c], a[c][4 * q4 + 3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int rr = 0; rr < TQ; ++rr)
          if (has[c]) acc[rr * D + c0 + c * kThreads] = a[c][rr];
    }
  }

  if (jg == 0) {
    l_s[r] = l_run;
    if (lse != nullptr && q0 + r < N)
      lse[(size_t)b * N + q0 + r] = m_run + logf(l_run);
  }
  __syncthreads();
  for (int rr = 0; rr < TQ; ++rr) {
    const int q = q0 + rr;
    if (q >= N) break;
    const float inv_l = 1.f / l_s[rr];
    TO* orow = O + ((size_t)b * N + q) * D;
    for (int c = tid; c < D; c += kThreads) store(orow + c, acc[rr * D + c] * inv_l);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 1;
  }
  return count;
}

template <typename T, typename TO, int TQ>
int launch_tq(const void* q, const void* k, const void* v, const float* keep,
              const float* kscale, void* o, float* lse, int B, int N, int P,
              int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TQ>(D);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ca_fwd_kernel<T, TO, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  ca_fwd_kernel<T, TO, TQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), keep, kscale, static_cast<TO*>(o), lse, N, P,
      D, scale);
  return (int)cudaGetLastError();
}

// 16-row tiles, or 8-row tiles when 16-row ones would leave SMs idle (at
// 256^2, B = 1: 61 blocks of 16 rows against 121 of 8 on 132 SMs).
template <typename T, typename TO>
int launch(const void* q, const void* k, const void* v, const float* keep,
           const float* kscale, void* o, float* lse, int B, int N, int P,
           int D, float scale, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || P <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * ((N + 15) / 16) < sm_count())
    return launch_tq<T, TO, 8>(q, k, v, keep, kscale, o, lse, B, N, P, D,
                               scale, stream);
  return launch_tq<T, TO, 16>(q, k, v, keep, kscale, o, lse, B, N, P, D,
                              scale, stream);
}

}  // namespace

extern "C" {

// dtype, out_dtype: 0 = float32, 1 = bfloat16. Q (B,N,D), K and V (B,P,D)
// contiguous in dtype; O (B,N,D) contiguous in out_dtype, which is dtype or
// float32; keep (B,P) float32; kscale (B,D) float32, a per-channel scale of
// the keys; lse (B,N) float32 or NULL.
// Returns the cudaError_t of the launch (0 on success).
int sketchedit_contextual_attention_fwd(int dtype, int out_dtype,
                                        const void* q, const void* k,
                                        const void* v, const void* keep,
                                        const void* kscale, void* o,
                                        void* lse, int B, int N, int P, int D,
                                        float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  const float* keep_f = static_cast<const float*>(keep);
  const float* ks_f = static_cast<const float*>(kscale);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    return launch<float, float>(q, k, v, keep_f, ks_f, o, lse_f, B, N, P, D,
                                scale, s);
  if (dtype == 1 && out_dtype == 1)
    return launch<bf16, bf16>(q, k, v, keep_f, ks_f, o, lse_f, B, N, P, D,
                              scale, s);
  if (dtype == 1 && out_dtype == 0)
    return launch<bf16, float>(q, k, v, keep_f, ks_f, o, lse_f, B, N, P, D,
                               scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* sketchedit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
