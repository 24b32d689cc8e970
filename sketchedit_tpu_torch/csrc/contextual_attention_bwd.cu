// Contextual-attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces sketchedit_tpu/ops/attention_pallas.py::_dq_kernel and
// ::_dkdv_kernel (launched by _attention_core_bwd_pallas). With the keys
// K_eff = K * kscale (per channel, formed in float32 here as in the forward
// kernel), g_j = keep_bj * scale, the forward's logsumexp lse and
// delta_i = rowsum(dO_i * O_i) (a plain reduction done before the launch):
//
//   S_ij  = Q_i . K_eff_j,    P_ij = exp(S_ij g_j - lse_i)   (real j < P)
//   dP_ij = dO_i . V_j,       dS_ij = P_ij (dP_ij - delta_i) g_j
//   dq kernel:   dQ_i     = sum_j dS_ij K_eff_j
//   dkdv kernel: dV_j     = sum_i P_ij dO_i,   dK_eff_j = sum_i dS_ij Q_i
//
// The gate rules are the forward's: keep = 0 gives logit 0 (P = exp(-lse))
// and a zero dS multiplier; keys past P contribute nothing; ragged N, P and
// D are bounds checks, never padded copies. Q, K and V are float32 or
// bfloat16; dO, lse, delta and every output are float32, and all arithmetic
// is float32 on the CUDA cores. dO is not rounded to the input type (the
// JAX package streams it in the input type to halve its DMA): these kernels
// are bound by operations, not bytes, so the rounding would buy nothing.
//
// What bounds them on an H100. At 256^2 (N = P = 961, D = 1536) the dq
// kernel runs three products of N P D multiply-adds (6 N P D = 8.5 GFLOP
// per image, 0.127 ms at the SXM's 67 TFLOP/s of float32) and the dkdv
// kernel four (11.4 GFLOP, 0.169 ms), against ~30 MB of float32 traffic
// (~0.009 ms): both are bound by operations.
//
// Design. Blocks run in parallel, so the sequential axis of each TPU grid
// becomes a loop inside the block, and each block owns its output rows
// outright (no atomics, no second pass):
// - dq: one block per (image, TQ-query tile), TQ = 16, or 8 when 16-row
//   tiles would leave SMs idle. The (TQ, D) float32 dQ accumulator lives in
//   dynamic shared memory (96 KB at TQ = 16, D = 1536). The keys are walked
//   in tiles of kT = 64: S and dP come from the forward's tile product
//   (staged D-chunks, register micro-tiles, a register prefetch of the next
//   chunk); since every lane of a D-group ends with the reduced sums, P and
//   dS are formed in registers and only dS^T goes to shared memory; then
//   dQ += dS K streams K from global memory (one image's K and V stay in
//   the 50 MB L2). kscale is applied to dQ once, at the end.
// - dkdv: one block per (image, R-key tile), R = 16, or 8 when 16-key tiles
//   would leave SMs idle, with two (R, D) float32 accumulators, dK_eff and
//   dV, in shared memory (2 x 96 KB at R = 16, D = 1536), walking the
//   queries in tiles of 64: S^T and dP^T by the same tile product (kscale
//   on the staged Q chunk), P^T and dS^T to shared memory, then
//   dV += P^T dO and dK_eff += dS^T Q in one pass over dO and Q.
//   Every key tile reads all of Q and dO twice, from L2, so
//   the taller tile halves that traffic and gives the tile product twice
//   the multiply-adds per shared-memory load: 16-key tiles took the kernel
//   from 11.0 to 7.8 ms at 256^2, B = 8, float32 on an H100 SXM.
// A dkdv block (8 warps, ~212 KB of shared memory at R = 16) runs alone on
// its SM; the dq blocks at TQ = 16 fit two. The first design is simple and
// right; making it fast (tensor cores, more warps per SM) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;                  // columns of a tile product
constexpr int kDG = 4;                  // D-groups splitting a chunk
constexpr int kCPT = 4;                 // columns per thread in a product
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

// Per row-tile height R: the D-chunk staged per step (kDC), its padded row
// stride (kSD), the columns a thread carries at once in the accumulation
// (kNC), and the blocks per SM the register budget is cut for.
template <int R> struct Tile {
  static constexpr int kDC = R == 8 ? 64 : 32;
  static constexpr int kSD = kDC + 4;
  static constexpr int kNC = R == 8 ? 3 : 2;
  static constexpr int kMinBlocks = R == 8 ? 1 : 2;
};

// s[a][c] = sum_d A[a0 + rg*RPT + a][d] * B[b0 + kg + 16 c][d], with the
// per-channel scale sc on the A rows (kScaled == 1), on the B rows
// (kScaled == 2) or nowhere (0). Rows at or past na (nb) read as 0. A warp
// pair owns RPT = R/4 rows and all kT columns; each thread sums an RPT x 4
// micro-tile over its D-group's quarter of every staged chunk, and the four
// D-groups are summed with shuffles, so every lane ends with the totals.
// as [R][kSD] and bs [kT][kSD] are the staging areas; the function begins
// each chunk with a barrier, so two calls may follow each other.
template <typename TA, typename TB, int R, int kScaled>
__device__ __forceinline__ void tile_dot(const TA* A, int a0, int na,
                                         const TB* B, int b0, int nb,
                                         const float* sc, int D, float* as,
                                         float* bs, float (&s)[R / 4][kCPT]) {
  constexpr int kDC = Tile<R>::kDC;
  constexpr int kSD = Tile<R>::kSD;
  constexpr int RPT = R / 4;
  constexpr int ALD = R * kDC / kThreads;
  constexpr int BLD = kT * kDC / kThreads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 3;
  const int rg = (tid >> 5) >> 1;
  const int kg = (((tid >> 5) & 1) << 3) | (lane & 7);

  TA araw[ALD];
  TB braw[BLD];
  float asc[kScaled == 1 ? ALD : 1];
  float bsc[kScaled == 2 ? BLD : 1];
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int n = 0; n < ALD; ++n) {
      const int i = tid + n * kThreads, r = a0 + i / kDC, d = c0 + i % kDC;
      const bool in = r < na && d < D;
      araw[n] = in ? A[(size_t)r * D + d] : zero<TA>();
      if constexpr (kScaled == 1) asc[n] = in ? sc[d] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < BLD; ++n) {
      const int i = tid + n * kThreads, r = b0 + i / kDC, d = c0 + i % kDC;
      const bool in = r < nb && d < D;
      braw[n] = in ? B[(size_t)r * D + d] : zero<TB>();
      if constexpr (kScaled == 2) bsc[n] = in ? sc[d] : 0.f;
    }
  };
  load_chunk(0);

#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int c = 0; c < kCPT; ++c) s[a][c] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kDC) {
    __syncthreads();  // the previous chunk (or call) is done with as and bs
#pragma unroll
    for (int n = 0; n < ALD; ++n) {
      const int i = tid + n * kThreads;
      float x = to_f(araw[n]);
      if constexpr (kScaled == 1) x *= asc[n];
      as[(i / kDC) * kSD + i % kDC] = x;
    }
#pragma unroll
    for (int n = 0; n < BLD; ++n) {
      const int i = tid + n * kThreads;
      float x = to_f(braw[n]);
      if constexpr (kScaled == 2) x *= bsc[n];
      bs[(i / kDC) * kSD + i % kDC] = x;
    }
    __syncthreads();
    if (d0 + kDC < D) load_chunk(d0 + kDC);  // next chunk, while this one runs
#pragma unroll
    for (int dd = 0; dd < kDC / kDG; dd += 4) {
      const int d = g * (kDC / kDG) + dd;
      float4 av[RPT], bv[kCPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a)
        av[a] = *reinterpret_cast<const float4*>(as + (rg * RPT + a) * kSD + d);
#pragma unroll
      for (int c = 0; c < kCPT; ++c)
        bv[c] = *reinterpret_cast<const float4*>(bs + (kg + 16 * c) * kSD + d);
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          s[a][c] = fmaf(av[a].x, bv[c].x, s[a][c]);
          s[a][c] = fmaf(av[a].y, bv[c].y, s[a][c]);
          s[a][c] = fmaf(av[a].z, bv[c].z, s[a][c]);
          s[a][c] = fmaf(av[a].w, bv[c].w, s[a][c]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < RPT; ++a)
#pragma unroll
    for (int c = 0; c < kCPT; ++c) {
      s[a][c] += __shfl_xor_sync(0xffffffffu, s[a][c], 8);
      s[a][c] += __shfl_xor_sync(0xffffffffu, s[a][c], 16);
    }
}

template <int TQ>
size_t dq_smem_bytes(int D) {
  constexpr int kSD = Tile<TQ>::kSD;
  return sizeof(float) *
         ((size_t)TQ * D + TQ * kSD + kT * kSD + kT * TQ + 2 * TQ);
}

template <int R>
size_t dkdv_smem_bytes(int D) {
  constexpr int kSD = Tile<R>::kSD;
  return sizeof(float) *
         (2 * (size_t)R * D + R * kSD + kT * kSD + 2 * kT * R + 2 * kT);
}

// One block: TQ query rows of one image, all keys, all of D.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads, Tile<TQ>::kMinBlocks)
ca_dq_kernel(const T* Q, const T* K, const T* V, const float* keep,
             const float* kscale, const float* dO, const float* lse,
             const float* delta, float* dQ, int N, int P, int D,
             float scale) {
  constexpr int kSD = Tile<TQ>::kSD;
  constexpr int kNC = Tile<TQ>::kNC;
  constexpr int RPT = TQ / 4;

  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                        // [TQ][D]
  float* as = acc + (size_t)TQ * D;         // [TQ][kSD]
  float* bs = as + TQ * kSD;                // [kT][kSD]
  float* ds_s = bs + kT * kSD;              // [kT][TQ]  (dS transposed)
  float* lse_s = ds_s + kT * TQ;            // [TQ]
  float* delta_s = lse_s + TQ;              // [TQ]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const T* Vb = V + (size_t)b * P * D;
  const float* dOb = dO + (size_t)b * N * D;
  const float* keep_b = keep + (size_t)b * P;
  const float* ks_b = kscale + (size_t)b * D;

  for (int i = tid; i < TQ * D; i += kThreads) acc[i] = 0.f;
  if (tid < TQ) {  // rows past N: lse = delta = 0 (their dS is 0 anyway)
    const bool in = q0 + tid < N;
    lse_s[tid] = in ? lse[(size_t)b * N + q0 + tid] : 0.f;
    delta_s[tid] = in ? delta[(size_t)b * N + q0 + tid] : 0.f;
  }

  const int lane = tid & 31;
  const int g = lane >> 3;
  const int rg = (tid >> 5) >> 1;
  const int kg = (((tid >> 5) & 1) << 3) | (lane & 7);

  for (int k0 = 0; k0 < P; k0 += kT) {
    float s[RPT][kCPT], dp[RPT][kCPT];
    tile_dot<T, T, TQ, 1>(Qb, q0, N, Kb, k0, P, ks_b, D, as, bs, s);
    tile_dot<float, T, TQ, 0>(dOb, q0, N, Vb, k0, P, nullptr, D, as, bs, dp);
    if (g == 0) {
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          const int r = rg * RPT + a, jj = kg + 16 * c, j = k0 + jj;
          float ds = 0.f;
          if (j < P) {
            const float gm = keep_b[j] * scale;
            const float p = expf(s[a][c] * gm - lse_s[r]);
            ds = p * (dp[a][c] - delta_s[r]) * gm;
          }
          ds_s[jj * TQ + r] = ds;
        }
    }
    __syncthreads();

    // acc += dS K. Each thread owns columns tid + kThreads * c of every row,
    // kNC at a time, so only dS needs the barrier above.
    const int kn = min(kT, P - k0);
    for (int c0 = tid; c0 < D; c0 += kNC * kThreads) {
      float a_[kNC][TQ];
      bool has[kNC];
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int col = c0 + c * kThreads;
        has[c] = col < D;
#pragma unroll
        for (int rr = 0; rr < TQ; ++rr)
          a_[c][rr] = has[c] ? acc[rr * D + col] : 0.f;
      }
      const T* krow = Kb + (size_t)k0 * D + c0;
#pragma unroll 4
      for (int jj = 0; jj < kn; ++jj) {
        float kv[kNC];
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          kv[c] = has[c] ? to_f(krow[(size_t)jj * D + c * kThreads]) : 0.f;
        const float4* d4 = reinterpret_cast<const float4*>(ds_s + jj * TQ);
#pragma unroll
        for (int q4 = 0; q4 < TQ / 4; ++q4) {
          const float4 w = d4[q4];
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            a_[c][4 * q4 + 0] = fmaf(w.x, kv[c], a_[c][4 * q4 + 0]);
            a_[c][4 * q4 + 1] = fmaf(w.y, kv[c], a_[c][4 * q4 + 1]);
            a_[c][4 * q4 + 2] = fmaf(w.z, kv[c], a_[c][4 * q4 + 2]);
            a_[c][4 * q4 + 3] = fmaf(w.w, kv[c], a_[c][4 * q4 + 3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int rr = 0; rr < TQ; ++rr)
          if (has[c]) acc[rr * D + c0 + c * kThreads] = a_[c][rr];
    }
  }

  // dQ = acc * kscale; each thread writes the columns it accumulated.
  for (int rr = 0; rr < TQ; ++rr) {
    const int q = q0 + rr;
    if (q >= N) break;
    float* orow = dQ + ((size_t)b * N + q) * D;
    for (int c = tid; c < D; c += kThreads) orow[c] = acc[rr * D + c] * ks_b[c];
  }
}

// One block: R key rows of one image, all queries, all of D.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
ca_dkdv_kernel(const T* Q, const T* K, const T* V, const float* keep,
               const float* kscale, const float* dO, const float* lse,
               const float* delta, float* dK, float* dV, int N, int P, int D,
               float scale) {
  constexpr int kSD = Tile<R>::kSD;
  constexpr int kNC = Tile<R>::kNC;
  constexpr int RPT = R / 4;

  extern __shared__ __align__(16) float smem[];
  float* dk_acc = smem;                     // [R][D]
  float* dv_acc = dk_acc + (size_t)R * D;   // [R][D]
  float* as = dv_acc + (size_t)R * D;       // [R][kSD]
  float* bs = as + R * kSD;                 // [kT][kSD]
  float* p_s = bs + kT * kSD;               // [kT][R]  (P transposed)
  float* ds_s = p_s + kT * R;               // [kT][R]  (dS transposed)
  float* lse_s = ds_s + kT * R;             // [kT]
  float* delta_s = lse_s + kT;              // [kT]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * R;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const T* Vb = V + (size_t)b * P * D;
  const float* dOb = dO + (size_t)b * N * D;
  const float* keep_b = keep + (size_t)b * P;
  const float* ks_b = kscale + (size_t)b * D;

  for (int i = tid; i < 2 * R * D; i += kThreads) dk_acc[i] = 0.f;

  const int lane = tid & 31;
  const int g = lane >> 3;
  const int rg = (tid >> 5) >> 1;
  const int kg = (((tid >> 5) & 1) << 3) | (lane & 7);

  for (int i0 = 0; i0 < N; i0 += kT) {
    // visible after the first barrier of tile_dot; the previous tile's
    // readers passed the barrier before its accumulation
    if (tid < kT) {
      const int i = i0 + tid;
      const bool in = i < N;
      lse_s[tid] = in ? lse[(size_t)b * N + i] : 0.f;
      delta_s[tid] = in ? delta[(size_t)b * N + i] : 0.f;
    }
    float s[RPT][kCPT], dp[RPT][kCPT];
    tile_dot<T, T, R, 2>(Kb, j0, P, Qb, i0, N, ks_b, D, as, bs, s);
    tile_dot<T, float, R, 0>(Vb, j0, P, dOb, i0, N, nullptr, D, as, bs, dp);
    if (g == 0) {
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          const int r = rg * RPT + a, j = j0 + r;     // key
          const int ii = kg + 16 * c, i = i0 + ii;    // query
          float p = 0.f, ds = 0.f;
          if (j < P && i < N) {
            const float gm = keep_b[j] * scale;
            p = expf(s[a][c] * gm - lse_s[ii]);
            ds = p * (dp[a][c] - delta_s[ii]) * gm;
          }
          p_s[ii * R + r] = p;
          ds_s[ii * R + r] = ds;
        }
    }
    __syncthreads();

    // dV += P^T dO and dK_eff += dS^T Q, one pass over this tile's queries.
    const int qn = min(kT, N - i0);
    for (int c0 = tid; c0 < D; c0 += kNC * kThreads) {
      float av[kNC][R], ak[kNC][R];
      bool has[kNC];
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int col = c0 + c * kThreads;
        has[c] = col < D;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          av[c][rr] = has[c] ? dv_acc[rr * D + col] : 0.f;
          ak[c][rr] = has[c] ? dk_acc[rr * D + col] : 0.f;
        }
      }
      const float* orow = dOb + (size_t)i0 * D + c0;
      const T* qrow = Qb + (size_t)i0 * D + c0;
#pragma unroll 2
      for (int ii = 0; ii < qn; ++ii) {
        float o[kNC], q[kNC];
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          o[c] = has[c] ? orow[(size_t)ii * D + c * kThreads] : 0.f;
          q[c] = has[c] ? to_f(qrow[(size_t)ii * D + c * kThreads]) : 0.f;
        }
        const float4* p4 = reinterpret_cast<const float4*>(p_s + ii * R);
        const float4* d4 = reinterpret_cast<const float4*>(ds_s + ii * R);
#pragma unroll
        for (int r4 = 0; r4 < R / 4; ++r4) {
          const float4 pw = p4[r4];
          const float4 dw = d4[r4];
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            av[c][4 * r4 + 0] = fmaf(pw.x, o[c], av[c][4 * r4 + 0]);
            av[c][4 * r4 + 1] = fmaf(pw.y, o[c], av[c][4 * r4 + 1]);
            av[c][4 * r4 + 2] = fmaf(pw.z, o[c], av[c][4 * r4 + 2]);
            av[c][4 * r4 + 3] = fmaf(pw.w, o[c], av[c][4 * r4 + 3]);
            ak[c][4 * r4 + 0] = fmaf(dw.x, q[c], ak[c][4 * r4 + 0]);
            ak[c][4 * r4 + 1] = fmaf(dw.y, q[c], ak[c][4 * r4 + 1]);
            ak[c][4 * r4 + 2] = fmaf(dw.z, q[c], ak[c][4 * r4 + 2]);
            ak[c][4 * r4 + 3] = fmaf(dw.w, q[c], ak[c][4 * r4 + 3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          if (has[c]) {
            dv_acc[rr * D + c0 + c * kThreads] = av[c][rr];
            dk_acc[rr * D + c0 + c * kThreads] = ak[c][rr];
          }
    }
  }

  for (int rr = 0; rr < R; ++rr) {
    const int j = j0 + rr;
    if (j >= P) break;
    float* krow = dK + ((size_t)b * P + j) * D;
    float* vrow = dV + ((size_t)b * P + j) * D;
    for (int c = tid; c < D; c += kThreads) {
      krow[c] = dk_acc[rr * D + c];
      vrow[c] = dv_acc[rr * D + c];
    }
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

template <typename T, int TQ>
int launch_dq_tq(const void* q, const void* k, const void* v,
                 const float* keep, const float* kscale, const float* dO,
                 const float* lse, const float* delta, float* dq, int B,
                 int N, int P, int D, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<TQ>(D);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ca_dq_kernel<T, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TQ - 1) / TQ, B);
  ca_dq_kernel<T, TQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), keep, kscale, dO, lse, delta, dq, N, P, D,
      scale);
  return (int)cudaGetLastError();
}

// 16-row tiles, or 8-row tiles when 16-row ones would leave SMs idle (the
// forward kernel's rule).
template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const float* keep,
              const float* kscale, const float* dO, const float* lse,
              const float* delta, float* dq, int B, int N, int P, int D,
              float scale, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || P <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * ((N + 15) / 16) < sm_count())
    return launch_dq_tq<T, 8>(q, k, v, keep, kscale, dO, lse, delta, dq, B, N,
                              P, D, scale, stream);
  return launch_dq_tq<T, 16>(q, k, v, keep, kscale, dO, lse, delta, dq, B, N,
                             P, D, scale, stream);
}

template <typename T, int R>
int launch_dkdv_r(const void* q, const void* k, const void* v,
                  const float* keep, const float* kscale, const float* dO,
                  const float* lse, const float* delta, float* dk, float* dv,
                  int B, int N, int P, int D, float scale,
                  cudaStream_t stream) {
  const size_t smem = dkdv_smem_bytes<R>(D);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ca_dkdv_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + R - 1) / R, B);
  ca_dkdv_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), keep, kscale, dO, lse, delta, dk, dv, N, P, D,
      scale);
  return (int)cudaGetLastError();
}

// 16-key tiles, which read Q and dO half as often as 8-key ones, when they
// fill every SM and their accumulators fit; 8-key tiles otherwise.
template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const float* keep, const float* kscale, const float* dO,
                const float* lse, const float* delta, float* dk, float* dv,
                int B, int N, int P, int D, float scale, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || P <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * ((P + 15) / 16) >= sm_count() &&
      dkdv_smem_bytes<16>(D) <= kMaxSmem)
    return launch_dkdv_r<T, 16>(q, k, v, keep, kscale, dO, lse, delta, dk, dv,
                                B, N, P, D, scale, stream);
  return launch_dkdv_r<T, 8>(q, k, v, keep, kscale, dO, lse, delta, dk, dv, B,
                             N, P, D, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for Q (B,N,D), K and V (B,P,D), all
// contiguous. keep (B,P), kscale (B,D), dO (B,N,D), lse and delta (B,N):
// float32. Outputs float32: dQ (B,N,D); dK_eff and dV (B,P,D).
// Each returns the cudaError_t of its launch (0 on success).
int sketchedit_contextual_attention_dq(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* keep, const void* kscale,
                                       const void* dO, const void* lse,
                                       const void* delta, void* dq, int B,
                                       int N, int P, int D, float scale,
                                       void* stream) {
  const float* keep_f = static_cast<const float*>(keep);
  const float* ks_f = static_cast<const float*>(kscale);
  const float* do_f = static_cast<const float*>(dO);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  float* dq_f = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, keep_f, ks_f, do_f, lse_f, delta_f, dq_f,
                            B, N, P, D, scale, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, keep_f, ks_f, do_f, lse_f,
                                    delta_f, dq_f, B, N, P, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

int sketchedit_contextual_attention_dkdv(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* keep, const void* kscale,
                                         const void* dO, const void* lse,
                                         const void* delta, void* dk,
                                         void* dv, int B, int N, int P, int D,
                                         float scale, void* stream) {
  const float* keep_f = static_cast<const float*>(keep);
  const float* ks_f = static_cast<const float*>(kscale);
  const float* do_f = static_cast<const float*>(dO);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  float* dk_f = static_cast<float*>(dk);
  float* dv_f = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkdv<float>(q, k, v, keep_f, ks_f, do_f, lse_f, delta_f,
                              dk_f, dv_f, B, N, P, D, scale, s);
  if (dtype == 1)
    return launch_dkdv<__nv_bfloat16>(q, k, v, keep_f, ks_f, do_f, lse_f,
                                      delta_f, dk_f, dv_f, B, N, P, D, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}

const char* sketchedit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
