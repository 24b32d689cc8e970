// Contextual-attention backward for Hopper (sm_90a), CUDA C++: four kernels.
//
// Replaces sketchedit_tpu/ops/attention_pallas.py::_dq_kernel,
// ::_dkdv_kernel, ::_dv_kernel and ::_dk_kernel (all launched by
// _attention_core_bwd_pallas). With the keys K_eff = K * kscale (per
// channel, formed in float32 here as in the forward kernels),
// g_j = keep_bj * scale, the forward's logsumexp lse and
// delta_i = rowsum(dO_i * O_i) (a plain reduction done before the launch):
//
//   S_ij  = Q_i . K_eff_j,    P_ij = exp(S_ij g_j - lse_i)   (real j < P)
//   dP_ij = dO_i . V_j,       dS_ij = P_ij (dP_ij - delta_i) g_j
//   dq kernel:   dQ_i     = sum_j dS_ij K_eff_j
//   dkdv kernel: dV_j     = sum_i P_ij dO_i,   dK_eff_j = sum_i dS_ij Q_i
//   dv kernel:   dV alone (reads neither V nor delta)
//   dk kernel:   dK_eff alone
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
// (~0.009 ms): both are bound by operations. The dv kernel runs two
// products and the dk kernel three, five together where the fused kernel
// runs four, since both recompute S and P.
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
// - dkdv: one cluster of two blocks per (image, R-key tile). The block of
//   rank h owns columns [h Dh, min(D, (h + 1) Dh)) of D, Dh = ceil(D / 2)
//   rounded up to 4, and holds that half of the two float32 accumulators,
//   dK_eff and dV, in shared memory (2 x 32 x 768 x 4 = 192 KB at R = 32,
//   D = 1536). Per tile of 64 queries each block contracts its half of D by
//   the tile product (kscale on the staged K chunk, R rows where the Q
//   chunk has 64) into partial S^T and dP^T; the pair sums them through
//   distributed shared memory, so every logit is still computed once and
//   both blocks form the same P^T and dS^T; each accumulates
//   dV += P^T dO and dK_eff += dS^T Q over its own columns, streaming them
//   from L2. A cluster reads all of Q and dO once per 32 keys where a
//   full-D block of 16 keys (the design this replaced) read them twice per
//   16, and the 32-key tile gives the tile product an 8 x 4 register
//   micro-tile. Beside the accumulators there is room for one more area
//   (the block uses 223,232 of the 232,448 bytes it may): the tile
//   products stage 64-wide D-chunks there, then the partials go there with
//   a cluster barrier before the peer reads them, then P^T and dS^T after
//   a second one, once the peer is done reading. R = 32 where those
//   clusters give every SM a block, else 16, else 8 (the D-split forward's
//   rule). Each block owns its output columns outright, so the result
//   repeats bit for bit. With one 8-warp block per SM, the tile products
//   run at about a quarter of the FMA rate and the accumulation at about
//   half (256^2, B = 8; scripts/dkdv_variants.py clocks each phase).
// - dv and dk: one block per (image, R-key tile), all of D, with one
//   (R, D) accumulator, which is what the split buys: R = 32 keys fit in
//   one block (192 KB at D = 1536) without a cluster; 16 and 8 keys when
//   taller tiles would leave SMs idle. One weight tile
//   (P^T for dv, dS^T for dk) goes to shared memory, and one tensor (dO for
//   dv, Q for dk) is streamed in the accumulation.
// A dkdv block (8 warps, 218 KB of shared memory at R = 32) runs alone on
// its SM, as a 32-key dv or dk block does; the dq blocks at TQ = 16 fit
// two. The dkdv cluster needs sm_90. The other three kernels are the first
// design, simple and right; making them fast (tensor cores, more warps per
// SM) is later work.

#include <cooperative_groups.h>

#include "contextual_attention_common.cuh"

namespace {

template <int TQ>
size_t dq_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)TQ * D + stage_floats<TQ>() + kT * TQ + 2 * TQ);
}

template <int R>
size_t single_smem_bytes(int D) {
  return sizeof(float) * ((size_t)R * D + stage_floats<R>() + kT * R + 2 * kT);
}

// One block: TQ query rows of one image, all keys, all of D.
template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads, Tile<TQ>::kMinBlocks)
ca_dq_kernel(const T* Q, const T* K, const T* V, const float* keep,
             const float* kscale, const float* dO, const float* lse,
             const float* delta, float* dQ, int N, int P, int D,
             float scale) {
  constexpr int kSD = Tile<TQ>::kSD;
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
    tile_dot<T, T, TQ, 1>(Qb, q0, N, Kb, k0, P, ks_b, D, 0, D, as, bs, s);
    tile_dot<float, T, TQ, 0>(dOb, q0, N, Vb, k0, P, nullptr, D, 0, D, as, bs,
                              dp);
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
    // acc += dS K, K streamed from global memory
    accumulate<T, TQ, Tile<TQ>::kNC, false>(
        acc, D, D, Kb + (size_t)k0 * D, D, min(kT, P - k0), ds_s, nullptr);
  }

  // dQ = acc * kscale; each thread writes the columns it accumulated.
  for (int rr = 0; rr < TQ; ++rr) {
    const int q = q0 + rr;
    if (q >= N) break;
    float* orow = dQ + ((size_t)b * N + q) * D;
    for (int c = tid; c < D; c += kThreads) orow[c] = acc[rr * D + c] * ks_b[c];
  }
}

// The fused dK/dV kernel's tile: 64-wide D-chunks, which fit beside a
// 32-key tile's accumulators because P^T and dS^T share the staging area;
// each accumulation covers kNC = 3 columns a thread, a whole half of
// D = 1536 in one pass, unrolled 8 streamed rows deep; P^T and dS^T rows
// padded to kWLd = R + 4 floats, so the float4 rows that eight neighbouring
// lanes store fall on distinct banks. scripts/dkdv_variants.py times each
// choice against the others.
template <int R> struct DkdvTile {
  static constexpr int kDC = 64;
  static constexpr int kSD = kDC + 4;
  static constexpr int kNC = 3;
  static constexpr int kUnroll = 8;
  static constexpr int kWLd = R + 4;
  // floats of the area where the tile products stage their chunks and
  // P^T and dS^T (the partials first) go afterwards
  static constexpr int kArea = (R + kT) * kSD > 2 * kT * kWLd
                                   ? (R + kT) * kSD : 2 * kT * kWLd;
};

// A dK/dV block's shared memory, for its half of Dh columns: the two
// accumulators, the shared area, lse and delta.
template <int R>
size_t dkdv_smem_bytes(int Dh) {
  return sizeof(float) * (2 * (size_t)R * Dh + DkdvTile<R>::kArea + 2 * kT);
}

// kCPT register columns of a micro-tile row, one picked by the lane's
// D-group g: no divergence, no local memory.
__device__ __forceinline__ float pick(const float (&v)[kCPT], int g) {
  return g == 0 ? v[0] : g == 1 ? v[1] : g == 2 ? v[2] : v[3];
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int a = 0; a < N; ++a) dst[a] = v[a];
  }
}

template <int N>
__device__ __forceinline__ void load_row(const float* src, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(src)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < N; ++a) v[a] = src[a];
  }
}

// One cluster of two blocks: R key rows of one image, all queries. The
// block of rank `half` contracts columns [c_lo, c_hi) of D for partial S^T
// and dP^T, sums them with its peer's through distributed shared memory,
// and accumulates those columns of dV and dK_eff.
template <typename T, int R>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(kThreads, 1)
ca_dkdv_kernel(const T* Q, const T* K, const T* V, const float* keep,
               const float* kscale, const float* dO, const float* lse,
               const float* delta, float* dK, float* dV, int N, int P, int D,
               int Dh, float scale) {
  using Tl = DkdvTile<R>;
  constexpr int RPT = R / 4;
  constexpr int kWLd = Tl::kWLd;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int half = blockIdx.y;              // == cluster.block_rank()
  const int c_lo = half * Dh;
  const int nc = max(0, min(D, c_lo + Dh) - c_lo);  // 0 when D <= Dh (half 1)

  extern __shared__ __align__(16) float smem[];
  float* dk_acc = smem;                     // [R][Dh]
  float* dv_acc = dk_acc + (size_t)R * Dh;  // [R][Dh]
  float* as = dv_acc + (size_t)R * Dh;      // [R][kSD]
  float* bs = as + R * Tl::kSD;             // [kT][kSD]
  float* p_s = as;                // [kT][kWLd]: P^T, the partial S^T first
  float* ds_s = p_s + kT * kWLd;  // [kT][kWLd]: dS^T, the partial dP^T first
  float* lse_s = as + Tl::kArea;            // [kT]
  float* delta_s = lse_s + kT;              // [kT]
  const float* peer_p = cluster.map_shared_rank(p_s, half ^ 1);
  const float* peer_ds = cluster.map_shared_rank(ds_s, half ^ 1);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * R;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const T* Vb = V + (size_t)b * P * D;
  const float* dOb = dO + (size_t)b * N * D;
  const float* ks_b = kscale + (size_t)b * D;

  for (int i = tid; i < 2 * R * Dh; i += kThreads) dk_acc[i] = 0.f;

  const int lane = tid & 31;
  const int g = lane >> 3;
  const int rg = (tid >> 5) >> 1;
  const int kg = (((tid >> 5) & 1) << 3) | (lane & 7);
  // Every lane of a D-group ends tile_dot with the same sums, so the lanes
  // of group g take column c = g of the micro-tile: query ii, keys
  // rg * RPT + a. Their gates (keep * scale; keys past P are out) are fixed
  // for the block.
  const int ii = kg + 16 * g;
  const int off = ii * kWLd + rg * RPT;
  float gm[RPT];
  bool key_in[RPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int j = j0 + rg * RPT + a;
    key_in[a] = j < P;
    gm[a] = key_in[a] ? keep[(size_t)b * P + j] * scale : 0.f;
  }

  for (int i0 = 0; i0 < N; i0 += kT) {
    // read after the barrier that ends the tile products; the previous
    // tile's readers passed its second cluster barrier
    if (tid < kT) {
      const int i = i0 + tid;
      const bool in = i < N;
      lse_s[tid] = in ? lse[(size_t)b * N + i] : 0.f;
      delta_s[tid] = in ? delta[(size_t)b * N + i] : 0.f;
    }
    // tile_dot begins each chunk with a barrier, so the last tile's
    // accumulation is done with P^T and dS^T before chunks are staged over
    // them (an empty half stages nothing)
    float s[RPT][kCPT], dp[RPT][kCPT];
    tile_dot<T, T, R, 1, Tl::kDC>(Kb, j0, P, Qb, i0, N, ks_b, D, c_lo,
                                  c_lo + nc, as, bs, s);
    tile_dot<T, float, R, 0, Tl::kDC>(Vb, j0, P, dOb, i0, N, nullptr, D, c_lo,
                                      c_lo + nc, as, bs, dp);
    __syncthreads();  // every thread is done with the last chunk
    // the partials go where P^T and dS^T will
    float sp[RPT], dpp[RPT], peer_sp[RPT], peer_dpp[RPT];
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      sp[a] = pick(s[a], g);
      dpp[a] = pick(dp[a], g);
    }
    store_row(p_s + off, sp);
    store_row(ds_s + off, dpp);
    cluster.sync();  // both blocks' partials are written
    load_row(peer_p + off, peer_sp);
    load_row(peer_ds + off, peer_dpp);
    // S = own + peer and dP = own + peer: the same bits in both blocks,
    // since float addition commutes, so both form the same P and dS
    const int i = i0 + ii;
    float p[RPT], ds[RPT];
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      p[a] = 0.f;
      ds[a] = 0.f;
      if (key_in[a] && i < N) {
        p[a] = expf((sp[a] + peer_sp[a]) * gm[a] - lse_s[ii]);
        ds[a] = p[a] * (dpp[a] + peer_dpp[a] - delta_s[ii]) * gm[a];
      }
    }
    // The peer has read this block's partials: overwrite them. This also
    // keeps each block's shared memory alive until its peer is done with
    // it, so nothing after the last tile needs another barrier.
    cluster.sync();
    store_row(p_s + off, p);
    store_row(ds_s + off, ds);
    __syncthreads();
    if (nc > 0) {
      const int qn = min(kT, N - i0);
      const size_t row0 = (size_t)i0 * D + c_lo;
      // dV += P^T dO and dK_eff += dS^T Q over this block's columns
      accumulate<float, R, Tl::kNC, false, Tl::kUnroll, kWLd>(
          dv_acc, Dh, nc, dOb + row0, D, qn, p_s, nullptr);
      accumulate<T, R, Tl::kNC, false, Tl::kUnroll, kWLd>(
          dk_acc, Dh, nc, Qb + row0, D, qn, ds_s, nullptr);
    }
  }

  // each thread writes the columns it accumulated
  for (int rr = 0; rr < R; ++rr) {
    const int j = j0 + rr;
    if (j >= P) break;
    float* krow = dK + ((size_t)b * P + j) * D + c_lo;
    float* vrow = dV + ((size_t)b * P + j) * D + c_lo;
    for (int c = tid; c < nc; c += kThreads) {
      krow[c] = dk_acc[rr * Dh + c];
      vrow[c] = dv_acc[rr * Dh + c];
    }
  }
}

// One block: R key rows of one image, all queries, all of D, one output:
// dK_eff (kDK; reads V and delta for dP and dS) or dV (reads neither: V
// and delta may be NULL).
template <typename T, int R, bool kDK>
__global__ void __launch_bounds__(kThreads, Tile<R>::kMinBlocks)
ca_dk_or_dv_kernel(const T* Q, const T* K, const T* V, const float* keep,
                   const float* kscale, const float* dO, const float* lse,
                   const float* delta, float* out, int N, int P, int D,
                   float scale) {
  constexpr int kSD = Tile<R>::kSD;
  constexpr int RPT = R / 4;

  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                        // [R][D]
  float* as = acc + (size_t)R * D;          // [R][kSD]
  float* bs = as + R * kSD;                 // [kT][kSD]
  float* w_s = bs + kT * kSD;               // [kT][R]  (P or dS, transposed)
  float* lse_s = w_s + kT * R;              // [kT]
  float* delta_s = lse_s + kT;              // [kT]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * R;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const float* dOb = dO + (size_t)b * N * D;
  const float* keep_b = keep + (size_t)b * P;
  const float* ks_b = kscale + (size_t)b * D;

  for (int i = tid; i < R * D; i += kThreads) acc[i] = 0.f;

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
      if constexpr (kDK) delta_s[tid] = in ? delta[(size_t)b * N + i] : 0.f;
    }
    float s[RPT][kCPT], dp[RPT][kCPT];
    tile_dot<T, T, R, 2>(Kb, j0, P, Qb, i0, N, ks_b, D, 0, D, as, bs, s);
    if constexpr (kDK)
      tile_dot<T, float, R, 0>(V + (size_t)b * P * D, j0, P, dOb, i0, N,
                               nullptr, D, 0, D, as, bs, dp);
    if (g == 0) {
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          const int r = rg * RPT + a, j = j0 + r;     // key
          const int ii = kg + 16 * c, i = i0 + ii;    // query
          float w = 0.f;
          if (j < P && i < N) {
            const float gm = keep_b[j] * scale;
            w = expf(s[a][c] * gm - lse_s[ii]);
            if constexpr (kDK) w *= (dp[a][c] - delta_s[ii]) * gm;
          }
          w_s[ii * R + r] = w;
        }
    }
    __syncthreads();
    const int qn = min(kT, N - i0);
    if constexpr (kDK)   // dK_eff += dS^T Q
      accumulate<T, R, Tile<R>::kNC, false>(acc, D, D, Qb + (size_t)i0 * D, D,
                                            qn, w_s, nullptr);
    else                 // dV += P^T dO
      accumulate<float, R, Tile<R>::kNC, false>(
          acc, D, D, dOb + (size_t)i0 * D, D, qn, w_s, nullptr);
  }

  for (int rr = 0; rr < R; ++rr) {
    const int j = j0 + rr;
    if (j >= P) break;
    float* orow = out + ((size_t)b * P + j) * D;
    for (int c = tid; c < D; c += kThreads) orow[c] = acc[rr * D + c];
  }
}

struct Args {
  const void *q, *k, *v;
  const float *keep, *kscale, *dO, *lse, *delta;
  float *out, *out2;
  int B, N, P, D;
  float scale;
  cudaStream_t stream;
  int* plan = nullptr;  // dK/dV only: fill the launch plan, do not launch
};

template <typename T, int TQ>
int launch_dq_tq(const Args& a) {
  const size_t smem = dq_smem_bytes<TQ>(a.D);
  if (int err = opt_in_smem(ca_dq_kernel<T, TQ>, smem)) return err;
  const dim3 grid((a.N + TQ - 1) / TQ, a.B);
  ca_dq_kernel<T, TQ><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, a.dO, a.lse, a.delta,
      a.out, a.N, a.P, a.D, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_dkdv_r(const Args& a) {
  const int Dh = half_cut(a.D);
  const size_t smem = dkdv_smem_bytes<R>(Dh);
  const auto kernel = ca_dkdv_kernel<T, R>;
  if (int err = opt_in_smem(kernel, smem)) return err;
  const dim3 grid((a.P + R - 1) / R, 2, a.B);
  if (a.plan != nullptr) return cluster_plan(kernel, grid, smem, R, a.plan);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, a.dO, a.lse, a.delta,
      a.out, a.out2, a.N, a.P, a.D, Dh, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int R, bool kDK>
int launch_single_r(const Args& a) {
  const size_t smem = single_smem_bytes<R>(a.D);
  if (int err = opt_in_smem(ca_dk_or_dv_kernel<T, R, kDK>, smem)) return err;
  const dim3 grid((a.P + R - 1) / R, a.B);
  ca_dk_or_dv_kernel<T, R, kDK><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, a.dO, a.lse, a.delta,
      a.out, a.N, a.P, a.D, a.scale);
  return (int)cudaGetLastError();
}

// which: 0 dq, 1 dkdv, 2 dv, 3 dk.
// dq: 16-row tiles, or 8-row tiles when 16-row ones would leave SMs idle
// (the forward kernel's rule). dkdv, whose blocks come in clusters of two
// and run one per SM: 32-key tiles, which read Q and dO half as often as
// 16-key ones, where their clusters give every SM a block and their
// accumulators fit; then 16 keys where those do, or where 8-key clusters
// would not all fit at once (at 256^2, B = 1: 61 clusters of 16 keys in one
// wave, not 121 of 8 in two); 8 keys otherwise (the D-split forward's
// rule). dv and dk: the tallest of 32, 16 and 8 keys that fills every SM
// and fits.
template <typename T>
int launch(int which, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.P <= 0 || a.D <= 0)
    return (int)cudaErrorInvalidValue;
  const auto fills = [&](int rows, int tile) {
    return (long long)a.B * ((rows + tile - 1) / tile) >= sm_count();
  };
  switch (which) {
    case 0:
      return fills(a.N, 16) ? launch_dq_tq<T, 16>(a) : launch_dq_tq<T, 8>(a);
    case 1: {
      if (a.B > 65535) return (int)cudaErrorInvalidValue;
      const int Dh = half_cut(a.D);
      const auto pairs = [&](int tile) {   // blocks of the grid
        return 2LL * a.B * ((a.P + tile - 1) / tile);
      };
      if (pairs(32) >= sm_count() && dkdv_smem_bytes<32>(Dh) <= kMaxSmem)
        return launch_dkdv_r<T, 32>(a);
      if ((pairs(16) >= sm_count() || pairs(8) > sm_count()) &&
          dkdv_smem_bytes<16>(Dh) <= kMaxSmem)
        return launch_dkdv_r<T, 16>(a);
      return launch_dkdv_r<T, 8>(a);
    }
    case 2:
    case 3:
      if (fills(a.P, 32) && single_smem_bytes<32>(a.D) <= kMaxSmem)
        return which == 3 ? launch_single_r<T, 32, true>(a)
                          : launch_single_r<T, 32, false>(a);
      if (fills(a.P, 16) && single_smem_bytes<16>(a.D) <= kMaxSmem)
        return which == 3 ? launch_single_r<T, 16, true>(a)
                          : launch_single_r<T, 16, false>(a);
      return which == 3 ? launch_single_r<T, 8, true>(a)
                        : launch_single_r<T, 8, false>(a);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_typed(int which, int dtype, const Args& a) {
  if (dtype == 0) return launch<float>(which, a);
  if (dtype == 1) return launch<__nv_bfloat16>(which, a);
  return (int)cudaErrorInvalidValue;
}

const float* f(const void* p) { return static_cast<const float*>(p); }
float* f(void* p) { return static_cast<float*>(p); }

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
  return launch_typed(0, dtype,
                      {q, k, v, f(keep), f(kscale), f(dO), f(lse), f(delta),
                       f(dq), nullptr, B, N, P, D, scale,
                       static_cast<cudaStream_t>(stream)});
}

int sketchedit_contextual_attention_dkdv(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* keep, const void* kscale,
                                         const void* dO, const void* lse,
                                         const void* delta, void* dk,
                                         void* dv, int B, int N, int P, int D,
                                         float scale, void* stream) {
  return launch_typed(1, dtype,
                      {q, k, v, f(keep), f(kscale), f(dO), f(lse), f(delta),
                       f(dk), f(dv), B, N, P, D, scale,
                       static_cast<cudaStream_t>(stream)});
}

// The fused dK/dV kernel's launch plan for these shapes on the current
// device, without a launch: plan[0] tile keys, [1] blocks per cluster, [2]
// the most clusters resident at once (cudaOccupancyMaxActiveClusters), [3]
// dynamic shared-memory bytes per block, [4] clusters in the grid.
int sketchedit_contextual_attention_dkdv_plan(int dtype, int B, int N, int P,
                                              int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  return launch_typed(1, dtype, a);
}

// dV alone: no V, no delta.
int sketchedit_contextual_attention_dv(int dtype, const void* q,
                                       const void* k, const void* keep,
                                       const void* kscale, const void* dO,
                                       const void* lse, void* dv, int B,
                                       int N, int P, int D, float scale,
                                       void* stream) {
  return launch_typed(2, dtype,
                      {q, k, nullptr, f(keep), f(kscale), f(dO), f(lse),
                       nullptr, f(dv), nullptr, B, N, P, D, scale,
                       static_cast<cudaStream_t>(stream)});
}

// dK_eff alone.
int sketchedit_contextual_attention_dk(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* keep, const void* kscale,
                                       const void* dO, const void* lse,
                                       const void* delta, void* dk, int B,
                                       int N, int P, int D, float scale,
                                       void* stream) {
  return launch_typed(3, dtype,
                      {q, k, v, f(keep), f(kscale), f(dO), f(lse), f(delta),
                       f(dk), nullptr, B, N, P, D, scale,
                       static_cast<cudaStream_t>(stream)});
}

const char* sketchedit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
