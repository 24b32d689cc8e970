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
// bfloat16; dO, lse, delta and every output are float32. All four kernels'
// products run on the tensor cores in split TF32 (float32-accurate, as the
// forwards'). dO is not rounded to the input type (the JAX package streams
// it in the input type to halve its DMA): these kernels are bound by
// operations, not bytes, so the rounding would buy nothing.
//
// What bounds them on an H100. At 256^2 (N = P = 961, D = 1536) the dq
// kernel runs three products of N P D multiply-adds (6 N P D = 8.5 GFLOP
// per image, 0.127 ms at the SXM's 67 TFLOP/s of float32, 0.052 ms as split
// TF32 at three passes of 495 TFLOP/s) and the dkdv kernel four (11.4
// GFLOP, 0.169 ms, 0.069 ms as split TF32), against ~30 MB of float32 traffic
// (~0.009 ms): both are bound by operations. The dv kernel runs two
// products and the dk kernel three, five together where the fused kernel
// runs four, since both recompute S and P.
//
// Design. Blocks run in parallel, so the sequential axis of each TPU grid
// becomes a loop inside the block, and each block owns its output rows
// outright (no atomics, no second pass):
// - dq: split TF32 on the tensor cores (mma.sync): 8 warps over kRows = 16 query
//   rows (8 where 16-row blocks would leave SMs idle, the lower half of
//   every A tile then zero) of one image, all keys, a slab of up to 1536 dQ
//   columns. Warp w owns 192 dQ columns as 24 m16n8 fragments in registers
//   (96 floats a thread), so no accumulator sits in shared memory. All
//   three products are mma.sync m16n8k8 TF32 through mma_tile: an operand
//   holding float32 values is split in two TF32 terms, one holding
//   bfloat16 data enters whole, so a product takes three passes in float32
//   and two with bfloat16 inputs. kscale goes on the query side of S (the
//   staged Q tile is Q kscale in float32, 99 KB at D = 1536), so K enters
//   raw in S and in dS K and dQ is scaled once at the end. Per key tile of
//   kT = 64:
//     S, dP  warp w contracts its own 1/8 of D, 16 columns a step, into
//            partial S and dP (16 x 64 each): it stages K rows, the block's
//            dO rows (float32, re-read from L2 on every key tile since the
//            Q tile leaves no room for a dO tile) and, where V is not K, V
//            rows with cp.async in its own 12.8 KB area, steps ahead; where
//            V is K (the main path) one set of K fragments feeds both
//            products, four mma tiles (S and dP, two k8 steps) per n8 tile;
//     dS     after a barrier warp w sums rows 2w and 2w + 1 of the eight
//            partials in warp order (so two launches give the same bits)
//            and writes dS = P (dP - delta) g to shared memory;
//     dS K   after a second barrier each warp adds dS K for its columns,
//            dS's A fragments from shared memory, K rows at its 192 columns
//            staged with cp.async, steps ahead.
//   The tensor cores add into an accumulator with truncation, so every k8
//   step starts a fresh one and is added with a round-to-nearest FADD (the
//   forward's rule: S and dP sum 192 k8 steps at D = 1536, dS K up to 121).
//   What holds it back is each warp's own chain of fragment loads, splits,
//   mma passes and FADDs, not L2: more steps in flight change nothing,
//   while staging and splitting V apart from K costs a quarter more
//   (scripts/dq_variants.py; S and dP run at ~0.29 mma a cycle per SM,
//   dS K at ~0.25, against a TF32 peak of 1).
//   Keys past the last real one of a tile are skipped. At D = 1536 a block
//   takes 206 KB of shared memory and runs alone on its SM; D up to 1920
//   fits, a wider D takes more column slabs, each recomputing S and dP.
// - dkdv: one cluster of two blocks per (image, 16-key tile), 8 keys where
//   16-key clusters would leave SMs idle and 8-key ones all fit at once
//   (at 256^2, B = 1: 61 clusters of 16 in one wave, not 121 of 8 in two);
//   the dK and dV kernels' block with D split over the pair. The block of
//   rank h contracts columns [h Dc, min(D, (h + 1) Dc)) of D, Dc = ceil(D /
//   2) rounded up to 4, for partial S^T = (K kscale) Q^T and dP^T = V dO^T,
//   each warp 1/8 of that half (96 columns at D = 1536) through
//   dk_dv_partial, the owned K rows of the half raw in the input type
//   (kscale put on as S^T's A fragments are formed), S^T's partial moved to
//   shared memory before dP^T runs so one partial at a time is held in
//   registers. The eight warps' partials are summed in warp order and the
//   pair adds its two sums through distributed shared memory (own + peer in
//   both blocks: the same bits, as float addition commutes), so every logit
//   is computed once and both blocks form the same P^T and dS^T. Each block
//   then accumulates dV += P^T dO and dK_eff += dS^T Q over its 768 output
//   columns, 96 a warp as 2 x 12 m16n8 fragments in registers (96 floats a
//   thread, the dK and dV kernels' budget), one loop staging 8 rows of Q
//   and of dO at the warp's columns with cp.async. All four products are
//   split TF32 through mma_tile, a fresh accumulator per k8 step; in
//   bfloat16 Q and K enter whole and only dO and K kscale are split. Two
//   steps are in flight in each phase (14.5 KB a warp in float32): one or
//   three measured slower (scripts/dkdv_variants.py); staging the
//   accumulation's first steps before the weights are formed, or splitting
//   a cluster barrier into its arrive and wait halves, measured no faster
//   (PERF.md). A D wider than two 768-column halves takes more column slabs
//   (clusters along y), each recomputing S^T and dP^T; the K tile over half
//   of D bounds D at about 2800 in float32 and 6400 in bfloat16 (the
//   forward kernels stop first, near 1750). Each block owns its output
//   columns outright, so the result repeats bit for bit; a block takes
//   186,880 bytes of shared memory in float32 at D = 1536 and runs alone on
//   its SM. Like the dK and dV kernels, each warp is held back by its own
//   chain of loads, splits, mma passes and FADDs: at 256^2, B = 8 the
//   accumulation takes ~45% of a query tile, S^T and dP^T ~20% each, the
//   reduction and exchange the rest (clocks on an NVIDIA H100 80GB HBM3,
//   700.00 W).
// - dv and dk: dq's block with the roles of owned and streamed rows
//   swapped: 8 warps over kRows = 16 key rows (8 where 16-row blocks would
//   leave SMs idle), all queries in tiles of kT = 64, a slab of up to 1536
//   output columns, 192 a warp in registers (no shared-memory accumulator);
//   split TF32 through mma_tile, a fresh accumulator per k8 step. The owned
//   K rows stay raw in the input type in shared memory (99 KB in float32,
//   50 KB in bfloat16 at D = 1536; a float32 tile costs 5% in bfloat16),
//   and kscale goes on them as S^T's A fragments are formed, so in bfloat16
//   Q enters S^T whole and K enters dP^T whole: both products take two
//   passes, and only dO and K kscale are split (three passes in float32).
//   Per query tile:
//     S^T, dP^T  warp w contracts its own 1/8 of D, 16 columns a step, into
//            partial S^T = (K kscale) Q^T and (dk) dP^T = V dO^T (16 x 64
//            each), staging the tile's Q or dO rows (with S^T the step's 16
//            kscale values, which a global load per step left unhidden:
//            +6% in bfloat16; where V is not K, V's 16 owned rows, re-read
//            from L2 per step) with cp.async in its own 12.8 KB area, as
//            two loops: one streamed tensor a step keeps three float32
//            steps in flight where one loop over both would fit one; where
//            V is K (the main path) dP^T takes its A rows from the owned K
//            tile (staging V's rows apart costs 0-2%);
//     weights after a barrier one lane sums 4 queries of a key over the
//            eight partials in warp order (two launches, same bits) and
//            writes P^T (dv) or dS^T = P (dP - delta) g (dk) to shared
//            memory; queries past N and keys past P weigh 0;
//     W X    after a second barrier each warp adds P^T dO (dv; dO split in
//            both dtypes) or dS^T Q (dk) for its columns, the weights' A
//            fragments from shared memory, 8 streamed rows at its 192
//            columns staged with cp.async, steps ahead (dq's dS K).
//   dK_eff is written as accumulated. A block takes 206 KB of shared memory
//   in float32 and runs alone on its SM; D up to 1920 fits, a wider D than
//   1536 takes more column slabs, each recomputing S^T and dP^T. Like dq's,
//   each warp is held back by its own chain of fragment loads, splits, mma
//   passes and FADDs: the streamed side is two tensors (Q and dO) where
//   dq's is one K serving S and dP, so a float32 step converts 80 operands
//   to dq's 48 for the same mma (scripts/dk_dv_variants.py clocks each
//   phase; 16-row blocks, 8 where 16 leave SMs idle, 64-query tiles and a
//   12.8 KB area measured best).
// A dkdv block runs alone on its SM, as a dq, dv or dk block does. The dkdv
// cluster needs sm_90.

#include <cooperative_groups.h>

#include <type_traits>

#include "contextual_attention_common.cuh"

namespace {

// dQ's per-warp staging area, kDqArea bytes, holds one of three things in
// turn: kStages1 steps of the S and dP products (K rows k0 .. k0 + 63 at 16
// columns of D in T, V's rows too where V is not K, and the block's 16 dO
// rows at the same columns in float32), or the warp's partial S and dP
// [2][kRows][kPartLd] floats, or kStages3 steps of dS K (8 K rows at the
// warp's 192 columns, padded as the forward's V steps). 12,800 bytes a
// warp keep the block at the forward's 206 KB at D = 1536 and admit D up to
// 1920 (a 15 KB area, one more step in flight, measured no faster:
// scripts/dq_variants.py `deep`).
constexpr int kDqArea = 12800;
template <typename T, bool kSame> struct DqStage {
  static constexpr int kK = kT * 16;                    // K (or V) step, T
  static constexpr int kO = kRows * 16;                 // dO step, floats
  static constexpr int kOOff = (kSame ? 1 : 2) * kK * (int)sizeof(T);
  static constexpr int kStep1 = kOOff + kO * (int)sizeof(float);  // bytes
  static constexpr int kStages1 = kDqArea / kStep1;
  static constexpr int kKLd = kGroups * 32 + 32 / (int)sizeof(T);
  static constexpr int kK3 = 8 * kKLd;                  // dS K step, T
  static constexpr int kStages3 = kDqArea / (kK3 * (int)sizeof(T));
  static_assert(kStages1 >= 1 && kStages3 >= 1, "a step must fit");
  static_assert(2 * kRows * kPartLd * sizeof(float) <= (size_t)kDqArea,
                "the partials must fit");
};

// Shared-memory bytes of a dQ block: the Q tile (times kscale), the warps'
// areas, dS [kRows][kPLd], lse and delta per row.
size_t dq_smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * mma_q_ld(D) + kRows * kPLd +
                          2 * kRows) + (size_t)kWarps * kDqArea;
}

// One block: query rows [q0, q0 + rows) of one image (rows is 16, or 8
// with the lower half of every A tile zero), all keys, dQ columns
// [blockIdx.y * kSlab, + kSlab). kSame: V is K (one pointer), so one staged
// step of K rows serves S and dP. kVec: D is a multiple of 4 and every
// pointer is 16-byte aligned.
template <typename T, bool kSame, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ca_dq_kernel(const T* Q, const T* K, const T* V, const float* keep,
             const float* kscale, const float* dO, const float* lse,
             const float* delta, float* dQ, int rows, int N, int P, int D,
             float scale) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);  // K and V split too
  using St = DqStage<T, kSame>;
  extern __shared__ __align__(16) float smem[];
  const int Ds = mma_cols(D), ldq = mma_q_ld(D), qcols = kWarps * Ds;
  float* qs = smem;                              // [kRows][ldq]
  char* areas = reinterpret_cast<char*>(qs + kRows * ldq);
  float* ds_s = reinterpret_cast<float*>(areas + kWarps * kDqArea);
  float* lse_s = ds_s + kRows * kPLd;            // [kRows]
  float* delta_s = lse_s + kRows;                // [kRows]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * rows;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const T* Vb = V + (size_t)b * P * D;
  const float* dOb = dO + (size_t)b * N * D;
  const float* keep_b = keep + (size_t)b * P;
  const float* ks_b = kscale + (size_t)b * D;
  char* mine = areas + w * kDqArea;              // this warp's area
  float* part = reinterpret_cast<float*>(mine);  // [2][kRows][kPartLd]
  T* kst3 = reinterpret_cast<T*>(mine);          // [kStages3][8][kKLd]

  // the Q tile times kscale in float32; rows past the tile or N and
  // columns past D are 0
  for (int i = tid; i < kRows * qcols; i += kThreads) {
    const int r = i / qcols, d = i % qcols;
    float x = 0.f;
    if (r < rows && q0 + r < N && d < D)
      x = to_f(Qb[(size_t)(q0 + r) * D + d]) * ks_b[d];
    qs[r * ldq + d] = x;
  }
  for (int i = tid; i < kRows * kPLd; i += kThreads) ds_s[i] = 0.f;
  if (tid < kRows) {  // rows past the tile or N: lse = delta = 0
    const bool in = tid < rows && q0 + tid < N;
    lse_s[tid] = in ? lse[(size_t)b * N + q0 + tid] : 0.f;
    delta_s[tid] = in ? delta[(size_t)b * N + q0 + tid] : 0.f;
  }
  __syncthreads();

  float acc[kGroups][4][4];
#pragma unroll
  for (int c = 0; c < kGroups; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  // dS rows: warp w forms rows 2w and 2w + 1, 16 lanes a row, 4 keys a lane
  const int srow = 2 * w + (lane >> 4), skey = 4 * (lane & 15);
  const int d_lo = w * Ds, d_hi = min(D, d_lo + Ds);
  const int nstep = d_hi > d_lo ? (d_hi - d_lo + 15) / 16 : 0;
  const int cw = blockIdx.y * kSlab + w * (kGroups * 32);  // warp's columns

  for (int k0 = 0; k0 < P; k0 += kT) {
    const int kn = min(kT, P - k0);              // real keys of the tile
    // 1. this warp's partial S = (Q kscale) K^T and dP = dO V^T over
    // columns [d_lo, d_hi) of D, 16 at a time: step i stages K rows k0 ..
    // k0 + 63 (and V's where V is not K) and dO rows q0 .. q0 + 15 at
    // columns d_lo + 16i .. + 15, kStages1 - 1 steps ahead. Lane (g, t)
    // reads row 8j + g, columns 4t .. 4t + 3 for n8 tile j: k = t and t + 4
    // of k8 step h are 4t + 2h and + 1, and the A fragments of Q kscale
    // and dO follow the same order. Each n8 tile is four mma tiles, S and
    // dP for both k8 steps, from one set of K fragments where V is K.
    auto stage1 = [&](int i) {
      if (i < nstep) {
        char* slot = mine + (i % St::kStages1) * St::kStep1;
        T* kd = reinterpret_cast<T*>(slot);
        float* od = reinterpret_cast<float*>(slot + St::kOOff);
        const int d0 = d_lo + 16 * i, q = (lane & 3) * 4;
        const size_t r0 = (size_t)(k0 + (lane >> 2)) * D;
#pragma unroll (kVec ? kT * 4 / 32 : 1)
        for (int n = 0; n < kT * 4 / 32; ++n) {
          const int r = (lane >> 2) + 8 * n;
          copy4<kVec>(kd + r * 16 + q, Kb + r0 + (size_t)(8 * n) * D,
                      k0 + r < P, d0 + q, D);
          if constexpr (!kSame)
            copy4<kVec>(kd + St::kK + r * 16 + q,
                        Vb + r0 + (size_t)(8 * n) * D, k0 + r < P, d0 + q, D);
        }
#pragma unroll
        for (int n = 0; n < kRows * 4 / 32; ++n) {
          const int r = (lane >> 2) + 8 * n;
          copy4<kVec>(od + r * 16 + q, dOb + (size_t)(q0 + r) * D,
                      r < rows && q0 + r < N, d0 + q, D);
        }
      }
      cp_commit();
    };
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < St::kStages1 - 1; ++i) stage1(i);
#pragma unroll 1
    for (int i = 0; i < nstep; ++i) {
      stage1(i + St::kStages1 - 1);
      cp_wait<St::kStages1 - 1>();
      __syncwarp();                    // step i is staged, by every lane
      const char* slot = mine + (i % St::kStages1) * St::kStep1;
      const T* kb = reinterpret_cast<const T*>(slot);
      const T* vb = kSame ? kb : kb + St::kK;
      const float* ob = reinterpret_cast<const float*>(slot + St::kOOff);
      const int d = d_lo + 16 * i + 4 * t;
      const float4 qa = lds4(qs + g * ldq + d);
      const float4 qb = lds4(qs + (g + 8) * ldq + d);
      const float4 oa = lds4(ob + g * 16 + 4 * t);
      const float4 obb = lds4(ob + (g + 8) * 16 + 4 * t);
      // A fragments: 0 and 1 Q kscale at k8 steps 0 and 1, 2 and 3 dO
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        to_tf32<true>(elem(qa, 2 * h), ah[h][0], al[h][0]);
        to_tf32<true>(elem(qb, 2 * h), ah[h][1], al[h][1]);
        to_tf32<true>(elem(qa, 2 * h + 1), ah[h][2], al[h][2]);
        to_tf32<true>(elem(qb, 2 * h + 1), ah[h][3], al[h][3]);
        to_tf32<true>(elem(oa, 2 * h), ah[2 + h][0], al[2 + h][0]);
        to_tf32<true>(elem(obb, 2 * h), ah[2 + h][1], al[2 + h][1]);
        to_tf32<true>(elem(oa, 2 * h + 1), ah[2 + h][2], al[2 + h][2]);
        to_tf32<true>(elem(obb, 2 * h + 1), ah[2 + h][3], al[2 + h][3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= kn) break;        // no real key left in the tile
        fence();
        const float4 kf = lds4(kb + (8 * j + g) * 16 + 4 * t);
        const float4 vf = kSame ? kf : lds4(vb + (8 * j + g) * 16 + 4 * t);
        uint32_t bh[4][2], bl[4][2];
        float x[4][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          to_tf32<kF32>(elem(kf, 2 * h), bh[h][0], bl[h][0]);
          to_tf32<kF32>(elem(kf, 2 * h + 1), bh[h][1], bl[h][1]);
          if constexpr (kSame) {
            bh[2 + h][0] = bh[h][0]; bl[2 + h][0] = bl[h][0];
            bh[2 + h][1] = bh[h][1]; bl[2 + h][1] = bl[h][1];
          } else {
            to_tf32<kF32>(elem(vf, 2 * h), bh[2 + h][0], bl[2 + h][0]);
            to_tf32<kF32>(elem(vf, 2 * h + 1), bh[2 + h][1], bl[2 + h][1]);
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
        mma_tile<true, kF32, 4, 4>(x, ah, al, bh, bl);  // S h0, h1, dP h0, h1
        add_into(s[j], x[0]);
        add_into(s[j], x[1]);
        add_into(dp[j], x[2]);
        add_into(dp[j], x[3]);
      }
      __syncwarp();                    // every lane is done with step i
    }
    cp_wait<0>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* ps = part + g * kPartLd + 8 * j + 2 * t;
      float* pd = ps + kRows * kPartLd;
      *reinterpret_cast<float2*>(ps) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(ps + 8 * kPartLd) =
          make_float2(s[j][2], s[j][3]);
      *reinterpret_cast<float2*>(pd) = make_float2(dp[j][0], dp[j][1]);
      *reinterpret_cast<float2*>(pd + 8 * kPartLd) =
          make_float2(dp[j][2], dp[j][3]);
    }
    __syncthreads();  // every partial is written

    // 2. S and dP = the eight partials each, summed in warp order; dS =
    // P (dP - delta) g with P = exp(S g - lse), g = keep * scale: a gated
    // key's g is 0, a key past P or a row past N gives 0.
    if (srow < rows) {
      const float* p0 = reinterpret_cast<const float*>(areas) +
                        srow * kPartLd + skey;
      float4 sx = lds4(p0), dx = lds4(p0 + kRows * kPartLd);
#pragma unroll
      for (int u = 1; u < kWarps; ++u) {
        const float* pu =
            reinterpret_cast<const float*>(areas + u * kDqArea) +
            srow * kPartLd + skey;
        const float4 y = lds4(pu), z = lds4(pu + kRows * kPartLd);
        sx.x += y.x; sx.y += y.y; sx.z += y.z; sx.w += y.w;
        dx.x += z.x; dx.y += z.y; dx.z += z.z; dx.w += z.w;
      }
      const bool row_in = q0 + srow < N;
      const float l = lse_s[srow], dl = delta_s[srow];
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + skey + e;
        ds[e] = 0.f;
        if (row_in && j < P) {
          const float gm = keep_b[j] * scale;
          const float p = expf(elem(sx, e) * gm - l);
          ds[e] = p * (elem(dx, e) - dl) * gm;
        }
      }
      *reinterpret_cast<float4*>(ds_s + srow * kPLd + skey) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // dS is written; the partials are read

    // 3. acc += dS K over this warp's columns, 8 keys a step: step i
    // stages K rows k0 + 8i .. + 7 at the warp's 192 columns, kStages3 - 1
    // steps ahead. Group c's rows t and t + 4 at columns 32c + 4g .. + 3
    // give the B fragments of its four n8 tiles (tile e's column n is 32c
    // + 4n + e).
    const int nstep3 = cw < D ? (kn + 7) / 8 : 0;
    auto stage3 = [&](int i) {
      if (i < nstep3) {
        T* dst = kst3 + (i % St::kStages3) * St::kK3;
        const T* krow = Kb + (size_t)(k0 + 8 * i) * D;
        // a row's 48 four-element chunks: lanes 0-31, then lanes 0-15
#pragma unroll (kVec ? 8 : 1)
        for (int r = 0; r < 8; ++r) {
          const bool ok = k0 + 8 * i + r < P;
          const int q = 4 * lane;
          copy4<kVec>(dst + r * St::kKLd + q, krow + (size_t)r * D, ok,
                      cw + q, D);
          if (lane < kGroups * 8 - 32)
            copy4<kVec>(dst + r * St::kKLd + 128 + q, krow + (size_t)r * D,
                        ok, cw + 128 + q, D);
        }
      }
      cp_commit();
    };
#pragma unroll
    for (int i = 0; i < St::kStages3 - 1; ++i) stage3(i);
#pragma unroll 1
    for (int i = 0; i < nstep3; ++i) {
      stage3(i + St::kStages3 - 1);
      cp_wait<St::kStages3 - 1>();
      __syncwarp();                    // step i is staged, by every lane
      uint32_t ah[1][4], al[1][4];
      to_tf32<true>(ds_s[g * kPLd + 8 * i + t], ah[0][0], al[0][0]);
      to_tf32<true>(ds_s[(g + 8) * kPLd + 8 * i + t], ah[0][1], al[0][1]);
      to_tf32<true>(ds_s[g * kPLd + 8 * i + t + 4], ah[0][2], al[0][2]);
      to_tf32<true>(ds_s[(g + 8) * kPLd + 8 * i + t + 4], ah[0][3],
                    al[0][3]);
      const T* kb = kst3 + (i % St::kStages3) * St::kK3;
      // one 32-column group at a time: its four n8 tiles
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        fence();
        const float4 ka = lds4(kb + t * St::kKLd + 32 * c + 4 * g);
        const float4 kc = lds4(kb + (t + 4) * St::kKLd + 32 * c + 4 * g);
        uint32_t bh[4][2], bl[4][2];
        float x[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          to_tf32<kF32>(elem(ka, e), bh[e][0], bl[e][0]);
          to_tf32<kF32>(elem(kc, e), bh[e][1], bl[e][1]);
#pragma unroll
          for (int k = 0; k < 4; ++k) x[e][k] = 0.f;
        }
        mma_tile<true, kF32, 4, 1>(x, ah, al, bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) add_into(acc[c][e], x[e]);
      }
      __syncwarp();                    // every lane is done with step i
    }
    cp_wait<0>();
  }

  // dQ = acc * kscale; each thread writes the columns it accumulated
  float* dQb = dQ + (size_t)b * N * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    if (r >= rows || q0 + r >= N) continue;
    float* orow = dQb + (size_t)(q0 + r) * D;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      const int col = cw + 32 * c + 8 * t;  // tile e, n = 2t (+1): col + e (+4)
      const float4 k0v = ldg4<kVec>(ks_b, col, D);
      const float4 k1v = ldg4<kVec>(ks_b, col + 4, D);
      store4<kVec>(orow, col, D,
                   make_float4(acc[c][0][2 * half] * k0v.x,
                               acc[c][1][2 * half] * k0v.y,
                               acc[c][2][2 * half] * k0v.z,
                               acc[c][3][2 * half] * k0v.w));
      store4<kVec>(orow, col + 4, D,
                   make_float4(acc[c][0][2 * half + 1] * k1v.x,
                               acc[c][1][2 * half + 1] * k1v.y,
                               acc[c][2][2 * half + 1] * k1v.z,
                               acc[c][3][2 * half + 1] * k1v.w));
    }
  }
}

// The dK and dV kernels' per-warp staging area, kDkArea bytes (dQ's), holds
// one of three things in turn: steps of one partial product (the block's kTq
// streamed Q or dO rows at 16 columns of D, and V's owned rows at the same
// columns where V is not K), or the warp's partials [2][kRows][kQLd]
// (S^T, then dP^T), or steps of the accumulation (8 streamed Q or dO rows at
// the warp's 192 columns, padded as dQ's K steps). S^T and dP^T run as two
// loops, so a float32 step holds one streamed tensor (4 KB) and three steps
// are in flight, where one loop over both would stage 8 KB a step and fit
// one.
constexpr int kDkArea = 12800;
// Queries per streamed tile of the dK/dV kernels, and the type the owned K
// rows are held in (the input type: 50 KB of bfloat16 at D = 1536).
constexpr int kTq = kT;
template <typename T> using DkOwned = T;
constexpr int kWLd = kTq + 4;         // weight rows (P^T or dS^T): 68 floats
constexpr int kQLd = kTq + 8;         // partial rows: 72 floats

// Steps in flight in a staging area of kArea bytes for a step of kBytes, at
// most kMax.
template <int kBytes, int kArea = kDkArea, int kMax = kArea / kBytes>
__host__ __device__ constexpr int dk_stages() {
  static_assert(kBytes <= kArea, "a step must fit");
  return kArea / kBytes < kMax ? kArea / kBytes : kMax;
}

// Shared-memory bytes of a dK or dV block: the owned K tile, the warps'
// areas, the weight tile [kRows][kWLd] (P^T or dS^T), lse and delta per
// streamed query.
template <typename T>
size_t dk_dv_smem_bytes(int D) {
  return (size_t)kRows * mma_q_ld(D) * sizeof(DkOwned<T>) +
         (size_t)kWarps * kDkArea + sizeof(float) * (kRows * kWLd + 2 * kTq);
}

// One partial product of the dK/dV kernels over this warp's columns
// [d_lo, d_lo + 16 nstep) of D, into acc[kTq / 8][4]: the block's kRows
// owned rows (m16, keys) against the kTq streamed rows of the tile (n8
// tiles of queries i0 ..), acc[j] the lane's C fragment of n8 tile j. The A
// rows are the owned K tile's (kOwnA; its column 0 is column k_lo of D;
// times kscale where kScaleA, for S, its 16 values staged with the step) or
// V's owned rows, staged with the step (dP where V is not K); the B rows
// are Bb's (Q in T for S, dO in float32 for dP), staged with cp.async in
// the warp's own area of kArea bytes, steps ahead. Columns at or past dcap
// are staged as 0. An operand holding float32 values is split (K kscale
// always; K, V and Q in float32; dO always), one holding bfloat16 data
// enters whole. Lane (g, t) reads columns 4t .. 4t + 3 of a step: k = t and
// t + 4 of k8 step h are 4t + 2h and + 1 on both sides. Two n8 tiles a pass
// (four independent mma); tiles past the tile's last real query are
// skipped. At most kMaxStages steps are in flight.
template <typename T, typename TB, bool kOwnA, bool kScaleA, bool kVec,
          int kArea = kDkArea, int kMaxStages = 64>
__device__ __forceinline__ void dk_dv_partial(
    float (&acc)[kTq / 8][4], char* mine, const DkOwned<T>* ktile, int ldk,
    int k_lo, const T* Vb, const float* ks_b, const TB* Bb, int i0, int N,
    int qn, int j0, int rows, int P, int D, int dcap, int d_lo, int nstep) {
  constexpr bool kSplitA = kScaleA || sizeof(T) == sizeof(float);
  constexpr bool kSplitB = sizeof(TB) == sizeof(float);
  constexpr int kStepB = kTq * 16 * (int)sizeof(TB);
  constexpr int kStepV = kStepB + (kScaleA ? 16 * (int)sizeof(float) : 0);
  constexpr int kStep = kStepV + (kOwnA ? 0 : kRows * 16 * (int)sizeof(T));
  constexpr int kStages = dk_stages<kStep, kArea, kMaxStages>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto stage = [&](int i) {
    if (i < nstep) {
      char* slot = mine + (i % kStages) * kStep;
      TB* bd = reinterpret_cast<TB*>(slot);
      const int d0 = d_lo + 16 * i, q = (lane & 3) * 4;
      const size_t r0 = (size_t)(i0 + (lane >> 2)) * D;
#pragma unroll (kVec ? kTq * 4 / 32 : 1)
      for (int n = 0; n < kTq * 4 / 32; ++n) {
        const int r = (lane >> 2) + 8 * n;
        copy4<kVec>(bd + r * 16 + q, Bb + r0 + (size_t)(8 * n) * D,
                    i0 + r < N, d0 + q, dcap);
      }
      if constexpr (kScaleA) {
        if (lane < 4)
          copy4<kVec>(reinterpret_cast<float*>(slot + kStepB) + 4 * lane,
                      ks_b, true, d0 + 4 * lane, dcap);
      }
      if constexpr (!kOwnA) {
        T* vd = reinterpret_cast<T*>(slot + kStepV);
#pragma unroll
        for (int n = 0; n < kRows * 4 / 32; ++n) {
          const int r = (lane >> 2) + 8 * n;
          copy4<kVec>(vd + r * 16 + q, Vb + (size_t)(j0 + r) * D,
                      r < rows && j0 + r < P, d0 + q, dcap);
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int j = 0; j < kTq / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);
#pragma unroll 1
  for (int i = 0; i < nstep; ++i) {
    stage(i + kStages - 1);
    cp_wait<kStages - 1>();
    __syncwarp();                      // step i is staged, by every lane
    const char* slot = mine + (i % kStages) * kStep;
    const TB* bb = reinterpret_cast<const TB*>(slot);
    const int d = d_lo + 16 * i + 4 * t;
    float4 xa, xb;
    if constexpr (kOwnA) {
      xa = lds4(ktile + g * ldk + d - k_lo);
      xb = lds4(ktile + (g + 8) * ldk + d - k_lo);
    } else {
      const T* vs = reinterpret_cast<const T*>(slot + kStepV) + 4 * t;
      xa = lds4(vs + g * 16);
      xb = lds4(vs + (g + 8) * 16);
    }
    if constexpr (kScaleA) {
      const float4 ks =
          lds4(reinterpret_cast<const float*>(slot + kStepB) + 4 * t);
      xa = make_float4(xa.x * ks.x, xa.y * ks.y, xa.z * ks.z, xa.w * ks.w);
      xb = make_float4(xb.x * ks.x, xb.y * ks.y, xb.z * ks.z, xb.w * ks.w);
    }
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      to_tf32<kSplitA>(elem(xa, 2 * h), ah[h][0], al[h][0]);
      to_tf32<kSplitA>(elem(xb, 2 * h), ah[h][1], al[h][1]);
      to_tf32<kSplitA>(elem(xa, 2 * h + 1), ah[h][2], al[h][2]);
      to_tf32<kSplitA>(elem(xb, 2 * h + 1), ah[h][3], al[h][3]);
    }
#pragma unroll
    for (int j = 0; j < kTq / 8; j += 2) {
      if (8 * j >= qn) break;          // no real query left in the tile
      fence();
      const float4 b0 = lds4(bb + (8 * j + g) * 16 + 4 * t);
      const float4 b1 = lds4(bb + (8 * j + 8 + g) * 16 + 4 * t);
      uint32_t bh[4][2], bl[4][2];
      float x[4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        to_tf32<kSplitB>(elem(b0, 2 * h), bh[h][0], bl[h][0]);
        to_tf32<kSplitB>(elem(b0, 2 * h + 1), bh[h][1], bl[h][1]);
        to_tf32<kSplitB>(elem(b1, 2 * h), bh[2 + h][0], bl[2 + h][0]);
        to_tf32<kSplitB>(elem(b1, 2 * h + 1), bh[2 + h][1], bl[2 + h][1]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
      mma_tile<kSplitA, kSplitB, 4, 2>(x, ah, al, bh, bl);  // (j, j + 1) x h
      add_into(acc[j], x[0]);
      add_into(acc[j], x[1]);
      add_into(acc[j + 1], x[2]);
      add_into(acc[j + 1], x[3]);
    }
    __syncwarp();                      // every lane is done with step i
  }
  cp_wait<0>();
  __syncwarp();
}

// One block: key rows [j0, j0 + rows) of one image (rows is 16, or 8 with
// the lower half of every A tile zero), all queries, output columns
// [blockIdx.y * kSlab, + kSlab): dK_eff (kDK; reads V and delta) or dV
// (reads neither: V and delta may be NULL). kSame (dK only): V is K (one
// pointer), so dP^T takes its A rows from the owned K tile. kVec: D is a
// multiple of 4 and every pointer is 16-byte aligned.
template <typename T, bool kDK, bool kSame, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ca_dk_or_dv_kernel(const T* Q, const T* K, const T* V, const float* keep,
                   const float* kscale, const float* dO, const float* lse,
                   const float* delta, float* out, int rows, int N, int P,
                   int D, float scale) {
  // the accumulation's streamed rows: Q for dK_eff, dO for dV; split where
  // they hold float32 values
  using TS = typename std::conditional<kDK, T, float>::type;
  constexpr bool kSplit3 = sizeof(TS) == sizeof(float);
  constexpr int kLd3 = kGroups * 32 + 32 / (int)sizeof(TS);
  constexpr int kStep3 = 8 * kLd3;                       // elements of TS
  constexpr int kStages3 = dk_stages<kStep3 * (int)sizeof(TS)>();
  static_assert(2 * kRows * kQLd * sizeof(float) <= (size_t)kDkArea,
                "the partials must fit");
  extern __shared__ __align__(16) float smem[];
  const int Ds = mma_cols(D), ldk = mma_q_ld(D), kcols = kWarps * Ds;
  DkOwned<T>* kt = reinterpret_cast<DkOwned<T>*>(smem);  // [kRows][ldk]
  char* areas = reinterpret_cast<char*>(kt + kRows * ldk);
  float* w_s = reinterpret_cast<float*>(areas + kWarps * kDkArea);
  float* lse_s = w_s + kRows * kWLd;                     // [kTq]
  float* delta_s = lse_s + kTq;                          // [kTq]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * rows;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const float* dOb = dO + (size_t)b * N * D;
  const TS* Sb;                                          // accumulation rows
  if constexpr (kDK) Sb = Qb; else Sb = dOb;
  const float* ks_b = kscale + (size_t)b * D;
  char* mine = areas + w * kDkArea;                      // this warp's area
  float* part = reinterpret_cast<float*>(mine);  // [2][kRows][kQLd]
  TS* st3 = reinterpret_cast<TS*>(mine);         // [kStages3][8][kLd3]

  // the owned K rows, raw; rows past the tile or P and columns past D are 0
  for (int i = tid; i < kRows * kcols; i += kThreads) {
    const int r = i / kcols, d = i % kcols;
    store(kt + r * ldk + d, r < rows && j0 + r < P && d < D
                                ? to_f(Kb[(size_t)(j0 + r) * D + d]) : 0.f);
  }
  __syncthreads();  // the K tile is written
  // the weight rows: warp w forms keys 2w and 2w + 1, 16 lanes a key, 4
  // queries a lane (lanes past kTq idle); a key past the tile or P, or a
  // gated one (g = 0), has weight 0 in dS^T, and a key past the tile or P
  // in P^T
  const int srow = 2 * w + (lane >> 4), sq = 4 * (lane & 15);
  const bool key_in = srow < rows && j0 + srow < P;
  const float gm = key_in ? keep[(size_t)b * P + j0 + srow] * scale : 0.f;

  float acc[kGroups][4][4];
#pragma unroll
  for (int c = 0; c < kGroups; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  const int d_lo = w * Ds, d_hi = min(D, d_lo + Ds);
  const int nstep = d_hi > d_lo ? (d_hi - d_lo + 15) / 16 : 0;
  const int cw = blockIdx.y * kSlab + w * (kGroups * 32);  // warp's columns

  for (int i0 = 0; i0 < N; i0 += kTq) {
    const int qn = min(kTq, N - i0);             // real queries of the tile
    // read after the barrier that ends the partial products; the previous
    // tile's readers passed the barrier after its weight rows
    if (tid < kTq) {
      const bool in = tid < qn;
      lse_s[tid] = in ? lse[(size_t)b * N + i0 + tid] : 0.f;
      if constexpr (kDK)
        delta_s[tid] = in ? delta[(size_t)b * N + i0 + tid] : 0.f;
    }
    // 1. this warp's partial S^T = (K kscale) Q^T and, for dK, dP^T =
    // V dO^T over columns [d_lo, d_hi) of D
    float s[kTq / 8][4];
    dk_dv_partial<T, T, true, true, kVec>(s, mine, kt, ldk, 0, nullptr,
                                          ks_b, Qb, i0, N, qn, j0, rows, P,
                                          D, D, d_lo, nstep);
    float dp[kTq / 8][4];
    if constexpr (kDK)
      dk_dv_partial<T, float, kSame, false, kVec>(
          dp, mine, kt, ldk, 0, V + (size_t)b * P * D, ks_b, dOb, i0, N, qn,
          j0, rows, P, D, D, d_lo, nstep);
#pragma unroll
    for (int j = 0; j < kTq / 8; ++j) {
      float* ps = part + g * kQLd + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(ps) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(ps + 8 * kQLd) =
          make_float2(s[j][2], s[j][3]);
      if constexpr (kDK) {
        float* pd = ps + kRows * kQLd;
        *reinterpret_cast<float2*>(pd) = make_float2(dp[j][0], dp[j][1]);
        *reinterpret_cast<float2*>(pd + 8 * kQLd) =
            make_float2(dp[j][2], dp[j][3]);
      }
    }
    __syncthreads();  // every partial S^T (and dP^T) is written

    // 2. S^T (and dP^T) = the eight partials, summed in warp order; the
    // weight is P = exp(S g - lse) for dV, dS = P (dP - delta) g for dK_eff
    if (sq < kTq) {
      const float* p0 = reinterpret_cast<const float*>(areas) +
                        srow * kQLd + sq;
      float4 sx = lds4(p0), dx = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kDK) dx = lds4(p0 + kRows * kQLd);
#pragma unroll
      for (int u = 1; u < kWarps; ++u) {
        const float* pu =
            reinterpret_cast<const float*>(areas + u * kDkArea) +
            srow * kQLd + sq;
        const float4 y = lds4(pu);
        sx.x += y.x; sx.y += y.y; sx.z += y.z; sx.w += y.w;
        if constexpr (kDK) {
          const float4 z = lds4(pu + kRows * kQLd);
          dx.x += z.x; dx.y += z.y; dx.z += z.z; dx.w += z.w;
        }
      }
      float wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wv[e] = 0.f;
        if (key_in && sq + e < qn) {
          const float p = expf(elem(sx, e) * gm - lse_s[sq + e]);
          wv[e] = kDK ? p * (elem(dx, e) - delta_s[sq + e]) * gm : p;
        }
      }
      *reinterpret_cast<float4*>(w_s + srow * kWLd + sq) =
          make_float4(wv[0], wv[1], wv[2], wv[3]);
    }
    __syncthreads();  // the weights are written; the partials are read

    // 3. acc += W X over this warp's columns, 8 queries a step (W = dS^T
    // and X = Q for dK_eff, W = P^T and X = dO for dV): step i stages rows
    // i0 + 8i .. + 7 at the warp's 192 columns, kStages3 - 1 steps ahead;
    // dQ's dS K step with the roles of keys and queries swapped.
    const int nstep3 = cw < D ? (qn + 7) / 8 : 0;
    auto stage3 = [&](int i) {
      if (i < nstep3) {
        TS* dst = st3 + (i % kStages3) * kStep3;
        const TS* srow3 = Sb + (size_t)(i0 + 8 * i) * D;
        // a row's 48 four-element chunks: lanes 0-31, then lanes 0-15
#pragma unroll (kVec ? 8 : 1)
        for (int r = 0; r < 8; ++r) {
          const bool ok = i0 + 8 * i + r < N;
          const int q = 4 * lane;
          copy4<kVec>(dst + r * kLd3 + q, srow3 + (size_t)r * D, ok, cw + q,
                      D);
          if (lane < kGroups * 8 - 32)
            copy4<kVec>(dst + r * kLd3 + 128 + q, srow3 + (size_t)r * D, ok,
                        cw + 128 + q, D);
        }
      }
      cp_commit();
    };
#pragma unroll
    for (int i = 0; i < kStages3 - 1; ++i) stage3(i);
#pragma unroll 1
    for (int i = 0; i < nstep3; ++i) {
      stage3(i + kStages3 - 1);
      cp_wait<kStages3 - 1>();
      __syncwarp();                    // step i is staged, by every lane
      uint32_t ah[1][4], al[1][4];
      to_tf32<true>(w_s[g * kWLd + 8 * i + t], ah[0][0], al[0][0]);
      to_tf32<true>(w_s[(g + 8) * kWLd + 8 * i + t], ah[0][1], al[0][1]);
      to_tf32<true>(w_s[g * kWLd + 8 * i + t + 4], ah[0][2], al[0][2]);
      to_tf32<true>(w_s[(g + 8) * kWLd + 8 * i + t + 4], ah[0][3],
                    al[0][3]);
      const TS* sb = st3 + (i % kStages3) * kStep3;
      // one 32-column group at a time: its four n8 tiles (tile e's column
      // n is 32c + 4n + e)
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        fence();
        const float4 ra = lds4(sb + t * kLd3 + 32 * c + 4 * g);
        const float4 rc = lds4(sb + (t + 4) * kLd3 + 32 * c + 4 * g);
        uint32_t bh[4][2], bl[4][2];
        float x[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          to_tf32<kSplit3>(elem(ra, e), bh[e][0], bl[e][0]);
          to_tf32<kSplit3>(elem(rc, e), bh[e][1], bl[e][1]);
#pragma unroll
          for (int k = 0; k < 4; ++k) x[e][k] = 0.f;
        }
        mma_tile<true, kSplit3, 4, 1>(x, ah, al, bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) add_into(acc[c][e], x[e]);
      }
      __syncwarp();                    // every lane is done with step i
    }
    cp_wait<0>();
  }

  // each thread writes the columns it accumulated, as accumulated (dK_eff
  // is the gradient of the keys K kscale)
  float* outb = out + (size_t)b * P * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    if (r >= rows || j0 + r >= P) continue;
    float* orow = outb + (size_t)(j0 + r) * D;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      const int col = cw + 32 * c + 8 * t;  // tile e, n = 2t (+1): col + e (+4)
      store4<kVec>(orow, col, D,
                   make_float4(acc[c][0][2 * half], acc[c][1][2 * half],
                               acc[c][2][2 * half], acc[c][3][2 * half]));
      store4<kVec>(orow, col + 4, D,
                   make_float4(acc[c][0][2 * half + 1],
                               acc[c][1][2 * half + 1],
                               acc[c][2][2 * half + 1],
                               acc[c][3][2 * half + 1]));
    }
  }
}

// The fused dK/dV kernel: kDkdvStages steps in flight in each phase. Each
// warp accumulates kHalfGroups 32-column groups, a block kHalfCols columns.
constexpr int kDkdvStages = 2;
// A step of the accumulation: 8 streamed rows of Q (T) and of dO (float)
// at a warp's columns, rows padded as dQ's K steps; a step of dP^T: 64 dO
// rows at 16 columns, and V's 16 owned rows where V is not K; a warp's
// partial S^T or dP^T [kRows][kQLd].
template <typename T>
constexpr int kDkdvLdQ = kHalfGroups * 32 + 32 / (int)sizeof(T);
constexpr int kDkdvLdO = kHalfGroups * 32 + 8;
template <typename T>
constexpr int kDkdvStep3 = 8 * (kDkdvLdQ<T> * (int)sizeof(T) +
                                kDkdvLdO * (int)sizeof(float));
template <typename T>
constexpr int kDkdvStepP =
    (kTq * (int)sizeof(float) + kRows * (int)sizeof(T)) * 16;
constexpr int kPartBytes = kRows * kQLd * (int)sizeof(float);
// The per-warp staging area holds, in turn, steps of S^T (dk_dv_partial's),
// then S^T's partial at its head and steps of dP^T behind it, then both
// partials [2][kRows][kQLd], then steps of the accumulation: sized for
// kDkdvStages steps of each (14,848 bytes in float32, 13,824 in bfloat16).
// More steps in flight measured slower (scripts/dkdv_variants.py).
template <typename T>
constexpr int dkdv_area() {
  const int acc = kDkdvStages * kDkdvStep3<T>;
  const int dp = kPartBytes + kDkdvStages * kDkdvStepP<T>;
  const int most = acc > dp ? acc : dp;
  return most > 2 * kPartBytes ? most : 2 * kPartBytes;
}
template <typename T> constexpr int kDkdvArea = dkdv_area<T>();

// Shared-memory bytes of a dK/dV block: the owned K tile over the block's
// contraction half of D (in the input type), the warps' areas, P^T and dS^T
// [kRows][kWLd] each, the block's summed S^T and dP^T for the peer (the
// same), lse and delta per streamed query.
template <typename T>
size_t dkdv_smem_bytes(int D) {
  return (size_t)kRows * mma_q_ld(half_cut(D)) * sizeof(T) +
         (size_t)kWarps * kDkdvArea<T> +
         sizeof(float) * (4 * kRows * kWLd + 2 * kTq);
}

// One cluster of two blocks: key rows [j0, j0 + rows) of one image (rows is
// 16, or 8 with the lower half of every A tile zero), all queries. The
// block of rank h contracts columns [h Dc, min(D, (h + 1) Dc)) of D, Dc =
// half_cut(D), for partial S^T and dP^T, sums them with its peer's through
// distributed shared memory, and accumulates dV and dK_eff over columns
// [s kSlab + h kHalfCols, + kHalfCols) of D, s = blockIdx.y / 2 the column
// slab. kSame: V is K (one pointer), so dP^T takes its A rows from the
// owned K tile. kVec: D is a multiple of 4 and every pointer is 16-byte
// aligned.
template <typename T, bool kSame, bool kVec>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(kThreads, 1)
ca_dkdv_kernel(const T* Q, const T* K, const T* V, const float* keep,
               const float* kscale, const float* dO, const float* lse,
               const float* delta, float* dK, float* dV, int rows, int N,
               int P, int D, float scale) {
  constexpr bool kSplitQ = sizeof(T) == sizeof(float);   // dO is always
  constexpr int kLdQ = kDkdvLdQ<T>, kLdO = kDkdvLdO;
  constexpr int kOOff = 8 * kLdQ * (int)sizeof(T);       // dO's rows, bytes
  constexpr int kStep3 = kDkdvStep3<T>;
  constexpr int kArea = kDkdvArea<T>;
  constexpr int kStages3 = dk_stages<kStep3, kArea, kDkdvStages>();
  constexpr int kChunks = kHalfGroups * 8;   // four-element chunks of a row
  static_assert(kChunks <= 32, "a row's chunks a copy");
  static_assert(2 * kPartBytes <= kArea, "the partials must fit");
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.y & 1;               // == cluster.block_rank()
  const int Dc = half_cut(D);
  const int c_lo = rank * Dc, c_hi = min(D, c_lo + Dc);   // contracted
  const int Ds = mma_cols(Dc), ldk = mma_q_ld(Dc), kcols = kWarps * Ds;
  T* kt = reinterpret_cast<T*>(smem);                     // [kRows][ldk]
  char* areas = reinterpret_cast<char*>(kt + kRows * ldk);
  float* wp_s = reinterpret_cast<float*>(areas + kWarps * kArea);
  float* wds_s = wp_s + kRows * kWLd;            // P^T and dS^T [kRows][kWLd]
  float* xs = wds_s + kRows * kWLd;              // [2][kRows][kWLd]
  float* lse_s = xs + 2 * kRows * kWLd;          // [kTq]
  float* delta_s = lse_s + kTq;                  // [kTq]
  const float* peer_xs = cluster.map_shared_rank(xs, rank ^ 1);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * rows;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const float* dOb = dO + (size_t)b * N * D;
  const float* ks_b = kscale + (size_t)b * D;
  char* mine = areas + w * kArea;                // this warp's area
  float* part = reinterpret_cast<float*>(mine);  // [2][kRows][kQLd]

  // the owned K rows over this block's half of D, raw; rows past the tile
  // or P and columns past the half are 0
  for (int i = tid; i < kRows * kcols; i += kThreads) {
    const int r = i / kcols, d = i % kcols;
    store(kt + r * ldk + d,
          r < rows && j0 + r < P && c_lo + d < c_hi
              ? to_f(Kb[(size_t)(j0 + r) * D + c_lo + d]) : 0.f);
  }
  __syncthreads();  // the K tile is written
  // the weights: warp w forms keys 2w and 2w + 1, 16 lanes a key, 4 queries
  // a lane; a key past the tile or P, or a gated one (g = 0), has weight 0
  // in dS^T, and a key past the tile or P in P^T
  const int srow = 2 * w + (lane >> 4), sq = 4 * (lane & 15);
  const bool key_in = srow < rows && j0 + srow < P;
  const float gm = key_in ? keep[(size_t)b * P + j0 + srow] * scale : 0.f;

  float acc_v[kHalfGroups][4][4], acc_k[kHalfGroups][4][4];
#pragma unroll
  for (int c = 0; c < kHalfGroups; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_v[c][j][e] = acc_k[c][j][e] = 0.f;
  const int d_lo = c_lo + w * Ds, d_hi = min(c_hi, d_lo + Ds);
  const int nstep = d_hi > d_lo ? (d_hi - d_lo + 15) / 16 : 0;
  const int cw = (blockIdx.y >> 1) * kSlab + rank * kHalfCols +
                 w * (kHalfGroups * 32);         // the warp's output columns

  for (int i0 = 0; i0 < N; i0 += kTq) {
    const int qn = min(kTq, N - i0);             // real queries of the tile
    // read after the barrier that ends the partial products; the previous
    // tile's readers passed the barrier after its weights
    if (tid < kTq) {
      const bool in = tid < qn;
      lse_s[tid] = in ? lse[(size_t)b * N + i0 + tid] : 0.f;
      delta_s[tid] = in ? delta[(size_t)b * N + i0 + tid] : 0.f;
    }
    // 1. this warp's partial S^T = (K kscale) Q^T and dP^T = V dO^T over
    // columns [d_lo, d_hi) of this block's half of D; S^T's partial goes to
    // the head of the area before dP^T stages behind it, so one partial at
    // a time is held in registers. Lane (g, t) holds rows g and g + 8,
    // queries 8j + 2t and + 1 of n8 tile j.
    const auto put = [&](float* pt, const float (&x)[kTq / 8][4]) {
#pragma unroll
      for (int j = 0; j < kTq / 8; ++j) {
        float* pj = pt + g * kQLd + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(pj) = make_float2(x[j][0], x[j][1]);
        *reinterpret_cast<float2*>(pj + 8 * kQLd) =
            make_float2(x[j][2], x[j][3]);
      }
    };
    {
      float s[kTq / 8][4];
      dk_dv_partial<T, T, true, true, kVec, kArea, kDkdvStages>(
          s, mine, kt, ldk, c_lo, nullptr, ks_b, Qb, i0, N, qn, j0, rows, P,
          D, c_hi, d_lo, nstep);
      put(part, s);
    }
    {
      float dp[kTq / 8][4];
      dk_dv_partial<T, float, kSame, false, kVec, kArea - kPartBytes,
                    kDkdvStages>(
          dp, mine + kPartBytes, kt, ldk, c_lo, V + (size_t)b * P * D, ks_b,
          dOb, i0, N, qn, j0, rows, P, D, c_hi, d_lo, nstep);
      put(part + kRows * kQLd, dp);
    }
    __syncthreads();  // every partial is written

    // 2. this block's S^T and dP^T: the eight partials, summed in warp
    // order, put where the peer reads them (it passed the last tile's
    // second cluster barrier once it was done with the last tile's)
    const float* p0 = reinterpret_cast<const float*>(areas) + srow * kQLd + sq;
    float4 sx = lds4(p0), dx = lds4(p0 + kRows * kQLd);
#pragma unroll
    for (int u = 1; u < kWarps; ++u) {
      const float* pu =
          reinterpret_cast<const float*>(areas + u * kArea) +
          srow * kQLd + sq;
      const float4 y = lds4(pu), z = lds4(pu + kRows * kQLd);
      sx.x += y.x; sx.y += y.y; sx.z += y.z; sx.w += y.w;
      dx.x += z.x; dx.y += z.y; dx.z += z.z; dx.w += z.w;
    }
    *reinterpret_cast<float4*>(xs + srow * kWLd + sq) = sx;
    *reinterpret_cast<float4*>(xs + (kRows + srow) * kWLd + sq) = dx;
    cluster.sync();  // both blocks' sums are written; every partial is read

    // 3. S^T = own + peer and dP^T = own + peer: the same bits in both
    // blocks, since float addition commutes, so both form the same weights
    // P = exp(S g - lse) and dS = P (dP - delta) g; queries past N weigh 0
    {
      const float4 py = lds4(peer_xs + srow * kWLd + sq);
      const float4 pz = lds4(peer_xs + (kRows + srow) * kWLd + sq);
      float wv[4], wd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wv[e] = wd[e] = 0.f;
        if (key_in && sq + e < qn) {
          const float p =
              expf((elem(sx, e) + elem(py, e)) * gm - lse_s[sq + e]);
          wv[e] = p;
          wd[e] = p * (elem(dx, e) + elem(pz, e) - delta_s[sq + e]) * gm;
        }
      }
      *reinterpret_cast<float4*>(wp_s + srow * kWLd + sq) =
          make_float4(wv[0], wv[1], wv[2], wv[3]);
      *reinterpret_cast<float4*>(wds_s + srow * kWLd + sq) =
          make_float4(wd[0], wd[1], wd[2], wd[3]);
    }
    // The peer has read this block's sums: the next tile may overwrite
    // them. This also keeps each block's shared memory alive until its peer
    // is done with it, so nothing after the last tile needs another
    // barrier; and the weights are written.
    cluster.sync();

    // 4. dV += P^T dO and dK_eff += dS^T Q over this warp's columns, 8
    // queries a step: step i stages rows i0 + 8i .. + 7 of Q and dO at the
    // warp's columns, kStages3 - 1 steps ahead; group c's rows t and t + 4
    // at columns 32c + 4g .. + 3 give the B fragments of its four n8 tiles
    // (tile e's column n is 32c + 4n + e), for dO and for Q
    const int nstep3 = cw < D ? (qn + 7) / 8 : 0;
    auto stage3 = [&](int i) {
      if (i < nstep3) {
        char* slot = mine + (i % kStages3) * kStep3;
        T* qd = reinterpret_cast<T*>(slot);
        float* od = reinterpret_cast<float*>(slot + kOOff);
        const int r0 = i0 + 8 * i;
        // a row a copy, lanes past its chunks idle: one column offset a
        // lane (six a lane cost the float32 builds spills)
        const int q = 4 * lane;
#pragma unroll (kVec ? 8 : 1)
        for (int r = 0; r < 8 && lane < kChunks; ++r) {
          const bool ok = r0 + r < N;
          copy4<kVec>(qd + r * kLdQ + q, Qb + (size_t)(r0 + r) * D, ok,
                      cw + q, D);
          copy4<kVec>(od + r * kLdO + q, dOb + (size_t)(r0 + r) * D, ok,
                      cw + q, D);
        }
      }
      cp_commit();
    };
#pragma unroll
    for (int i = 0; i < kStages3 - 1; ++i) stage3(i);
#pragma unroll 1
    for (int i = 0; i < nstep3; ++i) {
      stage3(i + kStages3 - 1);
      cp_wait<kStages3 - 1>();
      __syncwarp();                    // step i is staged, by every lane
      uint32_t aph[1][4], apl[1][4], adh[1][4], adl[1][4];
      // A fragments {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = (g + 8 * (r & 1)) * kWLd + 8 * i + t + 4 * (r >> 1);
        to_tf32<true>(wp_s[o], aph[0][r], apl[0][r]);
        to_tf32<true>(wds_s[o], adh[0][r], adl[0][r]);
      }
      const char* slot = mine + (i % kStages3) * kStep3;
      const T* qb = reinterpret_cast<const T*>(slot);
      const float* ob = reinterpret_cast<const float*>(slot + kOOff);
#pragma unroll
      for (int c = 0; c < kHalfGroups; ++c) {
        uint32_t bh[4][2], bl[4][2];
        float x[4][4];
        fence();
        const float4 oa = lds4(ob + t * kLdO + 32 * c + 4 * g);
        const float4 oc = lds4(ob + (t + 4) * kLdO + 32 * c + 4 * g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          to_tf32<true>(elem(oa, e), bh[e][0], bl[e][0]);
          to_tf32<true>(elem(oc, e), bh[e][1], bl[e][1]);
#pragma unroll
          for (int n = 0; n < 4; ++n) x[e][n] = 0.f;
        }
        mma_tile<true, true, 4, 1>(x, aph, apl, bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) add_into(acc_v[c][e], x[e]);
        fence();
        const float4 qa = lds4(qb + t * kLdQ + 32 * c + 4 * g);
        const float4 qc = lds4(qb + (t + 4) * kLdQ + 32 * c + 4 * g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          to_tf32<kSplitQ>(elem(qa, e), bh[e][0], bl[e][0]);
          to_tf32<kSplitQ>(elem(qc, e), bh[e][1], bl[e][1]);
#pragma unroll
          for (int n = 0; n < 4; ++n) x[e][n] = 0.f;
        }
        mma_tile<true, kSplitQ, 4, 1>(x, adh, adl, bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) add_into(acc_k[c][e], x[e]);
      }
      __syncwarp();                    // every lane is done with step i
    }
    cp_wait<0>();
    __syncwarp();
  }

  // each thread writes the columns it accumulated, as accumulated (dK_eff
  // is the gradient of the keys K kscale)
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = g + 8 * hi;
    if (r >= rows || j0 + r >= P) continue;
    float* krow = dK + ((size_t)b * P + j0 + r) * D;
    float* vrow = dV + ((size_t)b * P + j0 + r) * D;
#pragma unroll
    for (int c = 0; c < kHalfGroups; ++c) {
      const int col = cw + 32 * c + 8 * t;  // tile e, n = 2t (+1): col + e (+4)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int e2 = 2 * hi + o;
        store4<kVec>(krow, col + 4 * o, D,
                     make_float4(acc_k[c][0][e2], acc_k[c][1][e2],
                                 acc_k[c][2][e2], acc_k[c][3][e2]));
        store4<kVec>(vrow, col + 4 * o, D,
                     make_float4(acc_v[c][0][e2], acc_v[c][1][e2],
                                 acc_v[c][2][e2], acc_v[c][3][e2]));
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *keep, *kscale, *dO, *lse, *delta;
  float *out, *out2;
  int B, N, P, D;
  float scale;
  cudaStream_t stream;
  int* plan = nullptr;  // dQ and dK/dV: fill the launch plan, do not launch
};

// dQ with `rows` query rows a block; with a.plan, the launch plan instead.
template <typename T, bool kSame, bool kVec>
int launch_dq(const Args& a, int rows) {
  const size_t smem = dq_smem_bytes(a.D);
  const auto kernel = ca_dq_kernel<T, kSame, kVec>;
  if (int err = opt_in_smem(kernel, smem)) return err;
  const dim3 grid((a.N + rows - 1) / rows, (a.D + kSlab - 1) / kSlab, a.B);
  if (a.plan != nullptr) return block_plan(kernel, grid, smem, rows, a.plan);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, a.dO, a.lse, a.delta,
      a.out, rows, a.N, a.P, a.D, a.scale);
  return (int)cudaGetLastError();
}

// dQ: 16-row blocks, or 8-row ones when 16-row blocks would leave SMs idle
// (the forward's rule); one build whose staged K rows serve S and dP where
// V is K (the main path's call), one that stages both; 16-byte copies where
// D is a multiple of 4 and every pointer is aligned, else element by
// element.
template <typename T>
int launch_dq_rows(const Args& a) {
  if (a.B > 65535) return (int)cudaErrorInvalidValue;
  const int rows =
      (long long)a.B * ((a.N + kRows - 1) / kRows) < sm_count() ? 8 : kRows;
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a.D % 4 == 0 && aligned(a.q) && aligned(a.k) &&
                   aligned(a.v) && aligned(a.dO) && aligned(a.kscale) &&
                   aligned(a.out);
  const bool same = a.k == a.v;
  if (same)
    return vec ? launch_dq<T, true, true>(a, rows)
               : launch_dq<T, true, false>(a, rows);
  return vec ? launch_dq<T, false, true>(a, rows)
             : launch_dq<T, false, false>(a, rows);
}

// The fused dK/dV kernel with `rows` key rows a cluster; with a.plan, the
// launch plan instead.
template <typename T, bool kSame, bool kVec>
int launch_dkdv(const Args& a, int rows) {
  const size_t smem = dkdv_smem_bytes<T>(a.D);
  const auto kernel = ca_dkdv_kernel<T, kSame, kVec>;
  if (int err = opt_in_smem(kernel, smem)) return err;
  const dim3 grid((a.P + rows - 1) / rows, 2 * ((a.D + kSlab - 1) / kSlab),
                  a.B);
  if (a.plan != nullptr) return cluster_plan(kernel, grid, smem, rows, a.plan);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, a.dO, a.lse, a.delta,
      a.out, a.out2, rows, a.N, a.P, a.D, a.scale);
  return (int)cudaGetLastError();
}

// dK_eff and dV together, in clusters of two blocks that run one per SM:
// 16-key clusters where they give every SM a block, or where 8-key ones
// would not all fit at once (at 256^2, B = 1: 61 clusters of 16 keys in one
// wave, not 121 of 8 in two); 8 keys otherwise (the D-split forward's
// rule). dK's builds: one whose owned K rows serve S^T and dP^T where V is
// K (the main path's call), one that stages V's rows; 16-byte copies where
// D is a multiple of 4 and every pointer is aligned, else element by
// element.
template <typename T>
int launch_dkdv_rows(const Args& a) {
  if (a.B > 65535) return (int)cudaErrorInvalidValue;
  const auto blocks = [&](int tile) {
    return 2LL * ((a.D + kSlab - 1) / kSlab) * a.B * ((a.P + tile - 1) / tile);
  };
  const int rows =
      blocks(kRows) >= sm_count() || blocks(8) > sm_count() ? kRows : 8;
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a.D % 4 == 0 && aligned(a.q) && aligned(a.k) &&
                   aligned(a.v) && aligned(a.dO) && aligned(a.kscale) &&
                   aligned(a.out) && aligned(a.out2);
  if (a.k != a.v)
    return vec ? launch_dkdv<T, false, true>(a, rows)
               : launch_dkdv<T, false, false>(a, rows);
  return vec ? launch_dkdv<T, true, true>(a, rows)
             : launch_dkdv<T, true, false>(a, rows);
}

// dK_eff (kDK) or dV with `rows` key rows a block; with a.plan, the launch
// plan instead.
template <typename T, bool kDK, bool kSame, bool kVec>
int launch_dk_dv(const Args& a, int rows) {
  const size_t smem = dk_dv_smem_bytes<T>(a.D);
  const auto kernel = ca_dk_or_dv_kernel<T, kDK, kSame, kVec>;
  if (int err = opt_in_smem(kernel, smem)) return err;
  const dim3 grid((a.P + rows - 1) / rows, (a.D + kSlab - 1) / kSlab, a.B);
  if (a.plan != nullptr) return block_plan(kernel, grid, smem, rows, a.plan);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, a.dO, a.lse, a.delta,
      a.out, rows, a.N, a.P, a.D, a.scale);
  return (int)cudaGetLastError();
}

// dK_eff or dV: dQ's rule with keys for queries (16-row blocks, or 8-row
// ones when 16-row blocks would leave SMs idle), and dQ's builds: for dK one
// whose owned K rows serve S^T and dP^T where V is K (the main path's call),
// one that stages V's rows; 16-byte copies where D is a multiple of 4 and
// every pointer is aligned, else element by element. dV reads no V.
template <typename T, bool kDK>
int launch_dk_dv_rows(const Args& a) {
  if (a.B > 65535) return (int)cudaErrorInvalidValue;
  const int rows =
      (long long)a.B * ((a.P + kRows - 1) / kRows) < sm_count() ? 8 : kRows;
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a.D % 4 == 0 && aligned(a.q) && aligned(a.k) &&
                   aligned(a.v) && aligned(a.dO) && aligned(a.kscale) &&
                   aligned(a.out);
  if constexpr (kDK) {
    if (a.k != a.v)
      return vec ? launch_dk_dv<T, true, false, true>(a, rows)
                 : launch_dk_dv<T, true, false, false>(a, rows);
  }
  return vec ? launch_dk_dv<T, kDK, true, true>(a, rows)
             : launch_dk_dv<T, kDK, true, false>(a, rows);
}

// which: 0 dq, 1 dkdv, 2 dv, 3 dk.
template <typename T>
int launch(int which, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.P <= 0 || a.D <= 0)
    return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0:
      return launch_dq_rows<T>(a);
    case 1:
      return launch_dkdv_rows<T>(a);
    case 2:
      return launch_dk_dv_rows<T, false>(a);
    case 3:
      return launch_dk_dv_rows<T, true>(a);
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
// device, without a launch (V taken to be K, as on the main path): plan[0]
// tile keys, [1] blocks per cluster, [2] the most clusters resident at once
// (cudaOccupancyMaxActiveClusters), [3] dynamic shared-memory bytes per
// block, [4] clusters in the grid.
int sketchedit_contextual_attention_dkdv_plan(int dtype, int B, int N, int P,
                                              int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  return launch_typed(1, dtype, a);
}

// The dQ kernel's launch plan for these shapes on the current device,
// without a launch (V taken to be K, as on the main path): plan[0] query
// rows per block, [1] column slabs, [2] the most blocks resident at once on
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [3] dynamic
// shared-memory bytes per block, [4] blocks in the grid.
int sketchedit_contextual_attention_dq_plan(int dtype, int B, int N, int P,
                                            int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  return launch_typed(0, dtype, a);
}

// The dV (dk = 0) or dK (dk = 1) kernel's launch plan for these shapes on
// the current device, without a launch (V taken to be K, as on the main
// path), in dq_plan's order: plan[0] key rows per block, [1] column slabs,
// [2] the most blocks resident at once on an SM, [3] dynamic shared-memory
// bytes per block, [4] blocks in the grid.
int sketchedit_contextual_attention_dv_plan(int dtype, int B, int N, int P,
                                            int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  return launch_typed(2, dtype, a);
}

int sketchedit_contextual_attention_dk_plan(int dtype, int B, int N, int P,
                                            int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  return launch_typed(3, dtype, a);
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
