// Contextual-attention backward for Hopper (sm_90a), CUDA C++: four kernels
// and the joint sequence of two of them.
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
//   dq:          dQ_i     = sum_j dS_ij K_eff_j
//   dkdv:        dV_j     = sum_i P_ij dO_i,   dK_eff_j = sum_i dS_ij Q_i
//   bwd (joint): dQ, dK_eff and dV, from one S, dP and dS
//   dv kernel:   dV alone (reads neither V nor delta)
//   dk kernel:   dK_eff alone
//
// The gate rules are the forward's: keep = 0 gives logit 0 (P = exp(-lse))
// and a zero dS multiplier; keys past P contribute nothing; ragged N, P and
// D are bounds checks or TMA's zero fill, never padded copies of the
// inputs. Q, K and V are float32 or bfloat16; dO, lse, delta and every
// output are float32. Every product runs on the tensor cores in split TF32
// (float32-accurate, as the forwards'). dO is not rounded to the input type
// (the JAX package streams it in the input type to halve its DMA): these
// kernels are bound by operations, not bytes, so the rounding would buy
// nothing.
//
// What bounds them on an H100. At 256^2 (N = P = 961, D = 1536) dq runs
// three products of N P D multiply-adds (6 N P D = 8.5 GFLOP
// per image, 0.127 ms at the SXM's 67 TFLOP/s of float32, 0.052 ms as split
// TF32 at three passes of 495 TFLOP/s) and the fused dK/dV four (11.4
// GFLOP, 0.169 ms, 0.069 ms as split TF32), against ~30 MB of float32 traffic
// (~0.009 ms): both are bound by operations. The dv kernel runs two
// products and the dk kernel three, five together where the fused dK/dV
// runs four, since both recompute S and P.
//
// Design. Blocks run in parallel, so the sequential axis of each TPU grid
// becomes a loop inside the block or a launch of its own, and each block
// owns its output rows outright (no atomics, no second pass). dq and dkdv
// are the default forward's wgmma sequence (contextual_attention_fwd.cu
// header; contextual_attention_wgmma.cuh: TMA-fed warpgroup products, a
// fresh accumulator per k8 step added with one round-to-nearest FADD, no
// atomics and a fixed order, so two calls give the same bits), each on a
// scratch the wrapper allocates, each phase one launch:
// - dq, launches named ca_dq_*, the forward's shape with dS in place of P:
//     prep     once a call, the TF32 terms of K by rows (B, P, Dp; V's
//              apart where V is not K, so on the main path one set serves
//              S and dP), of K transposed (B, D, Pp), the B operand of
//              dS K (TF32 wgmma takes both operands K-major: only 16-bit
//              types may be transposed), and of Q kscale and dO by rows
//              (B, N, Dp), all queries at once, so only S, dP and dS grow
//              with the query rows. A bfloat16 K is one exact term;
//   then per chunk of query rows (the part of the scratch that grows with
//   the query rows, S, dP and dS's terms, is capped as the forward's is,
//   so large shapes take chunks):
//     S, dP    (Q kscale) K^T and dO V^T, dkdv's score block and sum below,
//              so the same values as its S and dP;
//     weights  P = exp(S g - lse) and dS = P (dP - delta) g, written by
//              rows (B, rows, Pp) as TF32 terms, 0 past P;
//     dQ       dS (K^T)^T, the forward's P V block (128 queries x 96
//              columns, two warpgroups over the rows sharing each B box;
//              64 x 192 in bfloat16, whose K^T terms are one), every step
//              added to the total (a chain of 121 at P = 961), and kscale
//              on each column in the epilogue, so K enters raw and stays
//              one term in bfloat16.
//   At 256^2, B = 1 every product is 128 blocks on 132 SMs; 8 launches a
//   call.
// - dkdv, launches named ca_dkdv_*:
//     prep     once a call, the TF32 terms of K (V's apart where V is not K;
//              on the main path one set serves S and dP), of Q kscale and
//              dO by rows (B, N, Dp), and of Q and dO transposed to (B, D,
//              Np): dV and dK contract over the queries. A bfloat16 Q or K
//              is one exact term;
//   then per chunk of key rows (the part of the scratch that grows with
//   the keys, S, dP and the weights' terms, is capped as the forward's
//   is, so large shapes take chunks):
//     S        (Q kscale) K^T, the forward's logits block (64 queries x 128
//              keys), its steps summed in runs of 16, each run added to
//              the total with Kahan's compensation (kept in shared memory:
//              the registers of a nine-warp block hold no more), which puts
//              dK and dV 0.72-0.87x the dK and dV kernels' distance from
//              float64 (relative L2) where plain run sums gave 0.91-1.13x;
//     dP       dO V^T, the same block and sum (dS carries dP's error times
//              P g, as S's through the softmax scale);
//     weights  P = exp(S g - lse) and dS = P (dP - delta) g, written
//              transposed (B, keys, Np) as TF32 terms through 32 x 32
//              shared-memory tiles;
//     dV, dK   P^T dO and dS^T Q, the forward's P V block (128 keys x 96
//              columns, two warpgroups over the rows sharing each B box;
//              dK in bfloat16 64 x 192, its Q^T one term), every step
//              added to the total (a chain of 121 at N = 961, as the dV
//              and dK kernels' accumulation).
//   Every product takes its A operand split (Q kscale, dO, P^T and dS^T
//   hold float32 values); the tensor maps' extents end the contraction at
//   D or N, so TMA reads zeros past them. Shared memory sets no widest D.
//   At 256^2, B = 1 every product is 128 blocks on 132 SMs.
// - bwd, the default route: dkdv's sequence with dQ added, so S, dP and dS
//   are formed once for the three products where dq and dkdv each form
//   them (the same bits: both use the same blocks and sums):
//     prep     dkdv's copies, and K transposed (B, D, Pp) as dq's prep
//              forms it;
//   then per chunk of key rows (dS's terms by rows counted in the cap):
//     S, dP, weights, dV, dK   as dkdv's, the weights pass also writing dS
//              by rows (B, N, ld) from the values it transposes;
//     dQ       dS[:, chunk] K_eff[chunk]: dq's product block over the
//              chunk's keys (A the chunk's dS rows, B K^T's columns r0 on),
//              kscale on the columns; the first chunk stores dQ, each later
//              one adds its part with one FADD (the launches are ordered on
//              the stream and each block owns its tile: no atomics). One
//              chunk gives dq's dQ bit for bit.
//   At 256^2 12 launches a call, where dq and dkdv take 8 + 10.
// - dv and dk: split TF32 on the tensor cores (mma.sync): 8 warps over
//   kRows = 16 key rows (8 where 16-row blocks would leave SMs idle, the
//   lower half of every A tile then zero) of one image, all queries in
//   tiles of kT = 64, a slab of up to 1536 output columns. Warp w owns 192
//   output columns as 24 m16n8 fragments in registers (96 floats a
//   thread), so no accumulator sits in shared memory. Every product is
//   mma.sync m16n8k8 TF32 through mma_tile: an operand holding float32
//   values is split in two TF32 terms, one holding bfloat16 data enters
//   whole. The tensor cores add into an accumulator with truncation, so
//   every k8 step starts a fresh one and is added with a round-to-nearest
//   FADD. The owned K rows stay raw in the input type in shared memory
//   (99 KB in float32, 50 KB in bfloat16 at D = 1536; a float32 tile costs
//   5% in bfloat16), and kscale goes on them as S^T's A fragments are
//   formed, so in bfloat16 Q enters S^T whole and K enters dP^T whole:
//   both products take two passes, and only dO and K kscale are split
//   (three passes in float32). Per query tile:
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
//            columns staged with cp.async, steps ahead.
//   dK_eff is written as accumulated. A block takes 206 KB of shared memory
//   in float32 and runs alone on its SM; D up to 1920 fits, a wider D than
//   1536 takes more column slabs, each recomputing S^T and dP^T. Each warp
//   is held back by its own chain of fragment loads, splits, mma passes
//   and FADDs: a float32 step converts 80 operands for its mma
//   (scripts/dk_dv_variants.py clocks each phase; 16-row blocks, 8 where
//   16 leave SMs idle, 64-query tiles and a 12.8 KB area measured best).

#include <type_traits>

#include "contextual_attention_common.cuh"
#include "contextual_attention_wgmma.cuh"

namespace {

// The dK and dV kernels' per-warp staging area, kDkArea bytes, holds
// one of three things in turn: steps of one partial product (the block's kTq
// streamed Q or dO rows at 16 columns of D, and V's owned rows at the same
// columns where V is not K), or the warp's partials [2][kRows][kQLd]
// (S^T, then dP^T), or steps of the accumulation (8 streamed Q or dO rows at
// the warp's 192 columns, rows padded by 32 bytes). S^T and dP^T run as two
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

// Steps in flight in a staging area for a step of kBytes.
template <int kBytes>
__host__ __device__ constexpr int dk_stages() {
  static_assert(kBytes <= kDkArea, "a step must fit");
  return kDkArea / kBytes;
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
// rows are the owned K tile's (kOwnA; times kscale where kScaleA, for S,
// its 16 values staged with the step) or V's owned rows, staged with the
// step (dP where V is not K); the B rows are Bb's (Q in T for S, dO in
// float32 for dP), staged with cp.async in the warp's own area, steps
// ahead. Columns past D are staged as 0. An operand holding float32 values is split (K kscale
// always; K, V and Q in float32; dO always), one holding bfloat16 data
// enters whole. Lane (g, t) reads columns 4t .. 4t + 3 of a step: k = t and
// t + 4 of k8 step h are 4t + 2h and + 1 on both sides. Two n8 tiles a pass
// (four independent mma); tiles past the tile's last real query are
// skipped.
template <typename T, typename TB, bool kOwnA, bool kScaleA, bool kVec>
__device__ __forceinline__ void dk_dv_partial(
    float (&acc)[kTq / 8][4], char* mine, const DkOwned<T>* ktile, int ldk,
    const T* Vb, const float* ks_b, const TB* Bb, int i0, int N, int qn,
    int j0, int rows, int P, int D, int d_lo, int nstep) {
  constexpr bool kSplitA = kScaleA || sizeof(T) == sizeof(float);
  constexpr bool kSplitB = sizeof(TB) == sizeof(float);
  constexpr int kStepB = kTq * 16 * (int)sizeof(TB);
  constexpr int kStepV = kStepB + (kScaleA ? 16 * (int)sizeof(float) : 0);
  constexpr int kStep = kStepV + (kOwnA ? 0 : kRows * 16 * (int)sizeof(T));
  constexpr int kStages = dk_stages<kStep>();
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
                    i0 + r < N, d0 + q, D);
      }
      if constexpr (kScaleA) {
        if (lane < 4)
          copy4<kVec>(reinterpret_cast<float*>(slot + kStepB) + 4 * lane,
                      ks_b, true, d0 + 4 * lane, D);
      }
      if constexpr (!kOwnA) {
        T* vd = reinterpret_cast<T*>(slot + kStepV);
#pragma unroll
        for (int n = 0; n < kRows * 4 / 32; ++n) {
          const int r = (lane >> 2) + 8 * n;
          copy4<kVec>(vd + r * 16 + q, Vb + (size_t)(j0 + r) * D,
                      r < rows && j0 + r < P, d0 + q, D);
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
      xa = lds4(ktile + g * ldk + d);
      xb = lds4(ktile + (g + 8) * ldk + d);
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
    dk_dv_partial<T, T, true, true, kVec>(s, mine, kt, ldk, nullptr, ks_b,
                                          Qb, i0, N, qn, j0, rows, P, D,
                                          d_lo, nstep);
    float dp[kTq / 8][4];
    if constexpr (kDK)
      dk_dv_partial<T, float, kSame, false, kVec>(
          dp, mine, kt, ldk, V + (size_t)b * P * D, ks_b, dOb, i0, N, qn,
          j0, rows, P, D, d_lo, nstep);
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
    // i0 + 8i .. + 7 at the warp's 192 columns, kStages3 - 1 steps ahead.
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

// --- dQ and the fused dK/dV: TMA-fed wgmma ----------------------------------
// (the prep bodies and the product's body: contextual_attention_wgmma.cuh)

constexpr int kKeyCols = 64;     // keys a warpgroup in S and dP
constexpr int kGradCols = 96;    // output columns a warpgroup in dQ, dV, dK
constexpr int kScoreGroup = kSumStages;  // stages S and dP sum apart
constexpr bool kScoreKahan = true;       // and add to their totals
constexpr int kGradGroup = 0;            // and dQ, dV and dK (every step)

// Rows r0 .. r0 + rc of each image of `in` (B, rows_in, D), times ks (B, D)
// where given, as TF32 terms (B, rc, Dp); one block a row.
template <typename T>
__global__ void __launch_bounds__(256)
ca_dkdv_split_rows(const T* in, const float* ks, float* hi, float* lo,
                   int rows_in, int r0, int rc, int D) {
  split_rows(in, ks, hi, lo, rows_in, r0, rc, D);
}
template <typename T>
__global__ void __launch_bounds__(256)
ca_dq_split_rows(const T* in, const float* ks, float* hi, float* lo,
                 int rows_in, int r0, int rc, int D) {
  split_rows(in, ks, hi, lo, rows_in, r0, rc, D);
}

// X (B, N, D) transposed to (B, D, Np) as TF32 terms, 0 past N.
template <typename T>
__global__ void __launch_bounds__(256)
ca_dkdv_split_t(const T* X, float* hi, float* lo, int N, int D) {
  split_t(X, hi, lo, N, D);
}
template <typename T>
__global__ void __launch_bounds__(256)
ca_dq_split_t(const T* X, float* hi, float* lo, int N, int D) {
  split_t(X, hi, lo, N, D);
}

// Where a product's epilogue writes: out[b * bstride + i * ld + j] = acc,
// times cs[b * cols + j] where cs is given (dQ's kscale), for rows i <
// rows and columns j < cols of image b; where `add`, added to what out
// holds there with one round-to-nearest FADD (the joint backward's dQ
// after its first chunk of keys).
struct GradEpi {
  float* out;
  long long bstride;
  int rows, cols, ld;
  const float* cs;
  bool add;
};

// A product of dQ or the fused dK/dV (S, dP, dQ, dV or dK):
// wgmma_product's block, summing its steps in runs of kGroup stages where
// kGroup > 0 (the runs added to the total with Kahan's compensation where
// kCompensate), and a float32 store of each accumulator, scaled by its
// column's cs where e.cs is given.
template <int kWN, int kMW, bool kSplitB, int kStages, int kGroup,
          bool kCompensate>
__device__ __forceinline__ void grad_product(const CUtensorMap& a_hi,
                                             const CUtensorMap& a_lo,
                                             const CUtensorMap& b_hi,
                                             const CUtensorMap& b_lo, int K,
                                             const GradEpi& e) {
  constexpr int kBM = kTileM * kMW, kBN = kWN * 2 / kMW;  // the block's tile
  float acc[kWN / 2];
  if (!wgmma_product<kWN, kMW, kSplitB, kStages, kGroup, kCompensate>(
          a_hi, a_lo, b_hi, b_lo, K, acc))
    return;                                               // the producer
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  // acc[4j + 2v + h] is row r + 8v, column cb + 8j + h
  const int r = blockIdx.x * kBM + (kMW == 2 ? wg * kTileM : 0) +
                16 * (warp & 3) + (lane >> 2);
  const int cb = blockIdx.y * kBN + (kMW == 2 ? 0 : wg * kWN) + 2 * (lane & 3);
  float* o = e.out + (long long)blockIdx.z * e.bstride;
  const float* cs =
      e.cs == nullptr ? nullptr : e.cs + (long long)blockIdx.z * e.cols;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int i = r + 8 * v;
    if (i >= e.rows) continue;
    float* orow = o + (long long)i * e.ld;
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = cb + 8 * j + h;
        if (col >= e.cols) continue;
        const float x = acc[4 * j + 2 * v + h];
        const float y = cs == nullptr ? x : x * __ldg(cs + col);
        orow[col] = e.add ? __fadd_rn(orow[col], y) : y;
      }
  }
}

template <int kWN, int kMW, bool kSplitB, int kStages, int kGroup,
          bool kCompensate>
__global__ void __launch_bounds__(kWgThreads, 1)
ca_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap a_hi,
                     const __grid_constant__ CUtensorMap a_lo,
                     const __grid_constant__ CUtensorMap b_hi,
                     const __grid_constant__ CUtensorMap b_lo, int K,
                     GradEpi e) {
  grad_product<kWN, kMW, kSplitB, kStages, kGroup, kCompensate>(
      a_hi, a_lo, b_hi, b_lo, K, e);
}
template <int kWN, int kMW, bool kSplitB, int kStages, int kGroup,
          bool kCompensate>
__global__ void __launch_bounds__(kWgThreads, 1)
ca_dq_wgmma_kernel(const __grid_constant__ CUtensorMap a_hi,
                   const __grid_constant__ CUtensorMap a_lo,
                   const __grid_constant__ CUtensorMap b_hi,
                   const __grid_constant__ CUtensorMap b_lo, int K,
                   GradEpi e) {
  grad_product<kWN, kMW, kSplitB, kStages, kGroup, kCompensate>(
      a_hi, a_lo, b_hi, b_lo, K, e);
}

// dQ's weights for one chunk of rc query rows from r0 on, one block a row,
// 4 keys a thread: with g = keep * scale, P = exp(S g - lse) and dS =
// P (dP - delta) g from S and dP (B, rc, Pp), written by rows (B, rc, Pp)
// as TF32 terms; 0 past P. (The same expressions as the fused dK/dV's
// weights, so the same dS.)
__global__ void __launch_bounds__(256)
ca_dq_weights(const float* s, const float* dp, const float* keep,
              const float* lse, const float* delta, float* d_hi, float* d_lo,
              int N, int P, int r0, int rc, float scale) {
  const int Pp = round4(P);
  const int b = blockIdx.x / rc, i = r0 + blockIdx.x % rc;
  const long long row = (long long)blockIdx.x * Pp;
  const float l = lse[(long long)b * N + i];
  const float dl = delta[(long long)b * N + i];
  const float* kb = keep + (long long)b * P;
  for (int q = threadIdx.x; 4 * q < Pp; q += blockDim.x) {
    const float4 sx = reinterpret_cast<const float4*>(s + row)[q];
    const float4 dx = reinterpret_cast<const float4*>(dp + row)[q];
    float h[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      float d = 0.f;
      if (j < P) {
        const float g = kb[j] * scale;
        const float p = expf(elem(sx, u) * g - l);
        d = p * (elem(dx, u) - dl) * g;
      }
      split_tf32(d, h[u], lo[u]);
    }
    reinterpret_cast<float4*>(d_hi + row)[q] =
        make_float4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<float4*>(d_lo + row)[q] =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The weights of one chunk of rc keys from r0 on, a block a 32 x 32 tile
// of (queries, keys): with g = keep * scale, P = exp(S g - lse) and dS =
// P (dP - delta) g from S and dP (B, N, ld), written transposed, keys by
// queries (B, rc, Np), as TF32 terms; 0 past N. Where r_hi is given (the
// joint backward), dS also by rows as TF32 terms into r_hi and r_lo (B, N,
// ld), 0 past rc: the A operand of dQ = dS K, from the same values.
__global__ void __launch_bounds__(256)
ca_dkdv_weights(const float* s, const float* dp, const float* keep,
                const float* lse, const float* delta, float* p_hi,
                float* p_lo, float* d_hi, float* d_lo, float* r_hi,
                float* r_lo, int N, int P, int r0, int rc, int ld,
                float scale) {
  __shared__ float tp[32][33], td[32][33];
  const int Np = round4(N);
  const int b = blockIdx.z, j0 = blockIdx.x * 32, i0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int u = ty; u < 32; u += 8) {
    const int i = i0 + u, j = j0 + tx;
    const long long o = ((long long)b * N + i) * ld + j;
    float p = 0.f, d = 0.f;
    if (i < N && j < rc) {
      const float g = keep[(long long)b * P + r0 + j] * scale;
      p = expf(s[o] * g - lse[(long long)b * N + i]);
      d = p * (dp[o] - delta[(long long)b * N + i]) * g;
    }
    if (r_hi != nullptr && i < N && j < ld) put_terms(d, r_hi, r_lo, o);
    tp[u][tx] = p;
    td[u][tx] = d;
  }
  __syncthreads();
  for (int u = ty; u < 32; u += 8) {
    const int j = j0 + u, i = i0 + tx;
    if (j < rc && i < Np) {
      const long long o = ((long long)b * rc + j) * Np + i;
      put_terms(tp[tx][u], p_hi, p_lo, o);
      put_terms(td[tx][u], d_hi, d_lo, o);
    }
  }
}

// The scratch of one call, in bytes from its start (each part 256-byte
// aligned): the TF32 terms of K (and V's where V is not K; lo parts only
// for float32 input), of Q kscale and dO (B, N, Dp), of Q and dO
// transposed (B, D, Np; Q's lo only for float32 input), then, for a chunk
// of `rows` keys, S and dP (B, N, ld), ld = rows rounded up to 4, and the
// terms of P^T and dS^T (B, rows, Np). With dq (the joint backward), also
// the terms of K transposed (B, D, Pp; lo only for float32 input) and, for
// the chunk, of dS by rows (B, N, ld); without, those offsets are 0.
struct GradLayout {
  int Dp, Np, Pp, ld;
  size_t kh, kl, vh, vl, qh, ql, oh, ol, qth, qtl, oth, otl;
  size_t s, dp, ph, pl, dh, dl, kth, ktl, rh, rl, total;
};

GradLayout grad_layout(bool f32, bool same, int B, int N, int P, int D,
                       int rows, bool dq) {
  GradLayout L;
  L.Dp = round4(D);
  L.Np = round4(N);
  L.Pp = round4(P);
  L.ld = round4(rows);
  size_t at = 0;
  const auto take = [&](size_t bytes) {
    const size_t o = at;
    at = (at + bytes + 255) / 256 * 256;
    return o;
  };
  const size_t kb = 4 * (size_t)B * P * L.Dp, qb = 4 * (size_t)B * N * L.Dp;
  const size_t tb = 4 * (size_t)B * D * L.Np;
  const size_t sb = 4 * (size_t)B * N * L.ld, wb = 4 * (size_t)B * rows * L.Np;
  L.kh = take(kb);
  L.kl = f32 ? take(kb) : L.kh;
  L.vh = same ? L.kh : take(kb);
  L.vl = same ? L.kl : (f32 ? take(kb) : L.vh);
  L.qh = take(qb);
  L.ql = take(qb);
  L.oh = take(qb);
  L.ol = take(qb);
  L.qth = take(tb);
  L.qtl = f32 ? take(tb) : L.qth;
  L.oth = take(tb);
  L.otl = take(tb);
  L.s = take(sb);
  L.dp = take(sb);
  L.ph = take(wb);
  L.pl = take(wb);
  L.dh = take(wb);
  L.dl = take(wb);
  L.kth = L.ktl = L.rh = L.rl = 0;
  if (dq) {
    const size_t ktb = 4 * (size_t)B * D * L.Pp;
    L.kth = take(ktb);
    L.ktl = f32 ? take(ktb) : L.kth;
    L.rh = take(sb);
    L.rl = take(sb);
  }
  L.total = at;
  return L;
}

// Key rows a chunk: all P where the chunked part of the scratch (S, dP and
// the weights' terms; with dq, dS's terms by rows too) fits in `cap` bytes,
// else the most multiples of 128 (dV's and dK's row block in float32) that
// fit, at least 128.
int grad_chunk_rows(int B, int N, int P, long long cap, bool dq) {
  const long long per_row =
      4ll * B * ((dq ? 4ll : 2ll) * N + 4ll * round4(N));
  if ((long long)P * per_row <= cap) return P;
  const long long rows = cap / per_row / 128 * 128;
  return (int)(rows < 128 ? (P < 128 ? P : 128) : (rows > P ? P : rows));
}

// dQ's scratch, in bytes from its start (each part 256-byte aligned): the
// TF32 terms of K by rows (B, P, Dp; V's apart where V is not K; lo parts
// only for float32 input) and of K transposed (B, D, Pp), of Q kscale and
// dO by rows (B, N, Dp), then, for a chunk of `rows` query rows, S and dP
// (B, rows, Pp) and the terms of dS (B, rows, Pp).
struct DqLayout {
  int Dp, Pp;
  size_t kh, kl, vh, vl, kth, ktl, qh, ql, oh, ol, s, dp, dh, dl, total;
};

DqLayout dq_layout(bool f32, bool same, int B, int N, int P, int D,
                   int rows) {
  DqLayout L;
  L.Dp = round4(D);
  L.Pp = round4(P);
  size_t at = 0;
  const auto take = [&](size_t bytes) {
    const size_t o = at;
    at = (at + bytes + 255) / 256 * 256;
    return o;
  };
  const size_t kb = 4 * (size_t)B * P * L.Dp, qb = 4 * (size_t)B * N * L.Dp;
  const size_t tb = 4 * (size_t)B * D * L.Pp;
  const size_t sb = 4 * (size_t)B * rows * L.Pp;
  L.kh = take(kb);
  L.kl = f32 ? take(kb) : L.kh;
  L.vh = same ? L.kh : take(kb);
  L.vl = same ? L.kl : (f32 ? take(kb) : L.vh);
  L.kth = take(tb);
  L.ktl = f32 ? take(tb) : L.kth;
  L.qh = take(qb);
  L.ql = take(qb);
  L.oh = take(qb);
  L.ol = take(qb);
  L.s = take(sb);
  L.dp = take(sb);
  L.dh = take(sb);
  L.dl = take(sb);
  L.total = at;
  return L;
}

// Query rows a chunk of dQ: all N where the chunked part of the scratch
// (S, dP and dS's terms) fits in `cap` bytes, else the most multiples of
// 128 (the dQ product's row block in float32) that fit, at least 128.
int dq_chunk_rows(int B, int N, int P, long long cap) {
  const long long per_row = 16ll * B * round4(P);
  if ((long long)N * per_row <= cap) return N;
  const long long rows = cap / per_row / 128 * 128;
  return (int)(rows < 128 ? (N < 128 ? N : 128) : (rows > N ? N : rows));
}

// The products' block shapes, the forward's: S and dP as its logits (64
// queries x 128 keys), dQ, dV and dK as its P V (128 rows x 96 columns,
// two warpgroups over the rows sharing each B box, where B is split; 64 x
// 192 for dQ and dK in bfloat16, whose K^T and Q^T terms are one, half the
// bytes). Each gives 128 blocks at 256^2, B = 1.
template <bool kF32>
using ScoreGemm =
    Gemm<kKeyCols, 1, kF32, kScoreKahan ? kCompBytes<kKeyCols> : 0>;
template <bool kSplitB>
using GradGemm = Gemm<kGradCols, kSplitB ? 2 : 1, kSplitB>;

struct Args {
  const void *q, *k, *v;
  const float *keep, *kscale, *dO, *lse, *delta;
  float *out, *out2;
  int B, N, P, D;
  float scale;
  cudaStream_t stream;
  int* plan = nullptr;  // fill the launch plan, do not launch
  void* scratch = nullptr;  // dQ's or the fused dK/dV's scratch
  int rows = 0;             // and its query or key rows a chunk
  float* dq = nullptr;      // the fused dK/dV's optional dQ (the joint)
};

// The product kernel of dQ (kDq) or of the fused dK/dV.
template <bool kDq, int kWN, int kMW, bool kSplitB, int kStages, int kGroup,
          bool kCompensate>
auto grad_kernel() {
  if constexpr (kDq)
    return ca_dq_wgmma_kernel<kWN, kMW, kSplitB, kStages, kGroup,
                              kCompensate>;
  else
    return ca_dkdv_wgmma_kernel<kWN, kMW, kSplitB, kStages, kGroup,
                                kCompensate>;
}

// One product of dQ (kDq) or the fused dK/dV: a grid of Gemm<kWN, kMW,
// kSplitB> blocks over rows x cols of each image (with room for the
// compensations where kCompensate); with per_sm, the resident blocks per
// SM instead of a launch.
template <int kWN, int kMW, bool kSplitB, int kGroup, bool kCompensate,
          bool kDq = false>
int launch_grad_gemm(int rows, int cols, int B, const CUtensorMap (&m)[4],
                     int K, const GradEpi& e, cudaStream_t stream,
                     int* per_sm = nullptr) {
  using G = Gemm<kWN, kMW, kSplitB, kCompensate ? kCompBytes<kWN> : 0>;
  const auto kernel = grad_kernel<kDq, kWN, kMW, kSplitB, G::kStages, kGroup,
                                  kCompensate>();
  static std::atomic<unsigned long long> opted{0};
  if (int err = opt_in_once(kernel, G::kSmem, opted)) return err;
  if (per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kWgThreads, G::kSmem);
  kernel<<<G::grid(rows, cols, B), kWgThreads, G::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], K, e);
  return (int)cudaGetLastError();
}

// The fused dK/dV on a.scratch, laid out by grad_layout() for chunks of
// a.rows key rows: the prep launches, then S, dP, the weights, dV and dK
// per chunk. a.out is dK_eff, a.out2 dV. With a.dq, the joint backward:
// the prep adds K transposed, the weights write dS by rows too, and each
// chunk ends with dQ (+)= dS[:, chunk] K_eff[chunk], the first chunk
// storing and later ones adding.
template <typename T>
int launch_dkdv(const Args& a) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  const int B = a.B, N = a.N, P = a.P, D = a.D, rows = a.rows;
  if (rows <= 0 || rows > P || B > 65535 || (long long)B * P > 0x7fffffff ||
      (long long)B * N > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const bool same = a.k == a.v, with_dq = a.dq != nullptr;
  const GradLayout L = grad_layout(kF32, same, B, N, P, D, rows, with_dq);
  char* base = static_cast<char*>(a.scratch);
  const auto at = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  float *kh = at(L.kh), *kl = kF32 ? at(L.kl) : nullptr;
  float *vh = at(L.vh), *vl = kF32 ? at(L.vl) : nullptr;
  float *qh = at(L.qh), *ql = at(L.ql), *oh = at(L.oh), *ol = at(L.ol);
  float *qth = at(L.qth), *qtl = kF32 ? at(L.qtl) : nullptr;
  float *oth = at(L.oth), *otl = at(L.otl);
  float *s = at(L.s), *dp = at(L.dp), *ph = at(L.ph), *pl = at(L.pl);
  float *dh = at(L.dh), *dl = at(L.dl);
  float *kth = with_dq ? at(L.kth) : nullptr;
  float *ktl = with_dq && kF32 ? at(L.ktl) : nullptr;
  float *rh = with_dq ? at(L.rh) : nullptr, *rl = with_dq ? at(L.rl) : nullptr;
  cudaStream_t st = a.stream;

  ca_dkdv_split_rows<T><<<B * P, 256, 0, st>>>(k, nullptr, kh, kl, P, 0, P,
                                               D);
  if (int err = (int)cudaGetLastError()) return err;
  if (!same) {
    ca_dkdv_split_rows<T><<<B * P, 256, 0, st>>>(v, nullptr, vh, vl, P, 0,
                                                 P, D);
    if (int err = (int)cudaGetLastError()) return err;
  }
  ca_dkdv_split_rows<T><<<B * N, 256, 0, st>>>(q, a.kscale, qh, ql, N, 0, N,
                                               D);
  if (int err = (int)cudaGetLastError()) return err;
  ca_dkdv_split_rows<float><<<B * N, 256, 0, st>>>(a.dO, nullptr, oh, ol, N,
                                                   0, N, D);
  if (int err = (int)cudaGetLastError()) return err;
  const dim3 tgrid((L.Np + 31) / 32, (D + 31) / 32, B);
  ca_dkdv_split_t<T><<<tgrid, 256, 0, st>>>(q, qth, qtl, N, D);
  if (int err = (int)cudaGetLastError()) return err;
  ca_dkdv_split_t<float><<<tgrid, 256, 0, st>>>(a.dO, oth, otl, N, D);
  if (int err = (int)cudaGetLastError()) return err;
  if (with_dq) {  // K transposed, dQ's B operand, as dQ's own prep forms it
    ca_dkdv_split_t<T><<<dim3((L.Pp + 31) / 32, (D + 31) / 32, B), 256, 0,
                         st>>>(k, kth, ktl, P, D);
    if (int err = (int)cudaGetLastError()) return err;
  }

  using GS = ScoreGemm<kF32>;
  using GV = GradGemm<true>;           // dO^T is split in both dtypes
  using GK = GradGemm<kF32>;           // and dQ's: K^T is split as Q^T is
  // ms: S = (Q kscale) K^T, mp: dP = dO V^T over D; mv: dV = P^T dO, mk:
  // dK_eff = dS^T Q over the queries, whose extent N ends every map's
  // contraction there (TMA reads zeros past it); mq: dQ = dS (K^T)^T over
  // the chunk's keys, whose extent rc ends its contraction
  CUtensorMap ms[4], mp[4], mv[4], mk[4], mq[4];
  const long long qstride = (long long)N * L.Dp, tstride = (long long)D * L.Np;
  if (int err = make_map(&ms[0], qh, D, N, B, L.Dp, qstride, GS::kBM))
    return err;
  if (int err = make_map(&ms[1], ql, D, N, B, L.Dp, qstride, GS::kBM))
    return err;
  if (int err = make_map(&mp[0], oh, D, N, B, L.Dp, qstride, GS::kBM))
    return err;
  if (int err = make_map(&mp[1], ol, D, N, B, L.Dp, qstride, GS::kBM))
    return err;
  if (int err = make_map(&mv[2], oth, N, D, B, L.Np, tstride, GV::kBN))
    return err;
  if (int err = make_map(&mv[3], otl, N, D, B, L.Np, tstride, GV::kBN))
    return err;
  if (int err = make_map(&mk[2], qth, N, D, B, L.Np, tstride, GK::kBN))
    return err;
  if (int err = make_map(&mk[3], kF32 ? qtl : qth, N, D, B, L.Np, tstride,
                         GK::kBN))
    return err;
  const long long kstride = (long long)P * L.Dp;
  for (int r0 = 0; r0 < P; r0 += rows) {
    const int rc = rows < P - r0 ? rows : P - r0;
    const long long ko = (long long)r0 * L.Dp;
    if (int err = make_map(&ms[2], kh + ko, D, rc, B, L.Dp, kstride, GS::kBN))
      return err;
    if (int err = make_map(&ms[3], (kF32 ? kl : kh) + ko, D, rc, B, L.Dp,
                           kstride, GS::kBN))
      return err;
    if (int err = make_map(&mp[2], vh + ko, D, rc, B, L.Dp, kstride, GS::kBN))
      return err;
    if (int err = make_map(&mp[3], (kF32 ? vl : vh) + ko, D, rc, B, L.Dp,
                           kstride, GS::kBN))
      return err;
    const long long sstride = (long long)N * L.ld;
    constexpr auto score = launch_grad_gemm<kKeyCols, 1, kF32, kScoreGroup,
                                            kScoreKahan>;
    if (int err = score(N, rc, B, ms, D, GradEpi{s, sstride, N, rc, L.ld}, st,
                        nullptr))
      return err;
    if (int err = score(N, rc, B, mp, D, GradEpi{dp, sstride, N, rc, L.ld},
                        st, nullptr))
      return err;
    ca_dkdv_weights<<<dim3((rc + 31) / 32, (L.Np + 31) / 32, B), 256, 0,
                      st>>>(s, dp, a.keep, a.lse, a.delta, ph, pl, dh, dl, rh,
                            rl, N, P, r0, rc, L.ld, a.scale);
    if (int err = (int)cudaGetLastError()) return err;
    const long long wstride = (long long)rc * L.Np;
    if (int err = make_map(&mv[0], ph, N, rc, B, L.Np, wstride, GV::kBM))
      return err;
    if (int err = make_map(&mv[1], pl, N, rc, B, L.Np, wstride, GV::kBM))
      return err;
    if (int err = make_map(&mk[0], dh, N, rc, B, L.Np, wstride, GK::kBM))
      return err;
    if (int err = make_map(&mk[1], dl, N, rc, B, L.Np, wstride, GK::kBM))
      return err;
    const long long ostride = (long long)P * D, oo = (long long)r0 * D;
    constexpr auto grad_v =
        launch_grad_gemm<kGradCols, GV::kMW, true, kGradGroup, false>;
    constexpr auto grad_k =
        launch_grad_gemm<kGradCols, GK::kMW, kF32, kGradGroup, false>;
    if (int err = grad_v(rc, D, B, mv, N,
                         GradEpi{a.out2 + oo, ostride, rc, D, D}, st, nullptr))
      return err;
    if (int err = grad_k(rc, D, B, mk, N,
                         GradEpi{a.out + oo, ostride, rc, D, D}, st, nullptr))
      return err;
    if (!with_dq) continue;
    // dQ's block as launch_dq launches it: A dS by rows (N x rc, rows ld
    // apart), B K^T's columns r0 .. r0 + rc (r0 a multiple of 128, so the
    // base keeps TMA's 16-byte alignment), kscale on the columns
    const long long rstride = (long long)N * L.ld;
    const long long ktstride = (long long)D * L.Pp;
    if (int err = make_map(&mq[0], rh, rc, N, B, L.ld, rstride, GK::kBM))
      return err;
    if (int err = make_map(&mq[1], rl, rc, N, B, L.ld, rstride, GK::kBM))
      return err;
    if (int err = make_map(&mq[2], kth + r0, rc, D, B, L.Pp, ktstride,
                           GK::kBN))
      return err;
    if (int err = make_map(&mq[3], (kF32 ? ktl : kth) + r0, rc, D, B, L.Pp,
                           ktstride, GK::kBN))
      return err;
    constexpr auto grad_q =
        launch_grad_gemm<kGradCols, GK::kMW, kF32, kGradGroup, false, true>;
    if (int err = grad_q(N, D, B, mq, rc,
                         GradEpi{a.dq, (long long)N * D, N, D, D, a.kscale,
                                 r0 > 0},
                         st, nullptr))
      return err;
  }
  return 0;
}

// The plan of launch_dkdv for these shapes and chunk rows (V taken to be
// K, as on the main path), without a launch: plan[0] chunk rows, [1]
// chunks, [2] S blocks (dP's are the same; a full chunk's grid), [3]
// weights blocks, [4] dV blocks, [5] dK blocks, [6] - [8] the S, dV and dK
// products' dynamic shared memory per block, [9] - [11] their stages, [12]
// - [14] their resident blocks per SM, [15] threads a product block, [16]
// launches per call, [17] and [18] the S block's rows and columns, [19]
// and [20] dV's, [21] and [22] dK's.
template <typename T>
int plan_dkdv(int B, int N, int P, int D, int rows, int* plan) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  using GS = ScoreGemm<kF32>;
  using GV = GradGemm<true>;
  using GK = GradGemm<kF32>;
  if (rows <= 0 || rows > P) return (int)cudaErrorInvalidValue;
  const CUtensorMap none[4] = {};
  const GradEpi e{};
  const auto blocks = [](dim3 g) { return (int)(g.x * g.y * g.z); };
  const int chunks = (P + rows - 1) / rows;
  plan[0] = rows;
  plan[1] = chunks;
  plan[2] = blocks(GS::grid(N, rows, B));
  plan[3] = ((rows + 31) / 32) * ((round4(N) + 31) / 32) * B;
  plan[4] = blocks(GV::grid(rows, D, B));
  plan[5] = blocks(GK::grid(rows, D, B));
  plan[6] = (int)GS::kSmem;
  plan[7] = (int)GV::kSmem;
  plan[8] = (int)GK::kSmem;
  plan[9] = GS::kStages;
  plan[10] = GV::kStages;
  plan[11] = GK::kStages;
  if (int err = launch_grad_gemm<kKeyCols, 1, kF32, kScoreGroup,
                                 kScoreKahan>(1, 1, 1, none, 0, e, nullptr,
                                              &plan[12]))
    return err;
  if (int err = launch_grad_gemm<kGradCols, GV::kMW, true, kGradGroup,
                                 false>(1, 1, 1, none, 0, e, nullptr,
                                        &plan[13]))
    return err;
  if (int err = launch_grad_gemm<kGradCols, GK::kMW, kF32, kGradGroup,
                                 false>(1, 1, 1, none, 0, e, nullptr,
                                        &plan[14]))
    return err;
  plan[15] = kWgThreads;
  plan[16] = 5 + 5 * chunks;
  plan[17] = GS::kBM;
  plan[18] = GS::kBN;
  plan[19] = GV::kBM;
  plan[20] = GV::kBN;
  plan[21] = GK::kBM;
  plan[22] = GK::kBN;
  return 0;
}

// The plan of the joint backward (launch_dkdv with dQ; V taken to be K):
// plan_dkdv's 23 ints for these chunk rows, [16] its launches per call,
// then [23] dQ product blocks, [24] its dynamic shared memory per block,
// [25] its stages, [26] its resident blocks per SM, [27] and [28] its
// block's rows and columns.
template <typename T>
int plan_bwd(int B, int N, int P, int D, int rows, int* plan) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  using GQ = GradGemm<kF32>;
  if (int err = plan_dkdv<T>(B, N, P, D, rows, plan)) return err;
  const dim3 g = GQ::grid(N, D, B);
  plan[16] = 6 + 6 * plan[1];
  plan[23] = (int)(g.x * g.y * g.z);
  plan[24] = (int)GQ::kSmem;
  plan[25] = GQ::kStages;
  const CUtensorMap none[4] = {};
  if (int err = launch_grad_gemm<kGradCols, GQ::kMW, kF32, kGradGroup, false,
                                 true>(1, 1, 1, none, 0, GradEpi{}, nullptr,
                                       &plan[26]))
    return err;
  plan[27] = GQ::kBM;
  plan[28] = GQ::kBN;
  return 0;
}

// dQ on a.scratch, laid out by dq_layout() for chunks of a.rows query
// rows: the prep launches, then S, dP, the weights and the dQ product per
// chunk. a.out is dQ.
template <typename T>
int launch_dq(const Args& a) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  const int B = a.B, N = a.N, P = a.P, D = a.D, rows = a.rows;
  if (rows <= 0 || rows > N || B > 65535 || (long long)B * P > 0x7fffffff ||
      (long long)B * N > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const bool same = a.k == a.v;
  const DqLayout L = dq_layout(kF32, same, B, N, P, D, rows);
  char* base = static_cast<char*>(a.scratch);
  const auto at = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  float *kh = at(L.kh), *kl = kF32 ? at(L.kl) : nullptr;
  float *vh = at(L.vh), *vl = kF32 ? at(L.vl) : nullptr;
  float *kth = at(L.kth), *ktl = kF32 ? at(L.ktl) : nullptr;
  float *qh = at(L.qh), *ql = at(L.ql), *oh = at(L.oh), *ol = at(L.ol);
  float *s = at(L.s), *dp = at(L.dp), *dh = at(L.dh), *dl = at(L.dl);
  cudaStream_t st = a.stream;

  ca_dq_split_rows<T><<<B * P, 256, 0, st>>>(k, nullptr, kh, kl, P, 0, P, D);
  if (int err = (int)cudaGetLastError()) return err;
  if (!same) {
    ca_dq_split_rows<T><<<B * P, 256, 0, st>>>(v, nullptr, vh, vl, P, 0, P,
                                               D);
    if (int err = (int)cudaGetLastError()) return err;
  }
  ca_dq_split_t<T><<<dim3((L.Pp + 31) / 32, (D + 31) / 32, B), 256, 0, st>>>(
      k, kth, ktl, P, D);
  if (int err = (int)cudaGetLastError()) return err;
  ca_dq_split_rows<T><<<B * N, 256, 0, st>>>(q, a.kscale, qh, ql, N, 0, N, D);
  if (int err = (int)cudaGetLastError()) return err;
  ca_dq_split_rows<float><<<B * N, 256, 0, st>>>(a.dO, nullptr, oh, ol, N, 0,
                                                 N, D);
  if (int err = (int)cudaGetLastError()) return err;

  using GS = ScoreGemm<kF32>;
  using GQ = GradGemm<kF32>;
  // ms: S = (Q kscale) K^T, mp: dP = dO V^T over D; mq: dQ = dS (K^T)^T
  // over the keys, whose extent P ends the maps' contraction there (TMA
  // reads zeros past it)
  CUtensorMap ms[4], mp[4], mq[4];
  const long long kstride = (long long)P * L.Dp, tstride = (long long)D * L.Pp;
  if (int err = make_map(&ms[2], kh, D, P, B, L.Dp, kstride, GS::kBN))
    return err;
  if (int err = make_map(&ms[3], kF32 ? kl : kh, D, P, B, L.Dp, kstride,
                         GS::kBN))
    return err;
  if (int err = make_map(&mp[2], vh, D, P, B, L.Dp, kstride, GS::kBN))
    return err;
  if (int err = make_map(&mp[3], kF32 ? vl : vh, D, P, B, L.Dp, kstride,
                         GS::kBN))
    return err;
  if (int err = make_map(&mq[2], kth, P, D, B, L.Pp, tstride, GQ::kBN))
    return err;
  if (int err = make_map(&mq[3], kF32 ? ktl : kth, P, D, B, L.Pp, tstride,
                         GQ::kBN))
    return err;
  const long long qstride = (long long)N * L.Dp;
  for (int r0 = 0; r0 < N; r0 += rows) {
    const int rc = rows < N - r0 ? rows : N - r0;
    const long long qo = (long long)r0 * L.Dp;
    if (int err = make_map(&ms[0], qh + qo, D, rc, B, L.Dp, qstride, GS::kBM))
      return err;
    if (int err = make_map(&ms[1], ql + qo, D, rc, B, L.Dp, qstride, GS::kBM))
      return err;
    if (int err = make_map(&mp[0], oh + qo, D, rc, B, L.Dp, qstride, GS::kBM))
      return err;
    if (int err = make_map(&mp[1], ol + qo, D, rc, B, L.Dp, qstride, GS::kBM))
      return err;
    const long long sstride = (long long)rc * L.Pp;
    constexpr auto score = launch_grad_gemm<kKeyCols, 1, kF32, kScoreGroup,
                                            kScoreKahan, true>;
    if (int err = score(rc, P, B, ms, D, GradEpi{s, sstride, rc, P, L.Pp},
                        st, nullptr))
      return err;
    if (int err = score(rc, P, B, mp, D, GradEpi{dp, sstride, rc, P, L.Pp},
                        st, nullptr))
      return err;
    ca_dq_weights<<<B * rc, 256, 0, st>>>(s, dp, a.keep, a.lse, a.delta, dh,
                                          dl, N, P, r0, rc, a.scale);
    if (int err = (int)cudaGetLastError()) return err;
    if (int err = make_map(&mq[0], dh, P, rc, B, L.Pp, sstride, GQ::kBM))
      return err;
    if (int err = make_map(&mq[1], dl, P, rc, B, L.Pp, sstride, GQ::kBM))
      return err;
    constexpr auto grad_q =
        launch_grad_gemm<kGradCols, GQ::kMW, kF32, kGradGroup, false, true>;
    if (int err = grad_q(rc, D, B, mq, P,
                         GradEpi{a.out + (long long)r0 * D, (long long)N * D,
                                 rc, D, D, a.kscale},
                         st, nullptr))
      return err;
  }
  return 0;
}

// The plan of launch_dq for these shapes and chunk rows (V taken to be K,
// as on the main path), without a launch: plan[0] chunk rows, [1] chunks,
// [2] S blocks (dP's are the same; a full chunk's grid), [3] weights
// blocks, [4] dQ product blocks, [5] and [6] the S and dQ products'
// dynamic shared memory per block, [7] and [8] their stages, [9] and [10]
// their resident blocks per SM, [11] threads a product block, [12]
// launches per call, [13] and [14] the S block's rows and columns, [15]
// and [16] the dQ block's.
template <typename T>
int plan_dq(int B, int N, int P, int D, int rows, int* plan) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  using GS = ScoreGemm<kF32>;
  using GQ = GradGemm<kF32>;
  if (rows <= 0 || rows > N) return (int)cudaErrorInvalidValue;
  const CUtensorMap none[4] = {};
  const GradEpi e{};
  const auto blocks = [](dim3 g) { return (int)(g.x * g.y * g.z); };
  const int chunks = (N + rows - 1) / rows;
  plan[0] = rows;
  plan[1] = chunks;
  plan[2] = blocks(GS::grid(rows, P, B));
  plan[3] = rows * B;
  plan[4] = blocks(GQ::grid(rows, D, B));
  plan[5] = (int)GS::kSmem;
  plan[6] = (int)GQ::kSmem;
  plan[7] = GS::kStages;
  plan[8] = GQ::kStages;
  if (int err = launch_grad_gemm<kKeyCols, 1, kF32, kScoreGroup, kScoreKahan,
                                 true>(1, 1, 1, none, 0, e, nullptr,
                                       &plan[9]))
    return err;
  if (int err = launch_grad_gemm<kGradCols, GQ::kMW, kF32, kGradGroup, false,
                                 true>(1, 1, 1, none, 0, e, nullptr,
                                       &plan[10]))
    return err;
  plan[11] = kWgThreads;
  plan[12] = 4 + 4 * chunks;
  plan[13] = GS::kBM;
  plan[14] = GS::kBN;
  plan[15] = GQ::kBM;
  plan[16] = GQ::kBN;
  return 0;
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

// dK_eff or dV: 16-row blocks, or 8-row ones when 16-row blocks would
// leave SMs idle; for dK one build whose owned K rows serve S^T and dP^T
// where V is K (the main path's call), one that stages V's rows; 16-byte
// copies where D is a multiple of 4 and every pointer is aligned, else
// element by element. dV reads no V.
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

// which: 0 dq, 1 dkdv, 2 dv, 3 dk, 4 the joint backward (dkdv with a.dq).
template <typename T>
int launch(int which, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.P <= 0 || a.D <= 0)
    return (int)cudaErrorInvalidValue;
  switch (which) {
    case 4:
      if (a.plan != nullptr)
        return plan_bwd<T>(a.B, a.N, a.P, a.D, a.rows, a.plan);
      if (a.dq == nullptr) return (int)cudaErrorInvalidValue;
      return launch_dkdv<T>(a);
    case 0:
      if (a.plan != nullptr)
        return plan_dq<T>(a.B, a.N, a.P, a.D, a.rows, a.plan);
      return launch_dq<T>(a);
    case 1:
      if (a.plan != nullptr)
        return plan_dkdv<T>(a.B, a.N, a.P, a.D, a.rows, a.plan);
      return launch_dkdv<T>(a);
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

// dQ, with a scratch of sketchedit_contextual_attention_dq_scratch's bytes
// for these shapes and its `rows` query rows a chunk.
int sketchedit_contextual_attention_dq(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* keep, const void* kscale,
                                       const void* dO, const void* lse,
                                       const void* delta, void* dq,
                                       void* scratch, int B, int N, int P,
                                       int D, int rows, float scale,
                                       void* stream) {
  Args a{q, k, v, f(keep), f(kscale), f(dO), f(lse), f(delta),
         f(dq), nullptr, B, N, P, D, scale,
         static_cast<cudaStream_t>(stream)};
  a.scratch = scratch;
  a.rows = rows;
  return launch_typed(0, dtype, a);
}

// Bytes of scratch dQ needs for these shapes (same: V is K, one pointer)
// when the part that grows with the query rows (S, dP and dS's terms) may
// take `cap` bytes; *rows gets the query rows a chunk. Returns -1 for
// shapes it refuses.
long long sketchedit_contextual_attention_dq_scratch(int dtype, int same,
                                                     int B, int N, int P,
                                                     int D, long long cap,
                                                     int* rows) {
  if (B <= 0 || N <= 0 || P <= 0 || D <= 0 || cap <= 0 ||
      (dtype != 0 && dtype != 1))
    return -1;
  *rows = dq_chunk_rows(B, N, P, cap);
  return (long long)dq_layout(dtype == 0, same != 0, B, N, P, D, *rows)
      .total;
}

// dQ's launch plan for these shapes and `rows` query rows a chunk on the
// current device, without a launch: the 17 ints plan_dq fills.
int sketchedit_contextual_attention_dq_plan(int dtype, int rows, int B, int N,
                                            int P, int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  a.rows = rows;
  return launch_typed(0, dtype, a);
}

// The fused dK/dV: the same arguments as dq, the two outputs, and a scratch
// of sketchedit_contextual_attention_dkdv_scratch's bytes for these shapes
// and its `rows` key rows a chunk.
int sketchedit_contextual_attention_dkdv(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* keep, const void* kscale,
                                         const void* dO, const void* lse,
                                         const void* delta, void* dk,
                                         void* dv, void* scratch, int B,
                                         int N, int P, int D, int rows,
                                         float scale, void* stream) {
  Args a{q, k, v, f(keep), f(kscale), f(dO), f(lse), f(delta),
         f(dk), f(dv), B, N, P, D, scale,
         static_cast<cudaStream_t>(stream)};
  a.scratch = scratch;
  a.rows = rows;
  return launch_typed(1, dtype, a);
}

// Bytes of scratch the fused dK/dV needs for these shapes (same: V is K,
// one pointer) when the part that grows with the key rows (S, dP and the
// weights' terms) may take `cap` bytes; *rows gets the key rows a chunk.
// Returns -1 for shapes it refuses.
long long sketchedit_contextual_attention_dkdv_scratch(int dtype, int same,
                                                       int B, int N, int P,
                                                       int D, long long cap,
                                                       int* rows) {
  if (B <= 0 || N <= 0 || P <= 0 || D <= 0 || cap <= 0 ||
      (dtype != 0 && dtype != 1))
    return -1;
  *rows = grad_chunk_rows(B, N, P, cap, false);
  return (long long)grad_layout(dtype == 0, same != 0, B, N, P, D, *rows,
                                false)
      .total;
}

// The fused dK/dV's launch plan for these shapes and `rows` key rows a
// chunk on the current device, without a launch: the 23 ints plan_dkdv
// fills.
int sketchedit_contextual_attention_dkdv_plan(int dtype, int rows, int B,
                                              int N, int P, int D,
                                              int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  a.rows = rows;
  return launch_typed(1, dtype, a);
}

// The joint backward: dQ, dK_eff and dV from one sequence (the fused
// dK/dV's, its S, dP and dS shared by the three products), the same
// arguments as dkdv with dq before dk, and a scratch of
// sketchedit_contextual_attention_bwd_scratch's bytes for these shapes and
// its `rows` key rows a chunk.
int sketchedit_contextual_attention_bwd(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* keep, const void* kscale,
                                        const void* dO, const void* lse,
                                        const void* delta, void* dq, void* dk,
                                        void* dv, void* scratch, int B, int N,
                                        int P, int D, int rows, float scale,
                                        void* stream) {
  Args a{q, k, v, f(keep), f(kscale), f(dO), f(lse), f(delta),
         f(dk), f(dv), B, N, P, D, scale,
         static_cast<cudaStream_t>(stream)};
  a.scratch = scratch;
  a.rows = rows;
  a.dq = f(dq);
  return launch_typed(4, dtype, a);
}

// Bytes of scratch the joint backward needs (the fused dK/dV's, with K
// transposed and, per chunk, dS's terms by rows) when its key-row part may
// take `cap` bytes; *rows gets the key rows a chunk. -1 for shapes it
// refuses.
long long sketchedit_contextual_attention_bwd_scratch(int dtype, int same,
                                                      int B, int N, int P,
                                                      int D, long long cap,
                                                      int* rows) {
  if (B <= 0 || N <= 0 || P <= 0 || D <= 0 || cap <= 0 ||
      (dtype != 0 && dtype != 1))
    return -1;
  *rows = grad_chunk_rows(B, N, P, cap, true);
  return (long long)grad_layout(dtype == 0, same != 0, B, N, P, D, *rows,
                                true)
      .total;
}

// The joint backward's launch plan for these shapes and `rows` key rows a
// chunk on the current device, without a launch: the 29 ints plan_bwd
// fills.
int sketchedit_contextual_attention_bwd_plan(int dtype, int rows, int B,
                                             int N, int P, int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  a.rows = rows;
  return launch_typed(4, dtype, a);
}

// The dV (dk = 0) or dK (dk = 1) kernel's launch plan for these shapes on
// the current device, without a launch (V taken to be K, as on the main
// path): plan[0] key rows per block, [1] column slabs,
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
