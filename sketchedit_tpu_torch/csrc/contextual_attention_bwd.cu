// Contextual-attention backward for Hopper (sm_90a), CUDA C++: dQ's
// sequence, and one sequence for dQ, dK and dV run with a mask of its
// products (the joint backward, the fused dK/dV, dV alone, dK alone).
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
//   dv, dk:      dV alone (reads neither V nor delta), dK_eff alone: the
//                joint sequence with a mask of its products
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
// (~0.009 ms): both are bound by operations. dv runs two products and dk
// three, five together where the fused dK/dV runs four, since both form S.
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
//     dQ       dS (K^T)^T in blocks of 128 queries x 128 columns (two
//              warpgroups over the rows sharing each B box; 64 x 256 in
//              bfloat16, whose K^T terms are one), every step
//              added to the total (a chain of 121 at P = 961), and kscale
//              on each column in the epilogue, so K enters raw and stays
//              one term in bfloat16.
//   At 256^2, B = 1 S and dP are 128 blocks on 132 SMs and dQ 96; 8
//   launches a call.
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
//              the total with Kahan's compensation (in registers), which puts
//              dK and dV 0.72-0.87x the dK and dV kernels' distance from
//              float64 (relative L2) where plain run sums gave 0.91-1.13x;
//     dP       dO V^T, the same block and sum (dS carries dP's error times
//              P g, as S's through the softmax scale);
//     weights  P = exp(S g - lse) and dS = P (dP - delta) g, written
//              transposed (B, keys, Np) as TF32 terms through 32 x 32
//              shared-memory tiles;
//     dV, dK   P^T dO and dS^T Q, dQ's block (128 keys x 128 columns,
//              two warpgroups over the rows sharing each B box; dK in
//              bfloat16 64 x 256, its Q^T one term), every step
//              added to the total (a chain of 121 at N = 961, as the dV
//              and dK kernels' accumulation).
//   Every product takes its A operand split (Q kscale, dO, P^T and dS^T
//   hold float32 values); the tensor maps' extents end the contraction at
//   D or N, so TMA reads zeros past them. Shared memory sets no widest D.
//   At 256^2, B = 1 S and dP are 128 blocks on 132 SMs, dV and dK 96.
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
// - dv, dk and the mask: launch_grad runs bwd's sequence for any mask of
//   its three products (dV, dK_eff, dQ): the joint takes all three, dkdv
//   {dV, dK}, dv {dV} and dk {dK}. A masked sequence does only the work its
//   products read:
//     prep     K and Q kscale by rows (S) always; dO by rows, and V's terms
//              where V is not K, for dP (dK or dQ); dO transposed for dV, Q
//              transposed for dK, K transposed for dQ;
//   then per chunk of key rows S; dP for dK or dQ; the weights pass writing
//   only the terms read (P^T for dV, dS^T for dK, dS by rows for dQ); then
//   the mask's products in bwd's order. The scratch and the chunk rows
//   count only the parts the mask reads, so a masked call takes fewer bytes
//   a key row and larger chunks. The products, their blocks, sums and
//   epilogues are bwd's, and dV and dK keep one chunk's bits however the
//   key rows are chunked, so dv's dV and dk's dK_eff equal bwd's bit for
//   bit. dv reads neither V nor delta. What bounds them: dv is two of the
//   joint's five products (S, then P^T dO: 5.7 GFLOP an image at 256^2,
//   0.034 ms as split TF32), dk three (S, dP, then dS^T Q: 8.5 GFLOP,
//   0.052 ms), each with the copies and the weights pass that feed them:
//   3 + 3 launches a call for dv and 4 + 4 for dk at one chunk. They
//   replace dv and dk kernels on mma.sync, which held the keys' rows in
//   shared memory (206 KB a block, D up to 1920) and recomputed S and dP
//   for every further column slab; the masked sequence takes any D.
//
// Blocks. Every product block is warp-specialised (WarpSpec in
// contextual_attention_wgmma.cuh): 384 threads, two consumer warpgroups
// raised to 232 registers a thread by setmaxnreg and a producer warpgroup
// lowered to 40, one lane of which issues the TMA loads; the forwards keep
// the nine-warp block of 168. The registers hold the wider dQ, dV and dK
// tiles (64 x 128 a warpgroup) and S and dP's compensations and a third
// fresh accumulator (two k8 steps in flight), none of which changes an
// output element's order of summation.

#include "contextual_attention_common.cuh"
#include "contextual_attention_wgmma.cuh"

namespace {

// --- dQ and the fused dK/dV: TMA-fed wgmma ----------------------------------
// (the prep bodies and the product's body: contextual_attention_wgmma.cuh)

constexpr int kKeyCols = 64;     // keys a warpgroup in S and dP
constexpr int kGradCols = 128;   // output columns a warpgroup in dQ, dV, dK
constexpr int kScoreGroup = kSumStages;  // stages S and dP sum apart
constexpr bool kScoreKahan = true;       // and add to their totals
constexpr int kGradGroup = 0;            // and dQ, dV and dK (every step)
// Every product runs the warp-specialised block (WarpSpec: a producer
// warpgroup that gives its registers to the two consumer warpgroups), S
// and dP with kScoreFresh fresh accumulators (acc, the run sum, its
// compensation and three fresh ones, 32 floats each: 192 a thread), dQ, dV
// and dK with kGradFresh (acc and two fresh ones of 64 floats: 192).
constexpr int kScoreFresh = 3;
constexpr int kGradFresh = 2;
using ScoreBlock = WarpSpec<kScoreFresh>;
using GradBlock = WarpSpec<kGradFresh>;

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
          bool kCompensate, class Block>
__device__ __forceinline__ void grad_product(const CUtensorMap& a_hi,
                                             const CUtensorMap& a_lo,
                                             const CUtensorMap& b_hi,
                                             const CUtensorMap& b_lo, int K,
                                             const GradEpi& e) {
  constexpr int kBM = kTileM * kMW, kBN = kWN * 2 / kMW;  // the block's tile
  float acc[kWN / 2];
  if (!wgmma_product<kWN, kMW, kSplitB, kStages, kGroup, kCompensate, Block>(
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

// The product kernels, on WarpSpec<kFresh>'s block of 384 threads: one
// block an SM, whose 168 registers a thread at launch the producer
// warpgroup gives to the consumers.
template <int kWN, int kMW, bool kSplitB, int kStages, int kGroup,
          bool kCompensate, int kFresh>
__global__ void __launch_bounds__(WarpSpec<kFresh>::kThreads, 1)
ca_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap a_hi,
                     const __grid_constant__ CUtensorMap a_lo,
                     const __grid_constant__ CUtensorMap b_hi,
                     const __grid_constant__ CUtensorMap b_lo, int K,
                     GradEpi e) {
  grad_product<kWN, kMW, kSplitB, kStages, kGroup, kCompensate,
               WarpSpec<kFresh>>(a_hi, a_lo, b_hi, b_lo, K, e);
}
template <int kWN, int kMW, bool kSplitB, int kStages, int kGroup,
          bool kCompensate, int kFresh>
__global__ void __launch_bounds__(WarpSpec<kFresh>::kThreads, 1)
ca_dq_wgmma_kernel(const __grid_constant__ CUtensorMap a_hi,
                   const __grid_constant__ CUtensorMap a_lo,
                   const __grid_constant__ CUtensorMap b_hi,
                   const __grid_constant__ CUtensorMap b_lo, int K,
                   GradEpi e) {
  grad_product<kWN, kMW, kSplitB, kStages, kGroup, kCompensate,
               WarpSpec<kFresh>>(a_hi, a_lo, b_hi, b_lo, K, e);
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
// of (queries, keys): with g = keep * scale, P = exp(S g - lse) and, where
// dp is given, dS = P (dP - delta) g from S and dP (B, N, ld), written
// transposed, keys by queries (B, rc, Np), as TF32 terms: P into p_hi and
// p_lo where given, dS into d_hi and d_lo where given, 0 past N. Where r_hi
// is given (dQ), dS also by rows as TF32 terms into r_hi and r_lo (B, N,
// ld), 0 past rc: the A operand of dQ = dS K, from the same values. delta
// is read only with dp.
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
      if (dp != nullptr) d = p * (dp[o] - delta[(long long)b * N + i]) * g;
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
      if (p_hi != nullptr) put_terms(tp[tx][u], p_hi, p_lo, o);
      if (d_hi != nullptr) put_terms(td[tx][u], d_hi, d_lo, o);
    }
  }
}

// The products a sequence of launch_grad runs (Args::mask): the joint
// backward is all three, the fused dK/dV kDV | kDK.
constexpr int kDV = 1, kDK = 2, kDQ = 4;

// What a mask reads: dP where dK or dQ is among its products.
struct Mask {
  bool dv, dk, dq, dp;
  explicit Mask(int m)
      : dv(m & kDV), dk(m & kDK), dq(m & kDQ), dp(m & (kDK | kDQ)) {}
  // launches of the prep, and of each chunk of key rows, where V is K
  int launches() const { return 2 + dp + dv + dk + dq; }
};

// The scratch of one call of launch_grad, in bytes from its start (each
// part 256-byte aligned), only the parts its mask reads: the TF32 terms of
// K (lo parts only for float32 input) and of Q kscale (B, N, Dp); for dP,
// V's where V is not K and dO's by rows (B, N, Dp); dO transposed for dV,
// Q transposed for dK (B, D, Np; Q's lo only for float32 input); then, for
// a chunk of `rows` keys, S (and dP) (B, N, ld), ld = rows rounded up to
// 4, the terms of P^T for dV and of dS^T for dK (B, rows, Np); for dQ the
// terms of K transposed (B, D, Pp; lo only for float32 input) and, for the
// chunk, of dS by rows (B, N, ld). A part the mask does not read keeps
// offset 0 and is never used.
struct GradLayout {
  int Dp, Np, Pp, ld;
  size_t kh, kl, vh, vl, qh, ql, oh, ol, qth, qtl, oth, otl;
  size_t s, dp, ph, pl, dh, dl, kth, ktl, rh, rl, total;
};

GradLayout grad_layout(bool f32, bool same, int B, int N, int P, int D,
                       int rows, Mask m) {
  GradLayout L{};
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
  if (m.dp) {
    L.vh = same ? L.kh : take(kb);
    L.vl = same ? L.kl : (f32 ? take(kb) : L.vh);
  }
  L.qh = take(qb);
  L.ql = take(qb);
  if (m.dp) {
    L.oh = take(qb);
    L.ol = take(qb);
  }
  if (m.dk) {
    L.qth = take(tb);
    L.qtl = f32 ? take(tb) : L.qth;
  }
  if (m.dv) {
    L.oth = take(tb);
    L.otl = take(tb);
  }
  L.s = take(sb);
  if (m.dp) L.dp = take(sb);
  if (m.dv) {
    L.ph = take(wb);
    L.pl = take(wb);
  }
  if (m.dk) {
    L.dh = take(wb);
    L.dl = take(wb);
  }
  if (m.dq) {
    const size_t ktb = 4 * (size_t)B * D * L.Pp;
    L.kth = take(ktb);
    L.ktl = f32 ? take(ktb) : L.kth;
    L.rh = take(sb);
    L.rl = take(sb);
  }
  L.total = at;
  return L;
}

// Key rows a chunk: all P where the chunked part of the scratch (S, and
// what the mask reads of dP, the weights' transposed terms and dS's terms
// by rows) fits in `cap` bytes, else the most multiples of 128 (dV's and
// dK's row block in float32) that fit, at least 128.
int grad_chunk_rows(int B, int N, int P, long long cap, Mask m) {
  const long long per_row =
      4ll * B * ((1 + m.dp + 2 * m.dq) * (long long)N +
                 2ll * (m.dv + m.dk) * round4(N));
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

// The products' block shapes: S and dP as the forward's logits (64 queries
// x 128 keys, 128 blocks at 256^2, B = 1), dQ, dV and dK wider than its P
// V (128 rows x 128 columns, two warpgroups over the rows sharing each B
// box, where B is split; 64 x 256 for dQ and dK in bfloat16, whose K^T and
// Q^T terms are one, half the bytes: 96 blocks at 256^2, B = 1, 768 at B =
// 8). Each consumer thread of dQ, dV and dK holds 192 accumulator floats,
// more than a nine-warp block's 168 registers a thread.
template <bool kF32> using ScoreGemm = Gemm<kKeyCols, 1, kF32>;
template <bool kSplitB>
using GradGemm = Gemm<kGradCols, kSplitB ? 2 : 1, kSplitB>;

struct Args {
  const void *q, *k, *v;
  const float *keep, *kscale, *dO, *lse, *delta;
  float *out, *out2;         // dQ's dQ; launch_grad's dK_eff and dV
  int B, N, P, D;
  float scale;
  cudaStream_t stream;
  int* plan = nullptr;       // fill the launch plan, do not launch
  void* scratch = nullptr;   // dQ's or launch_grad's scratch
  int rows = 0;              // and its query or key rows a chunk
  float* dq = nullptr;       // launch_grad's dQ
  int mask = 0;              // launch_grad's products (kDV, kDK, kDQ)
};

// The product kernel of dQ (kDq) or of launch_grad.
template <bool kDq, int kWN, int kMW, bool kSplitB, int kStages, int kGroup,
          bool kCompensate, class Block>
auto grad_kernel() {
  if constexpr (kDq)
    return ca_dq_wgmma_kernel<kWN, kMW, kSplitB, kStages, kGroup,
                              kCompensate, Block::kFresh>;
  else
    return ca_dkdv_wgmma_kernel<kWN, kMW, kSplitB, kStages, kGroup,
                                kCompensate, Block::kFresh>;
}

// One product of dQ (kDq) or of launch_grad: a grid of Gemm<kWN, kMW,
// kSplitB> blocks of Block's shape over rows x cols of each image; with
// per_sm, the resident blocks per SM instead of a launch.
template <int kWN, int kMW, bool kSplitB, int kGroup, bool kCompensate,
          class Block, bool kDq = false>
int launch_grad_gemm(int rows, int cols, int B, const CUtensorMap (&m)[4],
                     int K, const GradEpi& e, cudaStream_t stream,
                     int* per_sm = nullptr) {
  using G = Gemm<kWN, kMW, kSplitB>;
  const auto kernel = grad_kernel<kDq, kWN, kMW, kSplitB, G::kStages, kGroup,
                                  kCompensate, Block>();
  static std::atomic<unsigned long long> opted{0};
  if (int err = opt_in_once(kernel, G::kSmem, opted)) return err;
  if (per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, Block::kThreads, G::kSmem);
  kernel<<<G::grid(rows, cols, B), Block::kThreads, G::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], K, e);
  return (int)cudaGetLastError();
}

// The two kinds of product, of dQ (kDq) or of launch_grad: S and dP, and
// dQ, dV and dK (kSplitB: B's terms are two; kMW its warpgroups over the
// rows).
template <bool kF32, bool kDq = false>
constexpr auto score_gemm = launch_grad_gemm<kKeyCols, 1, kF32, kScoreGroup,
                                             kScoreKahan, ScoreBlock, kDq>;
template <bool kSplitB, bool kDq = false>
constexpr auto grad_gemm =
    launch_grad_gemm<kGradCols, GradGemm<kSplitB>::kMW, kSplitB, kGradGroup,
                     false, GradBlock, kDq>;

// The products of a.mask on a.scratch, laid out by grad_layout() for
// chunks of a.rows key rows: the prep launches, then S, dP, the weights and
// the products per chunk (the design note at the head of this file says
// which of them a mask takes). a.out is dK_eff, a.out2 dV, a.dq dQ: each
// chunk's dQ (+)= dS[:, chunk] K_eff[chunk], the first chunk storing and
// later ones adding.
template <typename T>
int launch_grad(const Args& a) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  const int B = a.B, N = a.N, P = a.P, D = a.D, rows = a.rows;
  const Mask m(a.mask);
  if (a.mask <= 0 || a.mask > (kDV | kDK | kDQ) || rows <= 0 || rows > P ||
      B > 65535 || (long long)B * P > 0x7fffffff ||
      (long long)B * N > 0x7fffffff || (m.dv && a.out2 == nullptr) ||
      (m.dk && a.out == nullptr) || (m.dq && a.dq == nullptr) ||
      (m.dp && (a.v == nullptr || a.delta == nullptr)))
    return (int)cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const bool same = a.k == a.v;
  const GradLayout L = grad_layout(kF32, same, B, N, P, D, rows, m);
  char* base = static_cast<char*>(a.scratch);
  // a part's pointer where the mask reads it (its lo part only for float32
  // input where `lo`), else nullptr
  const auto at = [&](bool used, size_t off) {
    return used ? reinterpret_cast<float*>(base + off) : nullptr;
  };
  float *kh = at(true, L.kh), *kl = at(kF32, L.kl);
  float *vh = at(m.dp, L.vh), *vl = at(m.dp && kF32, L.vl);
  float *qh = at(true, L.qh), *ql = at(true, L.ql);
  float *oh = at(m.dp, L.oh), *ol = at(m.dp, L.ol);
  float *qth = at(m.dk, L.qth), *qtl = at(m.dk && kF32, L.qtl);
  float *oth = at(m.dv, L.oth), *otl = at(m.dv, L.otl);
  float *s = at(true, L.s), *dp = at(m.dp, L.dp);
  float *ph = at(m.dv, L.ph), *pl = at(m.dv, L.pl);
  float *dh = at(m.dk, L.dh), *dl = at(m.dk, L.dl);
  float *kth = at(m.dq, L.kth), *ktl = at(m.dq && kF32, L.ktl);
  float *rh = at(m.dq, L.rh), *rl = at(m.dq, L.rl);
  cudaStream_t st = a.stream;

  ca_dkdv_split_rows<T><<<B * P, 256, 0, st>>>(k, nullptr, kh, kl, P, 0, P,
                                               D);
  if (int err = (int)cudaGetLastError()) return err;
  if (m.dp && !same) {
    ca_dkdv_split_rows<T><<<B * P, 256, 0, st>>>(v, nullptr, vh, vl, P, 0,
                                                 P, D);
    if (int err = (int)cudaGetLastError()) return err;
  }
  ca_dkdv_split_rows<T><<<B * N, 256, 0, st>>>(q, a.kscale, qh, ql, N, 0, N,
                                               D);
  if (int err = (int)cudaGetLastError()) return err;
  if (m.dp) {
    ca_dkdv_split_rows<float><<<B * N, 256, 0, st>>>(a.dO, nullptr, oh, ol,
                                                     N, 0, N, D);
    if (int err = (int)cudaGetLastError()) return err;
  }
  const dim3 tgrid((L.Np + 31) / 32, (D + 31) / 32, B);
  if (m.dk) {
    ca_dkdv_split_t<T><<<tgrid, 256, 0, st>>>(q, qth, qtl, N, D);
    if (int err = (int)cudaGetLastError()) return err;
  }
  if (m.dv) {
    ca_dkdv_split_t<float><<<tgrid, 256, 0, st>>>(a.dO, oth, otl, N, D);
    if (int err = (int)cudaGetLastError()) return err;
  }
  if (m.dq) {  // K transposed, dQ's B operand, as dQ's own prep forms it
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
  if (m.dp) {
    if (int err = make_map(&mp[0], oh, D, N, B, L.Dp, qstride, GS::kBM))
      return err;
    if (int err = make_map(&mp[1], ol, D, N, B, L.Dp, qstride, GS::kBM))
      return err;
  }
  if (m.dv) {
    if (int err = make_map(&mv[2], oth, N, D, B, L.Np, tstride, GV::kBN))
      return err;
    if (int err = make_map(&mv[3], otl, N, D, B, L.Np, tstride, GV::kBN))
      return err;
  }
  if (m.dk) {
    if (int err = make_map(&mk[2], qth, N, D, B, L.Np, tstride, GK::kBN))
      return err;
    if (int err = make_map(&mk[3], kF32 ? qtl : qth, N, D, B, L.Np, tstride,
                           GK::kBN))
      return err;
  }
  const long long kstride = (long long)P * L.Dp;
  for (int r0 = 0; r0 < P; r0 += rows) {
    const int rc = rows < P - r0 ? rows : P - r0;
    const long long ko = (long long)r0 * L.Dp;
    if (int err = make_map(&ms[2], kh + ko, D, rc, B, L.Dp, kstride, GS::kBN))
      return err;
    if (int err = make_map(&ms[3], (kF32 ? kl : kh) + ko, D, rc, B, L.Dp,
                           kstride, GS::kBN))
      return err;
    const long long sstride = (long long)N * L.ld;
    constexpr auto score = score_gemm<kF32>;
    if (int err = score(N, rc, B, ms, D, GradEpi{s, sstride, N, rc, L.ld}, st,
                        nullptr))
      return err;
    if (m.dp) {
      if (int err = make_map(&mp[2], vh + ko, D, rc, B, L.Dp, kstride,
                             GS::kBN))
        return err;
      if (int err = make_map(&mp[3], (kF32 ? vl : vh) + ko, D, rc, B, L.Dp,
                             kstride, GS::kBN))
        return err;
      if (int err = score(N, rc, B, mp, D, GradEpi{dp, sstride, N, rc, L.ld},
                          st, nullptr))
        return err;
    }
    ca_dkdv_weights<<<dim3((rc + 31) / 32, (L.Np + 31) / 32, B), 256, 0,
                      st>>>(s, dp, a.keep, a.lse, a.delta, ph, pl, dh, dl, rh,
                            rl, N, P, r0, rc, L.ld, a.scale);
    if (int err = (int)cudaGetLastError()) return err;
    const long long wstride = (long long)rc * L.Np;
    const long long ostride = (long long)P * D, oo = (long long)r0 * D;
    if (m.dv) {
      if (int err = make_map(&mv[0], ph, N, rc, B, L.Np, wstride, GV::kBM))
        return err;
      if (int err = make_map(&mv[1], pl, N, rc, B, L.Np, wstride, GV::kBM))
        return err;
      constexpr auto grad_v = grad_gemm<true>;
      if (int err = grad_v(rc, D, B, mv, N,
                           GradEpi{a.out2 + oo, ostride, rc, D, D}, st,
                           nullptr))
        return err;
    }
    if (m.dk) {
      if (int err = make_map(&mk[0], dh, N, rc, B, L.Np, wstride, GK::kBM))
        return err;
      if (int err = make_map(&mk[1], dl, N, rc, B, L.Np, wstride, GK::kBM))
        return err;
      constexpr auto grad_k = grad_gemm<kF32>;
      if (int err = grad_k(rc, D, B, mk, N,
                           GradEpi{a.out + oo, ostride, rc, D, D}, st,
                           nullptr))
        return err;
    }
    if (!m.dq) continue;
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
    constexpr auto grad_q = grad_gemm<kF32, true>;
    if (int err = grad_q(N, D, B, mq, rc,
                         GradEpi{a.dq, (long long)N * D, N, D, D, a.kscale,
                                 r0 > 0},
                         st, nullptr))
      return err;
  }
  return 0;
}

// The plan of launch_grad for this mask, these shapes and chunk rows (V
// taken to be K, as on the main path), without a launch: plan[0] chunk
// rows, [1] chunks, [2] S blocks (dP's are the same; a full chunk's grid),
// [3] weights blocks, [4] dV blocks, [5] dK blocks, [6] - [8] the S, dV and
// dK products' dynamic shared memory per block, [9] - [11] their stages,
// [12] - [14] their resident blocks per SM, [15] threads a product block,
// [16] launches per call, [17] and [18] the S block's rows and columns,
// [19] and [20] dV's, [21] and [22] dK's, [23] dQ product blocks, [24] its
// dynamic shared memory per block, [25] its stages, [26] its resident
// blocks per SM, [27] and [28] its block's rows and columns, [29] and [30]
// the registers a thread that the producer warpgroup and the consumers set
// (setmaxnreg). Every product is described whatever the mask; the
// launches count the mask's.
template <typename T>
int plan_grad(int mask, int B, int N, int P, int D, int rows, int* plan) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  using GS = ScoreGemm<kF32>;
  using GV = GradGemm<true>;
  using GK = GradGemm<kF32>;
  if (mask <= 0 || mask > (kDV | kDK | kDQ) || rows <= 0 || rows > P)
    return (int)cudaErrorInvalidValue;
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
  if (int err = score_gemm<kF32>(1, 1, 1, none, 0, e, nullptr, &plan[12]))
    return err;
  if (int err = grad_gemm<true>(1, 1, 1, none, 0, e, nullptr, &plan[13]))
    return err;
  if (int err = grad_gemm<kF32>(1, 1, 1, none, 0, e, nullptr, &plan[14]))
    return err;
  plan[15] = GradBlock::kThreads;
  plan[16] = Mask(mask).launches() * (1 + chunks);
  plan[17] = GS::kBM;
  plan[18] = GS::kBN;
  plan[19] = GV::kBM;
  plan[20] = GV::kBN;
  plan[21] = GK::kBM;
  plan[22] = GK::kBN;
  plan[23] = blocks(GK::grid(N, D, B));     // dQ's product is dK's kind
  plan[24] = (int)GK::kSmem;
  plan[25] = GK::kStages;
  if (int err = grad_gemm<kF32, true>(1, 1, 1, none, 0, e, nullptr,
                                      &plan[26]))
    return err;
  plan[27] = GK::kBM;
  plan[28] = GK::kBN;
  plan[29] = GradBlock::kProducerRegs;
  plan[30] = GradBlock::kConsumerRegs;
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
    constexpr auto score = score_gemm<kF32, true>;
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
    constexpr auto grad_q = grad_gemm<kF32, true>;
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
// and [16] the dQ block's, [17] and [18] the registers a thread that the
// producer warpgroup and the consumers set.
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
  if (int err = score_gemm<kF32, true>(1, 1, 1, none, 0, e, nullptr,
                                       &plan[9]))
    return err;
  if (int err = grad_gemm<kF32, true>(1, 1, 1, none, 0, e, nullptr,
                                      &plan[10]))
    return err;
  plan[11] = GradBlock::kThreads;
  plan[12] = 4 + 4 * chunks;
  plan[13] = GS::kBM;
  plan[14] = GS::kBN;
  plan[15] = GQ::kBM;
  plan[16] = GQ::kBN;
  plan[17] = GradBlock::kProducerRegs;
  plan[18] = GradBlock::kConsumerRegs;
  return 0;
}

// which: 0 dq, 1 launch_grad (a.mask).
template <typename T>
int launch(int which, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.P <= 0 || a.D <= 0)
    return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0:
      if (a.plan != nullptr)
        return plan_dq<T>(a.B, a.N, a.P, a.D, a.rows, a.plan);
      return launch_dq<T>(a);
    case 1:
      if (a.plan != nullptr)
        return plan_grad<T>(a.mask, a.B, a.N, a.P, a.D, a.rows, a.plan);
      return launch_grad<T>(a);
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
// current device, without a launch: the 19 ints plan_dq fills.
int sketchedit_contextual_attention_dq_plan(int dtype, int rows, int B, int N,
                                            int P, int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  a.rows = rows;
  return launch_typed(0, dtype, a);
}

// dQ, dK_eff and dV, or those of them in `mask` (1 dV, 2 dK_eff, 4 dQ;
// the joint backward 7, the fused dK/dV 3), from one sequence whose S, dP
// and dS its products share: the same arguments as dq, the three outputs,
// and a scratch of sketchedit_contextual_attention_grad_scratch's bytes for
// this mask and these shapes and its `rows` key rows a chunk. An output
// the mask leaves out may be NULL, and so may V and delta where the mask
// forms no dP (dV alone).
int sketchedit_contextual_attention_grad(int dtype, int mask, const void* q,
                                         const void* k, const void* v,
                                         const void* keep, const void* kscale,
                                         const void* dO, const void* lse,
                                         const void* delta, void* dq,
                                         void* dk, void* dv, void* scratch,
                                         int B, int N, int P, int D, int rows,
                                         float scale, void* stream) {
  Args a{q, k, v, f(keep), f(kscale), f(dO), f(lse), f(delta),
         f(dk), f(dv), B, N, P, D, scale,
         static_cast<cudaStream_t>(stream)};
  a.scratch = scratch;
  a.rows = rows;
  a.dq = f(dq);
  a.mask = mask;
  return launch_typed(1, dtype, a);
}

// Bytes of scratch the sequence of `mask` needs for these shapes (same: V
// is K, one pointer) when the part that grows with the key rows (S, dP,
// the weights' terms, dS's by rows, as the mask reads them) may take `cap`
// bytes; *rows gets the key rows a chunk. -1 for shapes or masks it
// refuses.
long long sketchedit_contextual_attention_grad_scratch(int dtype, int mask,
                                                       int same, int B, int N,
                                                       int P, int D,
                                                       long long cap,
                                                       int* rows) {
  if (B <= 0 || N <= 0 || P <= 0 || D <= 0 || cap <= 0 ||
      (dtype != 0 && dtype != 1) || mask <= 0 || mask > (kDV | kDK | kDQ))
    return -1;
  const Mask m(mask);
  *rows = grad_chunk_rows(B, N, P, cap, m);
  return (long long)grad_layout(dtype == 0, same != 0, B, N, P, D, *rows, m)
      .total;
}

// The launch plan of the sequence of `mask` for these shapes and `rows`
// key rows a chunk on the current device, without a launch: the 31 ints
// plan_grad fills.
int sketchedit_contextual_attention_grad_plan(int dtype, int mask, int rows,
                                              int B, int N, int P, int D,
                                              int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, nullptr, nullptr, B,       N,       P,       D,
         0.f,     nullptr, plan};
  a.rows = rows;
  a.mask = mask;
  return launch_typed(1, dtype, a);
}

const char* sketchedit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
