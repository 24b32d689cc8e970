// Contextual-attention forward for Hopper (sm_90a), CUDA C++.
//
// The default forward (sketchedit_contextual_attention_fwd) replaces
// sketchedit_tpu/ops/attention_pallas.py::_attn_kernel (launched by
// _attention_core_raw), the shared forward (..._fwd_shared) replaces
// ::_attn_shared_kernel (_attention_core_shared_raw), and
// ca_fwd_dsplit_kernel replaces ::_attn_kernel_dsplit
// (_attention_core_dsplit_raw). For each batch b and query row i all three
// compute
//
//   logit_ij = keep_bj * scale * sum_d Q_bid K_bjd kscale_bd   (real j < P)
//   O_bi     = sum_j softmax_j(logit_i) V_bj,   lse_bi = logsumexp_j logit_ij
//
// kscale is a per-channel scale of the keys (the background's inverse L2
// norm on the main path, which passes K = V, so the keys are formed in
// float32 here and no rounded K tensor is ever made).
// A gated key (keep = 0) gets logit 0, not -inf: it still adds exp(0) to the
// denominator, so an all-gated row gives the uniform mean of V. Ragged N, P
// and D need no padded copies from the caller. Inputs are float32 or
// bfloat16, and O is written in the input type or, for bfloat16 inputs, in
// float32 when the caller asks. lse is float32.
//
// What bounds them on an H100. At 256^2, B = 1 (N = P = 961, D = 1536) the
// two products are 5.67 GFLOP against 11.8 MB of float32 traffic (V, read as
// Q, K and V, and the output), so the work is arithmetic: ~85 us at the
// SXM's 67 TFLOP/s on the CUDA cores, ~34 us as split TF32 on the tensor
// cores (three passes at 495 TFLOP/s) against ~4 us of memory time.
//
// The default and shared forwards: warpgroup wgmma fed by TMA. Both run one
// host-side sequence of kernels (the shared one passes its one tensor as Q,
// K and V); the products are float32-accurate split TF32 (three passes for
// float32 operands, two where one side holds bfloat16 data, which is exact
// in TF32). Phases, each one launch, on a scratch the wrapper allocates:
//   keys    K as TF32 terms hi = rna(x), lo = rna(x - hi) (float32 input;
//           a bfloat16 key is one exact term), rows padded to Dp = D
//           rounded up to 4, so every row is 16-byte aligned for TMA
//           whatever the caller's D and pointers (no staging path of its
//           own for unaligned inputs: the prep kernels read element-wise);
//   values  V transposed to (B, D, Pp) and split the same way: TF32 wgmma
//           takes both operands K-major (only 16-bit types may be
//           transposed), and P V contracts over keys;
// then per chunk of query rows (the scratch of Q's terms, S and P is
// capped, 256 MiB by the wrapper's default, so a 2048^2 edit takes chunks):
//   queries Q * kscale formed in float32 and split (kscale goes on the
//           query rows in both forwards, so raw bfloat16 keys enter whole);
//   logits  S = (Q kscale) K^T by ca_fwd_wgmma_kernel, a block 64 query
//           rows x 128 keys; the epilogue writes logit = S keep scale;
//   softmax one warp per row: m = max logit, P = exp(logit - m) split into
//           its TF32 terms, 1 / l and lse = m + log l (l = sum P, in a
//           fixed butterfly order);
//   P V     the same kernel over K = P keys, a block 128 rows x 96 output
//           columns in float32, 64 x 192 in bfloat16; the epilogue writes
//           O = acc / l in the output type.
// ca_fwd_wgmma_kernel (its body, wgmma_product in
// contextual_attention_wgmma.cuh, serves the fused dK/dV backward too) is
// two consumer warpgroups and a producer warp: the
// producer's lane 0 keeps TMA boxes (32 contraction elements x the tile's
// rows, 128-byte swizzle, out-of-bounds elements zero-filled, which
// replaces the ragged edges' bounds checks) of all four terms in flight
// through a ring of mbarrier-guarded stages; each warpgroup runs wgmma
// m64nNk8 from shared-memory descriptors. At 256^2, B = 1 both products
// are 128 blocks on 132 SMs, every m64 tile full but the last row tile's
// (961 = 15 x 64 + 1: ~6% of each product is padding). Every k8 step is
// one wgmma per pass: the first pass starts a fresh accumulator (scale-d
// 0), the others add into it, and one round-to-nearest FADD adds it to
// the running sum, because the tensor core truncates as it accumulates
// (the mma.sync kernels' rule, contextual_attention_common.cuh add_into).
// Inside a stage each warpgroup alternates two fresh accumulators, so one
// step's FADDs overlap the next step's wgmma; the stage's last step is
// waited for before the stage is released (carrying the overlap across
// stages made ptxas serialize every wgmma, C7514). S sums its steps in
// groups of 16 (four stages) before adding each group to its total, so
// its chain of float32 adds is ~28 long, as the mma.sync kernels' per-warp
// partials were; one chain of 192 put the output 3.7x further from
// float64 (relative L2) than the D-split's. Both terms of every
// operand are exact TF32 values (low 13 bits clear), so the result does
// not depend on how the tensor core reads dropped bits. No atomics and a
// fixed order everywhere: two calls give the same bits.
//
// How this answers what held the mma.sync block back (16 query rows over
// all of D, 8-row tiles at B = 1, per-warp cp.async staging, ~0.2 mma a
// cycle per SM): (1) full m64 tiles, and 128 blocks cover the SMs at
// B = 1; (2) the split is done once per element in the prep phases, not
// per warp per fragment, and one wgmma does what 32 or 48 mma.sync did,
// with TMA computing the addresses; (3) no Q tile is held over all of D:
// both products stream their contraction in 32-element stages, so shared
// memory sets no widest D (the stages take 192-230 KB at any D); (4) TMA,
// mbarriers and wgmma are the staging and the product. What bounds it
// now: at 256^2, B = 8 the logits product runs at ~40% of the card's TF32
// rate per pass and P V at ~34%. Not L2: sharing the larger box between
// the two blocks of a cluster (TMA multicast), a third less traffic, made
// S 1.6x slower; not the shared-memory reads of the operands: one
// warpgroup of 64 x 128 (fewer bytes per multiply-add than two of 64 x
// 64) is 5-9% slower; 128 x 128 tiles spill (scripts/fwd_variants.py
// and PERF.md keep the numbers). What is left is each warpgroup's chain
// per k8 step, its passes into a fresh accumulator, the wait and the
// FADDs, of which two warpgroups keep the tensor cores about half busy.
// Besides, the split copies (K, V^T and Q terms: 6 B N D floats in
// float32) and S and P's terms pass through L2 and device memory (the prep
// and softmax phases are ~22% of a call at 256^2, B = 8), and the launches
// per forward are 2 + 4 per chunk where the mma.sync kernel took one.
//
// ca_fwd_dsplit_kernel (attention_pallas.py:156, launched at :234) splits D
// over a cluster of two blocks: grid (q tiles, 2 x column slabs, B),
// __cluster_dims__(1, 2, 1), so a query tile's two blocks run on
// neighbouring SMs and can read each other's shared memory (sm_90). Block
// `half`, its rank in the cluster, owns columns [half * Dh, min(D, (half +
// 1) * Dh)) of D, Dh = ceil(D/2) rounded up to 4 (the result does not
// depend on the cut), for the contraction of S and for the output. Each
// block is 8 warps on mma.sync over 16 query rows (the mma's m16, a full
// tile: at 256^2, B = 1, 61 clusters are 122 blocks on 132 SMs) or, where
// 32-row clusters
// give every SM a block, 32 rows as two m16 tiles that share each K and V
// fragment; both products split TF32 through mma_tile, kscale on the
// staged query rows (50 KB of float32 a 16-row tile at D = 1536), so raw
// bfloat16 keys enter whole. Per key
// tile of kT = 64:
//   S   each warp contracts its own 1/8 of the block's columns (96 at D =
//       1536), staging its K rows with cp.async, into a partial S per m16
//       tile (16 x 64);
//   sum the block sums its eight partials in warp order and puts the sum in
//       one of two slots, alternating by key tile; after one cluster
//       barrier it reads the peer's sum through distributed shared memory
//       and forms S = own + peer, which float addition makes bit-identical
//       in the two blocks, so their running max and sum agree and the two
//       halves of the output are normalised alike; the online softmax
//       writes P and alpha to shared memory;
//   P V after a block barrier each warp rescales its fragments and adds P V
//       for its 96 output columns (12 m16n8 fragments per m16 tile in
//       registers, 48 floats a thread), staging V rows with cp.async, a
//       fresh accumulator per k8 step added with a round-to-nearest FADD
//       (add_into's rule).
// Every logit is computed once (the TPU kernel computes S in both halves,
// since a TPU core cannot read another program's VMEM). A block overwrites
// a slot only after the next tile's barrier, which its peer reaches only
// once it has read that slot, so one cluster barrier per tile suffices. A
// block with no columns (D <= Dh) still takes part in every barrier with a
// zero partial, and a last barrier keeps each block resident until its
// peer has read its final sum. Only the first half writes lse. A half wider
// than 768 columns takes more column slabs (clusters along y), each
// recomputing S; the Q tile over half of D bounds D at 3584 (both input
// types; 32-row tiles fit to D = 1536). What holds it back is each warp's
// chain of fragment loads, splits, mma passes and FADDs:
// partial S and P V take 44% of a key tile each, the exchange 6%, at 0.21
// mma a cycle per SM with 16 rows; sharing the K and V fragments over two
// m16 tiles lifts that to 0.28 (scripts/dsplit_variants.py clocks).
// Inference only.

#include <cooperative_groups.h>

#include "contextual_attention_common.cuh"
#include "contextual_attention_wgmma.cuh"

namespace {

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// A warp's staging area in the D-split kernel, in elements of T: kKStages K
// steps of [kT keys][16 columns], or kVStages V steps of [8 keys][kVLd]
// (the warp's kG 32-column groups and a pad of 32 bytes, so the four key
// rows a fragment load spans start 8 banks apart), or, between the two,
// the warp's partial S [kMT * kRows][kPartLd] floats for its kMT m16
// tiles. The copies a warp has in flight are what hides the latency of L2,
// so a bfloat16 area, half the bytes a step, takes twice the steps.
template <typename T, int kG, int kMT> struct Stage {
  static constexpr int kKStages = sizeof(T) == 4 ? 3 : 6;  // K steps
  static constexpr int kVStages = sizeof(T) == 4 ? 2 : 4;  // V steps
  static constexpr int kK = kT * 16;
  static constexpr int kVLd = kG * 32 + 32 / (int)sizeof(T);
  static constexpr int kV = 8 * kVLd;
  static constexpr size_t kBytes = cmax(
      cmax(kKStages * kK * sizeof(T), kVStages * kV * sizeof(T)),
      (size_t)kMT * kRows * kPartLd * sizeof(float));
};

// Shared-memory bytes of a D-split block of kMT m16 row tiles: the Q tile
// over half of D, the warps' staging areas, P, the two exchange slots
// [2][rows][kT], alpha and l per row.
template <typename T, int kMT> size_t dsplit_smem_bytes(int D) {
  return sizeof(float) * (size_t)kMT * kRows *
             (mma_q_ld(half_cut(D)) + kPLd + 2 * kT + 2) +
         kWarps * Stage<T, kHalfGroups, kMT>::kBytes;
}

// One cluster of two blocks: rows [q0, q0 + 16 kMT) of image b, all keys.
// The block of rank `half` contracts columns [c_lo, c_hi) of D for its
// partial S, sums it with its peer's through distributed shared memory,
// and accumulates P V over output columns [c_lo + s kHalfCols, +
// kHalfCols) of its half, s = blockIdx.y / 2 the column slab. kMT m16 row
// tiles share each K and V fragment. kVec: D is a multiple of 4 and every
// pointer is 16-byte aligned.
template <typename T, typename TO, int kMT, bool kVec>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(kThreads, 1)
ca_fwd_dsplit_kernel(const T* Q, const T* K, const T* V, const float* keep,
                     const float* kscale, TO* O, float* lse, int N, int P,
                     int D, float scale) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);  // K and V are split
  constexpr int kR = kMT * kRows;                    // the block's rows
  constexpr int kChunks = kHalfGroups * 8;   // four-element chunks of a row
  static_assert(kChunks <= 32, "a row's chunks a copy");
  using St = Stage<T, kHalfGroups, kMT>;
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int half = blockIdx.y & 1;               // == cluster.block_rank()
  const int Dh = half_cut(D);
  const int c_lo = half * Dh;
  const int c_hi = min(D, c_lo + Dh);            // empty when D <= Dh (half 1)
  const int Ds = mma_cols(Dh), ldq = mma_q_ld(Dh), qcols = kWarps * Ds;
  float* qs = smem;                              // [kR][ldq]
  char* stages = reinterpret_cast<char*>(qs + kR * ldq);
  float* ps = reinterpret_cast<float*>(stages + kWarps * St::kBytes);
  float* xs = ps + kR * kPLd;                    // [2][kR][kT], by tile parity
  float* alpha_s = xs + 2 * kR * kT;             // [kR]
  float* l_s = alpha_s + kR;                     // [kR]
  const float* peer_xs = cluster.map_shared_rank(xs, half ^ 1);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kR;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const T* Vb = V + (size_t)b * P * D;
  const float* keep_b = keep + (size_t)b * P;
  const float* ks_b = kscale + (size_t)b * D;
  char* mine = stages + w * St::kBytes;          // this warp's staging area
  T* kst = reinterpret_cast<T*>(mine);           // [kKStages][kT][16]
  T* vst = reinterpret_cast<T*>(mine);           // [kVStages][8][kVLd]
  float* part = reinterpret_cast<float*>(mine);  // [kR][kPartLd]

  // the Q tile over this block's columns, times kscale in float32; rows
  // past N and columns past the half are 0
  for (int i = tid; i < kR * qcols; i += kThreads) {
    const int r = i / qcols, d = i % qcols;
    float x = 0.f;
    if (q0 + r < N && c_lo + d < c_hi)
      x = to_f(Qb[(size_t)(q0 + r) * D + c_lo + d]) * ks_b[c_lo + d];
    qs[r * ldq + d] = x;
  }
  __syncthreads();

  float acc[kMT][kHalfGroups][4][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < kHalfGroups; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][c][j][e] = 0.f;
  // softmax rows: warp w owns rows 2w and 2w + 1 of each m16 tile, 16
  // lanes a row, 4 keys a lane; m_run and l_run are the rows' running max
  // and sum
  const int srow = 2 * w + (lane >> 4), skey = 4 * (lane & 15);
  float m_run[kMT], l_run[kMT];
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    m_run[m] = -INFINITY;
    l_run[m] = 0.f;
  }
  const int d_lo = c_lo + w * Ds, d_hi = min(c_hi, d_lo + Ds);
  const int nstep = d_hi > d_lo ? (d_hi - d_lo + 15) / 16 : 0;
  const int cw = c_lo + (blockIdx.y >> 1) * kHalfCols +
                 w * (kHalfGroups * 32);         // the warp's output columns

  for (int k0 = 0, par = 0; k0 < P; k0 += kT, par ^= 1) {
    // 1. this warp's partial S over columns [d_lo, d_hi), 16 at a time:
    // step i stages K rows k0 .. k0 + 63, columns d_lo + 16i .. + 15,
    // kKStages - 1 steps ahead (lane (g, t) reads columns
    // 4t .. 4t + 3, k = t and t + 4 of k8 step h are 4t + 2h and + 1)
    auto stage_k = [&](int i) {
      if (i < nstep) {
        T* dst = kst + (i % St::kKStages) * St::kK;
        const int d0 = d_lo + 16 * i;
        const T* krow = Kb + (size_t)(k0 + (lane >> 2)) * D;
#pragma unroll (kVec ? kT * 4 / 32 : 1)
        for (int n = 0; n < kT * 4 / 32; ++n) {
          const int r = (lane >> 2) + 8 * n, q = (lane & 3) * 4;
          copy4<kVec>(dst + r * 16 + q, krow + (size_t)(8 * n) * D,
                      k0 + r < P, d0 + q, c_hi);
        }
      }
      cp_commit();
    };
    float s[kMT][8][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < St::kKStages - 1; ++i) stage_k(i);
#pragma unroll 1
    for (int i = 0; i < nstep; ++i) {
      stage_k(i + St::kKStages - 1);
      cp_wait<St::kKStages - 1>();
      __syncwarp();                    // step i is staged, by every lane
      const T* kb = kst + (i % St::kKStages) * St::kK;
      const int d = w * Ds + 16 * i + 4 * t;     // column of the Q tile
      uint32_t ah[kMT][2][4], al[kMT][2][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float4 qa = lds4(qs + (16 * m + g) * ldq + d);
        const float4 qb = lds4(qs + (16 * m + g + 8) * ldq + d);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          to_tf32<true>(elem(qa, 2 * h), ah[m][h][0], al[m][h][0]);
          to_tf32<true>(elem(qb, 2 * h), ah[m][h][1], al[m][h][1]);
          to_tf32<true>(elem(qa, 2 * h + 1), ah[m][h][2], al[m][h][2]);
          to_tf32<true>(elem(qb, 2 * h + 1), ah[m][h][3], al[m][h][3]);
        }
      }
      // two n8 tiles at a time, both k8 steps: four independent mma tiles
      // for each m16 tile
#pragma unroll
      for (int jp = 0; jp < 8; jp += 2) {
        fence();
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float4 kf = lds4(kb + (8 * (jp + jj) + g) * 16 + 4 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            to_tf32<kF32>(elem(kf, 2 * h), bh[2 * jj + h][0],
                          bl[2 * jj + h][0]);
            to_tf32<kF32>(elem(kf, 2 * h + 1), bh[2 * jj + h][1],
                          bl[2 * jj + h][1]);
          }
        }
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          float x[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
          mma_tile<true, kF32, 4, 2>(x, ah[m], al[m], bh, bl);  // 2jj + h
#pragma unroll
          for (int n = 0; n < 4; ++n) add_into(s[m][jp + n / 2], x[n]);
        }
      }
      __syncwarp();                    // every lane is done with step i
    }
    cp_wait<0>();
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* pj = part + (16 * m + g) * kPartLd + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(pj) = make_float2(s[m][j][0], s[m][j][1]);
        *reinterpret_cast<float2*>(pj + 8 * kPartLd) =
            make_float2(s[m][j][2], s[m][j][3]);
      }
    __syncthreads();  // every warp's partial is written

    // 2. this block's S: the eight partials, summed in warp order, put in
    // the slot of this tile's parity, where the peer reads it
    float4 own[kMT];
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int row = 16 * m + srow;
      float4 x = lds4(reinterpret_cast<const float*>(stages) +
                      row * kPartLd + skey);
#pragma unroll
      for (int u = 1; u < kWarps; ++u) {
        const float4 y = lds4(
            reinterpret_cast<const float*>(stages + u * St::kBytes) +
            row * kPartLd + skey);
        x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
      }
      own[m] = x;
      *reinterpret_cast<float4*>(xs + (par * kR + row) * kT + skey) = x;
    }
    cluster.sync();  // both blocks' sums are written; every partial is read

    // 3. S = own + peer, the same bits in both blocks; the online softmax.
    // A gated key gets logit 0, a padded key (j >= P) -inf; a tile holds at
    // least one real key, so the running max is finite.
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const int row = 16 * m + srow;
      const float4 y = lds4(peer_xs + (par * kR + row) * kT + skey);
      float logit[4], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + skey + e;
        logit[e] = j < P ? (elem(own[m], e) + elem(y, e)) * keep_b[j] * scale
                         : -INFINITY;
        mx = fmaxf(mx, logit[e]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[m], mx);
      const float alpha = expf(m_run[m] - m_new);  // 0 on the first tile
      float p[4], psum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(logit[e] - m_new);
        psum += p[e];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run[m] = l_run[m] * alpha + psum;
      m_run[m] = m_new;
      *reinterpret_cast<float4*>(ps + row * kPLd + skey) =
          make_float4(p[0], p[1], p[2], p[3]);
      if ((lane & 15) == 0) alpha_s[row] = alpha;
    }
    __syncthreads();  // P and alpha are written

    // 4. acc = acc * alpha + P V over this warp's columns, 8 keys a step:
    // step i stages V rows k0 + 8i .. + 7 at the warp's 96 columns,
    // kVStages - 1 steps ahead. Group c's rows t and t + 4 at columns 32c +
    // 4g .. + 3 give the B fragments of its four n8 tiles (tile e's column
    // n is 32c + 4n + e).
    if (cw < c_hi) {
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float alo = alpha_s[16 * m + g], ahi = alpha_s[16 * m + g + 8];
#pragma unroll
        for (int c = 0; c < kHalfGroups; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[m][c][j][0] *= alo; acc[m][c][j][1] *= alo;
            acc[m][c][j][2] *= ahi; acc[m][c][j][3] *= ahi;
          }
      }
      const int nstep_v = (min(kT, P - k0) + 7) / 8;
      auto stage_v = [&](int i) {
        if (i < nstep_v) {
          T* dst = vst + (i % St::kVStages) * St::kV;
          const T* vrow = Vb + (size_t)(k0 + 8 * i) * D;
          const int q = 4 * lane;
          // a row a copy, lanes past its 24 chunks idle
#pragma unroll (kVec ? 8 : 1)
          for (int r = 0; r < 8 && lane < kChunks; ++r)
            copy4<kVec>(dst + r * St::kVLd + q, vrow + (size_t)r * D,
                        k0 + 8 * i + r < P, cw + q, c_hi);
        }
        cp_commit();
      };
#pragma unroll
      for (int i = 0; i < St::kVStages - 1; ++i) stage_v(i);
#pragma unroll 1
      for (int i = 0; i < nstep_v; ++i) {
        stage_v(i + St::kVStages - 1);
        cp_wait<St::kVStages - 1>();
        __syncwarp();                  // step i is staged, by every lane
        uint32_t ah[kMT][1][4], al[kMT][1][4];
        // A fragments {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            to_tf32<true>(ps[(16 * m + g + 8 * (r & 1)) * kPLd + 8 * i + t +
                             4 * (r >> 1)],
                          ah[m][0][r], al[m][0][r]);
        const T* vb = vst + (i % St::kVStages) * St::kV;
        // one 32-column group at a time: its four n8 tiles
#pragma unroll
        for (int c = 0; c < kHalfGroups; ++c) {
          fence();
          const float4 va = lds4(vb + t * St::kVLd + 32 * c + 4 * g);
          const float4 vc = lds4(vb + (t + 4) * St::kVLd + 32 * c + 4 * g);
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            to_tf32<kF32>(elem(va, e), bh[e][0], bl[e][0]);
            to_tf32<kF32>(elem(vc, e), bh[e][1], bl[e][1]);
          }
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
            float x[4][4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int k = 0; k < 4; ++k) x[e][k] = 0.f;
            mma_tile<true, kF32, 4, 1>(x, ah[m], al[m], bh, bl);
#pragma unroll
            for (int e = 0; e < 4; ++e) add_into(acc[m][c][e], x[e]);
          }
        }
        __syncwarp();                  // every lane is done with step i
      }
      cp_wait<0>();
    }
  }

  // l per row; lse from the first half of the first slab
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
    const int row = 16 * m + srow;
    if ((lane & 15) == 0) {
      l_s[row] = l_run[m];
      if (lse != nullptr && blockIdx.y == 0 && q0 + row < N)
        lse[(size_t)b * N + q0 + row] = m_run[m] + logf(l_run[m]);
    }
  }
  // the peer has read this block's last sum; l is written
  cluster.sync();
  // O = acc / l over the warp's columns of this half
  TO* Ob = O + (size_t)b * N * D;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * m + g + 8 * hh;
      if (q0 + r >= N) continue;
      const float inv_l = 1.f / l_s[r];
      TO* orow = Ob + (size_t)(q0 + r) * D;
#pragma unroll
      for (int c = 0; c < kHalfGroups; ++c) {
        const int col = cw + 32 * c + 8 * t;  // tile e, n = 2t (+1): col + e (+4)
        store4<kVec>(orow, col, c_hi,
                     make_float4(acc[m][c][0][2 * hh] * inv_l,
                                 acc[m][c][1][2 * hh] * inv_l,
                                 acc[m][c][2][2 * hh] * inv_l,
                                 acc[m][c][3][2 * hh] * inv_l));
        store4<kVec>(orow, col + 4, c_hi,
                     make_float4(acc[m][c][0][2 * hh + 1] * inv_l,
                                 acc[m][c][1][2 * hh + 1] * inv_l,
                                 acc[m][c][2][2 * hh + 1] * inv_l,
                                 acc[m][c][3][2 * hh + 1] * inv_l));
      }
    }
}
// --- the default and shared forwards: TMA-fed wgmma ------------------------
// (the prep bodies and the product's body: contextual_attention_wgmma.cuh)

constexpr int kLogitCols = 64;   // keys a warpgroup in S
constexpr int kOutCols = 96;     // output columns a warpgroup in P V
constexpr int kOutRowGroups = 2; // P V's warpgroups over the rows (float32)

// Rows r0 .. r0 + rc of each image of `in` (B, rows_in, D), times ks (B, D)
// where given, in float32, as TF32 terms into hi and lo (B, rc, Dp), 0 past
// D. One block a row.
template <typename T>
__global__ void __launch_bounds__(256)
ca_fwd_split_rows(const T* in, const float* ks, float* hi, float* lo,
                  int rows_in, int r0, int rc, int D) {
  split_rows(in, ks, hi, lo, rows_in, r0, rc, D);
}

// V (B, P, D) transposed to (B, D, Pp) as TF32 terms, 0 past P; 32 x 32
// tiles through shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
ca_fwd_split_vt(const T* V, float* hi, float* lo, int P, int D) {
  split_t(V, hi, lo, P, D);
}

// Where a product's epilogue writes. Logits: s[b][i][j] (rows x ld) =
// acc * keep[b][j] * scale for i < rows, j < cols (= P). Output:
// o[b][r0 + i][j] (N x cols, cols = D) = acc * inv_l[b][i].
struct Epi {
  float* s;
  void* o;
  const float* keep;
  const float* inv_l;
  float scale;
  int rows, cols, ld, N, r0;
};

// The logits (kLogits) or P V product: wgmma_product's block (A the
// query rows' terms, B the keys' or the transposed values'), S summing its
// steps in runs of kSumStages stages, and the epilogue e.
template <int kWN, int kMW, bool kSplitB, int kStages, bool kLogits,
          typename TO>
__global__ void __launch_bounds__(kWgThreads, 1)
ca_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap a_hi,
                    const __grid_constant__ CUtensorMap a_lo,
                    const __grid_constant__ CUtensorMap b_hi,
                    const __grid_constant__ CUtensorMap b_lo, int K,
                    Epi e) {
  constexpr int kBM = kTileM * kMW, kBN = kWN * 2 / kMW;  // the block's tile
  float acc[kWN / 2];
  if (!wgmma_product<kWN, kMW, kSplitB, kStages, kLogits ? kSumStages : 0>(
          a_hi, a_lo, b_hi, b_lo, K, acc))
    return;                                               // the producer
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int wrow = kMW == 2 ? wg * kTileM : 0;
  const int wcol = kMW == 2 ? 0 : wg * kWN;
  const int b = blockIdx.z, row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;

  // acc[4j + h] is row 16 (warp % 4) + g (+ 8 for h >= 2), column 8j + 2t
  // (+ 1 for odd h) of the warpgroup's tile
  const int g = lane >> 2, t = lane & 3;
  const int r = row0 + wrow + 16 * (warp & 3) + g;
  const int cb = col0 + wcol + 2 * t;
  if constexpr (kLogits) {
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = cb + 8 * j + h;
        if (col >= e.cols) continue;
        const float gk = e.keep[(long long)b * e.cols + col] * e.scale;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int i = r + 8 * v;
          if (i < e.rows)
            e.s[((long long)b * e.rows + i) * e.ld + col] =
                acc[4 * j + 2 * v + h] * gk;
        }
      }
  } else {
    TO* o = static_cast<TO*>(e.o);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = r + 8 * v;
      if (i >= e.rows) continue;
      const float inv_l = e.inv_l[(long long)b * e.rows + i];
      TO* orow = o + ((long long)b * e.N + e.r0 + i) * e.cols;
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = cb + 8 * j + h;
          if (col < e.cols) store(orow + col, acc[4 * j + 2 * v + h] * inv_l);
        }
    }
  }
}

// One warp a query row of the chunk: m = max_j logit, P = exp(logit - m)
// as TF32 terms (0 past P), 1 / l and, where asked, lse = m + log l, l the
// sum of P in a fixed order.
__global__ void __launch_bounds__(256)
ca_fwd_softmax(const float* s, float* p_hi, float* p_lo, float* inv_l,
               float* lse, int rows, int N, int r0, int P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 8 + warp, b = blockIdx.y;
  if (i >= rows) return;
  const int Pp = round4(P);
  const long long base = ((long long)b * rows + i) * Pp;
  const float4* x = reinterpret_cast<const float4*>(s + base);
  float m = -INFINITY;
  for (int q = lane; 4 * q < P; q += 32) {
    const float4 v = x[q];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * q + u < P) m = fmaxf(m, elem(v, u));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float l = 0.f;
  for (int q = lane; 4 * q < Pp; q += 32) {
    const float4 v = x[q];
    float h[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float p = 4 * q + u < P ? expf(elem(v, u) - m) : 0.f;
      l += p;
      split_tf32(p, h[u], lo[u]);
    }
    reinterpret_cast<float4*>(p_hi + base)[q] =
        make_float4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<float4*>(p_lo + base)[q] =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) {
    inv_l[(long long)b * rows + i] = 1.f / l;
    if (lse != nullptr) lse[(long long)b * N + r0 + i] = m + logf(l);
  }
}

// The scratch of one call, in bytes from its start (each part 256-byte
// aligned): the keys' and the transposed values' terms (lo parts only for
// float32 input), then, for a chunk of `rows` query rows, Q kscale's
// terms, the logits, P's terms and 1 / l.
struct Layout {
  int Dp, Pp, rows;
  size_t kh, kl, vh, vl, qh, ql, s, ph, pl, il, total;
};

Layout layout(bool f32, int B, int P, int D, int rows) {
  Layout L;
  L.Dp = round4(D);
  L.Pp = round4(P);
  L.rows = rows;
  size_t at = 0;
  const auto take = [&](size_t bytes) {
    const size_t o = at;
    at = (at + bytes + 255) / 256 * 256;
    return o;
  };
  const size_t kb = 4 * (size_t)B * P * L.Dp, vb = 4 * (size_t)B * D * L.Pp;
  const size_t qb = 4 * (size_t)B * rows * L.Dp;
  const size_t sb = 4 * (size_t)B * rows * L.Pp;
  L.kh = take(kb);
  L.kl = f32 ? take(kb) : L.kh;
  L.vh = take(vb);
  L.vl = f32 ? take(vb) : L.vh;
  L.qh = take(qb);
  L.ql = take(qb);
  L.s = take(sb);
  L.ph = take(sb);
  L.pl = take(sb);
  L.il = take(4 * (size_t)B * rows);
  L.total = at;
  return L;
}

// Query rows a chunk: all N where the chunked part of the scratch (Q's
// terms, S, P's terms, 1 / l) fits in `cap` bytes, else the most multiples
// of the 64-row tile that fit, at least one tile.
int chunk_rows(int B, int N, int P, int D, long long cap) {
  const long long per_row =
      4ll * B * (2ll * round4(D) + 3ll * round4(P) + 1);
  if ((long long)N * per_row <= cap) return N;
  const long long rows = cap / per_row / kTileM * kTileM;
  return (int)(rows < kTileM ? kTileM : (rows > N ? N : rows));
}

// The products' block shapes. Each moves its operands' terms from L2 for
// every block, and that traffic per multiply-add is what sets their pace,
// so the shapes follow it. Logits: 64 query rows x 128 keys (two
// warpgroups side by side). P V: 128 rows x 96 output columns in float32
// (two warpgroups one above the other sharing each V box: 8 (128 + 96)
// bytes per 128 x 96 multiply-adds a stage), 64 rows x 192 columns in
// bfloat16, whose V terms are half the bytes. Both give 128 blocks at
// 256^2, B = 1. Larger tiles would move less per multiply-add, but a
// 64 x 128 warpgroup tile needs 192 accumulator registers a thread, and a
// block of nine warps gets at most 168 (three of its warps share one SM
// quarter's register file), so it spills.
template <bool kF32> using LogitGemm = Gemm<kLogitCols, 1, kF32>;
template <bool kF32>
using OutGemm = Gemm<kOutCols, kF32 ? kOutRowGroups : 1, kF32>;

template <int kWN, int kMW, bool kSplitB, bool kLogits, typename TO>
int launch_gemm(int rows, int cols, int B, const CUtensorMap (&m)[4], int K,
                const Epi& e, cudaStream_t stream, int* per_sm = nullptr) {
  using G = Gemm<kWN, kMW, kSplitB>;
  const auto kernel =
      ca_fwd_wgmma_kernel<kWN, kMW, kSplitB, G::kStages, kLogits, TO>;
  static std::atomic<unsigned long long> opted{0};
  if (int err = opt_in_once(kernel, G::kSmem, opted)) return err;
  if (per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kWgThreads, G::kSmem);
  kernel<<<G::grid(rows, cols, B), kWgThreads, G::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], K, e);
  return (int)cudaGetLastError();
}

// The default (q, k, v) or shared (one tensor in all three) forward on
// `scratch`, laid out by layout() for chunks of `rows` query rows.
template <typename T, typename TO>
int launch_wgmma(const void* qp, const void* kp, const void* vp,
                 const float* keep, const float* kscale, TO* o, float* lse,
                 void* scratch, int B, int N, int P, int D, int rows,
                 float scale, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  if (rows <= 0 || rows > N) return (int)cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(qp);
  const T* k = static_cast<const T*>(kp);
  const T* v = static_cast<const T*>(vp);
  const Layout L = layout(kF32, B, P, D, rows);
  char* base = static_cast<char*>(scratch);
  const auto at = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  float *kh = at(L.kh), *vh = at(L.vh), *qh = at(L.qh), *ql = at(L.ql);
  float *kl = kF32 ? at(L.kl) : nullptr, *vl = kF32 ? at(L.vl) : nullptr;
  float *s = at(L.s), *ph = at(L.ph), *pl = at(L.pl), *il = at(L.il);
  if ((long long)B * P > 0x7fffffff || (long long)B * rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;

  ca_fwd_split_rows<T><<<B * P, 256, 0, stream>>>(k, nullptr, kh, kl, P, 0,
                                                  P, D);
  if (int err = (int)cudaGetLastError()) return err;
  ca_fwd_split_vt<T><<<dim3((L.Pp + 31) / 32, (D + 31) / 32, B), 256, 0,
                       stream>>>(v, vh, vl, P, D);
  if (int err = (int)cudaGetLastError()) return err;
  CUtensorMap ms[4], mo[4];
  using GS = LogitGemm<kF32>;
  using GO = OutGemm<kF32>;
  if (int err = make_map(&ms[2], kh, D, P, B, L.Dp, (long long)P * L.Dp,
                         GS::kBN))
    return err;
  if (int err = make_map(&ms[3], kF32 ? kl : kh, D, P, B, L.Dp,
                         (long long)P * L.Dp, GS::kBN))
    return err;
  if (int err = make_map(&mo[2], vh, P, D, B, L.Pp, (long long)D * L.Pp,
                         GO::kBN))
    return err;
  if (int err = make_map(&mo[3], kF32 ? vl : vh, P, D, B, L.Pp,
                         (long long)D * L.Pp, GO::kBN))
    return err;
  for (int r0 = 0; r0 < N; r0 += rows) {
    const int rc = rows < N - r0 ? rows : N - r0;
    ca_fwd_split_rows<T><<<B * rc, 256, 0, stream>>>(q, kscale, qh, ql, N,
                                                     r0, rc, D);
    if (int err = (int)cudaGetLastError()) return err;
    if (int err = make_map(&ms[0], qh, D, rc, B, L.Dp, (long long)rc * L.Dp,
                           GS::kBM))
      return err;
    if (int err = make_map(&ms[1], ql, D, rc, B, L.Dp, (long long)rc * L.Dp,
                           GS::kBM))
      return err;
    const Epi es{s, nullptr, keep, nullptr, scale, rc, P, L.Pp, N, r0};
    if (int err = launch_gemm<kLogitCols, 1, kF32, true, float>(
            rc, P, B, ms, D, es, stream))
      return err;
    ca_fwd_softmax<<<dim3((rc + 7) / 8, B), 256, 0, stream>>>(
        s, ph, pl, il, lse, rc, N, r0, P);
    if (int err = (int)cudaGetLastError()) return err;
    if (int err = make_map(&mo[0], ph, P, rc, B, L.Pp, (long long)rc * L.Pp,
                           GO::kBM))
      return err;
    if (int err = make_map(&mo[1], pl, P, rc, B, L.Pp, (long long)rc * L.Pp,
                           GO::kBM))
      return err;
    const Epi eo{nullptr, o, nullptr, il, 1.f, rc, D, D, N, r0};
    if (int err = launch_gemm<kOutCols, GO::kMW, kF32, false, TO>(
            rc, D, B, mo, P, eo, stream))
      return err;
  }
  return 0;
}

// The plan of launch_wgmma for these shapes and chunk rows, without a
// launch: plan[0] chunk rows, [1] chunks, [2] logits blocks (a full
// chunk's grid), [3] softmax blocks, [4] P V blocks, [5] and [6] the two
// products' dynamic shared memory per block, [7] and [8] their stages,
// [9] and [10] their resident blocks per SM, [11] threads a product block,
// [12] launches per call, [13] and [14] the logits block's rows and
// columns, [15] and [16] the P V block's.
template <typename T, typename TO>
int plan_wgmma(int B, int N, int P, int D, int rows, int* plan) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  using GS = LogitGemm<kF32>;
  using GO = OutGemm<kF32>;
  const CUtensorMap none[4] = {};
  const Epi e{};
  const auto blocks = [](dim3 g) { return (int)(g.x * g.y * g.z); };
  const int chunks = (N + rows - 1) / rows;
  plan[0] = rows;
  plan[1] = chunks;
  plan[2] = blocks(GS::grid(rows, P, B));
  plan[3] = ((rows + 7) / 8) * B;
  plan[4] = blocks(GO::grid(rows, D, B));
  plan[5] = (int)GS::kSmem;
  plan[6] = (int)GO::kSmem;
  plan[7] = GS::kStages;
  plan[8] = GO::kStages;
  if (int err = launch_gemm<kLogitCols, 1, kF32, true, float>(
          1, 1, 1, none, 0, e, nullptr, &plan[9]))
    return err;
  if (int err = launch_gemm<kOutCols, GO::kMW, kF32, false, TO>(
          1, 1, 1, none, 0, e, nullptr, &plan[10]))
    return err;
  plan[11] = kWgThreads;
  plan[12] = 2 + 4 * chunks;
  plan[13] = GS::kBM;
  plan[14] = GS::kBN;
  plan[15] = GO::kBM;
  plan[16] = GO::kBN;
  return 0;
}

struct Args {
  const void *q, *k, *v;
  const float *keep, *kscale;
  void* o;
  float* lse;
  int B, N, P, D;
  float scale;
  cudaStream_t stream;
  int* plan = nullptr;     // fill the launch plan, do not launch
  void* scratch = nullptr; // the wgmma forwards' scratch
  int rows = 0;            // and their query rows a chunk
};

// The D-split kernel with 16 kMT query rows a cluster; with a.plan, the
// launch plan instead.
template <typename T, typename TO, int kMT, bool kVec>
int launch_dsplit(const Args& a) {
  constexpr int rows = kMT * kRows;
  const size_t smem = dsplit_smem_bytes<T, kMT>(a.D);
  const auto kernel = ca_fwd_dsplit_kernel<T, TO, kMT, kVec>;
  if (int err = opt_in_smem(kernel, smem)) return err;
  const int slabs = (half_cut(a.D) + kHalfCols - 1) / kHalfCols;
  const dim3 grid((a.N + rows - 1) / rows, 2 * slabs, a.B);
  if (a.plan != nullptr) return cluster_plan(kernel, grid, smem, rows, a.plan);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, static_cast<TO*>(a.o),
      a.lse, a.N, a.P, a.D, a.scale);
  return (int)cudaGetLastError();
}

// variant: 0 the default forward, 1 shared (q and k are ignored: v is all
// three), both the wgmma sequence; 2 D-split. The D-split kernel takes
// 32-row clusters (two m16 tiles a block, sharing each K and V fragment)
// where they give every SM a block and fit (D <= 1536), else 16-row ones
// (at 256^2, B = 1: 61 clusters of 16 rows are 122 blocks; 32-row tiles
// save 12-25% from 256^2, B = 8 on: scripts/dsplit_variants.py). Its
// 16-byte loads need D a multiple of 4 and aligned pointers, else a build
// of the same body loads element by element.
template <typename T, typename TO>
int launch(int variant, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.P <= 0 || a.D <= 0 || a.B > 65535)
    return (int)cudaErrorInvalidValue;
  if (variant == 0 || variant == 1) {
    if (a.plan != nullptr)
      return plan_wgmma<T, TO>(a.B, a.N, a.P, a.D, a.rows, a.plan);
    const void* q = variant == 0 ? a.q : a.v;
    const void* k = variant == 0 ? a.k : a.v;
    return launch_wgmma<T, TO>(q, k, a.v, a.keep, a.kscale,
                               static_cast<TO*>(a.o), a.lse, a.scratch, a.B,
                               a.N, a.P, a.D, a.rows, a.scale, a.stream);
  }
  const auto blocks = [&](int tq) {
    return (long long)a.B * ((a.N + tq - 1) / tq);
  };
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a.D % 4 == 0 && aligned(a.q) && aligned(a.k) &&
                   aligned(a.v) && aligned(a.o) && aligned(a.kscale);
  if (variant == 2) {
    if (2 * blocks(2 * kRows) >= sm_count() &&
        dsplit_smem_bytes<T, 2>(a.D) <= kMaxSmem)
      return vec ? launch_dsplit<T, TO, 2, true>(a)
                 : launch_dsplit<T, TO, 2, false>(a);
    return vec ? launch_dsplit<T, TO, 1, true>(a)
               : launch_dsplit<T, TO, 1, false>(a);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_typed(int variant, int dtype, int out_dtype, const Args& a) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && out_dtype == 0) return launch<float, float>(variant, a);
  if (dtype == 1 && out_dtype == 1) return launch<bf16, bf16>(variant, a);
  if (dtype == 1 && out_dtype == 0) return launch<bf16, float>(variant, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype, out_dtype: 0 = float32, 1 = bfloat16. Q (B,N,D), K and V (B,P,D)
// contiguous in dtype; O (B,N,D) contiguous in out_dtype, which is dtype or
// float32; keep (B,P) float32; kscale (B,D) float32, a per-channel scale of
// the keys; lse (B,N) float32 or NULL; scratch of
// sketchedit_contextual_attention_fwd_scratch's bytes for these shapes and
// its `rows` query rows a chunk.
// Each returns the cudaError_t of its launches (0 on success).
int sketchedit_contextual_attention_fwd(int dtype, int out_dtype,
                                        const void* q, const void* k,
                                        const void* v, const void* keep,
                                        const void* kscale, void* o,
                                        void* lse, void* scratch, int B,
                                        int N, int P, int D, int rows,
                                        float scale, void* stream) {
  Args a{q, k, v, static_cast<const float*>(keep),
         static_cast<const float*>(kscale), o, static_cast<float*>(lse),
         B, N, P, D, scale, static_cast<cudaStream_t>(stream)};
  a.scratch = scratch;
  a.rows = rows;
  return launch_typed(0, dtype, out_dtype, a);
}

// The shared-tensor forward: V (B,N,D) is queries, keys (times kscale) and
// values; keep (B,N); the scratch as above with P = N.
int sketchedit_contextual_attention_fwd_shared(
    int dtype, int out_dtype, const void* v, const void* keep,
    const void* kscale, void* o, void* lse, void* scratch, int B, int N,
    int D, int rows, float scale, void* stream) {
  Args a{nullptr, nullptr, v, static_cast<const float*>(keep),
         static_cast<const float*>(kscale), o, static_cast<float*>(lse),
         B, N, N, D, scale, static_cast<cudaStream_t>(stream)};
  a.scratch = scratch;
  a.rows = rows;
  return launch_typed(1, dtype, out_dtype, a);
}

// Bytes of scratch the default and shared forwards need for these shapes
// when the part that grows with the query rows (their terms, the logits,
// P's terms) may take `cap` bytes; *rows gets the query rows a chunk.
// Returns -1 for shapes the forwards refuse.
long long sketchedit_contextual_attention_fwd_scratch(int dtype, int B, int N,
                                                      int P, int D,
                                                      long long cap,
                                                      int* rows) {
  if (B <= 0 || N <= 0 || P <= 0 || D <= 0 || cap <= 0 ||
      (dtype != 0 && dtype != 1))
    return -1;
  *rows = chunk_rows(B, N, P, D, cap);
  return (long long)layout(dtype == 0, B, P, D, *rows).total;
}

// The D-split kernel: the same arguments as the default forward, without
// the scratch.
int sketchedit_contextual_attention_fwd_dsplit(
    int dtype, int out_dtype, const void* q, const void* k, const void* v,
    const void* keep, const void* kscale, void* o, void* lse, int B, int N,
    int P, int D, float scale, void* stream) {
  return launch_typed(2, dtype, out_dtype,
                      {q, k, v, static_cast<const float*>(keep),
                       static_cast<const float*>(kscale), o,
                       static_cast<float*>(lse), B, N, P, D, scale,
                       static_cast<cudaStream_t>(stream)});
}

// The D-split kernel's launch plan for these shapes on the current device,
// without a launch: plan[0] tile rows, [1] blocks per cluster, [2] the most
// clusters resident at once (cudaOccupancyMaxActiveClusters), [3] dynamic
// shared-memory bytes per block, [4] clusters in the grid.
int sketchedit_contextual_attention_fwd_dsplit_plan(int dtype, int out_dtype,
                                                    int B, int N, int P,
                                                    int D, int* plan) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         B,       N,       P,       D,       0.f,     nullptr, plan};
  return launch_typed(2, dtype, out_dtype, a);
}

// The launch plan of the default (variant 0) or shared (1) forward for
// these shapes and `rows` query rows a chunk on the current device,
// without a launch: the 17 ints plan_wgmma fills.
int sketchedit_contextual_attention_fwd_plan(int variant, int dtype,
                                             int out_dtype, int rows, int B,
                                             int N, int P, int D, int* plan) {
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         B,       N,       P,       D,       0.f,     nullptr, plan};
  a.rows = rows;
  return launch_typed(variant, dtype, out_dtype, a);
}

const char* sketchedit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
