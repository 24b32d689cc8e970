// Contextual-attention forward for Hopper (sm_90a), CUDA C++: three kernels.
//
// ca_fwd_kernel replaces sketchedit_tpu/ops/attention_pallas.py::_attn_kernel
// (launched by _attention_core_raw), ca_fwd_shared_kernel replaces
// ::_attn_shared_kernel (_attention_core_shared_raw) and ca_fwd_dsplit_kernel
// replaces ::_attn_kernel_dsplit (_attention_core_dsplit_raw). For each
// batch b and query row i all three compute
//
//   logit_ij = keep_bj * scale * sum_d Q_bid K_bjd kscale_bd   (real j < P)
//   O_bi     = sum_j softmax_j(logit_i) V_bj,   lse_bi = logsumexp_j logit_ij
//
// kscale is a per-channel scale of the keys (the background's inverse L2
// norm on the main path, which passes K = V, so the keys are formed in
// float32 here and no rounded K tensor is ever made).
// A gated key (keep = 0) gets logit 0, not -inf: it still adds exp(0) to the
// denominator, so an all-gated row gives the uniform mean of V. Ragged N, P
// and D are handled by bounds checks inside the kernels, never by padded
// copies. Inputs are float32 or bfloat16, and O is written in the input type
// or, for bfloat16 inputs, in float32 when the caller asks. lse is float32.
//
// What bounds them on an H100. At 256^2, B = 1 (N = P = 961, D = 1536) the
// two products are 5.67 GFLOP against 11.8 MB of float32 traffic (V, read as
// Q, K and V, and the output), so the work is arithmetic: ~85 us at the
// SXM's 67 TFLOP/s on the CUDA cores, ~34 us as split TF32 on the tensor
// cores (three passes at 495 TFLOP/s) against ~4 us of memory time; all
// three kernels compute S and P V once.
//
// ca_fwd_kernel and ca_fwd_shared_kernel: split TF32 on the tensor cores.
// Both products run as mma.sync m16n8k8 TF32 tiles (mma_tile in
// contextual_attention_common.cuh), float32-accurate: an operand that holds
// float32 values is split into two TF32 terms, one that holds bfloat16 data
// enters whole, so a float32 product takes three passes and a product with
// one bfloat16 operand two. The keys stay float32 (K * kscale is formed in
// float32), as in every other kernel here. A block is 8 warps and takes
// kRows = 16 query rows (the mma's m16; 8 rows leave the lower half of each
// tile zero) of one image, all keys, and a slab of up to kSlab = 1536
// output columns (one slab at the model's D; a wider D takes more slabs,
// each computing the same S). Warp w owns 192 output columns: its O
// accumulator is 24 m16n8 fragments in registers (96 floats a thread), so
// the rescale by alpha happens in registers and no accumulator sits in
// shared memory. Per key tile of kT = 64:
//   S   each warp contracts its own 1/8 of D (Ds columns, 16 at a time) into
//       a partial 16 x 64 S: the block's Q tile (times kscale in the default
//       kernel) is staged once in shared memory; the warp stages its K
//       rows itself with cp.async, two (float32) or five (bfloat16)
//       16-column steps ahead, in its own area of shared memory, so it
//       waits only for its own copies (no block barrier, no registers held
//       by loads in flight); the shared kernel scales the keys by kscale in
//       float32 as it reads them;
//   sum the eight partials go to the warps' areas and, after one barrier,
//       warp w sums rows 2w and 2w + 1 in a fixed order (so two launches
//       give the same bits) and runs the online softmax for them (running
//       max and sum in registers), writing P and alpha to shared memory;
//   P V after a second barrier each warp rescales its fragments and adds
//       P V for its columns: P's A fragments from shared memory, V rows
//       staged by the warp with cp.async one (float32) or three
//       (bfloat16) 8-key steps ahead.
// The tensor cores add into a float32 accumulator with truncation (aligned
// to its largest term, rounding toward zero), which over the ~600 mma a
// fragment sees would bias sums whose terms share a sign; so every k8 step
// starts a fresh accumulator at zero and adds it into the running one with
// a round-to-nearest FADD. The contraction index of a fragment may be permuted
// freely, and the column index of B and C alike, so every thread reads 4
// consecutive elements of a row: in S, d = d0 + 4t .. 4t + 3 serve two k8
// steps; in P V, columns 4g .. 4g + 3 of a 32-column group serve four n8
// tiles, and the same permutation makes each thread's C values 8
// consecutive columns of a row at the end. Staged rows are padded so that no
// fragment load or partial store meets a bank conflict (Q rows: 16 mod 32
// floats; V rows 32 bytes; partial S rows 72 floats, P rows 68). Each block
// streams K and V once from L2. What holds it back is each block's own
// staging pipeline and the copy and address instructions per mma, not the
// L2 (scripts/fwd_variants.py: 61 blocks of 16 rows take as long as 121 of
// 8 at 256^2, B = 1; ~0.2 mma a cycle per SM). The staged Q tile and the
// warps' areas take 206 KB at D = 1536 (float32), so D is limited to about
// 1750. Not yet done here: TMA, wgmma, a split over keys to fill the SMs at
// B = 1.
//
// ca_fwd_shared_kernel is the released call site's kernel: foreground and
// background are one tensor, so it takes ONE pointer, V. The query rows are
// rows of V (staged unscaled), and the keys are V * kscale formed in float32
// as each K fragment arrives, as the TPU kernel forms them per tile in
// registers; device memory sees one tensor per image.
//
// ca_fwd_dsplit_kernel (attention_pallas.py:156, launched at :234) splits D
// over a cluster of two blocks: grid (q tiles, 2 x column slabs, B),
// __cluster_dims__(1, 2, 1), so a query tile's two blocks run on
// neighbouring SMs and can read each other's shared memory (sm_90). Block
// `half`, its rank in the cluster, owns columns [half * Dh, min(D, (half +
// 1) * Dh)) of D, Dh = ceil(D/2) rounded up to 4 (the result does not
// depend on the cut), for the contraction of S and for the output. It is
// fwd_mma's block on half of D: 8 warps over 16 query rows (the mma's m16,
// a full tile: at 256^2, B = 1, 61 clusters are 122 blocks on 132 SMs,
// where the default forward needs 8-row blocks) or, where 32-row clusters
// give every SM a block, 32 rows as two m16 tiles that share each K and V
// fragment; both products split TF32 through mma_tile, kscale on the
// staged query rows (50 KB of float32 a 16-row tile at D = 1536, where the
// default forward stages 98 KB), so raw bfloat16 keys enter whole. Per key
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
//       (fwd_mma's rule).
// Every logit is computed once (the TPU kernel computes S in both halves,
// since a TPU core cannot read another program's VMEM). A block overwrites
// a slot only after the next tile's barrier, which its peer reaches only
// once it has read that slot, so one cluster barrier per tile suffices. A
// block with no columns (D <= Dh) still takes part in every barrier with a
// zero partial, and a last barrier keeps each block resident until its
// peer has read its final sum. Only the first half writes lse. A half wider
// than 768 columns takes more column slabs (clusters along y), each
// recomputing S; the Q tile over half of D bounds D at 3584 (both input
// types; 32-row tiles fit to D = 1536). What holds it back is fwd_mma's
// limit, each warp's chain of fragment loads, splits, mma passes and FADDs:
// partial S and P V take 44% of a key tile each, the exchange 6%, at 0.21
// mma a cycle per SM with 16 rows; sharing the K and V fragments over two
// m16 tiles lifts that to 0.28 (scripts/dsplit_variants.py clocks).
// Inference only.

#include <cooperative_groups.h>

#include "contextual_attention_common.cuh"

namespace {

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// A warp's staging area, in elements of T: kKStages K steps of [kT keys][16
// columns], or kVStages V steps of [8 keys][kVLd] (the warp's kG 32-column
// groups and a pad of 32 bytes, so the four key rows a fragment load spans
// start 8 banks apart), or, between the two, the warp's partial S [kMT *
// kRows][kPartLd] floats for its kMT m16 tiles. The copies a warp has in
// flight are what hides the latency of L2, so a bfloat16 area, half the
// bytes a step, takes twice the steps; float32 takes what fits beside the
// Q tile at D = 1536 (206 KB of 227). The D-split's warps (kHalfGroups,
// one or two m16 tiles) take the same steps.
template <typename T, int kG = kGroups, int kMT = 1> struct Stage {
  static constexpr int kKStages = sizeof(T) == 4 ? 3 : 6;  // K steps
  static constexpr int kVStages = sizeof(T) == 4 ? 2 : 4;  // V steps
  static constexpr int kK = kT * 16;
  static constexpr int kVLd = kG * 32 + 32 / (int)sizeof(T);
  static constexpr int kV = 8 * kVLd;
  static constexpr size_t kBytes = cmax(
      cmax(kKStages * kK * sizeof(T), kVStages * kV * sizeof(T)),
      (size_t)kMT * kRows * kPartLd * sizeof(float));
};

// Shared-memory bytes of a split-TF32 block: the Q tile, the warps' staging
// areas, P, alpha and l per row.
template <typename T> size_t mma_smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * mma_q_ld(D) + kRows * kPLd +
                          2 * kRows) + kWarps * Stage<T>::kBytes;
}

// One block of the split-TF32 forward: rows [q0, q0 + rows) of image b
// (rows is 16, or 8 with the lower half of every A tile zero), all keys,
// output columns [blockIdx.y * kSlab, + kSlab). Qb, Kb, Vb, keep_b and ks_b
// point at image b; kScaled says where kscale goes: on the staged query rows
// (1, the default kernel) or on the keys as they arrive (2, the shared one).
template <typename T, typename TO, int kScaled, bool kVec>
__device__ __forceinline__ void fwd_mma(const T* Qb, const T* Kb,
                                        const T* Vb, const float* keep_b,
                                        const float* ks_b, TO* Ob,
                                        float* lse_b, int rows, int N, int P,
                                        int D, float scale) {
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  constexpr bool kSplitQ = kF32 || kScaled == 1;  // A of S holds float32
  constexpr bool kSplitK = kF32 || kScaled == 2;  // B of S holds float32
  using St = Stage<T>;
  extern __shared__ __align__(16) float smem[];
  const int Ds = mma_cols(D), ldq = mma_q_ld(D), qcols = kWarps * Ds;
  float* qs = smem;                              // [kRows][ldq]
  char* stages = reinterpret_cast<char*>(qs + kRows * ldq);
  float* ps = reinterpret_cast<float*>(stages + kWarps * St::kBytes);
  float* alpha_s = ps + kRows * kPLd;            // [kRows]
  float* l_s = alpha_s + kRows;                  // [kRows]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * rows;
  char* mine = stages + w * St::kBytes;          // this warp's staging area
  T* kst = reinterpret_cast<T*>(mine);           // [kKStages][kT][16]
  T* vst = reinterpret_cast<T*>(mine);           // [kVStages][8][kVLd]
  float* part = reinterpret_cast<float*>(mine);  // [kRows][kPartLd]

  // the Q tile in float32 (times kscale in the default kernel); rows past
  // the tile or N and columns past D are 0
  for (int i = tid; i < kRows * qcols; i += kThreads) {
    const int r = i / qcols, d = i % qcols;
    float x = 0.f;
    if (r < rows && q0 + r < N && d < D) {
      x = to_f(Qb[(size_t)(q0 + r) * D + d]);
      if constexpr (kScaled == 1) x *= ks_b[d];
    }
    qs[r * ldq + d] = x;
  }
  for (int i = tid; i < kRows * kPLd; i += kThreads) ps[i] = 0.f;
  if (tid < 2 * kRows) alpha_s[tid] = 1.f;       // and l_s
  __syncthreads();

  float acc[kGroups][4][4];
#pragma unroll
  for (int c = 0; c < kGroups; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  // softmax rows: warp w owns rows 2w and 2w + 1, 16 lanes a row, 4 keys a
  // lane; m_run and l_run are the row's running max and sum
  const int srow = 2 * w + (lane >> 4), skey = 4 * (lane & 15);
  float m_run = -INFINITY, l_run = 0.f;
  const int d_lo = w * Ds, d_hi = min(D, d_lo + Ds);
  const int nstep = d_hi > d_lo ? (d_hi - d_lo + 15) / 16 : 0;
  const int cw = blockIdx.y * kSlab + w * (kGroups * 32);  // warp's columns

  for (int k0 = 0; k0 < P; k0 += kT) {
    // 1. this warp's partial S over columns [d_lo, d_hi) of D, 16 at a
    // time: step i stages K rows k0 .. k0 + 63, columns d_lo + 16i .. + 15,
    // kKStages - 1 steps ahead. Lane (g, t) reads row 8j + g, columns 4t ..
    // 4t + 3 for n8 tile j: k = t and t + 4 of k8 step h are 4t + 2h and
    // + 1, and Q's A fragments follow the same order.
    auto stage_k = [&](int i) {
      if (i < nstep) {
        T* dst = kst + (i % St::kKStages) * St::kK;
        const int d0 = d_lo + 16 * i;
        const T* krow = Kb + (size_t)(k0 + (lane >> 2)) * D;
#pragma unroll (kVec ? kT * 4 / 32 : 1)
        for (int n = 0; n < kT * 4 / 32; ++n) {
          const int r = (lane >> 2) + 8 * n, q = (lane & 3) * 4;
          copy4<kVec>(dst + r * 16 + q, krow + (size_t)(8 * n) * D,
                      k0 + r < P, d0 + q, D);
        }
      }
      cp_commit();
    };
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < St::kKStages - 1; ++i) stage_k(i);
#pragma unroll 1
    for (int i = 0; i < nstep; ++i) {
      stage_k(i + St::kKStages - 1);
      cp_wait<St::kKStages - 1>();
      __syncwarp();                    // step i is staged, by every lane
      const T* kb = kst + (i % St::kKStages) * St::kK;
      const int d = d_lo + 16 * i + 4 * t;
      const float4 qa = lds4(qs + g * ldq + d);
      const float4 qb = lds4(qs + (g + 8) * ldq + d);
      float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (kScaled == 2) sc = ldg4<kVec>(ks_b, d, D);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        to_tf32<kSplitQ>(elem(qa, 2 * h), ah[h][0], al[h][0]);
        to_tf32<kSplitQ>(elem(qb, 2 * h), ah[h][1], al[h][1]);
        to_tf32<kSplitQ>(elem(qa, 2 * h + 1), ah[h][2], al[h][2]);
        to_tf32<kSplitQ>(elem(qb, 2 * h + 1), ah[h][3], al[h][3]);
      }
      // two n8 tiles at a time, both k8 steps: four independent mma tiles
#pragma unroll
      for (int jp = 0; jp < 8; jp += 2) {
        fence();
        uint32_t bh[4][2], bl[4][2];
        float x[4][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float4 kf = lds4(kb + (8 * (jp + jj) + g) * 16 + 4 * t);
          if constexpr (kScaled == 2) {
            kf.x *= sc.x; kf.y *= sc.y; kf.z *= sc.z; kf.w *= sc.w;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = 2 * jj + h;
            to_tf32<kSplitK>(elem(kf, 2 * h), bh[n][0], bl[n][0]);
            to_tf32<kSplitK>(elem(kf, 2 * h + 1), bh[n][1], bl[n][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
          }
        }
        mma_tile<kSplitQ, kSplitK, 4, 2>(x, ah, al, bh, bl);  // tile 2jj + h
#pragma unroll
        for (int n = 0; n < 4; ++n) add_into(s[jp + n / 2], x[n]);
      }
      __syncwarp();                    // every lane is done with step i
    }
    cp_wait<0>();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(part + g * kPartLd + 8 * j + 2 * t) =
          make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(part + (g + 8) * kPartLd + 8 * j + 2 * t) =
          make_float2(s[j][2], s[j][3]);
    }
    __syncthreads();  // every partial is written

    // 2. S = the eight partials, summed in warp order; the online softmax.
    // A gated key gets logit 0, a padded key (j >= P) -inf; a tile holds at
    // least one real key, so the running max is finite.
    if (srow < rows) {
      float4 x = lds4(reinterpret_cast<const float*>(stages) +
                      srow * kPartLd + skey);
#pragma unroll
      for (int u = 1; u < kWarps; ++u) {
        const float4 y = lds4(
            reinterpret_cast<const float*>(stages + u * St::kBytes) +
            srow * kPartLd + skey);
        x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
      }
      float logit[4];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + skey + e;
        logit[e] = j < P ? elem(x, e) * keep_b[j] * scale : -INFINITY;
        mx = fmaxf(mx, logit[e]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      float p[4], psum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(logit[e] - m_new);
        psum += p[e];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run = l_run * alpha + psum;
      m_run = m_new;
      *reinterpret_cast<float4*>(ps + srow * kPLd + skey) =
          make_float4(p[0], p[1], p[2], p[3]);
      if ((lane & 15) == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();  // P and alpha are written; the partials are read

    // 3. acc = acc * alpha + P V over this warp's columns, 8 keys a step:
    // step i stages V rows k0 + 8i .. + 7 at the warp's 192 columns, one
    // step ahead. Group c's rows t and t + 4 at columns 32c + 4g .. + 3 give
    // the B fragments of its four n8 tiles (tile e's column n is 32c + 4n
    // + e).
    const float alo = alpha_s[g], ahi = alpha_s[g + 8];
#pragma unroll
    for (int c = 0; c < kGroups; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[c][j][0] *= alo; acc[c][j][1] *= alo;
        acc[c][j][2] *= ahi; acc[c][j][3] *= ahi;
      }
    auto stage_v = [&](int i) {
      if (i < kT / 8) {
        T* dst = vst + (i % St::kVStages) * St::kV;
        const T* vrow = Vb + (size_t)(k0 + 8 * i) * D;
        // a row's 48 four-element chunks: lanes 0-31, then lanes 0-15
#pragma unroll (kVec ? 8 : 1)
        for (int r = 0; r < 8; ++r) {
          const bool ok = k0 + 8 * i + r < P;
          const int q = 4 * lane;
          copy4<kVec>(dst + r * St::kVLd + q, vrow + (size_t)r * D, ok,
                      cw + q, D);
          if (lane < kGroups * 8 - 32)
            copy4<kVec>(dst + r * St::kVLd + 128 + q, vrow + (size_t)r * D,
                        ok, cw + 128 + q, D);
        }
      }
      cp_commit();
    };
#pragma unroll
    for (int i = 0; i < St::kVStages - 1; ++i) stage_v(i);
#pragma unroll 1
    for (int i = 0; i < kT / 8; ++i) {
      stage_v(i + St::kVStages - 1);
      cp_wait<St::kVStages - 1>();
      __syncwarp();                    // step i is staged, by every lane
      uint32_t ah[1][4], al[1][4];
      to_tf32<true>(ps[g * kPLd + 8 * i + t], ah[0][0], al[0][0]);
      to_tf32<true>(ps[(g + 8) * kPLd + 8 * i + t], ah[0][1], al[0][1]);
      to_tf32<true>(ps[g * kPLd + 8 * i + t + 4], ah[0][2], al[0][2]);
      to_tf32<true>(ps[(g + 8) * kPLd + 8 * i + t + 4], ah[0][3], al[0][3]);
      const T* vb = vst + (i % St::kVStages) * St::kV;
      // one 32-column group at a time: its four n8 tiles
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        fence();
        const float4 va = lds4(vb + t * St::kVLd + 32 * c + 4 * g);
        const float4 vb4 = lds4(vb + (t + 4) * St::kVLd + 32 * c + 4 * g);
        uint32_t bh[4][2], bl[4][2];
        float x[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          to_tf32<kF32>(elem(va, e), bh[e][0], bl[e][0]);
          to_tf32<kF32>(elem(vb4, e), bh[e][1], bl[e][1]);
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

  // O = acc / l; lse from the first slab
  if (srow < rows && (lane & 15) == 0) {
    l_s[srow] = l_run;
    if (lse_b != nullptr && blockIdx.y == 0 && q0 + srow < N)
      lse_b[q0 + srow] = m_run + logf(l_run);
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    if (r >= rows || q0 + r >= N) continue;
    const float inv_l = 1.f / l_s[r];
    TO* orow = Ob + (size_t)(q0 + r) * D;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      const int col = cw + 32 * c + 8 * t;  // tile e, n = 2t (+1): col + e (+4)
      store4<kVec>(orow, col, D,
                   make_float4(acc[c][0][2 * half] * inv_l,
                               acc[c][1][2 * half] * inv_l,
                               acc[c][2][2 * half] * inv_l,
                               acc[c][3][2 * half] * inv_l));
      store4<kVec>(orow, col + 4, D,
                   make_float4(acc[c][0][2 * half + 1] * inv_l,
                               acc[c][1][2 * half + 1] * inv_l,
                               acc[c][2][2 * half + 1] * inv_l,
                               acc[c][3][2 * half + 1] * inv_l));
    }
  }
}

// Grid (query tiles, column slabs, B).
template <typename T, typename TO, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ca_fwd_kernel(const T* Q, const T* K, const T* V, const float* keep,
              const float* kscale, TO* O, float* lse, int rows, int N, int P,
              int D, float scale) {
  const int b = blockIdx.z;
  fwd_mma<T, TO, 1, kVec>(Q + (size_t)b * N * D, K + (size_t)b * P * D,
                          V + (size_t)b * P * D, keep + (size_t)b * P,
                          kscale + (size_t)b * D, O + (size_t)b * N * D,
                          lse == nullptr ? nullptr : lse + (size_t)b * N, rows,
                          N, P, D, scale);
}

// One pointer feeds every operand: rows of V are queries, keys (times
// kscale) and values.
template <typename T, typename TO, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
ca_fwd_shared_kernel(const T* V, const float* keep, const float* kscale,
                     TO* O, float* lse, int rows, int N, int D, float scale) {
  const int b = blockIdx.z;
  const T* Vb = V + (size_t)b * N * D;
  fwd_mma<T, TO, 2, kVec>(Vb, Vb, Vb, keep + (size_t)b * N,
                          kscale + (size_t)b * D, O + (size_t)b * N * D,
                          lse == nullptr ? nullptr : lse + (size_t)b * N, rows,
                          N, N, D, scale);
}

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
    // kKStages - 1 steps ahead (fwd_mma's order: lane (g, t) reads columns
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

struct Args {
  const void *q, *k, *v;
  const float *keep, *kscale;
  void* o;
  float* lse;
  int B, N, P, D;
  float scale;
  cudaStream_t stream;
  int* plan = nullptr;  // fill the launch plan, do not launch
};

// variant 0 (ca_fwd_kernel) or 1 (ca_fwd_shared_kernel; q and k are
// ignored), `rows` query rows a block.
template <typename T, typename TO, bool kVec>
int launch_mma(int variant, const Args& a, int rows) {
  const size_t smem = mma_smem_bytes<T>(a.D);
  const dim3 grid((a.N + rows - 1) / rows, (a.D + kSlab - 1) / kSlab, a.B);
  const T* v = static_cast<const T*>(a.v);
  TO* o = static_cast<TO*>(a.o);
  if (variant == 0) {
    const auto kernel = ca_fwd_kernel<T, TO, kVec>;
    if (int err = opt_in_smem(kernel, smem)) return err;
    if (a.plan != nullptr) return block_plan(kernel, grid, smem, rows, a.plan);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), v, a.keep,
        a.kscale, o, a.lse, rows, a.N, a.P, a.D, a.scale);
  } else {
    const auto kernel = ca_fwd_shared_kernel<T, TO, kVec>;
    if (int err = opt_in_smem(kernel, smem)) return err;
    if (a.plan != nullptr) return block_plan(kernel, grid, smem, rows, a.plan);
    kernel<<<grid, kThreads, smem, a.stream>>>(v, a.keep, a.kscale, o, a.lse,
                                               rows, a.N, a.D, a.scale);
  }
  return (int)cudaGetLastError();
}

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

// variant: 0 the default kernel, 1 shared (q and k are ignored), 2 D-split.
// The default and shared kernels take 16-row tiles, or 8-row tiles when
// 16-row ones would leave SMs idle (at 256^2, B = 1: 61 blocks of 16 rows
// against 121 of 8 on 132 SMs). The D-split kernel takes 32-row clusters
// (two m16 tiles a block, sharing each K and V fragment) where they give
// every SM a block and fit (D <= 1536), else 16-row ones: half of D per
// block gives twice the blocks, so a full m16 tile fills the card where the
// default kernel needs 8 rows (at 256^2, B = 1: 61 clusters of 16 rows are
// 122 blocks; 8 rows, two waves, take 1.8x as long, and 32-row tiles save
// 12-25% from 256^2, B = 8 on: scripts/dsplit_variants.py). The 16-byte
// loads of every kernel need D a multiple of 4 and aligned pointers, else a
// build of the same body loads element by element.
template <typename T, typename TO>
int launch(int variant, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.P <= 0 || a.D <= 0 || a.B > 65535)
    return (int)cudaErrorInvalidValue;
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
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  const int rows = blocks(kRows) < sm_count() ? 8 : kRows;
  return vec ? launch_mma<T, TO, true>(variant, a, rows)
             : launch_mma<T, TO, false>(variant, a, rows);
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
// the keys; lse (B,N) float32 or NULL.
// Each returns the cudaError_t of its launch (0 on success).
int sketchedit_contextual_attention_fwd(int dtype, int out_dtype,
                                        const void* q, const void* k,
                                        const void* v, const void* keep,
                                        const void* kscale, void* o,
                                        void* lse, int B, int N, int P, int D,
                                        float scale, void* stream) {
  return launch_typed(0, dtype, out_dtype,
                      {q, k, v, static_cast<const float*>(keep),
                       static_cast<const float*>(kscale), o,
                       static_cast<float*>(lse), B, N, P, D, scale,
                       static_cast<cudaStream_t>(stream)});
}

// The D-split kernel: the same arguments and result.
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

// The launch plan of the default (variant 0) or shared (1) kernel for these
// shapes on the current device, without a launch: plan[0] query rows per
// block, [1] column slabs, [2] the most blocks resident at once on an SM,
// [3] dynamic shared-memory bytes per block, [4] blocks in the grid.
int sketchedit_contextual_attention_fwd_plan(int variant, int dtype,
                                             int out_dtype, int B, int N,
                                             int P, int D, int* plan) {
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
         B,       N,       P,       D,       0.f,     nullptr, plan};
  return launch_typed(variant, dtype, out_dtype, a);
}

// The shared-tensor kernel: V (B,N,D) is queries, keys (times kscale) and
// values; keep (B,N).
int sketchedit_contextual_attention_fwd_shared(
    int dtype, int out_dtype, const void* v, const void* keep,
    const void* kscale, void* o, void* lse, int B, int N, int D, float scale,
    void* stream) {
  return launch_typed(1, dtype, out_dtype,
                      {nullptr, nullptr, v, static_cast<const float*>(keep),
                       static_cast<const float*>(kscale), o,
                       static_cast<float*>(lse), B, N, N, D, scale,
                       static_cast<cudaStream_t>(stream)});
}

const char* sketchedit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
