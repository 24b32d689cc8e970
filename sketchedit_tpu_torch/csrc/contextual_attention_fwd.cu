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
// over a cluster of two blocks: grid (q tiles, 2, B), __cluster_dims__(1, 2,
// 1), so a query tile's two blocks run on neighbouring SMs and can read each
// other's shared memory (sm_90). Block `half`, its rank in the cluster, owns
// columns [half * Dh, min(D, (half + 1) * Dh)), Dh = ceil(D/2) rounded up to
// 4 (the result does not depend on the cut). For each key tile it contracts
// only its columns of Q and K into a partial S (tile_dot's window), writes it
// to a slot in its own shared memory and, after one cluster barrier, reads
// the peer's slot through distributed shared memory. Both blocks form S =
// own + peer, which float addition makes bit-identical in the two, so their
// running max and sum agree and the two halves of the output are normalised
// alike. Each then streams its half of V into a (TQ, Dh) accumulator, so 32
// rows take the 96 KB that 16 rows take at full width. Every logit is
// computed once, as in ca_fwd_kernel; the TPU kernel computes S in both
// halves, since a TPU core cannot read another program's VMEM. What bounds it
// is its float32 tile products on the CUDA cores (tile_dot, accumulate),
// whose staged-chunk loop waits on its loads and barriers more than it
// multiplies (scripts/dsplit_variants.py's `clocks` reads the cycles of each
// phase); the exchange moves 8 KB a tile across the cluster at TQ = 32 and
// costs a few percent of a tile. The partial slots alternate by key tile: a
// block overwrites one only after the next tile's barrier, which its peer
// reaches only once it has read that slot, so one cluster barrier per tile
// suffices. A block with no columns (D <= Dh) still takes part in every
// barrier with a zero partial, and a last barrier keeps each block resident
// until its peer has read its final partial. Not yet done here: tensor cores
// and TMA loads. Only the first half writes lse. Inference only.

#include <cooperative_groups.h>

#include "contextual_attention_common.cuh"

namespace {

// Shared-memory bytes of a CUDA-core forward block (the D-split's): an
// accumulator of acc_cols columns, the staging areas for kDC-wide chunks, P transposed, alpha and l
// per row.
template <int TQ, int kDC = Tile<TQ>::kDC>
size_t smem_bytes(int acc_cols) {
  return sizeof(float) * ((size_t)TQ * acc_cols + stage_floats<TQ, kDC>() +
                          kT * TQ + 2 * TQ);
}

// Shared-memory layout of a CUDA-core forward block and the per-thread
// softmax state.
template <int TQ, int kDC = Tile<TQ>::kDC> struct FwdBlock {
  float* acc;      // [TQ][acc_cols]
  float* as;       // [TQ][kSD]
  float* bs;       // [kT][kSD]; S tile [TQ][kSS]
  float* ps;       // [kT][TQ]  (P transposed)
  float* alpha_s;  // [TQ]
  float* l_s;      // [TQ]
  float m_run = -INFINITY;
  float l_run = 0.f;

  __device__ FwdBlock(float* smem, int acc_cols) {
    acc = smem;
    as = acc + (size_t)TQ * acc_cols;
    bs = as + TQ * (kDC + 4);
    ps = bs + kT * (kDC + 4);
    alpha_s = ps + kT * TQ;
    l_s = alpha_s + TQ;
    for (int i = threadIdx.x; i < TQ * acc_cols; i += kThreads) acc[i] = 0.f;
  }

  // O rows = acc / l for the block's query rows, columns [c_lo, c_lo + ncols)
  // of a D-wide output; lse where the pointer is given. Each thread writes
  // the columns it accumulated.
  template <typename TO>
  __device__ void finish(TO* O, float* lse, int b, int q0, int N, int D,
                         int acc_cols, int c_lo, int ncols) {
    constexpr int TPR = kThreads / TQ;
    const int r = threadIdx.x / TPR;
    if (threadIdx.x % TPR == 0) {
      l_s[r] = l_run;
      if (lse != nullptr && q0 + r < N)
        lse[(size_t)b * N + q0 + r] = m_run + logf(l_run);
    }
    __syncthreads();
    for (int rr = 0; rr < TQ; ++rr) {
      const int q = q0 + rr;
      if (q >= N) break;
      const float inv_l = 1.f / l_s[rr];
      TO* orow = O + ((size_t)b * N + q) * D + c_lo;
      for (int c = threadIdx.x; c < ncols; c += kThreads)
        store(orow + c, acc[rr * acc_cols + c] * inv_l);
    }
  }
};

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// A warp's staging area, in elements of T: kKStages K steps of [kT keys][16
// columns], or kVStages V steps of [8 keys][kVLd] (192 columns and a pad of
// 32 bytes, so the four key rows a fragment load spans start 8 banks apart),
// or, between the two, the warp's partial S [kRows][kPartLd] floats. The
// copies a warp has in flight are what hides the latency of L2, so a
// bfloat16 area, half the bytes a step, takes twice the steps; float32 takes
// what fits beside the Q tile at D = 1536 (206 KB of 227).
template <typename T> struct Stage {
  static constexpr int kKStages = sizeof(T) == 4 ? 3 : 6;  // K steps
  static constexpr int kVStages = sizeof(T) == 4 ? 2 : 4;  // V steps
  static constexpr int kK = kT * 16;
  static constexpr int kVLd = kGroups * 32 + 32 / (int)sizeof(T);
  static constexpr int kV = 8 * kVLd;
  static constexpr size_t kBytes = cmax(
      cmax(kKStages * kK * sizeof(T), kVStages * kV * sizeof(T)),
      kRows * kPartLd * sizeof(float));
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

// Columns a D-split thread carries at once: a half of D = 1536 is 768 = 3
// columns a thread, one pass.
constexpr int kSplitNC = 3;

// The D-split's 32-row tile stages 128-wide D-chunks where Tile<32> has 32,
// and unrolls its accumulation 8 streamed rows deep where the rule gives 2:
// a quarter of the chunk steps per key tile (each costs two barriers and
// waits out what the previous step's arithmetic did not cover of the next
// chunk's loads) and four times the loads of V in flight. A 32-row block
// takes one SM alone, so no other block hides those latencies. scripts/
// dsplit_variants.py times each choice against the others.
template <int TQ> struct SplitTile {
  static constexpr int kDC = TQ == 32 ? 128 : Tile<TQ>::kDC;
  static constexpr int kUnroll =
      TQ == 32 ? 8 : accumulate_unroll<TQ, kSplitNC>();
};

// A D-split block's shared memory: a forward block with a (TQ, Dh)
// accumulator, then two partial-S slots [2][TQ][kT].
template <int TQ>
size_t dsplit_smem_bytes(int Dh) {
  return smem_bytes<TQ, SplitTile<TQ>::kDC>(Dh) +
         sizeof(float) * 2 * TQ * kT;
}

// One cluster of two blocks: TQ query rows of one image, all keys. The
// block of rank `half` contracts columns [c_lo, c_hi) of D for the partial
// S, swaps partials with its peer, and accumulates those columns of P V.
template <typename T, typename TO, int TQ>
__global__ void __cluster_dims__(1, 2, 1)
__launch_bounds__(kThreads, Tile<TQ>::kMinBlocks)
ca_fwd_dsplit_kernel(const T* Q, const T* K, const T* V, const float* keep,
                     const float* kscale, TO* O, float* lse, int N, int P,
                     int D, int Dh, float scale) {
  constexpr int RPT = TQ / 4;
  constexpr int kPart = TQ * kT;         // floats of one partial-S slot
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int half = blockIdx.y;           // == cluster.block_rank()
  const int c_lo = half * Dh;
  const int c_hi = min(D, c_lo + Dh);    // empty when D <= Dh (half 1)
  extern __shared__ __align__(16) float smem[];
  FwdBlock<TQ, SplitTile<TQ>::kDC> blk(smem, Dh);
  float* part = blk.l_s + TQ;            // [2][TQ][kT], by key-tile parity
  const float* peer = cluster.map_shared_rank(part, half ^ 1);
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * TQ;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const T* Vb = V + (size_t)b * P * D;
  const float* keep_b = keep + (size_t)b * P;
  const float* kscale_b = kscale + (size_t)b * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = (tid >> 5) >> 1;
  const int kg = (((tid >> 5) & 1) << 3) | (lane & 7);

  for (int k0 = 0, t = 0; k0 < P; k0 += kT, t ^= 1) {
    float s[RPT][kCPT];
    tile_dot<T, T, TQ, 1, SplitTile<TQ>::kDC>(Qb, q0, N, Kb, k0, P, kscale_b,
                                              D, c_lo, c_hi, blk.as, blk.bs,
                                              s);
    float* mine = part + t * kPart;
    if ((lane >> 3) == 0) {
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int c = 0; c < kCPT; ++c)
          mine[(rg * RPT + a) * kT + kg + 16 * c] = s[a][c];
    }
    // both partials of this tile are written, and this block is done
    // reading bs: S = own + peer goes there, the same bits in both blocks
    // since float addition commutes
    cluster.sync();
    const float4* own4 = reinterpret_cast<const float4*>(mine);
    const float4* peer4 = reinterpret_cast<const float4*>(peer + t * kPart);
    for (int i = tid; i < kPart / 4; i += kThreads) {
      const float4 x = own4[i], y = peer4[i];
      float* srow = blk.bs + (i / (kT / 4)) * kSS + 4 * (i % (kT / 4));
      srow[0] = x.x + y.x;
      srow[1] = x.y + y.y;
      srow[2] = x.z + y.z;
      srow[3] = x.w + y.w;
    }
    __syncthreads();
    softmax_tile<TQ>(blk.bs, keep_b, k0, P, scale, blk.m_run, blk.l_run,
                     blk.ps, blk.alpha_s);
    if (c_hi > c_lo)
      accumulate<T, TQ, kSplitNC, true, SplitTile<TQ>::kUnroll>(
          blk.acc, Dh, c_hi - c_lo, Vb + (size_t)k0 * D + c_lo, D,
          min(kT, P - k0), blk.ps, blk.alpha_s);
  }
  cluster.sync();  // the peer has read this block's last partial
  if (c_hi > c_lo)
    blk.finish(O, half == 0 ? lse : nullptr, b, q0, N, D, Dh, c_lo,
               c_hi - c_lo);
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

template <typename T, typename TO, int TQ>
int launch_dsplit(const Args& a) {
  const int Dh = half_cut(a.D);
  const size_t smem = dsplit_smem_bytes<TQ>(Dh);
  const auto kernel = ca_fwd_dsplit_kernel<T, TO, TQ>;
  if (int err = opt_in_smem(kernel, smem)) return err;
  const dim3 grid((a.N + TQ - 1) / TQ, 2, a.B);
  if (a.plan != nullptr) return cluster_plan(kernel, grid, smem, TQ, a.plan);
  ca_fwd_dsplit_kernel<T, TO, TQ><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, static_cast<TO*>(a.o),
      a.lse, a.N, a.P, a.D, Dh, a.scale);
  return (int)cudaGetLastError();
}

// variant: 0 the default kernel, 1 shared (q and k are ignored), 2 D-split.
// The split-TF32 kernels take 16-row tiles, or 8-row tiles when 16-row ones
// would leave SMs idle (at 256^2, B = 1: 61 blocks of 16 rows against 121 of
// 8 on 132 SMs); their 16-byte loads need D a multiple of 4 and aligned
// pointers, else a build of the same body loads element by element. The
// D-split kernel, whose blocks come in clusters of two, takes 32 rows where
// they give every SM a block, then 16 where they do. Below that its 8-row
// blocks run one per SM (their registers), so 8 rows pay only while all
// their clusters fit on the card at once; otherwise 16 rows, whose clusters
// do (at 256^2, B = 1: 61 clusters of 16 rows in one wave, not 121 of 8
// rows in two).
template <typename T, typename TO>
int launch(int variant, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.P <= 0 || a.D <= 0 || a.B > 65535)
    return (int)cudaErrorInvalidValue;
  const auto blocks = [&](int tq) {
    return (long long)a.B * ((a.N + tq - 1) / tq);
  };
  if (variant == 2) {
    if (2 * blocks(32) >= sm_count()) return launch_dsplit<T, TO, 32>(a);
    if (2 * blocks(16) >= sm_count() || 2 * blocks(8) > sm_count())
      return launch_dsplit<T, TO, 16>(a);
    return launch_dsplit<T, TO, 8>(a);
  }
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  const int rows = blocks(kRows) < sm_count() ? 8 : kRows;
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (a.D % 4 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v) &&
      aligned(a.o) && aligned(a.kscale))
    return launch_mma<T, TO, true>(variant, a, rows);
  return launch_mma<T, TO, false>(variant, a, rows);
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
