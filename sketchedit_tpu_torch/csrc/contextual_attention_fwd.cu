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
// copies. Inputs are float32 or bfloat16; all arithmetic is float32 on the
// CUDA cores (no TF32, no tensor cores), and O is written in the input type
// or, for bfloat16 inputs, in float32 when the caller asks.
//
// What bounds them on an H100. At 256^2, B = 1 (N = P = 961, D = 1536) the
// two products are 5.67 GFLOP against 11.8 MB of float32 traffic (V, read as
// Q, K and V, and the output), so the work is arithmetic: ~85 us at the
// SXM's 67 TFLOP/s of float32 against ~4 us of memory time; all three
// kernels compute S and P V once. In bfloat16 the tensor cores would make
// it ~6 us, which these kernels do not try for yet.
//
// Design (ca_fwd_kernel). The TPU kernel keeps a (TQ, 1536) float32
// accumulator in VMEM. On Hopper 64 such rows (384 KB) exceed the 227 KB of
// shared memory a block may use, so each block takes a small tile of TQ = 16
// query rows (8 when 16-row tiles would leave SMs idle, as at 256^2 with
// B = 1) and keeps their full-width float32 accumulator in dynamic shared
// memory (96 KB at D = 1536 and TQ = 16). It walks the keys in tiles of
// kT = 64. S = Q K^T for a tile is built from kDC-wide D-chunks of Q and K
// staged in shared memory (tile_dot; kscale goes on the staged Q chunk, the
// smaller of the two). The online softmax (running max and sum per row, in
// registers) turns S into P, and acc = acc * alpha + P V streams V straight
// from global memory. S is never recomputed. Every block re-reads K and V
// once; one image's K and V (11.8 MB in float32) stay in the 50 MB L2. Two
// 16-row blocks fit on an SM (~112 KB of shared memory each).
//
// ca_fwd_shared_kernel is the released call site's kernel: foreground and
// background are one tensor, so it takes ONE pointer, V. The query tile is
// rows of V, and the keys of a tile are V * kscale, formed in float32 on the
// staged chunk (as the TPU kernel forms them per tile in registers). A
// 64-key tile of V at full D is 384 KB in float32 and cannot sit in shared
// memory beside the accumulator, so of the two ways to feed both products
// from one stream this kernel takes the second: S first, from D-chunks of
// the tile staged in shared memory; then P V from the same rows of the same
// pointer, which the block touched microseconds earlier and so finds in L2
// (or L1). What a block reads per key tile: the tile's rows twice (once
// staged, once streamed), its own TQ query rows once per tile, all through
// the one pointer; device memory sees one tensor per image.
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
// is what bounds the other two: the float32 tile products on the CUDA cores,
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

// Shared-memory bytes of a forward block: an accumulator of acc_cols
// columns, the staging areas for kDC-wide chunks, P transposed, alpha and l
// per row.
template <int TQ, int kDC = Tile<TQ>::kDC>
size_t smem_bytes(int acc_cols) {
  return sizeof(float) * ((size_t)TQ * acc_cols + stage_floats<TQ, kDC>() +
                          kT * TQ + 2 * TQ);
}

// Shared-memory layout of a forward block and the per-thread softmax state.
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

// One block: TQ query rows of one image, all keys, all of D.
template <typename T, typename TO, int TQ>
__global__ void __launch_bounds__(kThreads, Tile<TQ>::kMinBlocks)
ca_fwd_kernel(const T* Q, const T* K, const T* V, const float* keep,
              const float* kscale, TO* O, float* lse, int N, int P, int D,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  FwdBlock<TQ> blk(smem, D);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const T* Qb = Q + (size_t)b * N * D;
  const T* Kb = K + (size_t)b * P * D;
  const T* Vb = V + (size_t)b * P * D;
  const float* keep_b = keep + (size_t)b * P;
  const float* kscale_b = kscale + (size_t)b * D;

  for (int k0 = 0; k0 < P; k0 += kT) {
    s_tile<T, TQ, 1>(Qb, q0, N, Kb, k0, P, kscale_b, D, blk.as, blk.bs);
    softmax_tile<TQ>(blk.bs, keep_b, k0, P, scale, blk.m_run, blk.l_run,
                     blk.ps, blk.alpha_s);
    accumulate<T, TQ, Tile<TQ>::kNC, true>(
        blk.acc, D, D, Vb + (size_t)k0 * D, D, min(kT, P - k0), blk.ps,
        blk.alpha_s);
  }
  blk.finish(O, lse, b, q0, N, D, D, 0, D);
}

// One block: TQ rows of one image's V as queries, all rows of V as keys
// (times kscale) and values, all of D. One pointer feeds every operand.
template <typename T, typename TO, int TQ>
__global__ void __launch_bounds__(kThreads, Tile<TQ>::kMinBlocks)
ca_fwd_shared_kernel(const T* V, const float* keep, const float* kscale,
                     TO* O, float* lse, int N, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  FwdBlock<TQ> blk(smem, D);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const T* Vb = V + (size_t)b * N * D;
  const float* keep_b = keep + (size_t)b * N;
  const float* kscale_b = kscale + (size_t)b * D;

  for (int k0 = 0; k0 < N; k0 += kT) {
    // keys = V * kscale, in float32, on the staged chunk of the key tile
    s_tile<T, TQ, 2>(Vb, q0, N, Vb, k0, N, kscale_b, D, blk.as, blk.bs);
    softmax_tile<TQ>(blk.bs, keep_b, k0, N, scale, blk.m_run, blk.l_run,
                     blk.ps, blk.alpha_s);
    // the same rows again, as values: found in cache, not in device memory
    accumulate<T, TQ, Tile<TQ>::kNC, true>(
        blk.acc, D, D, Vb + (size_t)k0 * D, D, min(kT, N - k0), blk.ps,
        blk.alpha_s);
  }
  blk.finish(O, lse, b, q0, N, D, D, 0, D);
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
  int* plan = nullptr;  // D-split only: fill the launch plan, do not launch
};

template <typename T, typename TO, int TQ>
int launch_fwd(const Args& a) {
  const size_t smem = smem_bytes<TQ>(a.D);
  if (int err = opt_in_smem(ca_fwd_kernel<T, TO, TQ>, smem)) return err;
  const dim3 grid((a.N + TQ - 1) / TQ, a.B);
  ca_fwd_kernel<T, TO, TQ><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, static_cast<TO*>(a.o),
      a.lse, a.N, a.P, a.D, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TO, int TQ>
int launch_shared(const Args& a) {
  const size_t smem = smem_bytes<TQ>(a.D);
  if (int err = opt_in_smem(ca_fwd_shared_kernel<T, TO, TQ>, smem)) return err;
  const dim3 grid((a.N + TQ - 1) / TQ, a.B);
  ca_fwd_shared_kernel<T, TO, TQ><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.v), a.keep, a.kscale, static_cast<TO*>(a.o),
      a.lse, a.N, a.D, a.scale);
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
// Full-width kernels take 16-row tiles, or 8-row tiles when 16-row ones
// would leave SMs idle (at 256^2, B = 1: 61 blocks of 16 rows against 121 of
// 8 on 132 SMs). The D-split kernel, whose blocks come in clusters of two,
// takes 32 rows where they give every SM a block, then 16 where they do.
// Below that its 8-row blocks run one per SM (their registers), so 8 rows
// pay only while all their clusters fit on the card at once; otherwise 16
// rows, whose clusters do (at 256^2, B = 1: 61 clusters of 16 rows in one
// wave, not 121 of 8 rows in two).
template <typename T, typename TO>
int launch(int variant, const Args& a) {
  if (a.B <= 0 || a.N <= 0 || a.P <= 0 || a.D <= 0)
    return (int)cudaErrorInvalidValue;
  const auto blocks = [&](int tq) {
    return (long long)a.B * ((a.N + tq - 1) / tq);
  };
  if (variant == 2) {
    if (a.B > 65535) return (int)cudaErrorInvalidValue;
    if (2 * blocks(32) >= sm_count()) return launch_dsplit<T, TO, 32>(a);
    if (2 * blocks(16) >= sm_count() || 2 * blocks(8) > sm_count())
      return launch_dsplit<T, TO, 16>(a);
    return launch_dsplit<T, TO, 8>(a);
  }
  const bool small = blocks(16) < sm_count();
  if (variant == 1)
    return small ? launch_shared<T, TO, 8>(a) : launch_shared<T, TO, 16>(a);
  if (variant == 0)
    return small ? launch_fwd<T, TO, 8>(a) : launch_fwd<T, TO, 16>(a);
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
