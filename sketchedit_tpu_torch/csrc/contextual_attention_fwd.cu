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
// SXM's 67 TFLOP/s of float32 against ~4 us of memory time. The D-split
// kernel computes S twice (8.5 GFLOP, ~127 us). In bfloat16 the tensor
// cores would make it ~6 us, which these first kernels do not try for.
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
// ca_fwd_dsplit_kernel splits the output's D axis over two blocks: grid
// (q tiles, 2, B). A block owns TQ query rows and one half of D of the
// output, so its accumulator is (TQ, D/2) and 32 rows take the 96 KB that
// 16 rows take at full width: the keys are re-read half as often per query
// row. It computes S over the full D for its rows (so S is computed twice
// per query tile) and streams only its half of V. The cut is at
// ceil(D/2) rounded up to 4 columns; the result does not depend on where
// it is. Only the first half writes lse. Inference only.

#include "contextual_attention_common.cuh"

namespace {

// Shared-memory bytes of a forward block: an accumulator of acc_cols
// columns, the staging areas, P transposed, alpha and l per row.
template <int TQ>
size_t smem_bytes(int acc_cols) {
  return sizeof(float) * ((size_t)TQ * acc_cols + stage_floats<TQ>() +
                          kT * TQ + 2 * TQ);
}

// Shared-memory layout of a forward block and the per-thread softmax state.
template <int TQ> struct FwdBlock {
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
    bs = as + TQ * Tile<TQ>::kSD;
    ps = bs + kT * Tile<TQ>::kSD;
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

// One block: TQ query rows of one image, all keys, S over all of D, and
// the half blockIdx.y of the output's columns: [half * Dh, min(D, ... + Dh)).
template <typename T, typename TO, int TQ>
__global__ void __launch_bounds__(kThreads, Tile<TQ>::kMinBlocks)
ca_fwd_dsplit_kernel(const T* Q, const T* K, const T* V, const float* keep,
                     const float* kscale, TO* O, float* lse, int N, int P,
                     int D, int Dh, float scale) {
  const int half = blockIdx.y;
  const int c_lo = half * Dh;
  const int ncols = min(Dh, D - c_lo);
  if (ncols <= 0) return;  // D <= Dh: the first half is the whole output
  extern __shared__ __align__(16) float smem[];
  FwdBlock<TQ> blk(smem, Dh);
  const int b = blockIdx.z;
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
    accumulate<T, TQ, kSplitNC, true>(
        blk.acc, Dh, ncols, Vb + (size_t)k0 * D + c_lo, D, min(kT, P - k0),
        blk.ps, blk.alpha_s);
  }
  blk.finish(O, half == 0 ? lse : nullptr, b, q0, N, D, Dh, c_lo, ncols);
}

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v;
  const float *keep, *kscale;
  void* o;
  float* lse;
  int B, N, P, D;
  float scale;
  cudaStream_t stream;
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
  const int Dh = ((a.D + 1) / 2 + 3) / 4 * 4;
  const size_t smem = smem_bytes<TQ>(Dh);
  if (int err = opt_in_smem(ca_fwd_dsplit_kernel<T, TO, TQ>, smem)) return err;
  const dim3 grid((a.N + TQ - 1) / TQ, 2, a.B);
  ca_fwd_dsplit_kernel<T, TO, TQ><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.keep, a.kscale, static_cast<TO*>(a.o),
      a.lse, a.N, a.P, a.D, Dh, a.scale);
  return (int)cudaGetLastError();
}

// variant: 0 the default kernel, 1 shared (q and k are ignored), 2 D-split.
// Full-width kernels take 16-row tiles, or 8-row tiles when 16-row ones
// would leave SMs idle (at 256^2, B = 1: 61 blocks of 16 rows against 121 of
// 8 on 132 SMs). The D-split kernel, whose blocks come in pairs, takes the
// tallest of 32, 16 and 8 rows that still gives every SM a block.
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
    if (2 * blocks(16) >= sm_count()) return launch_dsplit<T, TO, 16>(a);
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
