// Device code shared by the contextual-attention kernels for Hopper
// (contextual_attention_fwd.cu and contextual_attention_bwd.cu): the
// float32-accurate tensor-core product (split TF32 on mma.sync) that the
// D-split forward is built on, with its block shape, per-warp cp.async
// staging and launch plan: kThreads = 256 threads a block, its streamed
// axis in tiles of kT = 64. (The default and shared forwards and the
// backward sequences run wgmma instead: contextual_attention_wgmma.cuh.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;                  // streamed rows per tile
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// Split TF32 on the tensor cores. mma.sync's TF32 operands are float32
// registers whose low 13 mantissa bits the hardware ignores (it drops them,
// it does not round), so an operand is rounded first: hi = rna(x) keeps 10
// mantissa bits, lo = rna(x - hi) the next 11, and x = hi + lo to within
// 2^-22 |x|. A product of two float32 operands is then three passes,
// a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo is below float32's last
// bit), accumulated in float32: about 22 bits, where one pass keeps 11. A
// bfloat16 value (8 exponent bits, 7 mantissa bits) is exact in TF32, so an
// operand that holds one enters whole and its product takes two passes.
//
// x as a TF32 operand: (hi, lo) when kSplit, else x whole (exact in TF32).
// The rounding is done on the bits: hi = x plus half an ulp of TF32 with the
// low 13 bits cleared, lo = (x - hi) plus half an ulp with its low bits left
// for the mma to drop. Both are cvt.rna.tf32.f32's roundings (to nearest,
// ties away from zero) for every x but a NaN (one with a small payload may
// come out as inf; a NaN input gives a non-finite result either way), in
// four instructions where cvt.rna, which the compiler expands with a check
// for inf and NaN, takes seven.
template <bool kSplit>
__device__ __forceinline__ void to_tf32(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kSplit) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
  } else {
    hi = __float_as_uint(x);
    lo = 0;
  }
}

// c += a b for one m16n8k8 tile: a row-major 16 x 8, b column-major 8 x 8,
// c 16 x 8 in float32. Fragments (g = lane / 4, t = lane % 4): a = {(g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4)}, b = {(t, g), (t + 4, g)}, c =
// {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}. Volatile, so the
// mma run in the order written: the compiler does not interleave
// more independent tiles than the caller does, each holding its own
// operands in registers.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma_tile: c[n] += a[n % kA] b[n] to float32 accuracy for kN independent
// tiles (kA A fragments, shared round-robin), from operands made by
// to_tf32: pass by pass (the small split terms first), each pass over the
// kN tiles, so consecutive mma are independent and the next pass finds the
// previous one done. A pass is left out where its operand is whole.
template <bool kSplitA, bool kSplitB, int kN, int kA>
__device__ __forceinline__ void mma_tile(float (&c)[kN][4],
                                         const uint32_t (&ah)[kA][4],
                                         const uint32_t (&al)[kA][4],
                                         const uint32_t (&bh)[kN][2],
                                         const uint32_t (&bl)[kN][2]) {
  if constexpr (kSplitA) {
#pragma unroll
    for (int n = 0; n < kN; ++n) mma_tf32(c[n], al[n % kA], bh[n]);
  }
  if constexpr (kSplitB) {
#pragma unroll
    for (int n = 0; n < kN; ++n) mma_tf32(c[n], ah[n % kA], bl[n]);
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) mma_tf32(c[n], ah[n % kA], bh[n]);
}

// The D-split forward (ca_fwd_dsplit_kernel), split TF32 on mma.sync: a
// block is kWarps warps over kRows query rows, whose clusters split D over
// two blocks; each warp owns kHalfGroups 32-column groups of its block's
// kHalfCols output columns, and contracts Ds = mma_cols(D) columns of D for
// its partial S.
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                    // the mma's m16
constexpr int kHalfGroups = 3;               // 96 columns a warp
constexpr int kHalfCols = kWarps * kHalfGroups * 32;  // 768 a block
constexpr int kPartLd = kT + 8;              // partial S rows: 72 floats
constexpr int kPLd = kT + 4;                 // P rows: 68 floats

// Columns of D a warp contracts for its partial S: D / 8 rounded up to the
// 16-column step.
__host__ __device__ inline int mma_cols(int D) {
  return ((D + kWarps - 1) / kWarps + 15) / 16 * 16;
}
// Row stride of the staged Q tile: 8 warps' columns plus 16 floats, which
// is 16 mod 32, so the 8 lanes of a float4 phase hit 32 distinct banks.
__host__ __device__ inline int mma_q_ld(int D) {
  return kWarps * mma_cols(D) + 16;
}

// Asynchronous copies global -> shared of 4 consecutive elements (16 bytes
// of float, 8 of bfloat16), zero-filled where `ok` is false; a warp waits
// for its own with cp_wait and __syncwarp, no block barrier.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int kPending> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending));
}

// dst[0..3] = row[d .. d + 3], 0 where the row is out of range (ok false:
// row is then not read, and may point past the tensor) or past D. kVec: D is a multiple of 4 and the base pointers are aligned,
// so one asynchronous copy does it; otherwise plain loads, element by
// element.
template <bool kVec, typename T>
__device__ __forceinline__ void copy4(T* dst, const T* row, bool ok, int d,
                                      int D) {
  if constexpr (kVec) {
    ok = ok && d < D;
    cp_async4(dst, ok ? row + d : row, ok);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = ok && d + i < D ? row[d + i] : zero<T>();
  }
}

// Four consecutive staged elements as float32.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// No load moves across this point: it bounds how many staged operands the
// compiler loads ahead of their mma, which would otherwise cost registers
// the accumulators need.
__device__ __forceinline__ void fence() { asm volatile("" ::: "memory"); }

__device__ __forceinline__ float elem(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// Four consecutive output elements c .. c + 3 of a row, in bounds.
template <bool kVec>
__device__ __forceinline__ void store4(float* row, int c, int D, float4 x) {
  if (kVec && c < D) {
    *reinterpret_cast<float4*>(row + c) = x;
    return;
  }
  for (int i = 0; i < 4; ++i)
    if (c + i < D) row[c + i] = elem(x, i);
}
template <bool kVec>
__device__ __forceinline__ void store4(__nv_bfloat16* row, int c, int D,
                                       float4 x) {
  if (kVec && c < D) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(row + c) = u;
    return;
  }
  for (int i = 0; i < 4; ++i)
    if (c + i < D) store(row + c + i, elem(x, i));
}

// c += the product mma_tile leaves in a fresh accumulator. An mma aligns
// its products and its accumulator to the largest of them and truncates
// the rest: products added to a running sum larger than themselves lose
// their low bits, always towards zero, and over the hundreds of steps of a
// row the loss builds up (1e-6 relative and more where all terms share a
// sign, as a key's similarity to itself does). So every k8 step starts
// from zero, takes its small split terms first and its hi x hi term last,
// and is added to the running sum with a round-to-nearest FADD.
__device__ __forceinline__ void add_into(float (&c)[4], const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += x[e];
}

// The SM count of the current device, which is the device a launch runs
// on: looked up on every call (a host-side attribute read), so a process
// that launches on two cards gets each card's own count.
int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || count < 1)
    return 1;
  return count;
}

// The width of the first half of D in the D-split forward's clusters:
// ceil(D / 2), rounded up to 4 (float4 rows).
__host__ __device__ inline int half_cut(int D) {
  return ((D + 1) / 2 + 3) / 4 * 4;
}

template <typename Kernel>
int opt_in_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The launch plan of a kernel whose blocks come in clusters of two along y,
// without a launch: plan[0] tile rows, [1] blocks per cluster, [2] the most
// clusters resident at once on the current device
// (cudaOccupancyMaxActiveClusters), [3] dynamic shared-memory bytes per
// block, [4] clusters in the grid.
template <typename Kernel>
int cluster_plan(Kernel kernel, dim3 grid, size_t smem, int rows, int* plan) {
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 2;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (int err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg))
    return err;
  plan[0] = rows;
  plan[1] = 2;
  plan[2] = clusters;
  plan[3] = (int)smem;
  plan[4] = (int)(grid.x * (grid.y / 2) * grid.z);
  return 0;
}

}  // namespace
