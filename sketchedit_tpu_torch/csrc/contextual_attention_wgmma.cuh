// The split-TF32 product on TMA-fed warpgroup wgmma that the default and
// shared forwards (contextual_attention_fwd.cu), dQ and the fused dK/dV
// backward (contextual_attention_bwd.cu) are built on: the prep bodies that
// write an operand's TF32 terms, by rows or transposed, and the body of a
// product block, C[b] = A[b] B[b]^T, up to its accumulators, in either of
// two block shapes (NineWarps, WarpSpec). Each file wraps these in kernels
// of its own names and epilogues.

#pragma once

#include <atomic>

#include "contextual_attention_common.cuh"
#include "hopper_async.cuh"

namespace {

constexpr int kWgThreads = 288;  // two consumer warpgroups, one producer warp
constexpr int kTileM = 64;       // rows a warpgroup: wgmma's m64
constexpr int kChunk = 32;       // contraction elements a stage: 128 bytes
constexpr int kSumStages = 4;    // stages a grouped product sums apart

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// A product block's shape beside its tiles. The forwards' (NineWarps):
// kWgThreads threads, two consumer warpgroups and one producer warp, whose
// nine warps cap every thread at 168 registers (three of them share an SM
// quarter's 16,384). The backward's (WarpSpec): three warpgroups, the third
// the producer, which gives back all but kProducerRegs of its 168
// registers a thread (setmaxnreg) so that each consumer thread may hold
// kConsumerRegs: 128 x 40 + 256 x 232 = 64,512 of an SM's 65,536. Both keep
// warps 0-7 as the consumers. kFresh fresh accumulators a consumer cycles
// through: kFresh - 1 k8 steps in flight while the FADDs of the one before
// them run.
struct NineWarps {
  static constexpr bool kWs = false;
  static constexpr int kFresh = 2;
};
template <int kFreshV> struct WarpSpec {
  static constexpr bool kWs = true;
  static constexpr int kFresh = kFreshV;
  static constexpr int kThreads = 384, kProducerRegs = 40,
                       kConsumerRegs = 232;
  static_assert(kFresh == 2 || kFresh == 3, "two or three accumulators");
  static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536,
                "the block's registers exceed the SM's");
};

// x as two TF32 terms with their low 13 bits clear, x = hi + lo to within
// 2^-22 |x|: hi = rna(x), lo = rna(x - hi) (to_tf32's rounding on the bits).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = __uint_as_float((__float_as_uint(x - hi) + 0x1000u) & 0xffffe000u);
}

// x into hi[i] and lo[i] as TF32 terms, or into hi[i] alone where lo is
// null (the value is exact in TF32: bfloat16 data).
__device__ __forceinline__ void put_terms(float x, float* hi, float* lo,
                                          long long i) {
  if (lo == nullptr) {
    hi[i] = x;
    return;
  }
  float h, l;
  split_tf32(x, h, l);
  hi[i] = h;
  lo[i] = l;
}

// A kernel of 256 threads a block, one block a row: rows r0 .. r0 + rc of
// each image of `in` (B, rows_in, D), times ks (B, D) where given, in
// float32, as TF32 terms into hi and lo (B, rc, Dp), 0 past D.
template <typename T>
__device__ __forceinline__ void split_rows(const T* in, const float* ks,
                                           float* hi, float* lo, int rows_in,
                                           int r0, int rc, int D) {
  const int Dp = round4(D);
  const int b = blockIdx.x / rc, r = blockIdx.x % rc;
  const T* src = in + ((long long)b * rows_in + r0 + r) * D;
  const float* sc = ks == nullptr ? nullptr : ks + (long long)b * D;
  const long long o = (long long)blockIdx.x * Dp;
  for (int d = threadIdx.x; d < Dp; d += blockDim.x) {
    float x = 0.f;
    if (d < D) {
      x = to_f(src[d]);
      if (sc != nullptr) x *= sc[d];
    }
    put_terms(x, hi, lo, o + d);
  }
}

// A kernel of 256 threads a block over grid (Rp / 32, D / 32, B): X (B, R,
// D) transposed to (B, D, Rp) as TF32 terms, Rp = R rounded up to 4, 0
// past R; 32 x 32 tiles through shared memory.
template <typename T>
__device__ __forceinline__ void split_t(const T* X, float* hi, float* lo,
                                        int R, int D) {
  __shared__ float tile[32][33];
  const int Rp = round4(R);
  const int b = blockIdx.z, p0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* Xb = X + (long long)b * R * D;
  for (int i = ty; i < 32; i += 8) {
    const int p = p0 + i, d = d0 + tx;
    tile[i][tx] = p < R && d < D ? to_f(Xb[(long long)p * D + d]) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int d = d0 + i, p = p0 + tx;
    if (d < D && p < Rp)
      put_terms(tile[tx][i], hi, lo, ((long long)b * D + d) * Rp + p);
  }
}

// A k8 step's passes into the fresh accumulator f, committed as one group.
template <int kN, bool kSplitB>
__device__ __forceinline__ void issue_step(float (&f)[kN / 2], uint64_t ah,
                                           uint64_t al, uint64_t bh,
                                           uint64_t bl) {
  wg_fence();
  wgmma_tf32<kN>(f, al, bh, 0);
  if constexpr (kSplitB) wgmma_tf32<kN>(f, ah, bl, 1);
  wgmma_tf32<kN>(f, ah, bh, 1);
  wg_commit();
}

// f added into sum, once the wait before it has seen f's group done.
template <int kN>
__device__ __forceinline__ void add_fresh(float (&sum)[kN / 2],
                                          float (&f)[kN / 2]) {
  pin(f);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sum[i] += f[i];
}

// One k8 step of a warpgroup's product into the fresh accumulator f (a
// pass per term: lo hi, hi lo where B is split, hi hi); then, once all but
// this step's wgmma are done, the previous step's fresh accumulator `prev`
// added into acc where `add_prev`.
template <int kN, bool kSplitB>
__device__ __forceinline__ void k8_step(float (&acc)[kN / 2],
                                        float (&f)[kN / 2],
                                        float (&prev)[kN / 2], uint64_t ah,
                                        uint64_t al, uint64_t bh, uint64_t bl,
                                        bool add_prev) {
  issue_step<kN, kSplitB>(f, ah, al, bh, bl);
  wg_wait<1>();  // the previous step's group is done
  pin(prev);
  if (add_prev) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] += prev[i];
  }
}

// One stage's four k8 steps (32 bytes, 2 descriptor units, apart in each
// row) added into sum, alternating the fresh accumulators f0 and f1 so a
// step's FADDs overlap the next step's wgmma; the last step is waited for
// before the stage is released (an overlap carried across stages made
// ptxas serialize every wgmma, C7514).
template <int kN, bool kSplitB>
__device__ __forceinline__ void stage_product(float (&sum)[kN / 2],
                                              float (&f0)[kN / 2],
                                              float (&f1)[kN / 2],
                                              uint64_t ah, uint64_t al,
                                              uint64_t bh, uint64_t bl) {
  k8_step<kN, kSplitB>(sum, f0, f1, ah, al, bh, bl, false);
  k8_step<kN, kSplitB>(sum, f1, f0, ah + 2, al + 2, bh + 2, bl + 2, true);
  k8_step<kN, kSplitB>(sum, f0, f1, ah + 4, al + 4, bh + 4, bl + 4, true);
  k8_step<kN, kSplitB>(sum, f1, f0, ah + 6, al + 6, bh + 6, bl + 6, true);
  wg_wait<0>();
  add_fresh<kN>(sum, f1);
}

// stage_product with three fresh accumulators: two k8 steps in flight
// while the FADDs of the one before them run. The same steps are added in
// the same order, so the same bits; the stage is drained before its
// release, as there.
template <int kN, bool kSplitB>
__device__ __forceinline__ void stage_product3(
    float (&sum)[kN / 2], float (&f0)[kN / 2], float (&f1)[kN / 2],
    float (&f2)[kN / 2], uint64_t ah, uint64_t al, uint64_t bh, uint64_t bl) {
  issue_step<kN, kSplitB>(f0, ah, al, bh, bl);
  issue_step<kN, kSplitB>(f1, ah + 2, al + 2, bh + 2, bl + 2);
  issue_step<kN, kSplitB>(f2, ah + 4, al + 4, bh + 4, bl + 4);
  wg_wait<2>();
  add_fresh<kN>(sum, f0);
  issue_step<kN, kSplitB>(f0, ah + 6, al + 6, bh + 6, bl + 6);
  wg_wait<2>();
  add_fresh<kN>(sum, f1);
  wg_wait<1>();
  add_fresh<kN>(sum, f2);
  wg_wait<0>();
  add_fresh<kN>(sum, f0);
}

// The body of a product block of Block's shape: C[b] = A[b] B[b]^T over
// K contraction elements, A (rows x K) and B (cols x K) K-major float32
// tensors given as their TF32 terms through tensor maps (a_hi, a_lo, b_hi
// and, where B is split, b_lo). Warps 0-7 are two consumer warpgroups,
// each a 64-row x kWN-column tile: side by side over the columns (kMW = 1:
// a block is 64 x 2 kWN) or one above the other over the rows (kMW = 2:
// 128 x kWN, sharing each B box). Warp 8 is the producer (in a WarpSpec
// block, with warps 9-11, the warpgroup that gives its registers to the
// consumers): its lane 0 keeps kStages stages of 32 contraction elements
// in flight (each stage: the A terms' and the B terms' boxes, 128-byte
// swizzled; a `full` mbarrier per stage counts their bytes, an `empty` one
// the eight consumer warps' release). Each warpgroup runs a stage's four
// k8 steps with stage_product (stage_product3 where Block::kFresh is 3).
// kGroup > 0 sums each run of kGroup stages apart before adding it to the
// total (a float32 chain over all of D's 192 k8 steps at D = 1536 drifts
// ~3x further from float64 than one of ~30); kGroup = 0 adds every step to
// the total. kCompensate (with kGroup > 0; a WarpSpec block, whose
// consumers have the registers) adds the runs to the total with Kahan's
// compensation, kWN / 2 more floats a thread, so the total's own rounding
// no longer builds up. Returns false in the producer; in a consumer,
// acc[4j + h] is row 16 (warp % 4) + g (+ 8 for h >= 2), column 8j + 2t (+
// 1 for odd h) of its warpgroup's tile (g = lane / 4, t = lane % 4).
template <int kWN, int kMW, bool kSplitB, int kStages, int kGroup,
          bool kCompensate = false, class Block = NineWarps>
__device__ __forceinline__ bool wgmma_product(const CUtensorMap& a_hi,
                                              const CUtensorMap& a_lo,
                                              const CUtensorMap& b_hi,
                                              const CUtensorMap& b_lo, int K,
                                              float (&acc)[kWN / 2]) {
  constexpr int kBM = kTileM * kMW, kBN = kWN * 2 / kMW;  // the block's tile
  constexpr int kA = kBM * 128, kB = kBN * 128;           // bytes a box
  constexpr int kStage = 2 * kA + (kSplitB ? 2 : 1) * kB;
  constexpr int kR = kWN / 2;                             // floats a thread
  static_assert(!kCompensate || Block::kWs,
                "the compensations need a WarpSpec block's registers");
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned stages
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int nchunk = (K + kChunk - 1) / kChunk;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer
    if constexpr (Block::kWs) regs_dec<Block::kProducerRegs>();
    if (warp == 8 && lane == 0) {
      for (int c = 0; c < nchunk; ++c) {
        const int s = c % kStages;
        mbar_wait(&empty[s], ((c / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        tma_load3(st, &a_hi, &full[s], c * kChunk, row0, b);
        tma_load3(st + kA, &a_lo, &full[s], c * kChunk, row0, b);
        tma_load3(st + 2 * kA, &b_hi, &full[s], c * kChunk, col0, b);
        if constexpr (kSplitB)
          tma_load3(st + 2 * kA + kB, &b_lo, &full[s], c * kChunk, col0, b);
      }
    }
    // A WarpSpec producer ends its threads here: were its path to join the
    // consumers' on the way back to the caller, ptxas would hold the code
    // after the join, the consumers' epilogue with it, to the producer's 40
    // registers and spill the accumulators across it
    if constexpr (Block::kWs) asm volatile("exit;");
    return false;
  }

  if constexpr (Block::kWs) regs_inc<Block::kConsumerRegs>();
  // a consumer warpgroup: its 64 x kWN tile's offsets in the block's
  const int wg = warp >> 2;
  const int wrow = kMW == 2 ? wg * kTileM : 0;
  const int wcol = kMW == 2 ? 0 : wg * kWN;
  float f0[kR], f1[kR], f2[Block::kFresh == 3 ? kR : 1];
  float part[kGroup ? kR : 1], comp[kCompensate ? kR : 1];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    acc[i] = f0[i] = f1[i] = 0.f;
    if constexpr (kCompensate) comp[i] = 0.f;
  }
  for (int c = 0; c < nchunk; ++c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    const uint8_t* st = smem + s * kStage;
    const uint64_t ah = desc_sw128(st + wrow * 128);
    const uint64_t al = desc_sw128(st + kA + wrow * 128);
    const uint64_t bh = desc_sw128(st + 2 * kA + wcol * 128);
    const uint64_t bl =
        kSplitB ? desc_sw128(st + 2 * kA + kB + wcol * 128) : 0;
    if constexpr (kGroup > 0) {
      if (c % kGroup == 0) {
#pragma unroll
        for (int i = 0; i < kR; ++i) part[i] = 0.f;
      }
      if constexpr (Block::kFresh == 3)
        stage_product3<kWN, kSplitB>(part, f0, f1, f2, ah, al, bh, bl);
      else
        stage_product<kWN, kSplitB>(part, f0, f1, ah, al, bh, bl);
      if (c % kGroup == kGroup - 1 || c == nchunk - 1) {
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          if constexpr (kCompensate) {
            const float y = part[i] - comp[i];
            const float t = acc[i] + y;
            comp[i] = (t - acc[i]) - y;
            acc[i] = t;
          } else {
            acc[i] += part[i];
          }
        }
      }
    } else if constexpr (Block::kFresh == 3) {
      stage_product3<kWN, kSplitB>(acc, f0, f1, f2, ah, al, bh, bl);
    } else {
      stage_product<kWN, kSplitB>(acc, f0, f1, ah, al, bh, bl);
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
  }
  if constexpr (kCompensate) {
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] -= comp[i];
  }
  return true;
}

// A product's block shape and pipeline: warpgroups of 64 x kWN, kMW of
// them over the rows; as many stages as fit the opt-in shared memory.
template <int kWN, int kMWv, bool kSplitB> struct Gemm {
  static constexpr int kMW = kMWv;
  static constexpr int kBM = kTileM * kMW, kBN = kWN * 2 / kMW;
  static constexpr int kStage = 2 * kBM * 128 + (kSplitB ? 2 : 1) * kBN * 128;
  static constexpr int kStages =
      (int)((kMaxSmem - 1024) / (kStage + 16)) > 8
          ? 8
          : (int)((kMaxSmem - 1024) / (kStage + 16));
  static constexpr size_t kSmem = (size_t)kStages * (kStage + 16) + 1024;
  static dim3 grid(int rows, int cols, int B) {
    return dim3((rows + kBM - 1) / kBM, (cols + kBN - 1) / kBN, B);
  }
};

// Sets a kernel's dynamic shared memory once per device it runs on.
template <typename Kernel>
int opt_in_once(Kernel kernel, size_t smem, std::atomic<unsigned long long>& done) {
  int dev = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return 0;
  if (int err = opt_in_smem(kernel, smem)) return err;
  done.fetch_or(bit);
  return 0;
}

}  // namespace
