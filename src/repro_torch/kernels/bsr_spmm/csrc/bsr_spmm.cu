// Fused BSR SpMM + bias + ReLU + clip, the GraphChallenge layer op, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the two Pallas kernels of src/repro/kernels/bsr_spmm/bsr_spmm.py:
//   bsr_spmm_fused_kernel  <- bsr_spmm_fused (body _kernel): one worker-layer
//   bsr_spmm_fleet_kernel  <- bsr_spmm_fleet_megakernel (body _fleet_kernel):
//                             every worker of the fleet in one launch, each
//                             row's K loop bounded by its real block count
//
//   y[p, r*bm + i, c] = clip(sum_k sum_j blocks[p,r,k,i,j]
//                              * x[p, cols[p,r,k]*bn + j, c] + bias, 0, clip)
//
// What bounds it on this card.  The padded 32x32 BSR layout of the
// GraphChallenge nets holds three block patterns: dense blocks (window
// offset 0, K = 1 block a row block), 4 nonzeros a block row (offset 3,
// K = 8) and exactly one (offsets 6 and 9, K = 32).  Every layer has 32
// nonzeros a row, so at N = 65536 and batch 128 the work that the data needs
// is 0.54 GFLOP (8 us at the 67 TFLOP/s fp32 peak) against 75-336 MB of
// blocks, x and y (23-100 us at 3.35 TB/s): bytes bound it at every offset.
// Past device memory, each 32-row x slice that a block references (16 KB)
// is read from L2 once for every block that references it: 1.07 GB at K = 32,
// more than the HBM traffic itself, so L2 bandwidth for x sets the pace
// there: on an H100 SXM at 700 W the times at K 8 and K 32 follow the 20 KB
// a block staged through L2 (5.2-5.9 TB/s) while their HBM traffic moves at
// 1.5-2.1 TB/s.  Sharing the slice between row blocks that reference the
// same column block would cut it; this kernel does not.  Among the port's
// kernels the SSD scan (ssd_scan.cu), not this one, is the next to
// redesign: it loses the most time against its bound.
//
// The design.  One CUDA block owns one (worker, row block, batch tile of 128)
// output tile; warp w of its 8 owns rows w, w + 8, w + 16 and w + 24, and
// each lane 4 consecutive batch columns (one float4), so one row of the x
// slice is one conflict-free 16-byte load across the warp.  Each block k's
// 4 KB of weights and its 16 KB x slice stream through a ring in shared
// memory with cp.async (16 bytes a thread where the shapes allow it, 4
// otherwise, with zero fill for ragged bm/bn < 32, rows past n and columns
// past b), so the copies of block k+1 are in flight while block k computes.
// The ring has kStages = 2 stages (40 KB of static shared memory) at every
// K, and the launch bounds hold a thread to 64 registers, so registers set
// 4 resident blocks an SM, which hide one another's waits.  At K = 1 the
// ring commits one empty group and runs as one stage would (chip_smoke.py's
// ring depth sweep times the ring against a one-stage build).
// The weights are read once and carry an evict-first L2 hint, so that they
// do not push x (33.5 MB, inside the 50 MB L2) out.  The row block's cols are
// loaded once, 32 at a time into a register of each lane, and broadcast by
// __shfl_sync.
//
// Zero weights are skipped.  For block k, lane j of the warp holds w[i][j]
// of each of its rows i; __ballot_sync(w != 0) gives row i's mask, and the
// warp walks the union of its rows' masks in ascending j: it loads x row j
// once and, for each row whose bit j is set, takes w[i][j] by __shfl_sync
// and does one fmaf.  The masks are warp-uniform, so no lane diverges.
// Where the rows' masks are equal (dense blocks; the rows a warp owns at
// window offset 3) the walk skips the test a row.  On dense blocks every bit
// is set: the same FFMAs as a dense walk, with x row j loaded once for the
// warp's 4 rows.
//
// Why skipping gives the bits of the dense walk (k ascending, j ascending,
// one fmaf a term), on finite inputs.  A zero weight's term w*x is an exact
// +-0 when x is finite, and fmaf(+-0, x, acc) has acc's value, so the two
// walks hold equal values after every term: where the exact result of an
// fmaf is nonzero, both round it alike.  The accumulator starts at +0 and in
// round-to-nearest a zero sum is -0 only when both addends are, so it can
// become -0 only through an underflow (a negative exact result of magnitude
// at most 2^-150, half the least subnormal): then the walks may differ in
// the sign of a zero, which the epilogue erases (every zero and negative sum
// stores +0).
// So y is equal bit for bit.  The same argument makes the fleet kernel
// (which stops at counts) equal to the per-worker kernel (which walks all
// K): the padding blocks past a row's count are all zero, so their masks
// are empty and they add no term at all.
//
// Non-finite x.  A skipped 0 * Inf or 0 * NaN is the one term whose value is
// not +-0: the dense walk's sum becomes NaN there, and so do the plain
// versions'.  So when block k's x slice lands in the ring, each thread
// tests the 16 values it copied (v * 0 is NaN only for an Inf or NaN v),
// and the barrier the ring takes anyway (__syncthreads_or) ORs the tests
// over the block.  Where a slice holds one, every warp walks block k
// densely: every j in ascending order for every row, the dense walk's own
// terms, so the sums are the dense walk's, NaN included; on lanes whose
// x is finite that is still the same bits as the skipping walk.  The
// epilogue keeps a NaN (fmaxf/fminf would turn it into 0 or the clip).
// Finite x never takes the dense walk: its bits are as before.  The fleet
// kernel never stages the padding slots past a row's count, which the
// plain versions multiply (their all-zero weights over column block 0 of
// x): with an Inf or NaN in column block 0 the two differ there, as the
// reference's count-bounded and dense lowerings differ from each other.
//
// Why no tensor cores.  With one nonzero a block row, a wgmma tile would
// multiply 31 zeros for each useful term, and the useful arithmetic is 8 us
// a layer at the FFMA peak while the bound is bytes.  TF32 would also break
// the 1e-5 layer tolerance over stacked clipped layers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 32;                        // largest bm and bn taken
constexpr int kTileB = 128;                     // batch columns per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBlk / kWarps;            // rows a warp owns: 4
constexpr int kStages = 2;                      // ring depth
constexpr int kMinBlocks = 4;                   // resident blocks an SM
constexpr int kStageFloats = kBlk * kBlk + kBlk * kTileB;  // 4 KB + 16 KB
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTileB == 4 * 32, "a lane owns 4 consecutive batch columns");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// `bytes` (16, or 4) from src to shared dst when ok, else zeros; the hinted
// forms carry an L2 cache policy.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp16_hint(uint32_t dst, const void* src,
                                          bool ok, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
      :: "r"(dst), "l"(src), "r"(ok ? 16 : 0), "l"(policy) : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp4_hint(uint32_t dst, const void* src,
                                         bool ok, uint64_t policy) {
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2, %3;\n"
      :: "r"(dst), "l"(src), "r"(ok ? 4 : 0), "l"(policy) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One block's weights [bm, bn] into ws[32][32] and its x slice (rows
// row0 .. row0+bn of x [n, b], columns b0 .. b0+128) into xs[32][128], zero
// filled outside.  Vec: 16-byte copies (bn and b multiples of 4, pointers
// 16-byte aligned), else 4-byte ones.
template <bool Vec>
__device__ __forceinline__ void copy_block(
    float* stage, const float* __restrict__ w, const float* __restrict__ x,
    long long row0, int bm, int bn, long long n, int b, int b0,
    uint64_t policy) {
  constexpr int kStep = Vec ? 4 : 1;
  constexpr int kWpr = kBlk / kStep, kXpr = kTileB / kStep;   // copies a row
  const int tid = threadIdx.x;
  const uint32_t ws = smem_u32(stage);
  const uint32_t xs = smem_u32(stage + kBlk * kBlk);
#pragma unroll
  for (int e = tid; e < kBlk * kWpr; e += kThreads) {
    const int i = e / kWpr, j = (e % kWpr) * kStep;
    const bool ok = i < bm && j < bn;
    const float* src = ok ? w + i * bn + j : w;
    const uint32_t dst = ws + 4u * (i * kBlk + j);
    if (Vec) cp16_hint(dst, src, ok, policy);
    else cp4_hint(dst, src, ok, policy);
  }
#pragma unroll
  for (int e = tid; e < kBlk * kXpr; e += kThreads) {
    const int j = e / kXpr, c = (e % kXpr) * kStep;
    const long long row = row0 + j;
    const bool ok = j < bn && row >= 0 && row < n && b0 + c < b;
    const float* src = ok ? x + row * b + b0 + c : x;
    const uint32_t dst = xs + 4u * (j * kTileB + c);
    if (Vec) cp16(dst, src, ok);
    else cp4(dst, src, ok);
  }
}

__device__ __forceinline__ void fma4(float w, const float4& x, float4& acc) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ float epilogue(float acc, float bias, float clip) {
  const float v = acc + bias;
  if (v != v) return v;                      // NaN stays NaN, as in clamp
  return fminf(v > 0.0f ? v : 0.0f, clip);   // every zero stores +0
}

// Whether one of the 16 x values this thread copied into a stage (see
// copy_block) is an Inf or a NaN: fmaf(v, 0, a) turns only those into NaN.
// Four independent sums keep the chain after the loads short.
template <bool Vec>
__device__ __forceinline__ bool copied_x_nonfinite(const float* xs) {
  constexpr int kN = kBlk * kTileB / kThreads;   // 16
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < kN / 4; ++m) {
    float4 v;
    if (Vec) {
      v = reinterpret_cast<const float4*>(xs)[threadIdx.x + m * kThreads];
    } else {
      const float* p = xs + threadIdx.x + 4 * m * kThreads;
      v = make_float4(p[0], p[kThreads], p[2 * kThreads], p[3 * kThreads]);
    }
    a[0] = __fmaf_rn(v.x, 0.0f, a[0]);
    a[1] = __fmaf_rn(v.y, 0.0f, a[1]);
    a[2] = __fmaf_rn(v.z, 0.0f, a[2]);
    a[3] = __fmaf_rn(v.w, 0.0f, a[3]);
  }
  const float t = __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3]));
  return t != t;
}

// Block k's terms for the warp's rows (see the note at the top): ws the
// block's weights [32][32], xs its x slice [32][32 float4].  Warp w owns rows
// w, w + 8, w + 16 and w + 24, which share their columns at window offset 3,
// so there the warp loads 4 rows of x a block, not 16.  With `dense` (an
// Inf or NaN in the slice) every row takes every j.
__device__ __forceinline__ void walk_block(const float* ws, const float4* xs,
                                           int warp, int lane, bool dense,
                                           float4 (&acc)[kRows]) {
  float w[kRows];
  unsigned mask[kRows];
  unsigned any = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    w[r] = ws[(r * kWarps + warp) * kBlk + lane];
    mask[r] = dense ? kFull : __ballot_sync(kFull, w[r] != 0.0f);
    any |= mask[r];
  }
  bool same = true;
#pragma unroll
  for (int r = 0; r < kRows; ++r) same &= mask[r] == any;
  if (same) {                  // every row has these columns: no test a row
    while (any) {              // ascending j, warp-uniform
      const int j = __ffs(any) - 1;
      any &= any - 1;
      const float4 xv = xs[j * (kTileB / 4) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        fma4(__shfl_sync(kFull, w[r], j), xv, acc[r]);
    }
  } else {
    while (any) {
      const int j = __ffs(any) - 1;
      any &= any - 1;
      const float4 xv = xs[j * (kTileB / 4) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (mask[r] >> j & 1u) fma4(__shfl_sync(kFull, w[r], j), xv, acc[r]);
    }
  }
}

// One (row block, batch tile) of one worker.  blocks/cols point at the row
// block's K slots, x at the worker's [n, b] panel, y at the row block's
// [bm, b] output rows.  Vec: 16-byte copies and stores (see copy_block).
template <bool Vec>
__device__ __forceinline__ void bsr_row_block(
    const float* __restrict__ blocks, const int* __restrict__ cols, int k_end,
    const float* __restrict__ x, float* __restrict__ y, int bm, int bn,
    long long n, int b, float bias, float clip) {
  __shared__ __align__(16) float smem[kStages * kStageFloats];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b0 = blockIdx.y * kTileB;
  const long long blk_elems = (long long)bm * bn;
  const uint64_t policy = evict_first_policy();

  int col_reg = 0;   // cols[32*(q/32) + lane] for the block q being issued
  auto issue = [&](int q) {
    if (q < k_end) {
      if (q % 32 == 0) col_reg = q + lane < k_end ? __ldg(cols + q + lane) : 0;
      const int col = __shfl_sync(kFull, col_reg, q % 32);
      const long long row0 = (long long)col * bn;
      float* stage = smem + (q % kStages) * kStageFloats;
      const float* w = blocks + q * blk_elems;
      copy_block<Vec>(stage, w, x, row0, bm, bn, n, b, b0, policy);
    }
    cp_commit();
  };

  float4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int kk = 0; kk < k_end; ++kk) {
    issue(kk + kStages - 1);
    cp_wait<kStages - 1>();            // block kk's copies, this thread's
    const float* ws = smem + (kk % kStages) * kStageFloats;
    // every thread's copies, and whether one of them put an Inf or a NaN
    // into the x slice
    const bool dense =
        __syncthreads_or(copied_x_nonfinite<Vec>(ws + kBlk * kBlk)) != 0;
    walk_block(ws, reinterpret_cast<const float4*>(ws + kBlk * kBlk), warp,
               lane, dense, acc);
    __syncthreads();             // the stage is free for block kk + kStages
  }

  const int c = b0 + 4 * lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r * kWarps + warp;
    if (row >= bm) continue;
    const float4 v = make_float4(epilogue(acc[r].x, bias, clip),
                                 epilogue(acc[r].y, bias, clip),
                                 epilogue(acc[r].z, bias, clip),
                                 epilogue(acc[r].w, bias, clip));
    float* out = y + (long long)row * b + c;
    if (Vec) {
      if (c < b) *reinterpret_cast<float4*>(out) = v;
    } else {
      if (c < b) out[0] = v.x;
      if (c + 1 < b) out[1] = v.y;
      if (c + 2 < b) out[2] = v.z;
      if (c + 3 < b) out[3] = v.w;
    }
  }
}

// grid (NBR, batch tiles): blocks [NBR,K,bm,bn], cols [NBR,K], x [n,b],
// y [NBR*bm, b].  Every row runs all K slots.
template <bool Vec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bsr_spmm_fused_kernel(
    const float* __restrict__ blocks, const int* __restrict__ cols,
    const float* __restrict__ x, float* __restrict__ y, int k, int bm, int bn,
    int n, int b, float bias, float clip) {
  const long long r = blockIdx.x;
  bsr_row_block<Vec>(blocks + r * k * bm * bn, cols + r * k, k, x,
                     y + r * bm * b, bm, bn, n, b, bias, clip);
}

// grid (P*NBR, batch tiles): blocks [P,NBR,K,bm,bn], cols [P,NBR,K],
// counts [P,NBR], x [P,n,b], y [P, NBR*bm, b].  Row (p, r) stops at
// counts[p, r], clamped to [0, K].
template <bool Vec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bsr_spmm_fleet_kernel(
    const float* __restrict__ blocks, const int* __restrict__ cols,
    const int* __restrict__ counts, const float* __restrict__ x,
    float* __restrict__ y, int nbr, int k, int bm, int bn, int n, int b,
    float bias, float clip) {
  const long long pr = blockIdx.x;     // p * nbr + r, below 2^31
  const long long p = (int)pr / nbr;
  const int k_end = min(max(counts[pr], 0), k);
  bsr_row_block<Vec>(blocks + pr * k * bm * bn, cols + pr * k, k_end,
                     x + p * n * b, y + pr * bm * b, bm, bn, n, b, bias, clip);
}

int check_shape(long long rows, int k, int bm, int bn, int n, int b) {
  if (rows < 0 || k < 0 || n < 0 || b < 0) return (int)cudaErrorInvalidValue;
  if (bm < 1 || bm > kBlk || bn < 1 || bn > kBlk) return (int)cudaErrorInvalidValue;
  if (rows > 0x7fffffffLL || (b + kTileB - 1) / kTileB > 65535)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// 16-byte copies and stores: every row of a block, of x and of y starts on
// 16 bytes.
bool vec_ok(const void* blocks, const void* x, const void* y, int bn, int b) {
  const uintptr_t a = (uintptr_t)blocks | (uintptr_t)x | (uintptr_t)y;
  return bn % 4 == 0 && b % 4 == 0 && a % 16 == 0;
}

}  // namespace

extern "C" {

// Each launcher returns cudaGetLastError() after the launch (0 on success),
// or an argument error without launching.  Nothing is launched for an empty
// output.  The kernels run on `stream` and do not synchronise.
int bsr_spmm_fused_launch(const void* blocks, const void* cols, const void* x,
                          void* y, int nbr, int k, int bm, int bn, int n, int b,
                          float bias, float clip, void* stream) {
  if (int err = check_shape(nbr, k, bm, bn, n, b)) return err;
  if (nbr == 0 || b == 0) return 0;
  const dim3 grid(nbr, (b + kTileB - 1) / kTileB);
  const auto kernel = vec_ok(blocks, x, y, bn, b)
                          ? bsr_spmm_fused_kernel<true>
                          : bsr_spmm_fused_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int*)cols, (const float*)x, (float*)y, k,
      bm, bn, n, b, bias, clip);
  return (int)cudaGetLastError();
}

int bsr_spmm_fleet_launch(const void* blocks, const void* cols,
                          const void* counts, const void* x, void* y, int p,
                          int nbr, int k, int bm, int bn, int n, int b,
                          float bias, float clip, void* stream) {
  if (p < 0) return (int)cudaErrorInvalidValue;
  if (int err = check_shape((long long)p * nbr, k, bm, bn, n, b)) return err;
  if (p == 0 || nbr == 0 || b == 0) return 0;
  const dim3 grid((unsigned)((long long)p * nbr), (b + kTileB - 1) / kTileB);
  const auto kernel = vec_ok(blocks, x, y, bn, b)
                          ? bsr_spmm_fleet_kernel<true>
                          : bsr_spmm_fleet_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int*)cols, (const int*)counts,
      (const float*)x, (float*)y, nbr, k, bm, bn, n, b, bias, clip);
  return (int)cudaGetLastError();
}

const char* bsr_spmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
