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
// What bounds it on this card: the padded BSR layout carries K = 32 blocks of
// 32x32 fp32 per row block at N = 65536 with only 32 nonzeros in each block.
// Each 4 KB block, read once, feeds 2*32*32*128 FLOPs at batch 128: 64 FLOPs
// per weight byte (about 51 counting x and y too), against the H100 SXM's
// balance of 20 (67 TFLOP/s fp32 FFMA over 3.35 TB/s), so the FFMAs bound it.
// The design reads each weight block from device memory once (the x slices
// are shared by many row blocks and come mostly from L2): one CUDA
// block owns one (worker, row block, batch tile of 128) output tile, stages
// each 4 KB weight block and the 32 x 128 x slice it references in shared
// memory, and accumulates the tile in registers (4 x 4 outputs a thread).
// The TPU grid walks row blocks in order inside a cell; here every row block
// is its own CUDA block, since blocks run in parallel on 132 SMs.  No TF32
// and no tensor cores: the reference holds the layer op to 1e-5.
//
// Summation order: k ascending, and inside a block j ascending, one fmaf per
// term.  Both kernels share that body, and the padding blocks beyond a row's
// count are exact zeros, so the fleet kernel (which stops at counts) and the
// per-worker kernel (which runs all K) give bitwise-equal results on finite
// inputs.  bm and bn below 32 are zero-padded in shared memory, which adds
// only exact +0 terms.

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 32;                        // largest bm and bn taken
constexpr int kTileB = 128;                     // batch columns per block
constexpr int kThreads = 256;
constexpr int kRows = kBlk / (kThreads / 32);   // output rows per thread: 4
constexpr int kCols = kTileB / 32;              // output cols per thread: 4

// One (row block, batch tile) of one worker.  blocks/cols point at the row
// block's K slots, x at the worker's [n, b] panel, y at the row block's
// [bm, b] output rows.
__device__ __forceinline__ void bsr_row_block(
    const float* __restrict__ blocks, const int* __restrict__ cols, int k_end,
    const float* __restrict__ x, float* __restrict__ y, int bm, int bn,
    long long n, int b, float bias, float clip) {
  __shared__ float ws[kBlk][kBlk];     // weight block, [i][j]
  __shared__ float xs[kBlk][kTileB];   // x slice, [j][c]

  const int tid = threadIdx.x;
  const int tx = tid % 32;             // column lane: cols tx + 32*q
  const int ty = tid / 32;             // warp: rows ty*kRows .. +kRows
  const int b0 = blockIdx.y * kTileB;
  const long long blk_elems = (long long)bm * bn;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[i][q] = 0.0f;

  for (int kk = 0; kk < k_end; ++kk) {
    const float* w = blocks + kk * blk_elems;
    for (int e = tid; e < kBlk * kBlk; e += kThreads) {
      const int i = e / kBlk, j = e % kBlk;
      ws[i][j] = (i < bm && j < bn) ? w[i * bn + j] : 0.0f;
    }
    const long long row0 = (long long)cols[kk] * bn;
    for (int e = tid; e < kBlk * kTileB; e += kThreads) {
      const int j = e / kTileB, c = e % kTileB;
      const long long row = row0 + j;
      const bool ok = j < bn && row >= 0 && row < n && b0 + c < b;
      xs[j][c] = ok ? x[row * b + b0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBlk; ++j) {
      float xv[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) xv[q] = xs[j][tx + 32 * q];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float wv = ws[ty * kRows + i][j];
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[i][q] = fmaf(wv, xv[q], acc[i][q]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = ty * kRows + i;
    if (row >= bm) continue;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int c = b0 + tx + 32 * q;
      if (c < b) y[(long long)row * b + c] = fminf(fmaxf(acc[i][q] + bias, 0.0f), clip);
    }
  }
}

// grid (NBR, batch tiles): blocks [NBR,K,bm,bn], cols [NBR,K], x [n,b],
// y [NBR*bm, b].  Every row runs all K slots.
__global__ void __launch_bounds__(kThreads) bsr_spmm_fused_kernel(
    const float* __restrict__ blocks, const int* __restrict__ cols,
    const float* __restrict__ x, float* __restrict__ y, int k, int bm, int bn,
    int n, int b, float bias, float clip) {
  const long long r = blockIdx.x;
  bsr_row_block(blocks + r * k * bm * bn, cols + r * k, k, x,
                y + r * bm * b, bm, bn, n, b, bias, clip);
}

// grid (P*NBR, batch tiles): blocks [P,NBR,K,bm,bn], cols [P,NBR,K],
// counts [P,NBR], x [P,n,b], y [P, NBR*bm, b].  Row (p, r) stops at
// counts[p, r], clamped to [0, K].
__global__ void __launch_bounds__(kThreads) bsr_spmm_fleet_kernel(
    const float* __restrict__ blocks, const int* __restrict__ cols,
    const int* __restrict__ counts, const float* __restrict__ x,
    float* __restrict__ y, int nbr, int k, int bm, int bn, int n, int b,
    float bias, float clip) {
  const long long pr = blockIdx.x;     // p * nbr + r
  const long long p = pr / nbr;
  const int k_end = min(max(counts[pr], 0), k);
  bsr_row_block(blocks + pr * k * bm * bn, cols + pr * k, k_end,
                x + p * n * b, y + pr * bm * b, bm, bn, n, b, bias, clip);
}

int check_shape(long long rows, int k, int bm, int bn, int n, int b) {
  if (rows < 0 || k < 0 || n < 0 || b < 0) return (int)cudaErrorInvalidValue;
  if (bm < 1 || bm > kBlk || bn < 1 || bn > kBlk) return (int)cudaErrorInvalidValue;
  if (rows > 0x7fffffffLL || (b + kTileB - 1) / kTileB > 65535)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
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
  dim3 grid(nbr, (b + kTileB - 1) / kTileB);
  bsr_spmm_fused_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int*)cols, (const float*)x, (float*)y, k, bm,
      bn, n, b, bias, clip);
  return (int)cudaGetLastError();
}

int bsr_spmm_fleet_launch(const void* blocks, const void* cols,
                          const void* counts, const void* x, void* y, int p,
                          int nbr, int k, int bm, int bn, int n, int b,
                          float bias, float clip, void* stream) {
  if (p < 0) return (int)cudaErrorInvalidValue;
  if (int err = check_shape((long long)p * nbr, k, bm, bn, n, b)) return err;
  if (p == 0 || nbr == 0 || b == 0) return 0;
  dim3 grid((unsigned)((long long)p * nbr), (b + kTileB - 1) / kTileB);
  bsr_spmm_fleet_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int*)cols, (const int*)counts,
      (const float*)x, (float*)y, nbr, k, bm, bn, n, b, bias, clip);
  return (int)cudaGetLastError();
}

const char* bsr_spmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
