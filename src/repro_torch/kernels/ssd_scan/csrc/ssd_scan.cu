// Chunked SSD scan (Mamba-2) for Hopper (sm_90a), with a plain C interface
// loaded through ctypes.
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan/ssd_scan.py:
//   ssd_scan_kernel  <- ssd_scan (body _kernel)
//
// For each batch row b and head h (B and C of group g = h / (H / G)), the
// sequence is cut into chunks of Q positions; per chunk, with the state S
// [P, N] carried from the chunk before (zero at the start):
//
//   l[t]  = cumsum_t(dt[t] * A[h])       (blocks of 16, see below)
//   M[t,s] = (C[t] . B[s]) * exp(clip(l[t] - l[s], -60, 0))  for s <= t,
//            0 for s > t
//   y[t]  = sum_s M[t,s] (x[s] dt[s]) + exp(clip(l[t], -60, 0)) (C[t] . S^T)
//   S    <- exp(clip(l[Q-1], -60, 0)) S + sum_s (x[s] w[s])^T B[s],
//           w[s] = exp(clip(l[Q-1] - l[s], -60, 0)) dt[s]
//
// all in fp32; y is written in x's dtype and the final S in fp32.
//
// What bounds it on this card: operations.  At mamba2-370m's prefill shape
// (B 8, H 32, G 1, L 512, P 64, N 128, chunk 256, bf16) it moves ~44 MB
// (13 us at 3.35 TB/s) and needs ~6.6 GFLOP of fp32 products (0.1 ms at 67
// TFLOP/s) when C.B is formed once per group; this kernel forms it once
// per head (~11 GFLOP).  The design keeps every intermediate on chip:
//
//   * one CUDA block (8 warps) owns one (b, h) and walks the chunks in
//     order, carrying S in shared memory: the loop inside the block takes
//     the place of the TPU kernel's sequential grid axis and its VMEM
//     scratch (P 64 x N 128 x 4 B = 32 KB at mamba2-370m);
//   * the TPU kernel holds a chunk's whole [Q, Q] score matrix (256 KB in
//     fp32 at Q 256, over a Hopper block's 227 KB); here a chunk is cut into
//     64-row tiles of t and of s, the s-tiles past the t-tile are skipped
//     (their terms are exact zeros in the reference), and only one 64 x 64
//     tile of M, one 64-row tile of C, of B and of x are staged at a time;
//   * every product is a register-tiled loop over shared memory: a thread
//     owns up to 4 rows by up to 8 columns (every 16th), and the row
//     strides of the operands read across lanes are odd, so the 16 lanes of
//     a row group hit 16 banks;
//   * the cumsum of a chunk is taken in the plain version's association
//     (sequential within blocks of 16, one thread a block, then the block
//     totals in order), so l agrees with it bit for bit.
//
// Scalar fp32 FMAs throughout.  Only B * H blocks exist (256 at B 8, H 32,
// 32 at B 1): a small batch leaves SMs idle.  Splitting the heads of a
// group over one block to share C.B, tensor cores for the bf16 products
// and a cp.async/TMA pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rows of t and of s staged at a time
constexpr int kScanBlock = 16;
constexpr int kMaxChunk = kScanBlock * kScanBlock;  // two levels of the scan

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float decay(float v) {  // exp(clip(v, -60, 0))
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

// How 256 threads cover an R x W output: RG row groups of TR consecutive
// rows, CL lanes each owning TW columns w = lane + CL * j.
template <int R, int W>
struct Layout {
  static constexpr int RG = R < 16 ? R : 16;
  static constexpr int CL = W < 16 ? W : 16;
  static constexpr int TR = R / RG;
  static constexpr int TW = W / CL;
  static constexpr int kUsed = RG * CL;
  static_assert(R % RG == 0 && W % CL == 0 && kUsed <= kThreads,
                "output shape does not tile over the block");
};

// acc[i][j] += sum_k a[r*ar + k*ak] * b[k*bk + w*bw], r = ty*TR + i,
// w = tx + CL*j, for the threads that own outputs (tid < kUsed).
template <int R, int W, int K>
__device__ __forceinline__ void mm_acc(
    float (&acc)[Layout<R, W>::TR][Layout<R, W>::TW], const float* a, int ar,
    int ak, const float* b, int bk, int bw) {
  using Lt = Layout<R, W>;
  if (threadIdx.x >= Lt::kUsed) return;
  const int ty = threadIdx.x / Lt::CL;
  const int tx = threadIdx.x % Lt::CL;
  const float* ap = a + ty * Lt::TR * ar;
  const float* bp = b + tx * bw;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[Lt::TR], bv[Lt::TW];
#pragma unroll
    for (int i = 0; i < Lt::TR; ++i) av[i] = ap[i * ar + k * ak];
#pragma unroll
    for (int j = 0; j < Lt::TW; ++j) bv[j] = bp[k * bk + j * Lt::CL * bw];
#pragma unroll
    for (int i = 0; i < Lt::TR; ++i)
#pragma unroll
      for (int j = 0; j < Lt::TW; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int R, int W>
__device__ __forceinline__ void zero(
    float (&acc)[Layout<R, W>::TR][Layout<R, W>::TW]) {
#pragma unroll
  for (int i = 0; i < Layout<R, W>::TR; ++i)
#pragma unroll
    for (int j = 0; j < Layout<R, W>::TW; ++j) acc[i][j] = 0.f;
}

template <int P, int N>
struct Smem {
  static constexpr int kNS = N + 1;  // odd row strides: see the header
  static constexpr int kMS = kTile + 1;
  static constexpr int kS = 0;                      // state [P][N+1]
  static constexpr int kC = kS + P * kNS;           // C tile [64][N+1]
  static constexpr int kB = kC + kTile * kNS;       // B tile [64][N+1]
  static constexpr int kX = kB + kTile * kNS;       // x tile [64][P]
  static constexpr int kM = kX + kTile * P;         // M tile [64][65]
  static constexpr int kL = kM + kTile * kMS;       // l [chunk], dt [chunk]
  static int bytes(int chunk) { return (kL + 2 * chunk) * 4; }
};

// rows [r0, r0 + 64) of a [rows, n] matrix into dst (row stride ds);
// rows at or past `rows` read as zeros; each row scaled by scale[r] when
// scale is given (rows past `rows` are never scaled).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ds,
                                          const T* __restrict__ src, int n,
                                          int r0, int rows,
                                          const float* scale) {
  for (int i = threadIdx.x; i < kTile * n; i += kThreads) {
    const int r = i / n;
    const int c = i % n;
    float v = 0.f;
    if (r0 + r < rows) {
      v = to_f(src[(long long)(r0 + r) * n + c]);
      if (scale != nullptr) v *= scale[r0 + r];
    }
    dst[r * ds + c] = v;
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state, int heads, int groups, int len,
                int chunk) {
  using Sm = Smem<P, N>;
  using LY = Layout<kTile, P>;   // y tile [64][P]
  using LM = Layout<kTile, kTile>;  // C.B tile [64][64]
  using LS = Layout<P, N>;       // state [P][N]
  extern __shared__ float smem[];
  float* ss = smem + Sm::kS;
  float* cs = smem + Sm::kC;
  float* bs = smem + Sm::kB;
  float* xs = smem + Sm::kX;
  float* ms = smem + Sm::kM;
  float* ls = smem + Sm::kL;
  float* dts = ls + chunk;
  float* ws = ms;  // the state update's w[s] reuse the M tile's space

  const int bh = blockIdx.x;  // b * heads + h
  const int b = bh / heads;
  const int h = bh % heads;
  const int g = h / (heads / groups);
  const T* xb = x + (long long)bh * len * P;
  const float* dtb = dt + (long long)bh * len;
  const T* bb = Bm + ((long long)b * groups + g) * len * N;
  const T* cb = Cm + ((long long)b * groups + g) * len * N;
  T* yb = y + (long long)bh * len * P;
  const float a = A[h];
  const int tid = threadIdx.x;

  for (int i = tid; i < P * N; i += kThreads) ss[(i / N) * Sm::kNS + i % N] = 0.f;

  for (int c0 = 0; c0 < len; c0 += chunk) {
    __syncthreads();  // the previous chunk is done with dts, ls and ss
    for (int i = tid; i < chunk; i += kThreads) dts[i] = dtb[c0 + i];
    __syncthreads();
    // l = cumsum(dt * A), dA rounded first, in chunk_cumsum's association
    // (models/mamba2.py): sequential within blocks of 16, then each block
    // plus the inclusive cumsum of the block totals before it
    const int nb = (chunk + kScanBlock - 1) / kScanBlock;
    if (tid < nb) {
      const int i0 = tid * kScanBlock;
      const int i1 = min(chunk, i0 + kScanBlock);
      float run = __fmul_rn(dts[i0], a);
      ls[i0] = run;
      for (int i = i0 + 1; i < i1; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a));
        ls[i] = run;
      }
    }
    __syncthreads();
    if (tid == 0) {  // carry[b] = sum of the totals of blocks 0 .. b-1
      float c = ls[kScanBlock - 1];
      for (int bk = 1; bk < nb; ++bk) {
        ms[bk] = c;
        c = __fadd_rn(c, ls[min(chunk, (bk + 1) * kScanBlock) - 1]);
      }
    }
    __syncthreads();
    for (int i = kScanBlock + tid; i < chunk; i += kThreads)
      ls[i] = __fadd_rn(ms[i / kScanBlock], ls[i]);
    __syncthreads();
    const float l_last = ls[chunk - 1];
    const T* xc = xb + (long long)c0 * P;
    const T* bc = bb + (long long)c0 * N;

    // ---- y, one 64-row tile of t at a time ----
    for (int t0 = 0; t0 < chunk; t0 += kTile) {
      __syncthreads();
      load_rows<T>(cs, Sm::kNS, cb + (long long)c0 * N, N, t0, chunk, nullptr);
      __syncthreads();
      float ycs[LY::TR][LY::TW], yin[LY::TR][LY::TW];
      zero<kTile, P>(ycs);
      zero<kTile, P>(yin);
      // C[t] . S_prev^T
      mm_acc<kTile, P, N>(ycs, cs, Sm::kNS, 1, ss, 1, Sm::kNS);
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        __syncthreads();
        load_rows<T>(bs, Sm::kNS, bc, N, s0, chunk, nullptr);
        load_rows<T>(xs, P, xc, P, s0, chunk, dts);  // x dt
        __syncthreads();
        float cbt[LM::TR][LM::TW];
        zero<kTile, kTile>(cbt);
        mm_acc<kTile, kTile, N>(cbt, cs, Sm::kNS, 1, bs, 1, Sm::kNS);
        {
          const int ty = tid / LM::CL, tx = tid % LM::CL;
#pragma unroll
          for (int i = 0; i < LM::TR; ++i) {
            const int t = t0 + ty * LM::TR + i;
#pragma unroll
            for (int j = 0; j < LM::TW; ++j) {
              const int s = s0 + tx + LM::CL * j;
              float v = 0.f;
              if (t < chunk && s <= t) v = cbt[i][j] * decay(ls[t] - ls[s]);
              ms[(t - t0) * Sm::kMS + (s - s0)] = v;
            }
          }
        }
        __syncthreads();
        mm_acc<kTile, P, kTile>(yin, ms, Sm::kMS, 1, xs, P, 1);
      }
      if (tid < LY::kUsed) {
        const int ty = tid / LY::CL, tx = tid % LY::CL;
#pragma unroll
        for (int i = 0; i < LY::TR; ++i) {
          const int t = t0 + ty * LY::TR + i;
          if (t >= chunk) continue;
          const float e = decay(ls[t]);
#pragma unroll
          for (int j = 0; j < LY::TW; ++j)
            from_f(yin[i][j] + e * ycs[i][j],
                   yb + (long long)(c0 + t) * P + tx + LY::CL * j);
        }
      }
    }

    // ---- the state: S <- exp(l_last) S + sum_s (x[s] w[s])^T B[s] ----
    __syncthreads();
    for (int i = tid; i < chunk; i += kThreads)
      ws[i] = decay(l_last - ls[i]) * dts[i];
    float sacc[LS::TR][LS::TW];
    zero<P, N>(sacc);
    for (int s0 = 0; s0 < chunk; s0 += kTile) {
      __syncthreads();
      load_rows<T>(bs, Sm::kNS, bc, N, s0, chunk, nullptr);
      load_rows<T>(xs, P, xc, P, s0, chunk, ws);  // x w
      __syncthreads();
      mm_acc<P, N, kTile>(sacc, xs, 1, P, bs, Sm::kNS, 1);
    }
    if (tid < LS::kUsed) {
      const float e = decay(l_last);
      const int ty = tid / LS::CL, tx = tid % LS::CL;
#pragma unroll
      for (int i = 0; i < LS::TR; ++i)
#pragma unroll
        for (int j = 0; j < LS::TW; ++j) {
          float* sp = ss + (ty * LS::TR + i) * Sm::kNS + tx + LS::CL * j;
          *sp = *sp * e + sacc[i][j];
        }
    }
  }
  __syncthreads();
  float* st = state + (long long)bh * P * N;
  for (int i = tid; i < P * N; i += kThreads) st[i] = ss[(i / N) * Sm::kNS + i % N];
}

template <typename T, int P, int N>
int launch_typed(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, int batch, int heads,
                 int groups, int len, int chunk, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, P, N>;
  const int bytes = Smem<P, N>::bytes(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch * heads, kThreads, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)state, heads, groups, len, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(int p, int n, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, void* state,
                 int batch, int heads, int groups, int len, int chunk,
                 cudaStream_t stream) {
#define SSD_SHAPE(PP, NN)                                                    \
  if (p == PP && n == NN)                                                    \
    return launch_typed<T, PP, NN>(x, dt, A, Bm, Cm, y, state, batch, heads, \
                                   groups, len, chunk, stream);
  SSD_SHAPE(16, 8)
  SSD_SHAPE(32, 16)
  SSD_SHAPE(32, 64)
  SSD_SHAPE(64, 32)
  SSD_SHAPE(64, 128)
#undef SSD_SHAPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [B, H, L, P] and y in one dtype (0: fp32, 1: bf16), dt [B, H, L] fp32,
// A [H] fp32, Bm and Cm [B, G, L, N] in x's dtype, state [B, H, P, N] fp32,
// all contiguous.  G must divide H and chunk divide L, 1 <= chunk <= 256.
// Returns cudaGetLastError() after the launch (0 on success), or an
// argument error without launching.  The kernel runs on `stream` and does
// not synchronise.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* state,
                    int batch, int heads, int groups, int len, int p, int n,
                    int chunk, int dtype, void* stream) {
  if (batch < 1 || heads < 1 || groups < 1 || heads % groups || len < 1 ||
      chunk < 1 || chunk > kMaxChunk || len % chunk)
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_shape<float>(p, n, x, dt, A, Bm, Cm, y, state, batch, heads,
                               groups, len, chunk, st);
  if (dtype == 1)
    return launch_shape<__nv_bfloat16>(p, n, x, dt, A, Bm, Cm, y, state, batch,
                                       heads, groups, len, chunk, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
