// Chunked SSD scan (Mamba-2) for Hopper (sm_90a), with a plain C interface
// loaded through ctypes.
//
// Replaces the Pallas kernel of src/repro/kernels/ssd_scan/ssd_scan.py:
//   ssd_scan (body _kernel)  <-  the four kernels below, launched in order
//
// For each batch row b and head h (B and C of group g = h / (H / G)), the
// sequence is cut into nc chunks of Q positions.  Per chunk c, with
// l = cumsum(dt A) inside the chunk and decay(v) = exp(clip(v, -60, 0)):
//
//   CB[t,s]  = C[t] . B[s]                                 (per group)
//   S_c      = sum_s (x[s] w[s])^T B[s],  w[s] = decay(l[Q-1] - l[s]) dt[s]
//   S_prev[0] = 0,  S_prev[c+1] = S_prev[c] decay(l_c[Q-1]) + S_c
//   y[t]     = sum_{s<=t} CB[t,s] decay(l[t] - l[s]) (x[s] dt[s])
//              + decay(l[t]) (C[t] . S_prev[c]^T)
//
// in fp32; y is written in x's dtype and the final state (S_prev[nc]) in
// fp32.  The TPU kernel walks the chunks of one (b, h) in order, carrying
// the state in VMEM.  Here the scan takes its plain version's decomposition
// (models/mamba2.py::ssd_chunked, the reference's Listing-1 form) across
// the card, and only the state passing walks the chunks in order,
// elementwise:
//
//   a. ssd_cb_kernel, one block per (b, g, chunk, 64-row tile of t): CB over
//      the causal tiles (s-tiles up to the t-tile), once per group, into
//      scratch CB [B, G, nc, Q, Q].
//   b. ssd_state_kernel, one block per (b, h, chunk): l, in the plain
//      version's association (chunk_cumsum: sequential within blocks of 16,
//      one thread a block, then each block plus the in-order sum of the
//      totals before it, one thread a carry), into scratch l [B, H, nc, Q];
//      and S_c into scratch S [B, H, nc, P, N].
//   c. ssd_pass_kernel, one block per (b, h, 1024 of the P N elements): walks
//      the chunks in order and overwrites S_c with S_prev[c] in place (the
//      plain version's roundings: a product, then a sum); writes the final
//      state.
//   d. ssd_out_kernel, one block per (b, h, chunk, 64-row tile of t), the
//      H / G heads of one group and chunk next to one another, so that
//      their reads of CB hit L2: y as above (no C . S_prev term for chunk
//      0, whose S_prev is zero).
//
// The products.  bf16 inputs run all four on tensor cores (mma.sync
// m16n8k16, bf16 x bf16 -> fp32).  C . B multiplies bf16 by bf16: exact
// products.  The other three have one fp32 operand (w B in b; S_prev, and
// CB decay dt in d), which split3 cuts exactly into three bf16 pieces, so
// each of their products is three exact ones, and only the order of the
// fp32 sums differs from the plain version (as flash_attention.cu splits
// p).  In d, dt moves from x to M and decay(l[t]) scales C . S_prev after
// the product: a rounding apart each.  fp32 inputs run register-tiled fp32
// FMAs over operands staged in shared memory in slices of 32 along the
// contracted dimension, C . B included.  No TF32: the reference holds y to
// 1e-5 in fp32.
//
// What bounds it on this card: operations.  At mamba2-370m's prefill shape
// (B 8, H 32, G 1, L 512, P 64, N 128, chunk 256, bf16) the kernels run
// 19.5 GFLOP of tensor-core products (C . B once, 0.14, and the fp32
// products, 6.45, three times): 0.020 ms at 989 TFLOP/s, against 44.6 MB of
// inputs and outputs (13 us at 3.35 TB/s) and ~25 MB of scratch written and
// read again, mostly in L2.  What is done per element outside the tensor
// cores (the exp of each decay, the splits, the staging) is not in that
// bound; PERF.md has the times by phase.  At B 1, L 16384 phases a, b, c
// and d launch 256, 2048, 256 and 8192 blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;        // a, c, and b on tensor cores
constexpr int kStateThreads = 128;   // b in fp32: 64 x 128, 8 x 8 a thread
constexpr int kOutThreads = 64;      // d in fp32: 64 x 64, 8 x 8 a thread
constexpr int kOutMmaThreads = 128;  // d on tensor cores: 4 warps
constexpr int kTile = 64;     // rows of t that a block of phases a and d owns
constexpr int kSlice = 32;    // depth of one staged slice of a product
constexpr int kScanBlock = 16;
constexpr int kMaxChunk = kScanBlock * kScanBlock;  // two levels of the scan
constexpr int kAhead = 8;     // chunks whose loads phase c issues together

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float decay(float v) {  // exp(clip(v, -60, 0))
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

// 4 consecutive elements from 16-byte (fp32) or 8-byte (bf16) aligned p
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// How Th threads cover an R x W fp32 product: CL column lanes and RG row
// groups.  A thread owns TR = 4 TRQ consecutive rows (from TR ty) and TWQ
// quads of 4 consecutive columns (quad tx + CL j), up to 8 x 8, and reads
// its rows and its columns with one 16-byte load each a quad.
template <int R, int W, int Th>
struct Tiling {
  static constexpr int RQ = R / 4, WQ = W / 4;
  static constexpr int TWQ = WQ < 2 ? WQ : 2;
  static constexpr int CL = WQ / TWQ;
  static constexpr int RG = RQ < Th / CL ? RQ : Th / CL;
  static constexpr int TRQ = RQ / RG;
  static constexpr int TR = 4 * TRQ, TW = 4 * TWQ;
  static constexpr int kUsed = RG * CL;
  static_assert(R % 4 == 0 && W % 4 == 0 && RQ % RG == 0 && CL <= Th,
                "product shape does not tile over the block");
  static __device__ __forceinline__ int row(int i) {
    return TR * (threadIdx.x / CL) + i;
  }
  static __device__ __forceinline__ int col(int j) {
    return 4 * (threadIdx.x % CL + CL * (j / 4)) + j % 4;
  }
};

template <typename Tl>
__device__ __forceinline__ void zero(float (&acc)[Tl::TR][Tl::TW]) {
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TW; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < kSlice} a[k * lda + row(i)] * b[k * ldb + col(j)],
// for the threads that own outputs (threadIdx.x < kUsed, the caller's test)
template <typename Tl>
__device__ __forceinline__ void mm_slice(float (&acc)[Tl::TR][Tl::TW],
                                         const float* a, int lda,
                                         const float* b, int ldb) {
  const float* ap = a + Tl::TR * (threadIdx.x / Tl::CL);
  const float* bp = b + 4 * (threadIdx.x % Tl::CL);
#pragma unroll
  for (int k = 0; k < kSlice; ++k) {
    float av[Tl::TR], bv[Tl::TW];
#pragma unroll
    for (int i = 0; i < Tl::TRQ; ++i) {
      const float4 v = load4(ap + k * lda + 4 * i);
      av[4 * i] = v.x, av[4 * i + 1] = v.y, av[4 * i + 2] = v.z, av[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < Tl::TWQ; ++j) {
      const float4 v = load4(bp + k * ldb + 4 * Tl::CL * j);
      bv[4 * j] = v.x, bv[4 * j + 1] = v.y, bv[4 * j + 2] = v.z, bv[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TW; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Rows [0, kSlice) of a row-major [*, width] source (row stride width)
// into dst [kSlice][width + 4], each row scaled by scale[r] unless scale is
// null; rows at or past `valid` are zeros.  width is a multiple of 4.
template <int Th, int W>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int valid, const float* scale) {
  constexpr int kQ = W / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < kSlice * kQ; i += Th) {
    const int r = i / kQ, q = i % kQ;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      v = load4(src + (long long)r * W + 4 * q);
      if (scale != nullptr) {
        const float sc = scale[r];
        v.x *= sc, v.y *= sc, v.z *= sc, v.w *= sc;
      }
    }
    store4(dst + r * (W + 4) + 4 * q, v);
  }
}

// dst[c * ld + r] = src[r * sld + c0 + c] for r < rows (a multiple of 16),
// c < kSlice; zeros for r >= valid or c0 + c >= width (a multiple of 4).
// Lanes 0-15 take 16 consecutive rows: with ld = 4 mod 32 (and rows a
// multiple of 8) the 4-byte stores of a warp hit 32 banks.
template <int Th>
__device__ __forceinline__ void stage_cols(float* dst, int ld, const float* src,
                                           int sld, int rows, int valid,
                                           int c0, int width) {
  constexpr int cq = kSlice / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * cq; i += Th) {
    const int r = i % 16 + 16 * (i / (16 * cq));
    const int q = (i / 16) % cq;
    const int c = c0 + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && c < width) v = load4(src + (long long)r * sld + c);
    dst[(4 * q) * ld + r] = v.x;
    dst[(4 * q + 1) * ld + r] = v.y;
    dst[(4 * q + 2) * ld + r] = v.z;
    dst[(4 * q + 3) * ld + r] = v.w;
  }
}

// ---- phase a: C . B once per (b, g, chunk), over the causal tiles ----

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global src to shared dst when ok, else 16 zero bytes
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// B fragments of an m16n8k16 product (k16 x n8, "col") from a tile stored
// [k][n] (n contiguous): lanes 0-15 give the addresses of rows k0 .. k0+15
// at column n0, each row 16-byte aligned
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(p)));
}

// A fragments (m16 x k16, "row") from a tile stored [k][m] (m contiguous):
// lane l gives row k0 + 8 (l / 16) + l % 8 at column m0 + 8 ((l / 8) % 2)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// v = w[0] + w[1] + w[2] exactly, each a bf16 (as flash_attention.cu splits
// p; exact for |v| >= 2^-110, within 2^-134 below): the first piece is v
// rounded, and each difference is exact in fp32
__device__ __forceinline__ void split3(float v, bf16 (&w)[3]) {
  w[0] = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(w[0]);
  w[1] = __float2bfloat16_rn(r);
  w[2] = __float2bfloat16_rn(r - __bfloat162float(w[1]));
}

// the pieces of (a, b) as three bf16x2 words, a in the low half
__device__ __forceinline__ void split3_pair(float a, float b,
                                            uint32_t (&w)[3]) {
  bf16 pa[3], pb[3];
  split3(a, pa);
  split3(b, pb);
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = pack_bf16(pa[k], pb[k]);
}

// rows [0, 64) of a bf16 [rows, N] matrix into dst [64][ld] (ld = NP + 8
// elements), zeros at rows >= valid and columns >= N (up to NP)
template <int N, int NP>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           int valid) {
  constexpr int kLd = NP + 8, kGroups = NP / 8;
  for (int i = threadIdx.x; i < kTile * kGroups; i += kThreads) {
    const int r = i / kGroups, c = 8 * (i % kGroups);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < N)
      v = *reinterpret_cast<const uint4*>(src + (long long)r * N + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = v;
  }
}

// bf16 inputs: 8 warps over each 64 x 64 tile, warp w owning rows
// 16 (w % 4) .. + 16 and columns 32 (w / 4) .. + 32 (four m16n8k16 tiles)
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              float* __restrict__ cb, int chunk, int n_tiles) {
  constexpr int NP = (N + 15) / 16 * 16, kLd = NP + 8;
  __shared__ __align__(16) bf16 cs[kTile * kLd];
  __shared__ __align__(16) bf16 bs[kTile * kLd];
  const int tt = blockIdx.x % n_tiles;
  const long long bgc = blockIdx.x / n_tiles;  // (b * G + g) * nc + c
  const int t0 = tt * kTile;
  const bf16* bc = Bm + bgc * chunk * N;
  float* out = cb + bgc * chunk * chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = 16 * (warp % 4), n0 = 32 * (warp / 4);
  stage_bf16<N, NP>(cs, Cm + (bgc * chunk + t0) * N, chunk - t0);
  for (int s0 = 0; s0 <= t0; s0 += kTile) {
    __syncthreads();  // the previous tile's reads of bs are done
    stage_bf16<N, NP>(bs, bc + (long long)s0 * N, chunk - s0);
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < NP; k0 += 16) {
      const bf16* ap = cs + (m0 + gid) * kLd + k0 + 2 * tig;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ap),
                             *reinterpret_cast<const uint32_t*>(ap + 8 * kLd),
                             *reinterpret_cast<const uint32_t*>(ap + 8),
                             *reinterpret_cast<const uint32_t*>(ap + 8 * kLd + 8)};
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const bf16* bp = bs + (n0 + 8 * nb + gid) * kLd + k0 + 2 * tig;
        mma_bf16(acc[nb], a, *reinterpret_cast<const uint32_t*>(bp),
                 *reinterpret_cast<const uint32_t*>(bp + 8));
      }
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int s = s0 + n0 + 8 * nb + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + m0 + gid + 8 * half;
        if (t >= chunk) continue;
        if (s < chunk) out[(long long)t * chunk + s] = acc[nb][2 * half];
        if (s + 1 < chunk) out[(long long)t * chunk + s + 1] = acc[nb][2 * half + 1];
      }
    }
  }
}

// fp32 inputs: fp32 FMAs over slices of n (n, the state width, a multiple
// of 4)
__global__ void __launch_bounds__(kThreads, 1)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int n, int chunk, int n_tiles) {
  using Tl = Tiling<kTile, kTile, kThreads>;
  constexpr int kLd = kTile + 4;
  __shared__ __align__(16) float ct[kSlice * kLd];
  __shared__ __align__(16) float bt[kSlice * kLd];
  const int tt = blockIdx.x % n_tiles;
  const long long bgc = blockIdx.x / n_tiles;
  const int t0 = tt * kTile;
  const float* cc = Cm + (bgc * chunk + t0) * n;
  const float* bc = Bm + bgc * chunk * n;
  float* out = cb + bgc * chunk * chunk;
  for (int s0 = 0; s0 <= t0; s0 += kTile) {
    float acc[Tl::TR][Tl::TW];
    zero<Tl>(acc);
    for (int k0 = 0; k0 < n; k0 += kSlice) {
      __syncthreads();
      stage_cols<kThreads>(ct, kLd, cc, n, kTile, chunk - t0, k0, n);
      stage_cols<kThreads>(bt, kLd, bc + (long long)s0 * n, n, kTile,
                           chunk - s0, k0, n);
      __syncthreads();
      if (threadIdx.x < Tl::kUsed) mm_slice<Tl>(acc, ct, kLd, bt, kLd);
    }
    if (threadIdx.x < Tl::kUsed) {
#pragma unroll
      for (int i = 0; i < Tl::TR; ++i) {
        const int t = t0 + Tl::row(i);
        if (t >= chunk) continue;
#pragma unroll
        for (int j = 0; j < Tl::TW; ++j) {
          const int s = s0 + Tl::col(j);
          if (s < chunk) out[(long long)t * chunk + s] = acc[i][j];
        }
      }
    }
  }
}

// ---- phase b: l and the chunk's own state S_c, per (b, h, chunk) ----

// ls[i] = cumsum(dts[i] * a) over the chunk in chunk_cumsum's association
// (models/mamba2.py): dA rounded first, sequential within blocks of 16, then
// each element of block k >= 1 plus carry[k], the in-order sum of the
// totals of blocks 0 .. k-1.  One thread a block, then one a carry.
template <int Th>
__device__ __forceinline__ void chunk_cumsum(float* ls, float* carry,
                                             const float* dts, float a,
                                             int chunk) {
  const int tid = threadIdx.x;
  const int nb = (chunk + kScanBlock - 1) / kScanBlock;
  if (tid < nb) {
    const int i0 = tid * kScanBlock, i1 = min(chunk, i0 + kScanBlock);
    float run = __fmul_rn(dts[i0], a);
    ls[i0] = run;
    for (int i = i0 + 1; i < i1; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[i], a));
      ls[i] = run;
    }
  }
  __syncthreads();
  if (tid >= 1 && tid < nb) {  // blocks 0 .. nb-2 are full
    float c = ls[kScanBlock - 1];
    for (int k = 1; k < tid; ++k) c = __fadd_rn(c, ls[k * kScanBlock + kScanBlock - 1]);
    carry[tid] = c;
  }
  __syncthreads();
  for (int i = kScanBlock + tid; i < chunk; i += Th)
    ls[i] = __fadd_rn(carry[i / kScanBlock], ls[i]);
  __syncthreads();
}

// fp32 inputs: register-tiled fp32 FMAs.
template <int P, int N>
__global__ void __launch_bounds__(kStateThreads, 1)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ lbuf, float* __restrict__ sbuf, int heads,
                 int groups, int nc, int chunk) {
  constexpr int Th = kStateThreads;
  using Tl = Tiling<P, N, Th>;
  __shared__ float dts[kMaxChunk], ls[kMaxChunk], ws[kMaxChunk];
  __shared__ float carry[kScanBlock];
  __shared__ __align__(16) float xs[kSlice * (P + 4)];
  __shared__ __align__(16) float bs[kSlice * (N + 4)];
  const long long bhc = blockIdx.x;  // (b * H + h) * nc + c
  const long long bh = bhc / nc;
  const int c = bhc % nc, h = bh % heads;
  const long long b = bh / heads;
  const long long bgc = (b * groups + h / (heads / groups)) * nc + c;
  const int tid = threadIdx.x;
  const float* xc = x + bhc * chunk * P;
  const float* bc = Bm + bgc * chunk * N;

  for (int i = tid; i < chunk; i += Th) dts[i] = dt[bhc * chunk + i];
  __syncthreads();
  chunk_cumsum<Th>(ls, carry, dts, A[h], chunk);
  const float l_last = ls[chunk - 1];
  for (int i = tid; i < chunk; i += Th) {
    lbuf[bhc * chunk + i] = ls[i];
    ws[i] = decay(l_last - ls[i]) * dts[i];
  }
  float acc[Tl::TR][Tl::TW];
  zero<Tl>(acc);
  for (int s0 = 0; s0 < chunk; s0 += kSlice) {
    __syncthreads();  // ws is written; the previous slice is read
    stage_rows<Th, P>(xs, xc + (long long)s0 * P, chunk - s0, ws + s0);
    stage_rows<Th, N>(bs, bc + (long long)s0 * N, chunk - s0, nullptr);
    __syncthreads();
    if (tid < Tl::kUsed) mm_slice<Tl>(acc, xs, P + 4, bs, N + 4);
  }
  if (tid < Tl::kUsed) {
    float* out = sbuf + bhc * P * N;
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int j = 0; j < Tl::TW; j += 4)
        store4(out + Tl::row(i) * N + Tl::col(j),
               make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]));
  }
}

// bf16 inputs: tensor cores.  S_c[p][n] = sum_s x[s][p] (w[s] B[s][n]): A =
// x^T, exact in bf16 (ldmatrix.trans from x's rows), and B = w B in fp32,
// split into three bf16 pieces, each product exact, so only the summation
// order differs from fp32 FMAs.  8 warps over P x N: warp w owns rows
// 16 (w % (P / 16)) .. + 16 and NT n8 tiles from NT (w / (P / 16)).
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 3)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ lbuf, float* __restrict__ sbuf, int heads,
                 int groups, int nc, int chunk) {
  constexpr int kLx = P + 8, kLw = N + 8;  // row strides, 16-byte multiples
  constexpr int kMT = P / 16, kUnits = kMT * (N / 8);
  constexpr int NT = kUnits >= 8 ? kUnits / 8 : 1;
  static_assert(P % 16 == 0 && N % 8 == 0 && kUnits % NT == 0, "shape");
  __shared__ float dts[kMaxChunk], ls[kMaxChunk], ws[kMaxChunk];
  __shared__ float carry[kScanBlock];
  __shared__ __align__(16) bf16 xs[kSlice * kLx];
  __shared__ __align__(16) bf16 wb[3][kSlice * kLw];
  const long long bhc = blockIdx.x;  // (b * H + h) * nc + c
  const long long bh = bhc / nc;
  const int c = bhc % nc, h = bh % heads;
  const long long b = bh / heads;
  const long long bgc = (b * groups + h / (heads / groups)) * nc + c;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const bf16* xc = x + bhc * chunk * P;
  const bf16* bc = Bm + bgc * chunk * N;

  for (int i = tid; i < chunk; i += kThreads) dts[i] = dt[bhc * chunk + i];
  __syncthreads();
  chunk_cumsum<kThreads>(ls, carry, dts, A[h], chunk);
  const float l_last = ls[chunk - 1];
  for (int i = tid; i < chunk; i += kThreads) {
    lbuf[bhc * chunk + i] = ls[i];
    ws[i] = decay(l_last - ls[i]) * dts[i];
  }

  const bool active = warp < kUnits / NT;
  const int m0 = 16 * (warp % kMT), nt0 = NT * (warp / kMT);
  float acc[NT][4] = {};
  for (int s0 = 0; s0 < chunk; s0 += kSlice) {
    __syncthreads();  // ws is written; the previous slice is read
    for (int i = tid; i < kSlice * P / 8; i += kThreads) {
      const int r = i / (P / 8), cc = 8 * (i % (P / 8));
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s0 + r < chunk)
        v = *reinterpret_cast<const uint4*>(xc + (long long)(s0 + r) * P + cc);
      *reinterpret_cast<uint4*>(xs + r * kLx + cc) = v;
    }
    for (int i = tid; i < kSlice * N / 4; i += kThreads) {
      const int r = i / (N / 4), cc = 4 * (i % (N / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 + r < chunk) {
        v = load4(bc + (long long)(s0 + r) * N + cc);
        const float w = ws[s0 + r];
        v.x *= w, v.y *= w, v.z *= w, v.w *= w;
      }
      uint32_t lo[3], hi[3];
      split3_pair(v.x, v.y, lo);
      split3_pair(v.z, v.w, hi);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint2*>(wb[k] + r * kLw + cc) = make_uint2(lo[k], hi[k]);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 16) {
        uint32_t a[4];
        ldsm_x4_trans(a, xs + (kk + 8 * (lane / 16) + lane % 8) * kLx + m0 +
                             8 * ((lane / 8) % 2));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, wb[k] + (kk + lane % 16) * kLw + 8 * (nt0 + j));
            mma_bf16(acc[j], a, b0, b1);
          }
        }
      }
    }
  }
  if (active) {
    float* out = sbuf + bhc * P * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * (nt0 + j) + 2 * tig;
      *reinterpret_cast<float2*>(out + (m0 + gid) * N + n) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + (m0 + gid + 8) * N + n) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// ---- phase c: the states passed from chunk to chunk, per (b, h) ----

__global__ void __launch_bounds__(kThreads, 1)
ssd_pass_kernel(float* __restrict__ sbuf, const float* __restrict__ lbuf,
                float* __restrict__ state, int nc, int chunk, int quads,
                int slices) {
  const long long bh = blockIdx.x / slices;
  const int q = (blockIdx.x % slices) * kThreads + threadIdx.x;
  if (q >= quads) return;
  float4* s = reinterpret_cast<float4*>(sbuf) + bh * nc * quads + q;
  const float* l_last = lbuf + bh * nc * chunk + chunk - 1;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 v[kAhead];
    float e[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        v[i] = s[(long long)(c0 + i) * quads];
        e[i] = decay(l_last[(long long)(c0 + i) * chunk]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        s[(long long)(c0 + i) * quads] = run;  // S_prev of chunk c0 + i
        run.x = __fadd_rn(__fmul_rn(run.x, e[i]), v[i].x);
        run.y = __fadd_rn(__fmul_rn(run.y, e[i]), v[i].y);
        run.z = __fadd_rn(__fmul_rn(run.z, e[i]), v[i].z);
        run.w = __fadd_rn(__fmul_rn(run.w, e[i]), v[i].w);
      }
    }
  }
  reinterpret_cast<float4*>(state)[bh * quads + q] = run;
}

// ---- phase d: y, per (b, h, chunk, 64-row tile of t) ----

// y's product over one slice, 32 deep, of either kind: over n (chunks
// c > 0), A = decay(l[t]) C[t][n] and B = S_prev[p][n]; over s, A =
// CB[t][s] decay(l[t] - l[s]) for s <= t (else 0) and B = x[s][p] dt[s].
// Both operands are laid out contracted-dim-major (A and B over n
// transposed, with 16 consecutive rows on 16 lanes as in stage_cols), so y
// is one accumulator over both kinds: the C S_prev term is taken as
// (decay(l[t]) C[t]) . S_prev, not (C[t] . S_prev) decay(l[t]), a rounding
// apart.

template <int N>
__device__ __forceinline__ void stage_n(float* as, float* bs, const float* cc,
                                        const float* sp, const float* es,
                                        int n0, int rows, int p_dim) {
  constexpr int cq = kSlice / 4, kLa = kTile + 4;
  for (int i = threadIdx.x; i < kTile * cq; i += kOutThreads) {
    const int r = i % 16 + 16 * (i / (16 * cq)), q = (i / 16) % cq;
    const int n = n0 + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && n < N) v = load4(cc + (long long)r * N + n);
    const float e = es[r];
    as[(4 * q) * kLa + r] = v.x * e;
    as[(4 * q + 1) * kLa + r] = v.y * e;
    as[(4 * q + 2) * kLa + r] = v.z * e;
    as[(4 * q + 3) * kLa + r] = v.w * e;
  }
  stage_cols<kOutThreads>(bs, p_dim + 4, sp, N, p_dim, p_dim, n0, N);
}

template <int P>
__device__ __forceinline__ void stage_s(float* as, float* bs, const float* cbt,
                                        const float* xc, const float* ls,
                                        const float* dts, int s0, int t0,
                                        int rows, int chunk) {
  constexpr int cq = kSlice / 4, kLa = kTile + 4;
#pragma unroll 2
  for (int i = threadIdx.x; i < kTile * cq; i += kOutThreads) {
    const int r = i % 16 + 16 * (i / (16 * cq)), q = (i / 16) % cq;
    const int s = s0 + 4 * q, t = t0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows && s <= t) {
      const float* src = cbt + (long long)r * chunk + s;
      if (chunk % 4 == 0) {  // s <= t < chunk: all four in the chunk
        const float4 w = load4(src);
        v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (s + k <= t) v[k] = src[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      as[(4 * q + k) * kLa + r] =
          r < rows && s + k <= t ? v[k] * decay(ls[t] - ls[s + k]) : 0.f;
  }
  stage_rows<kOutThreads, P>(bs, xc + (long long)s0 * P, chunk - s0, dts + s0);
}

template <int P, int N>
__global__ void __launch_bounds__(kOutThreads, 1)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ lbuf, const float* __restrict__ sbuf,
               float* __restrict__ y, int heads, int groups, int nc, int chunk,
               int n_tiles) {
  using Tl = Tiling<kTile, P, kOutThreads>;
  __shared__ float ls[kMaxChunk], dts[kMaxChunk], es[kTile];
  __shared__ __align__(16) float as[kSlice * (kTile + 4)];
  __shared__ __align__(16) float bs[kSlice * (P + 4)];
  const int rep = heads / groups;
  long long i = blockIdx.x;  // (((b * G + g) * nc + c) * n_tiles + tt) * rep + hr
  const int hr = i % rep;
  i /= rep;
  const int tt = i % n_tiles;
  i /= n_tiles;
  const int c = i % nc;
  const long long bg = i / nc;
  const long long b = bg / groups;
  const int h = (bg % groups) * rep + hr;
  const long long bhc = (b * heads + h) * nc + c, bgc = bg * nc + c;
  const int t0 = tt * kTile, rows = min(kTile, chunk - t0);
  const int tid = threadIdx.x;
  // the last row this thread owns: a slice of s past it adds only zeros
  const int t_last = t0 + Tl::row(Tl::TR - 1);

  // the whole chunk: the last slice of s may reach past the tile's rows,
  // where A is zero but x dt is still staged
  for (int j = tid; j < chunk; j += kOutThreads) {
    ls[j] = lbuf[bhc * chunk + j];
    dts[j] = dt[bhc * chunk + j];
  }
  __syncthreads();
  for (int j = tid; j < kTile; j += kOutThreads)
    es[j] = decay(ls[min(t0 + j, chunk - 1)]);

  float acc[Tl::TR][Tl::TW];
  zero<Tl>(acc);
  if (c > 0) {  // S_prev of chunk 0 is zero
    const float* cc = Cm + (bgc * chunk + t0) * N;
    const float* sp = sbuf + bhc * P * N;  // S_prev of this chunk (phase c)
    for (int n0 = 0; n0 < N; n0 += kSlice) {
      __syncthreads();  // es is written; the previous slice is read
      stage_n<N>(as, bs, cc, sp, es, n0, rows, P);
      __syncthreads();
      if (tid < Tl::kUsed) mm_slice<Tl>(acc, as, kTile + 4, bs, P + 4);
    }
  }
  const float* cbt = cb + (bgc * chunk + t0) * chunk;
  const float* xc = x + bhc * chunk * P;
  for (int s0 = 0; s0 < t0 + rows; s0 += kSlice) {
    __syncthreads();
    stage_s<P>(as, bs, cbt, xc, ls, dts, s0, t0, rows, chunk);
    __syncthreads();
    if (tid < Tl::kUsed && s0 <= t_last)
      mm_slice<Tl>(acc, as, kTile + 4, bs, P + 4);
  }

  if (tid < Tl::kUsed) {
    float* yc = y + (bhc * chunk + t0) * P;
#pragma unroll
    for (int i2 = 0; i2 < Tl::TR; ++i2) {
      const int r = Tl::row(i2);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < Tl::TW; j += 4)
        store4(yc + (long long)r * P + Tl::col(j),
               make_float4(acc[i2][j], acc[i2][j + 1], acc[i2][j + 2],
                           acc[i2][j + 3]));
    }
  }
}

// bf16 inputs: tensor cores, 4 warps over a 64 x P tile of y, warp w owning
// rows 16 w .. + 16 and every n8 tile of P.  First C . S_prev^T over slices
// of 32 n: A = C, exact in bf16; B = S_prev, split into three bf16 pieces;
// the sum is then scaled by decay(l[t]) in registers.  Then, over slices of
// 32 s, A = CB[t][s] decay(l[t] - l[s]) dt[s] for s <= t, computed by each
// thread for its own fragment elements straight from CB, split into three
// pieces, and B = x, exact (ldmatrix.trans from x's rows): the dt factor
// moves from x to M, a rounding apart from the plain version's M (x dt).
// The slices of CB and x stream through a two-stage cp.async ring (CB by
// 16-byte copies when chunk is a multiple of 4, else by plain loads), in
// the shared memory that the slices of n used.  A warp skips the steps of
// s past its last row.
template <int P, int N>
__global__ void __launch_bounds__(kOutMmaThreads)
ssd_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const bf16* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ lbuf, const float* __restrict__ sbuf,
               bf16* __restrict__ y, int heads, int groups, int nc, int chunk,
               int n_tiles) {
  constexpr int kNT = P / 8, kLn = kSlice + 8, kLx = P + 8, kLc = kSlice + 4;
  static_assert(P % 16 == 0 && N % 8 == 0, "shape");
  // the slices of n: C [t][n] and S_prev's pieces [p][n], bf16; then a ring
  // of two stages of x [s][p] (bf16) and CB [t][s] (fp32)
  constexpr int kNBytes = (kTile + 3 * P) * kLn * 2;
  constexpr int kXBytes = kSlice * kLx * 2;
  constexpr int kStage = kXBytes + kTile * kLc * 4;
  constexpr int kPool = kNBytes > 2 * kStage ? kNBytes : 2 * kStage;
  __shared__ float ls[kMaxChunk], dts[kMaxChunk], es[kTile];
  __shared__ __align__(16) unsigned char pool[kPool];
  bf16* cs = reinterpret_cast<bf16*>(pool);
  bf16* const sp[3] = {cs + kTile * kLn, cs + (kTile + P) * kLn,
                       cs + (kTile + 2 * P) * kLn};
  const int rep = heads / groups;
  long long i = blockIdx.x;  // (((b * G + g) * nc + c) * n_tiles + tt) * rep + hr
  const int hr = i % rep;
  i /= rep;
  const int tt = i % n_tiles;
  i /= n_tiles;
  const int c = i % nc;
  const long long bg = i / nc;
  const long long b = bg / groups;
  const int h = (bg % groups) * rep + hr;
  const long long bhc = (b * heads + h) * nc + c, bgc = bg * nc + c;
  const int t0 = tt * kTile, rows = min(kTile, chunk - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4, m0 = 16 * warp;

  for (int j = tid; j < chunk; j += kOutMmaThreads) {
    ls[j] = lbuf[bhc * chunk + j];
    dts[j] = dt[bhc * chunk + j];
  }
  __syncthreads();
  for (int j = tid; j < kTile; j += kOutMmaThreads)
    es[j] = decay(ls[min(t0 + j, chunk - 1)]);

  float acc[kNT][4] = {};
  if (c > 0) {  // S_prev of chunk 0 is zero
    const bf16* cc = Cm + (bgc * chunk + t0) * N;
    const float* spg = sbuf + bhc * P * N;  // S_prev of this chunk (phase c)
    for (int n0 = 0; n0 < N; n0 += kSlice) {
      __syncthreads();  // the previous slice is read
      for (int j = tid; j < kTile * kSlice / 8; j += kOutMmaThreads) {
        const int r = j / (kSlice / 8), n = 8 * (j % (kSlice / 8));
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && n0 + n < N)
          v = *reinterpret_cast<const uint4*>(cc + (long long)r * N + n0 + n);
        *reinterpret_cast<uint4*>(cs + r * kLn + n) = v;
      }
      for (int j = tid; j < P * kSlice / 4; j += kOutMmaThreads) {
        const int p = j / (kSlice / 4), n = 4 * (j % (kSlice / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n0 + n < N) v = load4(spg + p * N + n0 + n);
        uint32_t lo[3], hi[3];
        split3_pair(v.x, v.y, lo);
        split3_pair(v.z, v.w, hi);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint2*>(sp[k] + p * kLn + n) = make_uint2(lo[k], hi[k]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 16) {
        if (n0 + kk >= N) break;
        const bf16* ap = cs + (m0 + gid) * kLn + kk + 2 * tig;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ap),
                               *reinterpret_cast<const uint32_t*>(ap + 8 * kLn),
                               *reinterpret_cast<const uint32_t*>(ap + 8),
                               *reinterpret_cast<const uint32_t*>(ap + 8 * kLn + 8)};
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const bf16* bp = sp[k] + (8 * j + gid) * kLn + kk + 2 * tig;
            mma_bf16(acc[j], a, *reinterpret_cast<const uint32_t*>(bp),
                     *reinterpret_cast<const uint32_t*>(bp + 8));
          }
        }
      }
    }
    const float ea = es[m0 + gid], eb = es[m0 + gid + 8];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[j][0] *= ea, acc[j][1] *= ea;
      acc[j][2] *= eb, acc[j][3] *= eb;
    }
  }

  // the fragment rows of this thread, and the last row of the warp
  const int ta = t0 + m0 + gid, tb = ta + 8;
  const int t_end = t0 + rows;  // rows at or past it are not in the chunk
  const int warp_last = min(t0 + m0 + 15, t_end - 1);
  const float* cbt = cb + (bgc * chunk + t0) * chunk;  // the tile's rows
  const bf16* xc = x + bhc * chunk * P;
  auto stage_x = [&](int st) {
    return reinterpret_cast<bf16*>(pool + st * kStage);
  };
  auto stage_cb = [&](int st) {
    return reinterpret_cast<float*>(pool + st * kStage + kXBytes);
  };
  // the slice of s from s0 into stage st: x's rows (zeros past the chunk)
  // and CB's tile rows by columns s0 .. s0 + 31, where a quad of them
  // reaches the causal edge
  auto issue = [&](int s0, int st) {
    if (s0 < t_end) {
      bf16* xs = stage_x(st);
      for (int j = tid; j < kSlice * P / 8; j += kOutMmaThreads) {
        const int r = j / (P / 8), c8 = 8 * (j % (P / 8));
        const bool ok = s0 + r < chunk;
        cp16(xs + r * kLx + c8, ok ? xc + (long long)(s0 + r) * P + c8 : xc, ok);
      }
      float* cbs = stage_cb(st);
      for (int j = tid; j < kTile * kSlice / 4; j += kOutMmaThreads) {
        const int r = j / (kSlice / 4), c4 = 4 * (j % (kSlice / 4));
        const float* src = cbt + (long long)r * chunk + s0 + c4;
        if (chunk % 4 == 0) {  // s0 + c4 <= t0 + r < chunk: all four in it
          const bool ok = r < rows && s0 + c4 <= t0 + r;
          cp16(cbs + r * kLc + c4, ok ? src : cbt, ok);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cbs[r * kLc + c4 + u] =
                r < rows && s0 + c4 + u <= t0 + r ? src[u] : 0.f;
        }
      }
    }
    cp_commit();
  };

  __syncthreads();  // the slices of n are read: the ring takes their place
  issue(0, 0);
  for (int s0 = 0, st = 0; s0 < t_end; s0 += kSlice, st ^= 1) {
    issue(s0 + kSlice, st ^ 1);
    cp_wait<1>();     // this slice's copies, this thread's
    __syncthreads();  // and every thread's
    const bf16* xs = stage_x(st);
    const float* cbs = stage_cb(st);
    // M'[t][s] = CB[t][s] decay(l[t] - l[s]) dt[s] for one fragment
    // element (0 past the causal edge)
    auto m_of = [&](int t, int sv) -> float {
      if (t >= t_end || sv > t) return 0.f;
      return cbs[(t - t0) * kLc + sv - s0] * decay(ls[t] - ls[sv]) * dts[sv];
    };
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16) {
      const int sv = s0 + kk + 2 * tig;
      if (s0 + kk > warp_last || t0 + m0 >= t_end) break;  // warp-uniform
      uint32_t a0[3], a1[3], a2[3], a3[3];
      split3_pair(m_of(ta, sv), m_of(ta, sv + 1), a0);
      split3_pair(m_of(tb, sv), m_of(tb, sv + 1), a1);
      split3_pair(m_of(ta, sv + 8), m_of(ta, sv + 9), a2);
      split3_pair(m_of(tb, sv + 8), m_of(tb, sv + 9), a3);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, xs + (kk + lane % 16) * kLx + 8 * j);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const uint32_t a[4] = {a0[k], a1[k], a2[k], a3[k]};
          mma_bf16(acc[j], a, b0, b1);
        }
      }
    }
    __syncthreads();  // the stage is free for the slice after next
  }

  bf16* yc = y + bhc * chunk * P;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int pcol = 8 * j + 2 * tig;
    if (ta < t_end)
      *reinterpret_cast<__nv_bfloat162*>(yc + (long long)ta * P + pcol) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (tb < t_end)
      *reinterpret_cast<__nv_bfloat162*>(yc + (long long)tb * P + pcol) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

struct Grid {
  long long cb, state, pass, out;
  int nc, n_tiles, quads, slices;
};

Grid grid_of(int batch, int heads, int groups, int len, int p, int n,
             int chunk) {
  Grid g;
  g.nc = len / chunk;
  g.n_tiles = (chunk + kTile - 1) / kTile;
  g.quads = p * n / 4;
  g.slices = (g.quads + kThreads - 1) / kThreads;
  g.cb = (long long)batch * groups * g.nc * g.n_tiles;
  g.state = (long long)batch * heads * g.nc;
  g.pass = (long long)batch * heads * g.slices;
  g.out = g.state * g.n_tiles;
  return g;
}

template <typename T, int P, int N>
int launch_typed(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, void* cb, void* lbuf,
                 void* sbuf, int batch, int heads, int groups, int len,
                 int chunk, cudaStream_t st) {
  const Grid g = grid_of(batch, heads, groups, len, P, N, chunk);
  if (g.out > 0x7fffffffLL || g.pass > 0x7fffffffLL || g.cb > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value)
    ssd_cb_kernel<N><<<(unsigned)g.cb, kThreads, 0, st>>>(
        (const bf16*)Bm, (const bf16*)Cm, (float*)cb, chunk, g.n_tiles);
  else
    ssd_cb_kernel<<<(unsigned)g.cb, kThreads, 0, st>>>(
        (const float*)Bm, (const float*)Cm, (float*)cb, N, chunk, g.n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (std::is_same<T, bf16>::value)
    ssd_state_kernel<P, N><<<(unsigned)g.state, kThreads, 0, st>>>(
        (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
        (float*)lbuf, (float*)sbuf, heads, groups, g.nc, chunk);
  else
    ssd_state_kernel<P, N><<<(unsigned)g.state, kStateThreads, 0, st>>>(
        (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
        (float*)lbuf, (float*)sbuf, heads, groups, g.nc, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_pass_kernel<<<(unsigned)g.pass, kThreads, 0, st>>>(
      (float*)sbuf, (const float*)lbuf, (float*)state, g.nc, chunk, g.quads,
      g.slices);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (std::is_same<T, bf16>::value)
    ssd_out_kernel<P, N><<<(unsigned)g.out, kOutMmaThreads, 0, st>>>(
        (const bf16*)x, (const float*)dt, (const bf16*)Cm, (const float*)cb,
        (const float*)lbuf, (const float*)sbuf, (bf16*)y, heads, groups,
        g.nc, chunk, g.n_tiles);
  else
    ssd_out_kernel<P, N><<<(unsigned)g.out, kOutThreads, 0, st>>>(
        (const float*)x, (const float*)dt, (const float*)Cm, (const float*)cb,
        (const float*)lbuf, (const float*)sbuf, (float*)y, heads, groups,
        g.nc, chunk, g.n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(int p, int n, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, void* state,
                 void* cb, void* lbuf, void* sbuf, int batch, int heads,
                 int groups, int len, int chunk, cudaStream_t stream) {
#define SSD_SHAPE(PP, NN)                                                   \
  if (p == PP && n == NN)                                                   \
    return launch_typed<T, PP, NN>(x, dt, A, Bm, Cm, y, state, cb, lbuf,    \
                                   sbuf, batch, heads, groups, len, chunk,  \
                                   stream);
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
// A [H] fp32, Bm and Cm [B, G, L, N] in x's dtype, state [B, H, P, N] fp32;
// scratch cb [B, G, nc, Q, Q], lbuf [B, H, nc, Q] and sbuf [B, H, nc, P, N],
// fp32, nc = L / Q, Q = chunk.  All contiguous; x, Bm, Cm 16-byte aligned.
// G must divide H and chunk divide L, 1 <= chunk <= 256.  Launches the four
// phases in order on `stream`, checks cudaGetLastError() after each, and
// returns the first nonzero code (0 on success), or an argument error
// without launching.  Does not synchronise.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* state,
                    void* cb, void* lbuf, void* sbuf, int batch, int heads,
                    int groups, int len, int p, int n, int chunk, int dtype,
                    void* stream) {
  if (batch < 1 || heads < 1 || groups < 1 || heads % groups || len < 1 ||
      chunk < 1 || chunk > kMaxChunk || len % chunk)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_shape<float>(p, n, x, dt, A, Bm, Cm, y, state, cb, lbuf,
                               sbuf, batch, heads, groups, len, chunk, st);
  if (dtype == 1)
    return launch_shape<bf16>(p, n, x, dt, A, Bm, Cm, y, state, cb, lbuf,
                              sbuf, batch, heads, groups, len, chunk, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
