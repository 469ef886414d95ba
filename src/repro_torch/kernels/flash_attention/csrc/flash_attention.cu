// Flash-attention prefill for Hopper (sm_90a), with a plain C interface
// loaded through ctypes.
//
// Replaces the Pallas kernel of
// src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_kernel     <- flash_attention (body _kernel), fp32 inputs
//   flash_attention_tc_kernel  <- the same, bf16 inputs
//
// For each batch row b, query head h (KV head h / G, G = H / KV) and query
// row i:
//
//   s[j]  = (q[b,h,i] . k[b,kv,j]) * scale       (scale = 1/sqrt(D))
//           masked to -1e30 where causal and i < j (top-left aligned, no
//           offset when Sq != Sk)
//   o     = sum_j exp(s[j] - m) v[b,kv,j] / max(l, 1e-30)   (in q's dtype)
//
// with m and l the running max and sum of an online softmax over key tiles,
// all in fp32, and the probabilities kept in fp32 for the p.v product, as
// the TPU kernel keeps them.  Causal key tiles past a query tile's last row
// are skipped: every row sees key 0 in the first tile, so its m is finite
// after it, and a fully masked tile would add exp(-1e30 - m) = 0 with a
// correction of 1, so skipping gives the TPU kernel's numbers.  Query tiles
// are scheduled heaviest (last) first.
//
// What bounds it on this card: operations.  The dtype picks the kernel.
//
// bf16 inputs: tensor cores (flash_attention_tc_kernel).  q.k^T of bf16
// values is exact on bf16 tensor cores with fp32 accumulation.  p stays
// fp32, and an fp32 p is the sum of three bf16 pieces, hi = bf16(p),
// mid = bf16(p - hi), lo = bf16(p - hi - mid) (3 x 8 significand bits, and
// bf16 has fp32's exponent range), each of whose products with a bf16 v is
// exact in fp32.  So p.v is three bf16 tensor-core products, hi.v + mid.v +
// lo.v, accumulated in fp32: the fp32 p.v up to summation order (and, for
// p below 2^-110, the bf16 subnormal grid, 2^-134 absolute).  At
// internlm2-1.8b's prefill shape (B 8, H 16, KV 8, S 512, D 128, causal)
// that is 17.2 GFLOP at 989 TFLOP/s (17 us) against 50 MB of q, k, v and o
// (15 us at 3.35 TB/s).  The design, after FlashAttention-3:
//
//   * one CTA owns one (b, h) and 128 query rows: two consumer warpgroups
//     of 64 rows each, and one producer warp;
//   * the producer issues TMA loads of the Q tile once and of 64-key K and V
//     tiles into a ring of kStages stages in shared memory, with full and
//     empty mbarriers; tiles are split into 64-column (128-byte) chunks in
//     the 128-byte swizzle that wgmma reads, and TMA fills rows past Sq or
//     Sk with zeros (the mask covers the keys);
//   * per key tile a consumer warpgroup computes S = Q.K^T with wgmma (A and
//     B from shared memory, K K-major as stored), then in fp32: the scale
//     after the product (folding it into q would round q), the causal and
//     ragged-edge mask, the online max, exp, the correction and l;
//   * S's accumulator layout is the A-fragment layout of the next wgmma, so
//     each 16-key slice of p becomes hi, mid and lo bf16 register fragments
//     and three register-A wgmmas against the same V tile (V read
//     transposed, MN-major) add into the fp32 output accumulator;
//   * the epilogue divides by max(l, 1e-30), rounds once to bf16, writes the
//     tile into the warpgroup's rows of the Q buffer and stores it by TMA
//     (rows past Sq are clipped).
//
// fp32 inputs: scalar fp32 FMAs (flash_attention_kernel).  fp32 q.k^T has no
// exact tensor-core route short of a nine-piece split, so both products run
// at the 67 TFLOP/s of fp32 FMAs (128 us at the shape above):
//
//   * one CUDA block (8 warps) owns one (b, h, 64-row query tile) and walks
//     the key tiles of 64 itself: the loop inside the block takes the place
//     of the TPU kernel's sequential grid axis, and (m, l, acc) live in
//     registers instead of VMEM scratch;
//   * the query tile and each key and value tile are staged in shared
//     memory, with row strides padded so that the 16 lanes reading 16
//     different rows hit 16 different banks;
//   * a thread owns 4 query rows and, for the scores, 4 key columns (every
//     16th), for the output 4 x D/16 columns (every 16th), so a row's max
//     and sum reduce over 16 lanes of one warp by shuffles, and the
//     correction of acc stays in the thread that owns it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Lets `kernel` use `bytes` of dynamic shared memory on the current device,
// asking the runtime once per device (`done` is the kernel's own bitmask).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// ---------------------------------------------------------------------------
// fp32 inputs: scalar kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;   // query rows a block owns
constexpr int kBlockK = 64;   // keys a block stages at a time
constexpr int kRows = 4;      // query rows a thread owns
constexpr int kLanes = 16;    // lanes that share a row group

// rows [row0, row0 + tile_rows) of a [n_rows, D] matrix into dst (row
// stride `stride` floats); rows at or past n_rows read as zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int row0, int n_rows, int tile_rows) {
  constexpr int kPerRow = D / 4;
  for (int c = threadIdx.x; c < tile_rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int e = (c % kPerRow) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      f = __ldg(reinterpret_cast<const float4*>(
          src + (long long)(row0 + r) * D + e));
    *reinterpret_cast<float4*>(dst + r * stride + e) = f;
  }
}
template <int D>
struct Smem {
  static constexpr int kQStride = D + 4;        // float4 rows, 16 banks apart
  static constexpr int kKStride = D + 4;
  static constexpr int kVStride = D;            // read along a row
  static constexpr int kPStride = kBlockK + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBlockQ * kQStride;
  static constexpr int kV = kK + kBlockK * kKStride;
  static constexpr int kP = kV + kBlockK * kVStride;
  static constexpr int kFloats = kP + kBlockQ * kPStride;
  static constexpr int kBytes = kFloats * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int heads, int groups, int s_q, int s_k, int causal,
                       float scale) {
  using S = Smem<D>;
  constexpr int kCols = D / kLanes;  // output columns a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + S::kQ;
  float* ks = smem + S::kK;
  float* vs = smem + S::kV;
  float* ps = smem + S::kP;

  const int n_qt = (s_q + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - blockIdx.y;  // heaviest causal tile first
  const int bh = blockIdx.x;             // b * heads + h
  const int b = bh / heads;
  const int h = bh % heads;
  const int kvh = b * (heads / groups) + h / groups;
  const int q0 = qt * kBlockQ;
  const float* qb = q + (long long)bh * s_q * D;
  const float* kb = k + (long long)kvh * s_k * D;
  const float* vb = v + (long long)kvh * s_k * D;

  const int tid = threadIdx.x;
  const int ty = tid / kLanes;   // row group: rows ty*4 .. ty*4+3
  const int tx = tid % kLanes;
  const int r0 = ty * kRows;

  load_tile<D>(qs, S::kQStride, qb, q0, s_q, kBlockQ);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (s_k + kBlockK - 1) / kBlockK;
  int last_kt = n_kt - 1;
  if (causal) {
    const int last_row = min(q0 + kBlockQ, s_q) - 1;
    last_kt = min(last_kt, last_row / kBlockK);
  }

  for (int kt = 0; kt <= last_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, S::kKStride, kb, k0, s_k, kBlockK);
    load_tile<D>(vs, S::kVStride, vb, k0, s_k, kBlockK);
    __syncthreads();

    // scores s[i][j] for rows r0 + i and keys k0 + tx + 16 j
    float s[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv4[4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * S::kQStride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(
            ks + (tx + kLanes * j) * S::kKStride + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv4[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv4[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv4[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv4[j].w, s[i][j]);
        }
    }

    // mask, online softmax per row, p into shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + kLanes * j;
        const bool ok = kpos < s_k && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(r0 + i) * S::kPStride + tx + kLanes * j] = p;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc[i][j] += sum_t p[r0+i][t] v[t][tx + 16 j]
#pragma unroll 2
    for (int t = 0; t < kBlockK; t += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * S::kPStride + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          vv[j] = vs[(t + u) * S::kVStride + tx + kLanes * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= s_q) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + ((long long)bh * s_q + qpos) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      o[tx + kLanes * j] = acc[i][j] * inv_l;
  }
}

template <int D>
int launch_scalar(const void* q, const void* k, const void* v, void* out,
                  int batch, int heads, int kv_heads, int s_q, int s_k,
                  int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<D>;
  const int bytes = Smem<D>::kBytes;
  static unsigned allowed = 0;
  cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (s_q + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, heads,
      heads / kv_heads, s_q, s_k, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBlockM = 128;             // query rows a CTA owns
constexpr int kWgRows = 64;              // query rows a consumer warpgroup owns
constexpr int kBlockN = 64;              // keys a stage holds
constexpr int kStages = 3;               // K/V stages in the ring
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kChunk = 64;               // bf16 columns of a 128-byte row
constexpr int kRowBytes = 128;

// Shared memory, in bytes from a 1024-aligned base: Q as D/64 column chunks
// of kBlockM rows, then kStages x (K tile, V tile), each as D/64 chunks of
// kBlockN rows, every chunk in TMA's 128-byte swizzle; then the mbarriers.
template <int D>
struct Smem {
  static constexpr int kChunks = D / kChunk;
  static constexpr int kQChunk = kBlockM * kRowBytes;
  static constexpr int kKVChunk = kBlockN * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTileBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kK = kQBytes;     // stage s: K at kK + 2 s kTileBytes
  static constexpr int kBar = kK + kStages * 2 * kTileBytes;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// box (c0, c1, c2) of a 3-d tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// wgmma's shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses to an accumulator across the
// asynchronous wgmma that writes it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void reg_fence(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (+)= A·B on a 64x64x16 tile: A and B K-major in shared memory
// (128-byte swizzle), scale_d 0 overwriting d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A·B on a 64x64x16 tile: A a bf16 register fragment, B in shared
// memory MN-major (read transposed; 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d += A·B on a 64x128x16 tile: A a bf16 register fragment, B in shared
// memory MN-major (read transposed; 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// (lo, hi) as bf16x2, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float low_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float high_bf16(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// fp32 (a, b) as three bf16x2 pieces with a = hi + mid + lo (and b) exactly:
// each residual is exact in fp32, and 3 x 8 significand bits cover fp32's 24
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(a, b);
  a -= low_bf16(hi);
  b -= high_bf16(hi);
  mid = pack_bf16(a, b);
  a -= low_bf16(mid);
  b -= high_bf16(mid);
  lo = pack_bf16(a, b);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n64(o, a, b);
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_n128(o, a, b);
}

// O += P.V over a 64-key tile (V at v_s), P as three bf16 pieces of each
// 16-key slice, one committed group of 12 wgmmas.  The caller's
// wgmma_fence covers the fragments, written before it.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2],
                                        const uint32_t (&hi)[4][4],
                                        const uint32_t (&mid)[4][4],
                                        const uint32_t (&lo)[4][4],
                                        uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t vd = smem_desc(v_s + kk * 16 * kRowBytes,
                                  Smem<D>::kKVChunk, 1024);
    wgmma_pv<D>(o, hi[kk], vd);
    wgmma_pv<D>(o, mid[kk], vd);
    wgmma_pv<D>(o, lo[kk], vd);
  }
  wgmma_commit();
}

// q [B*H, Sq, D], k and v [B*KV, Sk, D], o like q, all bf16, through 3-d
// tensor maps (D, rows, planes) with 64-column boxes: kBlockM rows for q,
// kBlockN for k and v, kWgRows for o.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap o_map,
                          int heads, int groups, int s_q, int s_k, int causal,
                          float scale) {
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + S::kBar;  // full[kStages], empty[kStages], q
  const uint32_t q_bar = bars + 16 * kStages;

  const int n_qt = (s_q + kBlockM - 1) / kBlockM;
  const int qt = n_qt - 1 - blockIdx.y;  // heaviest causal tile first
  const int bh = blockIdx.x;             // b * heads + h
  const int kvh = (bh / heads) * (heads / groups) + (bh % heads) / groups;
  const int q0 = qt * kBlockM;
  const int n_kt = (s_k + kBlockN - 1) / kBlockN;
  const int n_tiles =
      causal ? min(n_kt, (min(q0 + kBlockM, s_q) - 1) / kBlockN + 1) : n_kt;

  // the warp index through a shuffle, so the compiler sees it (and every
  // branch on it) as warp-uniform and need not serialize the wgmmas
  const int warp = __shfl_sync(kFull, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumers / 32);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(q_bar, S::kQBytes);
      for (int c = 0; c < S::kChunks; ++c)
        tma_load(base + c * S::kQChunk, &q_map, q_bar, c * kChunk, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(bars + 8 * (kStages + s), ((t / kStages) & 1) ^ 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t k_s = base + S::kK + s * 2 * S::kTileBytes;
        const uint32_t v_s = k_s + S::kTileBytes;
        mbar_expect_tx(full, 2 * S::kTileBytes);
        for (int c = 0; c < S::kChunks; ++c) {
          tma_load(k_s + c * S::kKVChunk, &k_map, full, c * kChunk,
                   t * kBlockN, kvh);
          tma_load(v_s + c * S::kKVChunk, &v_map, full, c * kChunk,
                   t * kBlockN, kvh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 .. row0 + 63; this thread holds rows
  // r_lo and r_lo + 8 and, of every 8-column block, columns col and col + 1
  const int wg = warp / 4;
  const int row0 = q0 + wg * kWgRows;
  const int lr = (warp % 4) * 16 + lane / 4;  // row within the warpgroup
  const int r_lo = row0 + lr;
  const int r_hi = r_lo + 8;
  const int col = 2 * (lane % 4);
  int my_tiles = 0;  // key tiles this warpgroup's rows see
  if (row0 < s_q)
    my_tiles = causal ? min(n_kt, (min(row0 + kWgRows, s_q) - 1) / kBlockN + 1)
                      : n_kt;
  const uint32_t q_wg = base + wg * kWgRows * kRowBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  if (my_tiles > 0) mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(bars + 8 * s, (t / kStages) & 1);
    if (t < my_tiles) {
      const uint32_t k_s = base + S::kK + s * 2 * S::kTileBytes;

      // S = Q.K^T
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const uint32_t off = (k % 4) * 32;  // 16 columns of a 128-byte row
        wgmma_ss_n64(sc,
                     smem_desc(q_wg + (k / 4) * S::kQChunk + off, 16, 1024),
                     smem_desc(k_s + (k / 4) * S::kKVChunk + off, 16, 1024),
                     k > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // scale, mask, online softmax; sc[4i + j] is (r_lo, key 8i + col + j),
      // sc[4i + 2 + j] is (r_hi, the same key)
      const int k0 = t * kBlockN;
      const bool edge =
          k0 + kBlockN > s_k || (causal && k0 + kBlockN - 1 > row0);
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = sc[4 * i + j] * scale;
          float b = sc[4 * i + 2 + j] * scale;
          if (edge) {
            const int key = k0 + 8 * i + col + j;
            if (key >= s_k || (causal && key > r_lo)) a = kNegInf;
            if (key >= s_k || (causal && key > r_hi)) b = kNegInf;
          }
          sc[4 * i + j] = a;
          sc[4 * i + 2 + j] = b;
          mx_lo = fmaxf(mx_lo, a);
          mx_hi = fmaxf(mx_hi, b);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo);
      const float mn_hi = fmaxf(m_hi, mx_hi);
      const float c_lo = expf(m_lo - mn_lo);
      const float c_hi = expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sc[4 * i + j] = expf(sc[4 * i + j] - mn_lo);
          sc[4 * i + 2 + j] = expf(sc[4 * i + 2 + j] - mn_hi);
          sum_lo += sc[4 * i + j];
          sum_hi += sc[4 * i + 2 + j];
        }
      }
      l_lo = l_lo * c_lo + sum_lo;  // this lane's share of the row sums
      l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= c_lo;
        o[4 * i + 1] *= c_lo;
        o[4 * i + 2] *= c_hi;
        o[4 * i + 3] *= c_hi;
      }

      // O += P.V with p in three exact bf16 pieces, all formed before the
      // fence from which wgmma reads its register operands
      uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split3(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r],
                 mid[kk][r], lo[kk][r]);
      reg_fence(o);
      reg_fence(hi);
      reg_fence(mid);
      reg_fence(lo);
      wgmma_fence();
      pv_tile<D>(o, hi, mid, lo, k_s + S::kTileBytes);
      wgmma_wait_all();
      reg_fence(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));  // stage s is free
  }
  if (my_tiles == 0) return;

  // o / max(l, 1e-30) as bf16 into this warpgroup's rows of the Q buffer, in
  // the 128-byte swizzle of o_map, then one TMA store per column chunk
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, off);
    l_hi += __shfl_xor_sync(kFull, l_hi, off);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f);
  const float d_hi = fmaxf(l_hi, 1e-30f);
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // Q read
  const uint32_t swz = (lr % 8) << 4;  // rows lr and lr + 8 share it
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const uint32_t chunk = q_wg + (i / 8) * S::kQChunk;
    const uint32_t byte = ((i % 8) * 16 + (lane % 4) * 4) ^ swz;
    const uint32_t lo_v = pack_bf16(o[4 * i] / d_lo, o[4 * i + 1] / d_lo);
    const uint32_t hi_v = pack_bf16(o[4 * i + 2] / d_hi, o[4 * i + 3] / d_hi);
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(chunk + lr * kRowBytes + byte), "r"(lo_v) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(chunk + (lr + 8) * kRowBytes + byte), "r"(hi_v)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < S::kChunks; ++c)
      tma_store(&o_map, q_wg + c * S::kQChunk, c * kChunk, row0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 [planes, rows, d] tensor as a 3-d map with boxes of 64 columns by
// box_rows rows, in the 128-byte swizzle, out-of-bounds rows read as zeros
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int d,
                int rows, long long planes, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int heads, int kv_heads, int s_q, int s_k, int causal, float scale,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map, o_map;
  const long long qp = (long long)batch * heads;
  const long long kp = (long long)batch * kv_heads;
  if (!tensor_map(&q_map, encode, q, D, s_q, qp, kBlockM) ||
      !tensor_map(&k_map, encode, k, D, s_k, kp, kBlockN) ||
      !tensor_map(&v_map, encode, v, D, s_k, kp, kBlockN) ||
      !tensor_map(&o_map, encode, out, D, s_q, qp, kWgRows))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_tc_kernel<D>;
  const int bytes = Smem<D>::kBytes;
  static unsigned allowed = 0;
  cudaError_t err = allow_smem(kernel, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (s_q + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, bytes, stream>>>(q_map, k_map, v_map, o_map, heads,
                                            heads / kv_heads, s_q, s_k, causal,
                                            scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// q [B, H, Sq, D], k and v [B, KV, Sk, D], all contiguous and 16-byte
// aligned, of one dtype (0: fp32, 1: bf16); out [B, H, Sq, D] in that
// dtype; D 64 or 128.  KV must divide H.  fp32 goes to the scalar kernel,
// bf16 to the tensor-core kernel.  Returns cudaGetLastError() after the
// launch (0 on success), or an argument error without launching.  The
// kernel runs on `stream` and does not synchronise.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int batch, int heads, int kv_heads,
                           int s_q, int s_k, int d_head, int causal, int dtype,
                           float scale, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || s_q < 1 ||
      s_k < 1 || (d_head != 64 && d_head != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * heads > 0x7fffffffLL ||
      (s_q + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return d_head == 64 ? launch_scalar<64>(q, k, v, out, batch, heads,
                                            kv_heads, s_q, s_k, causal, scale,
                                            st)
                        : launch_scalar<128>(q, k, v, out, batch, heads,
                                             kv_heads, s_q, s_k, causal, scale,
                                             st);
  return d_head == 64 ? tc::launch<64>(q, k, v, out, batch, heads, kv_heads,
                                       s_q, s_k, causal, scale, st)
                      : tc::launch<128>(q, k, v, out, batch, heads, kv_heads,
                                        s_q, s_k, causal, scale, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
