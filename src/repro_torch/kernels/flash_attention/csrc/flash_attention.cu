// Flash-attention prefill for Hopper (sm_90a), with a plain C interface
// loaded through ctypes.
//
// Replaces the Pallas kernel of
// src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_kernel  <- flash_attention (body _kernel)
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
// the TPU kernel keeps them.
//
// What bounds it on this card: operations.  At the serving prefill shape
// (B 8, H 16, KV 8, S 512, D 128, causal) the kernel must move ~50 MB of
// q, k, v and o (15 us at 3.35 TB/s in bf16) and do 8.6 GFLOP of products:
// 128 us with both at the 67 TFLOP/s of fp32 FMAs, as fp32 inputs need, or
// 69 us for bf16 inputs, whose q.k half is exact on bf16 tensor cores (989
// TFLOP/s) while p.v stays fp32.  The design keeps every intermediate on
// chip and feeds the FMAs from shared memory:
//
//   * one CUDA block (8 warps) owns one (b, h, 64-row query tile) and walks
//     the key tiles of 64 itself: the loop inside the block takes the place
//     of the TPU kernel's sequential grid axis, and (m, l, acc) live in
//     registers instead of VMEM scratch;
//   * the query tile and each key and value tile are staged in shared
//     memory as fp32 (bf16 inputs are widened exactly), with row strides
//     padded so that the 16 lanes reading 16 different rows hit 16
//     different banks;
//   * a thread owns 4 query rows and, for the scores, 4 key columns (every
//     16th), for the output 4 x D/16 columns (every 16th), so a row's max
//     and sum reduce over 16 lanes of one warp by shuffles, and the
//     correction of acc stays in the thread that owns it;
//   * causal key tiles past the query tile's last row are skipped: every
//     row sees key 0 in the first tile, so its m is finite after it, and a
//     fully masked tile would add exp(-1e30 - m) = 0 with a correction of 1,
//     so skipping gives the same numbers as the TPU kernel, which runs them;
//   * query tiles are scheduled heaviest (last) first for the causal case.
//
// Scalar fp32 FMAs throughout; tensor cores (wgmma for bf16 inputs), a
// cp.async/TMA pipeline and a warp-specialised layout are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;   // query rows a block owns
constexpr int kBlockK = 64;   // keys a block stages at a time
constexpr int kRows = 4;      // query rows a thread owns
constexpr int kLanes = 16;    // lanes that share a row group
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;  // 16 bytes of T, widened to fp32

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(uint4 w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(uint4 w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

// rows [row0, row0 + tile_rows) of a [n_rows, D] matrix into dst (fp32,
// row stride `stride` floats); rows at or past n_rows read as zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int row0, int n_rows, int tile_rows) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kPerRow = D / kN;
  for (int c = threadIdx.x; c < tile_rows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int e = (c % kPerRow) * kN;
    float f[kN];
    if (row0 + r < n_rows) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * D + e));
      Vec<T>::unpack(w, f);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) f[i] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * stride + e);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i)
      d[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
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
  const T* qb = q + (long long)bh * s_q * D;
  const T* kb = k + (long long)kvh * s_k * D;
  const T* vb = v + (long long)kvh * s_k * D;

  const int tid = threadIdx.x;
  const int ty = tid / kLanes;   // row group: rows ty*4 .. ty*4+3
  const int tx = tid % kLanes;
  const int r0 = ty * kRows;

  load_tile<T, D>(qs, S::kQStride, qb, q0, s_q, kBlockQ);

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
    load_tile<T, D>(ks, S::kKStride, kb, k0, s_k, kBlockK);
    load_tile<T, D>(vs, S::kVStride, vb, k0, s_k, kBlockK);
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
    T* o = out + ((long long)bh * s_q + qpos) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      o[tx + kLanes * j] = Vec<T>::store(acc[i][j] * inv_l);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int batch, int heads, int kv_heads, int s_q, int s_k,
                 int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const int bytes = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (s_q + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, heads,
      heads / kv_heads, s_q, s_k, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d_head, const void* q, const void* k, const void* v,
             void* out, int batch, int heads, int kv_heads, int s_q, int s_k,
             int causal, float scale, cudaStream_t stream) {
  switch (d_head) {
    case 64:
      return launch_typed<T, 64>(q, k, v, out, batch, heads, kv_heads, s_q,
                                 s_k, causal, scale, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, out, batch, heads, kv_heads, s_q,
                                  s_k, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, Sq, D], k and v [B, KV, Sk, D], all contiguous and 16-byte
// aligned, of one dtype (0: fp32, 1: bf16); out [B, H, Sq, D] in that
// dtype.  KV must divide H.  Returns cudaGetLastError() after the launch (0
// on success), or an argument error without launching.  The kernel runs on
// `stream` and does not synchronise.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int batch, int heads, int kv_heads,
                           int s_q, int s_k, int d_head, int causal, int dtype,
                           float scale, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || s_q < 1 ||
      s_k < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * heads > 0x7fffffffLL || (s_q + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(d_head, q, k, v, out, batch, heads, kv_heads, s_q,
                           s_k, causal, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d_head, q, k, v, out, batch, heads,
                                   kv_heads, s_q, s_k, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
