// Split-KV flash decode of one token, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces the Pallas kernel of
// src/repro/kernels/decode_attention/decode_attention.py:
//   decode_attention_kernel  <- decode_attention (body _kernel)
//
// For each batch row b and KV head kv, the G = H / KV query heads
// h = kv*G + g that share the head attend to the cache's valid prefix:
//
//   s[t]  = (q[b,h] . k[b,kv,t]) / sqrt(D)  for t < cache_len, else -1e30
//   out   = sum_t exp(s[t] - m) v[b,kv,t] / max(l, 1e-30)    (in q's dtype)
//   lse   = m + log(max(l, 1e-30))                            (fp32)
//
// with m = max_t s[t] and l = sum_t exp(s[t] - m), all in fp32, and p kept
// in fp32 for the p.v product as the TPU kernel keeps it.  cache_len = 0
// masks every position to -1e30, which gives the mean of V over the whole
// capacity S, as the reference does.
//
// What bounds it on this card: bytes.  A bf16 step reads 2 * cache_len * D
// * 2 bytes of K and V for each (b, kv) and does about 4 * G * cache_len * D
// FLOPs on them, G FLOPs a byte against the H100's ~295 (bf16 tensor cores)
// or 20 (fp32 FFMA) a byte, so the least time is those bytes over HBM's
// rate.  The design reads each K and V row once, with 16-byte loads, and
// keeps everything else on chip:
//
//   * one CUDA block (8 warps) owns one (b, kv) and holds its G query rows
//     in registers (the TPU kernel keeps them in VMEM);
//   * R = D / (16 bytes) lanes share one key row, each holding a 16-byte
//     slice; a warp covers 32 / R rows per load, and every R-lane "row
//     group" runs its own online softmax (m, l, acc) over the keys
//     t = group (mod groups), reducing its dot products with warp shuffles.
//     A lane owns acc[G][its slice of D];
//   * after the sweep the row groups merge their partials by lse weight,
//     inside a warp with shuffles, then across warps in shared memory.
//
// The TPU kernel carries (m, l, acc) across a sequential grid axis over KV
// blocks; here that axis is the loop inside the block.  cache_len is read
// from device memory (the counterpart of its SMEM scalar), so a decode loop
// launches the same kernel as the cache grows, with no host sync.  For
// cache_len >= 1 the sweep stops at cache_len, since the masked terms are
// exactly 0; the capacity S need not be a multiple of anything.  Splitting
// S across blocks to fill all 132 SMs at small batch, and cp.async/TMA
// pipelining, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // keys a row group loads before it computes
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Slice;  // 16 bytes of T, unpacked to fp32

template <>
struct Slice<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(uint4 w, float (&f)[4]) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Slice<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(uint4 w, float (&f)[8]) {
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

template <typename T, int G, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ len,
                        T* __restrict__ out, float* __restrict__ lse,
                        int s_cap, float scale) {
  constexpr int kVec = Slice<T>::kVec;
  constexpr int R = D / kVec;        // lanes that share one key row
  constexpr int kRowsPerWarp = 32 / R;
  constexpr int kGroups = kWarps * kRowsPerWarp;
  static_assert(D % kVec == 0 && R >= 1 && R <= 32 && 32 % R == 0,
                "D must be a multiple of 16 bytes and at most 32 of them");

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int bh = blockIdx.x;  // b * KV + kv
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = lane % R;     // this lane's 16-byte slice of a row
  const int grp = warp * kRowsPerWarp + lane / R;

  const long long base = (long long)bh * s_cap * D + c * kVec;
  const uint4* kb = reinterpret_cast<const uint4*>(k + base);
  const uint4* vb = reinterpret_cast<const uint4*>(v + base);
  constexpr int kRowStride = D / kVec;  // uint4s per row

  // q [B, H, D] with H = KV * G: this block's heads start at row bh * G.
  float qf[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 w = *reinterpret_cast<const uint4*>(
        q + ((long long)bh * G + g) * D + c * kVec);
    Slice<T>::unpack(w, qf[g]);
  }

  const int cache_len = *len;
  const int n = cache_len >= 1 ? min(cache_len, s_cap) : s_cap;

  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  const int steps = (n + kGroups * kUnroll - 1) / (kGroups * kUnroll);
  for (int it = 0; it < steps; ++it) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = (it * kUnroll + u) * kGroups + grp;
      if (t < n) {
        kr[u] = __ldg(kb + (long long)t * kRowStride);
        vr[u] = __ldg(vb + (long long)t * kRowStride);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = (it * kUnroll + u) * kGroups + grp;
      float kf[kVec], vf[kVec];
      Slice<T>::unpack(kr[u], kf);
      Slice<T>::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qf[g][e], kf[e], part);
#pragma unroll
        for (int off = R / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(kFull, part, off);
        if (t < n) {  // the same for all R lanes of the group
          const float s = t < cache_len ? part * scale : kNegInf;
          // one exp: exp(s - m) when m stays, exp(m - s) as the
          // correction of the old terms when s raises the max
          const float d = s - m[g];
          const float x = expf(-fabsf(d));
          const bool up = d > 0.f;
          const float corr = up ? x : 1.f;
          const float p = up ? 1.f : x;
          l[g] = fmaf(l[g], corr, p);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[g][e] = fmaf(p, vf[e], acc[g][e] * corr);
          m[g] = up ? s : m[g];
        }
      }
    }
  }

  // merge the row groups of a warp: lanes c, c + R, c + 2R, ... hold the
  // same slice of D for different keys
#pragma unroll
  for (int off = R; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn);
      const float b = expf(mo - mn);
      l[g] = l[g] * a + lo * b;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * b;
      }
      m[g] = mn;
    }
  }
  if (lane < R) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) sm_acc[warp][g][c * kVec + e] = acc[g][e];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps and normalise
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm_m[w][g] - mx);
      lt = fmaf(sm_l[w][g], wt, lt);
      at = fmaf(sm_acc[w][g][d], wt, at);
    }
    const float lc = fmaxf(lt, 1e-30f);
    const long long row = (long long)bh * G + g;
    out[row * D + d] = Slice<T>::store(at / lc);
    if (d == 0) lse[row] = mx + logf(lc);
  }
}

template <typename T, int G>
int launch_d(int d_head, const void* q, const void* k, const void* v,
             const int* len, void* out, float* lse, int blocks, int s_cap,
             float scale, cudaStream_t stream) {
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  T* ot = (T*)out;
  switch (d_head) {
    case 32:
      decode_attention_kernel<T, G, 32><<<blocks, kThreads, 0, stream>>>(
          qt, kt, vt, len, ot, lse, s_cap, scale);
      break;
    case 64:
      decode_attention_kernel<T, G, 64><<<blocks, kThreads, 0, stream>>>(
          qt, kt, vt, len, ot, lse, s_cap, scale);
      break;
    case 128:
      decode_attention_kernel<T, G, 128><<<blocks, kThreads, 0, stream>>>(
          qt, kt, vt, len, ot, lse, s_cap, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_g(int groups, int d_head, const void* q, const void* k,
             const void* v, const int* len, void* out, float* lse, int blocks,
             int s_cap, float scale, cudaStream_t stream) {
  switch (groups) {
    case 1:
      return launch_d<T, 1>(d_head, q, k, v, len, out, lse, blocks, s_cap,
                            scale, stream);
    case 2:
      return launch_d<T, 2>(d_head, q, k, v, len, out, lse, blocks, s_cap,
                            scale, stream);
    case 4:
      return launch_d<T, 4>(d_head, q, k, v, len, out, lse, blocks, s_cap,
                            scale, stream);
    case 8:
      return launch_d<T, 8>(d_head, q, k, v, len, out, lse, blocks, s_cap,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, KV*G, D], k and v [B, KV, S, D], all contiguous and 16-byte
// aligned, of one dtype (0: fp32, 1: bf16); len a device int32; out
// [B, KV*G, D] in that dtype; lse fp32 [B, KV*G].  Returns
// cudaGetLastError() after the launch (0 on success), or an argument error
// without launching.  The kernel runs on `stream` and does not synchronise.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* len, void* out, void* lse, int batch,
                            int kv_heads, int groups, int s_cap, int d_head,
                            int dtype, float scale, void* stream) {
  if (batch < 1 || kv_heads < 1 || s_cap < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)batch * kv_heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_g<float>(groups, d_head, q, k, v, (const int*)len, out,
                           (float*)lse, (int)blocks, s_cap, scale, st);
  if (dtype == 1)
    return launch_g<__nv_bfloat16>(groups, d_head, q, k, v, (const int*)len,
                                   out, (float*)lse, (int)blocks, s_cap,
                                   scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
