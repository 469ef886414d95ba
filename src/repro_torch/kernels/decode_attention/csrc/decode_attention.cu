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
//
// cache_len is one length for the whole batch or one per batch row b (the
// continuous-batching scheduler's slots, what vmap over the TPU kernel
// gives each slot there); either way it stays in device memory.
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
// rate, and p.v stays scalar fp32.  The design reads each K and V row once
// and keeps as many bytes in flight as HBM needs:
//
//   * the grid is (B * KV, n_split): block (bh, j) sweeps one contiguous
//     range of split_keys keys of its (b, kv), clipped at the valid prefix
//     (the whole capacity when cache_len = 0).  The wrapper picks n_split
//     from the capacity, B * KV and the blocks the card holds at once,
//     never from cache_len, so cache_len stays in device memory (the
//     counterpart of the TPU kernel's SMEM scalar): no host sync, and the
//     same launch as the cache grows.
//     It takes as many splits as one resident wave of blocks holds
//     (decode_attention_blocks_per_sm says how many an SM holds), since a
//     short cache is a latency chain, which a second wave lengthens; and at
//     least enough for splits of at most 1024 keys, so that a long cache
//     runs as many short blocks, which leave no ragged last wave.  A block
//     whose range lies past the prefix writes an empty partial;
//   * one thread keeps a ring of kStages K and V tiles (16 KB each) in
//     flight with bulk copies (cp.async.bulk on the TMA engine, completing
//     on an mbarrier per stage) while the block computes on the oldest;
//   * R = D / (16 bytes) lanes share one key row of a tile, each holding a
//     16-byte slice; every R-lane "row group" runs its own online softmax
//     (m, l, acc) over its rows, reducing its dot products with warp
//     shuffles, and a lane owns acc[G][its slice of D].  Where R does not
//     divide 32 (D 112: R 14 in bf16, 28 in fp32) a row group is padded to
//     Rp, the next power of two: lanes c >= R hold a zero slice of q and
//     of each row, load and store nothing, and add 0 to the shuffled dot
//     products (2 of 16, or 4 of 32, lanes idle).  For D 32, 64 and 128,
//     Rp = R and the padding compiles away;
//   * after the sweep the row groups merge by lse weight, inside a warp
//     with shuffles, then across warps in shared memory, into the block's
//     partial (m, l, acc) in scratch;
//   * the last block of a (b, kv) to finish (an atomic ticket, which it
//     resets to 0 for the next call) merges the n_split partials by lse
//     into out and lse, inside the same launch.  With n_split = 1 the block
//     writes out and lse itself.
//
// The TPU kernel carries (m, l, acc) across a sequential grid axis over KV
// blocks; here that axis is the loop inside a block plus the merge.
//
// Paged form (Paged = true, decode_attention_paged_launch): K and V stay in
// the serving pool's pages, [num_blocks, ..., KV, block_k, D] with one page
// of one KV head contiguous (block_k x D), and an int32 table [B,
// table_width] names each row's pages in order.  Key t of row b is row
// t % block_k of page table[b][t / block_k]; a tile of keys never crosses a
// page (the wrapper checks that block_k and the split's length are
// multiples of the tile's rows), so a tile is still one bulk copy of K and
// one of V.  The capacity is table_width * block_k, and the split plan, each
// row group's keys in their order and the merges are the contiguous form's:
// the outputs are the contiguous form's over the gathered copy, bit for
// bit.  Like the contiguous form it reads keys up to each row's length only
// (the whole table at cache_len 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;         // K and V tiles in flight
constexpr int kTileBytes = 16384;  // shared memory of one K (or V) tile
constexpr int kRingBytes = kStages * 2 * kTileBytes;
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

// the next power of two >= r (r <= 32): lanes of a padded row group
__host__ __device__ constexpr int pow2_at_least(int r) {
  return r <= 1 ? 1 : 2 * pow2_at_least((r + 1) / 2);
}

// the largest power of two <= r (r >= 1)
__host__ __device__ constexpr int pow2_at_most(int r) {
  return r < 2 ? 1 : 2 * pow2_at_most(r / 2);
}

// keys of one tile: kTileBytes of rows, at most 64; the paged form's, a
// power of two, so that pages of a multiple of 64 keys hold whole tiles (it
// differs only at fp32 D 112: 32 keys, not 36).  A key's row group is its
// offset in the split modulo the row groups, which divide either count, so
// every row group sweeps the same keys in the same order in both forms.
template <typename T, int D, bool Paged = false>
__host__ __device__ constexpr int tile_rows() {
  constexpr int rows = kTileBytes / (D * (int)sizeof(T)) < 64
                           ? kTileBytes / (D * (int)sizeof(T))
                           : 64;
  return Paged ? pow2_at_most(rows) : rows;
}

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

// `bytes` (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// part: per (bh, split) G*D acc, then G m, then G l (fp32); tickets: one
// int per bh, 0 between launches.  len: one int (len_rows 1) or one per
// batch row (len_rows B), row b = bh / kv_heads.  Paged: k and v are the
// pages' base, page p's head kv at p * page_stride + kv * block_k * D, and
// table [B, table_width] holds each row's page ids (unused otherwise).
template <typename T, int G, int D, bool Paged>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ len,
                        const int* __restrict__ table, T* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ part,
                        int* __restrict__ tickets, int s_cap, int split_keys,
                        int n_split, int kv_heads, int len_rows,
                        int table_width, int block_k, long long page_stride,
                        float scale) {
  constexpr int kVec = Slice<T>::kVec;
  constexpr int R = D / kVec;        // lanes that hold a slice of one key row
  constexpr int Rp = pow2_at_least(R);  // lanes of a row group, R padded
  constexpr bool kPadded = Rp != R;
  constexpr int kRowsPerWarp = 32 / Rp;
  constexpr int kGroups = kWarps * kRowsPerWarp;
  constexpr int kRows = tile_rows<T, D, Paged>();
  constexpr int kRowBytes = D * (int)sizeof(T);
  constexpr int kPart = G * (D + 2);  // floats of one partial
  static_assert(D % kVec == 0 && R >= 1 && Rp <= 32 && 32 % Rp == 0,
                "D must be a multiple of 16 bytes and at most 32 of them");
  static_assert(kRows % kGroups == 0, "a tile must cover the row groups");
  static_assert(kWarps * G * (D + 2) * 4 <= kRingBytes, "merge space");

  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ int last;

  const int bh = blockIdx.x;  // b * KV + kv
  const int split = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = lane % Rp;    // this lane's 16-byte slice of a row
  const bool live = !kPadded || c < R;  // a padding lane holds no slice
  const int grp = warp * kRowsPerWarp + lane / Rp;

  const int cache_len = len[len_rows > 1 ? bh / kv_heads : 0];
  const int n = cache_len >= 1 ? min(cache_len, s_cap) : s_cap;
  const int t0 = split * split_keys;
  const int keys = max(0, min(t0 + split_keys, n) - t0);
  const int n_tiles = (keys + kRows - 1) / kRows;
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t bar0 = smem_u32(full_bar);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tile i into stage i % kStages (thread 0): keys t0 + i * kRows on, at
  // element offset `at` of k and of v
  auto issue = [&](int i) {
    const int s = i % kStages;
    const int t = t0 + i * kRows;
    const int bytes = min(kRows, keys - i * kRows) * kRowBytes;
    long long at;
    if constexpr (Paged) {
      const int b = bh / kv_heads;
      const int page = __ldg(table + (long long)b * table_width + t / block_k);
      at = (long long)page * page_stride +
           ((long long)(bh % kv_heads) * block_k + t % block_k) * D;
    } else {
      at = ((long long)bh * s_cap + t) * D;
    }
    const uint32_t bar = bar0 + 8 * s;
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(ring_s + s * 2 * kTileBytes, k + at, bytes, bar);
    bulk_load(ring_s + s * 2 * kTileBytes + kTileBytes, v + at, bytes, bar);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(kStages, n_tiles); ++i) issue(i);

  // q [B, H, D] with H = KV * G: this block's heads start at row bh * G.
  float qf[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 w = live ? *reinterpret_cast<const uint4*>(
                               q + ((long long)bh * G + g) * D + c * kVec)
                         : make_uint4(0u, 0u, 0u, 0u);
    Slice<T>::unpack(w, qf[g]);
  }

  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(bar0 + 8 * s, (i / kStages) & 1);
    const int rows = min(kRows, keys - i * kRows);
    const uint8_t* ks = ring + s * 2 * kTileBytes + c * 16;
    const uint8_t* vs = ks + kTileBytes;
    uint4 kr[kRows / kGroups], vr[kRows / kGroups];
#pragma unroll
    for (int u = 0; u < kRows / kGroups; ++u) {
      const int r = u * kGroups + grp;
      if (r < rows && live) {
        kr[u] = *reinterpret_cast<const uint4*>(ks + r * kRowBytes);
        vr[u] = *reinterpret_cast<const uint4*>(vs + r * kRowBytes);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kRows / kGroups; ++u) {
      const int r = u * kGroups + grp;
      const int t = t0 + i * kRows + r;
      float kf[kVec], vf[kVec];
      Slice<T>::unpack(kr[u], kf);
      Slice<T>::unpack(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qf[g][e], kf[e], dot);
#pragma unroll
        for (int off = Rp / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(kFull, dot, off);
        if (r < rows) {  // the same for all Rp lanes of the group
          const float sv = t < cache_len ? dot * scale : kNegInf;
          // one exp: exp(s - m) when m stays, exp(m - s) as the
          // correction of the old terms when s raises the max
          const float d = sv - m[g];
          const float x = expf(-fabsf(d));
          const bool up = d > 0.f;
          const float corr = up ? x : 1.f;
          const float p = up ? 1.f : x;
          l[g] = fmaf(l[g], corr, p);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[g][e] = fmaf(p, vf[e], acc[g][e] * corr);
          m[g] = up ? sv : m[g];
        }
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && i + kStages < n_tiles) issue(i + kStages);
  }

  // merge the row groups of a warp: lanes c, c + Rp, c + 2Rp, ... hold the
  // same slice of D for different keys
#pragma unroll
  for (int off = Rp; off < 32; off <<= 1) {
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
  // the ring is free (every copy landed and was read): merge space
  float* sm_acc = reinterpret_cast<float*>(ring);  // [kWarps][G][D]
  float* sm_m = sm_acc + kWarps * G * D;            // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;
  if (lane < R) {  // the first row group's live lanes
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        sm_acc[(warp * G + g) * D + c * kVec + e] = acc[g][e];
      if (lane == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps: normalise (n_split 1) or write the block's partial
  float* mine = part + ((long long)bh * n_split + split) * kPart;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(sm_m[w * G + g] - mx);
      lt = fmaf(sm_l[w * G + g], wt, lt);
      at = fmaf(sm_acc[(w * G + g) * D + d], wt, at);
    }
    if (n_split == 1) {
      const float lc = fmaxf(lt, 1e-30f);
      const long long row = (long long)bh * G + g;
      out[row * D + d] = Slice<T>::store(at / lc);
      if (d == 0) lse[row] = mx + logf(lc);
    } else {
      mine[i] = at;
      if (d == 0) {
        mine[G * D + g] = mx;
        mine[G * D + G + g] = lt;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this (b, kv) merges the partials, one output element
  // a thread, reading every split's (m, l, acc) from L2
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[bh], 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = part + (long long)bh * n_split * kPart;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
    for (int j = 0; j < n_split; ++j)
      mx = fmaxf(mx, __ldcg(parts + j * kPart + G * D + g));
    float lt = 0.f, at = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float* pj = parts + j * kPart;
      const float w = expf(__ldcg(pj + G * D + g) - mx);
      lt = fmaf(__ldcg(pj + G * D + G + g), w, lt);
      at = fmaf(__ldcg(pj + i), w, at);
    }
    const float lc = fmaxf(lt, 1e-30f);
    const long long row = (long long)bh * G + g;
    out[row * D + i % D] = Slice<T>::store(at / lc);
    if (i % D == 0) lse[row] = mx + logf(lc);
  }
  if (threadIdx.x == 0) tickets[bh] = 0;  // ready for the next launch
}

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

template <typename T>
struct Type {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(Type<T>{}, Int<G>{}, Int<D>{}) for the kernel that dtype
// (0: fp32, 1: bf16), groups and d_head select; an argument error where
// none is built.
template <typename T, int G, typename F>
int with_d(int d_head, F&& f) {
  switch (d_head) {
    case 32: return f(Type<T>{}, Int<G>{}, Int<32>{});
    case 64: return f(Type<T>{}, Int<G>{}, Int<64>{});
    case 112: return f(Type<T>{}, Int<G>{}, Int<112>{});
    case 128: return f(Type<T>{}, Int<G>{}, Int<128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename F>
int with_g(int groups, int d_head, F&& f) {
  switch (groups) {
    case 1: return with_d<T, 1>(d_head, f);
    case 2: return with_d<T, 2>(d_head, f);
    case 4: return with_d<T, 4>(d_head, f);
    case 8: return with_d<T, 8>(d_head, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int with_kernel(int dtype, int groups, int d_head, F&& f) {
  if (dtype == 0) return with_g<float>(groups, d_head, f);
  if (dtype == 1) return with_g<__nv_bfloat16>(groups, d_head, f);
  return (int)cudaErrorInvalidValue;
}

// The kernel for T, G, D and its form, allowed its ring of shared memory on
// the current device (err says whether that worked).
template <typename T, int G, int D, bool Paged = false>
auto ready(cudaError_t& err) {
  auto kernel = decode_attention_kernel<T, G, D, Paged>;
  static unsigned allowed = 0;
  err = allow_smem(kernel, kRingBytes, allowed);
  return kernel;
}

// The checks both forms' launches share: an argument error, or 0.
int check_plan(int batch, int kv_heads, int s_cap, int split_keys,
               int n_split, int len_rows, const void* part,
               const void* tickets) {
  if (batch < 1 || kv_heads < 1 || s_cap < 1 || split_keys < 1 ||
      (len_rows != 1 && len_rows != batch) ||
      split_keys % 64 || n_split < 1 || n_split > 65535 ||
      (long long)split_keys * n_split < s_cap ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * kv_heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

}  // namespace

extern "C" {

// q [B, KV*G, D], k and v [B, KV, S, D], all contiguous and 16-byte
// aligned, of one dtype (0: fp32, 1: bf16); len len_rows device int32s
// (1: one length for the batch, batch: one per row); out
// [B, KV*G, D] in that dtype; lse fp32 [B, KV*G].  The grid is (B*KV,
// n_split), block j sweeping keys [j*split_keys, (j+1)*split_keys) (a
// multiple of 64); with n_split > 1, part is fp32 scratch of
// B*KV*n_split*G*(D+2) floats and tickets B*KV int32 zeros, left zero.
// Returns cudaGetLastError() after the launch (0 on success), or an
// argument error without launching.  The kernel runs on `stream` and does
// not synchronise.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* len, void* out, void* lse, void* part,
                            void* tickets, int batch, int kv_heads, int groups,
                            int s_cap, int d_head, int split_keys, int n_split,
                            int dtype, int len_rows, float scale,
                            void* stream) {
  const int bad = check_plan(batch, kv_heads, s_cap, split_keys, n_split,
                             len_rows, part, tickets);
  if (bad) return bad;
  return with_kernel(dtype, groups, d_head, [&](auto t, auto g, auto d) {
    using T = typename decltype(t)::type;
    cudaError_t err;
    auto kernel = ready<T, decltype(g)::value, decltype(d)::value>(err);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)(batch * kv_heads), n_split), kThreads, kRingBytes,
             (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)len, nullptr,
        (T*)out, (float*)lse, (float*)part, (int*)tickets, s_cap, split_keys,
        n_split, kv_heads, len_rows, 0, 1, 0LL, scale);
    return (int)cudaGetLastError();
  });
}

// The paged form: k_pages and v_pages the pages' base (page p's KV head kv
// at element p * page_stride + kv * block_k * d_head, each head's block_k
// rows of d_head contiguous, 16-byte aligned), table int32 [batch,
// table_width] of page ids on the device; the capacity is table_width *
// block_k, and block_k and split_keys must be multiples of the tile's rows
// (a tile reads one page).  The rest as decode_attention_launch.
int decode_attention_paged_launch(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* len, void* out, void* lse,
                                  void* part, void* tickets, int batch,
                                  int kv_heads, int groups, int table_width,
                                  int block_k, long long page_stride,
                                  int d_head, int split_keys, int n_split,
                                  int dtype, int len_rows, float scale,
                                  void* stream) {
  if (table == nullptr || table_width < 1 || block_k < 1 || page_stride < 0)
    return (int)cudaErrorInvalidValue;
  const long long s_cap = (long long)table_width * block_k;
  if (s_cap > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bad = check_plan(batch, kv_heads, (int)s_cap, split_keys, n_split,
                             len_rows, part, tickets);
  if (bad) return bad;
  return with_kernel(dtype, groups, d_head, [&](auto t, auto g, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    constexpr int rows = tile_rows<T, kD, true>();
    if (block_k % rows || split_keys % rows) return (int)cudaErrorInvalidValue;
    cudaError_t err;
    auto kernel = ready<T, decltype(g)::value, kD, true>(err);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)(batch * kv_heads), n_split), kThreads, kRingBytes,
             (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k_pages, (const T*)v_pages, (const int*)len,
        (const int*)table, (T*)out, (float*)lse, (float*)part, (int*)tickets,
        (int)s_cap, split_keys, n_split, kv_heads, len_rows, table_width,
        block_k, page_stride, scale);
    return (int)cudaGetLastError();
  });
}

// Keys of one tile of the paged kernel for dtype and d_head, into *rows:
// its block_k and split length must be multiples of it.  Returns 0 or an
// argument error.
int decode_attention_tile_rows(int dtype, int d_head, int* rows) {
  return with_kernel(dtype, 1, d_head, [&](auto t, auto, auto d) {
    *rows = tile_rows<typename decltype(t)::type, decltype(d)::value, true>();
    return 0;
  });
}

// Blocks of the kernel for dtype, groups and d_head that one SM of the
// current device holds at once (its ring of shared memory and its registers
// decide), into *blocks.  Returns 0 or a CUDA error.
int decode_attention_blocks_per_sm(int groups, int d_head, int dtype,
                                   int* blocks) {
  return with_kernel(dtype, groups, d_head, [&](auto t, auto g, auto d) {
    using T = typename decltype(t)::type;
    cudaError_t err;
    auto kernel = ready<T, decltype(g)::value, decltype(d)::value>(err);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                          kThreads, kRingBytes);
    return (int)err;
  });
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
