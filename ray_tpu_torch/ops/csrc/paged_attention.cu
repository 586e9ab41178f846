// Paged decode attention for Hopper (sm_90a).
//
// Replaces ray_tpu/models/gpt_decode.py::_paged_attention_pallas, the
// Pallas TPU kernel behind paged_attention(kernel="pallas"). It computes
// the same function: each slot's single query q[b, 0, h, :] attends over
// the pages its page-table row pt[b, :] maps, valid at virtual positions
// <= pos[b]; unmapped (PT_SENTINEL) pages and pages wholly past pos[b]
// are skipped. Softmax statistics in f32, probabilities normalised THEN
// cast to the compute dtype (gpt_decode.py:1153), p·v accumulated in f32.
// int8 pools dequantise each element as bf16(float(code) * scale), with
// one f32 scale per (page, head), exactly as _deq_page does.
//
// What bounds it: device-memory bytes. Every live K and V element is
// used for a couple of flops, far below the ~295 flops per byte at which
// an H100's tensor cores, not HBM, become the limit. The design therefore
// moves each live byte once and keeps many loads in flight:
//   - one thread block per (slot, head) reads its page-table row and
//     pos[b] itself (no scalar prefetch on this card) and walks only the
//     live pages: no gathered [B, max_pages * page_size] copy, as the
//     plain PyTorch version makes, and no work for unmapped columns;
//   - the logits of the block's positions stay in shared memory
//     (max_pages * page_size floats, 4 KB at max_seq 1024), so K is read
//     once, where the TPU kernel swept K twice (one pass for the max and
//     exp-sum, one for p·v);
//   - every load is 16 bytes: a position's head row (head_dim elements)
//     is split over hd / (16 / sizeof(element)) lanes, so one warp covers
//     several positions per step, and each lane issues kUnroll loads
//     before it uses any, hiding device-memory latency.
// Not yet done (later work): split-K over pages for long sequences (one
// block per (slot, head) leaves a long slot's block the critical path),
// TMA/wgmma.
//
// Plain C interface (bound with ctypes): rt_paged_attention returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kUnroll = 4;       // 16-byte loads in flight per lane
constexpr int kMaxVec = 16;      // elements in 16 bytes (int8)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x after a cast to the compute dtype T and back (round to nearest even).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 16 bytes of K/V as the compute dtype T sees them: kN elements per
// vector; fp pools hold T itself, int8 pools dequantise each code.
template <typename T, bool kQuant>
struct KV {
  using Elem = T;
  static constexpr int kN = 16 / sizeof(T);
  __device__ __forceinline__ static void convert(const uint4& raw, float,
                                                 float* o) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kN; ++i) o[i] = to_float(e[i]);
  }
};
template <typename T>
struct KV<T, true> {
  using Elem = int8_t;
  static constexpr int kN = 16;
  __device__ __forceinline__ static void convert(const uint4& raw, float s,
                                                 float* o) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kN; ++i) o[i] = round_to<T>(static_cast<float>(e[i]) * s);
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max or sum; every thread receives the result.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    T* __restrict__ out, const T* __restrict__ q,
    const typename KV<T, kQuant>::Elem* __restrict__ kc,
    const typename KV<T, kQuant>::Elem* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ pt, const int* __restrict__ pos, int n_pages,
    int page_size, int max_pages, int H, int hd, float scale) {
  using V = KV<T, kQuant>;
  constexpr int kN = V::kN;
  extern __shared__ float smem[];
  float* qs = smem;                    // [kMaxHeadDim] the query row, f32
  float* red = qs + kMaxHeadDim;       // [kWarps] reduction scratch
  float* part = red + kWarps;          // [kThreads * kN] p·v partial sums
  float* lg = part + kThreads * kMaxVec;  // [max_pages*page_size] logits/p

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* row = pt + static_cast<size_t>(b) * max_pages;
  const int p_last = pos[b];
  // Page-table columns j with j * page_size <= pos[b]; the rest are past
  // the slot's length and never read.
  const int n_vis = p_last < 0 ? 0 : min(p_last / page_size + 1, max_pages);
  const int n_pos = n_vis * page_size;
  const size_t tok_stride = static_cast<size_t>(H) * hd;
  const size_t page_stride = static_cast<size_t>(page_size) * tok_stride;
  const size_t head_off = static_cast<size_t>(h) * hd;
  // A position's head row is hd / kN 16-byte vectors, one per lane of a
  // group of `lpp` lanes (a power of two, checked by the host).
  const int lpp = hd / kN;
  const int chunk = lane % lpp;        // this lane's vector of the row

  for (int d = tid; d < hd; d += kThreads)
    qs[d] = to_float(q[(static_cast<size_t>(b) * H + h) * hd + d]);
  __syncthreads();

  // Phase 1: logits. A warp covers 32 / lpp positions per step, each lane
  // kUnroll steps at once. An unmapped column (sentinel, or any index
  // outside the pool) is outside the softmax (-inf); a mapped position
  // past pos[b] is masked to -1e30 as the reference does.
  {
    float qv[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) qv[i] = qs[chunk * kN + i];
    const int per_warp = 32 / lpp;
    const int stride = kWarps * per_warp;          // positions per step
    const int first = warp * per_warp + lane / lpp;
    for (int t0 = 0; t0 < n_pos; t0 += stride * kUnroll) {
      uint4 raw[kUnroll];
      float sc[kUnroll];
      bool live[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * stride + first;
        const int page = t < n_pos ? row[t / page_size] : -1;
        live[u] = page >= 0 && page < n_pages;
        raw[u] = make_uint4(0, 0, 0, 0);
        sc[u] = 1.f;
        if (live[u]) {
          raw[u] = *reinterpret_cast<const uint4*>(
              kc + static_cast<size_t>(page) * page_stride +
              static_cast<size_t>(t % page_size) * tok_stride + head_off +
              chunk * kN);
          if (kQuant) sc[u] = ks[static_cast<size_t>(page) * H + h];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kv[kN];
        V::convert(raw[u], sc[u], kv);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kN; ++i) acc += qv[i] * kv[i];
        for (int o = lpp / 2; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const int t = t0 + u * stride + first;
        if (chunk == 0 && t < n_pos)
          lg[t] = !live[u] ? -INFINITY : (t <= p_last ? acc * scale : -1e30f);
      }
    }
  }
  __syncthreads();

  // Phase 2: block max m and exp-sum l.
  float m = -INFINITY;
  for (int t = tid; t < n_pos; t += kThreads) m = fmaxf(m, lg[t]);
  m = block_reduce<true>(m, red);
  T* o = out + (static_cast<size_t>(b) * H + h) * hd;
  if (m == -INFINITY) {  // no live page: zeros, never NaN
    for (int d = tid; d < hd; d += kThreads) o[d] = from_float<T>(0.f);
    return;
  }
  float l = 0.f;
  for (int t = tid; t < n_pos; t += kThreads) l += expf(lg[t] - m);
  l = block_reduce<false>(l, red);

  // Phase 3: p = to_compute_dtype(exp(s - m) / l), then p·v in f32. The
  // block covers kThreads / lpp positions per step, thread (g, chunk)
  // accumulating its kN output elements over positions g, g + groups, ..
  for (int t = tid; t < n_pos; t += kThreads)
    lg[t] = round_to<T>(expf(lg[t] - m) / l);
  __syncthreads();
  {
    const int groups = kThreads / lpp;
    const int g = tid / lpp;
    const int t_end = min(n_pos, p_last + 1);
    float acc[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.f;
    for (int t0 = g; t0 < t_end; t0 += groups * kUnroll) {
      uint4 raw[kUnroll];
      float sc[kUnroll], p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * groups;
        const int page = t < t_end ? row[t / page_size] : -1;
        raw[u] = make_uint4(0, 0, 0, 0);
        sc[u] = 1.f;
        p[u] = 0.f;
        if (page >= 0 && page < n_pages) {
          raw[u] = *reinterpret_cast<const uint4*>(
              vc + static_cast<size_t>(page) * page_stride +
              static_cast<size_t>(t % page_size) * tok_stride + head_off +
              chunk * kN);
          if (kQuant) sc[u] = vs[static_cast<size_t>(page) * H + h];
          p[u] = lg[t];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float v[kN];
        V::convert(raw[u], sc[u], v);
#pragma unroll
        for (int i = 0; i < kN; ++i) acc[i] += p[u] * v[i];
      }
    }
    // part[g][d], d = chunk * kN + i: the groups' partial rows.
#pragma unroll
    for (int i = 0; i < kN; ++i) part[g * hd + chunk * kN + i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += kThreads) {
    float r = 0.f;
    for (int g = 0; g < kThreads / lpp; ++g) r += part[g * hd + d];
    o[d] = from_float<T>(r);
  }
}

template <typename T, bool kQuant>
cudaError_t launch(void* out, const void* q, const void* kc, const void* vc,
                   const void* ks, const void* vs, const void* pt,
                   const void* pos, int B, int H, int hd, int n_pages,
                   int page_size, int max_pages, float scale,
                   cudaStream_t stream) {
  using V = KV<T, kQuant>;
  using E = typename V::Elem;
  const int lpp = hd / V::kN;
  if (hd % V::kN != 0 || lpp < 1 || lpp > 32 || (lpp & (lpp - 1)) != 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (kMaxHeadDim + kWarps + kThreads * kMaxVec +
                       static_cast<size_t>(max_pages) * page_size);
  paged_attention_kernel<T, kQuant><<<dim3(B, H), kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const E*>(kc), static_cast<const E*>(vc),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pt), static_cast<const int*>(pos), n_pages,
      page_size, max_pages, H, hd, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, and fp pools); quant: int8
// pools with f32 scales ks/vs [n_pages, H] (ignored otherwise). Every
// pointer must be 16-byte aligned, and head_dim a multiple of 16 bytes of
// the pool's element type with a power-of-two number of 16-byte vectors.
extern "C" int rt_paged_attention(void* out, const void* q, const void* kc,
                                  const void* vc, const void* ks,
                                  const void* vs, const void* pt,
                                  const void* pos, int B, int H, int hd,
                                  int n_pages, int page_size, int max_pages,
                                  int dtype, int quant, float scale,
                                  int device, void* stream) {
  if (hd < 1 || hd > kMaxHeadDim || B < 1 || H < 1 || page_size < 1 ||
      max_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    err = quant ? launch<__nv_bfloat16, true>(out, q, kc, vc, ks, vs, pt, pos,
                                              B, H, hd, n_pages, page_size,
                                              max_pages, scale, s)
                : launch<__nv_bfloat16, false>(out, q, kc, vc, ks, vs, pt,
                                               pos, B, H, hd, n_pages,
                                               page_size, max_pages, scale, s);
  else if (dtype == 0)
    err = quant ? launch<float, true>(out, q, kc, vc, ks, vs, pt, pos, B, H,
                                      hd, n_pages, page_size, max_pages,
                                      scale, s)
                : launch<float, false>(out, q, kc, vc, ks, vs, pt, pos, B, H,
                                       hd, n_pages, page_size, max_pages,
                                       scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
