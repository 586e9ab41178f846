// Paged decode attention for Hopper (sm_90a).
//
// Replaces ray_tpu/models/gpt_decode.py::_paged_attention_pallas, the
// Pallas TPU kernel behind paged_attention(kernel="pallas"). It computes
// the same function: each slot's single query q[b, 0, h, :] attends over
// the pages its page-table row pt[b, :] maps, valid at virtual positions
// <= pos[b]. An unmapped column (PT_SENTINEL, or any index outside the
// pool) is outside the softmax (-inf); a mapped position past pos[b] is
// masked to -1e30; a slot with no live column gives zeros. Softmax
// statistics in f32, probabilities normalised with the slot's global max
// and exp-sum THEN cast to the compute dtype (gpt_decode.py:1153), p·v
// accumulated in f32, the output cast once. int8 pools dequantise each
// element as round_to<T>(float(code) * scale), with one f32 scale per
// (page, head), exactly as _deq_page does.
//
// What bounds it. By the roofline, device-memory bytes: every live K and
// V element is used for a couple of flops, far below the ~295 flops per
// byte at which an H100's tensor cores become the limit. But a decode
// step moves only a few MB, so in practice one block's chain of
// dependent steps (page table, TMA round trip, reductions, cluster
// barriers) sets the time: at the serving shape every live block runs in
// one wave, and a build without the K/V loads and arithmetic keeps most
// of the kernel's time (PERF.md). The design keeps that chain short and
// a long slot off any single block:
//   - split-K over page-table columns inside a thread-block cluster: one
//     cluster of C = min(8, max_pages) blocks per (slot, head), rank r
//     taking the contiguous columns [r * max_pages / C, (r + 1) *
//     max_pages / C). The grid and the cluster come from shapes only;
//     pos[b] is read on the card. A rank whose columns all lie past
//     pos[b] leaves at once, before it issues any load (rank 0 stays: it
//     writes the output);
//   - warp 0 reads the rank's page-table columns beside pos[b], stages
//     the live columns (mapped and at or before pos[b]) in shared memory
//     once, and its lanes issue one TMA load per (page, head) box, [ps,
//     hd] (a 4-D tensor map {hd, H, ps, n_pages} over each pool), every
//     live page's K and then V, into a ring of `stages` page slots, each
//     completing on its own mbarrier; int8 scales come by cp.async beside
//     them. A slot is refilled once the block has read it. Only the last
//     live column can hold positions past pos[b], so the rank's valid
//     rows are a prefix of its rows and no row is masked;
//   - the block reads a window of pages after one wait per page, each
//     lane group kUnroll rows at once, so their loads, products and
//     shuffles overlap;
//   - the softmax keeps the reference's rounding points: each rank
//     publishes its max m_r and exp-sum l_r = sum exp(s - m_r); after a
//     cluster barrier every rank reads all of them through distributed
//     shared memory (the global m, exact, and l = sum_r l_r exp(m_r - m),
//     combined in one fixed order, the same on every rank); p =
//     round_to<T>(exp(s - m) / l), p·v in f32 per rank; each rank writes
//     its partial row into rank 0's shared memory, and after a second
//     cluster barrier rank 0 sums them in rank order, casts once and
//     writes. Deterministic, no workspace, one launch.
//   - Barrier discipline: every block that has not left reaches both
//     cluster barriers, also one with no live column (a cluster barrier
//     counts only threads that have not exited). Remote reads come after
//     the first barrier (every block has started) and before the second;
//     after the second only rank 0 reads, its own memory. No block reads
//     the memory of one that left.
//
// Plain C interface (bound with ctypes): rt_paged_attention returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxPageSize = 256;  // a TMA box dimension
constexpr int kUnroll = 4;       // rows a lane group reads at once
constexpr int kMinBlocks = 8;    // blocks an SM holds: at most 64 registers

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
// a, b after a cast to T and back, as one pair conversion for bf16.
template <typename T>
__device__ __forceinline__ void round_pair(float& a, float& b) {
  a = round_to<T>(a);
  b = round_to<T>(b);
}
template <>
__device__ __forceinline__ void round_pair<__nv_bfloat16>(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

template <typename T>
struct KV<T, true> {
  using Elem = int8_t;
  static constexpr int kN = 16;
  // round_to<T>(float(code) * s) per code. A code c becomes the float
  // 2^23 + 128 + c (its biased byte under the exponent of 2^23), minus
  // 2^23 + 128: exact, and two instructions instead of a conversion.
  __device__ __forceinline__ static void convert(const uint4& raw, float s,
                                                 float* o) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;  // code + 128 in each byte
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[4 * i + j] =
            (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) -
             8388736.f) *
            s;
#pragma unroll
      for (int j = 0; j < 4; j += 2) round_pair<T>(o[4 * i + j], o[4 * i + j + 1]);
    }
  }
};

// One block's shared memory, in this order: the ring (`stages` slots of
// one [ps, hd] box each); then 4-byte words: the rank's logits [cpr * ps],
// q [hd], the warps' p·v partials [kWarps * hd], the ranks' partial rows
// [cluster * hd] (rank 0's are the ones read), the rank's max and
// exp-sum [2], the live pages' int8 scales
// [2 * cpr], the live pages [cpr], their count [1]; then one mbarrier per
// slot, 8-byte aligned. ops/paged_attention.py (_smem_bytes) mirrors the
// total only to refuse a table past the card's 227 KB before a launch.
struct Layout {
  int slot, words, bars, total;
  __host__ __device__ Layout(int cluster, int cpr, int stages, int ps, int hd,
                             int elem)
      : slot(ps * hd * elem),
        words(cpr * ps + (1 + kWarps + cluster) * hd + 2 + 3 * cpr + 1),
        bars((stages * slot + 4 * words + 7) / 8 * 8),
        total(bars + 8 * stages) {}
};

// Block-wide max or sum through `red` [kWarps]; every thread receives
// the result. A later reduction must use other scratch, or a barrier.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float x = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, x) : v + x;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// Grid (C, H, B), clusters of (C, 1, 1): block rank r of the cluster at
// (h, b) takes columns [r * max_pages / C, (r + 1) * max_pages / C).
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads, kMinBlocks) paged_attention_kernel(
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
    const T* __restrict__ q, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ pt,
    const int* __restrict__ pos, int n_pages, int ps, int max_pages, int H,
    int hd, int cpr, int stages, float scale) {
  using V = KV<T, kQuant>;
  constexpr int kN = V::kN;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int c0 = rank * max_pages / C, c1 = (rank + 1) * max_pages / C;
  const int* row = pt + static_cast<size_t>(b) * max_pages;
  // Warp 0's first 32 columns are read beside pos[b], not after it.
  const int first = warp == 0 && c0 + lane < c1 ? row[c0 + lane] : -1;
  const int p_last = pos[b];
  // Columns j with j * ps <= pos[b]; the rest are past the slot's length
  // and never read (a page at or before pos[b] holds a valid position).
  const int n_vis = p_last < 0 ? 0 : min(p_last / ps + 1, max_pages);
  // The ranks whose columns start before n_vis (r * max_pages / C <
  // n_vis, a prefix), and rank 0, which writes the output. The others
  // have nothing to read and leave at once: a cluster barrier waits only
  // for threads that have not exited, and no rank touches their memory.
  const int live_ranks =
      max(1, min(C, (n_vis * C + max_pages - 1) / max_pages));
  if (rank >= live_ranks) return;

  const int row_bytes = hd * static_cast<int>(sizeof(typename V::Elem));
  const Layout lay(C, cpr, stages, ps, hd, sizeof(typename V::Elem));
  const int ring_bytes = stages * lay.slot;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = hopper::smem_addr(smem);
  float* lg = reinterpret_cast<float*>(smem + ring_bytes);
  float* qs = lg + cpr * ps;
  float* wpart = qs + hd;
  float* rows = wpart + kWarps * hd;
  float* stat = rows + C * hd;
  float* sc = stat + 2;
  int* live_page = reinterpret_cast<int*>(sc + 2 * cpr);
  int* n_live = live_page + cpr;
  const uint32_t bars = ring + lay.bars;
  auto bar = [&](int s) { return bars + 8 * s; };

  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) hopper::mbar_init(bar(s), 1);
      hopper::mbar_init_fence();
      hopper::prefetch_map(&tk);
      hopper::prefetch_map(&tv);
    }
    // Stage the live columns in column order; only the last one can hold
    // positions past pos[b]: the rank's valid rows are a prefix.
    int n = 0, last = -1;
    for (int j0 = c0; j0 < c1; j0 += 32) {
      const int j = j0 + lane;
      const int page = j0 == c0 ? first : j < c1 ? row[j] : -1;
      const bool live = j < n_vis && page >= 0 && page < n_pages;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) live_page[n + __popc(m & ((1u << lane) - 1u))] = page;
      if (m) last = j0 + 31 - __clz(m);
      n += __popc(m);
    }
    __syncwarp();
    // Item i (K of live page i, or V of live page i - n) into slot
    // i % stages; its u-th use of the slot completes phase u.
    for (int i = lane; i < min(stages, 2 * n); i += 32) {
      hopper::mbar_expect_tx(bar(i), lay.slot);
      hopper::tma_load(ring + i * lay.slot, i < n ? &tk : &tv, bar(i), 0, h,
                       0, live_page[i < n ? i : i - n]);
    }
    if (kQuant) {  // the pages' scales, in flight beside the pages
      for (int k = lane; k < n; k += 32) {
        const size_t at = static_cast<size_t>(live_page[k]) * H + h;
        hopper::cp_async4(hopper::smem_addr(sc + k), ks + at);
        hopper::cp_async4(hopper::smem_addr(sc + cpr + k), vs + at);
      }
      hopper::cp_async_wait_all();
    }
    // The last live column holds min(ps, pos[b] - last * ps + 1) valid
    // rows: pos[b] may lie past the table's last position.
    if (lane == 0)
      *n_live = n == 0 ? 0
                : (n - 1) * ps +
                      (last == n_vis - 1 ? min(ps, p_last - last * ps + 1)
                                         : ps);
  }
  for (int d = tid; d < hd; d += kThreads)
    qs[d] = to_float(q[(static_cast<size_t>(b) * H + h) * hd + d]);
  __syncthreads();
  const int nrows = *n_live;            // valid rows, live pages in order
  const int n = (nrows + ps - 1) / ps;  // live pages
  const int items = 2 * n;

  // A position's head row is hd / kN 16-byte vectors, one per lane of a
  // group of `lpp` lanes (a power of two, checked by the host); the block
  // covers `groups` rows per pass, each group kUnroll rows at once. Trip
  // counts are uniform across the block, so every lane reaches every
  // shuffle and barrier.
  const int lpp = hd / kN, lshift = __ffs(lpp) - 1;
  const int groups = kThreads >> lshift;
  const int g = tid >> lshift, chunk = tid & (lpp - 1);
  // Row t's page within a window (int8 scales): a shift for the usual
  // power-of-two page sizes.
  const int pshift = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  auto page_of = [&](int t) { return pshift >= 0 ? t >> pshift : t / ps; };
  // The window of items [i0, i0 + w): wait for all its pages, then row t
  // of it lies t * row_bytes past its first slot (the ring wraps once).
  auto wait_window = [&](int i0, int w) {
    int s = i0 % stages;
    uint32_t parity = (i0 / stages) & 1;
    for (int k = 0; k < w; ++k) {
      hopper::mbar_wait(bar(s), parity);
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
  };
  auto row_of = [&](int i0, int t) {
    int off = (i0 % stages) * lay.slot + t * row_bytes;
    if (off >= ring_bytes) off -= ring_bytes;
    return *reinterpret_cast<const uint4*>(smem + off + chunk * 16);
  };
  // After the window has been read: refill its slots with the items
  // `stages` further on (a uniform condition).
  auto refill = [&](int i0, int w) {
    if (i0 + stages >= items) return;
    __syncthreads();
    if (warp == 0)
      for (int i = i0 + stages + lane; i < min(i0 + stages + w, items);
           i += 32) {
        const int s = i % stages;
        hopper::mbar_expect_tx(bar(s), lay.slot);
        hopper::tma_load(ring + s * lay.slot, i < n ? &tk : &tv, bar(s), 0,
                         h, 0, live_page[i < n ? i : i - n]);
      }
  };

  // Phase 1: the rank's logits and their max m_r.
  float m_r = -INFINITY;
  {
    float qv[kN];
#pragma unroll
    for (int e = 0; e < kN; ++e) qv[e] = qs[chunk * kN + e];
    for (int i0 = 0; i0 < n; i0 += stages) {
      const int w = min(stages, n - i0);
      const int end = min(w * ps, nrows - i0 * ps);
      wait_window(i0, w);
      for (int t0 = 0; t0 < end; t0 += groups * kUnroll) {
        uint4 raw[kUnroll];
        float acc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * groups + g;
          raw[u] = t < end ? row_of(i0, t) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * groups + g;
          float kv[kN];
          V::convert(raw[u], kQuant && t < end ? sc[i0 + page_of(t)] : 1.f,
                     kv);
          acc[u] = 0.f;
#pragma unroll
          for (int e = 0; e < kN; ++e) acc[u] += qv[e] * kv[e];
        }
        for (int o = lpp / 2; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * groups + g;
          if (t < end) {
            const float x = acc[u] * scale;
            if (chunk == 0) lg[i0 * ps + t] = x;
            m_r = fmaxf(m_r, x);
          }
        }
      }
      refill(i0, w);
    }
  }
  // Its exp-sum l_r against m_r (the logits are visible after the first
  // reduction's barrier; wpart is free scratch until phase 3).
  m_r = block_reduce<true>(m_r, wpart);
  float l_r = 0.f;
  for (int t = tid; t < nrows; t += kThreads) l_r += expf(lg[t] - m_r);
  l_r = block_reduce<false>(l_r, wpart + kWarps);
  if (tid == 0) {
    stat[0] = m_r;
    stat[1] = l_r;
  }
  cluster.sync();

  // Phase 2: the slot's max m (exact) and exp-sum l, from every live
  // rank's (m_r, l_r) through distributed shared memory, in rank order,
  // so every rank holds the same l. A cluster with no live row has m =
  // -inf and no row anywhere: its partial rows stay zero. Then each valid
  // row's p = round_to<T>(exp(s - m) / l), in place of its logit.
  // Lane r % 8 of every warp reads rank r's pair; the eight lanes of a
  // group combine them in the same fixed order on every rank.
  float m = -INFINITY, l = 0.f;
  {
    const int r = lane & (kMaxCluster - 1);
    if (r < live_ranks) {
      const float* st = cluster.map_shared_rank(stat, r);
      m = st[0];
      l = st[1];
    }
    float mx = m;
    for (int o = 1; o < kMaxCluster; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    l = l > 0.f ? l * expf(m - mx) : 0.f;
    for (int o = 1; o < kMaxCluster; o <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    m = mx;
  }
  for (int t = tid; t < nrows; t += kThreads)
    lg[t] = round_to<T>(expf(lg[t] - m) / l);
  __syncthreads();

  // Phase 3: p·v in f32 over the valid rows (a row past pos[b] has p = 0
  // and is never read).
  float acc[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) acc[e] = 0.f;
  for (int i0 = n; i0 < items; i0 += stages) {
    const int w = min(stages, items - i0);
    const int base = (i0 - n) * ps, end = min(w * ps, nrows - base);
    wait_window(i0, w);
    for (int t0 = 0; t0 < end; t0 += groups * kUnroll) {
      uint4 raw[kUnroll];
      float p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * groups + g;
        raw[u] = t < end ? row_of(i0, t) : make_uint4(0, 0, 0, 0);
        p[u] = t < end ? lg[base + t] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * groups + g;
        float v[kN];
        V::convert(raw[u],
                   kQuant && t < end ? sc[cpr + i0 - n + page_of(t)] : 1.f, v);
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[e] += p[u] * v[e];
      }
    }
    refill(i0, w);
  }
  // The groups of a warp, then the warps in order: this rank's row, which
  // it writes into rank 0's shared memory; then rank 0 sums the live
  // ranks' rows in rank order, casts once and writes.
#pragma unroll
  for (int e = 0; e < kN; ++e)
    for (int o = lpp; o < 32; o <<= 1)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane < lpp)
#pragma unroll
    for (int e = 0; e < kN; ++e) wpart[warp * hd + chunk * kN + e] = acc[e];
  __syncthreads();
  float* rows0 = cluster.map_shared_rank(rows, 0) + rank * hd;
  for (int d = tid; d < hd; d += kThreads) {
    float r = 0.f;
    for (int w = 0; w < kWarps; ++w) r += wpart[w * hd + d];
    rows0[d] = r;
  }
  cluster.sync();  // after it, only rank 0 reads, and only its own memory
  if (rank == 0) {
    T* o = out + (static_cast<size_t>(b) * H + h) * hd;
    for (int d = tid; d < hd; d += kThreads) {
      float r = 0.f;
      for (int s = 0; s < live_ranks; ++s) r += rows[s * hd + d];
      o[d] = from_float<T>(r);
    }
  }
}

// One instantiation of the kernel, as a value for dispatch's callback.
template <typename T_, bool kQuant_>
struct Kernel {
  using T = T_;
  static constexpr bool kQuant = kQuant_;
  using E = typename KV<T, kQuant>::Elem;
  static CUtensorMapDataType map_type() {
    return kQuant ? CU_TENSOR_MAP_DATA_TYPE_UINT8
           : sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  }
};

// f(Kernel<T, kQuant>{}) for dtype 0 = float32, 1 = bfloat16 and quant.
template <typename F>
cudaError_t dispatch(int dtype, int quant, F f) {
  if (dtype == 1)
    return quant ? f(Kernel<__nv_bfloat16, true>{})
                 : f(Kernel<__nv_bfloat16, false>{});
  if (dtype == 0)
    return quant ? f(Kernel<float, true>{}) : f(Kernel<float, false>{});
  return cudaErrorInvalidValue;
}

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int cluster, int H,
                          int B, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The columns a rank takes at most.
int cols_per_rank(int max_pages, int cluster) {
  return (max_pages + cluster - 1) / cluster;
}

// The plan fits the kernel: a head row is a power-of-two number (at most
// 32) of 16-byte vectors.
bool plan_ok(int hd, int page_size, int max_pages, int cluster, int stages,
             int elem) {
  const int lpp = hd * elem / 16;
  return hd >= 1 && hd <= kMaxHeadDim && hd * elem % 16 == 0 && lpp <= 32 &&
         (lpp & (lpp - 1)) == 0 && page_size >= 1 &&
         page_size <= kMaxPageSize && max_pages >= 1 && cluster >= 1 &&
         cluster <= kMaxCluster && cluster <= max_pages && stages >= 1;
}

// A block's shared memory under this plan.
int smem_bytes(int hd, int page_size, int max_pages, int cluster, int stages,
               int elem) {
  return Layout(cluster, cols_per_rank(max_pages, cluster), stages,
                page_size, hd, elem)
      .total;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, and fp pools); quant: int8
// pools with f32 scales ks/vs [n_pages, H] (ignored otherwise). The launch
// plan (cluster size, ring stages) comes from
// ops/paged_attention.py::_launch_plan, which calls
// rt_paged_attention_prepare once per plan before its first launch. Every
// pointer must be 16-byte aligned, and head_dim a multiple of 16 bytes of
// the pool's element type with a power-of-two number of 16-byte vectors.
extern "C" int rt_paged_attention(void* out, const void* q, const void* kc,
                                  const void* vc, const void* ks,
                                  const void* vs, const void* pt,
                                  const void* pos, int B, int H, int hd,
                                  int n_pages, int page_size, int max_pages,
                                  int dtype, int quant, float scale,
                                  int cluster, int stages, int device,
                                  void* stream) {
  if (B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dispatch(dtype, quant, [&](auto k) -> cudaError_t {
    using K = decltype(k);
    using T = typename K::T;
    const auto fn = paged_attention_kernel<T, K::kQuant>;
    const int elem = static_cast<int>(sizeof(typename K::E));
    if (!plan_ok(hd, page_size, max_pages, cluster, stages, elem))
      return cudaErrorInvalidValue;
    CUtensorMap mk, mv;
    if (!hopper::page_map(&mk, kc, K::map_type(), elem, n_pages, page_size,
                          H, hd) ||
        !hopper::page_map(&mv, vc, K::map_type(), elem, n_pages, page_size,
                          H, hd))
      return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(
        &attr, cluster, H, B,
        smem_bytes(hd, page_size, max_pages, cluster, stages, elem),
        static_cast<cudaStream_t>(stream));
    return cudaLaunchKernelEx(
        &cfg, fn, mk, mv, static_cast<T*>(out), static_cast<const T*>(q),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(pt), static_cast<const int*>(pos), n_pages,
        page_size, max_pages, H, hd, cols_per_rank(max_pages, cluster),
        stages, scale);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Readies a plan on `device` (once, before its first launch): raises the
// instantiation's dynamic shared-memory limit to the plan's need (never
// lowers it, so an earlier plan stays launchable) and returns how many
// clusters of the plan the card holds at once (0: the plan cannot run),
// from cudaOccupancyMaxActiveClusters; a negative value is a CUDA error
// code.
extern "C" int rt_paged_attention_prepare(int dtype, int quant, int hd,
                                          int page_size, int max_pages,
                                          int cluster, int stages,
                                          int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int count = 0;
  err = dispatch(dtype, quant, [&](auto k) -> cudaError_t {
    using K = decltype(k);
    const auto fn = paged_attention_kernel<typename K::T, K::kQuant>;
    const int elem = static_cast<int>(sizeof(typename K::E));
    if (!plan_ok(hd, page_size, max_pages, cluster, stages, elem))
      return cudaErrorInvalidValue;
    const int smem =
        smem_bytes(hd, page_size, max_pages, cluster, stages, elem);
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, fn);
    if (e != cudaSuccess) return e;
    if (fa.maxDynamicSharedSizeBytes < smem) {
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(&attr, cluster, 1, 1, smem, 0);
    return cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  });
  return err == cudaSuccess ? count : -static_cast<int>(err);
}
