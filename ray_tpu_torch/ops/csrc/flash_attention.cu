// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   - _fwd_kernel (:74)        -> flash_fwd_*       (K2)
//   - _bwd_fused_kernel (:152) -> flash_bwd_dkdv_*  (K3a, dK and dV)
//                                 flash_bwd_dq_*    (K3b, dQ)
// and computes the same functions with the same rounding points:
//   - q arrives pre-scaled (qs = q * dtype(sm_scale), done by the caller);
//   - s = qs . k^T in f32; the causal mask is col > row, masked logits are
//     NEG_INF = -1e30 as in the reference;
//   - forward: online softmax over key tiles in f32, p rounded to the
//     compute dtype before p . v (f32 accumulation), o = acc / l cast once,
//     lse = m + log(l) in f32 [B, H, S];
//   - backward: p = exp(s - lse) in f32; dV += dtype(p)^T . dO;
//     dP = dO . V^T in f32; dS = dtype(p * (dP - delta)); dK += dS^T . qs
//     and dQ += dS . K in f32; dq = dtype(dQ * sm_scale).
// The bf16 kernels take exp(x) as exp2(x * log2(e)) (one FMA folding the
// factor in, one ex2.approx); l sums the unrounded f32 p.
//
// Layout: q, k, v, o, dO, dq, dk, dv are read and written in the public
// [B, S, H, hd] layout (contiguous), so no transposed copies are made
// around the kernels. lse and delta are f32 [B, H, S].
//
// The TPU backward carried dQ in VMEM across the sequential k-block sweep
// of one core ("not portable flash"). Hopper blocks run in no order, so the
// backward is two kernels: K3a walks q tiles for its key tile and writes
// dK, dV; K3b walks key tiles for its q tile and writes dQ. Both recompute
// p from lse; there are no atomics, so every gradient is deterministic.
//
// What bounds them: at the training shape (hd 64, S 1024, causal) the
// matrix products (4 hd flops per visible (q, k) pair forward, 8 hd in
// K3a, 6 hd in K3b) put K2 near the bytes/operations ridge and K3a/K3b on
// the operations side, and the forward's one exponential per pair costs
// the SFU about as long as the products cost the tensor cores. On Hopper
// the tensor cores' rate needs wgmma fed from shared memory by loads that
// overlap it, and the elementwise work between products must stay free
// of branches (a masked value is a select: per-element branches cost
// the backward a quarter of its time). As built, each kernel reaches a
// quarter to a third of the tensor-core rate, held by the dependent chain
// inside a warpgroup (product, then softmax or dS, then the next
// product), which only the block's other warpgroup overlaps (PERF.md has
// the measurements). The bf16 kernels are built as
//   - one block of two consumer warpgroups (64 rows, or 64 keys, each)
//     and a producer warpgroup whose first warp issues the loads; the
//     producer hands registers to the consumers (setmaxnreg, 24 / 240);
//   - the producer's TMA loads (one 4-D tensor map per operand over
//     {hd, H, S, B}, 128-byte swizzle, 64-byte at hd 32; boxes running
//     past S or Sk arrive zero-filled) into a ring of two shared-memory
//     stages guarded by full/empty mbarriers, so tile j + 1 is in flight
//     while tile j is multiplied; the tile each block keeps (K2's Q, K3b's
//     Q and dO, K3a's K and V) is loaded once;
//   - every product as wgmma m64nNk16 (bf16 in, f32 accumulate). Products
//     whose reduction is hd read both operands K-major from shared memory;
//     products whose reduction runs over positions take A from registers
//     (the previous product's accumulator rounded to bf16) and B from the
//     same swizzled tile read MN-major, so no transposed tile is built;
//   - the softmax statistics and all accumulators in registers; s and p
//     never reach device memory.
// Under causal masking, tiles past the diagonal are never loaded, in the
// backward a warpgroup skips a loaded tile that lies wholly past its own
// rows or keys, and only tiles that straddle the diagonal (or the Sk
// tail) pay for the mask.
// K2 and K3b launch their q tiles from the last (heaviest) one down; K3a's
// lowest key tiles are its heaviest and come first already.
//
// The f32 kernels are plain FMA loops over shared-memory tiles (no tensor
// core path keeps f32 exact).
//
// Plain C interface (bound with ctypes): each entry point returns
// cudaGetLastError() after its launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::kmajor;
using hopper::mnmajor;
using hopper::Tile;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;      // 4 warps per block, the f32 kernels

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Whether (row, col) is masked out; no short-circuit, so that a masked
// value is a select and not a branch.
__device__ __forceinline__ bool masked(int row, int col, int Sk, int causal) {
  return (col >= Sk) | ((causal != 0) & (col > row));
}

// ------------------------------------------------------------ bf16 kernels
// Every bf16 kernel: warps 0-7 are two consumer warpgroups, warps 8-11
// the producer warpgroup, of which warp 8 issues the loads. A block holds
// the whole register file (384 threads x 168 at launch); the producer
// drops to 24 registers a thread and the consumers rise to 240.
constexpr int kWsThreads = 384;
constexpr int kProducer = 8;
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// Two f32 values as one bf16 pair, the lower index in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register-A fragments of a product whose reduction runs over the
// N columns of accumulator c, rounded to bf16: n8 groups 2kk and 2kk + 1
// of c are k-step kk of A.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = 0.f;
}

// The first 1024-byte boundary of dynamic shared memory (the swizzle
// patterns repeat every 1024 bytes; tiles start on one). Launches ask
// for 1024 bytes more than the tiles need.
__device__ __forceinline__ uint32_t tile_base(const void* raw) {
  return (hopper::smem_addr(raw) + 1023u) & ~1023u;
}

// Stores one accumulator (rows row0 and row0 + 8 of this thread, columns
// 8d + 2t, + 1) as bf16 pairs times `scale`, rows past `limit` skipped.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* base, size_t rs,
                                           const float (&c)[HD / 2], int row0,
                                           int limit, int t, float scale) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (row0 < limit)
      *reinterpret_cast<uint32_t*>(base + row0 * rs + col) =
          pack(c[4 * d] * scale, c[4 * d + 1] * scale);
    if (row1 < limit)
      *reinterpret_cast<uint32_t*>(base + row1 * rs + col) =
          pack(c[4 * d + 2] * scale, c[4 * d + 3] * scale);
  }
}

// ------------------------------------------------------ K2 forward, bf16
// One block per (q tile of 128 rows, head, batch). Warpgroup w owns rows
// 64w..64w+63 of the tile; the producer streams key tiles of 128 (K and V
// on separate barriers, so S = Q K^T starts before V lands).
struct FwdTiles {
  static constexpr int BQ = 128, BK = 128, NS = 2;
  template <int HD>
  static constexpr size_t smem() {
    return 1024 + static_cast<size_t>(BQ + 2 * NS * BK) * HD * 2 +
           8 * (1 + 3 * NS);
  }
};

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1) flash_fwd_bf16(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
    float* __restrict__ lse, int H, int S, int Sk, int causal) {
  using T = Tile<HD>;
  constexpr int BQ = FwdTiles::BQ, BK = FwdTiles::BK, NS = FwdTiles::NS;
  // Every key tile a q tile loads is seen by both warpgroups' rows.
  static_assert(BQ == BK, "the last key tile of a causal q tile is its own");
  constexpr uint32_t QB = BQ * HD * 2, KB = BK * HD * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = tile_base(smem_raw);
  const uint32_t sK = sQ + QB, sV = sK + NS * KB;  // stage s at + s * KB
  const uint32_t bars = sV + NS * KB;
  const uint32_t barQ = bars;
  auto fullK = [&](int s) { return bars + 8 * (1 + s); };
  auto fullV = [&](int s) { return bars + 8 * (1 + NS + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * NS + s); };

  const int h = blockIdx.y, b = blockIdx.z;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  // Causal: rows of this tile see no key at or past q0 + BQ.
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n = (kv_end + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(barQ, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(fullK(s), 1);
      hopper::mbar_init(fullV(s), 1);
      hopper::mbar_init(empty(s), kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kProducer) {
    hopper::reg_release<kProducerRegs>();
    if (warp != kProducer) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(barQ, QB);
      T::template load<BQ>(sQ, &tq, barQ, h, q0, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % NS;
        if (j >= NS) hopper::mbar_wait(empty(s), ((j / NS) + 1) & 1);
        hopper::mbar_expect_tx(fullK(s), KB);
        T::template load<BK>(sK + s * KB, &tk, fullK(s), h, j * BK, b);
        hopper::mbar_expect_tx(fullV(s), KB);
        T::template load<BK>(sV + s * KB, &tv, fullV(s), h, j * BK, b);
      }
    }
    return;
  }
  hopper::reg_claim<kConsumerRegs>();

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int rw = q0 + 64 * wg + 16 * (warp & 3);  // this warp's first row
  const int row0 = rw + g, row1 = row0 + 8;
  const uint32_t sQw = sQ + 64 * wg * T::RB;
  float acc[HD / 2];
  zero(acc);
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  hopper::mbar_wait(barQ, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % NS, k0 = j * BK;
    const uint32_t ph = (j / NS) & 1;
    hopper::mbar_wait(fullK(s), ph);
    float sc[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_ss<BK>(sc, kmajor<HD, BQ>(sQw, kk),
                           kmajor<HD, BK>(sK + s * KB, kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::pin(sc);
    if ((causal && k0 + BK - 1 > rw) || k0 + BK > Sk) {
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (masked(i < 2 ? row0 : row1, k0 + 8 * c + 2 * t + (i & 1),
                     Sk, causal))
            sc[4 * c + i] = kNegInf;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float b0 = mx0 * kLog2e, b1 = mx1 * kLog2e;
    const float al0 = hopper::ex2(fmaf(m0, kLog2e, -b0));
    const float al1 = hopper::ex2(fmaf(m1, kLog2e, -b1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      sc[4 * c] = hopper::ex2(fmaf(sc[4 * c], kLog2e, -b0));
      sc[4 * c + 1] = hopper::ex2(fmaf(sc[4 * c + 1], kLog2e, -b0));
      sc[4 * c + 2] = hopper::ex2(fmaf(sc[4 * c + 2], kLog2e, -b1));
      sc[4 * c + 3] = hopper::ex2(fmaf(sc[4 * c + 3], kLog2e, -b1));
      sum0 += sc[4 * c] + sc[4 * c + 1];
      sum1 += sc[4 * c + 2] + sc[4 * c + 3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      acc[4 * d] *= al0;
      acc[4 * d + 1] *= al0;
      acc[4 * d + 2] *= al1;
      acc[4 * d + 3] *= al1;
    }
    // acc += bf16(p) . V
    uint32_t pa[BK / 16][4];
    to_a<BK>(pa, sc);
    hopper::mbar_wait(fullV(s), ph);
    hopper::pin(acc);
    hopper::pin(pa);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs<HD>(acc, pa[kk], mnmajor<HD, BK>(sV + s * KB, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::pin(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(s));
  }

#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    acc[4 * d] /= l0;
    acc[4 * d + 1] /= l0;
    acc[4 * d + 2] /= l1;
    acc[4 * d + 3] /= l1;
  }
  const size_t rs = static_cast<size_t>(H) * HD;
  store_rows<HD>(o + (static_cast<size_t>(b) * S * H + h) * HD, rs, acc,
                 row0, S, t, 1.f);
  float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  if (t == 0) {
    if (row0 < S) lb[row0] = m0 + logf(l0);
    if (row1 < S) lb[row1] = m1 + logf(l1);
  }
}

// ----------------------------------------------- K3a backward dK dV, bf16
// One block per (key tile of 128, head, batch); warpgroup w owns keys
// 64w..64w+63 and works on transposed products (keys are the M side):
// S^T = K Q^T and dP^T = V dO^T read both operands K-major, dV += P^T dO
// and dK += dS^T Q take A from registers and B (dO, Q) MN-major. The
// producer streams q tiles of BQ rows, from the diagonal on, with their
// lse (times log2 e) and delta rows; rows past S get lse = +inf and
// delta = 0, so their p and dS are exactly 0.
template <int HD>
struct DkdvTiles {
  static constexpr int BKc = 128, BQ = HD == 128 ? 32 : 64, NS = 2;
  static constexpr size_t smem() {
    return 1024 + static_cast<size_t>(2 * BKc + 2 * NS * BQ) * HD * 2 +
           NS * 2 * BQ * sizeof(float) + 8 * (1 + 2 * NS);
  }
};

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dkdv_bf16(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, bf16* __restrict__ dk,
    bf16* __restrict__ dv, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int S, int Sk, int causal) {
  using T = Tile<HD>;
  using C = DkdvTiles<HD>;
  constexpr int BKc = C::BKc, BQ = C::BQ, NS = C::NS;
  constexpr uint32_t KB = BKc * HD * 2, QB = BQ * HD * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sK = tile_base(smem_raw), sV = sK + KB;
  const uint32_t sQ = sV + KB, sdO = sQ + NS * QB;  // stage s at + s * QB
  const uint32_t stats = sdO + NS * QB;  // stage s: lse [BQ], delta [BQ]
  const uint32_t bars = stats + NS * 2 * BQ * sizeof(float);
  float* const sstat = reinterpret_cast<float*>(
      smem_raw + (stats - hopper::smem_addr(smem_raw)));
  const uint32_t barKV = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + NS + s); };

  const int h = blockIdx.y, b = blockIdx.z, c0 = blockIdx.x * BKc;
  // Causal: q rows before c0 see none of these keys.
  const int first = causal ? (c0 / BQ) * BQ : 0;
  const int n = first < S ? (S - first + BQ - 1) / BQ : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* db = delta + (static_cast<size_t>(b) * H + h) * S;

  if (threadIdx.x == 0) {
    hopper::mbar_init(barKV, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(full(s), 32);  // every producer lane arrives
      hopper::mbar_init(empty(s), kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kProducer) {
    hopper::reg_release<kProducerRegs>();
    if (warp != kProducer) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(barKV, 2 * KB);
      T::template load<BKc>(sK, &tk, barKV, h, c0, b);
      T::template load<BKc>(sV, &tv, barKV, h, c0, b);
    }
    for (int j = 0; j < n; ++j) {
      const int s = j % NS, q0 = first + j * BQ;
      if (j >= NS) hopper::mbar_wait(empty(s), ((j / NS) + 1) & 1);
      if (lane == 0) {  // the tiles first, then the rows' statistics
        hopper::mbar_expect(full(s), 2 * QB);
        T::template load<BQ>(sQ + s * QB, &tq, full(s), h, q0, b);
        T::template load<BQ>(sdO + s * QB, &tdo, full(s), h, q0, b);
      }
      float* sl = sstat + s * 2 * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const bool in = q0 + i < S;
        sl[i] = in ? lb[q0 + i] * kLog2e : INFINITY;
        sl[BQ + i] = in ? db[q0 + i] : 0.f;
      }
      hopper::mbar_arrive(full(s));
    }
    return;
  }
  hopper::reg_claim<kConsumerRegs>();

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int ck = c0 + 64 * wg;            // this warpgroup's first key
  const int kw = ck + 16 * (warp & 3);    // this warp's first key
  const int key0 = kw + g, key1 = key0 + 8;
  const uint32_t sKw = sK + 64 * wg * T::RB, sVw = sV + 64 * wg * T::RB;
  float dka[HD / 2], dva[HD / 2];
  zero(dka);
  zero(dva);

  hopper::mbar_wait(barKV, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % NS, q0 = first + j * BQ;
    hopper::mbar_wait(full(s), (j / NS) & 1);
    if (!causal || q0 + BQ - 1 >= ck) {
      const uint32_t q = sQ + s * QB, dob = sdO + s * QB;
      const float* sl = sstat + s * 2 * BQ;
      float st[BQ / 2], dpt[BQ / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<BQ>(st, kmajor<HD, BKc>(sKw, kk),
                             kmajor<HD, BQ>(q, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<BQ>(dpt, kmajor<HD, BKc>(sVw, kk),
                             kmajor<HD, BQ>(dob, kk), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::pin(st);
      hopper::pin(dpt);
      // P^T = exp(S^T - lse), masked entries exactly 0.
      const bool edge = (causal && kw + 15 > q0) || kw + 16 > Sk;
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = 8 * c + 2 * t + (i & 1);
          const float p = hopper::ex2(fmaf(st[4 * c + i], kLog2e, -sl[qi]));
          st[4 * c + i] =
              edge & masked(q0 + qi, i < 2 ? key0 : key1, Sk, causal) ? 0.f
                                                                       : p;
        }
      // dV += bf16(P^T) . dO, in flight while dS^T is formed.
      uint32_t pa[BQ / 16][4];
      to_a<BQ>(pa, st);
      hopper::pin(dva);
      hopper::pin(pa);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hopper::wgmma_rs<HD>(dva, pa[kk], mnmajor<HD, BQ>(dob, kk));
      hopper::wgmma_commit();
      // dS^T = P^T * (dP^T - delta), rounded to bf16 where it becomes A.
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dpt[4 * c + i] = st[4 * c + i] *
                           (dpt[4 * c + i] - sl[BQ + 8 * c + 2 * t + (i & 1)]);
      // dK += dS^T . qs
      uint32_t da[BQ / 16][4];
      to_a<BQ>(da, dpt);
      hopper::pin(dka);
      hopper::pin(da);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        hopper::wgmma_rs<HD>(dka, da[kk], mnmajor<HD, BQ>(q, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::pin(dva);
      hopper::pin(dka);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(s));
  }

  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * HD;
  store_rows<HD>(dk + koff, rs, dka, key0, Sk, t, 1.f);
  store_rows<HD>(dv + koff, rs, dva, key0, Sk, t, 1.f);
}

// ------------------------------------------------- K3b backward dQ, bf16
// One block per (q tile of 128 rows, head, batch); warpgroup w owns rows
// 64w..64w+63. The producer streams key tiles of 128 (64 at head_dim 128,
// for registers) with K and V on one barrier, up to the diagonal. S = Q
// K^T and dP = dO V^T read both operands K-major; dQ += dS K takes dS
// from registers and K MN-major.
template <int HD>
struct DqTiles {
  static constexpr int BQ = 128, BK = HD == 128 ? 64 : 128, NS = 2;
  static constexpr size_t smem() {
    return 1024 + static_cast<size_t>(2 * BQ + 2 * NS * BK) * HD * 2 +
           8 * (1 + 2 * NS);
  }
};

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dq_bf16(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, bf16* __restrict__ dq,
    const float* __restrict__ lse, const float* __restrict__ delta, int H,
    int S, int Sk, int causal, float sm_scale) {
  using T = Tile<HD>;
  using C = DqTiles<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, NS = C::NS;
  constexpr uint32_t QB = BQ * HD * 2, KB = BK * HD * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = tile_base(smem_raw), sdO = sQ + QB;
  const uint32_t sK = sdO + QB, sV = sK + NS * KB;  // stage s at + s * KB
  const uint32_t bars = sV + NS * KB;
  const uint32_t barQ = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + NS + s); };

  const int h = blockIdx.y, b = blockIdx.z;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n = (kv_end + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(barQ, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kProducer) {
    hopper::reg_release<kProducerRegs>();
    if (warp != kProducer) return;
    if (lane == 0) {
      hopper::mbar_expect_tx(barQ, 2 * QB);
      T::template load<BQ>(sQ, &tq, barQ, h, q0, b);
      T::template load<BQ>(sdO, &tdo, barQ, h, q0, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % NS;
        if (j >= NS) hopper::mbar_wait(empty(s), ((j / NS) + 1) & 1);
        hopper::mbar_expect_tx(full(s), 2 * KB);
        T::template load<BK>(sK + s * KB, &tk, full(s), h, j * BK, b);
        T::template load<BK>(sV + s * KB, &tv, full(s), h, j * BK, b);
      }
    }
    return;
  }
  hopper::reg_claim<kConsumerRegs>();

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int rw = r0 + 16 * (warp & 3);
  const int row0 = rw + g, row1 = row0 + 8;
  const uint32_t sQw = sQ + 64 * wg * T::RB, sdOw = sdO + 64 * wg * T::RB;
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* db = delta + (static_cast<size_t>(b) * H + h) * S;
  const float lse0 = row0 < S ? lb[row0] * kLog2e : INFINITY;
  const float lse1 = row1 < S ? lb[row1] * kLog2e : INFINITY;
  const float dl0 = row0 < S ? db[row0] : 0.f;
  const float dl1 = row1 < S ? db[row1] : 0.f;
  float dqa[HD / 2];
  zero(dqa);

  hopper::mbar_wait(barQ, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % NS, k0 = j * BK;
    hopper::mbar_wait(full(s), (j / NS) & 1);
    if (!causal || k0 <= r0 + 63) {
      const uint32_t kt = sK + s * KB;
      float sc[BK / 2], dp[BK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<BK>(sc, kmajor<HD, BQ>(sQw, kk),
                             kmajor<HD, BK>(kt, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss<BK>(dp, kmajor<HD, BQ>(sdOw, kk),
                             kmajor<HD, BK>(sV + s * KB, kk), kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::pin(sc);
      hopper::pin(dp);
      const bool edge = (causal && k0 + BK - 1 > rw) || k0 + BK > Sk;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? row0 : row1;
          const float e =
              hopper::ex2(fmaf(sc[4 * c + i], kLog2e, i < 2 ? -lse0 : -lse1));
          const float p =
              edge & masked(row, k0 + 8 * c + 2 * t + (i & 1), Sk, causal)
                  ? 0.f
                  : e;
          sc[4 * c + i] = p * (dp[4 * c + i] - (i < 2 ? dl0 : dl1));  // dS
        }
      // dQ += bf16(dS) . K
      uint32_t da[BK / 16][4];
      to_a<BK>(da, sc);
      hopper::pin(dqa);
      hopper::pin(da);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_rs<HD>(dqa, da[kk], mnmajor<HD, BK>(kt, kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::pin(dqa);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(s));
  }

  store_rows<HD>(dq + (static_cast<size_t>(b) * S * H + h) * HD,
                 static_cast<size_t>(H) * HD, dqa, row0, S, t, sm_scale);
}

// ------------------------------------------------------ FMA kernels (f32)
// Tiles of rows in shared memory as f32, row stride HD + 1 so that lanes
// walking rows hit different banks.
template <int HD, typename T>
__device__ __forceinline__ void load_rows_f(float* s, const T* base, int row0,
                                            int rows, int n_valid,
                                            size_t row_stride) {
  for (int i = threadIdx.x; i < rows * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    s[r * (HD + 1) + c] =
        r < n_valid
            ? to_float(base[static_cast<size_t>(row0 + r) * row_stride + c])
            : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) acc += a[d] * b[d];
  return acc;
}

// K2, FMA: one block per (q tile of 16 rows, head, batch), key tiles of
// 32; the output accumulator lives in registers, thread t owning elements
// t, t + 128, .. of the [16, HD] tile.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_fma(
    T* __restrict__ o, float* __restrict__ lse, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v, int H, int S, int Sk,
    int causal) {
  constexpr int BQ = 16, BK = 32, P = HD + 1, E = BQ * HD / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BQ][P]
  float* sK = sQ + BQ * P;                          // [BK][P]
  float* sV = sK + BK * P;                          // [BK][P]
  float* sS = sV + BK * P;                          // [BQ][BK]
  float* sM = sS + BQ * BK;                         // [BQ]
  float* sL = sM + BQ;                              // [BQ]
  float* sA = sL + BQ;                              // [BQ]

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t qoff = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * HD;
  load_rows_f<HD>(sQ, q + qoff, q0, BQ, min(BQ, S - q0), rs);
  if (tid < BQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[E];
#pragma unroll
  for (int j = 0; j < E; ++j) acc[j] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_rows_f<HD>(sK, k + koff, k0, BK, min(BK, Sk - k0), rs);
    load_rows_f<HD>(sV, v + koff, k0, BK, min(BK, Sk - k0), rs);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const float s = dot_rows<HD>(sQ + r * P, sK + c * P);
      sS[e] = masked(q0 + r, k0 + c, Sk, causal) ? kNegInf : s;
    }
    __syncthreads();
    if (tid < BQ) {
      float* row = sS + tid * BK;
      float mx = sM[tid];
      for (int c = 0; c < BK; ++c) mx = fmaxf(mx, row[c]);
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        const float p = expf(row[c] - mx);
        sum += p;
        row[c] = round_to<T>(p);
      }
      sA[tid] = expf(sM[tid] - mx);
      sL[tid] = sL[tid] * sA[tid] + sum;
      sM[tid] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = tid + j * kThreads, r = e / HD, d = e % HD;
      float a = acc[j] * sA[r];
      for (int c = 0; c < BK; ++c) a += sS[r * BK + c] * sV[c * P + d];
      acc[j] = a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid + j * kThreads, r = e / HD, d = e % HD;
    if (q0 + r < S)
      o[qoff + static_cast<size_t>(q0 + r) * rs + d] = from_float<T>(acc[j] / sL[r]);
  }
  if (tid < BQ && q0 + tid < S)
    lse[(static_cast<size_t>(b) * H + h) * S + q0 + tid] = sM[tid] + logf(sL[tid]);
}

// K3a, FMA: one block per (k tile of 16 keys, head, batch), q tiles of 32.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_fma(
    T* __restrict__ dk, T* __restrict__ dv, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta, int H,
    int S, int Sk, int causal) {
  constexpr int BKc = 16, BQ = 32, P = HD + 1, E = BKc * HD / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [BKc][P]
  float* sV = sK + BKc * P;                         // [BKc][P]
  float* sQ = sV + BKc * P;                         // [BQ][P]
  float* sdO = sQ + BQ * P;                         // [BQ][P]
  float* sP = sdO + BQ * P;                         // [BKc][BQ]
  float* sdS = sP + BKc * BQ;                       // [BKc][BQ]
  float* sL = sdS + BKc * BQ;                       // [BQ]
  float* sD = sL + BQ;                              // [BQ]

  const int h = blockIdx.y, b = blockIdx.z, c0 = blockIdx.x * BKc;
  const int tid = threadIdx.x;
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t qoff = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * HD;
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* db = delta + (static_cast<size_t>(b) * H + h) * S;
  load_rows_f<HD>(sK, k + koff, c0, BKc, min(BKc, Sk - c0), rs);
  load_rows_f<HD>(sV, v + koff, c0, BKc, min(BKc, Sk - c0), rs);
  float dka[E], dva[E];
#pragma unroll
  for (int j = 0; j < E; ++j) dka[j] = dva[j] = 0.f;

  const int first = causal ? (c0 / BQ) * BQ : 0;
  for (int q0 = first; q0 < S; q0 += BQ) {
    __syncthreads();
    const int nv = min(BQ, S - q0);
    load_rows_f<HD>(sQ, q + qoff, q0, BQ, nv, rs);
    load_rows_f<HD>(sdO, dO + qoff, q0, BQ, nv, rs);
    for (int i = tid; i < BQ; i += kThreads) {
      sL[i] = i < nv ? lb[q0 + i] : INFINITY;
      sD[i] = i < nv ? db[q0 + i] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < BKc * BQ; e += kThreads) {
      const int kr = e / BQ, qi = e % BQ;
      const float s = dot_rows<HD>(sK + kr * P, sQ + qi * P);
      const float p =
          masked(q0 + qi, c0 + kr, Sk, causal) ? 0.f : expf(s - sL[qi]);
      const float dp = dot_rows<HD>(sV + kr * P, sdO + qi * P);
      sP[e] = round_to<T>(p);
      sdS[e] = round_to<T>(p * (dp - sD[qi]));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = tid + j * kThreads, kr = e / HD, d = e % HD;
      float a = dva[j], c = dka[j];
      for (int qi = 0; qi < BQ; ++qi) {
        a += sP[kr * BQ + qi] * sdO[qi * P + d];
        c += sdS[kr * BQ + qi] * sQ[qi * P + d];
      }
      dva[j] = a;
      dka[j] = c;
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid + j * kThreads, kr = e / HD, d = e % HD;
    if (c0 + kr < Sk) {
      const size_t off = koff + static_cast<size_t>(c0 + kr) * rs + d;
      dk[off] = from_float<T>(dka[j]);
      dv[off] = from_float<T>(dva[j]);
    }
  }
}

// K3b, FMA: one block per (q tile of 16 rows, head, batch), key tiles of
// 32.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fma(
    T* __restrict__ dq, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta, int H,
    int S, int Sk, int causal, float sm_scale) {
  constexpr int BQ = 16, BK = 32, P = HD + 1, E = BQ * HD / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BQ][P]
  float* sdO = sQ + BQ * P;                         // [BQ][P]
  float* sK = sdO + BQ * P;                         // [BK][P]
  float* sV = sK + BK * P;                          // [BK][P]
  float* sdS = sV + BK * P;                         // [BQ][BK]
  float* sL = sdS + BQ * BK;                        // [BQ]
  float* sD = sL + BQ;                              // [BQ]

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t qoff = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * HD;
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* db = delta + (static_cast<size_t>(b) * H + h) * S;
  const int nv = min(BQ, S - q0);
  load_rows_f<HD>(sQ, q + qoff, q0, BQ, nv, rs);
  load_rows_f<HD>(sdO, dO + qoff, q0, BQ, nv, rs);
  for (int i = tid; i < BQ; i += kThreads) {
    sL[i] = i < nv ? lb[q0 + i] : INFINITY;
    sD[i] = i < nv ? db[q0 + i] : 0.f;
  }
  float dqa[E];
#pragma unroll
  for (int j = 0; j < E; ++j) dqa[j] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    load_rows_f<HD>(sK, k + koff, k0, BK, min(BK, Sk - k0), rs);
    load_rows_f<HD>(sV, v + koff, k0, BK, min(BK, Sk - k0), rs);
    __syncthreads();
    for (int e = tid; e < BQ * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const float s = dot_rows<HD>(sQ + r * P, sK + c * P);
      const float p = masked(q0 + r, k0 + c, Sk, causal) ? 0.f : expf(s - sL[r]);
      const float dp = dot_rows<HD>(sdO + r * P, sV + c * P);
      sdS[e] = round_to<T>(p * (dp - sD[r]));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = tid + j * kThreads, r = e / HD, d = e % HD;
      float a = dqa[j];
      for (int c = 0; c < BK; ++c) a += sdS[r * BK + c] * sK[c * P + d];
      dqa[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = tid + j * kThreads, r = e / HD, d = e % HD;
    if (q0 + r < S)
      dq[qoff + static_cast<size_t>(q0 + r) * rs + d] = from_float<T>(dqa[j] * sm_scale);
  }
}

// ------------------------------------------------------------- launches
// Kernels above 48 KB of dynamic shared memory need the opt-in attribute;
// it is set on every launch (a cheap host call) so no static state is
// shared between threads. The bf16 kernels' tensor maps are built on the
// host at each launch and passed by value.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int HD>
cudaError_t fwd(int dtype, void* o, void* lse, const void* q, const void* k,
                const void* v, int B, int H, int S, int Sk, int causal,
                cudaStream_t st) {
  cudaError_t err;
  if (dtype == 1) {
    using C = FwdTiles;
    CUtensorMap mq, mk, mv;
    if (!hopper::bshd_map(&mq, q, B, S, H, HD, C::BQ) ||
        !hopper::bshd_map(&mk, k, B, Sk, H, HD, C::BK) ||
        !hopper::bshd_map(&mv, v, B, Sk, H, HD, C::BK))
      return cudaErrorInvalidValue;
    const size_t smem = C::smem<HD>();
    if ((err = prepare(flash_fwd_bf16<HD>, smem)) != cudaSuccess) return err;
    flash_fwd_bf16<HD><<<dim3(cdiv(S, C::BQ), H, B), kWsThreads, smem, st>>>(
        mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), H, S,
        Sk, causal);
  } else {
    const size_t smem = sizeof(float) * (80 * (HD + 1) + 16 * 32 + 48);
    if ((err = prepare(flash_fwd_fma<HD, float>, smem)) != cudaSuccess)
      return err;
    flash_fwd_fma<HD, float><<<dim3(cdiv(S, 16), H, B), kThreads, smem, st>>>(
        static_cast<float*>(o), static_cast<float*>(lse),
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), H, S, Sk, causal);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t dkdv(int dtype, void* dk, void* dv, const void* q, const void* k,
                 const void* v, const void* dO, const void* lse,
                 const void* delta, int B, int H, int S, int Sk, int causal,
                 cudaStream_t st) {
  cudaError_t err;
  if (dtype == 1) {
    using C = DkdvTiles<HD>;
    CUtensorMap mq, mk, mv, mdo;
    if (!hopper::bshd_map(&mq, q, B, S, H, HD, C::BQ) ||
        !hopper::bshd_map(&mk, k, B, Sk, H, HD, C::BKc) ||
        !hopper::bshd_map(&mv, v, B, Sk, H, HD, C::BKc) ||
        !hopper::bshd_map(&mdo, dO, B, S, H, HD, C::BQ))
      return cudaErrorInvalidValue;
    const size_t smem = C::smem();
    if ((err = prepare(flash_bwd_dkdv_bf16<HD>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dkdv_bf16<HD>
        <<<dim3(cdiv(Sk, C::BKc), H, B), kWsThreads, smem, st>>>(
            mq, mk, mv, mdo, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            H, S, Sk, causal);
  } else {
    const size_t smem =
        sizeof(float) * (96 * (HD + 1) + 2 * 16 * 32 + 2 * 32);
    if ((err = prepare(flash_bwd_dkdv_fma<HD, float>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dkdv_fma<HD, float>
        <<<dim3(cdiv(Sk, 16), H, B), kThreads, smem, st>>>(
            static_cast<float*>(dk), static_cast<float*>(dv),
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(dO),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            H, S, Sk, causal);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t dq(int dtype, void* dqp, const void* q, const void* k,
               const void* v, const void* dO, const void* lse,
               const void* delta, int B, int H, int S, int Sk, int causal,
               float sm_scale, cudaStream_t st) {
  cudaError_t err;
  if (dtype == 1) {
    using C = DqTiles<HD>;
    CUtensorMap mq, mk, mv, mdo;
    if (!hopper::bshd_map(&mq, q, B, S, H, HD, C::BQ) ||
        !hopper::bshd_map(&mk, k, B, Sk, H, HD, C::BK) ||
        !hopper::bshd_map(&mv, v, B, Sk, H, HD, C::BK) ||
        !hopper::bshd_map(&mdo, dO, B, S, H, HD, C::BQ))
      return cudaErrorInvalidValue;
    const size_t smem = C::smem();
    if ((err = prepare(flash_bwd_dq_bf16<HD>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dq_bf16<HD><<<dim3(cdiv(S, C::BQ), H, B), kWsThreads, smem, st>>>(
        mq, mk, mv, mdo, static_cast<bf16*>(dqp),
        static_cast<const float*>(lse), static_cast<const float*>(delta), H,
        S, Sk, causal, sm_scale);
  } else {
    const size_t smem = sizeof(float) * (96 * (HD + 1) + 16 * 32 + 2 * 16);
    if ((err = prepare(flash_bwd_dq_fma<HD, float>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dq_fma<HD, float><<<dim3(cdiv(S, 16), H, B), kThreads, smem, st>>>(
        static_cast<float*>(dqp), static_cast<const float*>(q),
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dO), static_cast<const float*>(lse),
        static_cast<const float*>(delta), H, S, Sk, causal, sm_scale);
  }
  return cudaGetLastError();
}

bool valid(int B, int H, int S, int Sk, int hd, int dtype) {
  return B >= 1 && H >= 1 && S >= 1 && Sk >= 1 && B <= 65535 && H <= 65535 &&
         (hd == 32 || hd == 64 || hd == 128) && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every q/k/v/o/dO/dq/dk/dv tensor);
// lse and delta are float32 [B, H, S]. Tensors are contiguous [B, S, H, hd]
// (k, v, dk, dv: [B, Sk, H, hd]), 16-byte aligned; hd is 32, 64 or 128.
extern "C" int rt_flash_fwd(void* o, void* lse, const void* q, const void* k,
                            const void* v, int B, int H, int S, int Sk,
                            int hd, int causal, int dtype, int device,
                            void* stream) {
  if (!valid(B, H, S, Sk, hd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: err = fwd<32>(dtype, o, lse, q, k, v, B, H, S, Sk, causal, st); break;
    case 64: err = fwd<64>(dtype, o, lse, q, k, v, B, H, S, Sk, causal, st); break;
    default: err = fwd<128>(dtype, o, lse, q, k, v, B, H, S, Sk, causal, st);
  }
  return static_cast<int>(err);
}

extern "C" int rt_flash_bwd_dkdv(void* dk, void* dv, const void* q,
                                 const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, int B,
                                 int H, int S, int Sk, int hd, int causal,
                                 int dtype, int device, void* stream) {
  if (!valid(B, H, S, Sk, hd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: err = dkdv<32>(dtype, dk, dv, q, k, v, dO, lse, delta, B, H, S, Sk, causal, st); break;
    case 64: err = dkdv<64>(dtype, dk, dv, q, k, v, dO, lse, delta, B, H, S, Sk, causal, st); break;
    default: err = dkdv<128>(dtype, dk, dv, q, k, v, dO, lse, delta, B, H, S, Sk, causal, st);
  }
  return static_cast<int>(err);
}

extern "C" int rt_flash_bwd_dq(void* dqp, const void* q, const void* k,
                               const void* v, const void* dO, const void* lse,
                               const void* delta, int B, int H, int S, int Sk,
                               int hd, int causal, float sm_scale, int dtype,
                               int device, void* stream) {
  if (!valid(B, H, S, Sk, hd, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: err = dq<32>(dtype, dqp, q, k, v, dO, lse, delta, B, H, S, Sk, causal, sm_scale, st); break;
    case 64: err = dq<64>(dtype, dqp, q, k, v, dO, lse, delta, B, H, S, Sk, causal, sm_scale, st); break;
    default: err = dq<128>(dtype, dqp, q, k, v, dO, lse, delta, B, H, S, Sk, causal, sm_scale, st);
  }
  return static_cast<int>(err);
}
