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
//
// Layout: q, k, v, o, dO, dq, dk, dv are read and written in the public
// [B, S, H, hd] layout (contiguous), so no transposed copies are made
// around the kernels; a (batch, head) row is hd contiguous elements,
// H * hd elements apart from the next position. lse and delta are f32
// [B, H, S].
//
// The TPU backward carried dQ in VMEM across the sequential k-block sweep
// of one core ("not portable flash"). Hopper blocks run in no order, so the
// backward is two kernels: K3a walks q tiles for its k tile and writes dK,
// dV; K3b walks k tiles for its q tile and writes dQ. Both recompute p from
// lse; there are no atomics, so every gradient is deterministic.
//
// What bounds them: at GPT-2 shapes (hd 64, S 1024) the matrix products
// (4 hd flops per visible (q, k) pair forward, 8 hd and 6 hd in K3a and
// K3b) put the forward near the bytes/operations ridge and the backward
// kernels on the operations side. The bf16 kernels run every product on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), keep the
// softmax statistics and accumulators in registers, and stage K/V (or
// Q/dO) tiles through shared memory, never materialising s or p in device
// memory. Tiles past the causal diagonal are skipped, never visited; a
// ragged tail (S or Sk not a multiple of the tile) is zero-filled and
// masked. Not yet done (later work): wgmma/TMA, cp.async double
// buffering, ldmatrix fragment loads.
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

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kThreads = 128;      // 4 warps per block, every kernel

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

__device__ __forceinline__ bool masked(int row, int col, int Sk, int causal) {
  return col >= Sk || (causal && col > row);
}

// ------------------------------------------------------------ bf16 tiles
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 values as one bf16 pair, the lower index in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a . b for one m16n8k16 tile (bf16 in, f32 accumulate). Fragment
// layout (PTX ISA, mma.m16n8k16): with g = lane / 4 and t = lane % 4,
// a[0] = A[g][2t..], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..],
// a[3] = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g];
// c[0..1] = C[g][2t..], c[2..3] = C[g+8][2t..].
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* t, int stride,
                                       int r0, int c0, int g, int q4) {
  a[0] = ld32(t + (r0 + g) * stride + c0 + 2 * q4);
  a[1] = ld32(t + (r0 + g + 8) * stride + c0 + 2 * q4);
  a[2] = ld32(t + (r0 + g) * stride + c0 + 8 + 2 * q4);
  a[3] = ld32(t + (r0 + g + 8) * stride + c0 + 8 + 2 * q4);
}

// A fragment for k-step kk from two C tiles (n-tiles 2kk, 2kk+1) held in
// registers: the accumulator of one product is the A operand of the next,
// rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Rows row0..row0+ROWS-1 (those < n_valid valid, the rest zero) of a
// [*, H, HD] tensor at `base` (position 0 of one (batch, head)) into a
// row-major shared tile with row stride HD + 8 and, when `t` is given, a
// transposed tile t[d][r] with row stride ROWS + 8.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, bf16* t, const bf16* base,
                                          int row0, int n_valid,
                                          size_t row_stride) {
  constexpr int kVec = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_valid)
      val = *reinterpret_cast<const uint4*>(
          base + static_cast<size_t>(row0 + r) * row_stride + c);
    if (s != nullptr) *reinterpret_cast<uint4*>(s + r * (HD + 8) + c) = val;
    if (t != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) t[(c + j) * (ROWS + 8) + r] = e[j];
    }
  }
}

// ------------------------------------------------------ K2 forward, bf16
// One block per (q tile of 64 rows, head, batch); warp w owns rows
// 16w..16w+15 of the tile. Key tiles of 64 are staged as K (row-major)
// and V^T in shared memory.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(
    bf16* __restrict__ o, float* __restrict__ lse, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v, int H, int S,
    int Sk, int causal) {
  constexpr int BQ = 64, BK = 64, STR = HD + 8, TSTR = BK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][STR]
  bf16* sK = sQ + BQ * STR;                      // [BK][STR]
  bf16* sVt = sK + BK * STR;                     // [HD][TSTR]

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3, wr = warp * 16;
  const size_t rs = static_cast<size_t>(H) * HD;
  const bf16* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * H + h) * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * H + h) * HD;

  load_tile<HD, BQ>(sQ, nullptr, qb, q0, min(BQ, S - q0), rs);

  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // Causal: rows of this tile see no key at or past q0 + BQ.
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<HD, BK>(sK, nullptr, kb, k0, min(BK, Sk - k0), rs);
    load_tile<HD, BK>(nullptr, sVt, vb, k0, min(BK, Sk - k0), rs);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sQ, STR, wr, kk * 16, g, q4);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const bf16* kr = sK + (n * 8 + g) * STR + kk * 16 + 2 * q4;
        mma(s[n], a, ld32(kr), ld32(kr + 8));
      }
    }
    // Only tiles that straddle the diagonal or the key tail pay for the
    // mask.
    if ((causal && k0 + BK - 1 > q0 + wr) || k0 + BK > Sk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (masked(i < 2 ? row0 : row1, k0 + n * 8 + 2 * q4 + (i & 1), Sk,
                     causal))
            s[n][i] = kNegInf;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = expf(s[n][0] - mx0);
      s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1);
      s[n][3] = expf(s[n][3] - mx1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
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
      acc[d][0] *= al0;
      acc[d][1] *= al0;
      acc[d][2] *= al1;
      acc[d][3] *= al1;
    }
    // acc += bf16(p) . V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const bf16* vr = sVt + (d * 8 + g) * TSTR + kk * 16 + 2 * q4;
        mma(acc[d], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

  bf16* ob = o + (static_cast<size_t>(b) * S * H + h) * HD;
  float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int c = d * 8 + 2 * q4;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * rs + c) =
          pack(acc[d][0] / l0, acc[d][1] / l0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * rs + c) =
          pack(acc[d][2] / l1, acc[d][3] / l1);
  }
  if (q4 == 0) {
    if (row0 < S) lb[row0] = m0 + logf(l0);
    if (row1 < S) lb[row1] = m1 + logf(l1);
  }
}

// ----------------------------------------------- K3a backward dK dV, bf16
// One block per (k tile of 64 keys, head, batch); warp w owns keys
// 16w..16w+15 and works on transposed products (keys are the M side):
// S^T = K Q^T, dP^T = V dO^T. It walks q tiles of BQ rows from the
// diagonal on. Padding q rows get lse = +inf and delta = 0, so their p
// and dS are exactly 0.
template <int HD, int BQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_bf16(
    bf16* __restrict__ dk, bf16* __restrict__ dv, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int S, int Sk, int causal) {
  constexpr int BKc = 64, STR = HD + 8, QT = BQ + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BKc][STR]
  bf16* sV = sK + BKc * STR;                     // [BKc][STR]
  bf16* sQ = sV + BKc * STR;                     // [BQ][STR]
  bf16* sQt = sQ + BQ * STR;                     // [HD][QT]
  bf16* sdO = sQt + HD * QT;                     // [BQ][STR]
  bf16* sdOt = sdO + BQ * STR;                   // [HD][QT]
  float* sL = reinterpret_cast<float*>(sdOt + HD * QT);  // [BQ]
  float* sD = sL + BQ;                                   // [BQ]

  const int h = blockIdx.y, b = blockIdx.z, c0 = blockIdx.x * BKc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3, kr = warp * 16;
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t qoff = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * HD;
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* db = delta + (static_cast<size_t>(b) * H + h) * S;

  load_tile<HD, BKc>(sK, nullptr, k + koff, c0, min(BKc, Sk - c0), rs);
  load_tile<HD, BKc>(sV, nullptr, v + koff, c0, min(BKc, Sk - c0), rs);

  const int key0 = c0 + kr + g, key1 = key0 + 8;
  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[d][i] = dva[d][i] = 0.f;

  // Causal: q rows before c0 see none of these keys.
  const int first = causal ? (c0 / BQ) * BQ : 0;
  for (int q0 = first; q0 < S; q0 += BQ) {
    __syncthreads();
    const int nv = min(BQ, S - q0);
    load_tile<HD, BQ>(sQ, sQt, q + qoff, q0, nv, rs);
    load_tile<HD, BQ>(sdO, sdOt, dO + qoff, q0, nv, rs);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      sL[i] = i < nv ? lb[q0 + i] : INFINITY;
      sD[i] = i < nv ? db[q0 + i] : 0.f;
    }
    __syncthreads();

    // P^T = exp(K Q^T - lse), masked entries exactly 0.
    float st[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sK, STR, kr, kk * 16, g, q4);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const bf16* qr = sQ + (n * 8 + g) * STR + kk * 16 + 2 * q4;
        mma(st[n], a, ld32(qr), ld32(qr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = n * 8 + 2 * q4 + (i & 1);
        st[n][i] = masked(q0 + qi, i < 2 ? key0 : key1, Sk, causal)
                       ? 0.f
                       : expf(st[n][i] - sL[qi]);
      }
    // dV += bf16(P^T) . dO
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const bf16* r = sdOt + (d * 8 + g) * QT + kk * 16 + 2 * q4;
        mma(dva[d], a, ld32(r), ld32(r + 8));
      }
    }
    // dP^T = V dO^T, then dS^T = P^T * (dP^T - delta) (rounded to bf16
    // where it becomes the A operand).
    float dpt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sV, STR, kr, kk * 16, g, q4);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const bf16* r = sdO + (n * 8 + g) * STR + kk * 16 + 2 * q4;
        mma(dpt[n], a, ld32(r), ld32(r + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dpt[n][i] = st[n][i] * (dpt[n][i] - sD[n * 8 + 2 * q4 + (i & 1)]);
    // dK += dS^T . qs
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const bf16* r = sQt + (d * 8 + g) * QT + kk * 16 + 2 * q4;
        mma(dka[d], a, ld32(r), ld32(r + 8));
      }
    }
  }

  bf16* dkb = dk + koff;
  bf16* dvb = dv + koff;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int c = d * 8 + 2 * q4;
    if (key0 < Sk) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * rs + c) = pack(dka[d][0], dka[d][1]);
      *reinterpret_cast<uint32_t*>(dvb + key0 * rs + c) = pack(dva[d][0], dva[d][1]);
    }
    if (key1 < Sk) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * rs + c) = pack(dka[d][2], dka[d][3]);
      *reinterpret_cast<uint32_t*>(dvb + key1 * rs + c) = pack(dva[d][2], dva[d][3]);
    }
  }
}

// ------------------------------------------------- K3b backward dQ, bf16
// One block per (q tile of 64 rows, head, batch); warp w owns rows
// 16w..16w+15. It walks key tiles of BK up to the diagonal, staging K
// (row-major and transposed) and V.
template <int HD, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(
    bf16* __restrict__ dq, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int S, int Sk, int causal,
    float sm_scale) {
  constexpr int BQ = 64, STR = HD + 8, KT = BK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][STR]
  bf16* sdO = sQ + BQ * STR;                     // [BQ][STR]
  bf16* sK = sdO + BQ * STR;                     // [BK][STR]
  bf16* sKt = sK + BK * STR;                     // [HD][KT]
  bf16* sV = sKt + HD * KT;                      // [BK][STR]

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3, wr = warp * 16;
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t qoff = (static_cast<size_t>(b) * S * H + h) * HD;
  const size_t koff = (static_cast<size_t>(b) * Sk * H + h) * HD;
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * S;
  const float* db = delta + (static_cast<size_t>(b) * H + h) * S;

  const int nv = min(BQ, S - q0);
  load_tile<HD, BQ>(sQ, nullptr, q + qoff, q0, nv, rs);
  load_tile<HD, BQ>(sdO, nullptr, dO + qoff, q0, nv, rs);
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const float lse0 = row0 < S ? lb[row0] : INFINITY;
  const float lse1 = row1 < S ? lb[row1] : INFINITY;
  const float dl0 = row0 < S ? db[row0] : 0.f;
  const float dl1 = row1 < S ? db[row1] : 0.f;

  float dqa[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    const int kv = min(BK, Sk - k0);
    load_tile<HD, BK>(sK, sKt, k + koff, k0, kv, rs);
    load_tile<HD, BK>(sV, nullptr, v + koff, k0, kv, rs);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], ad[4];
      load_a(a, sQ, STR, wr, kk * 16, g, q4);
      load_a(ad, sdO, STR, wr, kk * 16, g, q4);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const bf16* kr = sK + (n * 8 + g) * STR + kk * 16 + 2 * q4;
        mma(s[n], a, ld32(kr), ld32(kr + 8));
        const bf16* vr = sV + (n * 8 + g) * STR + kk * 16 + 2 * q4;
        mma(dp[n], ad, ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? row0 : row1;
        const float p = masked(row, k0 + n * 8 + 2 * q4 + (i & 1), Sk, causal)
                            ? 0.f
                            : expf(s[n][i] - (i < 2 ? lse0 : lse1));
        s[n][i] = p * (dp[n][i] - (i < 2 ? dl0 : dl1));  // dS
      }
    // dQ += bf16(dS) . K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const bf16* r = sKt + (d * 8 + g) * KT + kk * 16 + 2 * q4;
        mma(dqa[d], a, ld32(r), ld32(r + 8));
      }
    }
  }

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int c = d * 8 + 2 * q4;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(dqb + row0 * rs + c) =
          pack(dqa[d][0] * sm_scale, dqa[d][1] * sm_scale);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(dqb + row1 * rs + c) =
          pack(dqa[d][2] * sm_scale, dqa[d][3] * sm_scale);
  }
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
// shared between threads.
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
    const size_t smem = sizeof(bf16) * (128 * (HD + 8) + HD * 72);
    if ((err = prepare(flash_fwd_bf16<HD>, smem)) != cudaSuccess) return err;
    flash_fwd_bf16<HD><<<dim3(cdiv(S, 64), H, B), kThreads, smem, st>>>(
        static_cast<bf16*>(o), static_cast<float*>(lse),
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), H, S, Sk, causal);
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
    constexpr int BQ = HD == 128 ? 32 : 64;
    const size_t smem = sizeof(bf16) * (2 * 64 * (HD + 8) + 2 * BQ * (HD + 8) +
                                        2 * HD * (BQ + 8)) +
                        sizeof(float) * 2 * BQ;
    if ((err = prepare(flash_bwd_dkdv_bf16<HD, BQ>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dkdv_bf16<HD, BQ>
        <<<dim3(cdiv(Sk, 64), H, B), kThreads, smem, st>>>(
            static_cast<bf16*>(dk), static_cast<bf16*>(dv),
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
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
    constexpr int BK = 64;
    const size_t smem =
        sizeof(bf16) * ((128 + 2 * BK) * (HD + 8) + HD * (BK + 8));
    if ((err = prepare(flash_bwd_dq_bf16<HD, BK>, smem)) != cudaSuccess)
      return err;
    flash_bwd_dq_bf16<HD, BK><<<dim3(cdiv(S, 64), H, B), kThreads, smem, st>>>(
        static_cast<bf16*>(dqp), static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dO), static_cast<const float*>(lse),
        static_cast<const float*>(delta), H, S, Sk, causal, sm_scale);
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
