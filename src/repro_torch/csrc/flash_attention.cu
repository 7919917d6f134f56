// Flash attention for Hopper (sm_90a) with exact or DAISM-approximate QK/PV:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h'] / sqrt(D)) v[b, j, h']
// with h' = h / (H / KH) (grouped-query heads), a causal mask by absolute
// index (key j <= query i) and a key-length mask (j < kv_len).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::_kernel
// (entry flash_attention, wrapper flash_attention_bhsd). It computes the
// same function, tile for tile along the keys:
//   * keys are walked in tiles of kBK = 128 in ascending order. The KV tile
//     width is part of the approximate function: p is rounded to bf16
//     relative to the running max after each tile, and the approximate
//     multiplier is not scale invariant. The query tile (kBQ = 64) is free:
//     every query row's arithmetic is independent of the others;
//   * per tile: s = q k^T * scale, masked lanes set to -1e30; m_new =
//     max(m, rowmax s); corr = exp(m - m_new); p = exp(s - m_new) with masked
//     lanes zeroed; l = l * corr + rowsum p; acc = acc * corr + p v. At the
//     end o = acc / max(l, 1e-30), rounded to the input type. exp is expf
//     (no fast-math), bf16 rounding is round-to-nearest-even;
//   * exact mode multiplies in f32 (fmaf); approximate mode runs the
//     DAISM product of approx_product.cuh on bf16 fields with q and p as
//     the multiplier and k and v as the multiplicand, as the reference's
//     approx_matmul_tile(q, k.T) and approx_matmul_tile(p.bf16, v) do.
//
// What bounds it. Approximate mode is bound by integer operations: every
// score and every p.v term is a DAISM product of about 20 integer
// operations on the SM's 64 INT32 lanes, and a causal (S, S) head needs
// S (S + 1) / 2 score pairs, each with 2 D products. Exact mode is bound by
// operations too (4 D flops per pair against the tensor cores' 989 TFLOP/s
// in bf16), but this kernel runs its f32 FMAs on the CUDA cores (67
// TFLOP/s) and issues no wgmma or mma, so it reaches at most ~7% of that
// bound. Bytes (q, k, v and o once) are far below either.
//
// Design (simple and correct first):
//   * one block of 256 threads per (batch x head, 64-query tile); a loop
//     inside the block walks the KV tiles (the TPU's sequential innermost
//     grid axis); tiles above the causal diagonal or past kv_len are
//     skipped, which changes no result (they contribute exactly nothing);
//   * the q tile is decomposed once into shared memory (packed sign,
//     exponent, mantissa lines and head weight in one word per element);
//     each K tile and then each V tile is decomposed once per tile into
//     one shared buffer, so the decomposition is spread over the 64 or
//     128 products each element enters;
//   * scores live in shared memory; one warp per row takes the row max,
//     the exps and the row sum, and writes p back in place (as the packed
//     fields of its bf16 rounding in approximate mode); m, l and the
//     correction per row live in shared memory, acc in registers
//     (4 rows x D/16 columns per thread);
//   * the grouped-query kv head is computed, not materialized by a repeat;
//     q, k, v, o are read and written through their strides, so the
//     (B, S, H, D) layout needs no transpose; ragged edges load as raw
//     zeros (a zero mantissa gives a zero product), query rows past Sq are
//     not stored, keys past kv_len are masked.
// wgmma, TMA and a ring of tiles in flight are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "approx_product.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 128;       // keys per KV tile: part of the function
constexpr int kMaxD = 128;     // largest head dim
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = kBQ / 16;     // query rows per thread
constexpr int kKeys = kBK / 16;     // scores per thread along the keys
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;
constexpr int kExpOffset = 2048;  // packed exponent = exponent + offset

// One element of the multiplier (q or p) packed into a word: mantissa lines
// in bits 0-7, head weight in bits 8-15, exponent + kExpOffset in 16-30,
// the f32 sign bit in bit 31.
template <int V>
__device__ __forceinline__ uint32_t pack_x(uint16_t bits) {
  const daism::XFields f = daism::decompose_x<V>(bits);
  return f.sign | (static_cast<uint32_t>(f.exp + kExpOffset) << 16) |
         (static_cast<uint32_t>(f.head) << 8) | static_cast<uint32_t>(f.lines);
}

__device__ __forceinline__ daism::XFields unpack_x(uint32_t w) {
  daism::XFields f;
  f.lines = static_cast<int>(w & 0xFFu);
  f.head = static_cast<int>((w >> 8) & 0xFFu);
  f.exp = static_cast<int>((w >> 16) & 0x7FFFu) - kExpOffset;
  f.sign = w & 0x80000000u;
  return f;
}

// One element of the multiplicand (k or v): mantissa with its hidden 1 in
// bits 0-15, biased exponent + kExpOffset in 16-30, sign in bit 31.
__device__ __forceinline__ uint32_t pack_w(uint16_t bits) {
  const daism::WFields f = daism::decompose_w(bits);
  return f.sign | (static_cast<uint32_t>(f.exp + kExpOffset) << 16) |
         static_cast<uint32_t>(f.man);
}

__device__ __forceinline__ daism::WFields unpack_w(uint32_t w) {
  daism::WFields f;
  f.man = static_cast<int>(w & 0xFFFFu);
  f.exp = static_cast<int>((w >> 16) & 0x7FFFu) - kExpOffset;
  f.sign = w & 0x80000000u;
  return f;
}

// Inputs are bf16 (raw bits) or f32 (exact mode only).
__device__ __forceinline__ float to_f32(uint16_t x) {
  return daism::bf16_to_f32(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ void store(uint16_t* dst, float x) {
  *dst = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

// A q or p element as the multiplier word of mode V.
template <int V, typename T>
__device__ __forceinline__ uint32_t encode_x(T x) {
  if constexpr (V == daism::kExact) {
    return __float_as_uint(to_f32(x));
  } else {
    return pack_x<V>(x);
  }
}

// A k or v element as the multiplicand word of mode V.
template <int V, typename T>
__device__ __forceinline__ uint32_t encode_w(T x) {
  if constexpr (V == daism::kExact) {
    return __float_as_uint(to_f32(x));
  } else {
    return pack_w(x);
  }
}

// p (f32) as the multiplier word: f32 for exact mode; in approximate mode
// its bf16 rounding (nearest even), as the reference's p.astype(bfloat16).
template <int V>
__device__ __forceinline__ uint32_t encode_p(float p) {
  if constexpr (V == daism::kExact) {
    return __float_as_uint(p);
  } else {
    return pack_x<V>(__bfloat16_as_ushort(__float2bfloat16_rn(p)));
  }
}

// acc + x * w in mode V (x, w: encoded words).
template <int V>
struct Mac {
  daism::XFields x;
  __device__ __forceinline__ explicit Mac(uint32_t xw) { x = unpack_x(xw); }
  __device__ __forceinline__ float operator()(float acc, uint32_t ww) const {
    return acc + daism::approx_product<V>(x, unpack_w(ww));
  }
};

template <>
struct Mac<daism::kExact> {
  float x;
  __device__ __forceinline__ explicit Mac(uint32_t xw) {
    x = __uint_as_float(xw);
  }
  __device__ __forceinline__ float operator()(float acc, uint32_t ww) const {
    return fmaf(x, __uint_as_float(ww), acc);
  }
};

struct Params {
  int H, KH, Sq, Skv, D, kv_len, causal;
  float scale;
  // element strides: batch, sequence, head (the head dim is contiguous)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
};

__host__ __device__ constexpr int smem_words(int d) {
  // q fields [d][kBQ + 1], k fields [d][kBK + 1] / v fields [kBK][d] in one
  // buffer, scores / p [kBQ][kBK], then m, l and corr per row
  return d * (kBQ + 1) + d * (kBK + 1) + kBQ * kBK + 3 * kBQ;
}

// NC: output columns per thread (ceil(D / 16), a power of two <= 8)
template <int V, typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Params p) {
  extern __shared__ uint32_t smem[];
  const int D = p.D;
  uint32_t* qs = smem;                      // [D][kBQ + 1]
  uint32_t* kv = qs + D * (kBQ + 1);        // [D][kBK + 1] or [kBK][D]
  uint32_t* ss = kv + D * (kBK + 1);        // [kBQ][kBK]
  float* m_s = reinterpret_cast<float*>(ss + kBQ * kBK);
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = blockIdx.x * kBQ;

  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;
  T* ob = o + b * p.o_sb + h * p.o_sh;

  // the q tile's fields, once (consecutive threads: consecutive d)
  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int gq = q0 + r;
    const T x = gq < p.Sq ? qb[gq * p.q_ss + d] : T(0);
    qs[d * (kBQ + 1) + r] = encode_x<V>(x);
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  __syncthreads();

  float acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  // tiles wholly above the causal diagonal or past kv_len contribute
  // nothing: skip them
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    // K tile -> multiplicand fields [d][key]
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D;
      const int d = idx % D;
      const int gk = k0 + c;
      const T x = gk < p.Skv ? kb[gk * p.k_ss + d] : T(0);
      kv[d * (kBK + 1) + c] = encode_w<V>(x);
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j, the sum over d ascending
    {
      float s[kRows][kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        uint32_t kw[kKeys];
#pragma unroll
        for (int j = 0; j < kKeys; ++j) kw[j] = kv[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const Mac<V> mac(qs[d * (kBQ + 1) + ty + 16 * i]);
#pragma unroll
          for (int j = 0; j < kKeys; ++j) s[i][j] = mac(s[i][j], kw[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          const int c = tx + 16 * j;
          const int gk = k0 + c;
          const bool keep = gk < p.kv_len && (!p.causal || gk <= q0 + r);
          ss[r * kBK + c] = __float_as_uint(keep ? s[i][j] * p.scale : kMasked);
        }
      }
    }
    __syncthreads();

    // one warp per row: max, exps, sum; p replaces s in place
    for (int r = warp; r < kBQ; r += kWarps) {
      float sv[kBK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kBK / 32; ++c) {
        sv[c] = __uint_as_float(ss[r * kBK + lane + 32 * c]);
        mx = fmaxf(mx, sv[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kBK / 32; ++c) {
        const int gk = k0 + lane + 32 * c;
        const bool keep = gk < p.kv_len && (!p.causal || gk <= q0 + r);
        const float pc = keep ? expf(sv[c] - m_new) : 0.0f;
        sum += pc;
        ss[r * kBK + lane + 32 * c] = encode_p<V>(pc);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }

    // V tile -> multiplicand fields [key][d] (K is no longer read)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D;
      const int d = idx % D;
      const int gk = k0 + c;
      const T x = gk < p.Skv ? vb[gk * p.v_ss + d] : T(0);
      kv[c * D + d] = encode_w<V>(x);
    }
    __syncthreads();

    // p v over the tile's keys ascending; acc = acc * corr + p v
    {
      float pv[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) pv[i][j] = 0.0f;
      for (int c = 0; c < kBK; ++c) {
        uint32_t vw[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int d = tx + 16 * j;
          vw[j] = d < D ? kv[c * D + d] : 0u;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const Mac<V> mac(ss[(ty + 16 * i) * kBK + c]);
#pragma unroll
          for (int j = 0; j < NC; ++j) pv[i][j] = mac(pv[i][j], vw[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float corr = c_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = acc[i][j] * corr + pv[i][j];
      }
    }
    __syncthreads();  // the next tile overwrites kv and ss
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    const int gq = q0 + r;
    if (gq >= p.Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(&ob[gq * p.o_ss + d], acc[i][j] / l);
    }
  }
}

template <int V, typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o,
              const Params& p, dim3 grid, cudaStream_t s) {
  const int bytes = smem_words(p.D) * static_cast<int>(sizeof(uint32_t));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<V, T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd<V, T, NC><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

template <int V, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, dim3 grid, cudaStream_t s) {
  const int nc = (p.D + 15) / 16;
  if (nc <= 1) return launch_nc<V, T, 1>(q, k, v, o, p, grid, s);
  if (nc <= 2) return launch_nc<V, T, 2>(q, k, v, o, p, grid, s);
  if (nc <= 4) return launch_nc<V, T, 4>(q, k, v, o, p, grid, s);
  return launch_nc<V, T, 8>(q, k, v, o, p, grid, s);
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, does not synchronize; returns cudaGetLastError() of the launch
// (0 = ok). `strides` holds 12 element strides: batch, sequence and head
// of q, k, v and o, in that order (the head dim is contiguous). `is_f32`:
// the inputs and output are f32 (exact mode only) instead of bf16.
// The caller guarantees 1 <= D <= 128, H % KH == 0, B * H <= 65535,
// 1 <= kv_len <= Skv and Sq >= 1.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KH, int Sq,
                               int Skv, int D, int kv_len, int causal,
                               float scale, int variant, int is_f32,
                               const long long* strides, void* stream) {
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  Params p{H, KH, Sq, Skv, D, kv_len, causal, scale,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11]};
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    if (variant != daism::kExact)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<daism::kExact, float>(q, k, v, o, p, grid, s);
  }
  switch (variant) {
    case daism::kExact:
      return launch<daism::kExact, uint16_t>(q, k, v, o, p, grid, s);
    case daism::kFla:
      return launch<daism::kFla, uint16_t>(q, k, v, o, p, grid, s);
    case daism::kHla:
      return launch<daism::kHla, uint16_t>(q, k, v, o, p, grid, s);
    case daism::kPc2:
      return launch<daism::kPc2, uint16_t>(q, k, v, o, p, grid, s);
    case daism::kPc3:
      return launch<daism::kPc3, uint16_t>(q, k, v, o, p, grid, s);
    case daism::kPc2Tr:
      return launch<daism::kPc2Tr, uint16_t>(q, k, v, o, p, grid, s);
    case daism::kPc3Tr:
      return launch<daism::kPc3Tr, uint16_t>(q, k, v, o, p, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
