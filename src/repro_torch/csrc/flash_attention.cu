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
//     (no fast-math), bf16 rounding is round-to-nearest-even.
//
// Two kernels, chosen by dtype and variant alone (never as a fallback):
//
// flash_fwd_tc: exact mode on bf16 q, k, v, on the tensor cores.
//   What bounds it: 4 D flops per causal score pair on the bf16 tensor
//   cores (989 TFLOP/s; 1.5x that work here, see PV below), then the f32
//   softmax on the CUDA cores: an expf and ~15 other f32 operations per
//   score, with the exps on the SFU (16 a clock an SM). Bytes (q, k, v and
//   o once) are far below either. Design, FlashAttention-2's shape:
//   * one block of 4 warps per (batch x head, 64-query tile), each warp
//     owning 16 query rows; the grid issues the longest causal query tiles
//     first, so the causal imbalance leaves no tail;
//   * q is loaded once into registers (ldmatrix fragments); K and V tiles
//     are bf16 in shared memory (2 bytes an element, rows padded by 16
//     bytes so ldmatrix does not conflict) in a 2-stage ring filled with
//     cp.async while the previous tile computes; D is padded to a multiple
//     of 16 with zeros, which add exactly 0; 72 KB at D = 64, 3 blocks an SM;
//   * S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate): bf16
//     products are exact in f32, so the scores differ from the reference's
//     f32 dot only in summation order. The online softmax stays in
//     registers (row max and row sum by quad shuffles);
//   * the reference multiplies an f32 p by v: p is split into p_hi =
//     bf16(p) and p_lo = bf16(p - p_hi), and PV runs as p_hi V + p_lo V
//     (V through ldmatrix.trans), which keeps p to ~16 mantissa bits. The
//     QK accumulator's layout is the PV A fragment's, so p never goes
//     through shared memory;
//   * a warp skips the key columns above its causal diagonal.
//   Head dims above 128 (KD = 12 for D <= 192, 16 for D <= 256, D padded
//   with zeros): a warp's 16 x D f32 accumulator alone takes 8 KD registers
//   a thread (128 at D = 256), so with q's fragments in registers (4 KD)
//   and 128 scores (64) it would pass the 255-register limit, and a 2-stage
//   ring of 128-key K and V tiles (4 x 128 x 264 x 2 bytes at D = 256)
//   would pass the 227 KB of shared memory. So these dims take 64-key
//   tiles (32 score registers; in exact mode the tile width changes only
//   the summation order), read q's fragments from shared memory at each
//   step, and load one 16-column V fragment at a time for its two MMAs:
//   165 KB of shared memory at D = 256, one block an SM.
//
// flash_fwd: the six approximate variants, and exact mode on f32 inputs
//   (the tensor cores' TF32 would break the f32 bound). Approximate mode
//   runs the DAISM product of approx_product.cuh on bf16 fields with q and
//   p as the multiplier and k and v as the multiplicand, as the reference's
//   approx_matmul_tile(q, k.T) and approx_matmul_tile(p.bf16, v) do; f32
//   exact mode multiplies in f32 (fmaf).
//   What bounds it: integer operations. Every score and every p.v term is a
//   DAISM product of about 20 integer operations on the SM's 64 INT32
//   lanes, and a causal (S, S) head needs S (S + 1) / 2 score pairs, each
//   with 2 D products. Design (simple and correct first):
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
//     (4 rows x D/16 columns per thread, D/16 rounded up to 1, 2, 4, 8, 12
//     or 16). At D = 256 the fields take 227 KB of shared memory (one block
//     an SM).
// Both read q, k, v, o through their strides (the (B, S, H, D) layout needs
// no transpose), compute the grouped-query kv head instead of repeating it,
// load ragged edges as zeros (a zero mantissa gives a zero product), do not
// store query rows past Sq, and mask keys past kv_len.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "approx_product.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 128;       // keys per KV tile: part of the function
constexpr int kMaxD = 256;     // largest head dim
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

// flash_fwd's exact mode takes f32 inputs only (bf16 runs flash_fwd_tc)
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

// NC: output columns per thread (ceil(D / 16) rounded up to 1, 2, 4, 8, 12
// or 16)
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
  if (nc <= 8) return launch_nc<V, T, 8>(q, k, v, o, p, grid, s);
  if (nc <= 12) return launch_nc<V, T, 12>(q, k, v, o, p, grid, s);
  return launch_nc<V, T, 16>(q, k, v, o, p, grid, s);
}


// ---------------------------------------------------------------------------
// flash_fwd_tc: exact mode, bf16, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
static_assert(kBQ == 16 * kTcWarps, "each warp owns 16 query rows");

// KD: 16-column steps of the head dim (D padded to 16 KD with zeros). Up
// to KD = 8: 128-key tiles and q's fragments in registers; above: 64-key
// tiles and q's fragments read from shared memory (kQs), see the note at
// the top.
template <int KD>
struct TcTile {
  static constexpr bool kQs = KD > 8;
  static constexpr int kKeys = kQs ? 64 : kBK;  // keys per KV tile
  static constexpr int kDp = 16 * KD;
  static constexpr int kLd = kDp + 8;   // row pitch, elements: +16 bytes
  static constexpr int kElems = kKeys * kLd;  // one K or V tile
  // two stages of (K, V); q passes through stage 1's K buffer first, or
  // with kQs stays in its own buffer after them
  static constexpr int kSmemBytes = (4 * kElems + (kQs ? kBQ * kLd : 0)) * 2;
  // blocks an SM holds by shared memory (72 KB at D = 64: 3); the
  // registers are capped to match
  static constexpr int kMinBlocks = KD <= 4 ? 3 : KD <= 6 ? 2 : 1;
  static_assert(kQs || kBQ <= kKeys, "q fits in a K buffer");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b on one m16n8k16 tile (bf16 in, f32 accumulate); registers only,
// so the compiler may schedule it freely
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16 (nearest even), packed: the first in the
// low half
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// p_hi = bf16(p) and p_lo = bf16(p - p_hi) of two neighbouring p values
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  hi = bf16x2_bits(p0, p1);
  const float h0 = __uint_as_float(hi << 16);
  const float h1 = __uint_as_float(hi & 0xFFFF0000u);
  lo = bf16x2_bits(p0 - h0, p1 - h1);
}

// ROWS rows of a (sequence, D) slice into shared memory [row][kLd], the
// head dim padded with zeros; rows at or past `limit` load as zeros.
// `vec`: D % 8 == 0 and the rows 16-byte aligned, so cp.async moves whole
// 16-byte pieces; else a plain gather.
template <int KD, int ROWS>
__device__ __forceinline__ void load_rows(uint16_t* dst,
                                          const uint16_t* __restrict__ src,
                                          long long ss, int row0, int limit,
                                          int D, bool vec) {
  constexpr int kPieces = 2 * KD;  // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < ROWS * kPieces; idx += kTcThreads) {
    const int r = idx / kPieces;
    const int d0 = 8 * (idx % kPieces);
    uint16_t* out = dst + r * TcTile<KD>::kLd + d0;
    const bool row_ok = row0 + r < limit;
    const uint16_t* in = src + (row_ok ? (row0 + r) * ss + d0 : 0);
    if (vec) {
      cp_async16(out, in, row_ok && d0 < D);
    } else {
      uint16_t e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = row_ok && d0 + i < D ? in[i] : 0;
      *reinterpret_cast<uint4*>(out) = make_uint4(
          e[0] | (static_cast<uint32_t>(e[1]) << 16),
          e[2] | (static_cast<uint32_t>(e[3]) << 16),
          e[4] | (static_cast<uint32_t>(e[5]) << 16),
          e[6] | (static_cast<uint32_t>(e[7]) << 16));
    }
  }
}

template <int KD>
__global__ void __launch_bounds__(kTcThreads, TcTile<KD>::kMinBlocks)
    flash_fwd_tc(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 Params p, int vec_in, int vec_out) {
  using T = TcTile<KD>;
  constexpr int BK = T::kKeys;
  extern __shared__ uint4 smem_tc[];
  uint16_t* const tiles = reinterpret_cast<uint16_t*>(smem_tc);
  // stage st: K at tiles + 2 st kElems, V right after it
  uint16_t* const q_tile = tiles + (T::kQs ? 4 : 2) * T::kElems;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int c4 = lane % 4;  // fragment column pair
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest rows first
  const int wr0 = q0 + 16 * warp;  // the warp's first query row
  const int D = p.D;

  const uint16_t* qb = q + b * p.q_sb + h * p.q_sh;
  const uint16_t* kb = k + b * p.k_sb + kvh * p.k_sh;
  const uint16_t* vb = v + b * p.v_sb + kvh * p.v_sh;
  uint16_t* ob = o + b * p.o_sb + h * p.o_sh;

  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  const int n_tiles = (k_end + BK - 1) / BK;

  // q and KV tile 0 (stage 0); without kQs, q's fragments go into
  // registers before tile 1 overwrites stage 1's K buffer, which held q
  load_rows<KD, kBQ>(q_tile, qb, p.q_ss, q0, p.Sq, D, vec_in);
  load_rows<KD, BK>(tiles, kb, p.k_ss, 0, p.Skv, D, vec_in);
  load_rows<KD, BK>(tiles + T::kElems, vb, p.v_ss, 0, p.Skv, D, vec_in);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // q's fragment kd of this warp's 16 rows
  const uint16_t* const q_frag =
      q_tile + (16 * warp + lane % 16) * T::kLd + (lane / 16) * 8;
  uint32_t qf[T::kQs ? 1 : KD][4];
  if constexpr (!T::kQs) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldsm_x4(qf[kd], q_frag + 16 * kd);
    __syncthreads();
  }

  float acc[2 * KD][4];
#pragma unroll
  for (int t = 0; t < 2 * KD; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.0f, 0.0f};  // this thread's part of the row sums
  const int rows[2] = {wr0 + g, wr0 + g + 8};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_tiles) {
      uint16_t* nk = tiles + 2 * ((j + 1) & 1) * T::kElems;
      load_rows<KD, BK>(nk, kb, p.k_ss, k0 + BK, p.Skv, D, vec_in);
      load_rows<KD, BK>(nk + T::kElems, vb, p.v_ss, k0 + BK, p.Skv, D,
                        vec_in);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* ks = tiles + 2 * (j & 1) * T::kElems;
    const uint16_t* vs = ks + T::kElems;

    // the last key offset of this tile any row of the warp sees
    const int key_hi = p.causal ? wr0 + 15 - k0 : BK - 1;
    if (wr0 < p.Sq && key_hi >= 0) {
      // S = Q K^T: BK / 8 n8 tiles over the tile's keys
      float s[BK / 8][4];
#pragma unroll
      for (int t = 0; t < BK / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.0f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qs[4];
        if constexpr (T::kQs) ldsm_x4(qs, q_frag + 16 * kd);
        const uint32_t(&qa)[4] = T::kQs ? qs : qf[T::kQs ? 0 : kd];
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          if (16 * np > key_hi) continue;
          uint32_t bk[4];
          ldsm_x4(bk, ks + (16 * np + (lane & 7) + (lane >> 4) * 8) * T::kLd +
                          16 * kd + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        }
      }

      // scale and mask (a tile wholly visible to the warp needs no mask);
      // the row max over the quad
      const bool full =
          k0 + BK <= p.kv_len && (!p.causal || k0 + BK - 1 <= wr0);
      // (four independent max and sum chains, one per fragment slot)
      float mx4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
      if (full) {
#pragma unroll
        for (int t = 0; t < BK / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[t][e] *= p.scale;
            mx4[e] = fmaxf(mx4[e], s[t][e]);
          }
      } else {
#pragma unroll
        for (int t = 0; t < BK / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * t + 2 * c4 + (e & 1);
            const bool keep =
                key < p.kv_len && (!p.causal || key <= rows[e >> 1]);
            s[t][e] = keep ? s[t][e] * p.scale : kMasked;
            mx4[e] = fmaxf(mx4[e], s[t][e]);
          }
      }
      float mx[2] = {fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3])};
      float m_new[2], corr[2], rsum4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        m_new[i] = fmaxf(m_r[i], mx[i]);
        corr[i] = expf(m_r[i] - m_new[i]);
        m_r[i] = m_new[i];
      }
      if (full) {
#pragma unroll
        for (int t = 0; t < BK / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[t][e] = expf(s[t][e] - m_new[e >> 1]);
            rsum4[e] += s[t][e];
          }
      } else {
#pragma unroll
        for (int t = 0; t < BK / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * t + 2 * c4 + (e & 1);
            const bool keep =
                key < p.kv_len && (!p.causal || key <= rows[e >> 1]);
            s[t][e] = keep ? expf(s[t][e] - m_new[e >> 1]) : 0.0f;
            rsum4[e] += s[t][e];
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l_r[i] = l_r[i] * corr[i] + (rsum4[2 * i] + rsum4[2 * i + 1]);
#pragma unroll
      for (int t = 0; t < 2 * KD; ++t) {
        acc[t][0] *= corr[0];
        acc[t][1] *= corr[0];
        acc[t][2] *= corr[1];
        acc[t][3] *= corr[1];
      }

      // acc += p_hi V + p_lo V, 16 keys a step: the V fragments first, then
      // the p_hi products of every d tile, then the p_lo ones, so no MMA
      // waits on the one before it (with kQs one d tile at a time, which
      // keeps the same order of adds into each accumulator)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (16 * kk > key_hi) continue;
        uint32_t ph[4], pl[4];
        split_p(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_p(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        const uint16_t* const v_frag =
            vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * T::kLd +
            (lane >> 4) * 8;
        if constexpr (T::kQs) {
#pragma unroll
          for (int dp = 0; dp < KD; ++dp) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, v_frag + 16 * dp);
            mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
            mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
            mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
            mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
          }
        } else {
          uint32_t bv[KD][4];
#pragma unroll
          for (int dp = 0; dp < KD; ++dp) ldsm_x4_trans(bv[dp], v_frag + 16 * dp);
#pragma unroll
          for (int dp = 0; dp < KD; ++dp) {
            mma_bf16(acc[2 * dp], ph, bv[dp][0], bv[dp][1]);
            mma_bf16(acc[2 * dp + 1], ph, bv[dp][2], bv[dp][3]);
          }
#pragma unroll
          for (int dp = 0; dp < KD; ++dp) {
            mma_bf16(acc[2 * dp], pl, bv[dp][0], bv[dp][1]);
            mma_bf16(acc[2 * dp + 1], pl, bv[dp][2], bv[dp][3]);
          }
        }
      }
    }
    __syncthreads();  // the next tile's load overwrites this stage
  }

  // o = acc / max(l, 1e-30), rounded to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    if (rows[i] >= p.Sq) continue;
    uint16_t* orow = ob + rows[i] * p.o_ss;
#pragma unroll
    for (int t = 0; t < 2 * KD; ++t) {
      const int d = 8 * t + 2 * c4;
      const float o0 = acc[t][2 * i] / l;
      const float o1 = acc[t][2 * i + 1] / l;
      if (vec_out) {
        if (d < D) *reinterpret_cast<uint32_t*>(orow + d) = bf16x2_bits(o0, o1);
      } else {
        if (d < D) store(orow + d, o0);
        if (d + 1 < D) store(orow + d + 1, o1);
      }
    }
  }
}

template <int KD>
int launch_tc_kd(const void* q, const void* k, const void* v, void* o,
                 const Params& p, dim3 grid, int vec_in, int vec_out,
                 cudaStream_t s) {
  constexpr int bytes = TcTile<KD>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_tc<KD><<<grid, kTcThreads, bytes, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), p, vec_in,
      vec_out);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

int launch_tc(const void* q, const void* k, const void* v, void* o,
              const Params& p, int bh, cudaStream_t s) {
  const int nq = (p.Sq + kBQ - 1) / kBQ;
  if (nq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(bh, nq);
  // whole 16-byte pieces of q, k, v rows (cp.async), bf16 pairs of o rows
  const bool vec_in =
      p.D % 8 == 0 && aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
      p.q_sb % 8 == 0 && p.q_ss % 8 == 0 && p.q_sh % 8 == 0 &&
      p.k_sb % 8 == 0 && p.k_ss % 8 == 0 && p.k_sh % 8 == 0 &&
      p.v_sb % 8 == 0 && p.v_ss % 8 == 0 && p.v_sh % 8 == 0;
  const bool vec_out = p.D % 2 == 0 && aligned(o, 4) && p.o_sb % 2 == 0 &&
                       p.o_ss % 2 == 0 && p.o_sh % 2 == 0;
  switch ((p.D + 15) / 16) {
    case 1: return launch_tc_kd<1>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 2: return launch_tc_kd<2>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 3: return launch_tc_kd<3>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 4: return launch_tc_kd<4>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 5: return launch_tc_kd<5>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 6: return launch_tc_kd<6>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 7: return launch_tc_kd<7>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 8: return launch_tc_kd<8>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 9: case 10: case 11: case 12:
      return launch_tc_kd<12>(q, k, v, o, p, grid, vec_in, vec_out, s);
    case 13: case 14: case 15: case 16:
      return launch_tc_kd<16>(q, k, v, o, p, grid, vec_in, vec_out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream`, allocates
// nothing, does not synchronize; returns cudaGetLastError() of the launch
// (0 = ok). `strides` holds 12 element strides: batch, sequence and head
// of q, k, v and o, in that order (the head dim is contiguous). `is_f32`:
// the inputs and output are f32 (exact mode only) instead of bf16.
// bf16 exact launches flash_fwd_tc, everything else flash_fwd.
// The caller guarantees 1 <= D <= 256, H % KH == 0, B * H <= 65535,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16 exact runs on the tensor cores; f32 exact and the approximate
  // variants on flash_fwd (see the note at the top)
  if (!is_f32 && variant == daism::kExact)
    return launch_tc(q, k, v, o, p, B * H, s);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  if (is_f32) {
    if (variant != daism::kExact)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<daism::kExact, float>(q, k, v, o, p, grid, s);
  }
  switch (variant) {
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
