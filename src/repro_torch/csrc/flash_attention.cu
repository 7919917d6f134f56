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
//     multiplier is not scale invariant. The query tile is free: every
//     query row's arithmetic is independent of the others;
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
// flash_fwd_int: the six approximate variants, and exact mode on f32 inputs
//   (the tensor cores' TF32 would break the f32 bound). Approximate mode
//   runs the DAISM product with q and p as the multiplier and k and v as
//   the multiplicand, as the reference's approx_matmul_tile(q, k.T) and
//   approx_matmul_tile(p.bf16, v) do, through approx_mac_lean
//   (approx_product.cuh: approx_product's bits in fewer operations); f32
//   exact mode multiplies in f32 (fmaf). The summation order is fixed: each
//   score over d ascending and each tile's p.v over its keys ascending, in
//   one f32 accumulator an output; a row's max and sum over 32 lanes of 4
//   keys each (keys lane + 32 c), the lanes in a butterfly; l and acc
//   updated by fmaf. The query tile and the block size change no bit.
//   What bounds it: issued operations. Every score and every p.v term is a
//   DAISM product, a dependent chain of 17 (PC3_TR) to 23 (HLA) operations
//   with its f32 add, about half IMAD/FADD for the FMA pipe and half logic,
//   shifts, compares and selects for the ALU pipe, which runs at half the
//   SM's issue rate of 4 warp instructions a clock; a causal (S, S) head
//   needs S (S + 1) / 2 score pairs, each with 2 D products. The chain is
//   long, so the SM needs many independent chains in flight and every
//   issued instruction counts: the design is about warps and operations,
//   not bytes.
//   * Warps: a block of 2, 4 or 8 warps owns 8, 16 or 32 query rows (4 a
//     warp); registers are capped at 128 a thread and shared memory scales
//     with the block, so an SM holds 8, 4 or 2 blocks: 16 warps at every
//     head dim from 1 to 256. The head dim is streamed through shared
//     memory in chunks of 512 elements a warp (K: the tile's 128 keys x 4
//     warps columns; V: a pass's columns x the keys that fill the chunk),
//     so the fields take the same room whatever D is (52 KB a 4-warp block
//     and 112 KB an 8-warp one at D = 256). The p.v accumulators of D = 256
//     are split into two 128-column passes.
//   * Grid: one block per (query tile, batch x head), the longest causal
//     query tiles first over the whole grid (not within a head), so the
//     short tiles fill the tail. The block size is the wrapper's one rule
//     (kernels/flash_attention.py::int_plan): the size whose per-SM share
//     of the grid ends soonest, so short grids (Whisper's 448-row attention,
//     20 heads) take smaller tiles that fill 132 SMs.
//   * Scores stay in registers: a warp's 4 rows x 128 keys are 4 x 4 a
//     lane, and the warp that owns the rows takes their max, exps and sums
//     with shuffles; no block barrier separates scores, softmax and p.v. p
//     reaches the lanes that own output columns as multiplier fields, one
//     32-key group at a time, through a per-warp buffer (warp-synchronous).
//   * Fields ready for the chain: K, V, q and p are decoded once (per block
//     and chunk; q per K chunk, under 1% of the products' work) into the
//     form the product consumes: q and p as int4 {lines, head, exp, sign},
//     k and v as three word arrays (mantissa, exponent, sign), so no product
//     unpacks a packed word. A lane multiplies a 4 x NG tile in the scores
//     (each q field reused over NG key groups, each k field over 4 rows; NG
//     is a template argument, so no product sits behind a branch and each
//     operand's line masks and shifts are made once) and RP rows x 4 or 6
//     columns in p.v.
//   * Overlap: the next chunk's raw bf16 K or V is loaded with cp.async
//     into the other stage of a 2-stage ring while this chunk's products
//     run (the stream runs on across tiles), then decoded once.
//   * Skips: tiles above the causal diagonal or past kv_len, a tile's keys
//     at or past the block's last visible key, and the key groups above
//     each warp's own diagonal are not computed: they add exactly nothing.
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

constexpr int kBQ = 64;        // flash_fwd_tc's query rows per block
constexpr int kBK = 128;       // keys per KV tile: part of the function
constexpr int kMaxD = 256;     // largest head dim
constexpr float kMasked = -1e30f;

// flash_fwd_int's exact mode takes f32 inputs only (bf16 runs flash_fwd_tc)
__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ void store(uint16_t* dst, float x) {
  *dst = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

struct Params {
  int H, KH, Sq, Skv, D, kv_len, causal;
  float scale;
  // element strides: batch, sequence, head (the head dim is contiguous)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
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

// ---------------------------------------------------------------------------
// flash_fwd_int: the six approximate variants and f32 exact
// ---------------------------------------------------------------------------

constexpr int kIntRows = 4;      // query rows a warp owns
constexpr int kIntChunk = 512;   // elements of a K or V chunk, per warp
constexpr int kGroup = 32;       // keys of a p group: one score a lane
constexpr int kIntThreads = 256;  // the largest block (8 warps)

// The p.v lane tile of the padded head dim DP: a warp's kIntRows rows x DP
// output columns over its 32 lanes, RP rows x (NP passes x NV vectors of VW
// neighbouring columns) a lane. Lanes split into kIntRows / RP row groups
// of NCG = 8 RP column groups; a pass covers DP / NP columns, so the
// multiplier (p) of a row is reused over NV VW columns and the
// multiplicand (v) of a column over RP rows.
template <int DP>
struct IntTile;
template <>
struct IntTile<16> { static constexpr int RP = 1, VW = 2, NV = 1, NP = 1; };
template <>
struct IntTile<32> { static constexpr int RP = 1, VW = 4, NV = 1, NP = 1; };
template <>
struct IntTile<64> { static constexpr int RP = 2, VW = 4, NV = 1, NP = 1; };
template <>
struct IntTile<128> { static constexpr int RP = 4, VW = 4, NV = 1, NP = 1; };
template <>
struct IntTile<192> { static constexpr int RP = 4, VW = 2, NV = 3, NP = 1; };
template <>
struct IntTile<256> { static constexpr int RP = 4, VW = 4, NV = 1, NP = 2; };

// The padded head dim a head dim D runs at.
__host__ __device__ constexpr int int_head_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128
       : d <= 192 ? 192 : 256;
}

// Operand fields as the product loops read them from shared memory.
// Approximate: the multiplier (q, p) as one int4 {lines, head, exp, sign}
// (daism::XFields) and the multiplicand (k, v) in three word arrays (mantissa,
// exponent, sign: daism::WFields), so no product unpacks a field. f32 exact:
// the values themselves.
template <int V>
struct IntFields {
  using X = int4;
  using W = daism::WFields;
  static constexpr int kWArrays = 3;
};
template <>
struct IntFields<daism::kExact> {
  using X = float;
  using W = float;
  static constexpr int kWArrays = 1;
};

// Shared memory of one block, bytes: two raw chunks (the ring the next
// chunk's cp.async fills), the q rows as loaded, q's fields for one K chunk,
// one 32-key p group a warp, and the multiplicand fields of one chunk.
template <int V, typename T>
__host__ __device__ constexpr int int_smem_bytes(int dp, int warps) {
  const int chunk = kIntChunk * warps;
  const int rows = kIntRows * warps;
  const int x_bytes = static_cast<int>(sizeof(typename IntFields<V>::X));
  return static_cast<int>(sizeof(T)) * (2 * chunk + rows * dp) +
         x_bytes * (rows * (chunk / kBK) + warps * kIntRows * kGroup) +
         4 * IntFields<V>::kWArrays * chunk;
}

template <int V, typename T>
__device__ __forceinline__ typename IntFields<V>::X x_fields(T x) {
  if constexpr (V == daism::kExact) {
    return to_f32(x);
  } else {
    const daism::XFields f = daism::decompose_x<V>(x);
    return make_int4(f.lines, f.head, f.exp, static_cast<int>(f.sign));
  }
}

// p (f32) as the multiplier: f32 in exact mode; in approximate mode its bf16
// rounding (nearest even), as the reference's p.astype(bfloat16)
template <int V>
__device__ __forceinline__ typename IntFields<V>::X p_fields(float p) {
  if constexpr (V == daism::kExact) {
    return p;
  } else {
    return x_fields<V, uint16_t>(__bfloat16_as_ushort(__float2bfloat16_rn(p)));
  }
}

// acc + x * w in mode V
template <int V>
__device__ __forceinline__ float mac(float acc,
                                     const typename IntFields<V>::X& x,
                                     const typename IntFields<V>::W& w) {
  if constexpr (V == daism::kExact) {
    return fmaf(x, w, acc);
  } else {
    return daism::approx_mac_lean<V>(
        acc, daism::XFields{x.x, x.y, x.z, static_cast<uint32_t>(x.w)}, w);
  }
}

// element i of the multiplicand buffer (arrays of n words)
template <int V>
__device__ __forceinline__ typename IntFields<V>::W w_at(const uint32_t* wf,
                                                         int n, int i) {
  if constexpr (V == daism::kExact) {
    return __uint_as_float(wf[i]);
  } else {
    return daism::WFields{static_cast<int>(wf[i]), static_cast<int>(wf[n + i]),
                          wf[2 * n + i]};
  }
}

// N neighbouring words (N = 2 or 4, aligned to N words), one vector load
template <int N>
__device__ __forceinline__ void words(const uint32_t* src, uint32_t (&w)[N]) {
  if constexpr (N == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else {
    static_assert(N == 2, "two or four words");
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    w[0] = x.x; w[1] = x.y;
  }
}

// elements i .. i + N - 1 of the multiplicand buffer
template <int V, int N>
__device__ __forceinline__ void w_vec(const uint32_t* wf, int n, int i,
                                      typename IntFields<V>::W (&out)[N]) {
  uint32_t a[N];
  words<N>(wf + i, a);
  if constexpr (V == daism::kExact) {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = __uint_as_float(a[e]);
  } else {
    uint32_t x[N], s[N];
    words<N>(wf + n + i, x);
    words<N>(wf + 2 * n + i, s);
#pragma unroll
    for (int e = 0; e < N; ++e)
      out[e] = daism::WFields{static_cast<int>(a[e]), static_cast<int>(x[e]),
                              s[e]};
  }
}

// the elements of one 16-byte piece of shared memory
template <typename T>
__device__ __forceinline__ void piece(const T* src, T (&e)[16 / sizeof(T)]) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = static_cast<T>(i % 2 ? w[i / 2] >> 16 : w[i / 2] & 0xFFFFu);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = __uint_as_float(w[i]);
  }
}

// the multiplicand fields of element i (arrays of n words)
template <int V, typename T>
__device__ __forceinline__ void put_w(uint32_t* wf, int n, int i, T x) {
  if constexpr (V == daism::kExact) {
    wf[i] = __float_as_uint(to_f32(x));
  } else {
    const daism::WFields f = daism::decompose_w(x);
    wf[i] = static_cast<uint32_t>(f.man);
    wf[n + i] = static_cast<uint32_t>(f.exp);
    wf[2 * n + i] = f.sign;
  }
}

// a[g] of a 4-register array, g warp-uniform (no local memory)
__device__ __forceinline__ float pick4(const float (&a)[4], int g) {
  return g == 0 ? a[0] : g == 1 ? a[1] : g == 2 ? a[2] : a[3];
}

// The scores of a warp's 4 rows at its lane's first NG keys (lane + 32 c)
// over one K chunk's dck head-dim columns, d ascending: a 4 x NG tile a
// lane, each q field reused over NG keys and each k field over 4 rows (NG
// is a template argument so that no product sits behind a branch). `wk`:
// the K fields [d][key] offset by the lane.
template <int V, int NG>
__device__ __forceinline__ void qk_chunk(float (&s)[kIntRows][4],
                                         const typename IntFields<V>::X* qw,
                                         const uint32_t* wk, int n, int dck) {
#pragma unroll 1
  for (int dd = 0; dd < dck; ++dd) {
    typename IntFields<V>::W kw[NG];
#pragma unroll
    for (int c = 0; c < NG; ++c) kw[c] = w_at<V>(wk, n, dd * kBK + 32 * c);
#pragma unroll
    for (int r = 0; r < kIntRows; ++r) {
      const typename IntFields<V>::X xq = qw[r * dck + dd];
#pragma unroll
      for (int c = 0; c < NG; ++c) s[r][c] = mac<V>(s[r][c], xq, kw[c]);
    }
  }
}

// One block: a tile of 4 x warps query rows of one (batch, head); each warp
// owns 4 rows. Keys are walked in 128-key tiles; a tile's K and V arrive as
// a stream of chunks of 512 x warps elements (K: all 128 keys x 4 x warps
// head-dim columns; V: kcv keys x a pass's columns), each cp.async-loaded
// raw into a 2-stage ring one chunk ahead, then decoded once into the
// multiplicand fields that every warp reads. `vec`: 16-byte cp.async pieces
// (D a multiple of a piece, rows aligned); else plain loads.
template <int V, typename T, int DP>
__global__ void __launch_bounds__(kIntThreads, 2)
    flash_fwd_int(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Params p,
                  int vec) {
  using Tile = IntTile<DP>;
  using X = typename IntFields<V>::X;
  using WL = typename IntFields<V>::W;
  constexpr int RP = Tile::RP, VW = Tile::VW, NV = Tile::NV, NP = Tile::NP;
  constexpr int NCG = 8 * RP;          // column groups of a warp
  constexpr int DPP = DP / NP;         // columns of a pass
  constexpr int CPP = NV * VW;         // columns of a pass a lane owns
  constexpr int VE = 16 / sizeof(T);   // elements of a 16-byte piece
  static_assert(NCG * CPP == DPP && (kIntRows / RP) * NCG == 32, "lane tile");

  const int nw = blockDim.x / 32;
  const int nt = blockDim.x;
  const int bq = kIntRows * nw;        // query rows of the block
  const int E = kIntChunk * nw;        // elements of a chunk
  const int dck = E / kBK;             // head-dim columns of a K chunk
  const int kcv = min(kBK, E / DPP);   // keys of a V chunk

  extern __shared__ uint4 smem_int[];
  T* const raw = reinterpret_cast<T*>(smem_int);       // [2][E]
  T* const qraw = raw + 2 * E;                         // [bq][DP]
  X* const qf = reinterpret_cast<X*>(qraw + bq * DP);  // [bq][dck]
  X* const pf = qf + bq * dck;                         // [nw][4][kGroup]
  uint32_t* const wf =
      reinterpret_cast<uint32_t*>(pf + nw * kIntRows * kGroup);  // [arrays][E]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nq = (p.Sq + bq - 1) / bq;
  const int nbh = gridDim.x / nq;
  const int bh = blockIdx.x % nbh;
  // the whole grid issues the longest causal query tiles first
  const int q0 = (nq - 1 - blockIdx.x / nbh) * bq;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KH);
  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;
  T* ob = o + b * p.o_sb + h * p.o_sh;

  // tiles wholly above the causal diagonal or past kv_len contribute
  // nothing: skip them; so do a tile's keys at or past k_end (masked for
  // every row of the block)
  const int q_last = min(q0 + bq, p.Sq) - 1;
  const int k_end = p.causal ? min(p.kv_len, q_last + 1) : p.kv_len;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const int nk = (p.D + dck - 1) / dck;  // K chunks: the head dim's columns
  auto n_v = [&](int j) { return (min(kBK, k_end - j * kBK) + kcv - 1) / kcv; };

  const int r0 = q0 + kIntRows * warp;  // the warp's first query row
  const bool live = r0 < p.Sq;
  const int rg = lane / NCG;  // the lane's p.v rows rg RP .. rg RP + RP - 1
  const int cg = lane % NCG;

  // rows [row0, row0 + rows) x columns [col0, col0 + cols) of a (sequence,
  // D) slice into dst [rows][cols]; zeros at rows >= limit or columns >= D
  auto load = [&](T* dst, const T* src, long long ss, int row0, int rows,
                  int limit, int col0, int cols) {
    if (vec) {
      const int pieces = cols / VE;
      for (int i = tid; i < rows * pieces; i += nt) {
        const int r = i / pieces;
        const int c = col0 + (i % pieces) * VE;
        const bool ok = row0 + r < limit && c < p.D;
        cp_async16(dst + r * cols + (c - col0),
                   src + (ok ? (row0 + r) * ss + c : 0), ok);
      }
    } else {
      for (int i = tid; i < rows * cols; i += nt) {
        const int r = i / cols;
        const int c = col0 + i % cols;
        dst[i] = row0 + r < limit && c < p.D ? src[(row0 + r) * ss + c] : T(0);
      }
    }
  };
  // chunk `idx` of tile j into ring stage `st`: K (pass < 0) its head-dim
  // columns idx dck.., all 128 keys; V pass `pass`'s columns, keys idx kcv..
  auto issue = [&](int j, int pass, int idx, int st) {
    T* dst = raw + st * E;
    if (pass < 0)
      load(dst, kb, p.k_ss, j * kBK, kBK, p.Skv, idx * dck, dck);
    else
      load(dst, vb, p.v_ss, j * kBK + idx * kcv, kcv, p.Skv, pass * DPP, DPP);
    cp_async_commit();
  };

  float s[kIntRows][4];  // scores (then p): rows r0 + r, keys lane + 32 c
  float m[kIntRows], l[kIntRows], corr[kIntRows];  // the same on every lane
#pragma unroll
  for (int r = 0; r < kIntRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
    corr[r] = 1.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
  }
  float acc[NP][RP][CPP];  // columns ((pass NV + t) NCG + cg) VW + e
  float pv[RP][CPP];       // this pass's p.v over the tile's keys
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int e = 0; e < CPP; ++e) {
      pv[i][e] = 0.0f;
#pragma unroll
      for (int pp = 0; pp < NP; ++pp) acc[pp][i][e] = 0.0f;
    }
  int pg = -1;  // the p group in this warp's pf

  load(qraw, qb, p.q_ss, q0, bq, p.Sq, 0, DP);
  int j = 0, pass = -1, idx = 0, st = 0;
  issue(0, -1, 0, 0);
  for (;;) {
    // the step after this one; its chunk loads while this one computes
    int nj = j, npass = pass, nidx = idx + 1;
    if (pass < 0) {
      if (nidx == nk) npass = nidx = 0;
    } else if (nidx == n_v(j)) {
      nidx = 0;
      if (++npass == NP) {
        npass = -1;
        ++nj;
      }
    }
    const bool more = nj < n_tiles;
    if (more) {
      issue(nj, npass, nidx, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunk is in; every warp is done with the fields

    const T* src = raw + st * E;
    if (pass < 0) {
      // K [key][d] -> fields [d][key]; q's columns of the chunk -> [row][d]
      for (int i = tid; i < kBK * (dck / VE); i += nt) {
        const int key = i % kBK;
        const int c0 = (i / kBK) * VE;
        T e[VE];
        piece(src + key * dck + c0, e);
#pragma unroll
        for (int u = 0; u < VE; ++u) put_w<V>(wf, E, (c0 + u) * kBK + key, e[u]);
      }
      for (int i = tid; i < bq * (dck / VE); i += nt) {
        const int r = i / (dck / VE);
        const int c0 = (i % (dck / VE)) * VE;
        T e[VE];
        piece(qraw + r * DP + idx * dck + c0, e);
#pragma unroll
        for (int u = 0; u < VE; ++u) qf[r * dck + c0 + u] = x_fields<V>(e[u]);
      }
    } else {
      // V [key][d] -> fields [key][d]
      for (int i = tid; i < kcv * DPP / VE; i += nt) {
        T e[VE];
        piece(src + i * VE, e);
#pragma unroll
        for (int u = 0; u < VE; ++u) put_w<V>(wf, E, i * VE + u, e[u]);
      }
    }
    __syncthreads();  // the fields are in

    const int k0 = j * kBK;
    // the last key offset of this tile any row of the warp sees
    const int kmax = min(min(kBK - 1, k_end - 1 - k0),
                         p.causal ? r0 + kIntRows - 1 - k0 : kBK - 1);
    if (live && kmax >= 0) {
      if (pass < 0) {
        // scores over this chunk's columns, d ascending; key groups past
        // kmax are masked for every row of the warp
        if (idx == 0) {
#pragma unroll
          for (int r = 0; r < kIntRows; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
        }
        const X* qw = qf + kIntRows * warp * dck;
        switch (kmax / kGroup) {
          case 0: qk_chunk<V, 1>(s, qw, wf + lane, E, dck); break;
          case 1: qk_chunk<V, 2>(s, qw, wf + lane, E, dck); break;
          case 2: qk_chunk<V, 3>(s, qw, wf + lane, E, dck); break;
          default: qk_chunk<V, 4>(s, qw, wf + lane, E, dck); break;
        }
        if (idx == nk - 1) {
          // the online softmax of each row, by the warp that owns it: the
          // row max and the row sum over its 32 lanes (4 keys each)
#pragma unroll
          for (int r = 0; r < kIntRows; ++r) {
            const int gq = r0 + r;
            bool keep[4];
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int gk = k0 + lane + 32 * c;
              keep[c] = gk < p.kv_len && (!p.causal || gk <= gq);
              s[r][c] = keep[c] ? __fmul_rn(s[r][c], p.scale) : kMasked;
              mx = fmaxf(mx, s[r][c]);
            }
#pragma unroll
            for (int off = 16; off > 0; off /= 2)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[r], mx);
            corr[r] = expf(__fsub_rn(m[r], m_new));
            float sum = 0.0f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              s[r][c] = keep[c] ? expf(__fsub_rn(s[r][c], m_new)) : 0.0f;
              sum = __fadd_rn(sum, s[r][c]);
            }
#pragma unroll
            for (int off = 16; off > 0; off /= 2)
              sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
            l[r] = fmaf(l[r], corr[r], sum);
            m[r] = m_new;
          }
          pg = -1;
        }
      } else {
        // p.v over this chunk's keys, ascending, 32-key groups of p at a
        // time (the lanes that hold a group's p write its fields)
        X* const pw = pf + kIntRows * kGroup * warp;
        const int kb0 = idx * kcv;
        const int kend = min(kb0 + kcv, kmax + 1);
        for (int seg = kb0; seg < kend;) {
          const int g = seg / kGroup;
          if (g != pg) {
            __syncwarp();
#pragma unroll
            for (int r = 0; r < kIntRows; ++r)
              pw[r * kGroup + lane] = p_fields<V>(pick4(s[r], g));
            __syncwarp();
            pg = g;
          }
          const int seg_end = min(kend, (g + 1) * kGroup);
          const X* const px = pw + rg * RP * kGroup;
          const uint32_t* vrow = wf + (seg - kb0) * DPP + cg * VW;
#pragma unroll 1
          for (int kk = seg; kk < seg_end; ++kk, vrow += DPP) {
            X xp[RP];
#pragma unroll
            for (int i = 0; i < RP; ++i) xp[i] = px[i * kGroup + (kk & 31)];
#pragma unroll
            for (int t = 0; t < NV; ++t) {
              WL wv[VW];
              w_vec<V, VW>(vrow, E, t * NCG * VW, wv);
#pragma unroll
              for (int i = 0; i < RP; ++i)
#pragma unroll
                for (int e = 0; e < VW; ++e)
                  pv[i][t * VW + e] = mac<V>(pv[i][t * VW + e], xp[i], wv[e]);
            }
          }
          seg = seg_end;
        }
        if (idx == n_v(j) - 1) {
          // the pass's columns: acc = acc * corr + p v
#pragma unroll
          for (int i = 0; i < RP; ++i) {
            const float c = pick4(corr, rg * RP + i);
#pragma unroll
            for (int pp = 0; pp < NP; ++pp) {
              if (pp != pass) continue;
#pragma unroll
              for (int e = 0; e < CPP; ++e) {
                acc[pp][i][e] = fmaf(acc[pp][i][e], c, pv[i][e]);
                pv[i][e] = 0.0f;
              }
            }
          }
        }
      }
    }
    if (!more) break;
    j = nj;
    pass = npass;
    idx = nidx;
    st ^= 1;
  }

  // o = acc / max(l, 1e-30), rounded to the input type
  if (!live) return;
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int gq = r0 + rg * RP + i;
    if (gq >= p.Sq) continue;
    const float lr = fmaxf(pick4(l, rg * RP + i), 1e-30f);
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int t = 0; t < NV; ++t)
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          const int d = pp * DPP + (t * NCG + cg) * VW + e;
          if (d < p.D) store(&ob[gq * p.o_ss + d], acc[pp][i][t * VW + e] / lr);
        }
  }
}

// The integer kernel of (variant, dtype) at head dim d and its shared
// memory a block of `warps` warps; fn is null for a variant it does not
// take.
struct IntKernel {
  const void* fn;
  int smem;
};

template <int V, typename T>
IntKernel int_kernel_of(int d, int warps) {
  const int dp = int_head_dim(d);
  const int bytes = int_smem_bytes<V, T>(dp, warps);
  switch (dp) {
    case 16: return {reinterpret_cast<const void*>(flash_fwd_int<V, T, 16>), bytes};
    case 32: return {reinterpret_cast<const void*>(flash_fwd_int<V, T, 32>), bytes};
    case 64: return {reinterpret_cast<const void*>(flash_fwd_int<V, T, 64>), bytes};
    case 128: return {reinterpret_cast<const void*>(flash_fwd_int<V, T, 128>), bytes};
    case 192: return {reinterpret_cast<const void*>(flash_fwd_int<V, T, 192>), bytes};
    default: return {reinterpret_cast<const void*>(flash_fwd_int<V, T, 256>), bytes};
  }
}

IntKernel int_kernel(int variant, int is_f32, int d, int warps) {
  if (is_f32)
    return variant == daism::kExact ? int_kernel_of<daism::kExact, float>(d, warps)
                                    : IntKernel{nullptr, 0};
  switch (variant) {
    case daism::kFla: return int_kernel_of<daism::kFla, uint16_t>(d, warps);
    case daism::kHla: return int_kernel_of<daism::kHla, uint16_t>(d, warps);
    case daism::kPc2: return int_kernel_of<daism::kPc2, uint16_t>(d, warps);
    case daism::kPc3: return int_kernel_of<daism::kPc3, uint16_t>(d, warps);
    case daism::kPc2Tr: return int_kernel_of<daism::kPc2Tr, uint16_t>(d, warps);
    case daism::kPc3Tr: return int_kernel_of<daism::kPc3Tr, uint16_t>(d, warps);
    default: return {nullptr, 0};
  }
}

bool valid_warps(int warps) { return warps == 2 || warps == 4 || warps == 8; }

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

int launch_int(const void* q, const void* k, const void* v, void* o,
               const Params& p, int bh, int variant, int is_f32, int warps,
               cudaStream_t s) {
  if (!valid_warps(warps)) return static_cast<int>(cudaErrorInvalidValue);
  const IntKernel kern = int_kernel(variant, is_f32, p.D, warps);
  if (kern.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((p.Sq + kIntRows * warps - 1) / (kIntRows * warps)) * bh;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kern.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern.fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  // whole 16-byte pieces of q, k, v rows (cp.async)
  const int el = is_f32 ? 4 : 8;
  int vec = p.D % el == 0 && aligned(q, 16) && aligned(k, 16) &&
            aligned(v, 16) && p.q_sb % el == 0 && p.q_ss % el == 0 &&
            p.q_sh % el == 0 && p.k_sb % el == 0 && p.k_ss % el == 0 &&
            p.k_sh % el == 0 && p.v_sb % el == 0 && p.v_ss % el == 0 &&
            p.v_sh % el == 0;
  Params pc = p;
  void* args[] = {const_cast<void**>(&q), const_cast<void**>(&k),
                  const_cast<void**>(&v), &o, &pc, &vec};
  err = cudaLaunchKernel(kern.fn, dim3(static_cast<unsigned>(blocks)),
                         dim3(32 * warps), args, kern.smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// approx_mac_lean against acc + approx_product over every pair of bf16 bit
// patterns, at acc = +0 (the product's own bits) and acc = 1.5: block x
// takes the multiplier x, its threads the 65536 multiplicands; the pairs
// whose bits differ are added to *bad.
template <int V>
__global__ void __launch_bounds__(256)
    product_check(unsigned long long* bad) {
  const daism::XFields x = daism::decompose_x<V>(static_cast<uint16_t>(blockIdx.x));
  unsigned long long n = 0;
  for (int wb = threadIdx.x; wb < 65536; wb += blockDim.x) {
    const daism::WFields w = daism::decompose_w(static_cast<uint16_t>(wb));
    const float p = daism::approx_product<V>(x, w);
    const float accs[2] = {0.0f, 1.5f};
#pragma unroll
    for (int a = 0; a < 2; ++a)
      n += __float_as_uint(accs[a] + p) !=
           __float_as_uint(daism::approx_mac_lean<V>(accs[a], x, w));
  }
  if (n) atomicAdd(bad, n);
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

// C entry points, bound with ctypes.

// Launches on `stream`, allocates nothing, does not synchronize; returns
// cudaGetLastError() of the launch (0 = ok). `strides` holds 12 element
// strides: batch, sequence and head of q, k, v and o, in that order (the
// head dim is contiguous). `is_f32`: the inputs and output are f32 (exact
// mode only) instead of bf16. bf16 exact launches flash_fwd_tc, everything
// else flash_fwd_int with blocks of `warps` warps (2, 4 or 8: query tiles
// of 8, 16 or 32 rows; kernels/flash_attention.py::int_plan picks them).
// The caller guarantees 1 <= D <= 256, H % KH == 0, B * H <= 65535,
// 1 <= kv_len <= Skv and Sq >= 1.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KH, int Sq,
                               int Skv, int D, int kv_len, int causal,
                               float scale, int variant, int is_f32,
                               int warps, const long long* strides,
                               void* stream) {
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  Params p{H, KH, Sq, Skv, D, kv_len, causal, scale,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16 exact runs on the tensor cores; f32 exact and the approximate
  // variants on flash_fwd_int (see the note at the top)
  if (!is_f32 && variant == daism::kExact)
    return launch_tc(q, k, v, o, p, B * H, s);
  return launch_int(q, k, v, o, p, B * H, variant, is_f32, warps, s);
}

// What the integer kernel of (variant, f32 or bf16, head dim d) compiled to
// at blocks of `warps` warps: out[0] blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers a
// thread, out[2] local memory a thread (spills), bytes, out[3] dynamic
// shared memory a block, bytes. Returns a CUDA error (0 = ok).
extern "C" int flash_attention_int_info(int variant, int is_f32, int d,
                                        int warps, int* out) {
  if (d < 1 || d > kMaxD || !valid_warps(warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const IntKernel kern = int_kernel(variant, is_f32, d, warps);
  if (kern.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kern.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern.fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern.fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kern.fn, 32 * warps, kern.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = kern.smem;
  return 0;
}

// Launches product_check of an approximate `variant` on `stream`: adds to
// the device counter *bad the bf16 pairs whose lean and reference products
// differ. Returns a CUDA error (0 = ok).
extern "C" int approx_product_check(int variant, unsigned long long* bad,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(65536), block(256);
  switch (variant) {
    case daism::kFla: product_check<daism::kFla><<<grid, block, 0, s>>>(bad); break;
    case daism::kHla: product_check<daism::kHla><<<grid, block, 0, s>>>(bad); break;
    case daism::kPc2: product_check<daism::kPc2><<<grid, block, 0, s>>>(bad); break;
    case daism::kPc3: product_check<daism::kPc3><<<grid, block, 0, s>>>(bad); break;
    case daism::kPc2Tr: product_check<daism::kPc2Tr><<<grid, block, 0, s>>>(bad); break;
    case daism::kPc3Tr: product_check<daism::kPc3Tr><<<grid, block, 0, s>>>(bad); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
