// DAISM approximate GEMM for Hopper (sm_90a):
//   out[m, n] = sum_k approx(a[m, k] * w[k, n]),  (M,K) bf16 @ (K,N) bf16 -> f32
//
// Replaces the Pallas TPU kernel repro/kernels/daism_matmul.py::_kernel
// (entry daism_matmul_kernel, wrapper repro/kernels/ops.py::
// daism_matmul_pallas). Per-element products are bit-identical to
// repro_torch/core/floatmul.py (see approx_product.cuh).
//
// Summation order (part of the function, the same on every path and at
// every M). K is cut into chunks of kKc = 64 columns; each output is
//   total = 0; for each chunk c ascending:
//     part = 0; for k in c ascending: part += approx(a[m, k] * w[k, n]);
//     total += part
// in f32 with no atomics, as kernels/daism_matmul.py::daism_matmul_ordered
// spells it. A row's bits then depend only on that row of `a` and on `w`,
// never on M or on the other rows, so a decode step gives the same tokens
// whatever the batch (and whichever path below it takes).
//
// What bounds it. Every approximate MAC is a chain of integer operations
// (no tensor core computes an OR of shifted partial products), run as
// approx_product.cuh's approx_mac_lean: with the operand-only terms
// hoisted, PC3_TR takes 17 operations a MAC with its f32 add (FLA 20, HLA
// 23), about half of them IMAD and FADD on the FMA pipe and half logic,
// shifts, compares and selects on the ALU pipe. An SM issues 4 warp
// instructions a clock (132 x 128 lanes x 1.98 GHz = 33.4e12 a second),
// which is far above the memory bound at every M the model sends: a
// (4, 2048) x (2048, 5632) decode product moves 23 MB (7 us) but issues
// ~0.78e9 operations (23 us). The bound is reached only when all 132 SMs
// run enough independent MAC chains with the two pipes kept equally busy.
//
// Two paths, one function (the wrapper's _plan picks the path, and the
// split-K path's row tile and columns a thread, by shape; the bits do not
// change):
//   * the tile path (large M): one 64 x 64 output tile per block, 256
//     threads, 4 x 4 outputs per thread (rows ty + 16 i, columns tx + 16 j:
//     neighbouring threads take neighbouring columns, so shared-memory reads
//     do not conflict); K in steps of 16, each step's a and w tiles
//     decomposed once into shared memory (sign, exponent, mantissa; for
//     PC2/PC3 also the multiplier's head weight and low-line mask), so the
//     decomposition is spread over the 64 products each element enters; the
//     4 x 4 register accumulator holds the chunk's part and each thread's
//     total sits in shared memory (so the order costs no registers);
//   * the split-K path (decode, small M or a small tile grid): at M = 4 the
//     tile grid is N / 64 blocks, each walking all of K with 4 of its 64
//     rows real, so it leaves most SMs idle and most lanes multiplying
//     zeros. Here a block of 128 threads owns 128 NC columns, one K chunk
//     and a tile of MR rows: grid (ceil(N / 128 NC), K / kKc, ceil(M / MR)).
//     Only real rows are decomposed (their chunk fields go once into shared
//     memory, read as one broadcast 16-byte word per row and k); each thread
//     owns NC neighbouring columns of the MR rows (NC = 4, loaded as one
//     8-byte word, where the grid is large; NC = 1 for the narrower GEMMs,
//     which then get 4x the threads; MR = 1, 4 or 16 by M, and MR = 1 for
//     the narrowest, k/v at decode, so each row has its own blocks); each
//     w element is decomposed once per row tile; each block writes its
//     chunk's part to an f32 workspace [chunks, M, N], and a second kernel
//     adds the parts in ascending chunk order from 0.0;
//   * ragged M/N/K edges load as raw zeros, whose zero mantissa gives a
//     zero product (which leaves a part's value alone), so the wrapper pads
//     nothing; rows past M are not computed.
//   * an expert axis (daism_matmul_experts, the MoE FFN's batched expert
//     GEMM): E products (M, K) @ (K, N) in one launch, expert e in grid z
//     (folded with the row tiles on the split-K path), its operands at
//     per-expert element strides (0 for an `a` that every expert shares,
//     as the dense MoE's broadcast tokens), its output block e M N. The
//     axis only offsets the pointers, so each expert's rows are the bits
//     of a 2-D launch on its operands;
// Packing the fields, a 128 x 128 mantissa-product table in shared memory
// and persistent tiles are left for later.
//
// EXACT (exact_gemm.cuh) is another kernel on the tensor cores: bf16
// products are exact in f32, and EXACT's summation order is not part of its
// function. It is bound by bytes up to M ~ 128 and by the bf16 tensor-core
// rate above. Three paths: TMA-fed wgmma on 64 x 128 (M <= 64) or 128 x 256
// tiles ("tile"); the same with K cut into slices where the tile grid would
// leave SMs idle ("splitk": decode, the 128-row prefill chunk, k/v), the
// slices' parts added by splitk_sum below; and the same kernel with plain
// zero-filled loads for shapes and pointers TMA cannot take ("edge").

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "approx_product.cuh"
#include "exact_gemm.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kSub = 4;  // outputs per thread along m and along n

// K chunk of the summation order: part of the function (a multiple of kBK;
// kernels/daism_matmul.py KC holds the same value). DAISM_KC builds another
// chunk only for tools/gemm_kc_sweep.py, which measured the choice.
#ifndef DAISM_KC
#define DAISM_KC 64
#endif
constexpr int kKc = DAISM_KC;
static_assert(kKc % kBK == 0, "a chunk is a whole number of K steps");

// split-K path
constexpr int kSkThreads = 128;
constexpr int kSkMaxRows = 16;  // rows per block (grid z)

// The split-K block's dynamic shared memory: the chunk's multiplier fields,
// one int4 per (row, k) of its MR rows (daism_matmul_splitk's xs).
constexpr size_t splitk_smem(int mr) { return sizeof(int4) * mr * kKc; }

template <int V>
__global__ void __launch_bounds__(kThreads)
    daism_matmul_approx(const uint16_t* __restrict__ a,
                        const uint16_t* __restrict__ w,
                        float* __restrict__ out, int M, int K, int N,
                        long long a_es, long long w_es) {
  // multiplier fields, [k][m] (+1 column against bank conflicts on store)
  __shared__ int x_lines[kBK][kBM + 1];
  __shared__ int x_head[kBK][kBM + 1];
  __shared__ int x_exp[kBK][kBM + 1];
  __shared__ uint32_t x_sign[kBK][kBM + 1];
  // multiplicand fields, [k][n]
  __shared__ int w_man[kBK][kBN];
  __shared__ int w_exp[kBK][kBN];
  __shared__ uint32_t w_sign[kBK][kBN];
  // each thread's total over the finished chunks (in shared memory, so the
  // chunk order costs no registers in the MAC loop)
  __shared__ float total[kSub * kSub][kThreads];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // expert blockIdx.z: its operands at the experts' strides, its output
  // block of M x N
  a += blockIdx.z * a_es;
  w += blockIdx.z * w_es;
  out += static_cast<size_t>(blockIdx.z) * M * N;

  int rows = 0;  // rows of this thread inside M (rows grow with i)
#pragma unroll
  for (int i = 0; i < kSub; ++i) rows += (m0 + ty + 16 * i < M);

  float part[kSub][kSub];  // the current chunk's part
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      part[i][j] = 0.0f;
      total[i * kSub + j][tid] = 0.0f;
    }

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int mm = idx / kBK;
      const int kk = idx % kBK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      const uint16_t bits =
          (gm < M && gk < K) ? a[static_cast<size_t>(gm) * K + gk] : 0;
      const daism::XFields f = daism::decompose_x<V>(bits);
      x_lines[kk][mm] = f.lines;
      x_head[kk][mm] = f.head;
      x_exp[kk][mm] = f.exp;
      x_sign[kk][mm] = f.sign;
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int kk = idx / kBN;
      const int nn = idx % kBN;
      const int gk = k0 + kk;
      const int gn = n0 + nn;
      const uint16_t bits =
          (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : 0;
      const daism::WFields f = daism::decompose_w(bits);
      w_man[kk][nn] = f.man;
      w_exp[kk][nn] = f.exp;
      w_sign[kk][nn] = f.sign;
    }
    __syncthreads();

    if (rows > 0) {
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        daism::WFields wf[kSub];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const int nn = tx + 16 * j;
          wf[j] = daism::WFields{w_man[kk][nn], w_exp[kk][nn], w_sign[kk][nn]};
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          if (i < rows) {
            const int mm = ty + 16 * i;
            const daism::XFields xf{x_lines[kk][mm], x_head[kk][mm],
                                    x_exp[kk][mm], x_sign[kk][mm]};
#pragma unroll
            for (int j = 0; j < kSub; ++j)
              part[i][j] = daism::approx_mac_lean<V>(part[i][j], xf, wf[j]);
          }
        }
      }
      // the chunk ends here (or K does): fold its part into the total
      if ((k0 + kBK) % kKc == 0 || k0 + kBK >= K) {
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            float& t = total[i * kSub + j][tid];
            t = __fadd_rn(t, part[i][j]);
            part[i][j] = 0.0f;
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        out[static_cast<size_t>(gm) * N + gn] = total[i * kSub + j][tid];
    }
  }
}

// w[k, n0 .. n0 + NC - 1] as NC bf16 bit patterns (zeros past N). `vec`:
// they are one aligned 2 NC-byte word (N % NC == 0 and w aligned).
template <int NC>
__device__ __forceinline__ void load_w(uint16_t (&e)[NC],
                                       const uint16_t* __restrict__ w, int k,
                                       int n0, int N, bool vec) {
  const uint16_t* row = w + static_cast<size_t>(k) * N + n0;
  if constexpr (NC == 4) {
    if (vec) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(row));
      e[0] = x.x & 0xFFFFu;
      e[1] = x.x >> 16;
      e[2] = x.y & 0xFFFFu;
      e[3] = x.y >> 16;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) e[j] = n0 + j < N ? __ldg(row + j) : 0;
}

// Split-K path: one block per (128 NC columns, one K chunk, up to MR rows).
// Writes the chunk's part per output: to ws[chunk][m][n], or, when K is a
// single chunk, the total 0 + part straight to out.
template <int V, int MR, int NC>
__global__ void __launch_bounds__(kSkThreads)
    daism_matmul_splitk(const uint16_t* __restrict__ a,
                        const uint16_t* __restrict__ w,
                        float* __restrict__ dst, int M, int K, int N,
                        int E, long long a_es, long long w_es, int direct,
                        int w_vec) {
  // the chunk's multiplier fields {lines, head, exp, sign} per (row, k),
  // [MR][kKc] (dynamic: past 48 KB at 16 rows once kKc > 192)
  extern __shared__ int4 xs[];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.y;
  const int kb = chunk * kKc;
  const int kn = min(kKc, K - kb);
  // blockIdx.z: expert e's row tile mt
  const int mtiles = (M + MR - 1) / MR;
  const int e = blockIdx.z / mtiles;
  const int m0 = (blockIdx.z % mtiles) * MR;
  const int rows = min(MR, M - m0);
  const int n0 = (blockIdx.x * kSkThreads + tid) * NC;
  a += e * a_es;
  w += e * w_es;

  for (int idx = tid; idx < MR * kKc; idx += kSkThreads) {
    const int r = idx / kKc;
    const int kk = idx % kKc;
    const uint16_t bits =
        (r < rows && kk < kn)
            ? a[static_cast<size_t>(m0 + r) * K + kb + kk] : 0;
    const daism::XFields f = daism::decompose_x<V>(bits);
    xs[r * kKc + kk] =
        make_int4(f.lines, f.head, f.exp, static_cast<int>(f.sign));
  }
  __syncthreads();
  if (n0 >= N) return;  // no barrier follows
  const bool vec = w_vec && n0 + NC <= N;

  float part[MR][NC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) part[i][j] = 0.0f;

  // w rows are loaded kAhead ahead of their use
  constexpr int kAhead = 4;
  uint16_t cur[kAhead][NC];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u < kn) {
      load_w<NC>(cur[u], w, kb + u, n0, N, vec);
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j) cur[u][j] = 0;
    }
  }

  for (int k0 = 0; k0 < kn; k0 += kAhead) {
    uint16_t nxt[kAhead][NC];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int kk = k0 + kAhead + u;
      if (kk < kn) {
        load_w<NC>(nxt[u], w, kb + kk, n0, N, vec);
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) nxt[u][j] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int kk = k0 + u;
      if (kk >= kn) break;
      daism::WFields wf[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) wf[j] = daism::decompose_w(cur[u][j]);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        if (i < rows) {
          const int4 xv = xs[i * kKc + kk];
          const daism::XFields xf{xv.x, xv.y, xv.z,
                                  static_cast<uint32_t>(xv.w)};
#pragma unroll
          for (int j = 0; j < NC; ++j)
            part[i][j] = daism::approx_mac_lean<V>(part[i][j], xf, wf[j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int j = 0; j < NC; ++j) cur[u][j] = nxt[u][j];
  }

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i >= rows) continue;
    // out is [E][M][N]; the workspace [chunks][E][M][N]
    const size_t row = (direct ? 0 : static_cast<size_t>(chunk) * E * M) +
                       static_cast<size_t>(e) * M + m0 + i;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (n0 + j >= N) continue;
      dst[row * N + n0 + j] = direct ? __fadd_rn(0.0f, part[i][j])
                                     : part[i][j];
    }
  }
}

// The split-K second pass: out[i] = 0 + ws[0][i] + ws[1][i] + ..., in
// ascending chunk order.
__global__ void __launch_bounds__(256)
    splitk_sum(const float* __restrict__ ws, float* __restrict__ out,
               int chunks, long long mn) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float total = 0.0f;
  for (int c = 0; c < chunks; ++c) total = __fadd_rn(total, ws[c * mn + i]);
  out[i] = total;
}

// The operands of the E experts' products, (M, K) @ (K, N) each: expert e
// reads a + e a_es and w + e w_es (element strides; a_es = 0 shares one a)
// and writes out + e M N.
struct Experts {
  int E;
  long long a_es, w_es;
};

template <int V>
int launch_tile(const uint16_t* a, const uint16_t* w, float* out, int M,
                int K, int N, Experts ex, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, ex.E);
  daism_matmul_approx<V><<<grid, kThreads, 0, s>>>(a, w, out, M, K, N,
                                                   ex.a_es, ex.w_es);
  return static_cast<int>(cudaGetLastError());
}

template <int V, int MR, int NC>
int launch_splitk_mr(const uint16_t* a, const uint16_t* w, float* out,
                     float* ws, int M, int K, int N, Experts ex,
                     cudaStream_t s) {
  const int chunks = (K + kKc - 1) / kKc;
  const bool direct = chunks == 1;
  const int w_vec = (N % NC == 0) && (ex.w_es % NC == 0) &&
                    (reinterpret_cast<uintptr_t>(w) % (2 * NC) == 0);
  const int cols = kSkThreads * NC;
  const dim3 grid((N + cols - 1) / cols, chunks,
                  ex.E * ((M + MR - 1) / MR));
  constexpr size_t smem = splitk_smem(MR);
  if constexpr (smem > 48 * 1024) {  // opt in once per instantiation
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        daism_matmul_splitk<V, MR, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  daism_matmul_splitk<V, MR, NC><<<grid, kSkThreads, smem, s>>>(
      a, w, direct ? out : ws, M, K, N, ex.E, ex.a_es, ex.w_es, direct,
      w_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return static_cast<int>(err);
  const long long mn = static_cast<long long>(ex.E) * M * N;
  splitk_sum<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
      ws, out, chunks, mn);
  return static_cast<int>(cudaGetLastError());
}

// The split-K launch for a plan's row tile and columns per thread (the
// wrapper's _plan picks them; these are the instantiated pairs).
template <int V>
int launch_splitk(const uint16_t* a, const uint16_t* w, float* out, float* ws,
                  int M, int K, int N, Experts ex, int rows, int cols,
                  cudaStream_t s) {
  if (rows == 1 && cols == 1)
    return launch_splitk_mr<V, 1, 1>(a, w, out, ws, M, K, N, ex, s);
  if (rows == 4 && cols == 1)
    return launch_splitk_mr<V, 4, 1>(a, w, out, ws, M, K, N, ex, s);
  if (rows == 4 && cols == 4)
    return launch_splitk_mr<V, 4, 4>(a, w, out, ws, M, K, N, ex, s);
  if (rows == kSkMaxRows && cols == 1)
    return launch_splitk_mr<V, kSkMaxRows, 1>(a, w, out, ws, M, K, N, ex, s);
  if (rows == kSkMaxRows && cols == 4)
    return launch_splitk_mr<V, kSkMaxRows, 4>(a, w, out, ws, M, K, N, ex, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int V>
int launch_approx(const uint16_t* a, const uint16_t* w, float* out, float* ws,
                  int M, int K, int N, Experts ex, int rows, int cols,
                  cudaStream_t s) {
  return rows ? launch_splitk<V>(a, w, out, ws, M, K, N, ex, rows, cols, s)
              : launch_tile<V>(a, w, out, M, K, N, ex, s);
}

using ApproxLaunch = int (*)(const uint16_t*, const uint16_t*, float*, float*,
                             int, int, int, Experts, int, int, cudaStream_t);

ApproxLaunch approx_launch(int variant) {
  switch (variant) {
    case daism::kFla: return launch_approx<daism::kFla>;
    case daism::kHla: return launch_approx<daism::kHla>;
    case daism::kPc2: return launch_approx<daism::kPc2>;
    case daism::kPc3: return launch_approx<daism::kPc3>;
    case daism::kPc2Tr: return launch_approx<daism::kPc2Tr>;
    case daism::kPc3Tr: return launch_approx<daism::kPc3Tr>;
    default: return nullptr;
  }
}

}  // namespace

// C entry points, bound with ctypes. They launch on `stream`, allocate
// nothing, do not synchronize, and return cudaGetLastError() of the launch
// (0 = ok).

// The K chunk of the summation order (the wrapper checks it against its
// own constant).
extern "C" int daism_matmul_chunk() { return kKc; }

// Shared memory a block of an approximate variant's path uses, in bytes:
// `rows` 0 for the tile path (its static arrays, as the compiled PC3_TR
// kernel reports them), else the dynamic bytes the split-K launch requests
// for row tiles of `rows` and `cols` columns a thread. -1 for a pair the
// launcher does not instantiate or a failed query.
extern "C" long long daism_matmul_smem(int rows, int cols) {
  if (rows == 0) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, daism_matmul_approx<daism::kPc3Tr>) !=
        cudaSuccess)
      return -1;
    return static_cast<long long>(attr.sharedSizeBytes);
  }
  const bool known = (rows == 1 && cols == 1) ||
                     ((rows == 4 || rows == kSkMaxRows) &&
                      (cols == 1 || cols == 4));
  return known ? static_cast<long long>(splitk_smem(rows)) : -1;
}

// Approximate variants: `rows` 0 takes the tile path; else the split-K path
// with row tiles of `rows` (1, 4 or 16) and `cols` columns a thread (1 or
// 4). `ws`: the split-K workspace of ceil(K / chunk) * M * N floats (unused,
// and may be null, on the tile path or when K <= chunk). The caller
// guarantees M, N >= 1, K >= 0, ceil(M / 64) <= 65535 and, on the split-K
// path, ceil(K / chunk) <= 65535 and ceil(M / rows) <= 65535.
// EXACT: `rows` is the tile's rows (64 or 128; negative for the edge path's
// plain loads, which any shape and alignment take; the TMA paths need
// K % 8 == N % 8 == 0 and 16-byte-aligned a and w), `cols` the number of K
// slices (1, or more with a workspace of cols * M * N floats). The caller
// guarantees ceil(N / (2 |rows|)) <= 65535 and cols <= 65535.
extern "C" int daism_matmul(const void* a, const void* w, void* out, void* ws,
                            int M, int K, int N, int variant, int rows,
                            int cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a16 = static_cast<const uint16_t*>(a);
  const auto* w16 = static_cast<const uint16_t*>(w);
  auto* o = static_cast<float*>(out);
  auto* wsf = static_cast<float*>(ws);
  if (K == 0) {  // an empty sum: zeros, as the tile path writes them
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(M) * N, s));
  }
  if (variant == daism::kExact) {
    const int slices = cols;
    if (slices < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int err =
        exact::launch(a16, w16, slices > 1 ? wsf : o, M, K, N, rows, slices, s);
    if (err != 0 || slices == 1) return err;
    const long long mn = static_cast<long long>(M) * N;
    splitk_sum<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(
        wsf, o, slices, mn);
    return static_cast<int>(cudaGetLastError());
  }
  const ApproxLaunch launch = approx_launch(variant);
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(a16, w16, o, wsf, M, K, N, Experts{1, 0, 0}, rows, cols, s);
}

// E experts' approximate products in one launch (the six approximate
// variants; EXACT is refused): out[e] = a[e] @ w[e], (M, K) @ (K, N) each,
// with a[e] = a + e a_es and w[e] = w + e w_es (element strides; a_es = 0
// shares one a between the experts), out [E][M][N]. Each expert's rows are
// the bits of a 2-D daism_matmul launch on its operands: the expert axis is
// one more grid axis, and nothing in the summation order changes. `rows`,
// `cols` and `ws` as for daism_matmul, the workspace E times larger
// (ceil(K / chunk) * E * M * N floats). The caller guarantees, besides
// daism_matmul's, E >= 1, E <= 65535 on the tile path and
// E * ceil(M / rows) <= 65535 on the split-K path.
extern "C" int daism_matmul_experts(const void* a, const void* w, void* out,
                                    void* ws, int E, int M, int K, int N,
                                    long long a_es, long long w_es,
                                    int variant, int rows, int cols,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) {
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(E) * M * N, s));
  }
  const ApproxLaunch launch = approx_launch(variant);
  if (launch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const uint16_t*>(a),
                static_cast<const uint16_t*>(w), static_cast<float*>(out),
                static_cast<float*>(ws), M, K, N, Experts{E, a_es, w_es},
                rows, cols, s);
}
