// DAISM approximate GEMM for Hopper (sm_90a):
//   out[m, n] = sum_k approx(a[m, k] * w[k, n]),  (M,K) bf16 @ (K,N) bf16 -> f32
//
// Replaces the Pallas TPU kernel repro/kernels/daism_matmul.py::_kernel
// (entry daism_matmul_kernel, wrapper repro/kernels/ops.py::
// daism_matmul_pallas). Per-element products are bit-identical to
// repro_torch/core/floatmul.py (see approx_product.cuh); the sum runs in
// f32 in ascending k order per output, with no atomics, so results are
// deterministic and do not depend on the other rows of the batch.
//
// What bounds it. Every approximate MAC is a chain of integer operations on
// the SM's INT32 lanes (no tensor core computes an OR of shifted partial
// products). Counted from approx_product.cuh, the PC3_TR chain is about 21
// integer operations per MAC once the operand-only terms are hoisted: one
// IMAD for the head line, five AND/OR line selects, the truncation mask,
// the top-bit normalization (3), the exponent add, the sign XOR and about
// seven operations to compose the f32 bits; FLA and HLA need 8 line
// selects. (The TPU kernel's own count, about 24 vector ops per MAC, is the
// same chain on a VPU.) At 64 INT32 lanes per SM that is far above the
// memory bound: a (64, 2048) x (2048, 2048) product moves 8.7 MB but issues
// about 5.6e9 integer operations. At decode (M <= 64) one M tile covers the
// whole batch, so each weight byte is read from device memory about once.
//
// Design (simple and correct first):
//   * one 64 x 64 output tile per block, 256 threads, 4 x 4 outputs per
//     thread (rows ty + 16 i, columns tx + 16 j: neighbouring threads take
//     neighbouring columns, so shared-memory reads do not conflict);
//   * K in steps of 16: each step loads the a and w tiles and decomposes
//     every element once into shared memory (sign, exponent, mantissa; for
//     PC2/PC3 also the multiplier's head weight and low-line mask), so the
//     decomposition is spread over the 64 products each element enters;
//   * ragged M/N/K edges load as raw zeros, whose zero mantissa gives a zero
//     product, so the wrapper pads nothing; rows past M are not computed;
//   * EXACT is an f32 multiply-add of the bf16 values on the same tiling
//     (bf16 products are exact in f32).
// Packing the fields, a 128 x 128 mantissa-product table in shared memory
// and persistent tiles are left for later.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "approx_product.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kSub = 4;  // outputs per thread along m and along n

template <int V>
__global__ void __launch_bounds__(kThreads)
    daism_matmul_approx(const uint16_t* __restrict__ a,
                        const uint16_t* __restrict__ w,
                        float* __restrict__ out, int M, int K, int N) {
  // multiplier fields, [k][m] (+1 column against bank conflicts on store)
  __shared__ int x_lines[kBK][kBM + 1];
  __shared__ int x_head[kBK][kBM + 1];
  __shared__ int x_exp[kBK][kBM + 1];
  __shared__ uint32_t x_sign[kBK][kBM + 1];
  // multiplicand fields, [k][n]
  __shared__ int w_man[kBK][kBN];
  __shared__ int w_exp[kBK][kBN];
  __shared__ uint32_t w_sign[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int rows = 0;  // rows of this thread inside M (rows grow with i)
#pragma unroll
  for (int i = 0; i < kSub; ++i) rows += (m0 + ty + 16 * i < M);

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.0f;

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
              acc[i][j] += daism::approx_product<V>(xf, wf[j]);
          }
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
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    daism_matmul_exact(const uint16_t* __restrict__ a,
                       const uint16_t* __restrict__ w,
                       float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int rows = 0;
#pragma unroll
  for (int i = 0; i < kSub; ++i) rows += (m0 + ty + 16 * i < M);

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int mm = idx / kBK;
      const int kk = idx % kBK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      xs[kk][mm] = daism::bf16_to_f32(
          (gm < M && gk < K) ? a[static_cast<size_t>(gm) * K + gk] : 0);
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int kk = idx / kBN;
      const int nn = idx % kBN;
      const int gk = k0 + kk;
      const int gn = n0 + nn;
      ws[kk][nn] = daism::bf16_to_f32(
          (gk < K && gn < N) ? w[static_cast<size_t>(gk) * N + gn] : 0);
    }
    __syncthreads();

    if (rows > 0) {
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float wv[kSub];
#pragma unroll
        for (int j = 0; j < kSub; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          if (i < rows) {
            const float xv = xs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kSub; ++j)
              acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(xv, wv[j]));
          }
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
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream`, allocates nothing,
// does not synchronize; returns cudaGetLastError() of the launch (0 = ok).
// The caller guarantees M, N >= 1, K >= 0 and ceil(M / 64) <= 65535.
extern "C" int daism_matmul(const void* a, const void* w, void* out, int M,
                            int K, int N, int variant, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a16 = static_cast<const uint16_t*>(a);
  const auto* w16 = static_cast<const uint16_t*>(w);
  auto* o = static_cast<float*>(out);
  switch (variant) {
    case daism::kExact:
      daism_matmul_exact<<<grid, block, 0, s>>>(a16, w16, o, M, K, N);
      break;
    case daism::kFla:
      daism_matmul_approx<daism::kFla><<<grid, block, 0, s>>>(a16, w16, o, M, K, N);
      break;
    case daism::kHla:
      daism_matmul_approx<daism::kHla><<<grid, block, 0, s>>>(a16, w16, o, M, K, N);
      break;
    case daism::kPc2:
      daism_matmul_approx<daism::kPc2><<<grid, block, 0, s>>>(a16, w16, o, M, K, N);
      break;
    case daism::kPc3:
      daism_matmul_approx<daism::kPc3><<<grid, block, 0, s>>>(a16, w16, o, M, K, N);
      break;
    case daism::kPc2Tr:
      daism_matmul_approx<daism::kPc2Tr><<<grid, block, 0, s>>>(a16, w16, o, M, K, N);
      break;
    case daism::kPc3Tr:
      daism_matmul_approx<daism::kPc3Tr><<<grid, block, 0, s>>>(a16, w16, o, M, K, N);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
