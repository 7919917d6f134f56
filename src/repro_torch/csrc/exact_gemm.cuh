// B1's EXACT mode on Hopper's tensor cores:
//   out[m, n] = sum_k f32(a[m, k]) * f32(w[k, n]),  (M,K) bf16 @ (K,N) bf16 -> f32
//
// The exact baseline of repro/kernels/daism_matmul.py::_kernel (its
// Variant.EXACT branch, "straight MXU matmul on the same tiling"). Every
// product of two bf16 values is exact in f32, so EXACT's function is the
// sum; its order is not part of the function (the reference's MXU sums in
// its own order, and the JAX suite holds EXACT to rtol 1e-5 / atol 1e-4).
// Unlike the approximate variants, whose K-chunk order is fixed, EXACT sums
// in whatever order the tensor cores and the K slices below give.
//
// What bounds it: bytes (a, w read once, the f32 out written once, over
// 3.35 TB/s) up to M ~ 128 at TinyLlama's widths, the bf16 tensor-core
// rate (989 TFLOP/s) above.
//
// One kernel, exact_gemm<BM, kTma>, in the shape of a Hopper GEMM:
//   * a block owns a BM x 2 BM output tile (64 x 128 with one consumer
//     warpgroup, two blocks an SM; 128 x 256 with two, one block an SM)
//     and a slice of K; warpgroup 0 is the producer, the others consume;
//   * K is walked in stages of 64 (one 128-byte swizzle row of bf16): a
//     ring of kStages stages in shared memory, each stage's `full` and
//     `empty` mbarriers pass it between producer and consumers;
//   * kTma: one producer thread loads the a tile (BM x 64, K-major) and
//     the w tile (64 x 2 BM, in 64-column boxes: w is (K, N) row-major,
//     which is MN-major for wgmma's B and is read through the descriptor's
//     transpose bit, so nothing is transposed in memory) with TMA, 128-byte
//     swizzled, signalling `full` by transaction bytes. TMA zero-fills past
//     M, N and K, so ragged edges need no masking on the load side. It needs
//     K and N multiples of 8 and 16-byte-aligned operands;
//   * !kTma (the edge path, any shape and alignment): the whole producer
//     warpgroup loads the same tiles with plain 2-byte loads, zero-filled
//     past the edges, and stores them in the same swizzled layout, so the
//     consumers run the same code;
//   * each consumer warpgroup runs wgmma m64n(2 BM)k16 (bf16 in, f32
//     accumulators in registers) four times a stage, keeps one stage's
//     wgmmas in flight and releases the stage before it; the 128 x 256
//     tile's 128 accumulators a thread get registers by setmaxnreg (the
//     producer gives its own back);
//   * the epilogue writes f32 straight from the accumulators, masked at the
//     ragged M and N edges: to `out`, or, when K is cut into slices
//     (grid z, to fill the 132 SMs where the tile grid is small), to the
//     slice's part in a workspace that daism_matmul.cu's splitk_sum adds.
// The wrapper's _plan (kernels/daism_matmul.py) picks tile rows, slices and
// loads; daism_matmul.cu's entry point launches exact::launch.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace exact {

constexpr int kBK = 64;  // K a stage: 64 bf16 = one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kWg = 128;  // threads a warpgroup
constexpr int kRowBytes = kBK * 2;

template <int BM>
struct Tile {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kBN = 2 * BM;
  static constexpr int kThreads = kWg * (kConsumers + 1);
  static constexpr int kMinBlocks = BM == 64 ? 2 : 1;
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kBBytes = kBK * kBN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the ring, 1024-byte aligned (the swizzle pattern's period), then the
  // 2 kStages barriers
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// One 2-D TMA box (c0: the inner, contiguous coordinate) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += a (64 x 16, K-major) . b (16 x N, MN-major: imm-trans-b = 1), f32
// accumulators in the wgmma fragment layout.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_m64n128(d, da, db);
  } else {
    wgmma_m64n256(d, da, db);
  }
}

// Byte offset of element (row, col) of a tile of 128-byte rows in the
// 128-byte swizzle that TMA writes and wgmma reads: the 16-byte chunk index
// (bits 4-6) XORs with the row's index mod 8 (bits 7-9).
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
  return static_cast<uint32_t>(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
}

// Eight bf16 of one row, zero past `valid` (plain loads: any alignment).
__device__ __forceinline__ uint4 load8(const uint16_t* __restrict__ p,
                                       int valid) {
  uint32_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = i < valid ? __ldg(p + i) : 0u;
  return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                    e[4] | (e[5] << 16), e[6] | (e[7] << 16));
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Grid (ceil(M / BM), ceil(N / 2 BM), slices). Slice z sums K tiles
// [z kt_per, (z + 1) kt_per) and writes dst + z M N.
template <int BM, bool kTma>
__global__ void __launch_bounds__(Tile<BM>::kThreads, Tile<BM>::kMinBlocks)
    exact_gemm(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w,
               const uint16_t* __restrict__ a, const uint16_t* __restrict__ w,
               float* __restrict__ dst, int M, int K, int N, int kt_per) {
  using T = Tile<BM>;
  constexpr int kBN = T::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t full0 = ring + kStages * T::kStageBytes;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int kt0 = blockIdx.z * kt_per;
  const int iters = max(0, min((K + kBK - 1) / kBK, kt0 + kt_per) - kt0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kTma ? 1 : kWg);
      mbar_init(empty0 + 8 * s, T::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kWg) {
    // ---- producer warpgroup ----
    if constexpr (BM == 128) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    }
    if constexpr (kTma) {
      if (tid == 0) {
        for (int i = 0; i < iters; ++i) {
          const int st = i % kStages;
          const uint32_t full = full0 + 8 * st;
          const uint32_t sa = ring + st * T::kStageBytes;
          const int k0 = (kt0 + i) * kBK;
          mbar_wait(empty0 + 8 * st, ((i / kStages) & 1) ^ 1);
          mbar_arrive_tx(full, T::kStageBytes);
          tma_load(sa, &map_a, k0, m0, full);
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load(sa + T::kABytes + j * kBK * kRowBytes, &map_w,
                     n0 + 64 * j, k0, full);
        }
      }
    } else {
      for (int i = 0; i < iters; ++i) {
        const int st = i % kStages;
        uint8_t* sa = ring_ptr + st * T::kStageBytes;
        uint8_t* sb = sa + T::kABytes;
        const int k0 = (kt0 + i) * kBK;
        mbar_wait(empty0 + 8 * st, ((i / kStages) & 1) ^ 1);
        // a: BM rows x 8 chunks of 8 k
        for (int idx = tid; idx < BM * 8; idx += kWg) {
          const int r = idx >> 3, ch = idx & 7;
          const int gm = m0 + r, gk = k0 + 8 * ch;
          const int valid = gm < M ? min(8, K - gk) : 0;
          *reinterpret_cast<uint4*>(sa + sw128_offset(r, ch)) =
              load8(a + static_cast<size_t>(gm) * K + gk, valid);
        }
        // w: 64 k rows x kBN / 8 chunks of 8 n, in 64-column boxes
        for (int idx = tid; idx < kBK * (kBN / 8); idx += kWg) {
          const int r = idx / (kBN / 8), g = idx % (kBN / 8);
          const int gk = k0 + r, gn = n0 + 8 * g;
          const int valid = gk < K ? min(8, N - gn) : 0;
          *reinterpret_cast<uint4*>(sb + (g >> 3) * kBK * kRowBytes +
                                    sw128_offset(r, g & 7)) =
              load8(w + static_cast<size_t>(gk) * N + gn, valid);
        }
        // the generic-proxy stores become visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full0 + 8 * st);
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64 c .. 64 c + 63 of the tile ----
    if constexpr (BM == 128) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    }
    const int c = tid / kWg - 1;
    const int t = tid % kWg;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;

    for (int i = 0; i < iters; ++i) {
      const int st = i % kStages;
      const uint32_t sa = ring + st * T::kStageBytes + c * 64 * kRowBytes;
      const uint32_t sb = ring + st * T::kStageBytes + T::kABytes;
      mbar_wait(full0 + 8 * st, (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // a: K-major, 8-row groups 1024 bytes apart (LBO unused); the
        // k16 step is 32 bytes along the swizzled row
        const uint64_t da = sw128_desc(sa + 32 * kk, 16, 8 * kRowBytes);
        // w: MN-major, 64-column boxes kBK rows apart (LBO), 8-k-row
        // groups 1024 bytes apart (SBO); the k16 step is 16 rows
        const uint64_t db = sw128_desc(sb + 16 * kRowBytes * kk,
                                       kBK * kRowBytes, 8 * kRowBytes);
        wgmma_tile<kBN>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one is read: release it
      if (i > 0 && t == 0) mbar_arrive(empty0 + 8 * ((i - 1) % kStages));
    }
    wgmma_wait<0>();

    // fragment layout: warp q of the warpgroup holds rows 16 q + lane / 4
    // (+ 8); acc[4 j + 2 h + e] is column 8 j + 2 (lane % 4) + e
    float* out = dst + static_cast<size_t>(blockIdx.z) * M * N;
    const int lane = t % 32;
    const int row0 = m0 + 64 * c + 16 * (t / 32) + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        float* p = out + static_cast<size_t>(row) * N + col;
        if constexpr (kTma) {  // N % 8 == 0: both columns or neither
          if (col < N)
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          if (col < N) p[0] = acc[4 * j + 2 * h];
          if (col + 1 < N) p[1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, a CUDA driver API function fetched through the
// runtime (so the library links against no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a row-major (rows, cols) bf16 matrix in boxes of box_rows x 64
// columns, 128-byte swizzled, zero-filled out of bounds.
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, bool kTma>
int launch_tile(const uint16_t* a, const uint16_t* w, float* dst, int M,
                int K, int N, int slices, cudaStream_t s) {
  using T = Tile<BM>;
  CUtensorMap map_a{}, map_w{};
  if constexpr (kTma) {
    if (!make_map(&map_a, a, M, K, BM) || !make_map(&map_w, w, K, N, kBK))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      exact_gemm<BM, kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int kt = (K + kBK - 1) / kBK;
  const int kt_per = (kt + slices - 1) / slices;
  const dim3 grid((M + BM - 1) / BM, (N + T::kBN - 1) / T::kBN, slices);
  exact_gemm<BM, kTma><<<grid, T::kThreads, T::kSmem, s>>>(
      map_a, map_w, a, w, dst, M, K, N, kt_per);
  return static_cast<int>(cudaGetLastError());
}

// `rows`: the tile's rows, 64 or 128, negative for the edge path's plain
// loads; `slices`: K slices (grid z), each writing dst + z M N.
inline int launch(const uint16_t* a, const uint16_t* w, float* dst, int M,
                  int K, int N, int rows, int slices, cudaStream_t s) {
  switch (rows) {
    case 64: return launch_tile<64, true>(a, w, dst, M, K, N, slices, s);
    case 128: return launch_tile<128, true>(a, w, dst, M, K, N, slices, s);
    case -64: return launch_tile<64, false>(a, w, dst, M, K, N, slices, s);
    case -128: return launch_tile<128, false>(a, w, dst, M, K, N, slices, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace exact
