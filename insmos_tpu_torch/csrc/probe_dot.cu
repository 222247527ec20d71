// Dot-shape rate probe for NVIDIA Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU probe tools/probe_dotshapes.py
// (main.make_bench.run): out = sum over `reps` of a @ b, bf16 operands,
// float32 accumulation, at the span kernel's extraction and fold shapes.
// `copies` runs the same (M, N) problem in that many independent groups of
// thread blocks (grid z), into out (copies, M, N): with one copy the rate of
// one problem's tiles is read, with one copy per SM the card's.
//
// The TPU kernel held both operands whole in VMEM; (128, 4096) and
// (512, 256) bf16 operands do not fit a thread block's shared memory, so
// here both are streamed through shared memory in 32-deep K chunks, once
// per rep (after the first rep they come from L2). Each block owns a
// 128 x 64 output tile. Two variants:
//   mma  bf16 tensor-core tiles through nvcuda::wmma (16 x 16 x 16, float32
//        accumulator fragments); 8 warps, each a 32 x 32 sub-tile. Each
//        rep's product is accumulated on the tensor cores and then added
//        into the sum on the CUDA cores, as the TPU body adds each dot: the
//        tensor cores' float32 accumulation rounds toward zero, and carried
//        over all 16,384 mma steps of the (128, 4096) shape it drifted by
//        2.7e-4 of the sum on an H100 (beyond the probe's 1e-4 tolerance)
//   fma  float32 FMA on CUDA cores, 8 x 4 outputs per thread, the way
//        csrc/span_conv.cu::fold runs the span kernel's fold today
// What bounds it: the math rate of the variant (no operand leaves L2 after
// the first rep); neither variant uses wgmma, TMA or a multi-stage
// pipeline, so each is a floor for its unit, not the card's peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace insmos_probe_dot {

constexpr int NT = 256;  // threads per block (8 warps)
constexpr int BM = 128;  // output tile rows
constexpr int BN = 64;   // output tile columns
constexpr int BK = 32;   // K chunk
constexpr int LDA = BK + 8;  // padded shared-memory rows (bf16 elements)
constexpr int LDB = BN + 8;
constexpr int RPT = 8;   // fma: output rows per thread
constexpr int CPT = 4;   // fma: output columns per thread
static_assert((BN / CPT) * (BM / RPT) == NT, "fma thread tiling");
static_assert((BM / 32) * (BN / 32) * 32 == NT, "mma warp tiling");

enum Variant { kMma = 0, kFma = 1 };

__global__ void __launch_bounds__(NT)
    dot_mma(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
            int M, int K, int N, int reps) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM][LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK][LDB];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = tid / 32, wm = warp / (BN / 32), wn = warp % (BN / 32);
  // acc: the sum over reps, added on CUDA cores; c: one rep's product on
  // the tensor cores (the TPU body's `acc += dot`)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      // 16-byte copies: 8 bf16 per thread and step
      for (int e = tid; e < BM * BK / 8; e += NT) {
        const int row = e / (BK / 8), c8 = (e % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&As[row][c8]) =
            *reinterpret_cast<const uint4*>(a + (size_t)(m0 + row) * K + k0 +
                                            c8);
      }
      for (int e = tid; e < BK * BN / 8; e += NT) {
        const int row = e / (BN / 8), c8 = (e % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[row][c8]) =
            *reinterpret_cast<const uint4*>(b + (size_t)(k0 + row) * N + n0 +
                                            c8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &Bs[kk][wn * 32 + j * 16], LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < c[i][j].num_elements; ++e)
          acc[i][j].x[e] += c[i][j].x[e];
  }
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          o + (size_t)(m0 + wm * 32 + i * 16) * N + n0 + wn * 32 + j * 16,
          acc[i][j], N, wmma::mem_row_major);
}

__global__ void __launch_bounds__(NT)
    dot_fma(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
            int M, int K, int N, int reps) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tr = tid / (BN / CPT), tc = tid % (BN / CPT);
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int r = 0; r < reps; ++r) {
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int e = tid; e < BK * BM; e += NT) {
        const int row = e / BK, kk = e % BK;
        As[kk][row] = __bfloat162float(a[(size_t)(m0 + row) * K + k0 + kk]);
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, cc = e % BN;
        Bs[kk][cc] = __bfloat162float(b[(size_t)(k0 + kk) * N + n0 + cc]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[RPT], bv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) av[i] = As[kk][tr * RPT + i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) bv[j] = Bs[kk][tc * CPT + j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      o[(size_t)(m0 + tr * RPT + i) * N + n0 + tc * CPT + j] = acc[i][j];
}

}  // namespace insmos_probe_dot

// a (M, K) bf16, b (K, N) bf16, out (copies, M, N) float32; M % 128 == 0,
// N % 64 == 0, K % 32 == 0, a and b 16-byte aligned. variant: 0 mma, 1 fma.
extern "C" int probe_dot(const void* a, const void* b, void* out, int M,
                         int K, int N, int reps, int copies, int variant,
                         void* stream) {
  using namespace insmos_probe_dot;
  if (M <= 0 || K <= 0 || N <= 0 || M % BM || N % BN || K % BK || reps < 1 ||
      copies < 1 || copies > 65535 || (variant != kMma && variant != kFma))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / BM, copies);
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* pa = (const __nv_bfloat16*)a;
  const __nv_bfloat16* pb = (const __nv_bfloat16*)b;
  if (variant == kMma)
    dot_mma<<<grid, NT, 0, st>>>(pa, pb, (float*)out, M, K, N, reps);
  else
    dot_fma<<<grid, NT, 0, st>>>(pa, pb, (float*)out, M, K, N, reps);
  return (int)cudaGetLastError();
}
