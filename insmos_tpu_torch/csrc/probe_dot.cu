// Dot-shape rate probe for NVIDIA Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the Pallas TPU probe tools/probe_dotshapes.py
// (main.make_bench.run): out = sum over `reps` of a @ b, bf16 operands,
// float32 accumulation, at the span kernel's extraction and fold shapes.
// `copies` runs the same (M, N) problem in that many independent groups of
// thread blocks, into out (copies, M, N): with one copy the time of one
// problem is read, with one copy per SM the card's rate.
//
// Every rep's product is computed; none is scaled. What bounds it: the
// math rate of the variant's unit (no operand leaves L2 after the first
// rep). Both variants share three parts of their design:
//
// Split over the reps. One copy of a 128 x 128 shape is one output tile,
// one block on a 132-SM card. So the reps of a copy are cut into `splits`
// contiguous ranges (split s: reps [s*reps/S, (s+1)*reps/S)), one block
// per (tile, copy, split): grid (tiles_n, tiles_m, copies * splits). The
// wrapper picks S (tools/probe_dotshapes.py::dot_splits) so that the grid
// fills the card in one wave of one block per SM; with one copy per SM,
// S = 1.
//
// Reduction order. With S > 1 each split stores its float32 partial into
// the workspace ws (copies, S, M, N); then every thread fences, and one
// thread takes a ticket for the (copy, tile). The block that draws the
// last ticket adds the S partials in split order, 0 first, into out
// (coalesced float4 loads, three partials in flight) and resets the ticket
// for the next launch. No float atomics: the sum's order is fixed, so two
// launches agree bit for bit. With S = 1 the block writes out directly.
// One launch per call either way. The fix-up is one SM reading S partial
// tiles of 64 KB (~170 GB/s on an H100): at S = 64 it takes most of a
// small shape's time at one copy.
//
// Block tile 128 x 128 (a 128-wide tile over the last 64 columns when
// N % 128 = 64: its other half reads zeros and is not stored).
//
//   mma  bf16 on the tensor cores through wgmma. One producer warp issues
//        TMA loads of A (128 x 64, K-major) and B (64 x 128 as two 64 x 64
//        boxes, N-major, so wgmma reads it with the transpose bit) with the
//        128-byte swizzle into a 4-stage mbarrier ring; past K's end TMA
//        fills zeros. Two consumer warpgroups, 64 rows each, run
//        wgmma.mma_async m64n128k16 from shared memory, one group in
//        flight while the next stage is awaited. Per-rep promotion: each
//        rep's product goes into its own wgmma accumulator (scale-d 0 on
//        its first k-step), which is then added into the float32 sum on the
//        CUDA cores, as the TPU body adds each dot: the tensor cores'
//        accumulation rounds toward zero and, carried over all 16,384 k-16
//        steps of the (128, 4096) shape, drifted by 2.7e-4 of the sum on an
//        H100 (beyond the probe's 1e-4 tolerance). 64 + 64 float registers.
//   fma  float32 FMA on the CUDA cores, the CUDA-core ceiling of the
//        span kernel's fold tiling. bf16 tiles (128 x 32 of A, K-major as
//        in memory; 32 x 128 of B) are staged raw by 16-byte cp.async into
//        a 3-stage ring (zero fill past K's and N's end) and widened to
//        float32 on the shared -> register load. 256 threads, 8 x 8 outputs
//        each: rows tr + 16 i (so the two rows a warp reads at one k are
//        64 bytes apart: no bank conflict), columns 8 tc .. 8 tc + 7 (one
//        16-byte load of B per k).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace insmos_probe_dot {

constexpr int BM = 128;  // output tile rows
constexpr int BN = 128;  // output tile columns
enum Variant { kMma = 0, kFma = 1 };

// ---- shared by both variants ---------------------------------------------

// The split fix-up, after each of the tile's `splits` blocks has stored its
// partial (copy, split) in ws: the block that draws the tile's last ticket
// (after a fence) resets the ticket for the next launch and writes out's
// tile = the partials added in split order, 0 first. Its 256 threads (the
// consumers; barrier 1) take 16 float4 of the 128 x 128 tile each, rows
// t/32 + 8i, columns 4 (t%32) .. + 3, in two passes of 8 with three
// partials' loads in flight (96 KB a block; within dot_mma's 168
// registers).
constexpr int FIX_THREADS = 256;

__device__ __forceinline__ void split_fixup(const float* __restrict__ ws,
                                            float* __restrict__ out,
                                            int* ticket, int splits, size_t MN,
                                            int N, int m0, int n0) {
  __shared__ int last;
  __threadfence();
  asm volatile("bar.sync 1, %0;" ::"n"(FIX_THREADS) : "memory");
  const int t = threadIdx.x;
  if (t == 0) {
    last = atomicAdd(ticket, 1) == splits - 1;
    if (last) *ticket = 0;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(FIX_THREADS) : "memory");
  if (!last) return;
  __threadfence();
  const int col = n0 + 4 * (t % 32);
  if (col >= N) return;
  const size_t step = (size_t)8 * N;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {  // rows 0-63, then 64-127 of the tile
    const size_t base = (size_t)(m0 + 64 * h + t / 32) * N + col;
    float4 acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < splits; p += 3) {
      float4 u[3][8];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        if (p + d < splits)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            u[d][i] = __ldcg(reinterpret_cast<const float4*>(
                ws + (p + d) * MN + base + i * step));
#pragma unroll
      for (int d = 0; d < 3; ++d)
        if (p + d < splits)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i].x += u[d][i].x; acc[i].y += u[d][i].y;
            acc[i].z += u[d][i].z; acc[i].w += u[d][i].w;
          }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(out + base + i * step) = acc[i];
  }
}

// ---- mma: wgmma fed by TMA -------------------------------------------------

constexpr int MMA_BK = 64;  // one 128-byte swizzle row of bf16
constexpr int MMA_STAGES = 4;
constexpr int MMA_CONSUMER_THREADS = FIX_THREADS;  // two warpgroups
constexpr int MMA_THREADS = MMA_CONSUMER_THREADS + 32;  // + the producer warp
constexpr int A_BYTES = BM * MMA_BK * 2;      // 16 KB
constexpr int B_BOX_BYTES = MMA_BK * 64 * 2;  // 8 KB, 64 columns
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BOX_BYTES;
constexpr int MMA_SMEM = MMA_STAGES * STAGE_BYTES + 1024 + 2 * MMA_STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed; a ring
// that stalls for ~10 s traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1LL << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 2-D TMA load of the box at (c0 inner, c1 outer) into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type
// 1); byte offsets in 16-byte units. The tile base is 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// Keeps the compiler from moving register reads and writes of the
// accumulator across the asynchronous wgmma instructions.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16, K-major) @ B (16 x 128, N-major: transpose bit set);
// d is overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}
#undef D8

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The accumulator fragment of a m64n128 wgmma: thread t of the warpgroup
// holds d[4j .. 4j+3] at rows 16 (t/32) + (t%32)/4 (+8 for the last two),
// columns 8j + 2 (t%4) (+1). Visits each (row, column pair, first index).
template <typename F>
__device__ __forceinline__ void for_frag(int row0, int col0, F f) {
  const int t = threadIdx.x % 128;
  const int r = row0 + 16 * (t / 32) + (t % 32) / 4;
  const int c = col0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    f(r, c + 8 * j, 4 * j);
    f(r + 8, c + 8 * j, 4 * j + 2);
  }
}

__global__ void __launch_bounds__(MMA_THREADS, 1)
    dot_mma(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, float* __restrict__ out,
            float* __restrict__ ws, int* __restrict__ tickets, int M, int K,
            int N, int reps, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + MMA_STAGES * STAGE_BYTES;  // MMA_STAGES x 8 B
  const uint32_t empty = full + MMA_STAGES * 8;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int copy = blockIdx.z / splits, s = blockIdx.z % splits;
  const int r0 = (int)((long long)s * reps / splits);
  const int r1 = (int)((long long)(s + 1) * reps / splits);
  const int KT = (K + MMA_BK - 1) / MMA_BK;
  const int nit = (r1 - r0) * KT;
  const bool half = n0 + 64 >= N;  // the tile's right half is past N

  if (tid == 0) {
    for (int i = 0; i < MMA_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, MMA_CONSUMER_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= MMA_CONSUMER_THREADS) {  // producer warp: one thread issues
    if (tid == MMA_CONSUMER_THREADS) {
      const uint32_t bytes = A_BYTES + (half ? 1 : 2) * B_BOX_BYTES;
      for (int it = 0; it < nit; ++it) {
        const int st = it % MMA_STAGES, k0 = (it % KT) * MMA_BK;
        mbar_wait(empty + 8 * st, ((it / MMA_STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * st, dst = base + st * STAGE_BYTES;
        mbar_expect_tx(bar, bytes);
        tma_load(dst, &map_a, bar, k0, m0);
        tma_load(dst + A_BYTES, &map_b, bar, n0, k0);
        if (!half) tma_load(dst + A_BYTES + B_BOX_BYTES, &map_b, bar, n0 + 64, k0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  const int wg = tid / 128;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  int it = 0;
  for (int r = r0; r < r1; ++r) {
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int st = it % MMA_STAGES;
      mbar_wait(full + 8 * st, (it / MMA_STAGES) & 1);
      const uint32_t a_tile = base + st * STAGE_BYTES + wg * 64 * 128;
      const uint32_t b_tile = base + st * STAGE_BYTES + A_BYTES;
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < MMA_BK / 16; ++kk)
        // A: 16 more K columns are 32 bytes along the swizzled row; B: 16
        // more K rows are two 1024-byte swizzle atoms; its next 64 columns
        // are the second box, 8 KB on
        wgmma_m64n128k16(acc, sw128_desc(a_tile + 32 * kk, 16, 1024),
                         sw128_desc(b_tile + 2048 * kk, B_BOX_BYTES, 1024),
                         (kt | kk) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait<1>();  // the previous k-tile's group is done: free its stage
      fence_regs(acc);
      if (kt > 0 && tid % 32 == 0)
        mbar_arrive(empty + 8 * ((it - 1) % MMA_STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (tid % 32 == 0) mbar_arrive(empty + 8 * ((it - 1) % MMA_STAGES));
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }

  // the sum, or with splits > 1 this split's partial, then the fix-up
  const size_t MN = (size_t)M * N;
  float* dst = splits == 1 ? out + copy * MN
                           : ws + ((size_t)copy * splits + s) * MN;
  for_frag(m0 + 64 * wg, n0, [&](int row, int col, int i) {
    if (col < N)
      *reinterpret_cast<float2*>(dst + (size_t)row * N + col) =
          make_float2(sum[i], sum[i + 1]);
  });
  if (splits > 1)
    split_fixup(ws + (size_t)copy * splits * MN, out + copy * MN,
                tickets + (size_t)copy * gridDim.x * gridDim.y +
                    blockIdx.y * gridDim.x + blockIdx.x,
                splits, MN, N, m0, n0);
}

// ---- fma: float32 on the CUDA cores, fed by cp.async ---------------------

constexpr int FMA_BK = 32;
constexpr int FMA_STAGES = 3;
constexpr int FMA_THREADS = FIX_THREADS;
constexpr int FMA_A = BM * FMA_BK;  // bf16 elements of a stage's A tile
constexpr int FMA_B = FMA_BK * BN;
constexpr int FMA_SMEM = FMA_STAGES * (FMA_A + FMA_B) * 2;  // 48 KB

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__global__ void __launch_bounds__(FMA_THREADS, 1)
    dot_fma(const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ b, float* __restrict__ out,
            float* __restrict__ ws, int* __restrict__ tickets, int M, int K,
            int N, int reps, int splits) {
  extern __shared__ __align__(16) __nv_bfloat16 fsmem[];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int copy = blockIdx.z / splits, s = blockIdx.z % splits;
  const int r0 = (int)((long long)s * reps / splits);
  const int r1 = (int)((long long)(s + 1) * reps / splits);
  const int KT = (K + FMA_BK - 1) / FMA_BK;
  const int nit = (r1 - r0) * KT;

  // stage `st` <- the k-tile of iteration `it` (every rep reads the same
  // tiles): 2 A chunks and 2 B chunks of 16 bytes per thread
  auto load = [&](int st, int it) {
    const int k0 = (it % KT) * FMA_BK;
    __nv_bfloat16* As = fsmem + st * (FMA_A + FMA_B);
    __nv_bfloat16* Bs = As + FMA_A;
#pragma unroll
    for (int e = tid; e < FMA_A / 8; e += FMA_THREADS) {
      const int row = e / (FMA_BK / 8), k = k0 + 8 * (e % (FMA_BK / 8));
      const bool in = k < K;
      cp_async16(As + 8 * e, in ? a + (size_t)(m0 + row) * K + k : a,
                 in ? 16 : 0);
    }
#pragma unroll
    for (int e = tid; e < FMA_B / 8; e += FMA_THREADS) {
      const int k = k0 + e / (BN / 8), n = n0 + 8 * (e % (BN / 8));
      const bool in = k < K && n < N;
      cp_async16(Bs + 8 * e, in ? b + (size_t)k * N + n : b, in ? 16 : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < FMA_STAGES - 1; ++st) {
    if (st < nit) load(st, st);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; it < nit; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FMA_STAGES - 2)
                 : "memory");
    __syncthreads();  // the stage is in, and the one refilled below is free
    if (it + FMA_STAGES - 1 < nit)
      load((it + FMA_STAGES - 1) % FMA_STAGES, it + FMA_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const __nv_bfloat16* As = fsmem + (it % FMA_STAGES) * (FMA_A + FMA_B);
    const __nv_bfloat16* Bs = As + FMA_A;
#pragma unroll 4
    for (int kp = 0; kp < FMA_BK; kp += 2) {
      uint32_t aw[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        aw[i] = *reinterpret_cast<const uint32_t*>(
            As + (tr + 16 * i) * FMA_BK + kp);
      const uint4 b0 = *reinterpret_cast<const uint4*>(Bs + kp * BN + 8 * tc);
      const uint4 b1 =
          *reinterpret_cast<const uint4*>(Bs + (kp + 1) * BN + 8 * tc);
      const float bv0[8] = {bf16_lo(b0.x), bf16_hi(b0.x), bf16_lo(b0.y),
                            bf16_hi(b0.y), bf16_lo(b0.z), bf16_hi(b0.z),
                            bf16_lo(b0.w), bf16_hi(b0.w)};
      const float bv1[8] = {bf16_lo(b1.x), bf16_hi(b1.x), bf16_lo(b1.y),
                            bf16_hi(b1.y), bf16_lo(b1.z), bf16_hi(b1.z),
                            bf16_lo(b1.w), bf16_hi(b1.w)};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a0 = bf16_lo(aw[i]), a1 = bf16_hi(aw[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a0, bv0[j], acc[i][j]);
          acc[i][j] = fmaf(a1, bv1[j], acc[i][j]);
        }
      }
    }
  }

  // the sum, or with splits > 1 this split's partial, then the fix-up
  const size_t MN = (size_t)M * N;
  float* dst = splits == 1 ? out + copy * MN
                           : ws + ((size_t)copy * splits + s) * MN;
  if (n0 + 8 * tc < N)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4* o = reinterpret_cast<float4*>(
          dst + (size_t)(m0 + tr + 16 * i) * N + n0 + 8 * tc);
      o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  if (splits > 1)
    split_fixup(ws + (size_t)copy * splits * MN, out + copy * MN,
                tickets + (size_t)copy * gridDim.x * gridDim.y +
                    blockIdx.y * gridDim.x + blockIdx.x,
                splits, MN, N, m0, n0);
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A bf16 row-major (rows, cols) tensor in boxes of (box_rows, 64 columns),
// 128-byte swizzle, zeros past its end.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* p, int rows,
            int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace insmos_probe_dot

// a (M, K) bf16, b (K, N) bf16, out (copies, M, N) float32; M % 128 == 0,
// N % 64 == 0, K % 8 == 0, a and b 16-byte aligned. splits in [1, reps],
// copies * splits <= 65535; with splits > 1, ws (copies, splits, M, N)
// float32 and tickets (copies * tiles) int32 zeros, which each launch
// leaves at zero. variant: 0 mma, 1 fma.
extern "C" int probe_dot(const void* a, const void* b, void* out, void* ws,
                         void* tickets, int M, int K, int N, int reps,
                         int copies, int splits, int variant, void* stream) {
  using namespace insmos_probe_dot;
  if (M <= 0 || K <= 0 || N <= 0 || M % BM || N % 64 || K % 8 || reps < 1 ||
      copies < 1 || splits < 1 || splits > reps ||
      (long long)copies * splits > 65535 ||
      (splits > 1 && (!ws || !tickets)) || (variant != kMma && variant != kFma))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, M / BM, copies * splits);
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  float* w = (float*)ws;
  int* t = (int*)tickets;
  if (variant == kFma) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        dot_fma, cudaFuncAttributeMaxDynamicSharedMemorySize, FMA_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    dot_fma<<<grid, FMA_THREADS, FMA_SMEM, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, o, w, t, M, K, N,
        reps, splits);
    return (int)cudaGetLastError();
  }
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || !p)
      return (int)cudaErrorSymbolNotFound;
    fn = (EncodeTiled)p;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      dot_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map_a, map_b;
  if (!encode(fn, &map_a, a, M, K, BM) || !encode(fn, &map_b, b, K, N, MMA_BK))
    return (int)cudaErrorInvalidValue;
  dot_mma<<<grid, MMA_THREADS, MMA_SMEM, st>>>(map_a, map_b, o, w, t, M, K, N,
                                               reps, splits);
  return (int)cudaGetLastError();
}
