// Rowdense submanifold conv probe for NVIDIA Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU prototype tools/probe_pallas_rowconv.py
// (pallas_conv, its pallas_call at :155) with the semantics of that file's
// jnp reference ref_conv (:45-65). A level is R rows of W slots; slot w of
// row r holds an x coordinate xs[r, w] (SENT = 2^30 marks an empty slot)
// and C bf16 features. For each group g (row shift s_g) and x offset dx_k,
// the center slot w of row r takes every slot j of row r + s_g with
// xs[r + s_g, j] == xs[r, w] + dx_k:
//   out[r, w, :] = sum over (g, k, matching j) of feats[r+s_g, j, :] @ w[g, k]
// in float32. Rows r + s_g outside [0, R) are empty (they never wrap), a
// center at SENT gives 0, and every duplicate match is summed.
//
// One thread per (row, center slot), persistent blocks. The G * kx folded
// (C, COUT) weights (27 * 3 * 16 * 16 bf16 = 41 KB) are staged once per
// block in shared memory. Per (group, dx) a thread sums the features of its
// matching slots into a C-wide float32 vector and, if any slot matched,
// folds it through the weight with float32 FMAs. The 16 threads of a row
// read each neighbour row's xs together (one 64-byte line, from L1); a
// slot's features (32 bytes) are read only on a match. What bounds it: the
// G * kx * W compares per center and the (R, W * COUT) float32 output
// write; matches are sparse (at the probe's densities about one per valid
// center, the center itself), so the fold costs little. The TPU layout is
// not carried over: the block-diagonal weight, bd_mask, the RB tiling and
// the DMA scratch (and with them the prototype's tiled mask, which
// scrambles its im2col).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace insmos_rowconv {

constexpr int C = 16;        // input channels
constexpr int COUT = 16;     // output channels
constexpr int NT = 256;      // threads per block
constexpr int GK_MAX = 90;   // G * kx: 90 * 16 * 16 bf16 = 45 KB
constexpr int G_MAX = 64;
constexpr int KX_MAX = 8;
constexpr int SENT = 1 << 30;

__global__ void __launch_bounds__(NT)
    rowconv_kernel(const int* __restrict__ xs,
                   const __nv_bfloat16* __restrict__ feats,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ shifts,
                   const int* __restrict__ x_off, float* __restrict__ out,
                   int R, int W, int G, int kx) {
  __shared__ __align__(16) __nv_bfloat16 ws[GK_MAX * C * COUT];
  __shared__ int sh[G_MAX], dxs[KX_MAX];
  for (int e = threadIdx.x; e < G * kx * C * COUT; e += NT) ws[e] = w[e];
  if (threadIdx.x < G) sh[threadIdx.x] = shifts[threadIdx.x];
  if (threadIdx.x < kx) dxs[threadIdx.x] = x_off[threadIdx.x];
  __syncthreads();

  const int64_t n = (int64_t)R * W;
  for (int64_t t = (int64_t)blockIdx.x * NT + threadIdx.x; t < n;
       t += (int64_t)gridDim.x * NT) {
    const int r = (int)(t / W);
    const int x = xs[t];
    float acc[COUT];
#pragma unroll
    for (int o = 0; o < COUT; ++o) acc[o] = 0.f;
    if (x < SENT) {
      for (int g = 0; g < G; ++g) {
        const int rr = r + sh[g];
        if (rr < 0 || rr >= R) continue;
        const int* nx = xs + (int64_t)rr * W;
        const __nv_bfloat16* nf = feats + (int64_t)rr * W * C;
        for (int k = 0; k < kx; ++k) {
          const int want = x + dxs[k];
          float v[C];
#pragma unroll
          for (int c = 0; c < C; ++c) v[c] = 0.f;
          bool hit = false;
          for (int j = 0; j < W; ++j) {
            if (__ldg(nx + j) != want) continue;
            hit = true;
            const uint4* f = reinterpret_cast<const uint4*>(nf + j * C);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint4 u = __ldg(f + h);
              const __nv_bfloat162* p =
                  reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 q = __bfloat1622float2(p[e]);
                v[h * 8 + 2 * e] += q.x;
                v[h * 8 + 2 * e + 1] += q.y;
              }
            }
          }
          if (!hit) continue;
          const __nv_bfloat16* wk = ws + (g * kx + k) * C * COUT;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const __nv_bfloat162* wr =
                reinterpret_cast<const __nv_bfloat162*>(wk + c * COUT);
#pragma unroll
            for (int o = 0; o < COUT / 2; ++o) {
              const float2 q = __bfloat1622float2(wr[o]);
              acc[2 * o] = fmaf(v[c], q.x, acc[2 * o]);
              acc[2 * o + 1] = fmaf(v[c], q.y, acc[2 * o + 1]);
            }
          }
        }
      }
    }
    float4* o4 = reinterpret_cast<float4*>(out + t * COUT);
#pragma unroll
    for (int o = 0; o < COUT / 4; ++o)
      o4[o] = make_float4(acc[4 * o], acc[4 * o + 1], acc[4 * o + 2],
                          acc[4 * o + 3]);
  }
}

}  // namespace insmos_rowconv

// xs (R, W) int32, feats (R, W * 16) bf16, w (G * kx, 16, 16) bf16, shifts
// (G,) int32, x_off (kx,) int32, out (R, W * 16) float32; feats, w and out
// 16-byte aligned; 1 <= G <= 64, 1 <= kx <= 8, G * kx <= 90.
extern "C" int rowconv(const void* xs, const void* feats, const void* w,
                       const void* shifts, const void* x_off, void* out,
                       int R, int W, int G, int kx, void* stream) {
  using namespace insmos_rowconv;
  if (R < 1 || W < 1 || G < 1 || G > G_MAX || kx < 1 || kx > KX_MAX ||
      G * kx > GK_MAX)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rowconv_kernel, NT,
                                                0);
  const int64_t need = ((int64_t)R * W + NT - 1) / NT;
  const int64_t cap =
      (int64_t)(sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  rowconv_kernel<<<(unsigned)(need < cap ? need : cap), NT, 0,
                   (cudaStream_t)stream>>>(
      (const int*)xs, (const __nv_bfloat16*)feats, (const __nv_bfloat16*)w,
      (const int*)shifts, (const int*)x_off, (float*)out, R, W, G, kx);
  return (int)cudaGetLastError();
}
