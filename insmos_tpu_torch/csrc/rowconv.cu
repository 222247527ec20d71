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
// What bounds it on this card: bytes. The (R, W * COUT) float32 output is
// written once (at the probe's L1-4D case 409.6 MB of the 640 MB that the
// bound counts), and matches are sparse (about one per valid center at the
// probe's densities, the center itself), so the fold costs little. At those
// densities (Poisson(3) of 16 slots) 81% of the slots are empty.
//
// The design. A half-warp owns one row, a warp two: in the search lane j
// holds slot j, in the fold lane o computes output channel o. The row's
// valid centers are compacted first (lane i holds the i-th one's x), so an
// empty center costs no compare and a pair of rows without one costs its
// zero store alone. Per (row, group) the 16 lanes read the neighbour row's
// xs once, as one coalesced 64-byte line (the next group's line is loaded
// while this one is searched); each lane compares its neighbour slot with
// every valid center in registers (a shuffle and a range test of x_j - x_w
// against the x offsets each), and one ballot a group says whether any
// slot of the two rows matched. Most (row, group) pairs match nothing and
// end there. A match reads its 32 bytes of features (one broadcast load)
// and folds them through the (C, COUT) weight, staged once per block in
// shared memory, in float32, in a fixed order (slot, center, offset); the
// sum of each center goes into the half-warp's row of float32 sums in
// shared memory, which is then written out as one coalesced row, zeros of
// the empty centers included (16-byte stores). Persistent blocks stride
// over row pairs. The TPU layout is not carried over: the block-diagonal
// weight, bd_mask, the RB tiling and the DMA scratch (and with them the
// prototype's tiled mask, which scrambles its im2col).
// What holds it above its bound is instruction issue in the group loop
// (about 75 instructions a warp and group) and the fold of the matches;
// fewer compare instructions, batched line loads and one ballot per x
// offset were each slower (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace insmos_rowconv {

typedef __nv_bfloat16 bf16;

constexpr int C = 16;        // input channels
constexpr int COUT = 16;     // output channels: one a lane of a half-warp
constexpr int W_MAX = 16;    // slots per row: one a lane of a half-warp
constexpr int NT = 256;      // threads per block
constexpr int WARPS = NT / 32;
constexpr int GK_MAX = 90;   // G * kx: 90 * 16 * 16 bf16 = 45 KB
constexpr int G_MAX = 64;
constexpr int KX_MAX = 8;
constexpr int SENT = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

// dynamic shared memory: the row sums of every half-warp, then the weights
__host__ __device__ constexpr int smem_bytes(int W, int gk) {
  return 2 * WARPS * W * COUT * 4 + gk * C * COUT * 2;
}

__global__ void __launch_bounds__(NT)
    rowconv_kernel(const int* __restrict__ xs, const bf16* __restrict__ feats,
                   const bf16* __restrict__ w, const int* __restrict__ shifts,
                   const int* __restrict__ x_off, float* __restrict__ out,
                   int R, int W, int G, int kx) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float* sums = reinterpret_cast<float*>(dyn);
  bf16* ws = reinterpret_cast<bf16*>(sums + 2 * WARPS * W * COUT);
  __shared__ int sh[G_MAX], dxs[KX_MAX];
  // each half-warp's valid centers in slot order: x and slot
  __shared__ int cxs[2 * WARPS][W_MAX], cws[2 * WARPS][W_MAX];
  {
    const uint4* src = reinterpret_cast<const uint4*>(w);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    for (int e = threadIdx.x; e < G * kx * C * COUT / 8; e += NT)
      dst[e] = __ldg(src + e);
  }
  if (threadIdx.x < G) sh[threadIdx.x] = shifts[threadIdx.x];
  if (threadIdx.x < kx) dxs[threadIdx.x] = x_off[threadIdx.x];
  __syncthreads();
  int dmin = dxs[0], dmax = dxs[0];
  for (int k = 1; k < kx; ++k) {
    dmin = min(dmin, dxs[k]);
    dmax = max(dmax, dxs[k]);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = lane >> 4, hl = lane & 15, base = 16 * half;
  const int hw = 2 * warp + half;                    // this half-warp
  float* acc = sums + hw * W * COUT;                 // [W][COUT]
  float4* acc4 = reinterpret_cast<float4*>(acc);
  const int n4 = W * COUT / 4;  // float4 pieces of a row
  const bool slot = hl < W;
  const int64_t npairs = ((int64_t)R + 1) / 2;

  for (int64_t p = (int64_t)blockIdx.x * WARPS + warp; p < npairs;
       p += (int64_t)gridDim.x * WARPS) {
    const int64_t r = 2 * p + half;
    const bool row_ok = r < R;
    const int xc = (row_ok && slot) ? __ldg(xs + r * W + hl) : SENT;
    const unsigned valid = (__ballot_sync(FULL, xc < SENT) >> base) & 0xffffu;
    const int nv = __popc(valid);
    // compact the valid centers: lane i holds the i-th one's x in cx
    if ((valid >> hl) & 1u) {
      const int i = __popc(valid & ((1u << hl) - 1u));
      cxs[hw][i] = xc;
      cws[hw][i] = hl;
    }
    for (int e = hl; e < n4; e += 16)
      acc4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int nmax = max(nv, __shfl_xor_sync(FULL, nv, 16));
    __syncwarp();
    const int cx = hl < nv ? cxs[hw][hl] : 0;

    if (nmax > 0) {
      // the neighbour line of group g: slot j's x in lane j, SENT when the
      // row lies outside the level (no center is compared against it)
      auto line = [&](int g, bool& in) -> int {
        const int64_t rr = r + sh[g];
        in = row_ok && rr >= 0 && rr < R;
        return (in && slot) ? __ldg(xs + rr * W + hl) : SENT;
      };
      bool in_next;
      int nx_next = line(0, in_next);
      for (int g = 0; g < G; ++g) {
        const int nx = nx_next;
        const bool in = in_next;
        if (g + 1 < G) nx_next = line(g + 1, in_next);
        // hit: the centers whose x + dx could equal this slot's x
        unsigned hit = 0u;
        const bool look = in && slot;
        for (int i = 0; i < nmax; ++i) {
          const int d = nx - __shfl_sync(FULL, cx, base + i);
          if (look && i < nv && d >= dmin && d <= dmax) hit |= 1u << i;
        }
        const unsigned any = __ballot_sync(FULL, hit != 0u);
        if (!any) continue;  // the common case: no match in either row
        // the rare path: each hit slot j in order, each of its centers in
        // slot order, each x offset in order
        const int64_t rr = r + sh[g];
        for (unsigned js = (any >> base) & 0xffffu; js; js &= js - 1u) {
          const int j = __ffs(js) - 1;
          unsigned hj = __shfl_sync(0xffffu << base, hit, base + j);
          const int xj = __shfl_sync(0xffffu << base, nx, base + j);
          const uint4* f =
              reinterpret_cast<const uint4*>(feats + (rr * W + j) * C);
          const uint4 u[2] = {__ldg(f), __ldg(f + 1)};
          const __nv_bfloat162* fp =
              reinterpret_cast<const __nv_bfloat162*>(u);
          for (; hj; hj &= hj - 1u) {
            const int i = __ffs(hj) - 1;
            const int d = xj - cxs[hw][i];
            for (int k = 0; k < kx; ++k) {
              if (dxs[k] != d) continue;
              const bf16* wk = ws + (g * kx + k) * C * COUT + hl;
              float a = 0.f;
#pragma unroll
              for (int c2 = 0; c2 < C / 2; ++c2) {
                const float2 fv = __bfloat1622float2(fp[c2]);
                a = fmaf(fv.x, __bfloat162float(wk[(2 * c2) * COUT]), a);
                a = fmaf(fv.y, __bfloat162float(wk[(2 * c2 + 1) * COUT]), a);
              }
              acc[cws[hw][i] * COUT + hl] += a;
            }
          }
        }
      }
    }

    __syncwarp();  // every lane's sums are in
    if (row_ok) {
      float4* o4 = reinterpret_cast<float4*>(out + r * W * COUT);
      for (int e = hl; e < n4; e += 16) o4[e] = acc4[e];
    }
    __syncwarp();  // the next pair rewrites the centers and sums
  }
}

}  // namespace insmos_rowconv

// xs (R, W) int32, feats (R, W * 16) bf16, w (G * kx, 16, 16) bf16, shifts
// (G,) int32, x_off (kx,) int32, out (R, W * 16) float32; feats, w and out
// 16-byte aligned; 1 <= W <= 16, 1 <= G <= 64, 1 <= kx <= 8, G * kx <= 90.
extern "C" int rowconv(const void* xs, const void* feats, const void* w,
                       const void* shifts, const void* x_off, void* out,
                       int R, int W, int G, int kx, void* stream) {
  using namespace insmos_rowconv;
  if (R < 1 || W < 1 || W > W_MAX || G < 1 || G > G_MAX || kx < 1 ||
      kx > KX_MAX || G * kx > GK_MAX)
    return (int)cudaErrorInvalidValue;
  // the attribute is a ceiling: set once, at the largest geometry
  static const cudaError_t attr = cudaFuncSetAttribute(
      rowconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(W_MAX, GK_MAX));
  if (attr != cudaSuccess) return (int)attr;
  const int smem = smem_bytes(W, G * kx);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rowconv_kernel, NT,
                                                smem);
  const int64_t need = (((int64_t)R + 1) / 2 + WARPS - 1) / WARPS;
  const int64_t cap =
      (int64_t)(sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  rowconv_kernel<<<(unsigned)(need < cap ? need : cap), NT, smem,
                   (cudaStream_t)stream>>>(
      (const int*)xs, (const bf16*)feats, (const bf16*)w, (const int*)shifts,
      (const int*)x_off, (float*)out, R, W, G, kx);
  return (int)cudaGetLastError();
}
