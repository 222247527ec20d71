// Span-kernel extraction probe for NVIDIA Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU probe tools/probe_extract.py (run_case.make over
// kern_A, kern_B and kern_C). It computes that probe's synthetic span conv:
// for every site i of a block b of `bs` sites and every group g,
//   out[b*bs + i] += sum_d feats[row(q_i + d)] @ wg[g][d*TCP : (d+1)*TCP]
// where row(k) is the key row holding k, found only among the window rows
// [sb[g,b]*16, sb[g,b]*16 + span); a key outside the window contributes
// nothing. Products are of bf16 operands, accumulated in float32.
//
// The TPU bodies built one-hot matrices and extracted on the MXU; that is
// TPU layout and is not carried over. Here the window's keys are staged in
// shared memory, every site finds its taps by search, and the fold runs on
// CUDA cores in float32 exactly as csrc/span_conv.cu::fold does (a 128 x 64
// output tile per block, 8 x 4 outputs per thread, 32-deep reduction chunks
// of gathered feature rows and weights staged in shared memory). The three
// TPU bodies become one template parameter:
//   A  kx binary searches per site (one per tap), one fold over kx*TCP
//   B  the taps of A, then kx separate (bs, TCP) @ (TCP, TOP) passes, each
//      summed apart and added in tap order (kern_B's order)
//   C  one lower bound per site, then a forward scan while key - q < kx
//      (the "delta-once" construction; span_conv.cu's tap search)
// Unlike span_conv.cu, no reduction chunk is skipped when its taps match
// nothing, so every variant issues the full 2*bs*kx*TCP*TOP fold FLOPs of a
// (block, group) and the fold rate reads directly.
//
// What bounds it on this card: the fold, 2*kx*TCP*TOP FLOPs per site and
// group on CUDA cores in float32, against bs*kx*TCP gathered bf16 elements
// and span*4 bytes of keys per (block, group).

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace insmos_probe_extract {

constexpr int NT = 256;       // threads per block
constexpr int BS_MAX = 128;   // sites per block
constexpr int KX_MAX = 5;     // x-taps
constexpr int SPAN_MAX = 512; // key rows per window
constexpr int TO_TILE = 64;   // output columns per block
constexpr int KC = 32;        // reduction chunk of the fold
constexpr int RPT = 8;        // output rows per thread
constexpr int CPT = 4;        // output columns per thread
static_assert((TO_TILE / CPT) * (BS_MAX / RPT) == NT, "thread tiling");

enum Variant { kA = 0, kB = 1, kC = 2 };

struct Geom {
  int V, nrows, NB, bs, G, kx, TCP, TOP, span;
};

struct Smem {
  int keys[SPAN_MAX];
  int rowidx[BS_MAX][KX_MAX];
  float A[KC][BS_MAX];
  float W[KC][TO_TILE];
};

// Lower bound of q in the staged window keys.
__device__ __forceinline__ int lower_bound(const int* keys, int n,
                                           long long q) {
  int L = 0, R = n;
  while (L < R) {
    const int m = (L + R) >> 1;
    if ((long long)keys[m] < q) L = m + 1; else R = m;
  }
  return L;
}

// acc += the gathered (bs, k_hi - k_lo) columns of the extraction @
// w[k_lo:k_hi, to0:to0 + TO_TILE].
__device__ void fold_range(Smem& sm, const __nv_bfloat16* __restrict__ feats,
                           const __nv_bfloat16* __restrict__ w,
                           const Geom& g, int to0, int k_lo, int k_hi,
                           float (&acc)[RPT][CPT]) {
  const int tid = threadIdx.x;
  const int tr = tid / (TO_TILE / CPT);
  const int tc = tid % (TO_TILE / CPT);
  for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
    for (int e = tid; e < KC * BS_MAX; e += NT) {
      const int r = e / KC, kk = e % KC, k = k0 + kk;
      float v = 0.f;
      if (k < k_hi && r < g.bs) {
        const int d = k / g.TCP, c = k - d * g.TCP;
        const int j = sm.rowidx[r][d];
        if (j >= 0) v = __bfloat162float(feats[(size_t)j * g.TCP + c]);
      }
      sm.A[kk][r] = v;
    }
    for (int e = tid; e < KC * TO_TILE; e += NT) {
      const int kk = e / TO_TILE, cc = e % TO_TILE;
      const int k = k0 + kk, col = to0 + cc;
      sm.W[kk][cc] = (k < k_hi && col < g.TOP)
                         ? __bfloat162float(w[(size_t)k * g.TOP + col])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float av[RPT], bv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) av[i] = sm.A[kk][tr * RPT + i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) bv[j] = sm.W[kk][tc * CPT + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// One thread block per (block of bs sites, 64-column tile of TOP); it walks
// the G groups in order.
template <int VARIANT>
__global__ void __launch_bounds__(NT)
    extract_kernel(const int* __restrict__ keys, const int* __restrict__ q,
                   const __nv_bfloat16* __restrict__ feats,
                   const __nv_bfloat16* __restrict__ wg,
                   const int* __restrict__ sb, float* __restrict__ out,
                   Geom g) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int to0 = blockIdx.y * TO_TILE;
  const long long site = (long long)b * g.bs + tid;
  const bool has_q = tid < g.bs && site < g.V;
  const long long qi = has_q ? (long long)q[site] : 0;
  const size_t wstride = (size_t)g.kx * g.TCP * g.TOP;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int gi = 0; gi < g.G; ++gi) {
    // 1. the window's keys; rows past the input read as INT_MAX, which
    //    keeps the staged span sorted and matches nothing
    const long long start = (long long)sb[gi * g.NB + b] * 16;
    for (int r = tid; r < g.span; r += NT) {
      const long long row = start + r;
      sm.keys[r] = (row >= 0 && row < g.nrows) ? keys[row] : INT_MAX;
    }
    if (tid < BS_MAX) {
#pragma unroll
      for (int d = 0; d < KX_MAX; ++d) sm.rowidx[tid][d] = -1;
    }
    __syncthreads();

    // 2. taps
    if (has_q) {
      if (VARIANT == kC) {
        for (int p = lower_bound(sm.keys, g.span, qi); p < g.span; ++p) {
          const long long dk = (long long)sm.keys[p] - qi;
          if (dk >= g.kx) break;
          sm.rowidx[tid][dk] = (int)(start + p);
        }
      } else {
        for (int d = 0; d < g.kx; ++d) {
          const int p = lower_bound(sm.keys, g.span, qi + d);
          if (p < g.span && (long long)sm.keys[p] == qi + d)
            sm.rowidx[tid][d] = (int)(start + p);
        }
      }
    }
    __syncthreads();

    // 3. fold (fold_range ends on a barrier, so the next group may restage)
    const __nv_bfloat16* w = wg + gi * wstride;
    if (VARIANT == kB) {
      for (int d = 0; d < g.kx; ++d) {
        float part[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) part[i][j] = 0.f;
        fold_range(sm, feats, w, g, to0, d * g.TCP, (d + 1) * g.TCP, part);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] += part[i][j];
      }
    } else {
      fold_range(sm, feats, w, g, to0, 0, g.kx * g.TCP, acc);
    }
  }

  const int tr = tid / (TO_TILE / CPT);
  const int tc = tid % (TO_TILE / CPT);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr * RPT + i;
    const long long row = (long long)b * g.bs + r;
    if (r >= g.bs || row >= g.V) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = to0 + tc * CPT + j;
      if (col < g.TOP) out[row * g.TOP + col] = acc[i][j];
    }
  }
}

}  // namespace insmos_probe_extract

// keys (nkeys,) int32 sorted; q (V,) int32; feats (nfeats, TCP) bf16;
// wg (G, kx*TCP, TOP) bf16; sb (G, NB) int32 window starts in 16-row units;
// out (V, TOP) float32. nrows = min(nkeys, nfeats). variant: 0 A, 1 B, 2 C.
extern "C" int probe_extract(const void* keys, const void* q,
                             const void* feats, const void* wg,
                             const void* sb, void* out, int V, int nrows,
                             int NB, int bs, int G, int kx, int TCP, int TOP,
                             int span, int variant, void* stream) {
  using namespace insmos_probe_extract;
  if (bs < 1 || bs > BS_MAX || kx < 1 || kx > KX_MAX || span < 1 ||
      span > SPAN_MAX || variant < kA || variant > kC)
    return (int)cudaErrorInvalidValue;
  if (NB == 0 || TOP == 0) return 0;
  const Geom g{V, nrows, NB, bs, G, kx, TCP, TOP, span};
  const dim3 grid(NB, (TOP + TO_TILE - 1) / TO_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  const int* k = (const int*)keys;
  const int* qq = (const int*)q;
  const __nv_bfloat16* f = (const __nv_bfloat16*)feats;
  const __nv_bfloat16* w = (const __nv_bfloat16*)wg;
  const int* s = (const int*)sb;
  float* o = (float*)out;
  if (variant == kA)
    extract_kernel<kA><<<grid, NT, 0, st>>>(k, qq, f, w, s, o, g);
  else if (variant == kB)
    extract_kernel<kB><<<grid, NT, 0, st>>>(k, qq, f, w, s, o, g);
  else
    extract_kernel<kC><<<grid, NT, 0, st>>>(k, qq, f, w, s, o, g);
  return (int)cudaGetLastError();
}
