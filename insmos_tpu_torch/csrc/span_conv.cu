// Span convolution for NVIDIA Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces both Pallas TPU kernels of insmos_tpu/sparse/span_conv.py with
// one kernel:
//   span_conv.py::_kernel     (main window per group and block)
//   span_conv.py::_gw_kernel  (greedy coverage slots, added onto the main
//                              kernel's output)
// For every output site i of a block of `bs` sorted sites it computes the
// sum over (dy, dz) groups g and x-taps d of
//   feats[row] @ Wg[g, d*TC : (d+1)*TC, :]
// where `row` is the input row whose key equals q_g(i) + d and lies inside one
// of the group's windows for the block: the main window [sb*16, sb*16 + span)
// of a live, non-empty pair, and the slot windows [r*16, r*16 + span) cut
// below their exclusion row `excl`. That is the TPU kernels' span-restricted
// semantics; it equals a global neighbour lookup whenever the plan's
// n_overflow is 0. A pair's windows are disjoint (each slot's exclusion row
// is the coverage end of the windows before it), so a tap matches in at most
// one of them.
//
// What is different from the TPU design, and why. The TPU kernel gathered by
// one-hot matmuls on the MXU (a TPU has no fast random gather) over a
// 16-strided key layout with 128-lane padding, and ran every slot window as a
// second kernel with its own fold GEMM, aliased onto the first one's output.
// Here site keys are unique and sorted, so each site finds its kx taps by one
// binary search in the window's key span, staged in shared memory, plus a
// short forward scan. The taps that the main window and the group's slot
// windows find go into one row table, and ONE fold GEMM per (block, group)
// reads the matched feature rows straight from global memory (neighbouring
// blocks' spans overlap, so these are mostly L2 hits). A slot window thus
// costs a key staging and a search, not a GEMM. One thread block owns one
// output block (and one 64-column tile of it) and walks its groups in order,
// with the block's slots, sorted by (block, group), found from a CSR offset:
// every output element is accumulated by one thread in a fixed order, with
// no atomics and no aliasing.
//
// What bounds it on this card. Narrow convs (the stem: TC = 10, and every
// T=1 UNet conv) are bound by the gathered bytes and the key search: each
// window moves span*4 bytes of keys, and each group bs*kx*TC feature elements
// for 2*bs*kx*TC*TO flops. Wide convs (MotionNet decoder cat convs, TC up to
// 480, TO up to 320) are bound by the fold FLOPs, which this first version
// runs on the CUDA cores in float32 (a 128 x 64 tile per block, 8 x 4 outputs
// per thread). Reduction chunks whose taps match nothing are skipped; dead
// blocks and empty (group, block) pairs without slots skip everything. Moving
// the fold to wgmma on bf16 tiles is the next step.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int BS_MAX = 128;   // output sites per block (plan.bs <= 128)
constexpr int KX_MAX = 5;     // x-taps per group
constexpr int SPAN_MAX = 512; // key rows per window (plan.span <= 512)
constexpr int TO_TILE = 64;   // output columns per block
constexpr int KC = 32;        // reduction chunk of the fold GEMM
constexpr int RPT = 8;        // output rows per thread
constexpr int CPT = 4;        // output columns per thread
static_assert((TO_TILE / CPT) * (BS_MAX / RPT) == NT, "thread tiling");

struct Geom {
  int V, Vin, NB, bs, G, kx, TC, TO, span;
  int X, Y, Z, sx, sy, sz, px, py, pz;
};

struct Smem {
  int keys[SPAN_MAX];
  int rowidx[BS_MAX][KX_MAX];
  int any_d[KX_MAX];
  float A[KC][BS_MAX];
  float W[KC][TO_TILE];
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

struct Site {
  bool ok;
  int ox, oy, oz;
};

__device__ __forceinline__ Site load_site(const int* ocoords,
                                          const int* ovalid, const Geom& g,
                                          int b) {
  Site s{false, 0, 0, 0};
  const int t = threadIdx.x;
  const long long row = (long long)b * g.bs + t;
  if (t < g.bs && row < g.V && ovalid[row] != 0) {
    s.ok = true;
    s.ox = ocoords[3 * row];
    s.oy = ocoords[3 * row + 1];
    s.oz = ocoords[3 * row + 2];
  }
  return s;
}

// Start a group: no tap found yet.
__device__ __forceinline__ void clear_taps(Smem& sm) {
  const int tid = threadIdx.x;
  if (tid < BS_MAX) {
#pragma unroll
    for (int d = 0; d < KX_MAX; ++d) sm.rowidx[tid][d] = -1;
  }
  if (tid < KX_MAX) sm.any_d[tid] = 0;
  __syncthreads();
}

// One window: stage its keys, find every site's taps in it and record them
// in the group's row table. All threads of the block call it together.
__device__ void find_taps(Smem& sm, const int* __restrict__ keys,
                          long long start, long long excl, int ky, int kz,
                          const Geom& g, const Site& site) {
  const int tid = threadIdx.x;
  const long long lo = start > excl ? start : excl;
  const long long hi_all = start + g.span;
  const long long hi = hi_all < g.Vin ? hi_all : (long long)g.Vin;

  // 1. key span; rows below the exclusion row or past the input read as
  //    INT_MIN / INT_MAX, which keeps the staged span sorted
  for (int r = tid; r < g.span; r += NT) {
    const long long row = start + r;
    sm.keys[r] = row < lo ? INT_MIN : (row >= hi ? INT_MAX : keys[row]);
  }
  __syncthreads();

  // 2. taps: lower bound of q in the span, then scan forward while the key
  //    is below q + kx (keys are unique, so each tap matches at most once)
  if (tid < BS_MAX && site.ok) {
    const long long xbase = (long long)site.ox * g.sx - g.px;
    const long long iy = (long long)site.oy * g.sy - g.py + ky;
    const long long iz = (long long)site.oz * g.sz - g.pz + kz;
    if (iy >= 0 && iy < g.Y && iz >= 0 && iz < g.Z) {
      const long long q = (iz * g.Y + iy) * g.X + xbase;
      int L = 0, R = g.span;
      while (L < R) {
        const int m = (L + R) >> 1;
        if ((long long)sm.keys[m] < q) L = m + 1; else R = m;
      }
      for (int p = L; p < g.span; ++p) {
        const long long dk = (long long)sm.keys[p] - q;
        if (dk >= g.kx) break;
        const long long xd = xbase + dk;
        if (xd >= 0 && xd < g.X) {
          sm.rowidx[tid][dk] = (int)(start + p);
          sm.any_d[dk] = 1;
        }
      }
    }
  }
  __syncthreads();  // the next window overwrites the key span
}

// The fold GEMM of one group: (bs, kx*TC) gathered rows @ (kx*TC, TO_TILE)
// weights, accumulated into acc.
template <typename T>
__device__ void fold(Smem& sm, const T* __restrict__ feats,
                     const T* __restrict__ w, const Geom& g, int to0,
                     float (&acc)[RPT][CPT]) {
  const int tid = threadIdx.x;
  const int K = g.kx * g.TC;
  const int tr = tid / (TO_TILE / CPT);
  const int tc = tid % (TO_TILE / CPT);
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int k1 = (k0 + KC < K ? k0 + KC : K) - 1;
    bool any = false;
    for (int d = k0 / g.TC; d <= k1 / g.TC; ++d) any |= sm.any_d[d] != 0;
    if (!any) continue;  // same answer in every thread
    for (int e = tid; e < KC * BS_MAX; e += NT) {
      const int r = e / KC, kk = e % KC, k = k0 + kk;
      float v = 0.f;
      if (k < K && r < g.bs) {
        const int d = k / g.TC, c = k - d * g.TC;
        const int j = sm.rowidx[r][d];
        if (j >= 0) v = ld(feats + (size_t)j * g.TC + c);
      }
      sm.A[kk][r] = v;
    }
    for (int e = tid; e < KC * TO_TILE; e += NT) {
      const int kk = e / TO_TILE, cc = e % TO_TILE;
      const int k = k0 + kk, col = to0 + cc;
      sm.W[kk][cc] =
          (k < K && col < g.TO) ? ld(w + (size_t)k * g.TO + col) : 0.f;
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
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  __syncthreads();  // the next group clears the row table
}

// One thread block per (output block, 64-column tile). gs (4, JS): rows
// (group, block or -1, start tile, exclusion row), sorted by (block, group);
// block b's slots are [slot_off[b], slot_off[b + 1]) (JS == 0: no slots).
template <typename T>
__global__ void __launch_bounds__(NT)
    span_conv_kernel(const int* __restrict__ keys, const T* __restrict__ feats,
                     const T* __restrict__ wg, const int* __restrict__ ocoords,
                     const int* __restrict__ ovalid, const int* __restrict__ sb,
                     const int* __restrict__ emp, const int* __restrict__ dead,
                     const int* __restrict__ gp, const int* __restrict__ gs,
                     int JS, const int* __restrict__ slot_off,
                     float* __restrict__ out, Geom g) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const int to0 = blockIdx.y * TO_TILE;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  if (!dead[b]) {
    const Site site = load_site(ocoords, ovalid, g, b);
    const size_t wstride = (size_t)g.kx * g.TC * g.TO;
    int s = JS ? slot_off[b] : 0;
    const int s_end = JS ? slot_off[b + 1] : 0;
    for (int gi = 0; gi < g.G; ++gi) {
      int e = s;
      while (e < s_end && gs[e] == gi) ++e;  // this group's slots: [s, e)
      const bool main_win = emp[gi * g.NB + b] == 0;
      if (!main_win && e == s) continue;
      const int ky = gp[2 * gi], kz = gp[2 * gi + 1];
      clear_taps(sm);
      if (main_win)
        find_taps(sm, keys, (long long)sb[gi * g.NB + b] * 16, 0, ky, kz, g,
                  site);
      for (; s < e; ++s)
        find_taps(sm, keys, (long long)gs[2 * JS + s] * 16, gs[3 * JS + s], ky,
                  kz, g, site);
      fold<T>(sm, feats, wg + gi * wstride, g, to0, acc);
    }
  }
  const int tid = threadIdx.x;
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
      if (col < g.TO) out[row * g.TO + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int span_conv(const void* keys, const void* feats, const void* wg,
                         const void* ocoords, const void* ovalid,
                         const void* sb, const void* emp, const void* dead,
                         const void* gp, const void* gs, int JS,
                         const void* slot_off, void* out, int V, int Vin,
                         int NB, int bs, int G, int kx, int TC, int TO,
                         int span, int X, int Y, int Z, int sx, int sy, int sz,
                         int px, int py, int pz, int is_bf16, void* stream) {
  if (bs < 1 || bs > BS_MAX || kx < 1 || kx > KX_MAX || span > SPAN_MAX)
    return (int)cudaErrorInvalidValue;
  if (NB == 0 || TO == 0) return 0;
  const Geom g{V, Vin, NB, bs, G, kx, TC, TO, span,
               X, Y,   Z,  sx, sy, sz, px, py, pz};
  const dim3 grid(NB, (TO + TO_TILE - 1) / TO_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  const int* k = (const int*)keys;
  const int* oc = (const int*)ocoords;
  const int* ov = (const int*)ovalid;
  const int* s = (const int*)sb;
  const int* em = (const int*)emp;
  const int* dd = (const int*)dead;
  const int* gpp = (const int*)gp;
  const int* gss = (const int*)gs;
  const int* off = (const int*)slot_off;
  if (is_bf16) {
    span_conv_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        k, (const __nv_bfloat16*)feats, (const __nv_bfloat16*)wg, oc, ov, s,
        em, dd, gpp, gss, JS, off, (float*)out, g);
  } else {
    span_conv_kernel<float><<<grid, NT, 0, st>>>(
        k, (const float*)feats, (const float*)wg, oc, ov, s, em, dd, gpp, gss,
        JS, off, (float*)out, g);
  }
  return (int)cudaGetLastError();
}
