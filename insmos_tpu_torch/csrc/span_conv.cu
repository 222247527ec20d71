// Span convolution for NVIDIA Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces both Pallas TPU kernels of insmos_tpu/sparse/span_conv.py with
// one kernel per operand type:
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
// reads the matched feature rows from global memory (neighbouring blocks'
// spans overlap, so these are mostly L2 hits). A slot window thus costs a key
// staging and a search, not a GEMM. One thread block owns one output block
// (and one column tile of it) and walks its groups in order, with the
// block's slots, sorted by (block, group), found from a CSR offset: every
// output element is accumulated by one thread in a fixed order, with no
// atomics and no aliasing.
//
// Two kernels, dispatched by operand type (both hand-written, no fallback):
//
// span_mma_kernel (bf16 operands, the inference path). The fold runs on the
// tensor cores: mma.sync.m16n8k16 bf16 with float32 accumulation, operands
// from shared memory through ldmatrix. 8 warps as 4 (rows) x 2 (columns):
// each warp owns 32 sites x 8*NW8 columns. A column tile covers all of TO up
// to 160 columns (TO 320: 2 x 160), so the key staging, tap search and
// feature gather run once per (block, group) for every column, at most twice
// on the widest decoder convs. Gathered rows and weight chunks (32 deep) come
// in by cp.async through a 3- or 4-stage ring: chunk k+2 or k+3 loads
// while chunk k multiplies. Feature rows are 16-byte copies when TC % 8 ==
// 0, 4-byte copies when TC is even, element loads otherwise; an unmatched
// tap zero-fills its row (src-size 0). TMA has no row gather, so the A side
// stays on cp.async; the weights are re-laid by the wrapper into a
// (G, Kp, TOP) array padded to the chunk depth and tile width, 16-byte
// copies throughout. Staged rows are padded by 8 elements, which makes
// every ldmatrix conflict-free. A chunk whose taps match nothing in the
// block (any_d) is skipped. Zero weight tiles are not: the MotionNet t-band
// leaves most (k16, n8) tiles of a folded weight zero, but skipping them
// cost more than it saved, by a mask the wrapper built (host time) and by a
// warp vote on each B fragment (device time), since the kernel is bound by
// latency, not by the tensor cores. Each group's product is summed on the
// tensor cores and then added, in group order, into the float32 result,
// which each thread keeps for its own elements in shared memory (registers
// hold one group's sum only, so tiles up to N = 96 fit two blocks on an SM
// and one block's search overlaps the other's fold). mma.sync, not wgmma:
// the four 32-row warp tiles keep the register file small enough for two
// blocks, and N varies per conv (16..160 in eight instantiations).
//
// span_conv_kernel (float32 operands, the exact parity runs). The fold runs
// on the CUDA cores in float32, a 128 x 64 tile per block, 8 x 4 outputs per
// thread (TF32 would miss the float32 parity tolerance). The staged A tile
// is padded by one column, so its transposing stores are conflict-free.
//
// What bounds it on this card. Against the least time for its work (useful
// FLOPs at the 989 TF/s bf16 peak, the bytes read once at 3.35 TB/s; bytes
// set it in every shape class of the step but the UNet subm convs at span
// 384) each class runs at 1-6% of that bound on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py). The fold is no longer the limit: the same 46 convs
// of a step take 54.5 ms on the float32 CUDA-core kernel, and 10.6 ms of
// device time on this one (tools/profile_step.py). What is left is latency:
// per block and group a chain of key staging, binary search and a gather
// ring that fills and drains again for the next group, which two blocks on
// an SM overlap only in part.
//
// The slot axis. A multi-stream pod step runs one conv over the S streams
// (slots) of a card at once, as the JAX package's vmap gives the TPU kernels
// a slot axis on their grid: blockIdx.z is the slot. Every per-slot operand
// (keys, feats, the plan, out) is read at its slot's offset (SlotStrides, in
// elements; 0 for an operand that all slots share), and one weight array
// serves every slot. A slot's arithmetic is that of a launch with S = 1, so
// a batched launch equals S single launches bit for bit.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace insmos_span {

constexpr int NT = 256;       // threads per block
constexpr int BS_MAX = 128;   // output sites per block (plan.bs <= 128)
constexpr int KX_MAX = 5;     // x-taps per group
constexpr int SPAN_MAX = 512; // key rows per window (plan.span <= 512)

// float32 kernel
constexpr int TO_TILE = 64;   // output columns per block
constexpr int KC = 32;        // reduction chunk of the fold GEMM
constexpr int RPT = 8;        // output rows per thread
constexpr int CPT = 4;        // output columns per thread
static_assert((TO_TILE / CPT) * (BS_MAX / RPT) == NT, "thread tiling");

// bf16 tensor-core kernel
constexpr int MKC = 32;               // K chunk (two k16 steps)
constexpr int LDA = MKC + 8;          // staged A row: 80 bytes
constexpr int KP_MAX = 4096;          // padded K limit
constexpr int NCH_MAX = KP_MAX / MKC;
static_assert(BS_MAX == 4 * 32 && NT == 8 * 32, "warp tiling 4 x 2");

struct Geom {
  int V, Vin, NB, bs, G, kx, TC, TO, span;
  int X, Y, Z, sx, sy, sz, px, py, pz;
};

// The block's plan inputs (device pointers).
struct PlanPtrs {
  const int* keys;
  const int* ocoords;
  const int* ovalid;
  const int* sb;
  const int* emp;
  const int* dead;
  const int* gp;
  const int* gs;
  int JS;
  const int* slot_off;
};

// Per-slot offsets of the operands, in elements (blockIdx.z is the slot).
struct SlotStrides {
  long long keys, feats, ocoords, ovalid, sb, emp, dead, gp, gs, slot_off,
      out;
};

// The plan inputs of slot z.
__device__ __forceinline__ PlanPtrs at_slot(const PlanPtrs& p,
                                            const SlotStrides& st, int z) {
  PlanPtrs q = p;
  q.keys += z * st.keys;
  q.ocoords += z * st.ocoords;
  q.ovalid += z * st.ovalid;
  q.sb += z * st.sb;
  q.emp += z * st.emp;
  q.dead += z * st.dead;
  q.gp += z * st.gp;
  if (q.gs) q.gs += z * st.gs;
  if (q.slot_off) q.slot_off += z * st.slot_off;
  return q;
}

// One group's row table: input row (or -1) per site and tap, and whether a
// tap matched anywhere in the block.
struct Taps {
  int keys[SPAN_MAX];
  int rowidx[BS_MAX][KX_MAX];
  int any_d[KX_MAX];
};

struct Site {
  bool ok;
  int ox, oy, oz;
};

__device__ __forceinline__ Site load_site(const PlanPtrs& p, const Geom& g,
                                          int b) {
  Site s{false, 0, 0, 0};
  const int t = threadIdx.x;
  const long long row = (long long)b * g.bs + t;
  if (t < g.bs && row < g.V && p.ovalid[row] != 0) {
    s.ok = true;
    s.ox = p.ocoords[3 * row];
    s.oy = p.ocoords[3 * row + 1];
    s.oz = p.ocoords[3 * row + 2];
  }
  return s;
}

// Start a group: no tap found yet.
__device__ __forceinline__ void clear_taps(Taps& sm) {
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
__device__ void find_taps(Taps& sm, const int* __restrict__ keys,
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

// Walk block b's groups in order; for each group with a window, fill the
// row table from its main window and its slot windows, then call
// fold(group). All threads of the block call it together. gs (4, JS): rows
// (group, block or -1, start tile, exclusion row), sorted by (block, group);
// block b's slots are [slot_off[b], slot_off[b + 1]) (JS == 0: no slots).
template <class Fold>
__device__ __forceinline__ void for_each_group(Taps& sm, const PlanPtrs& p,
                                               const Geom& g, int b,
                                               Fold&& fold) {
  const Site site = load_site(p, g, b);
  int s = p.JS ? p.slot_off[b] : 0;
  const int s_end = p.JS ? p.slot_off[b + 1] : 0;
  for (int gi = 0; gi < g.G; ++gi) {
    int e = s;
    while (e < s_end && p.gs[e] == gi) ++e;  // this group's slots: [s, e)
    const bool main_win = p.emp[gi * g.NB + b] == 0;
    if (!main_win && e == s) continue;
    const int ky = p.gp[2 * gi], kz = p.gp[2 * gi + 1];
    clear_taps(sm);
    if (main_win)
      find_taps(sm, p.keys, (long long)p.sb[gi * g.NB + b] * 16, 0, ky, kz,
                g, site);
    for (; s < e; ++s)
      find_taps(sm, p.keys, (long long)p.gs[2 * p.JS + s] * 16,
                p.gs[3 * p.JS + s], ky, kz, g, site);
    fold(gi);
  }
}

// ------------------------------------------------------ float32 kernel
struct Smem32 {
  Taps taps;
  float A[KC][BS_MAX + 1];  // +1: the transposing stores hit 32 banks
  float W[KC][TO_TILE];
};

// The fold GEMM of one group: (bs, kx*TC) gathered rows @ (kx*TC, TO_TILE)
// weights, accumulated into acc.
__device__ void fold32(Smem32& sm, const float* __restrict__ feats,
                       const float* __restrict__ w, const Geom& g, int to0,
                       float (&acc)[RPT][CPT]) {
  const int tid = threadIdx.x;
  const int K = g.kx * g.TC;
  const int tr = tid / (TO_TILE / CPT);
  const int tc = tid % (TO_TILE / CPT);
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int k1 = (k0 + KC < K ? k0 + KC : K) - 1;
    bool any = false;
    for (int d = k0 / g.TC; d <= k1 / g.TC; ++d) any |= sm.taps.any_d[d] != 0;
    if (!any) continue;  // same answer in every thread
    for (int e = tid; e < KC * BS_MAX; e += NT) {
      const int r = e / KC, kk = e % KC, k = k0 + kk;
      float v = 0.f;
      if (k < K && r < g.bs) {
        const int d = k / g.TC, c = k - d * g.TC;
        const int j = sm.taps.rowidx[r][d];
        if (j >= 0) v = __ldg(feats + (size_t)j * g.TC + c);
      }
      sm.A[kk][r] = v;
    }
    for (int e = tid; e < KC * TO_TILE; e += NT) {
      const int kk = e / TO_TILE, cc = e % TO_TILE;
      const int k = k0 + kk, col = to0 + cc;
      sm.W[kk][cc] =
          (k < K && col < g.TO) ? __ldg(w + (size_t)k * g.TO + col) : 0.f;
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

// One thread block per (output block, 64-column tile, slot).
__global__ void __launch_bounds__(NT)
    span_conv_kernel(PlanPtrs p0, const float* __restrict__ feats,
                     const float* __restrict__ wg, float* __restrict__ out,
                     Geom g, SlotStrides st) {
  __shared__ Smem32 sm;
  const int z = blockIdx.z;
  const PlanPtrs p = at_slot(p0, st, z);
  feats += z * st.feats;
  out += z * st.out;
  const int b = blockIdx.x;
  const int to0 = blockIdx.y * TO_TILE;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  if (!p.dead[b]) {
    const size_t wstride = (size_t)g.kx * g.TC * g.TO;
    for_each_group(sm.taps, p, g, b, [&](int gi) {
      fold32(sm, feats, wg + gi * wstride, g, to0, acc);
    });
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

// --------------------------------------------------- bf16 tensor-core kernel
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// 16 / 4 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 operands, float32 sum
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct MmaGeom {
  int Kp;   // padded K (multiple of MKC) of the re-laid weight
  int TOP;  // padded columns of the re-laid weight (ntiles * N)
  int vec;  // feature copy width in elements: 8, 2 or 1
};

// A column tile of N = 16 * NW8: the staged weight row and the float32
// result row (both padded by 8: conflict-free ldmatrix and float2 stores),
// blocks per SM, ring depth, and the dynamic shared memory of one block
// (2 blocks up to N = 96: 128 registers a thread, and 3 stages for N = 80
// and 96 to keep two blocks within the SM's shared memory).
template <int NW8>
struct Tile {
  static constexpr int N = 16 * NW8;
  static constexpr int LDB = N + 8;
  static constexpr int LDO = N + 8;
  static constexpr int BLOCKS = NW8 <= 6 ? 2 : 1;
  static constexpr int STAGES = NW8 == 5 || NW8 == 6 ? 3 : 4;
  static constexpr int SMEM =
      STAGES * (BS_MAX * LDA + MKC * LDB) * 2 + BS_MAX * LDO * 4;
};

struct SmemMma {
  Taps taps;
  int live[NCH_MAX];  // chunks to run, in K order
  int nlive;
};

// Issue the copies of K chunk c into ring stage `stage`: the gathered rows
// (BS_MAX x MKC) and the weight rows (MKC x N) of group gi, column tile.
// The copy loops stay rolled: unrolled, their addresses held 30-50 more
// registers a thread and spilled the two-block tiles.
template <int N>
__device__ __forceinline__ void load_chunk(const SmemMma& sm, bf16* As,
                                           bf16* Bs, const bf16* feats,
                                           const bf16* wp, const Geom& g,
                                           const MmaGeom& mg, int gi,
                                           int tile, int c, int stage) {
  constexpr int LDB = N + 8;
  const int tid = threadIdx.x;
  const int K = g.kx * g.TC;
  const int k0 = c * MKC;
  bf16* A = As + stage * (BS_MAX * LDA);
  if (mg.vec == 8) {
#pragma unroll 1
    for (int e = tid; e < BS_MAX * (MKC / 8); e += NT) {
      const int r = e / (MKC / 8), s = e % (MKC / 8);
      const int k = k0 + 8 * s;
      const bf16* src = feats;
      int bytes = 0;
      if (k < K) {
        const int d = k / g.TC;
        const int j = sm.taps.rowidx[r][d];
        if (j >= 0) {
          src = feats + (size_t)j * g.TC + (k - d * g.TC);
          bytes = 16;
        }
      }
      cp_async16(A + r * LDA + 8 * s, src, bytes);
    }
  } else if (mg.vec == 2) {
#pragma unroll 1
    for (int e = tid; e < BS_MAX * (MKC / 2); e += NT) {
      const int r = e / (MKC / 2), s = e % (MKC / 2);
      const int k = k0 + 2 * s;
      const bf16* src = feats;
      int bytes = 0;
      if (k < K) {
        const int d = k / g.TC;
        const int j = sm.taps.rowidx[r][d];
        if (j >= 0) {
          src = feats + (size_t)j * g.TC + (k - d * g.TC);
          bytes = 4;
        }
      }
      cp_async4(A + r * LDA + 2 * s, src, bytes);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < BS_MAX * MKC; e += NT) {
      const int r = e / MKC, kk = e % MKC;
      const int k = k0 + kk;
      bf16 v = __float2bfloat16(0.f);
      if (k < K) {
        const int d = k / g.TC;
        const int j = sm.taps.rowidx[r][d];
        if (j >= 0) v = feats[(size_t)j * g.TC + (k - d * g.TC)];
      }
      A[r * LDA + kk] = v;
    }
  }
  bf16* B = Bs + stage * (MKC * LDB);
  const bf16* w = wp + ((size_t)gi * mg.Kp + k0) * mg.TOP + (size_t)tile * N;
#pragma unroll 1
  for (int e = tid; e < MKC * (N / 8); e += NT) {
    const int kk = e / (N / 8), s = e % (N / 8);
    cp_async16(B + kk * LDB + 8 * s, w + (size_t)kk * mg.TOP + 8 * s, 16);
  }
}

// The warp's share of a chunk: (32 rows) x (8*NW8 columns) x MKC.
template <int NW8>
__device__ __forceinline__ void mma_chunk(const bf16* As, const bf16* Bs,
                                          int stage, float (&cg)[2][NW8][4]) {
  constexpr int LDB = 16 * NW8 + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const bf16* A = As + stage * (BS_MAX * LDA) + (wm * 32 + (lane & 15)) * LDA +
                  (lane >> 4) * 8;
  const bf16* B = Bs + stage * (MKC * LDB) + (lane & 15) * LDB + wn * NW8 * 8;
#pragma unroll
  for (int ks = 0; ks < MKC / 16; ++ks) {
    uint32_t a[2][4];
    ldmatrix_x4(a[0], A + ks * 16);
    ldmatrix_x4(a[1], A + 16 * LDA + ks * 16);
    const bf16* Bk = B + ks * 16 * LDB;
#pragma unroll
    for (int j = 0; j < NW8; j += 2) {
      uint32_t bq[4] = {0u, 0u, 0u, 0u};
      if (j + 1 < NW8)
        ldmatrix_x4_trans(bq, Bk + j * 8 + (lane >> 4) * 8);
      else
        ldmatrix_x2_trans(bq[0], bq[1], Bk + j * 8);
#pragma unroll
      for (int h = 0; h < 2 && j + h < NW8; ++h) {
        mma16816(cg[0][j + h], a[0], bq[2 * h], bq[2 * h + 1]);
        mma16816(cg[1][j + h], a[1], bq[2 * h], bq[2 * h + 1]);
      }
    }
  }
}

// One thread block per (output block, column tile of N = 16 * NW8, slot).
template <int NW8>
__global__ void __launch_bounds__(NT, Tile<NW8>::BLOCKS)
    span_mma_kernel(PlanPtrs p0, const bf16* __restrict__ feats,
                    const bf16* __restrict__ wp, float* __restrict__ out,
                    Geom g, MmaGeom mg, SlotStrides st) {
  using T = Tile<NW8>;
  constexpr int N = T::N, STAGES = T::STAGES;
  extern __shared__ __align__(128) unsigned char dyn[];
  bf16* As = reinterpret_cast<bf16*>(dyn);   // [STAGES][BS_MAX][LDA]
  bf16* Bs = As + STAGES * BS_MAX * LDA;     // [STAGES][MKC][LDB]
  float* res = reinterpret_cast<float*>(Bs + STAGES * MKC * T::LDB);
  __shared__ SmemMma sm;
  const int z = blockIdx.z;
  const PlanPtrs p = at_slot(p0, st, z);
  feats += z * st.feats;
  out += z * st.out;
  const int b = blockIdx.x, tile = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;

  // the float32 result, [BS_MAX][LDO]; each thread owns the elements of
  // its accumulator fragments (c0, c1: row lane/4, cols 2*(lane%4) + 0/1;
  // c2, c3: the row + 8) and is the only one to read or write them
  auto own = [&](int i, int j, int h) -> float2* {
    const int r = wm * 32 + i * 16 + (lane >> 2) + 8 * h;
    const int c = wn * NW8 * 8 + j * 8 + 2 * (lane & 3);
    return reinterpret_cast<float2*>(res + r * T::LDO + c);
  };
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NW8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) *own(i, j, h) = make_float2(0.f, 0.f);

  if (!p.dead[b]) {
    const int K = g.kx * g.TC;
    const int nch = mg.Kp / MKC;
    for_each_group(sm.taps, p, g, b, [&](int gi) {
      // the chunks whose taps matched in the block, in order
      if (warp == 0) {
        int base = 0;
        for (int c0 = 0; c0 < nch; c0 += 32) {
          const int c = c0 + lane;
          bool ok = false;
          const int k0 = c * MKC;
          if (c < nch && k0 < K) {
            const int k1 = (k0 + MKC < K ? k0 + MKC : K) - 1;
            for (int d = k0 / g.TC; d <= k1 / g.TC; ++d)
              ok |= sm.taps.any_d[d] != 0;
          }
          const unsigned bal = __ballot_sync(0xffffffffu, ok);
          if (ok) sm.live[base + __popc(bal & ((1u << lane) - 1u))] = c;
          base += __popc(bal);
        }
        if (lane == 0) sm.nlive = base;
      }
      __syncthreads();
      const int nl = sm.nlive;

      float cg[2][NW8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NW8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) cg[i][j][q] = 0.f;

      // ring: chunk i + STAGES - 1 loads while chunk i multiplies
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nl)
          load_chunk<N>(sm, As, Bs, feats, wp, g, mg, gi, tile, sm.live[s], s);
        cp_async_commit();
      }
      for (int i = 0; i < nl; ++i) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // chunk i landed; chunk i-1's stage is free
        const int nx = i + STAGES - 1;
        if (nx < nl)
          load_chunk<N>(sm, As, Bs, feats, wp, g, mg, gi, tile, sm.live[nx],
                        nx % STAGES);
        cp_async_commit();
        mma_chunk<NW8>(As, Bs, i % STAGES, cg);
      }
      cp_async_wait<0>();
      __syncthreads();  // the next group rewrites the row table and ring

      // the group's tensor-core sum joins the result on the CUDA cores
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NW8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* o = own(i, j, h);
            o->x += cg[i][j][2 * h];
            o->y += cg[i][j][2 * h + 1];
          }
    });
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + i * 16 + (lane >> 2) + 8 * h;
      const long long row = (long long)b * g.bs + r;
      if (r >= g.bs || row >= g.V) continue;
#pragma unroll
      for (int j = 0; j < NW8; ++j) {
        const float2 v = *own(i, j, h);
        const int col = tile * N + wn * NW8 * 8 + j * 8 + 2 * (lane & 3);
        if (col < g.TO) out[row * g.TO + col] = v.x;
        if (col + 1 < g.TO) out[row * g.TO + col + 1] = v.y;
      }
    }
}

template <int NW8>
int launch_mma(const PlanPtrs& p, const bf16* feats, const bf16* wp,
               float* out, const Geom& g, const MmaGeom& mg, int ntiles,
               int S, const SlotStrides& ss, cudaStream_t st) {
  constexpr int smem = Tile<NW8>::SMEM;
  // above 48 KB only after the attribute, set once per device
  static int attr_done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !attr_done[dev]) {
    e = cudaFuncSetAttribute(span_mma_kernel<NW8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attr_done[dev] = 1;
  }
  const dim3 grid(g.NB, ntiles, S);
  span_mma_kernel<NW8><<<grid, NT, smem, st>>>(p, feats, wp, out, g, mg, ss);
  return (int)cudaGetLastError();
}

bool geometry_ok(int bs, int kx, int span, int S) {
  return bs >= 1 && bs <= BS_MAX && kx >= 1 && kx <= KX_MAX && span >= 1 &&
         span <= SPAN_MAX && S >= 1 && S <= 65535;
}

SlotStrides strides_of(const long long* s) {
  return SlotStrides{s[0], s[1], s[2], s[3], s[4], s[5],
                     s[6], s[7], s[8], s[9], s[10]};
}

}  // namespace insmos_span

// Both entry points take S slots (grid z) and `strides`, a host array of the
// 11 per-slot offsets of SlotStrides in its order (keys, feats, ocoords,
// ovalid, sb, emp, dead, gp, gs, slot_off, out), in elements. S = 1 is one
// stream's conv.
//
// float32 operands: feats (Vin, TC), wg (G, kx*TC, TO), out (V, TO) float32
// per slot.
extern "C" int span_conv_f32(const void* keys, const void* feats,
                             const void* wg, const void* ocoords,
                             const void* ovalid, const void* sb,
                             const void* emp, const void* dead, const void* gp,
                             const void* gs, int JS, const void* slot_off,
                             void* out, int V, int Vin, int NB, int bs, int G,
                             int kx, int TC, int TO, int span, int X, int Y,
                             int Z, int sx, int sy, int sz, int px, int py,
                             int pz, int S, const long long* strides,
                             void* stream) {
  using namespace insmos_span;
  if (!geometry_ok(bs, kx, span, S)) return (int)cudaErrorInvalidValue;
  if (NB == 0 || TO == 0) return 0;
  const Geom g{V, Vin, NB, bs, G, kx, TC, TO, span,
               X, Y,   Z,  sx, sy, sz, px, py, pz};
  const PlanPtrs p{(const int*)keys, (const int*)ocoords, (const int*)ovalid,
                   (const int*)sb,   (const int*)emp,     (const int*)dead,
                   (const int*)gp,   (const int*)gs,      JS,
                   (const int*)slot_off};
  const dim3 grid(NB, (TO + TO_TILE - 1) / TO_TILE, S);
  span_conv_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      p, (const float*)feats, (const float*)wg, (float*)out, g,
      strides_of(strides));
  return (int)cudaGetLastError();
}

// bf16 operands: feats (Vin, TC) per slot; wp (G, Kp, TOP) the folded
// weight padded with zeros to Kp = a multiple of 32 rows and TOP = ntiles *
// 16 * nw8 columns; out (V, TO) float32 per slot. vec: 8 (TC % 8 == 0,
// every slot's feats 16-byte aligned), 2 (TC even, 4-byte aligned) or 1.
extern "C" int span_conv_mma(const void* keys, const void* feats,
                             const void* wp, const void* ocoords,
                             const void* ovalid,
                             const void* sb, const void* emp, const void* dead,
                             const void* gp, const void* gs, int JS,
                             const void* slot_off, void* out, int V, int Vin,
                             int NB, int bs, int G, int kx, int TC, int TO,
                             int span, int X, int Y, int Z, int sx, int sy,
                             int sz, int px, int py, int pz, int Kp, int TOP,
                             int nw8, int ntiles, int vec, int S,
                             const long long* strides, void* stream) {
  using namespace insmos_span;
  if (!geometry_ok(bs, kx, span, S) || Kp <= 0 || Kp % MKC || Kp > KP_MAX ||
      Kp < kx * TC || ntiles < 1 || TOP != ntiles * 16 * nw8 || TOP < TO ||
      (vec != 8 && vec != 2 && vec != 1) || (vec == 8 && TC % 8) ||
      (vec == 2 && TC % 2))
    return (int)cudaErrorInvalidValue;
  if (NB == 0 || TO == 0) return 0;
  const Geom g{V, Vin, NB, bs, G, kx, TC, TO, span,
               X, Y,   Z,  sx, sy, sz, px, py, pz};
  const PlanPtrs p{(const int*)keys, (const int*)ocoords, (const int*)ovalid,
                   (const int*)sb,   (const int*)emp,     (const int*)dead,
                   (const int*)gp,   (const int*)gs,      JS,
                   (const int*)slot_off};
  const MmaGeom mg{Kp, TOP, vec};
  const bf16* f = (const bf16*)feats;
  const bf16* w = (const bf16*)wp;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const SlotStrides ss = strides_of(strides);
  switch (nw8) {
    case 1: return launch_mma<1>(p, f, w, o, g, mg, ntiles, S, ss, st);
    case 2: return launch_mma<2>(p, f, w, o, g, mg, ntiles, S, ss, st);
    case 3: return launch_mma<3>(p, f, w, o, g, mg, ntiles, S, ss, st);
    case 4: return launch_mma<4>(p, f, w, o, g, mg, ntiles, S, ss, st);
    case 5: return launch_mma<5>(p, f, w, o, g, mg, ntiles, S, ss, st);
    case 6: return launch_mma<6>(p, f, w, o, g, mg, ntiles, S, ss, st);
    case 8: return launch_mma<8>(p, f, w, o, g, mg, ntiles, S, ss, st);
    case 10: return launch_mma<10>(p, f, w, o, g, mg, ntiles, S, ss, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
