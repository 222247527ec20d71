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
// shared memory and every site finds its taps by search. The fold runs on
// the tensor cores by the span kernel's own route (csrc/span_conv.cu::
// span_mma_kernel), so the three restructurings read that kernel's
// machinery: mma.sync.m16n8k16 in bf16 with float32 accumulation over a
// 128 x 128 output tile (sites x columns), operands from shared memory
// through ldmatrix (.trans for the weight). Each 32-deep K chunk (the
// block's 128 gathered feature rows and the weight rows of the column
// tile) comes in by 16-byte cp.async pieces through a 4-stage ring:
// chunk k+3 loads while chunk k multiplies. A missed tap, a row past bs and
// a K or column tail zero-fill their piece (src-size 0). Staged rows are
// padded by 8 elements, which makes every ldmatrix conflict-free. TMA has
// no row gather, so the A side stays on cp.async, and so does the weight,
// which shares the ring. The three TPU bodies become one template
// parameter:
//   A  kx binary searches per site (one per tap), one fold over kx*TCP
//   B  the taps of A, then kx separate (bs, TCP) @ (TCP, TOP) passes, each
//      summed apart in its own zeroed fragments and added in tap order
//      (kern_B's order)
//   C  one lower bound per site, then a forward scan while key - q < kx
//      (the "delta-once" construction; span_conv.cu's tap search)
// A and C sum every group's fold in the same fragments: 8 warps as 4 (rows)
// x 2 (columns), 32 x 64 warp tiles, two blocks an SM. B's two sets of
// fragments would need 198 registers a thread in that tiling, which leaves
// 8 warps an SM; it runs 16 warps as 4 x 4 with 32 x 32 warp tiles, one
// block of 16 warps an SM. Unlike span_conv.cu, no reduction chunk is
// skipped when its taps match nothing, so every variant issues the full
// 2*bs*kx*TCP*TOP fold FLOPs of a (block, group) and the fold rate reads
// directly.
//
// What bounds it on this card: the work is 2*kx*TCP*TOP FLOPs per site and
// group, which the bf16 tensor cores run at up to 989 TF/s; the bound of the
// probe's cases is set by operations. The kernel runs at about a fifth of
// it: its chunk copies and its MMAs overlap little (the gathered rows are
// not the cost: zero-filling them leaves the time as it is), and per
// (block, group) it stages the window's keys and searches the taps. A ring
// across groups and a deeper ring were slower (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace insmos_probe_extract {

typedef __nv_bfloat16 bf16;

constexpr int BS_MAX = 128;    // sites per block
constexpr int KX_MAX = 5;      // x-taps
constexpr int SPAN_MAX = 512;  // key rows per window
constexpr int MKC = 32;        // K chunk (two k16 steps)
constexpr int LDA = MKC + 8;   // staged A row: 80 bytes
constexpr int STAGES = 4;      // cp.async ring depth
constexpr int N = 128;         // output columns per block
constexpr int LDB = N + 8;     // staged weight row: 272 bytes
constexpr int SMEM = STAGES * (BS_MAX * LDA + MKC * LDB) * 2;
static_assert(BS_MAX == 4 * 32, "four 32-row warp tiles");

enum Variant { kA = 0, kB = 1, kC = 2 };

// A variant's warps: 4 (rows) x WN (columns). A and C: 8 warps, 32 x 64
// warp tiles, two blocks an SM. B keeps two sets of fragments,
// so it takes 16 warps with 32 x 32 tiles in one block an SM.
template <int VARIANT>
struct Warps {
  static constexpr int WN = VARIANT == kB ? 4 : 2;
  static constexpr int NT = 4 * WN * 32;
  static constexpr int BLOCKS = VARIANT == kB ? 1 : 2;
};

struct Geom {
  int V, nrows, NB, bs, G, kx, TCP, TOP, span;
};

// One group's window keys and row table (input row or -1 per site and tap).
struct Taps {
  int keys[SPAN_MAX];
  int rowidx[BS_MAX][KX_MAX];
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
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

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 operands, float32 sum
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Issue the copies of the K chunk [k0, k0 + MKC) (cut at k_hi) into ring
// stage `stage`: the block's gathered feature rows (BS_MAX x MKC) and the
// group's weight rows (MKC x N) of the column tile at to0. TCP and TOP are
// multiples of 8, so a 16-byte piece never straddles a tap or the last
// column.
template <int NT>
__device__ __forceinline__ void load_chunk(const Taps& t, bf16* As, bf16* Bs,
                                           const bf16* feats, const bf16* w,
                                           const Geom& g, int to0, int k0,
                                           int k_hi, int stage) {
  const int tid = threadIdx.x;
  bf16* A = As + stage * (BS_MAX * LDA);
#pragma unroll 1
  for (int e = tid; e < BS_MAX * (MKC / 8); e += NT) {
    const int r = e / (MKC / 8), s = e % (MKC / 8);
    const int k = k0 + 8 * s;
    const bf16* src = feats;
    int bytes = 0;
    if (k < k_hi) {
      const int d = k / g.TCP;
      const int j = t.rowidx[r][d];
      if (j >= 0) {
        src = feats + (size_t)j * g.TCP + (k - d * g.TCP);
        bytes = 16;
      }
    }
    cp_async16(A + r * LDA + 8 * s, src, bytes);
  }
  bf16* B = Bs + stage * (MKC * LDB);
#pragma unroll 1
  for (int e = tid; e < MKC * (N / 8); e += NT) {
    const int kk = e / (N / 8), s = e % (N / 8);
    const int k = k0 + kk, col = to0 + 8 * s;
    const bool ok = k < k_hi && col < g.TOP;
    cp_async16(B + kk * LDB + 8 * s, ok ? w + (size_t)k * g.TOP + col : w,
               ok ? 16 : 0);
  }
}

// The warp's share of a chunk: (32 rows) x (8*NC8 columns) x MKC, with
// N = 8 * NC8 * WN.
template <int NC8, int WN>
__device__ __forceinline__ void mma_chunk(const bf16* As, const bf16* Bs,
                                          int stage, float (&cg)[2][NC8][4]) {
  static_assert(8 * NC8 * WN == N, "warps span the column tile");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const bf16* A = As + stage * (BS_MAX * LDA) + (wm * 32 + (lane & 15)) * LDA +
                  (lane >> 4) * 8;
  const bf16* B = Bs + stage * (MKC * LDB) + (lane & 15) * LDB + wn * NC8 * 8;
#pragma unroll
  for (int ks = 0; ks < MKC / 16; ++ks) {
    uint32_t a[2][4];
    ldmatrix_x4(a[0], A + ks * 16);
    ldmatrix_x4(a[1], A + 16 * LDA + ks * 16);
    const bf16* Bk = B + ks * 16 * LDB;
#pragma unroll
    for (int j = 0; j < NC8; j += 2) {
      uint32_t bq[4];
      ldmatrix_x4_trans(bq, Bk + j * 8 + (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma16816(cg[0][j + h], a[0], bq[2 * h], bq[2 * h + 1]);
        mma16816(cg[1][j + h], a[1], bq[2 * h], bq[2 * h + 1]);
      }
    }
  }
}

// cg += the gathered (bs, k_hi - k_lo) columns of the extraction @
// w[k_lo:k_hi, to0:to0 + N], every chunk on the ring. Ends on a barrier,
// so the caller may restage the row table.
template <int NC8, int WN>
__device__ void fold(const Taps& t, bf16* As, bf16* Bs, const bf16* feats,
                     const bf16* w, const Geom& g, int to0, int k_lo,
                     int k_hi, float (&cg)[2][NC8][4]) {
  constexpr int NT = 128 * WN;
  const int nch = (k_hi - k_lo + MKC - 1) / MKC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch)
      load_chunk<NT>(t, As, Bs, feats, w, g, to0, k_lo + s * MKC, k_hi,
                        s);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk i landed; chunk i-1's stage is free
    const int nx = i + STAGES - 1;
    if (nx < nch)
      load_chunk<NT>(t, As, Bs, feats, w, g, to0, k_lo + nx * MKC, k_hi,
                        nx % STAGES);
    cp_async_commit();
    mma_chunk<NC8, WN>(As, Bs, i % STAGES, cg);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int NC8>
__device__ __forceinline__ void zero(float (&c)[2][NC8][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NC8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[i][j][q] = 0.f;
}

// One thread block per (block of bs sites, column tile of N); it walks the
// G groups in order.
template <int VARIANT>
__global__ void __launch_bounds__(Warps<VARIANT>::NT, Warps<VARIANT>::BLOCKS)
    extract_kernel(const int* __restrict__ keys, const int* __restrict__ q,
                   const bf16* __restrict__ feats,
                   const bf16* __restrict__ wg, const int* __restrict__ sb,
                   float* __restrict__ out, Geom g) {
  constexpr int WN = Warps<VARIANT>::WN, NT = Warps<VARIANT>::NT;
  constexpr int NC8 = N / 8 / WN;  // n8 tiles of a warp
  extern __shared__ __align__(128) unsigned char dyn[];
  bf16* As = reinterpret_cast<bf16*>(dyn);  // [STAGES][BS_MAX][LDA]
  bf16* Bs = As + STAGES * BS_MAX * LDA;    // [STAGES][MKC][LDB]
  __shared__ Taps t;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int b = blockIdx.x;
  const int to0 = blockIdx.y * N;
  const long long site = (long long)b * g.bs + tid;
  const bool has_q = tid < g.bs && site < g.V;
  const long long qi = has_q ? (long long)q[site] : 0;
  const int K = g.kx * g.TCP;
  float acc[2][NC8][4];
  zero(acc);

  for (int gi = 0; gi < g.G; ++gi) {
    // 1. the window's keys; rows past the input read as INT_MAX, which
    //    keeps the staged span sorted and matches nothing
    const long long start = (long long)sb[gi * g.NB + b] * 16;
    for (int r = tid; r < g.span; r += NT) {
      const long long row = start + r;
      t.keys[r] = (row >= 0 && row < g.nrows) ? keys[row] : INT_MAX;
    }
    if (tid < BS_MAX) {
#pragma unroll
      for (int d = 0; d < KX_MAX; ++d) t.rowidx[tid][d] = -1;
    }
    __syncthreads();

    // 2. taps
    if (has_q) {
      if (VARIANT == kC) {
        for (int p = lower_bound(t.keys, g.span, qi); p < g.span; ++p) {
          const long long dk = (long long)t.keys[p] - qi;
          if (dk >= g.kx) break;
          t.rowidx[tid][dk] = (int)(start + p);
        }
      } else {
        for (int d = 0; d < g.kx; ++d) {
          const int p = lower_bound(t.keys, g.span, qi + d);
          if (p < g.span && (long long)t.keys[p] == qi + d)
            t.rowidx[tid][d] = (int)(start + p);
        }
      }
    }
    __syncthreads();

    // 3. fold on the tensor cores
    const bf16* w = wg + (size_t)gi * K * g.TOP;
    if (VARIANT == kB) {
      for (int d = 0; d < g.kx; ++d) {
        float part[2][NC8][4];
        zero(part);
        fold<NC8, WN>(t, As, Bs, feats, w, g, to0, d * g.TCP,
                      (d + 1) * g.TCP, part);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NC8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      }
    } else {
      fold<NC8, WN>(t, As, Bs, feats, w, g, to0, 0, K, acc);
    }
  }

  // fragments: c0, c1 at row lane/4, columns 2*(lane%4) + 0/1; c2, c3 at
  // the row + 8. TOP is even, so a column pair is in or out together.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + i * 16 + (lane >> 2) + 8 * h;
      const long long row = (long long)b * g.bs + r;
      if (r >= g.bs || row >= g.V) continue;
#pragma unroll
      for (int j = 0; j < NC8; ++j) {
        const int col = to0 + wn * NC8 * 8 + j * 8 + 2 * (lane & 3);
        if (col < g.TOP)
          *reinterpret_cast<float2*>(out + row * g.TOP + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

template <int VARIANT>
int launch(const int* keys, const int* q, const bf16* feats, const bf16* wg,
           const int* sb, float* out, const Geom& g, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      extract_kernel<VARIANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(g.NB, (g.TOP + N - 1) / N);
  extract_kernel<VARIANT><<<grid, Warps<VARIANT>::NT, SMEM, st>>>(
      keys, q, feats, wg, sb, out, g);
  return (int)cudaGetLastError();
}

}  // namespace insmos_probe_extract

// keys (nkeys,) int32 sorted; q (V,) int32; feats (nfeats, TCP) bf16;
// wg (G, kx*TCP, TOP) bf16; sb (G, NB) int32 window starts in 16-row units;
// out (V, TOP) float32. nrows = min(nkeys, nfeats). TCP and TOP multiples
// of 8, feats and wg 16-byte aligned. variant: 0 A, 1 B, 2 C.
extern "C" int probe_extract(const void* keys, const void* q,
                             const void* feats, const void* wg,
                             const void* sb, void* out, int V, int nrows,
                             int NB, int bs, int G, int kx, int TCP, int TOP,
                             int span, int variant, void* stream) {
  using namespace insmos_probe_extract;
  if (bs < 1 || bs > BS_MAX || kx < 1 || kx > KX_MAX || span < 1 ||
      span > SPAN_MAX || variant < kA || variant > kC || TCP < 8 ||
      TCP % 8 || TOP % 8)
    return (int)cudaErrorInvalidValue;
  if (NB == 0 || TOP == 0) return 0;
  const Geom g{V, nrows, NB, bs, G, kx, TCP, TOP, span};
  const int* k = (const int*)keys;
  const int* qq = (const int*)q;
  const bf16* f = (const bf16*)feats;
  const bf16* w = (const bf16*)wg;
  const int* s = (const int*)sb;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == kA) return launch<kA>(k, qq, f, w, s, o, g, st);
  if (variant == kB) return launch<kB>(k, qq, f, w, s, o, g, st);
  return launch<kC>(k, qq, f, w, s, o, g, st);
}
