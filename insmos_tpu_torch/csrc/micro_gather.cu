// Gather and search micro-probe kernels for NVIDIA Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU probes tools/micro_pallas.py (T1 pallas_gather,
// T2 pallas_bsearch, T3 pallas_rowg), tools/micro_pallas2.py (T4 rows,
// T5 tala, T6 bs), tools/micro_lanegather.py (T7 lane_gather),
// tools/micro_lanegather2.py (T8 try_case.f) and tools/probe_tala.py (T9).
// The nine TPU bodies are three operations in different layouts, each with
// its table whole in VMEM; here they are three operations on 4-byte elements
// (float32 or int32, copied bit for bit):
//
//   rows     out[q, :] = table[idx[q], :] at any row width. What bounds it:
//            HBM bytes at wide rows (T4: 512 MB of output), L2 sectors at
//            narrow ones: a random 4-byte read costs a 32-byte sector, so
//            T1's 4M reads of a 1 MB table move 134 MB through L2 against
//            the 33 MB its HBM bound counts. At the probes' wide widths (2
//            and 32 pieces of 16 bytes: 8 and 128 floats) gather_rows_kernel
//            puts a row's pieces on neighbouring threads in 2-D, the piece
//            count a template constant (no division per element), RPT_ROWS
//            rows in flight a thread, the table through the read-only path
//            and idx and out evict-first (ld.cs / st.cs: T3's 36 MB and T4's
//            516 MB of streams would push the table out of L2); a grid-stride
//            loop over ROWS_PER_SM blocks per SM (the SM count kept per
//            device). Every other width, and a table or output not 16-byte
//            aligned, runs gather_rows_any_kernel: a thread a piece (the
//            widest of 16, 8 or 4 bytes that divides the row and the
//            pointers), one division per piece. Width 1 (T1) runs it too: a
//            kernel of four queries a thread with 16-byte streams measured
//            within the calls' noise of it (PERF.md).
//   bsearch  out[i] = the left lower bound of q[i] in sorted keys[0, T) (the
//            first index with keys[index] >= q[i], T if none). The keys
//            fall in buckets of 2^s (at most 2^15 buckets: T2's 262,144 keys
//            in buckets of 8, T6's 8,192 in buckets of 1), and the first key
//            of every bucket but the first is a splitter. The splitters are
//            a tree in BFS (Eytzinger) order, padded with INT_MAX to 2^h - 1
//            nodes (at most 128 KB), which every block holds in shared
//            memory: where buckets hold more than one key a pre-pass
//            (tree_build_kernel) builds it once per call into the wrapper's
//            scratch and each block takes it in one bulk copy
//            (cp.async.bulk on an mbarrier); where they hold one, each block
//            builds it from the contiguous keys (a pre-pass kernel cost more
//            device time than the build, PERF.md). The first queries are in
//            flight meanwhile. A query then runs h branchless steps
//            i = 2i + (tree[i] < v) (a shift-add, no index arithmetic: the
//            top five levels are one 128-byte row, so a warp's first loads
//            are broadcasts, and each level is contiguous, so a deeper one
//            costs its random lanes' bank conflicts, ~3.5 wavefronts) and
//            lands in bucket i - 2^h; buckets of one key are then done
//            (keys[0] decides bucket 0), larger ones halve down to a group of
//            8 keys, read as two 16-byte loads of one 32-byte sector from L2.
//            What bounds it: T2 by that sector per query (134 MB) beside
//            35 shared-memory wavefronts a warp of queries, T6 by its 28
//            wavefronts. Queries and answers move as 16-byte evict-first
//            quads. A lower bound has T + 1 answers; the TPU bodies ran
//            ceil(log2 T) halvings and so return 0 for
//            keys[0] < q <= keys[1].
//   lane     out[i, l] = op[(i / S) * stride + idx[i, l], l], with idx[i, l]
//            in [0, span): span = stride, or every row of op when stride is
//            0 (one window over the whole table). What bounds it: HBM
//            bytes at T7's size (three 512 MB arrays), launch latency at T8's
//            and T9's (1-4 MB, L2-resident: 1.5-4 us a case), L2 sectors at
//            T5's (1M random 4-byte reads of a 4 MB table: 33.5 MB of
//            sectors against the 12.6 MB its HBM bound counts). A thread
//            takes four adjacent lanes: one 16-byte load of idx and one
//            16-byte store a row where L % 4 == 0 and the pointers are
//            16-byte aligned, lane by lane otherwise; 32-bit offsets, the
//            window base computed once a row. Two paths, by span:
//            staged  (span <= 384, T7-T9) a block stages the 32-lane strip
//                    of its window (span x 128 bytes <= 48 KB) by 16-byte
//                    cp.async, loads its first rows' indices while the copies
//                    land, then gathers RPT rows a thread from shared memory
//                    (lane l in bank l % 32: the 4 row slots of a warp share
//                    8 banks, a 4-way conflict that costs less than the HBM
//                    stream). A window's rows are split over several blocks,
//                    at least MIN_CHUNK rows each, towards 2 blocks per SM (T8
//                    at S=256: 8 windows x 4 strips x 8 chunks, where one
//                    block a window strip left 100 of 132 SMs idle). Plain
//                    streams: no table stays resident between blocks.
//            l2      (otherwise, T5) op is read from L2 through the read-only
//                    path, a warp a row strip of 128 lanes, RPT_L2 rows a
//                    thread; plain streams (T5's 8 MB leave the table room).
//            A 4-lane column strip of T5's table staged in shared memory
//            (128 KB, a block per SM) was slower than l2: its 16-byte rows
//            fill half of each 32-byte sector, so staging moves as many
//            sectors as l2's random reads (PERF.md).
//   ptxas -v (sm_90a, -O3), registers a thread, no spills and no stack in
//   any: gather_rows_kernel 32, gather_rows_any_kernel 22-24,
//   lane_staged_kernel 32-36 (dynamic shared memory span x 128 bytes),
//   lane_l2_kernel 26-28, lower_bound_kernel 54 (kTailVec), 39-40
//   (kTailNone), 30-32 (kTailScalar), each 4 << h bytes of dynamic shared
//   memory and 16 static (kTailNone: 0), tree_build_kernel 10.
// 32-bit offsets: every array holds at most 2^30 elements (checked). Indices
// are not clamped: the callers check them once, on the host.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace insmos_micro_gather {

constexpr int NT = 256;            // rows, lane: threads per block
constexpr int RPT_ROWS = 8;        // rows: rows in flight a thread
constexpr int ROWS_PER_SM = 8;     // rows: blocks per SM in the grid
constexpr int ANY_PER_SM = 32;     // rows, other widths: blocks per SM
constexpr int RPT = 4;             // lane, staged: rows in flight a thread
constexpr int RPT_L2 = 2;          // lane, l2: rows in flight a thread
constexpr int TREE_LEVELS = 15;   // bsearch: tree levels at most
constexpr int TREE_INTS = 1 << TREE_LEVELS;  // bsearch: tree ints (128 KB)
constexpr int TREE_TOP = 12;       // bsearch: levels of the first copy (16 KB)
constexpr int NT_BS = 1024;        // bsearch: threads per block
constexpr int NT_TREE = 256;       // bsearch: threads per block, tree build
constexpr int BS_QUADS = 1;        // bsearch: quads a thread a round
constexpr int BS_QUADS_ONE = 2;    // bsearch, one-key buckets: the same
constexpr int LQ = 8;              // lane, staged: 16-byte quads a strip
constexpr int LT = 4 * LQ;         // lane, staged: lanes a strip
constexpr int LANE_SLOTS = NT / LQ;  // lane, staged: rows a block pass
constexpr int SPAN_STAGED = 384;   // lane: largest staged window (48 KB)
constexpr int MIN_CHUNK = 32;      // lane, staged: fewest rows a block
constexpr int L2_SLOTS = NT / 32;  // lane, l2: rows a block pass
constexpr int64_t MAX_ELEMS = 1 << 30;  // 32-bit offsets

enum Variant { kRows = 0, kBsearch = 1, kLane = 2 };

// ---- shared ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four lanes of an index row from p, `left` lanes of the row remaining
// (VEC: one 16-byte load; else lane by lane, 0 past the row).
template <bool VEC>
__device__ __forceinline__ int4 ld_quad(const int* p, int left) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(p));
  int4 v = make_int4(__ldg(p), 0, 0, 0);
  if (left > 1) v.y = __ldg(p + 1);
  if (left > 2) v.z = __ldg(p + 2);
  if (left > 3) v.w = __ldg(p + 3);
  return v;
}

// The matching store of four lanes.
template <bool VEC>
__device__ __forceinline__ void st_quad(uint32_t* p, uint4 v, int left) {
  if (VEC) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (left > 1) p[1] = v.y;
  if (left > 2) p[2] = v.z;
  if (left > 3) p[3] = v.w;
}

// The card's SM count, kept for the last device: the query costs more host
// time than a launch.
int sm_count() {
  static thread_local int last_dev = -1, sms = 132;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != last_dev) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    last_dev = dev;
  }
  return sms;
}

// ---- rows -----------------------------------------------------------------

// P pieces of type V a row (P a template constant): TPR neighbouring threads
// a row, RPT_ROWS rows in flight a thread, idx and out evict-first.
template <typename V, int P>
__global__ void __launch_bounds__(NT)
    gather_rows_kernel(const V* __restrict__ table,
                       const int* __restrict__ idx, V* __restrict__ out,
                       int n) {
  constexpr int TPR = P < 32 ? P : 32;  // threads a row
  constexpr int PPT = P / TPR;          // pieces a thread
  constexpr int SLOTS = NT / TPR;       // rows a block pass
  static_assert(P % TPR == 0 && 32 % TPR == 0, "pieces per row");
  const int tx = threadIdx.x % TPR;
  for (int r0 = blockIdx.x * SLOTS * RPT_ROWS + threadIdx.x / TPR; r0 < n;
       r0 += gridDim.x * SLOTS * RPT_ROWS) {
    int j[RPT_ROWS];
#pragma unroll
    for (int k = 0; k < RPT_ROWS; ++k) {
      const int r = r0 + k * SLOTS;
      j[k] = r < n ? __ldcs(idx + r) : 0;  // row 0: read, not stored
    }
    V v[RPT_ROWS][PPT];
#pragma unroll
    for (int k = 0; k < RPT_ROWS; ++k)
#pragma unroll
      for (int p = 0; p < PPT; ++p)
        v[k][p] = __ldg(table + j[k] * P + p * TPR + tx);
#pragma unroll
    for (int k = 0; k < RPT_ROWS; ++k) {
      const int r = r0 + k * SLOTS;
      if (r < n)
#pragma unroll
        for (int p = 0; p < PPT; ++p)
          __stcs(out + r * P + p * TPR + tx, v[k][p]);
    }
  }
}

// Any other piece count: a thread a piece of the flat output (total pieces).
template <typename V>
__global__ void __launch_bounds__(NT)
    gather_rows_any_kernel(const V* __restrict__ table,
                           const int* __restrict__ idx, V* __restrict__ out,
                           int total, int P) {
  for (int e = blockIdx.x * NT + threadIdx.x; e < total;
       e += gridDim.x * NT) {
    const int q = e / P;
    out[e] = table[__ldg(idx + q) * P + (e - q * P)];
  }
}

// ---- bsearch --------------------------------------------------------------

// The search's layout for T keys: buckets of 2^s keys (s the least that
// leaves at most TREE_INTS buckets), the first key of every bucket but the
// first a splitter, and the splitters in a tree of h levels (2^h - 1 nodes,
// 2^h >= buckets). Mirrored by micro_kernels.lower_bound_layout.
struct BsLayout {
  int s, h;
};

inline int bit_length(unsigned x) { return x ? 32 - __builtin_clz(x) : 0; }

inline BsLayout bs_layout(int T) {
  const int over = bit_length((unsigned)(T - 1)) - TREE_LEVELS;
  const int s = over > 0 ? over : 0;
  return {s, bit_length((unsigned)((T - 1) >> s))};
}

// Node i of the tree in BFS order from 1 (children 2i and 2i + 1; node 0
// holds keys[0]): the splitter of in-order rank r = (2 (i - 2^d) + 1)
// 2^(h-1-d) at depth d, keys[r 2^s], or INT_MAX past the last bucket.
__device__ __forceinline__ int tree_node(const int* __restrict__ keys, int i,
                                         int T, int h, int s) {
  if (i == 0) return keys[0];
  const int d = 31 - __clz(i);
  const int64_t k = (int64_t)(2 * (i - (1 << d)) + 1) << (h - 1 - d + s);
  return k < T ? keys[k] : INT_MAX;
}

// The BFS slot of in-order rank r >= 1 (the inverse of tree_node's rank).
__device__ __forceinline__ int tree_slot(int r, int h) {
  const int t = __ffs(r) - 1;
  return (1 << (h - 1 - t)) + (r >> (t + 1));
}

// A key at or past T reads as +infinity.
__device__ __forceinline__ int key_at(const int* __restrict__ keys, int i,
                                      int T) {
  return i < T ? __ldg(keys + i) : INT_MAX;
}

// The tree of a call whose buckets hold more than one key, built once into
// the wrapper's scratch (2^h ints) for every block to copy.
__global__ void __launch_bounds__(NT_TREE)
    tree_build_kernel(const int* __restrict__ keys, int* __restrict__ tree,
                      int T, int h, int s) {
  const int i = blockIdx.x * NT_TREE + threadIdx.x;
  if (i < (1 << h)) tree[i] = tree_node(keys, i, T, h, s);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

// Waits until the barrier's phase 0 has completed; a copy that has not
// landed after ~10 s traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1LL << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Four adjacent queries from q[i, i + 4) (INT_MAX past n): one evict-first
// 16-byte load where VQ (q 16-byte aligned) and all four exist.
template <bool VQ>
__device__ __forceinline__ int4 load_quad(const int* __restrict__ q,
                                          int64_t i, int64_t n) {
  if (VQ && i + 4 <= n) return __ldcs(reinterpret_cast<const int4*>(q + i));
  return make_int4(__ldcs(q + i), i + 1 < n ? __ldcs(q + i + 1) : INT_MAX,
                   i + 2 < n ? __ldcs(q + i + 2) : INT_MAX,
                   i + 3 < n ? __ldcs(q + i + 3) : INT_MAX);
}

template <bool VQ>
__device__ __forceinline__ void store_quad(int* __restrict__ out, int64_t i,
                                           int64_t n, int4 v) {
  if (VQ && i + 4 <= n) {
    __stcs(reinterpret_cast<int4*>(out + i), v);
    return;
  }
  __stcs(out + i, v.x);
  if (i + 1 < n) __stcs(out + i + 1, v.y);
  if (i + 2 < n) __stcs(out + i + 2, v.z);
  if (i + 3 < n) __stcs(out + i + 3, v.w);
}

// What finishes a search after the tree: kTailNone, buckets of one key (the
// answer follows from the tree and keys[0]); kTailVec, buckets of 2^s >= 8
// keys, 16-byte aligned: halvings down to a group of 8, read as two
// 16-byte loads (one 32-byte sector; read key by key, T2's search took 2.15x
// the device time, PERF.md); kTailScalar, any other bucket, the group of
// min(2^s, 8) keys read key by key.
enum Tail { kTailNone = 0, kTailVec = 1, kTailScalar = 2 };

// `levels` branchless steps i = 2i + (tree[i] < v) of QUADS quads of
// queries, on byte offsets (off = 4i: the load takes the offset as it is).
template <int QUADS>
__device__ __forceinline__ void descend(const char* tree, int (&off)[QUADS][4],
                                        const int4 (&v)[QUADS], int levels) {
  for (int l = 0; l < levels; ++l)
#pragma unroll
    for (int k = 0; k < QUADS; ++k) {
      const int nv[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        off[k][j] = 2 * off[k][j] +
                    (*reinterpret_cast<const int*>(tree + off[k][j]) < nv[j]
                         ? 4
                         : 0);
    }
}

// A thread takes QUADS quads of adjacent queries a round (quads of a round
// a grid apart). Every block first gets the tree into shared memory: built
// from keys[0, 2^h) when buckets hold one key (contiguous: 4 bytes read per
// node), else two bulk copies of the tree built for the call, its top
// TREE_TOP levels (16 KB) first, so that the first round's descent starts
// while the other 112 KB land. The first round's queries are in flight
// meanwhile. Then per query h branchless steps i = 2i + (tree[i] < v) from
// i = 1: the top 5 levels are one 128-byte row, so a warp's first loads are
// broadcasts; i - 2^h is the number of splitters below v, so the answer
// lies in bucket i - 2^h, which the tail finishes.
template <int TAIL, bool VQ>
__global__ void __launch_bounds__(NT_BS, 1)
    lower_bound_kernel(const int* __restrict__ keys,
                       const int* __restrict__ built,
                       const int* __restrict__ q, int* __restrict__ out,
                       int T, int64_t n, int h, int s) {
  constexpr int QUADS = TAIL == kTailNone ? BS_QUADS_ONE : BS_QUADS;
  extern __shared__ __align__(16) int tree[];  // 2^h ints
  __shared__ __align__(8) uint64_t bar[2];  // the tree's two copies
  const int nodes = 1 << h;
  const int64_t stride = (int64_t)gridDim.x * NT_BS * 4;  // queries
  int64_t i0 = ((int64_t)blockIdx.x * NT_BS + threadIdx.x) * 4;
  const uint32_t bar_top = smem_u32(&bar[0]), bar_rest = smem_u32(&bar[1]);
  if (TAIL != kTailNone && threadIdx.x == 0) {  // h = TREE_LEVELS here
    constexpr int top = 4 << TREE_TOP;  // bytes
    mbar_init(bar_top, 1);
    mbar_init(bar_rest, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load(smem_u32(tree), built, top, bar_top);
    bulk_load(smem_u32(tree) + top, built + top / 4, nodes * 4 - top,
              bar_rest);
  }
  int4 v[QUADS];
#pragma unroll
  for (int k = 0; k < QUADS; ++k)
    v[k] = i0 + k * stride < n ? load_quad<VQ>(q, i0 + k * stride, n)
                               : make_int4(0, 0, 0, 0);
  if (TAIL == kTailNone) {
    for (int r = threadIdx.x; r < nodes; r += NT_BS)
      tree[r ? tree_slot(r, h) : 0] = r < T ? keys[r] : INT_MAX;
    __syncthreads();
  } else {
    __syncthreads();  // the barriers are initialised
    mbar_wait0(bar_top);
  }
  const int key0 = tree[0];
  for (; i0 < n; i0 += QUADS * stride) {
    int node[QUADS][4];  // byte offsets in the descent, then nodes
#pragma unroll
    for (int k = 0; k < QUADS; ++k)
      node[k][0] = node[k][1] = node[k][2] = node[k][3] = 4;
    const char* tb = reinterpret_cast<const char*>(tree);
    if (TAIL == kTailNone) {
      descend<QUADS>(tb, node, v, h);
    } else {  // the rest may still be landing in the first round
      descend<QUADS>(tb, node, v, TREE_TOP);
      mbar_wait0(bar_rest);
      descend<QUADS>(tb, node, v, h - TREE_TOP);
    }
#pragma unroll
    for (int k = 0; k < QUADS; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) node[k][j] >>= 2;
#pragma unroll
    for (int k = 0; k < QUADS; ++k) {
      const int64_t i = i0 + k * stride;
      const int nv[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      int ans[4];
      if (TAIL == kTailNone) {  // bucket c is keys[c]; keys[c] < v for c > 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = node[k][j] - nodes;
          ans[j] = c + (c > 0 || key0 < nv[j]);
        }
      } else {
        int pos[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) pos[j] = (node[k][j] - nodes) << s;
        for (int half = 1 << (s - 1); half >= 8; half >>= 1)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pos[j] += key_at(keys, pos[j] + half - 1, T) < nv[j] ? half : 0;
        if (TAIL == kTailVec) {  // the group of 8 at pos[j]: one sector
          int4 g[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (pos[j] + 8 <= T) {
              const int4* p = reinterpret_cast<const int4*>(keys + pos[j]);
              g[j][0] = __ldg(p);
              g[j][1] = __ldg(p + 1);
            } else {  // the last bucket, cut by T
              g[j][0] = make_int4(
                  key_at(keys, pos[j], T), key_at(keys, pos[j] + 1, T),
                  key_at(keys, pos[j] + 2, T), key_at(keys, pos[j] + 3, T));
              g[j][1] = make_int4(
                  key_at(keys, pos[j] + 4, T), key_at(keys, pos[j] + 5, T),
                  key_at(keys, pos[j] + 6, T), key_at(keys, pos[j] + 7, T));
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ans[j] = pos[j] + (g[j][0].x < nv[j]) + (g[j][0].y < nv[j]) +
                     (g[j][0].z < nv[j]) + (g[j][0].w < nv[j]) +
                     (g[j][1].x < nv[j]) + (g[j][1].y < nv[j]) +
                     (g[j][1].z < nv[j]) + (g[j][1].w < nv[j]);
        } else {
          const int group = min(1 << s, 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ans[j] = pos[j];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (e < group) ans[j] += key_at(keys, pos[j] + e, T) < nv[j];
          }
        }
      }
      if (i < n)
        store_quad<VQ>(out, i, n, make_int4(ans[0], ans[1], ans[2], ans[3]));
      const int64_t inext = i + QUADS * stride;
      if (inext < n) v[k] = load_quad<VQ>(q, inext, n);
    }
  }
}

// ---- lane -----------------------------------------------------------------

// Block (window, 32-lane strip, chunk of the window's rows), chunks of one
// strip adjacent: stage the strip's span rows, gather RPT passes of
// LANE_SLOTS rows from shared memory.
template <bool VEC>
__global__ void __launch_bounds__(NT)
    lane_staged_kernel(const uint32_t* __restrict__ op,
                       const int* __restrict__ idx, uint32_t* __restrict__ out,
                       int rows, int L, int S, int stride, int span,
                       int strips, int chunks, int chunk) {
  extern __shared__ uint4 win4[];  // (span, LT) words
  const uint32_t* win = reinterpret_cast<const uint32_t*>(win4);
  const int c = blockIdx.x % chunks, pair = blockIdx.x / chunks;
  const int s = pair % strips, b = pair / strips;
  const int r0 = b * S + c * chunk;  // this block's rows: [r0, r1)
  const int r1 = min(min(r0 + chunk, b * S + S), rows);
  if (r0 >= r1) return;  // the last window's tail: the whole block leaves
  const int l0 = s * LT, nl = min(LT, L - l0);  // the strip's lanes
  const uint32_t* src = op + b * stride * L + l0;
  if (VEC) {  // nl % 4 == 0
    for (int e = threadIdx.x; e < span * LQ; e += NT) {
      const int q = e % LQ;
      if (4 * q < nl) cp_async16(win4 + e, src + (e / LQ) * L + 4 * q);
    }
  } else {
    uint32_t* w = reinterpret_cast<uint32_t*>(win4);
    for (int e = threadIdx.x; e < span * LT; e += NT) {
      const int x = e % LT;
      if (x < nl) w[e] = __ldg(src + (e / LT) * L + x);
    }
  }
  const int lx = 4 * (threadIdx.x % LQ), left = nl - lx;
  const int ty = threadIdx.x / LQ;
  const int* ip = idx + l0 + lx;
  uint32_t* outp = out + l0 + lx;
  bool staged = false;
  for (int rb = r0; rb < r1; rb += LANE_SLOTS * RPT) {  // block-uniform
    int4 j[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = rb + ty + k * LANE_SLOTS;
      j[k] = r < r1 && left > 0 ? ld_quad<VEC>(ip + r * L, left)
                                : make_int4(0, 0, 0, 0);
    }
    if (!staged) {  // the first indices are in flight: wait for the window
      if (VEC) cp_async_wait_all();
      __syncthreads();
      staged = true;
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = rb + ty + k * LANE_SLOTS;
      if (r < r1 && left > 0)
        st_quad<VEC>(
            outp + r * L,
            make_uint4(win[j[k].x * LT + lx], win[j[k].y * LT + lx + 1],
                       win[j[k].z * LT + lx + 2], win[j[k].w * LT + lx + 3]),
            left);
    }
  }
}

// Block (RPT_L2 x L2_SLOTS rows, 128-lane strip blockIdx.y): a warp a row's
// strip, op read from L2.
template <bool VEC>
__global__ void __launch_bounds__(NT)
    lane_l2_kernel(const uint32_t* __restrict__ op,
                   const int* __restrict__ idx, uint32_t* __restrict__ out,
                   int rows, int L, int S, int stride) {
  const int l = blockIdx.y * 128 + 4 * (threadIdx.x % 32), left = L - l;
  if (left <= 0) return;
  const int rb = blockIdx.x * L2_SLOTS * RPT_L2 + threadIdx.x / 32;
  const uint32_t* col = op + l;
  int4 j[RPT_L2];
#pragma unroll
  for (int k = 0; k < RPT_L2; ++k) {
    const int r = rb + k * L2_SLOTS;
    if (r < rows) {
      j[k] = ld_quad<VEC>(idx + r * L + l, left);
      const int base = (r / S) * stride;  // once a row
      j[k].x += base, j[k].y += base, j[k].z += base, j[k].w += base;
    } else {
      j[k] = make_int4(0, 0, 0, 0);
    }
  }
  uint4 v[RPT_L2];
#pragma unroll
  for (int k = 0; k < RPT_L2; ++k) {
    v[k].x = __ldg(col + j[k].x * L);
    v[k].y = VEC || left > 1 ? __ldg(col + j[k].y * L + 1) : 0;
    v[k].z = VEC || left > 2 ? __ldg(col + j[k].z * L + 2) : 0;
    v[k].w = VEC || left > 3 ? __ldg(col + j[k].w * L + 3) : 0;
  }
#pragma unroll
  for (int k = 0; k < RPT_L2; ++k) {
    const int r = rb + k * L2_SLOTS;
    if (r < rows) st_quad<VEC>(out + r * L + l, v[k], left);
  }
}

// ---- launches -------------------------------------------------------------

unsigned grid_for(int64_t tiles, int per_sm) {
  const int64_t cap = (int64_t)sm_count() * per_sm;
  return (unsigned)(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
}

template <typename V>
void launch_rows(const void* table, const int* idx, void* out, int n,
                 int width, cudaStream_t st) {
  const int P = width * 4 / (int)sizeof(V);
  const V* t = (const V*)table;
  V* o = (V*)out;
  constexpr int SLOTS2 = NT / 2 * RPT_ROWS, SLOTS32 = NT / 32 * RPT_ROWS;
  if constexpr (sizeof(V) == 16) {
    if (P == 2) {  // 8 floats
      gather_rows_kernel<V, 2>
          <<<grid_for((n + SLOTS2 - 1) / SLOTS2, ROWS_PER_SM), NT, 0, st>>>(
              t, idx, o, n);
      return;
    }
    if (P == 32) {  // 128 floats
      gather_rows_kernel<V, 32>
          <<<grid_for((n + SLOTS32 - 1) / SLOTS32, ROWS_PER_SM), NT, 0, st>>>(
              t, idx, o, n);
      return;
    }
  }
  gather_rows_any_kernel<V>
      <<<grid_for(((int64_t)n * P + NT - 1) / NT, ANY_PER_SM), NT, 0, st>>>(
          t, idx, o, n * P, P);
}

// Staged windows up to SPAN_STAGED rows, else op from L2.
int launch_lane(const uint32_t* op, const int* idx, uint32_t* out, int n,
                int src_rows, int L, int S, int stride, bool vec,
                cudaStream_t st) {
  const int span = stride > 0 ? stride : src_rows;
  if (span > SPAN_STAGED) {
    if ((L + 127) / 128 > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(
        (unsigned)((n + L2_SLOTS * RPT_L2 - 1) / (L2_SLOTS * RPT_L2)),
        (unsigned)((L + 127) / 128));
    if (vec)
      lane_l2_kernel<true><<<grid, NT, 0, st>>>(op, idx, out, n, L, S, stride);
    else
      lane_l2_kernel<false><<<grid, NT, 0, st>>>(op, idx, out, n, L, S,
                                                 stride);
    return (int)cudaSuccess;
  }
  const int nb = (n - 1) / S + 1;  // windows
  const int Sw = S < n ? S : n;    // rows of a full window
  const int strips = (L + LT - 1) / LT;
  const int64_t pairs = (int64_t)nb * strips;
  // towards 2 blocks per SM, chunks of at least MIN_CHUNK rows
  const int most = (Sw + MIN_CHUNK - 1) / MIN_CHUNK;
  int chunks = (int)((2 * sm_count() + pairs - 1) / pairs);
  chunks = chunks < most ? chunks : most;
  const int chunk = (Sw + chunks - 1) / chunks;
  chunks = (Sw + chunk - 1) / chunk;
  if (pairs * chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)span * LT * sizeof(uint32_t);
  if (vec)
    lane_staged_kernel<true><<<(unsigned)(pairs * chunks), NT, smem, st>>>(
        op, idx, out, n, L, S, stride, span, strips, chunks, chunk);
  else
    lane_staged_kernel<false><<<(unsigned)(pairs * chunks), NT, smem, st>>>(
        op, idx, out, n, L, S, stride, span, strips, chunks, chunk);
  return (int)cudaSuccess;
}

// Build the tree once where buckets hold more than one key, then one wave
// of blocks (as many as fit on the card, fewer when the queries give each
// thread less than a quad). The attribute and occupancy queries are made
// once per device and kernel: they cost more host time than the launch.
template <int TAIL, bool VQ>
int launch_search(const int* keys, const int* q, int* out, int* scratch,
                  int T, int64_t n, BsLayout L, cudaStream_t st) {
  auto kern = lower_bound_kernel<TAIL, VQ>;
  static thread_local int last_dev = -1, per_sm[TREE_LEVELS + 1];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != last_dev) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         TREE_INTS * (int)sizeof(int));
    for (int h = 0; h <= TREE_LEVELS; ++h)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[h], kern, NT_BS, (size_t)sizeof(int) << h);
    last_dev = dev;
  }
  const size_t smem = (size_t)sizeof(int) << L.h;
  if (TAIL != kTailNone) {  // s > 0: the tree has TREE_LEVELS levels
    if (!scratch || L.h != TREE_LEVELS) return (int)cudaErrorInvalidValue;
    tree_build_kernel<<<((1 << L.h) + NT_TREE - 1) / NT_TREE, NT_TREE, 0,
                        st>>>(keys, scratch, T, L.h, L.s);
  }
  const int64_t quads = (n + 3) / 4;
  const int64_t need = (quads + NT_BS - 1) / NT_BS;
  const int64_t cap =
      (int64_t)sm_count() * (per_sm[L.h] > 1 ? per_sm[L.h] : 1);
  kern<<<(unsigned)(need < cap ? need : cap), NT_BS, smem, st>>>(
      keys, scratch, q, out, T, n, L.h, L.s);
  return (int)cudaSuccess;
}

int launch_bsearch(const int* keys, const int* q, int* out, int* scratch,
                   int T, int64_t n, cudaStream_t st) {
  const BsLayout L = bs_layout(T);
  const bool vq = ((uintptr_t)q | (uintptr_t)out) % 16 == 0;
  const int tail = L.s == 0                                  ? kTailNone
                   : L.s >= 3 && (uintptr_t)keys % 16 == 0 ? kTailVec
                                                             : kTailScalar;
  auto go = [&](auto launch) {
    return launch(keys, q, out, scratch, T, n, L, st);
  };
  switch (tail * 2 + vq) {
    case 0: return go(launch_search<kTailNone, false>);
    case 1: return go(launch_search<kTailNone, true>);
    case 2: return go(launch_search<kTailVec, false>);
    case 3: return go(launch_search<kTailVec, true>);
    case 4: return go(launch_search<kTailScalar, false>);
    default: return go(launch_search<kTailScalar, true>);
  }
}

}  // namespace insmos_micro_gather

// One entry for the three kernels (variant 0 rows, 1 bsearch, 2 lane), 4-byte
// elements throughout:
//   rows     src table (src_rows, width), idx (n,), out (n, width)
//   bsearch  src sorted keys (src_rows,), idx queries (n,), out (n,) int32;
//            width 1; scratch 2^h ints for the tree (bs_layout), where
//            buckets hold more than one key
//   lane     src op (src_rows, width), idx (n, width) with values in
//            [0, stride) (or [0, src_rows) when stride is 0), out (n, width);
//            windows of S rows of idx, window b at op row b * stride
// n >= 1, src_rows >= 1, width >= 1; the pointers are 4-byte aligned, the
// scratch 16-byte aligned; rows and lane: n * width and src_rows * width at
// most 2^30, no scratch.
extern "C" int micro_gather(const void* src, const void* idx, void* out,
                            void* scratch, long long n, long long src_rows,
                            int width, int S, long long stride, int variant,
                            void* stream) {
  using namespace insmos_micro_gather;
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || src_rows < 1 || width < 1) return (int)cudaErrorInvalidValue;
  const int* pi = (const int*)idx;
  if (variant != kBsearch &&
      (n * width > MAX_ELEMS || src_rows * width > MAX_ELEMS))
    return (int)cudaErrorInvalidValue;
  const uintptr_t al = (uintptr_t)src | (uintptr_t)out;
  if (variant == kRows) {
    if (width % 4 == 0 && al % 16 == 0) {
      launch_rows<uint4>(src, pi, out, (int)n, width, st);
    } else if (width % 2 == 0 && al % 8 == 0) {
      launch_rows<uint2>(src, pi, out, (int)n, width, st);
    } else {
      launch_rows<uint32_t>(src, pi, out, (int)n, width, st);
    }
  } else if (variant == kBsearch) {
    if (width != 1 || src_rows > (1 << 30)) return (int)cudaErrorInvalidValue;
    const int err = launch_bsearch((const int*)src, pi, (int*)out,
                                   (int*)scratch, (int)src_rows, n, st);
    if (err) return err;
  } else if (variant == kLane) {
    if (S < 1 || stride < 0) return (int)cudaErrorInvalidValue;
    const int64_t nb = (n + S - 1) / S;  // windows
    if (stride > 0 && nb * stride > src_rows) return (int)cudaErrorInvalidValue;
    const bool vec = width % 4 == 0 && (al | (uintptr_t)idx) % 16 == 0;
    const int err = launch_lane((const uint32_t*)src, pi, (uint32_t*)out,
                                (int)n, (int)src_rows, width, S, (int)stride,
                                vec, st);
    if (err) return err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
