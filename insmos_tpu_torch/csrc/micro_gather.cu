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
//            first index with keys[index] >= q[i], T if none). One wave of
//            1024-thread blocks; each stages every step-th key (at most
//            SAMPLE_MAX, 128 KB) in shared memory once, searches that sample
//            first and finishes inside the bracket of `step` keys, one sector
//            of global memory (L2) at T = 262,144: 16 of its 20 loads come
//            from shared memory, 3 from L1, 1 from L2 (8,192 keys: all 14
//            from shared memory). Bound by L2 sectors and the latency of
//            dependent loads: a random 4-byte read costs a 32-byte sector,
//            so the sample is as fine as shared memory allows, and the
//            searches are branchless, the same steps for every query, so
//            each thread runs QPT of them in lockstep; the sample's layout is
//            swizzled against bank conflicts. A lower bound has T + 1
//            answers and needs ceil(log2(T + 1)) halvings; the TPU bodies
//            ran ceil(log2 T) and so return 0 for keys[0] < q <= keys[1].
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
//   lane_l2_kernel 26-28, lower_bound_kernel 54.
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
constexpr int SAMPLE_MAX = 32768;  // bsearch: keys staged per block (128 KB)
constexpr int QPT = 8;             // bsearch: queries in flight per thread
constexpr int NT_BS = 1024;        // bsearch: threads per block
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

// The sample's place in shared memory: its low 5 bits XOR-ed with the two
// 5-bit groups above them (a permutation inside each 32-word row). Binary
// search probes indices a + 2^j with a a multiple of 2^(j+1), which would
// all fall in one bank; the folded bits spread them over the banks.
__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 5) ^ (i >> 10)) & 31);
}

// A key at or past T reads as +infinity.
__device__ __forceinline__ int key_at(const int* __restrict__ keys, int i,
                                      int T) {
  return i < T ? __ldg(keys + i) : INT_MAX;
}

__global__ void __launch_bounds__(NT_BS)
    lower_bound_kernel(const int* __restrict__ keys,
                       const int* __restrict__ q, int* __restrict__ out, int T,
                       int64_t n, int step, int ns) {
  extern __shared__ int sample[];  // ns <= SAMPLE_MAX keys
  for (int j = threadIdx.x; j < ns; j += NT_BS)
    sample[swz(j)] = keys[(int64_t)j * step];
  __syncthreads();
  const int64_t threads = (int64_t)gridDim.x * NT_BS;
  for (int64_t i0 = (int64_t)blockIdx.x * NT_BS + threadIdx.x; i0 < n;
       i0 += threads * QPT) {
    int v[QPT], a[QPT];
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      v[k] = i0 + k * threads < n ? q[i0 + k * threads] : INT_MAX;
      a[k] = 0;
    }
    // Branchless lower bounds (the same steps for every query, so QPT
    // searches run in lockstep, each load independent of the others'):
    // first the number of samples below v, in [0, ns] ...
    for (int m = ns; m > 1; m -= m >> 1) {
      const int half = m >> 1;
#pragma unroll
      for (int k = 0; k < QPT; ++k)
        a[k] += sample[swz(a[k] + half)] < v[k] ? half : 0;
    }
    bool live[QPT];
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const int lo = a[k] + (sample[swz(a[k])] < v[k]);
      // ... then keys[(lo - 1) * step] < v <= keys[lo * step], so the
      // answer lies in [a, a + step - 1]: a branchless search of the
      // step - 1 keys from a (lo == 0: the answer is 0)
      live[k] = lo > 0;
      a[k] = live[k] ? (lo - 1) * step + 1 : 0;
    }
    for (int m = step - 1; m > 1; m -= m >> 1) {
      const int half = m >> 1;
#pragma unroll
      for (int k = 0; k < QPT; ++k)
        a[k] += key_at(keys, a[k] + half, T) < v[k] ? half : 0;
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      if (step > 1) a[k] += key_at(keys, a[k], T) < v[k];
      if (i0 + k * threads < n) out[i0 + k * threads] = live[k] ? a[k] : 0;
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

}  // namespace insmos_micro_gather

// One entry for the three kernels (variant 0 rows, 1 bsearch, 2 lane), 4-byte
// elements throughout:
//   rows     src table (src_rows, width), idx (n,), out (n, width)
//   bsearch  src sorted keys (src_rows,), idx queries (n,), out (n,) int32;
//            width 1
//   lane     src op (src_rows, width), idx (n, width) with values in
//            [0, stride) (or [0, src_rows) when stride is 0), out (n, width);
//            windows of S rows of idx, window b at op row b * stride
// n >= 1, src_rows >= 1, width >= 1; the pointers are 4-byte aligned; rows
// and lane: n * width and src_rows * width at most 2^30.
extern "C" int micro_gather(const void* src, const void* idx, void* out,
                            long long n, long long src_rows, int width,
                            int S, long long stride, int variant,
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
    const int T = (int)src_rows;
    const int step = (T + SAMPLE_MAX - 1) / SAMPLE_MAX;
    const int ns = (T + step - 1) / step;
    // one wave of blocks (each stages the sample once), its size kept for
    // the last device and sample size: the attribute and occupancy queries
    // cost more host time than the launch
    static thread_local int last_dev = -1, last_ns = -1, last_cap = 0;
    const size_t smem = (size_t)ns * sizeof(int);
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev != last_dev || ns != last_ns) {
      cudaFuncSetAttribute(lower_bound_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SAMPLE_MAX * (int)sizeof(int));
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lower_bound_kernel, NT_BS, smem);
      last_dev = dev, last_ns = ns, last_cap = sm_count() * per_sm;
    }
    const int64_t need = (n + (int64_t)QPT * NT_BS - 1) / (QPT * NT_BS);
    lower_bound_kernel<<<(unsigned)(need < last_cap ? need : last_cap), NT_BS,
                         smem, st>>>((const int*)src, pi, (int*)out, T, n,
                                     step, ns);
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
