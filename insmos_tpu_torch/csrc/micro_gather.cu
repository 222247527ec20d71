// Gather and search micro-probe kernels for NVIDIA Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU probes tools/micro_pallas.py (T1 pallas_gather,
// T2 pallas_bsearch, T3 pallas_rowg), tools/micro_pallas2.py (T4 rows,
// T5 tala, T6 bs), tools/micro_lanegather.py (T7 lane_gather),
// tools/micro_lanegather2.py (T8 try_case.f) and tools/probe_tala.py (T9).
// The nine TPU bodies are three operations in different layouts, each with
// its table whole in VMEM; here they are three kernels on 4-byte elements
// (float32 or int32, copied bit for bit):
//   rows     out[q, :] = table[idx[q], :] at any row width. One thread per
//            16-, 8- or 4-byte piece of an output row (the widest that
//            divides the row and the pointers). The tables (1-8 MB) do not
//            fit shared memory (228 KB per SM) but stay in the 50 MB L2.
//            Bound by memory: a random table read per piece, one index read
//            per row, a coalesced write.
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
//            0 (one window over the whole table). A block of 256 threads
//            covers 32 lanes. When a window of span rows x 32 lanes fits in
//            48 KB of shared memory (span <= 384, so every block-local case)
//            the block is one window of S rows: it stages the window, 128
//            bytes of a row at a time, and each output reads its element
//            there without bank conflicts (lane l is bank l % 32). Otherwise
//            (a 4 MB table) each output reads op from L2. Bound by memory.
// Offsets are 64-bit (the largest arrays hold 134M elements). Indices are
// not clamped: the callers check them once, on the host.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace insmos_micro_gather {

constexpr int NT = 256;            // rows, lane: threads per block
constexpr int SAMPLE_MAX = 32768;  // bsearch: keys staged per block (128 KB)
constexpr int QPT = 8;             // bsearch: queries in flight per thread
constexpr int NT_BS = 1024;        // bsearch: threads per block
constexpr int LT = 32;             // lane: lanes per block
constexpr int LANE_RT = NT / LT;   // lane: rows in flight per block
constexpr int SPAN_STAGED = 384;   // lane: largest staged window (48 KB)
constexpr int LANE_ROWS = 64;      // lane: rows per block from L2

enum Variant { kRows = 0, kBsearch = 1, kLane = 2 };

template <typename V>
__global__ void __launch_bounds__(NT)
    gather_rows_kernel(const V* __restrict__ table,
                       const int* __restrict__ idx, V* __restrict__ out,
                       int64_t n, int wv) {
  for (int64_t e = (int64_t)blockIdx.x * NT + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * NT) {
    const int64_t q = e / wv;
    const int c = (int)(e - q * wv);
    out[e] = table[(int64_t)__ldg(idx + q) * wv + c];
  }
}

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

template <bool STAGED>
__global__ void __launch_bounds__(NT)
    lane_gather_kernel(const uint32_t* __restrict__ op,
                       const int* __restrict__ idx, uint32_t* __restrict__ out,
                       int64_t rows, int L, int S, int64_t stride, int span,
                       int rows_per_block) {
  extern __shared__ uint32_t win[];  // (span, LT), staged windows only
  const int tx = threadIdx.x % LT, ty = threadIdx.x / LT;
  const int l = blockIdx.y * LT + tx;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 =
      r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  if (STAGED) {  // rows_per_block == S: this block is window blockIdx.x
    const uint32_t* src = op + (int64_t)blockIdx.x * stride * L;
    if (l < L)
      for (int r = ty; r < span; r += LANE_RT)
        win[r * LT + tx] = src[(int64_t)r * L + l];
    __syncthreads();
  }
  if (l >= L) return;
  for (int64_t i = r0 + ty; i < r1; i += LANE_RT) {
    const int j = idx[i * L + l];
    out[i * L + l] = STAGED ? win[j * LT + tx]
                            : __ldg(op + ((i / S) * stride + j) * L + l);
  }
}

int grid_cap(int per_sm) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (sms > 0 ? sms : 132) * per_sm;
}

unsigned blocks_for(int64_t n, int cap) {
  const int64_t b = (n + NT - 1) / NT;
  return (unsigned)(b < cap ? b : cap);
}

template <typename V>
void launch_rows(const void* table, const int* idx, void* out, int64_t n,
                 int width, cudaStream_t st) {
  const int wv = width * 4 / (int)sizeof(V);
  const int64_t total = n * wv;
  gather_rows_kernel<V><<<blocks_for(total, grid_cap(32)), NT, 0, st>>>(
      (const V*)table, idx, (V*)out, total, wv);
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
// n >= 1, src_rows >= 1, width >= 1; the pointers are 4-byte aligned.
extern "C" int micro_gather(const void* src, const void* idx, void* out,
                            long long n, long long src_rows, int width,
                            int S, long long stride, int variant,
                            void* stream) {
  using namespace insmos_micro_gather;
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 1 || src_rows < 1 || width < 1) return (int)cudaErrorInvalidValue;
  const int* pi = (const int*)idx;
  if (variant == kRows) {
    const uintptr_t al = (uintptr_t)src | (uintptr_t)out;
    if (width % 4 == 0 && al % 16 == 0)
      launch_rows<uint4>(src, pi, out, n, width, st);
    else if (width % 2 == 0 && al % 8 == 0)
      launch_rows<uint2>(src, pi, out, n, width, st);
    else
      launch_rows<uint32_t>(src, pi, out, n, width, st);
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
      last_dev = dev, last_ns = ns, last_cap = grid_cap(per_sm);
    }
    const int64_t need = (n + (int64_t)QPT * NT_BS - 1) / (QPT * NT_BS);
    lower_bound_kernel<<<(unsigned)(need < last_cap ? need : last_cap), NT_BS,
                         smem, st>>>((const int*)src, pi, (int*)out, T, n,
                                     step, ns);
  } else if (variant == kLane) {
    if (S < 1 || stride < 0) return (int)cudaErrorInvalidValue;
    const int64_t nb = (n + S - 1) / S;  // windows
    const int64_t span = stride > 0 ? stride : src_rows;
    if (stride > 0 && nb * stride > src_rows) return (int)cudaErrorInvalidValue;
    const unsigned lane_blocks = (unsigned)((width + LT - 1) / LT);
    const uint32_t* po = (const uint32_t*)src;
    if (span <= SPAN_STAGED) {
      const dim3 grid((unsigned)nb, lane_blocks);
      lane_gather_kernel<true><<<grid, NT, span * LT * sizeof(uint32_t),
                                 st>>>(
          po, pi, (uint32_t*)out, n, width, S, stride, (int)span, S);
    } else {
      const dim3 grid((unsigned)((n + LANE_ROWS - 1) / LANE_ROWS),
                      lane_blocks);
      lane_gather_kernel<false><<<grid, NT, 0, st>>>(
          po, pi, (uint32_t*)out, n, width, S, stride, (int)span, LANE_ROWS);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
