// Native host-side data loader (the port's copy of the JAX package's
// insmos_tpu/native/loader.cpp, same C interface).
//
// The loader's hot loop (.bin scan read, 4x4 pose alignment,
// fixed-capacity padding, and whole-window assembly across threads) in
// plain C++ behind a C ABI for ctypes. (The reference's range_mask_xy has
// no caller and is not copied.)
//
// Build: insmos_tpu_torch/native/__init__.py runs g++ -O3 -shared
// -ffp-contract=off at first use (no external deps). Without contraction
// each transformed coordinate is ((r0*x + r1*y) + r2*z) + t, every product
// and sum rounded to float32, which the binding's numpy route repeats.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Read a KITTI .bin scan (float32 x,y,z,r rows) into out[cap*4].
// Applies the row-major 4x4 transform tf to xyz. Zero-pads beyond n.
// Returns the number of valid points written (<= cap), or -1 on IO error.
int load_scan_transformed(const char* path, const float* tf, float* out,
                          int cap) {
  FILE* fh = std::fopen(path, "rb");
  if (!fh) return -1;
  std::fseek(fh, 0, SEEK_END);
  long bytes = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  long n_total = bytes / (4 * sizeof(float));
  long n = n_total < cap ? n_total : cap;

  std::vector<float> buf(static_cast<size_t>(n) * 4);
  size_t got = std::fread(buf.data(), sizeof(float) * 4, n, fh);
  std::fclose(fh);
  if (static_cast<long>(got) != n) return -1;

  const float r00 = tf[0], r01 = tf[1], r02 = tf[2], t0 = tf[3];
  const float r10 = tf[4], r11 = tf[5], r12 = tf[6], t1 = tf[7];
  const float r20 = tf[8], r21 = tf[9], r22 = tf[10], t2 = tf[11];
  for (long i = 0; i < n; ++i) {
    const float x = buf[i * 4 + 0], y = buf[i * 4 + 1], z = buf[i * 4 + 2];
    out[i * 4 + 0] = r00 * x + r01 * y + r02 * z + t0;
    out[i * 4 + 1] = r10 * x + r11 * y + r12 * z + t1;
    out[i * 4 + 2] = r20 * x + r21 * y + r22 * z + t2;
    out[i * 4 + 3] = buf[i * 4 + 3];
  }
  std::memset(out + n * 4, 0, sizeof(float) * 4 * (cap - n));
  return static_cast<int>(n);
}

// Assemble a whole scan window in parallel: for each of n_scans slots read
// paths[i], transform by tfs[i*16..], write into out[i*cap*4..]; counts[i]
// receives the valid point count. Threads = min(n_scans, hw concurrency).
void load_window(const char** paths, int n_scans, const float* tfs, float* out,
                 int* counts, int cap) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  const int n_threads = n_scans < hw ? n_scans : hw;
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n_scans) return;
      counts[i] = load_scan_transformed(
          paths[i], tfs + static_cast<size_t>(i) * 16,
          out + static_cast<size_t>(i) * cap * 4, cap);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

}  // extern "C"
