// Native host-side runtime for octane_tpu.
//
// The accelerator owns the compute path (JAX/XLA); this library owns the
// host-side hot loops around it, replacing what the reference did with
// per-pixel C++ host code (oct_interp.cc:424-457 count re-quantization,
// the staging loops in every *_cuda.cu wrapper):
//
//   * octane_requantize: normalized [0,255] image -> int16 radiance counts
//     (denormalize + inverse scale/offset + C truncation), multithreaded --
//     the product-write hot loop for every temporally interpolated frame.
//   * octane_epe_stats: endpoint-error statistics between two flow fields
//     (mean/max), multithreaded -- the parity metric (EPE < 0.1 px).
//
// Build: make -C native   (produces liboctane_native.so, loaded via ctypes)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

int default_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

template <typename F>
void parallel_for(int64_t n, int nthreads, F body) {
  if (nthreads <= 1 || n < (1 << 16)) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// img (float32 normalized [0, 255], n) -> counts (int16, n):
//   counts = int16((img/255 * (vmax - vmin) + vmin - offset) / scale)
// The divide-by-255 runs in double and the product is truncated to float
// BEFORE the int16 C-cast, matching the reference's precision/order exactly
// (oct_interp.cc:424-457 computes imgnew/255. in double); pre-dividing the
// span in float can flip counts by 1 at truncation boundaries.
void octane_requantize(const float* img, int64_t n, float vmin, float vmax,
                       float scale, float offset, int16_t* out,
                       int nthreads) {
  if (nthreads <= 0) nthreads = default_threads();
  const double span = static_cast<double>(vmax) - static_cast<double>(vmin);
  parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float rad = static_cast<float>(
          static_cast<double>(img[i]) / 255.0 * span + vmin);
      out[i] = static_cast<int16_t>((rad - offset) / scale);
    }
  });
}

// Endpoint-error statistics; out = {mean_epe, max_epe, frac_above_thresh}
void octane_epe_stats(const float* u1, const float* v1, const float* u2,
                      const float* v2, int64_t n, float thresh, double* out,
                      int nthreads) {
  if (nthreads <= 0) nthreads = default_threads();
  std::vector<double> sums;
  std::vector<double> maxs;
  std::vector<int64_t> cnts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  int used = 0;
  std::vector<std::thread> ts;
  sums.assign(nthreads, 0.0);
  maxs.assign(nthreads, 0.0);
  cnts.assign(nthreads, 0);
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ++used;
    ts.emplace_back([=, &sums, &maxs, &cnts] {
      double s = 0.0, m = 0.0;
      int64_t c = 0;
      for (int64_t i = lo; i < hi; ++i) {
        double du = static_cast<double>(u1[i]) - u2[i];
        double dv = static_cast<double>(v1[i]) - v2[i];
        double e = std::sqrt(du * du + dv * dv);
        s += e;
        if (e > m) m = e;
        if (e > thresh) ++c;
      }
      sums[t] = s;
      maxs[t] = m;
      cnts[t] = c;
    });
  }
  for (auto& t : ts) t.join();
  double s = 0.0, m = 0.0;
  int64_t c = 0;
  for (int t = 0; t < used; ++t) {
    s += sums[t];
    m = std::max(m, maxs[t]);
    c += cnts[t];
  }
  out[0] = n > 0 ? s / static_cast<double>(n) : 0.0;
  out[1] = m;
  out[2] = n > 0 ? static_cast<double>(c) / static_cast<double>(n) : 0.0;
}

}  // extern "C"
