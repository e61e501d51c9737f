// C++ image-source RIR engine for the eabnet_tpu_torch data pipeline (the
// port's copy of the JAX package's native engine, same ABI version).
//
// Replaces the pyroomacoustics C++ dependency of the reference data layer
// (reference: dataset/audio_util.py:49-88) with a minimal, allocation-free
// shoebox image-source model (Allen & Berkley): enumerate images up to
// max_order, damp by beta^reflections, place each contribution with an
// 81-tap Hann-windowed sinc fractional-delay filter.
//
// Exposed as a C ABI for ctypes (eabnet_tpu_torch/data/rir_native.py);
// semantics are identical to the numpy path in data/rir.py (tested
// against it). The hybrid diffuse tail stays in Python so both backends
// share one RNG stream.
//
// Built at first use by data/rir_native.py (g++ -O3 -march=native
// -ffast-math -fPIC -std=c++17 -shared) into build/eabnet_tpu_torch/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kFdl = 81;  // fractional-delay filter length (odd)

struct AxisImages {
  std::vector<double> coord;
  std::vector<int> refl;
};

AxisImages axis_images(double src, double room, int order) {
  AxisImages out;
  const int lo = -(order + 1) / 2 - 2;
  const int hi = order / 2 + 3;
  for (int r = lo; r <= hi; ++r) {
    for (int p = 0; p <= 1; ++p) {
      const int hits = std::abs(r - p) + std::abs(r);
      if (hits > order) continue;
      out.coord.push_back((1 - 2 * p) * src + 2.0 * r * room);
      out.refl.push_back(hits);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Bump on ANY signature/semantics change of the exported functions: the
// ctypes loader refuses (and rebuilds) stale .so files by checking this,
// since a C ABI mismatch (e.g. the `air` argument added in v2) would
// otherwise run "successfully" with garbage-or-ignored arguments.
long long rir_abi_version() { return 2; }

// Returns the used RIR length (<= max_len) or -1 on overflow.
// out: row-major (n_mics, max_len) float32, zero-initialized by the caller.
// air: energy air-absorption coefficient (1/m); amplitude is damped by
// exp(-0.5 * air * dist). 0 disables (pure Allen & Berkley).
long long shoebox_rir(const double* room, const double* src,
                      const double* mics, int n_mics, double e_absorption,
                      int max_order, int fs, double c, double air,
                      float* out, long long max_len) {
  const double beta = std::sqrt(std::max(0.0, 1.0 - e_absorption));

  const AxisImages ax = axis_images(src[0], room[0], max_order);
  const AxisImages ay = axis_images(src[1], room[1], max_order);
  const AxisImages az = axis_images(src[2], room[2], max_order);

  // precompute damping powers
  std::vector<double> beta_pow(3 * max_order + 1, 1.0);
  for (size_t i = 1; i < beta_pow.size(); ++i)
    beta_pow[i] = beta_pow[i - 1] * beta;

  long long used = 0;
  const double inv_c = static_cast<double>(fs) / c;
  const double two_pi_over_fdl = 2.0 * M_PI / kFdl;

  for (size_t ix = 0; ix < ax.coord.size(); ++ix) {
    for (size_t iy = 0; iy < ay.coord.size(); ++iy) {
      const int rxy = ax.refl[ix] + ay.refl[iy];
      if (rxy > max_order) continue;
      for (size_t iz = 0; iz < az.coord.size(); ++iz) {
        const int total = rxy + az.refl[iz];
        if (total > max_order) continue;
        const double px = ax.coord[ix];
        const double py = ay.coord[iy];
        const double pz = az.coord[iz];
        const double damp = beta_pow[total];

        for (int mi = 0; mi < n_mics; ++mi) {
          const double dx = px - mics[mi * 3 + 0];
          const double dy = py - mics[mi * 3 + 1];
          const double dz = pz - mics[mi * 3 + 2];
          double dist = std::sqrt(dx * dx + dy * dy + dz * dz);
          if (dist < 1e-3) dist = 1e-3;
          double amp = damp / (4.0 * M_PI * dist);
          if (air > 0.0) amp *= std::exp(-0.5 * air * dist);
          const double delay = dist * inv_c;
          const long long base = static_cast<long long>(std::floor(delay));
          const double frac = delay - static_cast<double>(base);

          const long long start = base - kFdl / 2;
          const long long end = start + kFdl;
          if (end > max_len) return -1;
          if (end > used) used = end;

          float* row = out + static_cast<long long>(mi) * max_len;
          // Hann-windowed sinc at offset (n - kFdl/2 - frac)
          for (int n = 0; n < kFdl; ++n) {
            const long long k = start + n;
            if (k < 0) continue;  // energy before t=0 is clipped
            const double t = (n - kFdl / 2) - frac;
            double sinc;
            if (std::abs(t) < 1e-12) {
              sinc = 1.0;
            } else {
              const double pt = M_PI * t;
              sinc = std::sin(pt) / pt;
            }
            const double win = 0.5 * (1.0 + std::cos(two_pi_over_fdl * t));
            row[k] += static_cast<float>(amp * sinc * win);
          }
        }
      }
    }
  }
  return used;
}

}  // extern "C"
