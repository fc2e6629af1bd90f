// The non-compact U(1) heatbath sweep, host code.
//
// The update is an exact gaussian heatbath, site-sequential: each link's
// staple reads links updated earlier in the same sweep, so the sweep is a
// serial loop on the host (the reference's "can't be parallelized as is",
// u1/u1_utils.h:633-667) and no kernel. qmg_tpu_torch/u1.py builds this
// file with the host C++ compiler at first use and calls it through
// ctypes; its plain version is u1._heatbath_sweeps_numpy.
//
// Two entries, each the same function as its counterpart in
// qmg_tpu/native/heatbath.cpp, x links first (x outer, y inner), then y
// links:
//   heatbath_sweeps (qmg_heatbath_sweeps): a std::mt19937_64 seeded once
//     per call (the caller draws the 64-bit seed from its own stream)
//     feeding std::normal_distribution;
//   heatbath_sweeps_std (qmg_heatbath_sweeps_std): the caller's
//     rng.StdMT19937 stream continued in place: its mt19937 state, index
//     and cached Marsaglia-polar normal live in the caller's buffers and
//     are left as the plain sweep (u1._heatbath_sweeps_numpy) with the
//     same object would leave them.
// Built with -ffp-contract=off, as that library is, so that both give the
// same bits.
//
// Layout: phases is a (2, Y, X) row-major array of doubles, mu-major, then
// y, then x: phases[mu][y][x] = A_mu(x, y).

#include <cmath>
#include <cstdint>
#include <random>

namespace {

// libstdc++'s std::mt19937 with generate_canonical<double, 53> (two draws,
// low word first) and normal_distribution (Marsaglia polar with its saved
// value), on state that the caller owns: rng.StdMT19937's arithmetic.
struct StdMT {
  uint32_t* mt;        // 624-word state (borrowed)
  int32_t* idx;        // position in [0, 624]
  double* saved;       // the cached normal
  int32_t* has_saved;

  static constexpr int N = 624, M = 397;
  static constexpr uint32_t MATRIX_A = 0x9908B0DFu;
  static constexpr uint32_t UPPER = 0x80000000u, LOWER = 0x7FFFFFFFu;

  void refill() {
    for (int i = 0; i < N; i++) {
      uint32_t y = (mt[i] & UPPER) | (mt[(i + 1) % N] & LOWER);
      mt[i] = mt[(i + M) % N] ^ (y >> 1) ^ ((y & 1u) ? MATRIX_A : 0u);
    }
    *idx = 0;
  }

  uint32_t raw() {
    if (*idx >= N) refill();
    uint32_t y = mt[(*idx)++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9D2C5680u;
    y ^= (y << 15) & 0xEFC60000u;
    y ^= y >> 18;
    return y;
  }

  double canonical() {
    const double g0 = raw();
    const double g1 = raw();
    return (g0 + g1 * 4294967296.0) / 18446744073709551616.0;
  }

  double normal(double stddev) {
    if (*has_saved) {
      *has_saved = 0;
      return *saved * stddev;
    }
    double x, y, r2;
    do {
      x = 2.0 * canonical() - 1.0;
      y = 2.0 * canonical() - 1.0;
      r2 = x * x + y * y;
    } while (r2 > 1.0 || r2 == 0.0);
    const double mult = std::sqrt(-2.0 * std::log(r2) / r2);
    *saved = x * mult;
    *has_saved = 1;
    return y * mult * stddev;
  }
};

// n_update sweeps drawing each link's gaussian from normal(width).
template <class Normal>
void sweeps(double* phases, int ylen, int xlen, double beta, int n_update,
            Normal&& normal) {
  const double width = std::sqrt(0.5 / beta);
  double* ax = phases;                            // A_x(y, x)
  double* ay = phases + (size_t)ylen * xlen;      // A_y(y, x)
  auto AX = [&](int y, int x) -> double& { return ax[(size_t)y * xlen + x]; };
  auto AY = [&](int y, int x) -> double& { return ay[(size_t)y * xlen + x]; };

  for (int iter = 0; iter < n_update; iter++) {
    for (int x = 0; x < xlen; x++) {
      const int xp = (x + 1) % xlen;
      for (int y = 0; y < ylen; y++) {
        const int yp = (y + 1) % ylen;
        const int ym = (y - 1 + ylen) % ylen;
        const double staple = AY(y, xp) - AX(yp, x) - AY(y, x)
                            - AY(ym, xp) - AX(ym, x) + AY(ym, x);
        AX(y, x) = normal(width) - 0.5 * staple;
      }
    }
    for (int x = 0; x < xlen; x++) {
      const int xp = (x + 1) % xlen;
      const int xm = (x - 1 + xlen) % xlen;
      for (int y = 0; y < ylen; y++) {
        const int yp = (y + 1) % ylen;
        const double staple = AX(yp, x) - AY(y, xp) - AX(y, x)
                            - AX(yp, xm) - AY(y, xm) + AX(y, xm);
        AY(y, x) = normal(width) - 0.5 * staple;
      }
    }
  }
}

}  // namespace

extern "C" void heatbath_sweeps(double* phases, int ylen, int xlen,
                                double beta, int n_update, uint64_t seed) {
  std::mt19937_64 gen(seed);
  std::normal_distribution<double> dist(0.0, std::sqrt(0.5 / beta));
  sweeps(phases, ylen, xlen, beta, n_update,
         [&](double) { return dist(gen); });
}

extern "C" void heatbath_sweeps_std(double* phases, int ylen, int xlen,
                                    double beta, int n_update,
                                    uint32_t* mt_state, int32_t* mt_idx,
                                    double* saved_normal,
                                    int32_t* has_saved) {
  StdMT gen{mt_state, mt_idx, saved_normal, has_saved};
  sweeps(phases, ylen, xlen, beta, n_update,
         [&](double width) { return gen.normal(width); });
}
