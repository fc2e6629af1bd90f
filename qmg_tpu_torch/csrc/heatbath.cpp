// The non-compact U(1) heatbath sweep, host code.
//
// The update is an exact gaussian heatbath, site-sequential: each link's
// staple reads links updated earlier in the same sweep, so the sweep is a
// serial loop on the host (the reference's "can't be parallelized as is",
// u1/u1_utils.h:633-667) and no kernel. qmg_tpu_torch/u1.py builds this
// file with the host C++ compiler at first use and calls it through
// ctypes; its plain version is u1._heatbath_sweeps_numpy.
//
// The sweep is the same function as qmg_tpu/native/heatbath.cpp's
// qmg_heatbath_sweeps: a std::mt19937_64 seeded once per call (the caller
// draws the 64-bit seed from its own stream) feeding
// std::normal_distribution, x links first (x outer, y inner), then y
// links. Built with -ffp-contract=off, as that library is, so that both
// give the same bits.
//
// Layout: phases is a (2, Y, X) row-major array of doubles, mu-major, then
// y, then x: phases[mu][y][x] = A_mu(x, y).

#include <cmath>
#include <cstdint>
#include <random>

extern "C" void heatbath_sweeps(double* phases, int ylen, int xlen,
                                double beta, int n_update, uint64_t seed) {
  const double width = std::sqrt(0.5 / beta);
  std::mt19937_64 gen(seed);
  std::normal_distribution<double> dist(0.0, width);

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
        AX(y, x) = dist(gen) - 0.5 * staple;
      }
    }
    for (int x = 0; x < xlen; x++) {
      const int xp = (x + 1) % xlen;
      const int xm = (x - 1 + xlen) % xlen;
      for (int y = 0; y < ylen; y++) {
        const int yp = (y + 1) % ylen;
        const double staple = AX(yp, x) - AY(y, xp) - AX(y, x)
                            - AX(yp, xm) - AY(y, xm) + AX(y, xm);
        AY(y, x) = dist(gen) - 0.5 * staple;
      }
    }
  }
}
