"""Deterministic host-side random numbers (port of qmg_tpu/rng.py).

Draws happen on the host with NumPy's MT19937 and are bit-exact with
``qmg_tpu.rng``: the same seed gives the same gaussians in both packages,
so a hierarchy built by either one starts from identical inputs. Callers
move the drawn arrays to the device themselves.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["QMGRandom", "StdMT19937", "DEFAULT_SEED"]

DEFAULT_SEED = 1337


class QMGRandom:
    """A seeded mt19937 stream with the fill primitives the setup needs."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self.gen = np.random.Generator(np.random.MT19937(seed))

    def gaussian_cv(self, lat, deviation: float = 1.0) -> np.ndarray:
        """Complex gaussian color vector (2, Y, Xh, nc), complex128;
        each real component ~ N(0, deviation)."""
        shape = lat.cv_shape()
        re = self.gen.normal(0.0, deviation, size=shape)
        im = self.gen.normal(0.0, deviation, size=shape)
        return re + 1j * im

    def gaussian_real(self, shape, deviation: float = 1.0) -> np.ndarray:
        return self.gen.normal(0.0, deviation, size=shape)

    def uniform(self, shape, low: float, high: float) -> np.ndarray:
        return self.gen.uniform(low, high, size=shape)

    def normal_scalar(self, deviation: float = 1.0) -> float:
        return float(self.gen.normal(0.0, deviation))


class StdMT19937:
    """Bit-exact libstdc++ ``std::mt19937`` with its distributions:
    generate_canonical<double> (two draws, low word first), uniform_real
    and the Marsaglia-polar normal_distribution with its saved value."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = DEFAULT_SEED):
        mt = np.empty(self.N, dtype=np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) \
                & 0xFFFFFFFF
        self._mt = mt
        self._idx = self.N
        self._saved_normal = None

    def _refill(self):
        mt = self._mt
        n, m = self.N, self.M
        for i in range(n):
            y = (mt[i] & self.UPPER) | (mt[(i + 1) % n] & self.LOWER)
            mt[i] = (mt[(i + m) % n] ^ (y >> 1)
                     ^ (self.MATRIX_A if (y & 1) else 0)) & 0xFFFFFFFF
        self._idx = 0

    def raw(self) -> int:
        """One tempered 32-bit draw."""
        if self._idx >= self.N:
            self._refill()
        y = int(self._mt[self._idx])
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def canonical(self) -> float:
        g0 = self.raw()
        g1 = self.raw()
        return (g0 + g1 * 4294967296.0) / 18446744073709551616.0

    def uniform(self, a: float = 0.0, b: float = 1.0) -> float:
        return a + self.canonical() * (b - a)

    def normal(self, mean: float = 0.0, stddev: float = 1.0) -> float:
        if self._saved_normal is not None:
            v = self._saved_normal
            self._saved_normal = None
            return mean + v * stddev
        while True:
            x = 2.0 * self.canonical() - 1.0
            y = 2.0 * self.canonical() - 1.0
            r2 = x * x + y * y
            if r2 <= 1.0 and r2 != 0.0:
                break
        # math.log/math.sqrt are the C library's, as libstdc++ uses.
        mult = math.sqrt(-2.0 * math.log(r2) / r2)
        self._saved_normal = x * mult
        return mean + y * mult * stddev

    def normal_scalar(self, deviation: float = 1.0) -> float:
        return self.normal(0.0, deviation)
