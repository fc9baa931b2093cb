"""Check that the int8 kernels' quotient from a correctly rounded reciprocal
equals the IEEE division, in float32, against exact rational arithmetic.

    python3 scripts/check_rcp_division.py [--n 60000] [--seed 1]

B3 (csrc/ffn_block_int8.cu) divides each value of a row by the row's
scale with ``int8_tile.cuh div_rcp``: y = RN(1 / b), q = RN(a y),
r = a - b q (an FMA, exact), q' = RN(q + r y) (Markstein's correction).
This script draws scales over 1e-10 .. 1e3 and values over 1e-6 .. 1e4,
a third of them with quotients within 4e-7 of a half-integer (where the
rounding to an int8 step depends on the last bit), computes each float32
operation as its exact rational result rounded once to float32, and
counts the pairs where q' differs from RN(a / b).  Prints one line;
exits non-zero on any mismatch.  Runs on the CPU (~2 minutes).
"""

from __future__ import annotations

import argparse
import sys
from fractions import Fraction

import numpy as np


def rn32(x: Fraction) -> np.float32:
    """x rounded once to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]

    def key(c):
        odd = int(np.frombuffer(np.float32(c).tobytes(), np.uint32)[0]) & 1
        return abs(Fraction(float(c)) - x), odd

    return np.float32(min(cands, key=key))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=60000)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    bad = 0
    for i in range(args.n):
        b = np.float32(abs(rng.standard_normal()) * 10.0 ** rng.uniform(-10, 3)) or np.float32(1e-10)
        a = np.float32(rng.standard_normal() * 10.0 ** rng.uniform(-6, 4))
        if i % 3 == 0:
            k = rng.integers(-127, 128) + 0.5
            a = np.float32(float(b) * k * (1 + rng.uniform(-4e-7, 4e-7)))
        fa, fb = Fraction(float(a)), Fraction(float(b))
        y = rn32(1 / fb)
        q = rn32(fa * Fraction(float(y)))
        r = rn32(fa - fb * Fraction(float(q)))
        q2 = rn32(Fraction(float(q)) + Fraction(float(r)) * Fraction(float(y)))
        if q2 != rn32(fa / fb):
            bad += 1
    print(f"checked {args.n} quotients, mismatches {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
