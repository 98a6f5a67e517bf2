"""Exact classical prediction of a semiclassical attempt's measurement
record — no state vector, any modulus size.

The work register starts in |1> = (1/sqrt r) sum_k |u_k> with
U|u_k> = e^{2 pi i k/r}|u_k> (r = ord_C(a)); a semiclassical step s
applies controlled-U^{2^(L-1-s)} and the deferred phase theta_s =
pi*phi_s, so conditioned on eigenphase k/r the control measures 0 with
probability cos^2(pi(2^(L-1-s) k/r + phi_s/2)).  Tracking the posterior
over k (r weights) reproduces the engine's joint bit distribution
EXACTLY (same closed form the engine evaluates on the state,
algorithms/semiclassical.py:_oracle_pass), and replaying the engine's
own PRNG stream (key split + uniform draws, shor.py:484 /
semiclassical.py rs) reproduces its exact bit sequence — validated
bit-for-bit against the CPU engine (tests/test_semiclassical.py::
test_predictor_matches_engine).

Use: pick a seed for a large forced-a demo run WITHOUT paying a device
attempt per candidate —

    python scripts/predict_semiclassical.py 1060314373 2 45 [seeds]

prints per-seed x~, recovered period, factors, and the minimum draw
margin min_s |r_s - p0(s)| (prefer large: bf16-storage engines deviate
from the f64 conditionals by ~1e-2 at worst, and a draw inside that
band could flip a bit on hardware).

O(r*L) flops per seed — the 622,212-eigenphase posterior for the
30-bit demo costs ~30 ms, vs ~600 s per attempt on the chip.
"""

import math
import sys

import numpy as np


def multiplicative_order(a: int, C: int) -> int:
    """ord_C(a) by factoring C (trial division — demo-scale moduli) and
    reducing lambda prime-by-prime."""
    # factor C
    fac = {}
    x, d = C, 2
    while d * d <= x:
        while x % d == 0:
            fac[d] = fac.get(d, 0) + 1
            x //= d
        d += 1
    if x > 1:
        fac[x] = fac.get(x, 0) + 1

    def order_mod_pk(a, p, k):
        pk = p**k
        lam = (p - 1) * p ** (k - 1)
        f = {}
        y, q = lam, 2
        while q * q <= y:
            while y % q == 0:
                f[q] = f.get(q, 0) + 1
                y //= q
            q += 1
        if y > 1:
            f[y] = f.get(y, 0) + 1
        o = lam
        for q in f:
            while o % q == 0 and pow(a, o // q, pk) == 1:
                o //= q
        return o

    return math.lcm(*(order_mod_pk(a, p, k) for p, k in fac.items()))


def predict_bits(C: int, a: int, L: int, rs, r: int | None = None):
    """Replay one attempt against the exact eigenphase-mixture posterior.

    rs: the engine's L uniform draws (float64).  Returns (bits,
    min_margin): the measured bit sequence and min_s |rs[s] - p0(s)| —
    the robustness of the prediction to engine-side roundoff."""
    if r is None:
        r = multiplicative_order(a, C)
    k = np.arange(r, dtype=np.int64)
    w = np.full(r, 1.0 / r)
    phi = 0.0
    bits = []
    margin = 1.0
    for s in range(L):
        e_s = pow(2, L - 1 - s, r)
        frac = ((e_s * k) % r) / r
        p0k = np.cos(np.pi * (frac + phi / 2.0)) ** 2
        p0 = float(np.sum(w * p0k))
        bit = 1 if rs[s] >= p0 else 0  # collapse_from_a1 draw convention
        margin = min(margin, abs(float(rs[s]) - p0))
        pk = p0k if bit == 0 else (1.0 - p0k)
        w = w * pk / max(p0 if bit == 0 else (1.0 - p0), 1e-300)
        w /= w.sum()
        phi = (phi + bit) / 2.0
        bits.append(bit)
    return bits, margin


def engine_draws(seed: int, L: int):
    """The exact rs the CLI/driver hands the first attempt for --seed:
    key = PRNGKey(seed); key, sub = split(key) (shor.py trial loop);
    rs = uniform(sub, (L,), f32) (run_semiclassical)."""
    import jax

    key = jax.random.PRNGKey(seed)
    _, sub = jax.random.split(key)
    import jax.numpy as jnp

    return np.asarray(jax.random.uniform(sub, (L,), dtype=jnp.float32), np.float64)


def predict_attempt(C: int, a: int, L: int, seed: int, r: int | None = None):
    """Full pipeline for one forced-a attempt: bits -> x~ -> period ->
    factors, using the repo's own continued-fraction recovery."""
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from quantumcomputer.algorithms import number_theory as nt

    if r is None:
        r = multiplicative_order(a, C)
    bits, margin = predict_bits(C, a, L, engine_draws(seed, L), r)
    x_tilde = 0
    for pos, m in enumerate(bits):
        x_tilde |= m << pos
    omega = x_tilde / float(1 << L)
    period = nt.find_period_from_omega(omega, a, C)
    factors = None
    if period is not None and period % 2 == 0:
        h = pow(a, period // 2, C)
        if h != C - 1:
            for f in (math.gcd(h - 1, C), math.gcd(h + 1, C)):
                if 1 < f < C:
                    factors = (max(f, C // f), min(f, C // f))
                    break
    return {
        "bits": bits, "x_tilde": x_tilde, "omega": omega,
        "period": period, "factors": factors, "min_margin": margin,
    }


if __name__ == "__main__":
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 1060314373
    a = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    L = int(sys.argv[3]) if len(sys.argv) > 3 else 45
    seeds = [int(s) for s in sys.argv[4:]] or list(range(24))
    r = multiplicative_order(a, C)
    print(f"ord_{C}({a}) = {r}")
    for seed in seeds:
        p = predict_attempt(C, a, L, seed, r)
        print(
            f"seed {seed:3d}: x~={p['x_tilde']:>14d} period={p['period']} "
            f"factors={p['factors']} min_margin={p['min_margin']:.4f}"
        )
