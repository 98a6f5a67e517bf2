// Native classical number-theory kernels for Shor's algorithm.
//
// Rebuild of the reference's classical post-processing layer
// (qc_shor.c:756-964), which is itself native C.  Exact 64-bit integer
// arithmetic throughout: modular exponentiation is square-and-multiply with
// __uint128_t intermediates, fixing the reference's INT_POW double-rounding
// (qc_shor.c:158-159, 946).  The continued-fraction expansion reproduces the
// reference's double-precision recurrence (qc_shor.c:806-846) exactly,
// including its convention of rebuilding each convergent denominator from
// the coefficient array in reverse.
//
// Exposed as a C ABI for ctypes binding (see
// quantumcomputer/algorithms/_native.py).

#include <cstdint>
#include <cmath>

extern "C" {

uint64_t qc_gcd(uint64_t a, uint64_t b) {
    while (b != 0) {
        uint64_t t = a % b;
        a = b;
        b = t;
    }
    return a;
}

// Exact (a * b) mod m via 128-bit intermediate.
static inline uint64_t mulmod(uint64_t a, uint64_t b, uint64_t m) {
    return (uint64_t)(((__uint128_t)a * b) % m);
}

uint64_t qc_modpow(uint64_t base, uint64_t exp, uint64_t mod) {
    if (mod == 0) return 0;
    uint64_t result = 1 % mod;
    base %= mod;
    while (exp > 0) {
        if (exp & 1) result = mulmod(result, base, mod);
        base = mulmod(base, base, mod);
        exp >>= 1;
    }
    return result;
}

// Denominators of successive continued-fraction convergents of omega,
// using the reference's floating recurrence (qc_shor.c:821-843): at step i,
// omega_inv = 1/omega; next omega is its fractional part; the coefficient
// is the integer part; the i-th denominator is rebuilt from coeffs[0..i-1]
// in reverse.  omega <= 0 emits coefficient 0 (the reference would divide
// by zero); overflow saturates.
void qc_cf_denominators(double omega, int num, uint64_t* out) {
    uint64_t coeffs[64];
    if (num > 64) num = 64;
    for (int i = 0; i < num; i++) {
        if (omega <= 0.0) {
            coeffs[i] = 0;
        } else {
            double omega_inv = 1.0 / omega;
            double frac = omega_inv - (double)((uint64_t)omega_inv);
            double c = omega_inv - frac;
            coeffs[i] = c >= 1.8446744073709552e19 ? UINT64_MAX : (uint64_t)c;
            omega = frac;
        }
        uint64_t den = 1, num_ = 0;
        for (int k = i - 1; k >= 0; k--) {
            uint64_t t = den;
            den = num_ + den * coeffs[k];  // may wrap for pathological omegas,
            num_ = t;                       // matching unsigned C semantics
        }
        out[i] = den;
    }
}

// Period extraction (qc_shor.c:941-955): try multiples m*d (m = 1..trials)
// of each convergent denominator d against a^p == 1 (mod C).  Returns the
// period, or -1 when no candidate passes (the reference reads uninitialized
// memory in that case; here it is an explicit miss).
int64_t qc_find_period(double omega, uint64_t a, uint64_t C,
                       int num_fractions, int trials_per_denominator) {
    uint64_t denoms[64];
    if (num_fractions > 64) num_fractions = 64;
    qc_cf_denominators(omega, num_fractions, denoms);
    for (int d = 0; d < num_fractions; d++) {
        if (denoms[d] == 0) continue;
        for (int m = 1; m <= trials_per_denominator; m++) {
            uint64_t p = (uint64_t)m * denoms[d];
            if (p == 0) continue;
            if (qc_modpow(a, p, C) == 1) return (int64_t)p;
        }
    }
    return -1;
}

// Exact multiplicative order of a mod C (0 if gcd(a, C) != 1).
uint64_t qc_mult_order(uint64_t a, uint64_t C) {
    if (qc_gcd(a, C) != 1) return 0;
    uint64_t x = a % C, p = 1;
    while (x != 1) {
        x = mulmod(x, a % C, C);
        p++;
        if (p > C) return 0;
    }
    return p;
}

// Modular inverse of a mod C via extended Euclid; 0 when gcd(a, C) != 1.
uint64_t qc_modinv(uint64_t a, uint64_t C) {
    int64_t t = 0, newt = 1;
    int64_t r = (int64_t)C, newr = (int64_t)(a % C);
    while (newr != 0) {
        int64_t q = r / newr;
        int64_t tmp = t - q * newt; t = newt; newt = tmp;
        tmp = r - q * newr; r = newr; newr = tmp;
    }
    if (r != 1) return 0;
    if (t < 0) t += (int64_t)C;
    return (uint64_t)t;
}

// Cycle schedule for the cycle-ordered oracle kernel
// (quantumcomputer/ops/pallas_oracle.py): order output rows along the
// permutation's cycles so each input row is read exactly once.  prev_kind:
// 0 = chain from the previous step's source, 1 = fresh read (cycle head),
// 2 = self (fixed point), 3 = cycle-closing step (source = the saved head
// original; no DMA — makes in-place execution safe).  ginv[j] = source
// row for output row j.
void qc_cycle_schedule(const int32_t* ginv, int64_t rows,
                       int32_t* out_row, int32_t* src_row, int32_t* prev_kind) {
    // visited bitmap on the stack-ish heap; rows <= 2^24 in practice.
    uint8_t* visited = new uint8_t[rows]();
    int64_t t = 0;
    for (int64_t j0 = 0; j0 < rows; ++j0) {
        if (visited[j0]) continue;
        if (ginv[j0] == (int32_t)j0) {
            out_row[t] = (int32_t)j0;
            src_row[t] = (int32_t)j0;
            prev_kind[t] = 2;
            visited[j0] = 1;
            ++t;
            continue;
        }
        int64_t j = j0;
        int32_t first = 1;
        while (!visited[j]) {
            visited[j] = 1;
            out_row[t] = (int32_t)j;
            src_row[t] = ginv[j];
            prev_kind[t] = first;
            first = 0;
            ++t;
            j = (int64_t)ginv[j];
        }
        // Mark the cycle-closing step: its source is the head row's
        // ORIGINAL value (overwritten under in-place execution), served
        // from the kernel's saved head slot instead of a DMA read.
        prev_kind[t - 1] = 3;
    }
    delete[] visited;
}

// Composed inverse multipliers for a fused run of modular multiplies
// (ops/gates.modexp_combo_multipliers): combos[mask] =
// prod_k (A_k^{-1})^{bit_k(mask)} mod C.  Returns 0 on success, -1 when
// some A_k is not invertible mod C.
int qc_combo_multipliers(uint64_t C, const uint64_t* A, int K, uint64_t* combos) {
    uint64_t ainv[32];
    if (K > 32) return -1;
    for (int k = 0; k < K; ++k) {
        ainv[k] = qc_modinv(A[k] % C, C);
        if (ainv[k] == 0 && C != 1) return -1;
    }
    combos[0] = 1 % C;
    for (uint64_t mask = 1; mask < ((uint64_t)1 << K); ++mask) {
        uint64_t low = mask & (~mask + 1);
        int k = 0;
        while (!((low >> k) & 1)) ++k;
        combos[mask] = mulmod(combos[mask ^ low], ainv[k], C);
    }
    return 0;
}

}  // extern "C"
