// Host point generation for the PyTorch/CUDA fast-GP port (a copy of the JAX
// package's points/_native/fastgp_native.cpp).
//
// Only the rank-1 lattice (van der Corput order, random shift) is kept: the
// numpy lattice path spends its time on the bit reversal, while the digital
// net's numpy doubling is already one pass of XORs over the points, so the
// Sobol' functions and the bit-reversal table are left out of this copy.
// Exposed through ctypes (points/native.py) with the numpy path as fallback.
//
// Built by points/native.py with g++ -O3 -ffp-contract=off -shared -fPIC into
// the package's _build/ directory; -ffp-contract=off keeps the lattice
// arithmetic (multiply, then add) bit-identical to the numpy path.

#include <cstdint>
#include <cstddef>

extern "C" {

// Reverse the lowest 32 bits of each index.
static inline uint32_t bitrev32(uint32_t v) {
    v = ((v & 0x55555555u) << 1) | ((v >> 1) & 0x55555555u);
    v = ((v & 0x33333333u) << 2) | ((v >> 2) & 0x33333333u);
    v = ((v & 0x0F0F0F0Fu) << 4) | ((v >> 4) & 0x0F0F0F0Fu);
    v = ((v & 0x00FF00FFu) << 8) | ((v >> 8) & 0x00FF00FFu);
    return (v << 16) | (v >> 16);
}

// Rank-1 lattice, natural (van der Corput) order with shift:
// out[i - n_min][j] = frac(vdc(i) * g[j] + shift[j]).
void lattice_natural(const uint64_t* gen_vec, int d,
                     uint64_t n_min, uint64_t n_max, const double* shift,
                     double* out) {
    const double inv32 = 1.0 / 4294967296.0;
    for (uint64_t i = n_min; i < n_max; ++i) {
        double v = bitrev32((uint32_t)i) * inv32;
        double* row = out + (size_t)(i - n_min) * d;
        for (int j = 0; j < d; ++j) {
            double x = v * (double)gen_vec[j] + shift[j];
            x -= (double)(int64_t)x;  // frac for non-negative x
            row[j] = x;
        }
    }
}

}  // extern "C"
