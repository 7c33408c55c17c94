// Host-side rank-k transform of a gradient against a basis in host memory.
//
//   out = g + V^T (c * (V g))      V: row-major (k, p) f32, g and out: (p,)
//
// The host counterpart of the CUDA pair in ops/csrc/rank_k.cu, for a basis
// offloaded to (pinned) host memory: the gradient is adjusted where the
// basis lives, with no k x p copy to the card.  Two passes, O(k p) each:
// k dot products summed in double, one OpenMP thread per row, then the
// rank-k AXPY with each output element's sum in double, OpenMP over p.
//
// Built at first use by ops/native/__init__.py:
//   g++ -O3 -fopenmp -shared -fPIC -std=c++17

#include <cstddef>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

void two_pass(const float* g, const float* V, const double* coeffs, float* out,
              int64_t k, int64_t p) {
    std::vector<double> w(static_cast<size_t>(k));
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < k; ++i) {
        const float* row = V + i * p;
        double acc = 0.0;
        for (int64_t j = 0; j < p; ++j) acc += static_cast<double>(row[j]) * g[j];
        w[static_cast<size_t>(i)] = acc * coeffs[i];
    }
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < p; ++j) {
        double acc = g[j];
        for (int64_t i = 0; i < k; ++i) acc += w[static_cast<size_t>(i)] * V[i * p + j];
        out[j] = static_cast<float>(acc);
    }
}

}  // namespace

extern "C" {

// out = g + V^T (coeffs * (V g)); out may be g itself.
void rank_k_apply(const float* g, const float* V, const float* coeffs, float* out,
                  int64_t k, int64_t p) {
    std::vector<double> c(coeffs, coeffs + k);
    two_pass(g, V, c.data(), out, k, p);
}

// LanczosSGD's adjustment: coeffs[i] = 1/lambda_i - 1/(lambda_i + delta), in f32.
void spectral_adjust(const float* g, const float* V, const float* eigvals, float* out,
                     int64_t k, int64_t p, float delta) {
    std::vector<double> c(static_cast<size_t>(k));
    for (int64_t i = 0; i < k; ++i)
        c[static_cast<size_t>(i)] = 1.0f / eigvals[i] - 1.0f / (eigvals[i] + delta);
    two_pass(g, V, c.data(), out, k, p);
}

// The projection g - sum_i (v_i . g) v_i (coeffs all -1).
void project_out(const float* g, const float* V, float* out, int64_t k, int64_t p) {
    std::vector<double> c(static_cast<size_t>(k), -1.0);
    two_pass(g, V, c.data(), out, k, p);
}

int num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
