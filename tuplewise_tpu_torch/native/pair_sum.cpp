// Native pair-kernel reduction engine for the CPU backend family.
//
// The TPU compute path is JAX/XLA/Pallas (ops/); this C++ engine is the
// native runtime for the host-side reference/serial path: the same
// blockwise streaming reduction as backends/numpy_backend.py, compiled
// with -O3 and parallelized over rows with OpenMP when available.
//
// Determinism: each row's inner reduction is sequential, per-row results
// land in a row_sums array indexed by row, and the final fold over rows
// is a sequential Kahan sum — so the result is independent of thread
// scheduling and reproducible run-to-run.
//
// Kernel ids mirror ops/kernels.py exactly:
//   0 = auc       g(d) = 1{d>0} + 0.5*1{d==0}
//   1 = hinge     g(d) = max(0, 1 - d)
//   2 = logistic  g(d) = log(1 + exp(-d))   (stable softplus)
//
// Exclusion semantics match NumpyBackend._pair_stats: when use_ids is
// set, grid cells with ids_a[i] == ids_b[j] are skipped (one-sample
// diagonal and with-replacement duplicates).

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline double softplus_neg(double d) {
    // log(1 + exp(-d)), stable for any d
    if (d > 0.0) {
        return std::log1p(std::exp(-d));
    }
    return -d + std::log1p(std::exp(d));
}

inline double eval_diff(int kernel_id, double d) {
    switch (kernel_id) {
        case 0:  // auc indicator with half-weight ties
            return d > 0.0 ? 1.0 : (d == 0.0 ? 0.5 : 0.0);
        case 1:  // hinge
            return d < 1.0 ? 1.0 - d : 0.0;
        default:  // 2: logistic
            return softplus_neg(d);
    }
}

struct Acc {
    double sum = 0.0;
    int64_t count = 0;
};

// Sequential Kahan fold of per-row partials (deterministic).
void fold_rows(const std::vector<Acc>& rows, double* out_sum,
               int64_t* out_count) {
    double s = 0.0, comp = 0.0;
    int64_t c = 0;
    for (const Acc& r : rows) {
        double y = r.sum - comp;
        double t = s + y;
        comp = (t - s) - y;
        s = t;
        c += r.count;
    }
    *out_sum = s - comp;
    *out_count = c;
}

}  // namespace

extern "C" {

// (sum, count) of g(a_i - b_j) over the (masked-by-ids) pair grid.
void pair_stats_diff(int kernel_id, const double* a, int64_t n1,
                     const double* b, int64_t n2, const int64_t* ids_a,
                     const int64_t* ids_b, int use_ids, double* out_sum,
                     int64_t* out_count) {
    std::vector<Acc> rows(static_cast<size_t>(n1));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n1; ++i) {
        const double ai = a[i];
        const int64_t ia = use_ids ? ids_a[i] : 0;
        double s = 0.0, comp = 0.0;
        int64_t c = 0;
        for (int64_t j = 0; j < n2; ++j) {
            if (use_ids && ia == ids_b[j]) continue;
            const double v = eval_diff(kernel_id, ai - b[j]);
            double y = v - comp;
            double t = s + y;
            comp = (t - s) - y;
            s = t;
            ++c;
        }
        rows[static_cast<size_t>(i)].sum = s - comp;
        rows[static_cast<size_t>(i)].count = c;
    }
    fold_rows(rows, out_sum, out_count);
}

// (sum, count) of the scatter kernel h(x, x') = ||x - x'||^2 / 2 over
// the [n1, n2] grid of d-dimensional rows, with id exclusion.
void pair_stats_scatter(const double* a, int64_t n1, const double* b,
                        int64_t n2, int64_t dim, const int64_t* ids_a,
                        const int64_t* ids_b, int use_ids, double* out_sum,
                        int64_t* out_count) {
    std::vector<Acc> rows(static_cast<size_t>(n1));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n1; ++i) {
        const double* xi = a + i * dim;
        const int64_t ia = use_ids ? ids_a[i] : 0;
        double s = 0.0, comp = 0.0;
        int64_t c = 0;
        for (int64_t j = 0; j < n2; ++j) {
            if (use_ids && ia == ids_b[j]) continue;
            const double* yj = b + j * dim;
            double d2 = 0.0;
            for (int64_t k = 0; k < dim; ++k) {
                const double diff = xi[k] - yj[k];
                d2 += diff * diff;
            }
            const double v = 0.5 * d2;
            double y = v - comp;
            double t = s + y;
            comp = (t - s) - y;
            s = t;
            ++c;
        }
        rows[static_cast<size_t>(i)].sum = s - comp;
        rows[static_cast<size_t>(i)].count = c;
    }
    fold_rows(rows, out_sum, out_count);
}

// (sum, count) of the degree-3 metric-learning kernel
// h(x_i, x_j, y_k) over ids_x[i] != ids_x[j] (anchor/positive
// exclusion), all k — mirroring NumpyBackend._triplet_stats exactly.
// kernel_id: 0 = indicator 1{d(a,n) > d(a,p) + margin},
//            1 = hinge max(0, margin + d(a,p) - d(a,n)),
// with d = SQUARED euclidean distance (ops/kernels.py semantics).
// Per anchor i, the n2 anchor-negative distances are computed once
// (O(n2 d)) and reused across all positives j, so the triple loop
// costs O(n1^2 n2 + n1 n2 d) instead of O(n1^2 n2 d).
void triplet_stats_native(int kernel_id, double margin, const double* x,
                          int64_t n1, const double* y, int64_t n2,
                          int64_t dim, const int64_t* ids_x,
                          double* out_sum, int64_t* out_count) {
    std::vector<Acc> rows(static_cast<size_t>(n1));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n1; ++i) {
        const double* xi = x + i * dim;
        std::vector<double> dan(static_cast<size_t>(n2));
        for (int64_t kk = 0; kk < n2; ++kk) {
            const double* yk = y + kk * dim;
            double d2 = 0.0;
            for (int64_t d = 0; d < dim; ++d) {
                const double diff = xi[d] - yk[d];
                d2 += diff * diff;
            }
            dan[static_cast<size_t>(kk)] = d2;
        }
        double s = 0.0, comp = 0.0;
        int64_t c = 0;
        for (int64_t j = 0; j < n1; ++j) {
            if (ids_x[j] == ids_x[i]) continue;
            const double* xj = x + j * dim;
            double dap = 0.0;
            for (int64_t d = 0; d < dim; ++d) {
                const double diff = xi[d] - xj[d];
                dap += diff * diff;
            }
            // plain f64 sum over the n2 negatives (values are O(1), so
            // a block of <=1e7 terms keeps ~1e-10 relative error), then
            // ONE Kahan add per (i, j): a Kahan chain in the innermost
            // loop would serialize it on the compensation dependency
            double block = 0.0;
            if (kernel_id == 0) {
                const double thresh = dap + margin;
                for (int64_t kk = 0; kk < n2; ++kk) {
                    block += dan[static_cast<size_t>(kk)] > thresh
                                 ? 1.0 : 0.0;
                }
            } else {
                const double base = margin + dap;
                for (int64_t kk = 0; kk < n2; ++kk) {
                    const double h = base - dan[static_cast<size_t>(kk)];
                    block += h > 0.0 ? h : 0.0;
                }
            }
            double yv = block - comp;
            double t = s + yv;
            comp = (t - s) - yv;
            s = t;
            c += n2;
        }
        rows[static_cast<size_t>(i)].sum = s - comp;
        rows[static_cast<size_t>(i)].count = c;
    }
    fold_rows(rows, out_sum, out_count);
}

int native_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
