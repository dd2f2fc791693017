// Native incomplete-factorization kernels (ILU(0) / IC(0)) and the
// dependency levels of a triangular solve: a copy of the reference's
// singlespmv_tpu/core/native/factor_native.cpp.
//
// Host-side symbolic+numeric passes are latency-bound pointer-chasing, so
// they run native, bound via ctypes with a numpy fallback that gives the same
// arrays (singlespmv_tpu_torch/ops/ilu.py, ops/sptrsv.py).
//
// Both factorizations work on a CSR matrix with row-sorted column indices and
// run in-place on vals.  Complexity: classic IKJ with an O(n) column-position
// workspace — O(nnz + sum_k |upper(k)| * |rows hitting k|), the textbook
// ILU(0) bound.
#include <cstdint>
#include <cmath>
#include <vector>

extern "C" {

// Returns 0 on success, or (1 + row) of the zero/absent pivot on failure.
int64_t spmv_ilu0(int64_t n, const int64_t* rp, const int64_t* cols,
                  double* vals) {
    std::vector<int64_t> pos(n, -1);      // column -> position in current row
    std::vector<int64_t> diag(n, -1);     // diagonal position per row
    for (int64_t r = 0; r < n; ++r)
        for (int64_t p = rp[r]; p < rp[r + 1]; ++p)
            if (cols[p] == r) { diag[r] = p; break; }

    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = rp[i]; p < rp[i + 1]; ++p) pos[cols[p]] = p;
        for (int64_t p = rp[i]; p < rp[i + 1]; ++p) {
            int64_t k = cols[p];
            if (k >= i) break;
            if (diag[k] < 0 || vals[diag[k]] == 0.0) {
                for (int64_t q = rp[i]; q < rp[i + 1]; ++q) pos[cols[q]] = -1;
                return 1 + k;
            }
            double lik = (vals[p] /= vals[diag[k]]);
            // subtract lik * U(k, j) for j > k present in row i's pattern
            for (int64_t q = diag[k] + 1; q < rp[k + 1]; ++q) {
                int64_t pj = pos[cols[q]];
                if (pj >= 0) vals[pj] -= lik * vals[q];
            }
        }
        for (int64_t p = rp[i]; p < rp[i + 1]; ++p) pos[cols[p]] = -1;
    }
    return 0;
}

// IC(0) on the LOWER-triangular pattern (diagonal included): overwrites vals
// with L such that L·Lᵀ matches A on the pattern.  Input rows must contain
// only columns <= row.  Returns 0, or (1 + row) on a non-positive pivot
// (matrix not SPD enough for IC(0) — the standard breakdown condition).
int64_t spmv_ic0(int64_t n, const int64_t* rp, const int64_t* cols,
                 double* vals) {
    std::vector<int64_t> pos(n, -1);
    std::vector<int64_t> diag(n, -1);
    for (int64_t r = 0; r < n; ++r) {
        int64_t last = rp[r + 1] - 1;
        if (last >= rp[r] && cols[last] == r) diag[r] = last;  // sorted rows
    }
    for (int64_t i = 0; i < n; ++i) {
        if (diag[i] < 0) return 1 + i;
        for (int64_t p = rp[i]; p < rp[i + 1]; ++p) pos[cols[p]] = p;
        for (int64_t p = rp[i]; p < rp[i + 1]; ++p) {
            int64_t k = cols[p];
            double s = vals[p];
            // s -= sum_{j < k} L(i,j) * L(k,j) over shared pattern
            for (int64_t q = rp[k]; q < rp[k + 1]; ++q) {
                int64_t j = cols[q];
                if (j >= k) break;
                int64_t pj = pos[j];
                if (pj >= 0) s -= vals[pj] * vals[q];
            }
            if (k < i) {
                vals[p] = s / vals[diag[k]];
            } else {  // k == i: pivot
                if (s <= 0.0) {
                    for (int64_t q = rp[i]; q < rp[i + 1]; ++q)
                        pos[cols[q]] = -1;
                    return 1 + i;
                }
                vals[p] = std::sqrt(s);
            }
        }
        for (int64_t p = rp[i]; p < rp[i + 1]; ++p) pos[cols[p]] = -1;
    }
    return 0;
}

// Dependency levels for a triangular matrix's off-diagonal pattern:
// level[r] = 1 + max(level[deps of r]), 0 if none.  lower != 0 walks rows
// ascending (lower triangle), else descending (upper).  Returns max level.
int64_t spmv_tri_levels(int64_t n, const int64_t* rp, const int64_t* cols,
                        int64_t lower, int64_t* level) {
    int64_t maxlev = 0;
    if (lower) {
        for (int64_t r = 0; r < n; ++r) {
            int64_t lv = 0;
            for (int64_t p = rp[r]; p < rp[r + 1]; ++p) {
                int64_t l = level[cols[p]] + 1;
                if (l > lv) lv = l;
            }
            level[r] = lv;
            if (lv > maxlev) maxlev = lv;
        }
    } else {
        for (int64_t r = n - 1; r >= 0; --r) {
            int64_t lv = 0;
            for (int64_t p = rp[r]; p < rp[r + 1]; ++p) {
                int64_t l = level[cols[p]] + 1;
                if (l > lv) lv = l;
            }
            level[r] = lv;
            if (lv > maxlev) maxlev = lv;
        }
    }
    return maxlev;
}

}  // extern "C"
