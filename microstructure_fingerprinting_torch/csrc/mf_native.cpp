// Native host kernels for the float64 refinement stage.
//
// The general path runs its exhaustive candidate scan on the device in
// float32 and re-scores the top candidates exactly in float64 on the
// host (models/refine.py). The re-scoring gathers rotated dictionary
// columns (binary search + lerp over the knot tables) per candidate — a
// scattered float64 gather that NumPy fancy indexing executes an order of
// magnitude slower than this kernel. Compiled on first use by
// utils/native.py (g++ -O3 -fopenmp); models/refine.py falls back to
// NumPy when no compiler is found. Host code: no CUDA.

#include <cmath>
#include <cstdint>

extern "C" {

// Rotated dictionary columns, float64.
//
//   xs   (S, Kmax)       knot positions per dense shell (+inf padded)
//   cnt  (S,)            valid knots per shell
//   ys   (S, Kmax, N)    knot signal tables
//   gdir (Nseq, 3)       target gradient directions
//   lo, hi (Nseq,)       bracketing dense-shell ids per sequence
//   wg   (Nseq,)         G-blend weight between lo and hi shells
//   newdir (B, 3)        fascicle direction per voxel
//   atom_ids (B, M)      candidate atom per voxel per candidate
//   out  (B, M, Nseq)    interpolated columns (candidate-major so the
//                        downstream dot products are contiguous)
void interp_columns_f64(const double* xs, const int32_t* cnt,
                        const double* ys, const double* gdir,
                        const int32_t* lo, const int32_t* hi,
                        const double* wg, const double* newdir,
                        const int32_t* atom_ids,
                        int64_t B, int64_t Nseq, int64_t S, int64_t Kmax,
                        int64_t N, int64_t M, double* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < B; ++b) {
        const double nx = newdir[3 * b + 0];
        const double ny = newdir[3 * b + 1];
        const double nz = newdir[3 * b + 2];
        const int32_t* ids = atom_ids + b * M;
        for (int64_t i = 0; i < Nseq; ++i) {
            const double* g = gdir + 3 * i;
            double x = g[0] * nx + g[1] * ny + g[2] * nz;
            if (x < 0) x = -x;
            double* dst = out + b * M * Nseq + i;  // stride Nseq per cand
            const double w = wg[i];
            const int32_t shells[2] = {lo[i], hi[i]};
            const double coefs[2] = {1.0 - w, w};
            for (int64_t m = 0; m < M; ++m) dst[m * Nseq] = 0.0;
            for (int p = 0; p < 2; ++p) {
                const double c = coefs[p];
                if (c == 0.0 && p == 1) continue;  // exact-G match
                const int32_t s = shells[p];
                const double* xrow = xs + s * Kmax;
                const int32_t n_k = cnt[s];
                // binary search: largest j with xrow[j] <= x, clamped to
                // [0, n_k - 2]
                int64_t loj = 0, hij = n_k - 1;
                while (loj < hij) {
                    int64_t mid = (loj + hij + 1) >> 1;
                    if (xrow[mid] <= x) loj = mid; else hij = mid - 1;
                }
                int64_t j = loj;
                if (j > n_k - 2) j = n_k - 2;
                const double x0 = xrow[j], x1 = xrow[j + 1];
                const double dx = x1 - x0;
                const double t = dx > 0.0 ? (x - x0) / dx : 0.0;
                const double* y0 = ys + (s * Kmax + j) * N;
                const double* y1 = y0 + N;
                for (int64_t m = 0; m < M; ++m) {
                    const int32_t a = ids[m];
                    dst[m * Nseq] += c * (y0[a] + t * (y1[a] - y0[a]));
                }
            }
        }
    }
}

// Per-candidate Gram scalars and correlations, float64.
//   cols (C, B, M, Nseq) candidate columns per compartment (contiguous dots)
//   y    (B, Nseq)
//   G    (C, C, B, M)  output: col_i . col_j per candidate
//   Yv   (C, B, M)     output: col_i . y
void candidate_grams_f64(const double* cols, const double* y,
                         int64_t C, int64_t B, int64_t Nseq, int64_t M,
                         double* G, double* Yv) {
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t b = 0; b < B; ++b) {
        for (int64_t m = 0; m < M; ++m) {
            const double* yb = y + b * Nseq;
            for (int64_t ci = 0; ci < C; ++ci) {
                const double* a = cols + ((ci * B + b) * M + m) * Nseq;
                double sy = 0.0;
                for (int64_t i = 0; i < Nseq; ++i) sy += a[i] * yb[i];
                Yv[(ci * B + b) * M + m] = sy;
                for (int64_t cj = ci; cj < C; ++cj) {
                    const double* bc = cols + ((cj * B + b) * M + m) * Nseq;
                    double s = 0.0;
                    for (int64_t i = 0; i < Nseq; ++i) s += a[i] * bc[i];
                    G[((ci * C + cj) * B + b) * M + m] = s;
                    G[((cj * C + ci) * B + b) * M + m] = s;
                }
            }
        }
    }
}

}  // extern "C"
