// Incremental clustering hot loop — native C++ port of the reference's
// sequential (deterministic) scan semantics (clustering.rs:547-910):
//   - first row creates the first centroid;
//   - new centroid iff n_c < max_clusters and d2 > radius*0.5;
//   - running-mean assignment iff d2 <= radius;
//   - soft-outlier assignment (no centroid move) iff d2 <= radius*1.5
//     after saturation; otherwise drop.
//
// Sampling keep-decisions arrive as a precomputed byte mask (or NULL when
// sampling is disabled); the RNG and its stats stay on the Python side.
//
// arrowspace_torch's own copy of the JAX package's native scan (the two
// packages share no code).  Built at first use by
// arrowspace_torch/native/__init__.py with the host C++ compiler:
//   $CXX -O3 -march=native -fPIC -std=c++17 -ffp-contract=off -shared
// -ffp-contract=off keeps every distance a sum of rounded squares: no
// product is fused into its accumulation, so the scan's decisions do not
// depend on the target's FMA units.

#include <cmath>
#include <cstdint>
#include <limits>

namespace {

// Squared Euclidean distance with 8 independent accumulators: the inner
// FP reduction is the hot op (O(N * X * F) over the whole scan) and a
// single sequential accumulator blocks autovectorization (gcc will not
// reassociate FP sums without -ffast-math).  Spelling the reassociation
// out in source keeps the numerics deterministic and portable while
// letting the compiler map the accumulators onto SIMD lanes (~4-6x on
// AVX2 at F>=32).
inline double dist2(const double* a, const double* b, long long f) {
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
    double a4 = 0.0, a5 = 0.0, a6 = 0.0, a7 = 0.0;
    long long j = 0;
    for (; j + 8 <= f; j += 8) {
        const double d0 = a[j] - b[j];
        const double d1 = a[j + 1] - b[j + 1];
        const double d2 = a[j + 2] - b[j + 2];
        const double d3 = a[j + 3] - b[j + 3];
        const double d4 = a[j + 4] - b[j + 4];
        const double d5 = a[j + 5] - b[j + 5];
        const double d6 = a[j + 6] - b[j + 6];
        const double d7 = a[j + 7] - b[j + 7];
        a0 += d0 * d0; a1 += d1 * d1; a2 += d2 * d2; a3 += d3 * d3;
        a4 += d4 * d4; a5 += d5 * d5; a6 += d6 * d6; a7 += d7 * d7;
    }
    double acc = ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
    for (; j < f; ++j) {
        const double d = a[j] - b[j];
        acc += d * d;
    }
    return acc;
}

}  // namespace

extern "C" {

// Returns the number of centroids created (<= max_clusters), or 0 if no
// clusters were created (caller raises, matching clustering.rs:869-877).
long long incremental_clustering(
    const double* rows,      // n * f, row-major
    long long n,
    long long f,
    long long max_clusters,
    double radius,
    const unsigned char* keep_mask,  // n entries or NULL
    double* out_centroids,   // max_clusters * f
    long long* out_counts,   // max_clusters
    long long* out_assign    // n, -1 encodes dropped/skipped
);

// Density-adaptive variant (sampling.rs:190-225): the keep decision
// depends on the evolving cluster state, so uniforms are precomputed by
// the (seeded) Python RNG — one per row, consumed in row order, matching
// the sequential Python path exactly — and the adaptive rate
//   base·(1 - 0.1·saturation)·(1 + 0.3·max(0, ln(d² + 0.1)))
// clamped to [0.01, 1] is evaluated in-loop.  out_kept reports the
// number of kept rows for the sampler's statistics.
long long incremental_clustering_density(
    const double* rows, long long n, long long f, long long max_clusters,
    double radius, const double* uniforms, double base_rate,
    double* out_centroids, long long* out_counts, long long* out_assign,
    long long* out_kept);

long long incremental_clustering(
    const double* rows,      // n * f, row-major
    long long n,
    long long f,
    long long max_clusters,
    double radius,
    const unsigned char* keep_mask,  // n entries or NULL
    double* out_centroids,   // max_clusters * f
    long long* out_counts,   // max_clusters
    long long* out_assign    // n, -1 encodes dropped/skipped
) {
    long long n_c = 0;
    const double relaxed_radius = radius * 1.5;

    for (long long r = 0; r < n; ++r) {
        const double* row = rows + r * f;
        out_assign[r] = -1;

        // keep-decision already made by the (Python-side) sampler; skipped
        // rows never touch cluster state, so the distance scan is elided
        if (keep_mask != nullptr && !keep_mask[r]) continue;

        // nearest centroid over the current state (sequential scan: the
        // snapshot and the current state coincide)
        long long best_idx = 0;
        double best_d2 = std::numeric_limits<double>::infinity();
        for (long long c = 0; c < n_c; ++c) {
            const double d2 = dist2(row, out_centroids + c * f, f);
            if (d2 < best_d2) { best_d2 = d2; best_idx = c; }
        }

        if (n_c == 0) {
            double* cent = out_centroids;
            for (long long j = 0; j < f; ++j) cent[j] = row[j];
            out_counts[0] = 1;
            out_assign[r] = 0;
            n_c = 1;
            continue;
        }

        if (n_c < max_clusters && best_d2 > radius * 0.5) {
            double* cent = out_centroids + n_c * f;
            for (long long j = 0; j < f; ++j) cent[j] = row[j];
            out_counts[n_c] = 1;
            out_assign[r] = n_c;
            ++n_c;
        } else if (best_d2 <= radius) {
            double* cent = out_centroids + best_idx * f;
            const double k_new = static_cast<double>(out_counts[best_idx] + 1);
            for (long long j = 0; j < f; ++j) {
                cent[j] += (row[j] - cent[j]) / k_new;
            }
            out_counts[best_idx] += 1;
            out_assign[r] = best_idx;
        } else if (best_d2 <= relaxed_radius) {
            // soft outlier: counted, centroid unchanged (eta = 0)
            out_counts[best_idx] += 1;
            out_assign[r] = best_idx;
        }
        // else: drop
    }

    return n_c;
}

long long incremental_clustering_density(
    const double* rows, long long n, long long f, long long max_clusters,
    double radius, const double* uniforms, double base_rate,
    double* out_centroids, long long* out_counts, long long* out_assign,
    long long* out_kept) {
    long long n_c = 0;
    long long kept = 0;
    const double relaxed_radius = radius * 1.5;

    for (long long r = 0; r < n; ++r) {
        const double* row = rows + r * f;
        out_assign[r] = -1;

        long long best_idx = 0;
        double best_d2 = std::numeric_limits<double>::infinity();
        for (long long c = 0; c < n_c; ++c) {
            const double d2 = dist2(row, out_centroids + c * f, f);
            if (d2 < best_d2) { best_d2 = d2; best_idx = c; }
        }

        // adaptive keep rate from the snapshot distance + saturation
        const double saturation = max_clusters > 0
            ? static_cast<double>(n_c) / static_cast<double>(max_clusters)
            : 0.0;
        double dist_factor = 0.0;
        if (std::isfinite(best_d2)) {
            const double lf = std::log(best_d2 + 0.1);
            dist_factor = lf > 0.0 ? lf : 0.0;
        }
        double rate = base_rate * (1.0 - saturation * 0.1)
            * (1.0 + dist_factor * 0.3);
        if (rate < 0.01) rate = 0.01;
        if (rate > 1.0) rate = 1.0;
        if (!(uniforms[r] < rate)) continue;
        ++kept;

        if (n_c == 0) {
            double* cent = out_centroids;
            for (long long j = 0; j < f; ++j) cent[j] = row[j];
            out_counts[0] = 1;
            out_assign[r] = 0;
            n_c = 1;
            continue;
        }

        if (n_c < max_clusters && best_d2 > radius * 0.5) {
            double* cent = out_centroids + n_c * f;
            for (long long j = 0; j < f; ++j) cent[j] = row[j];
            out_counts[n_c] = 1;
            out_assign[r] = n_c;
            ++n_c;
        } else if (best_d2 <= radius) {
            double* cent = out_centroids + best_idx * f;
            const double k_new = static_cast<double>(out_counts[best_idx] + 1);
            for (long long j = 0; j < f; ++j) {
                cent[j] += (row[j] - cent[j]) / k_new;
            }
            out_counts[best_idx] += 1;
            out_assign[r] = best_idx;
        } else if (best_d2 <= relaxed_radius) {
            out_counts[best_idx] += 1;
            out_assign[r] = best_idx;
        }
    }

    *out_kept = kept;
    return n_c;
}

// Certified-snapshot block scan: EXACT sequential semantics at GEMM
// speed (the one-shot scan is O(n*X*F) scalar work on one core).  The
// caller (arrowspace_torch/native/__init__.py) computes snapshot
// distances for a block of rows with multi-core BLAS and passes, per
// row, the snapshot argmin `bidx` and the sqrt of the best/second-best
// snapshot distances (s1 unused by the math, kept for diagnostics; s2
// feeds the certificate).  This function then replays the reference's
// sequential rules row by row, but instead of scanning all centroids it
// computes ONE exact distance to the snapshot-best centroid's CURRENT
// position and certifies optimality with a drift bound:
//
//   a running-mean update moves centroid j by exactly sqrt(e)/k_new, so
//   accumulating m[j] (and m_max over snapshot centroids) bounds every
//   centroid's travel since the snapshot; any j != bidx satisfies
//   cur_d(j) >= (s2_safe - m_max)^2, where s2_safe subtracts the
//   caller's bound on BLAS summation error.  If the exact distance to
//   bidx beats that bound, bidx is provably the nearest OLD centroid;
//   otherwise the row falls back to a full exact scan (correct either
//   way — the certificate only chooses the cheap path, never the
//   result).  Centroids created after the snapshot are always checked
//   exactly.  All accepted distances come from the same dist2() as the
//   one-shot scan, so decisions, running means, assignments and
//   centroids are BIT-IDENTICAL to incremental_clustering[_density].
//
// Returns the number of rows CONSUMED from the block: the scan stops
// early (for the caller to re-snapshot) once enough new centroids
// accumulate that the exact new-centroid loop erodes the win.
long long incremental_clustering_certified_block(
    const double* rows_block, long long bn, long long f,
    const double* s2_safe,    // (bn) sqrt of 2nd-best snapshot d2, safety-adjusted
    const long long* bidx,    // (bn) snapshot argmin (< n_snap)
    long long n_snap,
    long long max_clusters, double radius,
    const unsigned char* keep_mask,   // (bn) or NULL (simple sampler / none)
    const double* uniforms,           // (bn) or NULL; density mode iff set
    double base_rate,
    double* centroids, long long* counts, long long* assign_block,
    double* m_scratch,                // (max_clusters), caller-zeroed
    long long* inout_nc, long long* out_kept, long long* out_fallbacks) {
    long long n_c = *inout_nc;
    long long kept = 0;
    long long fallbacks = 0;
    const double relaxed_radius = radius * 1.5;
    const int density = uniforms != nullptr;
    double m_max = 0.0;

    long long r = 0;
    for (; r < bn; ++r) {
        // re-snapshot once the exact new-centroid loop gets long enough
        // to rival the BLAS pass it replaces
        if (n_c - n_snap >= 64 && bn - r > 256) break;

        const double* row = rows_block + r * f;
        assign_block[r] = -1;

        if (!density && keep_mask != nullptr && !keep_mask[r]) continue;

        long long best_idx = 0;
        double best_d2 = std::numeric_limits<double>::infinity();
        if (n_snap > 0) {
            const long long b = bidx[r];
            const double e_b = dist2(row, centroids + b * f, f);
            const double margin = s2_safe[r] - m_max;
            if (margin > 0.0 && e_b < margin * margin) {
                best_idx = b;
                best_d2 = e_b;
            } else {
                ++fallbacks;
                for (long long c = 0; c < n_snap; ++c) {
                    const double e = dist2(row, centroids + c * f, f);
                    if (e < best_d2) { best_d2 = e; best_idx = c; }
                }
            }
        }
        for (long long c = n_snap; c < n_c; ++c) {
            const double e = dist2(row, centroids + c * f, f);
            if (e < best_d2) { best_d2 = e; best_idx = c; }
        }

        if (density) {
            const double saturation = max_clusters > 0
                ? static_cast<double>(n_c) / static_cast<double>(max_clusters)
                : 0.0;
            double dist_factor = 0.0;
            if (std::isfinite(best_d2)) {
                const double lf = std::log(best_d2 + 0.1);
                dist_factor = lf > 0.0 ? lf : 0.0;
            }
            double rate = base_rate * (1.0 - saturation * 0.1)
                * (1.0 + dist_factor * 0.3);
            if (rate < 0.01) rate = 0.01;
            if (rate > 1.0) rate = 1.0;
            if (!(uniforms[r] < rate)) continue;
            ++kept;
        }

        if (n_c == 0) {
            for (long long j = 0; j < f; ++j) centroids[j] = row[j];
            counts[0] = 1;
            assign_block[r] = 0;
            n_c = 1;
            continue;
        }

        if (n_c < max_clusters && best_d2 > radius * 0.5) {
            double* cent = centroids + n_c * f;
            for (long long j = 0; j < f; ++j) cent[j] = row[j];
            counts[n_c] = 1;
            assign_block[r] = n_c;
            ++n_c;
        } else if (best_d2 <= radius) {
            double* cent = centroids + best_idx * f;
            const double k_new = static_cast<double>(counts[best_idx] + 1);
            for (long long j = 0; j < f; ++j) {
                cent[j] += (row[j] - cent[j]) / k_new;
            }
            counts[best_idx] += 1;
            assign_block[r] = best_idx;
            if (best_idx < n_snap) {
                m_scratch[best_idx] += std::sqrt(best_d2) / k_new;
                if (m_scratch[best_idx] > m_max) m_max = m_scratch[best_idx];
            }
        } else if (best_d2 <= relaxed_radius) {
            counts[best_idx] += 1;
            assign_block[r] = best_idx;
        }
    }

    *inout_nc = n_c;
    *out_kept = kept;
    *out_fallbacks += fallbacks;
    return r;
}

}  // extern "C"
