// Banded Viterbi decoding (float64), the hot loop of the CREPE pitch
// smoothing and voicing decisions (shennong_tpu_torch/ops/viterbi.py).
//
// Replaces the reference's hmmlearn decoder (reference call sites
// shennong/processor/pitch_crepe.py:233-243 and :275-291).
// Bit-identical to the numpy banded decoder: per (to, d) candidate the
// same two float64 additions are performed (no reassociation), the
// argmax keeps the first maximum (strict '>' comparison, candidates
// scanned in ascending source order), and out-of-range candidates
// carry -inf weights.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// obs_at(t, j) returns the log observation weight of state j at
// frame t; dense and two-valued variants share this core.
template <typename ObsFn>
long long viterbi_banded_impl(
        const double* log_start, const double* band, ObsFn obs_at,
        long long T, long long S, long long W, int64_t* path_out) {
    if (T <= 0 || S <= 0 || W <= 0 || W % 2 == 0 || W > 127)
        return -1;
    const long long hw = (W - 1) / 2;
    const double ninf = -std::numeric_limits<double>::infinity();

    std::vector<double> score(S), next(S);
    // padded score buffer so every window read is in range
    std::vector<double> padded(S + 2 * hw, ninf);
    std::vector<int8_t> back((size_t)T * S);

    // band transposed to [W, S]: the recursion then runs d-outer /
    // state-inner, W contiguous passes of length S that the compiler
    // vectorizes (the j-outer form reduces over W = 23 strided
    // elements per state and ran ~4x slower). Same additions, and
    // first-strictly-greater updates in ascending d keep numpy's
    // first-maximum argmax tie-break.
    std::vector<double> band_t((size_t)W * S);
    for (long long j = 0; j < S; ++j)
        for (long long d = 0; d < W; ++d)
            band_t[(size_t)d * S + j] = band[j * W + d];
    // argmax-so-far per state, kept as doubles so the update loop
    // stays a pure blend (d <= 126 is exact in float64)
    std::vector<double> best(S), bestd(S);

    for (long long j = 0; j < S; ++j)
        score[j] = log_start[j] + obs_at(0, j);

    for (long long t = 1; t < T; ++t) {
        std::memcpy(padded.data() + hw, score.data(),
                    S * sizeof(double));
        int8_t* bt = back.data() + (size_t)t * S;
        double* __restrict bst = best.data();
        double* __restrict bsd = bestd.data();
        {
            const double* __restrict win = padded.data();
            const double* __restrict bnd = band_t.data();
            for (long long j = 0; j < S; ++j) {
                bst[j] = win[j] + bnd[j];
                bsd[j] = 0.0;
            }
        }
        for (long long d = 1; d < W; ++d) {
            const double* __restrict win = padded.data() + d;
            const double* __restrict bnd = band_t.data() + d * S;
            const double dv = (double)d;
            for (long long j = 0; j < S; ++j) {
                const double cand = win[j] + bnd[j];
                const double b = bst[j];
                bsd[j] = cand > b ? dv : bsd[j];
                bst[j] = cand > b ? cand : b;
            }
        }
        for (long long j = 0; j < S; ++j) {
            bt[j] = (int8_t)bsd[j];
            next[j] = bst[j] + obs_at(t, j);
        }
        score.swap(next);
    }

    long long last = 0;
    for (long long j = 1; j < S; ++j)
        if (score[j] > score[last]) last = j;
    path_out[T - 1] = last;
    for (long long t = T - 2; t >= 0; --t) {
        long long nxt = path_out[t + 1];
        path_out[t] = nxt - hw + back[(size_t)(t + 1) * S + nxt];
    }
    return 0;
}

}  // namespace

extern "C" {

// log_start [S], band [S, W] (band[j*W + d] = log_trans[j - hw + d, j],
// -inf outside), log_obs [T, S]; writes the most likely state path
// into path_out [T]. W must be odd (hw = (W - 1) / 2).
// Returns 0 on success, -1 on invalid arguments.
long long shennong_viterbi_banded(
        const double* log_start, const double* band,
        const double* log_obs, long long T, long long S, long long W,
        int64_t* path_out) {
    return viterbi_banded_impl(
        log_start, band,
        [log_obs, S](long long t, long long j) {
            return log_obs[t * S + j];
        },
        T, S, W, path_out);
}

// Two-valued observation model (the CREPE smoothing prior): state j
// at frame t weighs self_weight when j == obs[t], uniform_weight
// otherwise. Avoids materializing the [T, S] observation matrix.
long long shennong_viterbi_banded_two(
        const double* log_start, const double* band,
        double uniform_weight, double self_weight, const int32_t* obs,
        long long T, long long S, long long W, int64_t* path_out) {
    return viterbi_banded_impl(
        log_start, band,
        [obs, uniform_weight, self_weight](long long t, long long j) {
            return obs[t] == j ? self_weight : uniform_weight;
        },
        T, S, W, path_out);
}

}  // extern "C"
