// Banded two-valued Viterbi decode for NVIDIA Hopper (sm_90a).
//
// Replaces shennong_tpu/ops/viterbi.py:133, viterbi_banded_obs_batch,
// which is a lax.scan and not a Pallas kernel: the whole slice decode of
// CREPE pitch in its decode='device' mode. The wrapper is
// viterbi_banded_obs_batch in shennong_tpu_torch/ops/viterbi.py.
//
// For each row b, with n = clamp(nframes[b], 1, T), u the uniform
// weight, g = self - uniform (both rounded to float32 by the wrapper) and
// pad(score) the state row with -3e38 on hw states each side:
//   frame 0:      score[j] = (log_start[j] + u) + (j == obs[b,0] ? g : 0)
//   frame t < n:  best[j]  = max over d of pad(score)[j + d] + band[j, d],
//                            the first maximum in ascending d (rel[j] = d)
//                 new[j]   = (best[j] + u) + (j == obs[b,t] ? g : 0)
//                 score    = new - max over j of new
//   frames at or past n keep the score and point back to the same state,
//   so path[n-1 .. T-1] = argmax score (the first maximum), and
//   path[t-1] = path[t] - hw + rel_t[path[t]] for t = n-1 down to 1.
//
// Rounding: every add is one rounded float32 add (__fadd_rn, and the
// file is built with -fmad=false); adding g or 0 and the maxima are
// exact, so scores, back-pointers and paths are bit-equal to the plain
// version.
//
// What bounds it: a row is a chain of T dependent frames. Its operations
// (2 W S a frame) and its bytes (the observations in, the path out) are
// tiny next to the card's rates, so the time is the latency of one frame
// times T. The design keeps that step short: one block per row and one
// thread per state; the padded state row lives in shared memory,
// double-buffered, so a frame costs two barriers; the band is kept
// transposed in shared memory so that neighbouring threads read
// neighbouring words; the next frame's observation is loaded one frame
// ahead; back-pointers go out as int8 ([B, T, S], coalesced). The
// backtrace is one warp's argmax and then one thread's chain of dependent
// loads from L2.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr float kPad = -3e38f;

__global__ void banded_viterbi_kernel(
    const int32_t* __restrict__ obs, const int32_t* __restrict__ nframes,
    const float* __restrict__ log_start, const float* __restrict__ band,
    float uniform, float gain, int T, int S, int W,
    int8_t* __restrict__ back, int32_t* __restrict__ path) {
  extern __shared__ float smem[];
  const int hw = (W - 1) / 2;
  const int P = S + 2 * hw;        // a padded state row
  float* band_t = smem;            // [W, S]
  float* rows = band_t + W * S;    // [2, P], double-buffered
  float* warp_max = rows + 2 * P;  // [blockDim.x / 32]

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int nwarps = blockDim.x / kWarp;
  const int32_t* o = obs + static_cast<size_t>(b) * T;
  int8_t* bp = back + static_cast<size_t>(b) * T * S;
  int32_t* out = path + static_cast<size_t>(b) * T;
  const int n = min(max(nframes[b], 1), T);
  const bool live = j < S;

  for (int i = j; i < W * S; i += blockDim.x) {
    const int d = i / S;
    const int s = i - d * S;
    band_t[i] = band[s * W + d];
  }
  for (int i = j; i < 2 * P; i += blockDim.x) rows[i] = kPad;
  __syncthreads();
  if (live) {
    rows[hw + j] = __fadd_rn(__fadd_rn(log_start[j], uniform),
                             j == o[0] ? gain : 0.f);
  }
  __syncthreads();

  int cur = 0;
  int next_obs = n > 1 ? o[1] : 0;
  for (int t = 1; t < n; ++t) {
    const int ot = next_obs;
    if (t + 1 < n) next_obs = o[t + 1];
    float value = -CUDART_INF_F;
    if (live) {
      const float* win = rows + cur * P + j;
      float best = __fadd_rn(win[0], band_t[j]);
      int rel = 0;
      for (int d = 1; d < W; ++d) {
        const float cand = __fadd_rn(win[d], band_t[d * S + j]);
        if (cand > best) {
          best = cand;
          rel = d;
        }
      }
      bp[static_cast<size_t>(t) * S + j] = static_cast<int8_t>(rel);
      value = __fadd_rn(__fadd_rn(best, uniform), j == ot ? gain : 0.f);
    }
    float m = value;
    for (int k = kWarp / 2; k > 0; k >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, k));
    if ((j & (kWarp - 1)) == 0) warp_max[j / kWarp] = m;
    __syncthreads();
    float row_max = warp_max[0];
    for (int w = 1; w < nwarps; ++w) row_max = fmaxf(row_max, warp_max[w]);
    cur ^= 1;
    if (live) rows[cur * P + hw + j] = __fsub_rn(value, row_max);
    __syncthreads();
  }

  if (j >= kWarp) return;
  // the first maximum of the final scores: each lane its first maximum
  // over its states, then the larger value or, on a tie, the lower state
  const float* last = rows + cur * P + hw;
  float best = -CUDART_INF_F;
  int state = S;
  for (int s = j; s < S; s += kWarp) {
    if (last[s] > best) {
      best = last[s];
      state = s;
    }
  }
  for (int k = kWarp / 2; k > 0; k >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, best, k);
    const int other_state = __shfl_xor_sync(0xffffffffu, state, k);
    if (other > best || (other == best && other_state < state)) {
      best = other;
      state = other_state;
    }
  }
  if (j != 0) return;
  for (int t = T - 1; t >= n - 1; --t) out[t] = state;
  for (int t = n - 1; t >= 1; --t) {
    state = state - hw + bp[static_cast<size_t>(t) * S + state];
    out[t - 1] = state;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for S states and band width W.
size_t shennong_banded_viterbi_smem(int S, int W) {
  const int hw = (W - 1) / 2;
  const size_t words = static_cast<size_t>(W) * S + 2 * (S + 2 * hw) +
                       (S + kWarp - 1) / kWarp;
  return words * sizeof(float);
}

// obs [B, T] int32, nframes [B] int32, log_start [S] float32, band
// [S, W] float32 (band[j*W + d] = log_trans[j - hw + d, j]) -> path
// [B, T] int32; back [B, T, S] int8 is scratch. Launches on `stream`;
// returns the CUDA error code of the launch.
int shennong_banded_viterbi(const int32_t* obs, const int32_t* nframes,
                            const float* log_start, const float* band,
                            float uniform, float gain, int B, int T, int S,
                            int W, int8_t* back, int32_t* path,
                            void* stream) {
  const size_t smem = shennong_banded_viterbi_smem(S, W);
  cudaError_t err = cudaFuncSetAttribute(
      banded_viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (S + kWarp - 1) / kWarp * kWarp;
  banded_viterbi_kernel<<<B, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      obs, nframes, log_start, band, uniform, gain, T, S, W, back, path);
  return static_cast<int>(cudaGetLastError());
}

const char* shennong_banded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
