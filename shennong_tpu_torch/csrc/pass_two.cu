// Pass 2 of the extraction pipeline over a packed group of utterances:
// CMVN, deltas and the pitch concatenation, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: pass 2 is host code in both packages (the JAX
// package's shennong_tpu/pipeline.py, _batched_pass_two, numpy and one XLA
// program per frame bucket for the deltas). It was added because on the
// H100 the port's per-utterance numpy pass 2 was the largest block of an
// extraction call while the card sat idle (PERF.md). The wrapper is
// pass_two in shennong_tpu_torch/ops/pass_two.py.
//
// Input, U utterances packed without padding: feats [N, D] (float or
// double), the rows of utterance u at layout[u].feat_off, layout[u].frames
// of them; pitch [R, P] (the output's type, already trimmed, at the
// output's rows); the CMVN affine scale, offset [G, D] float64 and each
// utterance's row of it (layout[u].group). Output rows [R, C], C =
// (order + 1) * D + P, utterance u's layout[u].rows of them at
// layout[u].out_off:
//   c = cmvn ? x * scale + offset : x                 (float64, per column)
//   without deltas:  out[t, d] = (In) c              (the features' type)
//   with deltas:     v = (float) c, and for order k, d < D,
//     out[t, k D + d] = sum_j coeff_k[j] * v[clamp(t + j - k w, 0, T - 1), d]
//   then the pitch columns, out[t, (order + 1) D + p] = pitch[t, p].
// coeff_k are Kaldi's delta scales (ops/postops.py, delta_scales: 2 k w + 1
// of them, order k's at k + w k (k - 1) in coeffs). Each order is summed in
// float32 in the order of j, the first term stored, as compute_deltas_host
// does, over the untrimmed frames T of the utterance; the output keeps its
// first layout[u].rows of them. Rounding: __dmul_rn, __dadd_rn,
// __fmul_rn, __fadd_rn and round-to-nearest conversions (the file is also
// built with -fmad=false), so the bits are numpy's.
//
// nonfinite counts the CMVN values (c in the features' type) that are not
// finite over every frame of every utterance, where Features.validate
// raised on the per-utterance route.
//
// What bounds it: bytes and the launch. A test_clean CMVN group (65
// utterances, 48,464 frames, D = 13, P = 3, order 2) reads 2.5 MB of
// features and 0.6 MB of pitch and writes 8.1 MB of rows: 3.4 us at 3.35
// TB/s, below a launch. The design:
// - a block owns a tile of up to tile_rows frames of one utterance (tiles
//   never cross utterances; a block finds its utterance by a binary search
//   of tile_off), so its halo clamps at that utterance's edges;
// - each tap of a delta reads its CMVN'd value from device memory (the
//   rows of a tile and its order * window halo stay in L1/L2 across the
//   taps; a test_clean group is 11 MB) and recomputes its CMVN, the same
//   arithmetic as the owned frame's;
// - it writes its tile's output rows whole, consecutive threads on
//   consecutive words of the rows;
// - the 2 D doubles of the affine come through the read-only cache.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Utterance {
  long long feat_off, frames, out_off, rows, group;
};

__device__ __forceinline__ float to_float(double c) {
  return __double2float_rn(c);
}

template <typename In>
__device__ __forceinline__ bool finite_as(double c);

template <>
__device__ __forceinline__ bool finite_as<float>(double c) {
  return isfinite(__double2float_rn(c));
}

template <>
__device__ __forceinline__ bool finite_as<double>(double c) {
  return isfinite(c);
}

template <typename In>
__device__ __forceinline__ double cmvn(
    const In* __restrict__ feats, const double* __restrict__ scale,
    const double* __restrict__ offset, long long row, int d, int D,
    long long group) {
  const double x = static_cast<double>(feats[row * D + d]);
  if (scale == nullptr) return x;
  return __dadd_rn(__dmul_rn(x, __ldg(scale + group * D + d)),
                   __ldg(offset + group * D + d));
}

template <typename In>
__device__ __forceinline__ In as_input(double c);

template <>
__device__ __forceinline__ float as_input<float>(double c) {
  return __double2float_rn(c);
}

template <>
__device__ __forceinline__ double as_input<double>(double c) {
  return c;
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads) pass_two_kernel(
    const In* __restrict__ feats, const Out* __restrict__ pitch,
    const Utterance* __restrict__ layout, const int* __restrict__ tile_off,
    int U, const double* __restrict__ scale, const double* __restrict__ offset,
    const float* __restrict__ coeffs, int D, int P, int order, int window,
    int tile_rows, Out* __restrict__ out,
    unsigned long long* __restrict__ nonfinite) {
  // the utterance of this tile: the last u with tile_off[u] <= tile
  const int tile = blockIdx.x;
  int lo = 0, hi = U - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_off[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const Utterance utt = layout[lo];
  const long long t0 = static_cast<long long>(tile - tile_off[lo]) * tile_rows;
  // the frames this tile owns, and the output rows among them
  const int own = static_cast<int>(min(static_cast<long long>(tile_rows),
                                       utt.frames - t0));
  const int nout = static_cast<int>(
      max(0LL, min(static_cast<long long>(own), utt.rows - t0)));
  const bool deltas = coeffs != nullptr;
  const long long last = utt.frames - 1;

  // the non-finite CMVN values of the owned frames
  unsigned long long bad = 0;
  if (scale != nullptr) {
    for (int e = threadIdx.x; e < own * D; e += blockDim.x) {
      const int i = e / D, d = e - i * D;
      bad += !finite_as<In>(cmvn(feats, scale, offset, utt.feat_off + t0 + i,
                                 d, D, utt.group));
    }
  }
  if (bad) atomicAdd(nonfinite, bad);

  const int width = (order + 1) * D;
  const int C = width + P;
  Out* dst = out + (utt.out_off + t0) * C;
  const Out* src_pitch = pitch + (utt.out_off + t0) * P;
  for (int e = threadIdx.x; e < nout * C; e += blockDim.x) {
    const int r = e / C, col = e - r * C;
    Out value;
    if (col >= width) {
      value = src_pitch[r * P + (col - width)];
    } else if (!deltas) {
      value = static_cast<Out>(as_input<In>(cmvn(
          feats, scale, offset, utt.feat_off + t0 + r, col, D, utt.group)));
    } else {
      const int k = col / D, d = col - k * D;
      const float* coeff = coeffs + k + window * k * (k - 1);
      const int taps = 2 * k * window + 1;
      float acc = 0.0f;
      for (int j = 0; j < taps; ++j) {
        // the tap's frame, t0 + r + j - k * window, clamped to the utterance
        const long long frame = min(
            max(t0 + r + j - static_cast<long long>(k) * window, 0LL), last);
        const float v = to_float(cmvn(feats, scale, offset,
                                      utt.feat_off + frame, d, D, utt.group));
        const float term = __fmul_rn(v, __ldg(coeff + j));
        acc = j ? __fadd_rn(acc, term) : term;
      }
      value = static_cast<Out>(acc);
    }
    dst[e] = value;
  }
}

template <typename In, typename Out>
cudaError_t launch(const void* feats, const void* pitch,
                   const Utterance* layout, const int* tile_off, int U,
                   int tiles, const double* scale, const double* offset,
                   const float* coeffs, int D, int P, int order, int window,
                   int tile_rows, void* out, unsigned long long* nonfinite,
                   cudaStream_t stream) {
  pass_two_kernel<In, Out><<<tiles, kThreads, 0, stream>>>(
      static_cast<const In*>(feats), static_cast<const Out*>(pitch), layout,
      tile_off, U, scale, offset, coeffs, D, P, order, window, tile_rows,
      static_cast<Out*>(out), nonfinite);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over a packed group (see the top of the file), on `stream`.
// feats_double, out_double: the types of feats and of pitch and out (0
// float32, 1 float64). layout [U] of {feat_off, frames, out_off, rows,
// group} (int64), tile_off [U + 1] (int32): utterance u owns tiles
// [tile_off[u], tile_off[u + 1]), ceil(frames / tile_rows) of them, and
// tiles = tile_off[U]. scale and offset are null without CMVN, coeffs
// null without deltas (order is then 0). nonfinite (one uint64) is
// zeroed here, then counted. Returns the CUDA error code of the launch.
int shennong_pass_two(const void* feats, int feats_double, const void* pitch,
                      int out_double, const void* layout,
                      const int* tile_off, int U, int tiles,
                      const double* scale, const double* offset,
                      const float* coeffs, int D, int P, int order,
                      int window, int tile_rows, void* out,
                      unsigned long long* nonfinite, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(nonfinite, 0, sizeof(*nonfinite), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles == 0) return 0;
  const Utterance* utts = static_cast<const Utterance*>(layout);
  if (feats_double && out_double)
    err = launch<double, double>(feats, pitch, utts, tile_off, U, tiles,
                                 scale, offset, coeffs, D, P, order, window,
                                 tile_rows, out, nonfinite, s);
  else if (feats_double)  // the output holds the features' type
    err = cudaErrorInvalidValue;
  else if (out_double)
    err = launch<float, double>(feats, pitch, utts, tile_off, U, tiles, scale,
                                offset, coeffs, D, P, order, window,
                                tile_rows, out, nonfinite, s);
  else
    err = launch<float, float>(feats, pitch, utts, tile_off, U, tiles, scale,
                               offset, coeffs, D, P, order, window, tile_rows,
                               out, nonfinite, s);
  return static_cast<int>(err);
}

const char* shennong_pass_two_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
