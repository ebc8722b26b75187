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
// Rounding: every add is one rounded float32 add (__fadd_rn, __fsub_rn;
// the file is built with -fmad=false); adding g or 0 and the maxima are
// exact, so scores, back-pointers and paths are bit-equal to the plain
// version.
//
// What bounds it: a row is a chain of n dependent frames. Its operations
// (about 2 W S a frame) and its bytes (the observations in, the path out)
// are tiny next to the card's rates, so the time is one frame's latency
// times n. A frame is instruction issue: a state's first maximum over W = 23
// candidates is 23 adds and about 57 compares and selects, which issue at
// half rate, so a warp of 3 states a thread needs some 400 cycles a frame
// before any wait. The design keeps the waits few and the issue straight:
// - one block per row, K contiguous states a thread: K = 3 and four warps,
//   one a scheduler, for CREPE's 360 states. A thread's K x 23 band entries
//   (halfwidth 11) live in registers for the whole row;
// - the row goes through shared memory unnormalized, and the warps' maxima
//   (one redux.sync each) in the same phase, so one barrier a frame serves
//   both. Each thread then loads its K + 2 hw window first (lanes K words
//   apart: no bank conflicts), reads the warp maxima with four 16-byte
//   loads, and applies the same rounded subtraction, score = new - max,
//   that the plain version makes. The pad stays -3e38 because -3e38 - max
//   rounds back to -3e38 whenever |max| < 1e31; a block-uniform test
//   restores it otherwise;
// - the first maximum over the band is a tree of depth 5 (ties keep the
//   lower d), and all K states run without a branch: a slot past S stores
//   the pad and its back-pointer lands in the frame's slack bytes, so the
//   compiler interleaves the K trees;
// - the observation of each frame comes from a register of the warp,
//   loaded 32 frames at a time and one chunk ahead;
// - back-pointers go to two tiles of frames in shared memory (int8), so the
//   backtrace walks shared memory. A row longer than two tiles spills the
//   older tile to device memory with 16-byte stores when the next but one
//   starts, and the backtrace loads each spilled tile with cp.async while
//   it walks the tile after it.
// A halfwidth other than 11, or more than 512 states, takes the generic
// instantiation: the window is read from shared memory and the band from
// device memory for each candidate.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPad = -3e38f;
constexpr int kMaxWarps = 32;
// the halfwidth whose band lives in registers (the CREPE smoothing prior)
constexpr int kStaticHalfwidth = 11;
// most dynamic shared memory of a block on sm_90
constexpr size_t kSmemLimit = 232448;

// Floats mapped to unsigned ints of the same order (finite or inf).
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The largest of a row of warp keys: four 16-byte reads cover the 16 warps
// a block has at most (the slots past its warps hold the key of -inf), with
// no loop and no branch.
__device__ __forceinline__ unsigned max_key(const unsigned* row) {
  const uint4* quad = reinterpret_cast<const uint4*>(row);
  unsigned key = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint4 v = quad[w];
    key = max(key, max(max(v.x, v.y), max(v.z, v.w)));
  }
  return key;
}

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_address(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_async_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first maximum of c[LO, LO + N): the value and its index. A tree:
// of two halves, the upper one wins only when strictly greater.
template <int LO, int N, int SIZE>
__device__ __forceinline__ void first_max(const float (&c)[SIZE], float& v,
                                          int& i) {
  if constexpr (N == 1) {
    v = c[LO];
    i = LO;
  } else {
    float va, vb;
    int ia, ib;
    first_max<LO, N / 2>(c, va, ia);
    first_max<LO + N / 2, N - N / 2>(c, vb, ib);
    const bool upper = vb > va;
    v = upper ? vb : va;
    i = upper ? ib : ia;
  }
}

// Most threads of a block of an instantiation (bounds its registers).
template <int K, int HW>
constexpr int max_threads() {
  return HW == 0 ? 128 : (K == 1 ? 512 : (K == 2 ? 256 : 128));
}

// Shared memory: four rows of warp keys, the padded state rows (two,
// alternating), then two tiles of back-pointer frames. A frame of
// back-pointers has a byte for every state slot of the block (K x threads,
// S of them real), so the slots past S store without a branch.
struct Layout {
  int row;    // floats of a padded state row, a multiple of 4
  int spad;   // bytes of a back-pointer frame, a multiple of 16
  size_t fixed() const { return (4 * kMaxWarps + 2 * row) * sizeof(float); }
};

__host__ __device__ inline Layout layout(int K, int threads, int hw) {
  return {(K * threads + 2 * hw + 3) / 4 * 4, (K * threads + 15) / 16 * 16};
}

template <int K, int HW>
__global__ void __launch_bounds__(max_threads<K, HW>())
    banded_viterbi_kernel(const int32_t* __restrict__ obs,
                          const int32_t* __restrict__ nframes,
                          const float* __restrict__ log_start,
                          const float* __restrict__ band, float uniform,
                          float gain, int T, int S, int hw_arg, int tile,
                          int8_t* __restrict__ spill,
                          int32_t* __restrict__ path, int forward_only) {
  constexpr bool kStatic = HW > 0;
  const int hw = kStatic ? HW : hw_arg;
  const int W = 2 * hw + 1;
  const int threads = blockDim.x;
  const int nwarps = threads / kWarp;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  const Layout lay = layout(K, threads, hw);

  extern __shared__ __align__(16) unsigned char smem[];
  // keys[0..1]: the warps' maxima of the row in each state buffer;
  // keys[2..3]: the final argmax's reductions
  unsigned* keys = reinterpret_cast<unsigned*>(smem);
  float* rows = reinterpret_cast<float*>(keys + 4 * kMaxWarps);
  int8_t* tiles = reinterpret_cast<int8_t*>(rows + 2 * lay.row);
  const size_t tile_bytes = static_cast<size_t>(tile) * lay.spad;

  const int b = blockIdx.x;
  const int n = min(max(nframes[b], 1), T);
  const int32_t* o = obs + static_cast<size_t>(b) * T;
  int32_t* out = path + static_cast<size_t>(b) * T;
  const int ntiles = (T + tile - 1) / tile;
  int8_t* spilled = spill ? spill + static_cast<size_t>(b) * ntiles * tile_bytes
                          : nullptr;
  const int j0 = K * tid;  // this thread's first state

  for (int i = tid; i < 2 * lay.row; i += threads) rows[i] = kPad;
  for (int i = tid; i < 4 * kMaxWarps; i += threads)
    keys[i] = ordered(-CUDART_INF_F);
  float band_r[kStatic ? K : 1][kStatic ? 2 * HW + 1 : 1];
  if constexpr (kStatic) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = min(j0 + k, S - 1);
#pragma unroll
      for (int d = 0; d < 2 * HW + 1; ++d) band_r[k][d] = band[j * W + d];
    }
  }
  // the observations, 32 frames a warp register, one chunk ahead
  int obs_cur = lane < T ? o[lane] : 0;
  int obs_next = kWarp + lane < T ? o[kWarp + lane] : 0;
  __syncthreads();
  {
    const int first = __shfl_sync(kFull, obs_cur, 0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      if (j < S) {
        rows[hw + j] = __fadd_rn(__fadd_rn(log_start[j], uniform),
                                 j == first ? gain : 0.f);
      }
    }
  }
  __syncthreads();

  int slot = 0, tile_k = 0;  // frame t's place among the tiles
  for (int t = 1; t < n; ++t) {
    if ((t & (kWarp - 1)) == 0) {
      obs_cur = obs_next;
      const int f = t + kWarp + lane;
      obs_next = f < T ? o[f] : 0;
    }
    const int ot = __shfl_sync(kFull, obs_cur, t & (kWarp - 1));
    if (++slot == tile) {
      slot = 0;
      ++tile_k;
      if (tile_k >= 2 && spilled) {
        // the buffer of tile k held tile k - 2: out to device memory
        const uint4* src =
            reinterpret_cast<const uint4*>(tiles + (tile_k & 1) * tile_bytes);
        uint4* dst = reinterpret_cast<uint4*>(spilled +
                                              (tile_k - 2) * tile_bytes);
        for (size_t c = tid; c < tile_bytes / 16; c += threads) dst[c] = src[c];
        __syncthreads();
      }
    }
    int8_t* bp = tiles + (tile_k & 1) * tile_bytes +
                 static_cast<size_t>(slot) * lay.spad;
    const int cur = (t - 1) & 1;
    const float* row = rows + cur * lay.row;
    float* next = rows + (cur ^ 1) * lay.row;
    unsigned key = ordered(-CUDART_INF_F);

    if constexpr (kStatic) {
      constexpr int kW = 2 * HW + 1;
      // the window first: its loads do not wait for the row maximum
      float win[K + 2 * HW];
#pragma unroll
      for (int q = 0; q < K + 2 * HW; ++q) win[q] = row[j0 + q];
      // frame 0 is not normalized: its scores go in as they are
      const float row_max =
          t > 1 ? unordered(max_key(keys + cur * kMaxWarps)) : 0.f;
#pragma unroll
      for (int q = 0; q < K + 2 * HW; ++q) win[q] = __fsub_rn(win[q], row_max);
      // block-uniform: whether the pad survives the subtraction
      if (__fsub_rn(kPad, row_max) != kPad) {
#pragma unroll
        for (int q = 0; q < K + 2 * HW; ++q) {
          const int pos = j0 + q;
          if (pos < HW || pos >= HW + S) win[q] = kPad;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float cand[kW];
#pragma unroll
        for (int d = 0; d < kW; ++d) cand[d] = __fadd_rn(win[k + d], band_r[k][d]);
        float best;
        int rel;
        first_max<0, kW>(cand, best, rel);
        // a slot past S keeps the pad: no branch around the work
        const int j = j0 + k;
        const float value =
            j < S ? __fadd_rn(__fadd_rn(best, uniform), j == ot ? gain : 0.f)
                  : kPad;
        next[HW + j] = value;
        bp[j] = static_cast<int8_t>(rel);
        key = max(key, j < S ? ordered(value) : 0u);
      }
    } else {
      const float row_max =
          t > 1 ? unordered(max_key(keys + cur * kMaxWarps)) : 0.f;
      for (int k = 0; k < K; ++k) {
        const int j = j0 + k;
        if (j >= S) break;
        const float* band_j = band + static_cast<size_t>(j) * W;
        float best = 0.f;
        int rel = 0;
        for (int d = 0; d < W; ++d) {
          const int pos = j + d;
          const float score = (pos < hw || pos >= hw + S)
                                  ? kPad
                                  : __fsub_rn(row[pos], row_max);
          const float cand = __fadd_rn(score, __ldg(band_j + d));
          if (d == 0 || cand > best) {
            best = cand;
            rel = d;
          }
        }
        const float value = __fadd_rn(__fadd_rn(best, uniform),
                                      j == ot ? gain : 0.f);
        next[hw + j] = value;
        bp[j] = static_cast<int8_t>(rel);
        key = max(key, ordered(value));
      }
    }
    key = __reduce_max_sync(kFull, key);
    if (lane == 0) keys[(cur ^ 1) * kMaxWarps + warp] = key;
    __syncthreads();
  }
  if (forward_only) return;

  // the first maximum of the final scores (frame 0's when n == 1)
  const int last = (n - 1) & 1;
  float row_max = 0.f;
  if (n > 1) row_max = unordered(max_key(keys + last * kMaxWarps));
  float score[K];
  unsigned key = ordered(-CUDART_INF_F);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    score[k] = j < S ? __fsub_rn(rows[last * lay.row + hw + j], row_max)
                     : -CUDART_INF_F;
    key = max(key, ordered(score[k]));
  }
  key = __reduce_max_sync(kFull, key);
  if (lane == 0) keys[2 * kMaxWarps + warp] = key;
  __syncthreads();
  const float best = unordered(max_key(keys + 2 * kMaxWarps));
  // ties compare as floats, as the plain version's argmax does
  unsigned first = 0xffffffffu;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (j0 + k < S && score[k] == best) first = j0 + k;
  }
  first = __reduce_min_sync(kFull, first);
  if (lane == 0) keys[3 * kMaxWarps + warp] = first;
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) first = min(first, keys[3 * kMaxWarps + w]);
  int state = first < static_cast<unsigned>(S) ? static_cast<int>(first) : 0;
  for (int t = n - 1 + tid; t < T; t += threads) out[t] = state;

  // the backtrace: thread 0 walks tile k while the others load tile k - 1
  // when it was spilled (the last two tiles never left shared memory)
  const int top = (n - 1) / tile;
  for (int k = top; k >= 0; --k) {
    if (k - 1 >= 0 && k - 1 <= top - 2 && tid > 0) {
      int8_t* dst = tiles + ((k - 1) & 1) * tile_bytes;
      const int8_t* src = spilled + (k - 1) * tile_bytes;
      for (size_t c = tid - 1; c < tile_bytes / 16; c += threads - 1)
        copy_async16(dst + 16 * c, src + 16 * c);
    }
    if (tid == 0) {
      const int8_t* base = tiles + (k & 1) * tile_bytes;
      const int lo = max(k * tile, 1);
      for (int t = min(n - 1, (k + 1) * tile - 1); t >= lo; --t) {
        state = state - hw + base[static_cast<size_t>(t - k * tile) * lay.spad +
                                  state];
        out[t - 1] = state;
      }
    }
    wait_async_all();
    __syncthreads();
  }
}

// The instantiations: K states a thread, the CREPE halfwidth held in
// registers (11) or any halfwidth (0).
using Kernel = void (*)(const int32_t*, const int32_t*, const float*,
                        const float*, float, float, int, int, int, int,
                        int8_t*, int32_t*, int);

Kernel pick(int K, bool fixed_band, int* bound) {
  if (fixed_band) {
    switch (K) {
      case 1: *bound = max_threads<1, 11>(); return banded_viterbi_kernel<1, 11>;
      case 2: *bound = max_threads<2, 11>(); return banded_viterbi_kernel<2, 11>;
      case 3: *bound = max_threads<3, 11>(); return banded_viterbi_kernel<3, 11>;
      case 4: *bound = max_threads<4, 11>(); return banded_viterbi_kernel<4, 11>;
    }
    return nullptr;
  }
  switch (K) {
    case 1: *bound = max_threads<1, 0>(); return banded_viterbi_kernel<1, 0>;
    case 2: *bound = max_threads<2, 0>(); return banded_viterbi_kernel<2, 0>;
    case 4: *bound = max_threads<4, 0>(); return banded_viterbi_kernel<4, 0>;
    case 8: *bound = max_threads<8, 0>(); return banded_viterbi_kernel<8, 0>;
  }
  return nullptr;
}

// The states a thread of the CREPE band takes by default: the fewest that
// keep a row on four warps (three for 360 states).
int default_states(int S, bool fixed_band) {
  const int per128 = (S + 127) / 128;
  if (fixed_band) return per128;
  int K = 1;
  while (K < per128) K *= 2;
  return K;
}

}  // namespace

extern "C" {

// The launch of B rows of T frames, S states and band width W with K
// states a thread (0: the default): the states a thread takes, threads a
// block, frames a back-pointer tile, dynamic shared memory, and the bytes
// of device scratch that the spilled tiles need (0 when a row fits in two
// tiles). Returns 0, or cudaErrorInvalidValue for a shape no
// instantiation takes.
int shennong_banded_viterbi_plan(int B, int T, int S, int W, int K,
                                 int* states, int* threads, int* tile,
                                 size_t* smem, size_t* spill_bytes) {
  const int hw = (W - 1) / 2;
  if (S < 1 || S > 1024 || W < 1 || W > 127 || W % 2 == 0 || T < 1 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fixed_band = hw == kStaticHalfwidth && (K > 0 || S <= 512);
  if (K == 0) K = default_states(S, fixed_band);
  int bound = 0;
  if (!pick(K, fixed_band, &bound)) return static_cast<int>(cudaErrorInvalidValue);
  const int used = ((S + K - 1) / K + kWarp - 1) / kWarp * kWarp;
  if (used > bound) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(K, used, hw);
  const size_t room = kSmemLimit - lay.fixed();
  const int fit = static_cast<int>(room / (2 * static_cast<size_t>(lay.spad)));
  *states = K;
  *threads = used;
  *tile = T < fit ? T : fit;
  *smem = lay.fixed() + 2 * static_cast<size_t>(*tile) * lay.spad;
  const size_t ntiles = (T + *tile - 1) / *tile;
  *spill_bytes = ntiles > 2 ? static_cast<size_t>(B) * ntiles * *tile * lay.spad
                            : 0;
  return 0;
}

// obs [B, T] int32, nframes [B] int32, log_start [S] float32, band
// [S, W] float32 (band[j*W + d] = log_trans[j - hw + d, j]) -> path
// [B, T] int32, with K states a thread (0: the default). spill holds the
// plan's spill_bytes (null when they are 0). forward_only skips the argmax
// and the backtrace (path is not written): a timing split. Launches on
// `stream`; returns the CUDA error code of the launch.
int shennong_banded_viterbi(const int32_t* obs, const int32_t* nframes,
                            const float* log_start, const float* band,
                            float uniform, float gain, int B, int T, int S,
                            int W, int K, int8_t* spill, int32_t* path,
                            int forward_only, void* stream) {
  int states = 0, threads = 0, tile = 0;
  size_t smem = 0, spill_bytes = 0;
  int code = shennong_banded_viterbi_plan(B, T, S, W, K, &states, &threads,
                                          &tile, &smem, &spill_bytes);
  if (code != 0) return code;
  if (spill_bytes && !spill) return static_cast<int>(cudaErrorInvalidValue);
  const int hw = (W - 1) / 2;
  int bound = 0;
  Kernel kernel = pick(states, hw == kStaticHalfwidth && (K > 0 || S <= 512),
                       &bound);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, nframes, log_start, band, uniform, gain, T, S, hw, tile,
      spill_bytes ? spill : nullptr, path, forward_only);
  return static_cast<int>(cudaGetLastError());
}

const char* shennong_banded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
