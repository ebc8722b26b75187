// Pitch Viterbi lag selection for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// shennong_tpu/ops/pallas_viterbi.py:
//   viterbi_forward_pallas   (kernel body _make_viterbi_kernel)
//   viterbi_backtrace_pallas (kernel body _make_backtrace_kernel)
// and, through the wrapper in shennong_tpu_torch/ops/cuda_viterbi.py,
// viterbi_lags_pallas, which runs both.
//
// Forward: min-plus recursion over L lag states,
//   frame 0:   fwd = cost[b,0,:] - min(cost[b,0,:])
//   frame f:   new[j] = cost[b,f,j] + min_i(fwd[i] + (i-j)^2 * factor)
//              new -= min_j(new); rows with f >= nframes[b] keep fwd
// and every state goes out as hist[f, b, :] ([F, B, L] layout).
// Backtrace: best[F-1] = argmin hist[F-1]; for t < F-1,
//   best[t] = argmin_i(hist[t,i] + (best[t+1]-i)^2 * factor)
// where t+1 < nframes[b], else best[t+1]; ties go to the lowest index.
//
// What bounds it on the card: the forward is F dependent steps of
// L^2 (~174k at L = 417) add/min pairs per row, so it is bound by the
// instruction throughput of one SM and by the per-frame barrier, not
// by memory (it reads B*F*L costs and writes B*F*L states once). The
// design keeps the state on chip for the whole recursion, as the TPU
// kernel kept it in VMEM: one block per batch row loops over frames
// with fwd[L] in shared memory; each thread owns lags j and scans all
// i reading fwd[i] as a shared-memory broadcast; the block reduces
// the frame minimum through warp shuffles. With B = 64 rows only 64
// of the 132 SMs work; splitting L across a cluster is later work.
// The backtrace is O(L) per frame and latency bound: one warp per row
// walks t downward, one coalesced read of hist[t, b, :] per step.
//
// Rounding: the penalty is evaluated on the fly exactly as the
// reference rounds it, fl(fl(d*d) * factor) then one rounded add,
// with __fmul_rn/__fadd_rn (never contracted into an FMA); the file is
// also built with -fmad=false. The forward history is then bit-equal
// to the reference, and so are the argmins.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float penalized(float value, float d,
                                           float factor) {
  return __fadd_rn(value, __fmul_rn(__fmul_rn(d, d), factor));
}

// Minimum over the block; every thread gets the result. `scratch`
// holds one slot per warp plus one broadcast slot.
__device__ float block_min(float v, float* scratch) {
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, offset));
  }
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = (blockDim.x + kWarp - 1) / kWarp;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? scratch[lane] : CUDART_INF_F;
    for (int offset = kWarp / 2; offset > 0; offset /= 2) {
      v = fminf(v, __shfl_down_sync(0xffffffffu, v, offset));
    }
    if (lane == 0) scratch[kWarp] = v;
  }
  __syncthreads();
  return scratch[kWarp];
}

// One block per batch row. Shared memory: fwd[L], new[L], 33 floats.
__global__ void viterbi_forward_kernel(const float* __restrict__ cost,
                                       const int* __restrict__ nframes,
                                       float* __restrict__ hist, int B,
                                       int F, int L, float factor) {
  extern __shared__ float smem[];
  float* fwd = smem;
  float* fresh = smem + L;
  float* scratch = smem + 2 * L;

  const int b = blockIdx.x;
  const int valid = nframes[b];
  const float* row = cost + static_cast<size_t>(b) * F * L;

  // frame 0: the costs re-centred on their minimum
  float local = CUDART_INF_F;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const float c = row[j];
    fresh[j] = c;
    local = fminf(local, c);
  }
  float low = block_min(local, scratch);
  float* out = hist + static_cast<size_t>(b) * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const float v = __fsub_rn(fresh[j], low);
    fwd[j] = v;
    out[j] = v;
  }
  __syncthreads();

  for (int f = 1; f < F; ++f) {
    out = hist + (static_cast<size_t>(f) * B + b) * L;
    if (f >= valid) {  // padded frame: the state passes through
      for (int j = threadIdx.x; j < L; j += blockDim.x) out[j] = fwd[j];
      continue;
    }
    const float* cost_f = row + static_cast<size_t>(f) * L;
    local = CUDART_INF_F;
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      float best = CUDART_INF_F;
      float d = static_cast<float>(-j);  // i - j, exact in float
      for (int i = 0; i < L; ++i) {
        best = fminf(best, penalized(fwd[i], d, factor));
        d = __fadd_rn(d, 1.0f);
      }
      const float v = __fadd_rn(cost_f[j], best);
      fresh[j] = v;
      local = fminf(local, v);
    }
    // block_min's barriers also order every read of fwd[] above
    // before the writes below
    low = block_min(local, scratch);
    for (int j = threadIdx.x; j < L; j += blockDim.x) {
      const float v = __fsub_rn(fresh[j], low);
      fwd[j] = v;
      out[j] = v;
    }
    __syncthreads();
  }
}

// (value, index) argmin over a warp, ties to the lowest index.
__device__ __forceinline__ int warp_argmin(float v, int idx) {
  for (int offset = kWarp / 2; offset > 0; offset /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, v, offset);
    const int oi = __shfl_down_sync(0xffffffffu, idx, offset);
    if (ov < v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  return __shfl_sync(0xffffffffu, idx, 0);
}

// One warp (one block) per batch row.
__global__ void viterbi_backtrace_kernel(const float* __restrict__ hist,
                                         const int* __restrict__ nframes,
                                         int* __restrict__ best, int B,
                                         int F, int L, float factor) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int valid = nframes[b];

  // last frame: plain argmin; each lane scans i = lane, lane + 32, ...
  // so its first strict minimum is its lowest index
  const float* h = hist + (static_cast<size_t>(F - 1) * B + b) * L;
  float v = CUDART_INF_F;
  int idx = 0x7fffffff;
  for (int i = lane; i < L; i += kWarp) {
    const float x = h[i];
    if (x < v || idx == 0x7fffffff) {
      v = x;
      idx = i;
    }
  }
  int current = warp_argmin(v, idx);
  if (lane == 0) best[static_cast<size_t>(F - 1) * B + b] = current;

  for (int t = F - 2; t >= 0; --t) {
    if (t + 1 < valid) {
      h = hist + (static_cast<size_t>(t) * B + b) * L;
      const float next = static_cast<float>(current);
      v = CUDART_INF_F;
      idx = 0x7fffffff;
      for (int i = lane; i < L; i += kWarp) {
        const float x = penalized(h[i], __fsub_rn(next, static_cast<float>(i)),
                                  factor);
        if (x < v || idx == 0x7fffffff) {
          v = x;
          idx = i;
        }
      }
      current = warp_argmin(v, idx);
    }
    if (lane == 0) best[static_cast<size_t>(t) * B + b] = current;
  }
}

}  // namespace

extern "C" {

// Threads per forward block: one per lag, rounded up to whole warps.
static int forward_threads(int L) {
  int threads = ((L + kWarp - 1) / kWarp) * kWarp;
  return threads > 1024 ? 1024 : threads;
}

size_t shennong_viterbi_forward_smem(int L) {
  return (2 * static_cast<size_t>(L) + kWarp + 1) * sizeof(float);
}

// cost [B, F, L] float32, nframes [B] int32 -> hist [F, B, L] float32.
// Launches on `stream`; returns the CUDA error code of the launch.
int shennong_viterbi_forward(const float* cost, const int* nframes,
                             float* hist, int B, int F, int L, float factor,
                             void* stream) {
  const size_t smem = shennong_viterbi_forward_smem(L);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_forward_kernel<<<B, forward_threads(L), smem,
                           static_cast<cudaStream_t>(stream)>>>(
      cost, nframes, hist, B, F, L, factor);
  return static_cast<int>(cudaGetLastError());
}

// hist [F, B, L] float32, nframes [B] int32 -> best [F, B] int32.
int shennong_viterbi_backtrace(const float* hist, const int* nframes,
                               int* best, int B, int F, int L, float factor,
                               void* stream) {
  viterbi_backtrace_kernel<<<B, kWarp, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      hist, nframes, best, B, F, L, factor);
  return static_cast<int>(cudaGetLastError());
}

const char* shennong_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
