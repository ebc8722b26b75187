// One conv block of the CREPE pitch CNN, fused, for NVIDIA Hopper
// (sm_90a): TensorFlow 'SAME' zero padding, the convolution, its bias,
// ReLU, inference batch norm and max-pooling by 2 in one launch.
//
// Replaces no Pallas kernel: the JAX package's CNN
// (shennong_tpu/models/crepe.py) is XLA's lax.conv. It was added because
// the port ran these blocks through cuDNN, whose float32 convolution
// (implicit_convolve_sgemm, the 1024-channel layers) reached 22.9 TFLOP/s,
// 34% of the card's float32 rate, and took 84% of the CREPE cell's kernel
// time, with ReLU, batch norm, padding and pooling as separate passes over
// the activations. TF32 is off (it fails the cell's checks), so the tensor
// cores are out. The wrapper is conv_block in
// shennong_tpu_torch/ops/crepe_conv.py.
//
// For frames n, output channels co and output times t < T:
//   y[n, co, t] = bias[co] + sum_{ci, k} w[co, ci, k] * xp[n, ci, S t + k]
//   z           = (max(y, 0) - mean[co]) * scale[co] + beta[co]
//   out         = max(z[2 t'], z[2 t' + 1])  -> [N, Cout, T / 2]
// with xp the input padded with `pad` zeros on the left ('SAME': the odd
// sample on the right). Two block shapes exist: width 64 at stride 1
// (blocks 2-6), and width 512 at stride 4 over one input channel (block
// 1). The second is the first rewritten as a stride-1 convolution over 8
// sub-channels of 64 taps: tap k = 4 (64 h + j) + r reads
// x[4 (t + j) + 256 h + r - pad], so sub-channel c = 4 h + r is the input's
// residue class r, shifted by 64 h. The wrapper repacks the weights once
// into [sub-channel, tap, Cout] (packed_weight), which makes a staged
// weight row 16-byte loads.
//
// What bounds it: FP32 FFMA at 67 TFLOP/s (132 SMs x 128 lanes x 2 x 1.98
// GHz). A scheduler issues one warp instruction a clock, so every
// instruction that is not an FFMA takes the FFMA pipe's slot. The design:
// - a block computes 128 output channels x 128 output times, frames side
//   by side where T is shorter than the tile, over every (sub-)channel in
//   turn; a layer of fewer channels leaves the tile's rest unused;
// - a (sub-)channel's staged weights [64 taps][tile channels] and its input
//   samples, 63 more than the tile's times per frame, come through a
//   three-stage ring of cp.async copies into shared memory; 'SAME' padding
//   and frames past N are zeros: for stride 1 they are written once, and
//   the copies only ever fill the real samples; for stride 4 each stage is
//   filled whole, with zero-filling copies where a sample lies outside;
// - a thread holds an 8 x 8 tile (8 channels x 8 consecutive times of one
//   frame) in 64 registers. Over 8 taps it loads 16 consecutive input
//   samples (two 16-byte loads each 8 taps: the window slides one sample a
//   tap, so tap j of the group reads samples j .. j + 7) and 8 weights a
//   tap (two 16-byte loads, the same address across the 8 threads that
//   share the channels), for 64 __fmaf_rn a tap: 1024 FFMA against 36
//   loads each 16 taps. The file is built with -fmad=false, so an FMA is
//   written out;
// - the epilogue adds the bias, applies ReLU and (z - mean) * scale + beta,
//   each rounded on its own in the plain version's order, pools the
//   register pairs and writes only the pooled values.
// No tensor core, cuDNN, cuBLAS or library GEMM is used.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 64;    // taps of a (sub-)channel
constexpr int kStages = 3;   // the cp.async ring
constexpr int kWarpsC = 4;   // warps along the output channels, 2 along time
constexpr int BC = 32 * kWarpsC;          // output channels of a block
constexpr int BT = 64 * (8 / kWarpsC);    // output times of a block

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros when !valid (src is then not read)
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero when !valid
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void load8(float (&v)[8], const float* s) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Eight taps: tap j reads the weights of row j and the samples lo[j..7],
// hi[0..j-1] (the window slid by j).
template <int BC>
__device__ __forceinline__ void taps8(float (&acc)[8][8], const float* ws,
                                      const float (&lo)[8],
                                      const float (&hi)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float wv[8];
    load8(wv, ws + j * BC);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float xv = u + j < 8 ? lo[u + j] : hi[u + j - 8];
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[v][u] = __fmaf_rn(wv[v], xv, acc[v][u]);
    }
  }
}

// Grid: x over tiles of BT output times (whole frames side by side when
// T < BT), y over tiles of BC output channels. C is the number of
// (sub-)channels, 64 taps each; w is packed [C][64][Cout].
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
crepe_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ mean,
                  const float* __restrict__ scale,
                  const float* __restrict__ beta, float* __restrict__ out,
                  int N, int Cin, int Tin, int T, int C, int Cout, int pad) {
  constexpr int kQuads = BC / 4;      // 16-byte pieces of a staged row
  constexpr int kRowStep = kThreads / kQuads;
  constexpr int kWordsW = kTaps * BC;
  constexpr int kXPasses = (BT + kThreads - 1) / kThreads;
  static_assert(S == 1 || BT + kTaps <= kThreads,
                "a stride-4 stage is one sample a thread");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tpb = T < BT ? T : BT;   // output times of a frame in the block
  const int fpb = BT / tpb;          // frames in the block
  const int seg = tpb + kTaps;       // staged samples of a frame
  const int stage = kWordsW + fpb * seg;
  const int tid = threadIdx.x;
  const int co0 = blockIdx.y * BC;
  int64_t n0;
  int t0;
  if (T <= BT) {
    n0 = static_cast<int64_t>(blockIdx.x) * fpb;
    t0 = 0;
  } else {
    n0 = blockIdx.x / (T / BT);
    t0 = (blockIdx.x % (T / BT)) * BT;
  }

  // the weight rows this thread stages: rows wk + m kRowStep, piece wq
  const int wq = tid % kQuads, wk = tid / kQuads;
  const bool w_ok = co0 + 4 * wq < Cout;
  const float* w_src = w_ok ? w + static_cast<size_t>(wk) * Cout + co0 + 4 * wq
                            : w;
  const int w_dst = wk * BC + 4 * wq;

  // stride 1: the real samples of the block, one or two a thread, at the
  // same place in every stage
  const float* x_src[kXPasses];
  int x_dst[kXPasses];
  bool x_ok[kXPasses];
#pragma unroll
  for (int m = 0; m < kXPasses; ++m) {
    const int e = tid + m * kThreads;
    const int f = e / tpb, tt = e - f * tpb;
    const int64_t n = n0 + f;
    x_ok[m] = S == 1 && e < BT && n < N;
    x_src[m] = x_ok[m] ? x + static_cast<size_t>(n) * Cin * Tin + t0 + tt : x;
    x_dst[m] = kWordsW + f * seg + tt + pad;
  }
  // stride 4: one frame, input channel 0
  const float* x_row = x + static_cast<size_t>(n0) * Tin;

  if (S == 1) {
    // the padding and the frames past N stay zero in every stage
    const int words = fpb * seg;
    for (int i = tid; i < kStages * words; i += kThreads) {
      const int s = i / words;
      smem[s * stage + kWordsW + (i - s * words)] = 0.0f;
    }
    __syncthreads();
  }

  auto load = [&](int c, int buffer) {
    float* st = smem + buffer * stage;
    const float* src = w_src + (w_ok ? static_cast<size_t>(c) * kTaps * Cout
                                     : 0);
#pragma unroll
    for (int r = 0; r < kTaps; r += kRowStep)
      copy16(st + w_dst + r * BC,
             w_ok ? src + static_cast<size_t>(r) * Cout : w, w_ok);
    if (S == 1) {
#pragma unroll
      for (int m = 0; m < kXPasses; ++m)
        if (x_ok[m])
          copy4(st + x_dst[m], x_src[m] + static_cast<size_t>(c) * Tin, true);
    } else if (tid < seg) {
      const int pos = S * (t0 + tid) + S * kTaps * (c / S) + c % S - pad;
      const bool ok = pos >= 0 && pos < Tin;
      copy4(st + kWordsW + tid, ok ? x_row + pos : x, ok);
    }
  };

  // this thread's 8 channels and 8 consecutive times of one frame
  const int warp = tid >> 5, lane = tid & 31;
  const int co_t = (warp % kWarpsC) * 32 + (lane >> 3) * 8;
  const int p = (warp / kWarpsC) * 64 + (lane & 7) * 8;
  const int f_t = p / tpb, tt = p - f_t * tpb;
  const int x_off = kWordsW + f_t * seg + tt;

  float acc[8][8];
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[v][u] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < C) load(s, s);
    commit();
  }
  for (int c = 0; c < C; ++c) {
    wait_pending<kStages - 2>();
    // stage c has landed, and every thread is past stage c - 1, whose
    // buffer the next load reuses
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < C) load(next, next % kStages);
    commit();

    const float* st = smem + (c % kStages) * stage;
    const float* ws = st + co_t;
    const float* xs = st + x_off;
    float lo[8], hi[8];
    load8(lo, xs);
#pragma unroll 1
    for (int k = 0; k < kTaps; k += 16) {
      load8(hi, xs + k + 8);
      taps8<BC>(acc, ws + k * BC, lo, hi);
      load8(lo, xs + k + 16);
      taps8<BC>(acc, ws + (k + 8) * BC, hi, lo);
    }
  }

  const int64_t n = n0 + f_t;
  const int co_base = co0 + co_t;
  if (n >= N || co_base >= Cout) return;   // Cout % 8 == 0
  const int half = T / 2;
  const int tp = (t0 + tt) / 2;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int co = co_base + v;
    const float b = bias[co], mu = mean[co], sc = scale[co], be = beta[co];
    float z[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float y = fmaxf(__fadd_rn(acc[v][u], b), 0.0f);
      z[u] = __fadd_rn(__fmul_rn(__fsub_rn(y, mu), sc), be);
    }
    *reinterpret_cast<float4*>(
        out + (static_cast<size_t>(n) * Cout + co) * half + tp) =
        make_float4(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]), fmaxf(z[4], z[5]),
                    fmaxf(z[6], z[7]));
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*, float*, int,
                        int, int, int, int, int, int);

}  // namespace

extern "C" {

// x [N, Cin, Tin] float32; w packed [C][64][Cout] with C = Cin * width /
// 64; bias, mean, scale, beta [Cout]; out [N, Cout, T / 2], T = Tin /
// stride. Shapes taken: width 64 at stride 1 with T a power of two in
// [8, 128]; width 512 at stride 4 over one input channel with T a
// multiple of 128; Cout a multiple of 8. Launches on `stream`; returns
// the CUDA error code of the launch (cudaErrorInvalidValue for another
// shape).
int shennong_crepe_conv(const float* x, const float* w, const float* bias,
                        const float* mean, const float* scale,
                        const float* beta, float* out, int N, int Cin,
                        int Tin, int Cout, int width, int stride, int pad,
                        void* stream) {
  const int T = Tin / stride;
  const bool pow2 = (T & (T - 1)) == 0;
  bool ok = N > 0 && Cout % 8 == 0 && Tin % stride == 0;
  Kernel kernel = nullptr;
  if (stride == 1 && width == kTaps) {
    ok = ok && pow2 && T >= 8 && T <= BT;
    kernel = crepe_conv_kernel<1>;
  } else if (stride == 4 && width == 512 && Cin == 1) {
    ok = ok && T % BT == 0;
    kernel = crepe_conv_kernel<4>;
  } else {
    ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int C = Cin * width / kTaps;
  const int tpb = T < BT ? T : BT;
  const size_t smem =
      sizeof(float) * kStages * (kTaps * BC + (BT / tpb) * (tpb + kTaps));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = T <= BT ? (static_cast<int64_t>(N) + BT / T - 1) /
                                      (BT / T)
                                : static_cast<int64_t>(N) * (T / BT);
  const dim3 grid(static_cast<unsigned>(tiles), (Cout + BC - 1) / BC);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, mean, scale, beta, out, N, Cin, Tin, T, C, Cout, pad);
  return static_cast<int>(cudaGetLastError());
}

const char* shennong_crepe_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
