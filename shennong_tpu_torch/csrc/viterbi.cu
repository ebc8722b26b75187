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
// Rounding: the penalty is the reference's fl(fl(d*d) * factor), taken
// from a table built with __fmul_rn (d = i - j is an exact integer and
// d*d < 2^24, so every entry equals the value the reference computes
// on the fly), then one rounded add (__fadd_rn; the file is built with
// -fmad=false). fminf is exact and order-free, so splitting the min
// over threads, warps and blocks leaves the history bit-equal to the
// reference, and the argmins equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;

// The penalty of a lag step of k = m - centre, as the reference rounds
// it: the mirrored table pen[m] lets neighbouring lags read neighbouring
// words.
__device__ void build_penalty(float* pen, int size, int centre,
                              float factor) {
  for (int m = threadIdx.x; m < size; m += blockDim.x) {
    const float d = static_cast<float>(m - centre);
    pen[m] = __fmul_rn(__fmul_rn(d, d), factor);
  }
}

// Floats mapped to unsigned ints of the same order (finite or inf).
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float warp_min(float v) {
  return unordered(__reduce_min_sync(0xffffffffu, ordered(v)));
}

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_address(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of a shared-memory word in the block of rank `rank`.
__device__ __forceinline__ uint32_t cluster_map(uint32_t address, int rank) {
  uint32_t mapped;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(mapped)
               : "r"(address), "r"(rank));
  return mapped;
}

// Stores v at a (mapped) address of another block and counts its 4
// bytes on that block's (mapped) transaction barrier.
__device__ __forceinline__ void store_counted(uint32_t address, float v,
                                              uint32_t barrier) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(address),
      "r"(__float_as_uint(v)), "r"(barrier)
      : "memory");
}

__device__ __forceinline__ void barrier_init(uint64_t* barrier) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_address(barrier)),
               "r"(1)
               : "memory");
}

// One arrival that also expects `bytes` more bytes in this phase.
__device__ __forceinline__ void barrier_expect(uint64_t* barrier,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_address(barrier)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* barrier,
                                             uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_address(barrier)), "r"(phase)
        : "memory");
  }
}

// ----------------------------------------------------------- forward
//
// What bounds it on the card: each of the F dependent frames does L^2
// (~174k at L = 417) add/min pairs per row, so the forward is bound by
// its instruction rate and by the per-frame exchange between the blocks
// of a row, not by memory (it reads B*F*L costs and writes B*F*L
// states once).
//
// Design:
// - A cluster of C blocks works on one row (C = 2 at B = 64, 8 at
//   B = 8 on an H100, chosen by the wrapper so that the rows fill the
//   card with one block per SM). Block `rank` owns the lags
//   [rank*S, rank*S + S) of the new state, S = ceil(L / C) rounded up
//   to 4, and reads the whole previous state.
// - Register tiling: each lane owns R neighbouring lags j (R odd, so
//   the 32 lanes of a warp read 32 different banks of the penalty
//   table) and keeps R accumulators; per previous lag i it loads
//   fwd[i] once (a broadcast) and one penalty entry into a window of R
//   registers, then does R adds and R mins. The window rotates through
//   registers R steps at a time. The i range is split across the warps
//   of the block; their partial minima are merged in shared memory.
// - Per frame each block sends its slice of the new state (16-byte
//   st.async stores) and one minimum per merging warp to every block of
//   the cluster, each store counted on the receiver's transaction
//   barrier (mbarrier complete_tx), and waits on its own barrier for the
//   whole state. No cluster barrier runs per frame: the release of
//   barrier.cluster.arrive waits for every store and load in flight.
//   The buffers alternate by frame parity: a block sends frame f+2 into
//   a buffer only after it has received every block's frame f+1, which
//   each block sends after its last read of that buffer.
// - While the state arrives, the previous frame's state is written out
//   and the next frame's costs are fetched with cp.async.
// Shared memory: two barriers, pen[M], first[N], fresh[2][N], the minima,
// part[W][spad], costs[2][S], stage[S], low0[W].

struct ForwardPlan {
  int C;       // blocks per row (the cluster)
  int S;       // lags per block, a multiple of 4
  int N;       // C * S: the padded state that the blocks exchange
  int R;       // lags per lane (odd)
  int passes;  // tiles of 32*R lags per block
  int merging; // warps that merge the slice, 4 lags per thread
  int pad;     // low-side padding of the penalty table
  int M;       // penalty table entries, a multiple of 4
};

constexpr int kForwardWarps = 8;
constexpr int kMaxLanesLags = 9;

__host__ __device__ ForwardPlan forward_plan(int L, int C) {
  ForwardPlan plan;
  plan.C = C;
  plan.S = ((L + C - 1) / C + 3) / 4 * 4;
  plan.N = C * plan.S;
  plan.passes = (plan.S + kWarp * kMaxLanesLags - 1) /
                (kWarp * kMaxLanesLags);
  const int r = (plan.S + kWarp * plan.passes - 1) / (kWarp * plan.passes);
  plan.R = r | 1;
  plan.merging = (plan.S / 4 + kWarp - 1) / kWarp;
  const int spad = plan.passes * kWarp * plan.R;
  // the lanes past a block's slice read (and discard) penalties of
  // lags up to N + spad past L
  plan.pad = spad + plan.N - L;
  plan.M = (2 * L + plan.pad + 1 + 3) / 4 * 4;
  return plan;
}

// Shared memory a forward block claims: what it uses, and for a cluster
// of several blocks at least kOwnSm bytes, more than half of an SM's
// 228 KB, so that no two blocks share an SM (the blocks of one frame
// wait for each other: a doubled-up SM would set the pace of the whole
// cluster).
constexpr size_t kOwnSm = 120 * 1024;

__host__ __device__ size_t forward_smem_bytes(const ForwardPlan& p) {
  const int spad = p.passes * kWarp * p.R;
  const int mins = (p.C * p.merging + 3) / 4 * 4;
  // two 8-byte transaction barriers, then the floats
  const size_t used =
      16 + sizeof(float) * (static_cast<size_t>(p.M) + 3 * p.N + 2 * mins +
                            kForwardWarps * spad + 3 * p.S + kForwardWarps);
  return p.C > 1 && used < kOwnSm ? kOwnSm : used;
}

// min over i in [i_begin, i_end) of fl(fl(prev[i] - low) + pen[i - j +
// centre]) for the R lags j = jb .. jb + R - 1, into acc.
template <int R>
__device__ __forceinline__ void min_plus(float (&acc)[R],
                                         const float* __restrict__ prev,
                                         const float* __restrict__ pen,
                                         float low, int i_begin, int i_end,
                                         int jb, int centre) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = CUDART_INF_F;
  int q = i_begin - jb + centre;
  float w[R];  // w[r] = pen[q - r], the penalty of lag jb + r at step i
#pragma unroll
  for (int r = 0; r < R; ++r) w[r] = pen[q - r];
  int i = i_begin;
  // R steps at a time: the window rotates through registers
#pragma unroll (R == 1 ? 8 : 1)
  for (; i + R <= i_end; i += R) {
    float nw[R];  // nw[k] = pen[q + 1 + k]
    float v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      nw[k] = pen[q + 1 + k];
      v[k] = __fsub_rn(prev[i + k], low);
    }
#pragma unroll
    for (int step = 0; step < R; ++step) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = step <= r ? w[r - step] : nw[step - r - 1];
        acc[r] = fminf(acc[r], __fadd_rn(v[step], p));
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = nw[R - 1 - r];
    q += R;
  }
  for (; i < i_end; ++i) {
    const float v = __fsub_rn(prev[i], low);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fminf(acc[r], __fadd_rn(v, w[r]));
#pragma unroll
    for (int r = R - 1; r > 0; --r) w[r] = w[r - 1];
    w[0] = pen[++q];
  }
}

template <int R>
__global__ void __launch_bounds__(kForwardWarps * kWarp)
    viterbi_forward_kernel(const float* __restrict__ cost,
                           const int* __restrict__ nframes,
                           float* __restrict__ hist, int B, int F, int L,
                           float factor, ForwardPlan plan) {
  extern __shared__ uint64_t smem_words[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int W = kForwardWarps;
  const int C = plan.C, S = plan.S, N = plan.N;
  const int spad = plan.passes * kWarp * R;
  const int nmins = C * plan.merging;
  uint64_t* arrived = smem_words;  // [2] transaction barriers
  float* pen = reinterpret_cast<float*>(smem_words + 2);
  float* first = pen + plan.M;                 // [N]
  float* fresh = first + N;                    // [2][N]
  float* mins = fresh + 2 * N;                 // [2][nmins, padded to 4]
  float* part = mins + 2 * ((nmins + 3) / 4 * 4);  // [W][spad]
  float* costs = part + W * spad;              // [2][S]
  float* stage = costs + 2 * S;                // [S]
  float* low0 = stage + S;                     // [W]

  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int j0 = rank * S;
  const int own = max(0, min(S, L - j0));  // lags of this block's slice
  const int valid = nframes[b];
  // frames 1 .. last-1 are computed; frames last .. F-1 pass through
  const int last = min(max(valid, 1), F);
  const float* row = cost + static_cast<size_t>(b) * F * L;
  const int centre = L - 1 + plan.pad;
  // bytes each block receives per frame: the padded state and the
  // minima of the merging warps of every block
  const uint32_t frame_bytes = 4u * (N + nmins);
  build_penalty(pen, plan.M, centre, factor);
  if (threadIdx.x == 0) {
    barrier_init(arrived);
    barrier_init(arrived + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // frame 0: the whole cost row re-centred on its minimum, in every
  // block (no exchange needed). It has a buffer of its own: the
  // exchanged buffers are written by st.async alone, never also by
  // plain stores, whose order against st.async's is not defined
  float local = CUDART_INF_F;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const float c = row[j];
    first[j] = c;
    local = fminf(local, c);
  }
  local = warp_min(local);
  if (lane == 0) low0[warp] = local;
  // the first frame's costs
  if (last > 1) {
    for (int l = threadIdx.x; l < own; l += blockDim.x) {
      copy_async4(costs + S + l, row + L + j0 + l);
    }
  }
  commit_async();
  // every block of the cluster runs, with its barriers initialised,
  // before any distributed write; this also publishes fresh[0] and low0
  // inside the block
  cluster_barrier();
  float low = CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < W; ++w) low = fminf(low, low0[w]);
  for (int l = threadIdx.x; l < own; l += blockDim.x) {
    stage[l] = __fsub_rn(first[j0 + l], low);
  }

  // the i range of this warp
  const int i_begin = warp * L / W;
  const int i_end = (warp + 1) * L / W;
  int parity = 0;
  for (int f = 1; f < last; ++f) {
    const int next = parity ^ 1;
    if (threadIdx.x == 0) barrier_expect(arrived + next, frame_bytes);
    const float* prev = f == 1 ? first : fresh + parity * N;
    for (int tile = 0; tile < plan.passes; ++tile) {
      float acc[R];
      min_plus<R>(acc, prev, pen, low, i_begin, i_end,
                  j0 + tile * kWarp * R + lane * R, centre);
      float* mine = part + warp * spad + tile * kWarp * R + lane * R;
#pragma unroll
      for (int r = 0; r < R; ++r) mine[r] = acc[r];
    }
    wait_async<0>();  // the copies of frame f's costs
    __syncthreads();

    // merge the warps' partial minima, add the costs, and send the
    // slice (16 bytes a store) and the merging warps' minima to every
    // block of the cluster, each store counted on the receiver's barrier
    if (warp < plan.merging) {
      const uint32_t fresh_next = smem_address(fresh + next * N + j0);
      const uint32_t bar = smem_address(arrived + next);
      const float* cost_f = costs + next * S;
      local = CUDART_INF_F;
      for (int t = threadIdx.x; 4 * t < S; t += plan.merging * kWarp) {
        float4 best = reinterpret_cast<const float4*>(part)[t];
#pragma unroll
        for (int w = 1; w < W; ++w) {
          const float4 p =
              reinterpret_cast<const float4*>(part + w * spad)[t];
          best = make_float4(fminf(best.x, p.x), fminf(best.y, p.y),
                             fminf(best.z, p.z), fminf(best.w, p.w));
        }
        const float4 c = reinterpret_cast<const float4*>(cost_f)[t];
        const float v[4] = {__fadd_rn(c.x, best.x), __fadd_rn(c.y, best.y),
                            __fadd_rn(c.z, best.z), __fadd_rn(c.w, best.w)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * t + k < own) local = fminf(local, v[k]);
        }
        for (int peer = 0; peer < C; ++peer) {
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
              "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                  cluster_map(fresh_next + 16 * t, peer)),
              "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
              "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])),
              "r"(cluster_map(bar, peer))
              : "memory");
        }
      }
      local = warp_min(local);
      if (lane < C) {
        store_counted(
            cluster_map(smem_address(mins + next * ((nmins + 3) / 4 * 4) +
                                     rank * plan.merging + warp),
                        lane),
            local, cluster_map(bar, lane));
      }
    }
    // while the state arrives: the previous frame's state goes out, and
    // the next frame's costs are fetched
    float* out = hist + (static_cast<size_t>(f - 1) * B + b) * L + j0;
    for (int l = threadIdx.x; l < own; l += blockDim.x) out[l] = stage[l];
    if (f + 1 < last) {
      const float* src = row + static_cast<size_t>(f + 1) * L + j0;
      for (int l = threadIdx.x; l < own; l += blockDim.x) {
        copy_async4(costs + parity * S + l, src + l);
      }
    }
    commit_async();
    // the k-th use of a buffer waits for phase parity k & 1
    barrier_wait(arrived + next, ((f - 1) >> 1) & 1);

    local = CUDART_INF_F;
    for (int k = lane; k < nmins; k += kWarp) {
      local = fminf(local, mins[next * ((nmins + 3) / 4 * 4) + k]);
    }
    low = warp_min(local);
    const float* state = fresh + next * N + j0;
    for (int l = threadIdx.x; l < own; l += blockDim.x) {
      stage[l] = __fsub_rn(state[l], low);
    }
    parity = next;
  }
  // no block leaves while its stores to the others may be in flight
  cluster_barrier();

  // the last computed state, and the padded frames, which pass it
  // through (local reads only)
  for (int f = last - 1; f < F; ++f) {
    float* out = hist + (static_cast<size_t>(f) * B + b) * L + j0;
    for (int l = threadIdx.x; l < own; l += blockDim.x) out[l] = stage[l];
  }
}

// --------------------------------------------------------- backtrace
//
// What bounds it on the card: F dependent steps of an L-wide argmin per
// row; the bytes (one read of hist) would take microseconds, so the
// latency of each step bounds it.
//
// Design: one warp per row. A row's address does not depend on the
// data, so the warp keeps a ring of kRing rows of hist in shared
// memory, filled kRing steps ahead with cp.async, and each step reads
// only shared memory. The penalty comes from the forward's mirrored
// table. Each lane holds its K = ceil(L/32) scores in registers and
// reduces them as a tree. The scores are >= +0 (hist is re-centred on
// its minimum and the penalty is >= 0), so their float bits order as
// unsigned ints: the warp takes __reduce_min_sync of the bits, then of
// the lowest index of each lane that holds that minimum (ties to the
// lowest index). K = 0 is the form for any L: each lane streams its
// scores keeping (bits, index) keys.

constexpr int kRing = 16;

// The argmin over the warp of the scores x[k] of lags lane + 32k.
template <int K>
__device__ __forceinline__ int warp_argmin(const float (&x)[K], int lane) {
  float m[K];
#pragma unroll
  for (int k = 0; k < K; ++k) m[k] = x[k];
#pragma unroll
  for (int width = 1; width < K; width *= 2) {
#pragma unroll
    for (int k = 0; k + width < K; k += 2 * width) {
      m[k] = fminf(m[k], m[k + width]);
    }
  }
  const float low = __uint_as_float(
      __reduce_min_sync(0xffffffffu, __float_as_uint(m[0])));
  unsigned index = 0xffffffffu;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    index = x[k] == low ? static_cast<unsigned>(lane + k * kWarp) : index;
  }
  return static_cast<int>(__reduce_min_sync(0xffffffffu, index));
}

template <int K>
__global__ void viterbi_backtrace_kernel(const float* __restrict__ hist,
                                         const int* __restrict__ nframes,
                                         int* __restrict__ best, int B,
                                         int F, int L, float factor) {
  extern __shared__ float smem[];
  const int M = 2 * L - 1;
  float* pen = smem;
  float* ring = smem + M;  // [kRing][L]
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  build_penalty(pen, M, L - 1, factor);

  // rows read: F - 1, then last - 2 down to 0
  const int last = min(max(nframes[b], 1), F);
  auto row_of = [&](int n) { return n == 0 ? F - 1 : last - 1 - n; };
  auto fetch = [&](int n) {
    if (n < last) {
      const float* src = hist + (static_cast<size_t>(row_of(n)) * B + b) * L;
      float* dst = ring + (n % kRing) * L;
      for (int i = lane; i < L; i += kWarp) copy_async4(dst + i, src + i);
    }
    commit_async();
  };
  for (int n = 0; n < kRing; ++n) fetch(n);

  int current = 0;
  for (int n = 0; n < last; ++n) {
    wait_async<kRing - 1>();
    __syncwarp();
    const float* h = ring + (n % kRing) * L;
    // pen[current - i + L - 1]; frame F - 1 has no successor
    const float* p = pen + (L - 1) + current;
    if constexpr (K > 0) {
      float x[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = lane + k * kWarp;
        x[k] = i < L ? (n == 0 ? h[i] : __fadd_rn(h[i], p[-i]))
                     : CUDART_INF_F;
      }
      current = warp_argmin<K>(x, lane);
    } else {
      uint64_t key = ~0ull;
      for (int i = lane; i < L; i += kWarp) {
        const float x = n == 0 ? h[i] : __fadd_rn(h[i], p[-i]);
        const uint64_t k =
            (static_cast<uint64_t>(__float_as_uint(x)) << 32) | i;
        key = k < key ? k : key;
      }
      const unsigned bits = static_cast<unsigned>(key >> 32);
      const unsigned low = __reduce_min_sync(0xffffffffu, bits);
      current = static_cast<int>(__reduce_min_sync(
          0xffffffffu,
          bits == low ? static_cast<unsigned>(key) : 0xffffffffu));
    }
    if (n == 0) {
      // frame F - 1 and the padded frames share its argmin
      for (int u = last - 1 + lane; u < F; u += kWarp) {
        best[static_cast<size_t>(u) * B + b] = current;
      }
    } else if (lane == 0) {
      best[static_cast<size_t>(row_of(n)) * B + b] = current;
    }
    __syncwarp();  // every lane is done with this slot
    fetch(n + kRing);
  }
  wait_async<0>();
}

}  // namespace

extern "C" {

// The forward's plan for L lags and clusters of C blocks: threads per
// block, lags per lane R, and dynamic shared memory in bytes.
void shennong_viterbi_forward_plan(int L, int C, int* threads, int* lanes_lags,
                                   size_t* smem) {
  const ForwardPlan plan = forward_plan(L, C);
  *threads = kForwardWarps * kWarp;
  *lanes_lags = plan.R;
  *smem = forward_smem_bytes(plan);
}

static int forward_config(int B, int L, int C, void* stream,
                          cudaLaunchConfig_t* config,
                          cudaLaunchAttribute* attribute, ForwardPlan* plan,
                          void (**kernel)(const float*, const int*, float*,
                                          int, int, int, float,
                                          ForwardPlan)) {
  *plan = forward_plan(L, C);
  switch (plan->R) {
    case 1: *kernel = viterbi_forward_kernel<1>; break;
    case 3: *kernel = viterbi_forward_kernel<3>; break;
    case 5: *kernel = viterbi_forward_kernel<5>; break;
    case 7: *kernel = viterbi_forward_kernel<7>; break;
    case 9: *kernel = viterbi_forward_kernel<9>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = forward_smem_bytes(*plan);
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C > 8) {
    err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = C;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(B * C);
  config->blockDim = dim3(kForwardWarps * kWarp);
  config->dynamicSmemBytes = smem;
  config->stream = static_cast<cudaStream_t>(stream);
  config->attrs = attribute;
  config->numAttrs = 1;
  return 0;
}

// How many clusters of C forward blocks (for L lags) the card holds at
// once, into *count; returns the CUDA error code.
int shennong_viterbi_forward_max_clusters(int L, int C, int* count) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  ForwardPlan plan;
  void (*kernel)(const float*, const int*, float*, int, int, int, float,
                 ForwardPlan);
  int err = forward_config(1, L, C, nullptr, &config, &attribute, &plan,
                           &kernel);
  if (err != 0) return err;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, kernel, &config));
}

// cost [B, F, L] float32, nframes [B] int32 -> hist [F, B, L] float32,
// in clusters of C blocks per row. Launches on `stream`; returns the
// CUDA error code of the launch.
int shennong_viterbi_forward(const float* cost, const int* nframes,
                             float* hist, int B, int F, int L, float factor,
                             int C, void* stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  ForwardPlan plan;
  void (*kernel)(const float*, const int*, float*, int, int, int, float,
                 ForwardPlan);
  int err = forward_config(B, L, C, stream, &config, &attribute, &plan,
                           &kernel);
  if (err != 0) return err;
  err = static_cast<int>(cudaLaunchKernelEx(&config, kernel, cost, nframes,
                                            hist, B, F, L, factor, plan));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

size_t shennong_viterbi_backtrace_smem(int L) {
  return (2 * static_cast<size_t>(L) - 1 + static_cast<size_t>(kRing) * L) *
         sizeof(float);
}

// hist [F, B, L] float32, nframes [B] int32 -> best [F, B] int32.
int shennong_viterbi_backtrace(const float* hist, const int* nframes,
                               int* best, int B, int F, int L, float factor,
                               void* stream) {
  void (*kernel)(const float*, const int*, int*, int, int, int, float);
  const int per_lane = (L + kWarp - 1) / kWarp;
  if (per_lane <= 1) {
    kernel = viterbi_backtrace_kernel<1>;
  } else if (per_lane <= 2) {
    kernel = viterbi_backtrace_kernel<2>;
  } else if (per_lane <= 4) {
    kernel = viterbi_backtrace_kernel<4>;
  } else if (per_lane <= 8) {
    kernel = viterbi_backtrace_kernel<8>;
  } else if (per_lane <= 16) {
    kernel = viterbi_backtrace_kernel<16>;
  } else {
    kernel = viterbi_backtrace_kernel<0>;
  }
  const size_t smem = shennong_viterbi_backtrace_smem(L);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      hist, nframes, best, B, F, L, factor);
  return static_cast<int>(cudaGetLastError());
}

const char* shennong_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
