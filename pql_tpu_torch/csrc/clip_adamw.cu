// PQL's optimizer tail for one network: optax's clip_by_global_norm over all
// of its gradients, then one step of the default AdamW, as two launches.
//
// Replaces no TPU kernel: the JAX package's step is optax under jit. It was
// added because the eager tail, the clip by global norm and the default
// foreach AdamW step (6·P + 11 launches for P tensors), was 107 of the
// critic's 221 kernel nodes an update and 59 of the actor's 140 in PQL's
// captured learner phases: 2.3 us a node (245 us for the critic's tail, one
// graph, on an H100) for tensors of 0.2-0.4 M floats.
//
// What bounds it on an H100: bytes, at a size where latency rules. An update
// reads g, p, m, v and writes p, m, v: 28 bytes an element, 11.2 MB for the
// critic's 400,386 parameters (3.4 us at 3.35 TB/s, and in L2 after the
// backward); ~15 flops an element. So the design spends the fewest launches
// a global norm allows without a grid-wide barrier, two, each one wave of
// blocks that keeps all of its loads in flight at once:
//
// 1. clip_adamw_norm_kernel: block b takes chunk b, kChunk elements of one
//    tensor (tensor t's chunks are numbered from first[t]), and writes the
//    fp32 sum of their squares to partial[b], in a fixed order (each thread
//    its kPerThread strided elements in turn, then a fixed shuffle tree).
// 2. clip_adamw_step_kernel: each block issues its elements' loads, then
//    sums the partials itself in the same fixed order, so every block holds
//    the same norm, bit for bit, on every call and replay (block 0 writes it
//    out); no atomics, no counter to reset. Then one pass per element: the
//    clipped gradient where(norm < max, g, g / norm * max), not written back,
//    and the AdamW step.
//
// The AdamW arithmetic repeats PyTorch's default foreach step on CUDA op for
// op, with its roundings: p·(1 − lr·wd); m.lerp(g, 1 − β1), which PyTorch's
// kernel contracts to fma(w, g − m, m) for w < 0.5; v·β2, then addcmul's
// fma(1 − β2, g·g, v); sqrt(v) / √(1 − β2ᵗ) + eps; p + s·(m / d) as one fma,
// s = −lr / (1 − β1ᵗ). Every op is a round-to-nearest intrinsic, so nvcc
// contracts nothing else. The two per-step scalars (s, √(1 − β2ᵗ)) are read
// from the device, so a CUDA graph replays each step with its own.
//
// The tensors' pointers and sizes travel in the kernels' parameters, by value
// (__grid_constant__, at most kMaxTensors, 2.6 KB), so a graph's kernel node
// holds them and no pointer table is uploaded or kept alive.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTensors = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;  // 2,048 elements a block

struct Tensors {
  const float* g[kMaxTensors];
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  int n[kMaxTensors];
  int first[kMaxTensors + 1];  // each tensor's first chunk; first[count]: the chunks of all
  int count;
};

// The step's constants, each rounded to fp32 from the double PyTorch gets.
struct Step {
  float max_norm;
  int clip;     // 0: no clip
  float decay;  // 1 − lr·wd
  float w1;     // 1 − β1, the lerp's weight
  float b2;     // β2
  float w2;     // 1 − β2
  float eps;
};

__device__ __forceinline__ int tensor_of(const Tensors& T, int chunk) {
  int t = 0;
  while (t + 1 < T.count && chunk >= T.first[t + 1]) ++t;
  return t;
}

// The block's sum of x in a fixed order, in every thread: a butterfly within
// each warp (both lanes of a pair add the same two values, so every lane
// holds the same bits), then the same over the warps' sums.
__device__ __forceinline__ float block_sum(float x, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  x = warp_sums[threadIdx.x & (kWarps - 1)];
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// at::lerp as PyTorch's CUDA kernels compile it: one fma on either branch.
__device__ __forceinline__ float lerp(float self, float end, float w) {
  const float diff = __fsub_rn(end, self);
  return fabsf(w) < 0.5f ? __fmaf_rn(w, diff, self) : __fmaf_rn(-diff, __fsub_rn(1.0f, w), end);
}

__global__ void __launch_bounds__(kThreads)
    clip_adamw_norm_kernel(const __grid_constant__ Tensors T, float* __restrict__ partial) {
  __shared__ float warp_sums[kWarps];
  const int b = blockIdx.x, t = tensor_of(T, b);
  const float* __restrict__ g = T.g[t];
  const int lo = (b - T.first[t]) * kChunk, hi = min(lo + kChunk, T.n[t]);
  float x[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = lo + k * kThreads + static_cast<int>(threadIdx.x);
    x[k] = i < hi ? g[i] : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc = __fmaf_rn(x[k], x[k], acc);
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partial[b] = acc;
}

__global__ void __launch_bounds__(kThreads)
    clip_adamw_step_kernel(const __grid_constant__ Tensors T, const float* __restrict__ partial, int parts,
                           const float* __restrict__ adam, Step s, float* __restrict__ norm_out) {
  __shared__ float warp_sums[kWarps];
  const int b = blockIdx.x, t = tensor_of(T, b);
  const int lo = (b - T.first[t]) * kChunk, hi = min(lo + kChunk, T.n[t]);
  const float* __restrict__ gp = T.g[t];
  float* __restrict__ pp = T.p[t];
  float* __restrict__ mp = T.m[t];
  float* __restrict__ vp = T.v[t];
  float g[kPerThread], p[kPerThread], m[kPerThread], v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = lo + k * kThreads + static_cast<int>(threadIdx.x);
    const bool in = i < hi;
    g[k] = in ? gp[i] : 0.0f;
    p[k] = in ? pp[i] : 0.0f;
    m[k] = in ? mp[i] : 0.0f;
    v[k] = in ? vp[i] : 0.0f;
  }
  float sq = 0.0f;
  for (int i = threadIdx.x; i < parts; i += kThreads) sq = __fadd_rn(sq, partial[i]);
  const float norm = __fsqrt_rn(block_sum(sq, warp_sums));
  if (b == 0 && threadIdx.x == 0) *norm_out = norm;
  const bool keep = s.clip == 0 || norm < s.max_norm;
  const float step = adam[0], bias2 = adam[1];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = lo + k * kThreads + static_cast<int>(threadIdx.x);
    if (i >= hi) continue;
    const float gk = keep ? g[k] : __fmul_rn(__fdiv_rn(g[k], norm), s.max_norm);
    const float mk = lerp(m[k], gk, s.w1);
    const float vk = __fmaf_rn(s.w2, __fmul_rn(gk, gk), __fmul_rn(v[k], s.b2));
    const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(vk), bias2), s.eps);
    pp[i] = __fmaf_rn(__fdiv_rn(mk, d), step, __fmul_rn(p[k], s.decay));
    mp[i] = mk;
    vp[i] = vk;
  }
}

}  // namespace

extern "C" {

// Blocks of each launch for `count` tensors of n[t] elements (the length of
// the partials buffer clip_adamw_step takes); -1 where count or a size is
// out of range.
int clip_adamw_blocks(const int64_t* n, int count) {
  if (count < 1 || count > kMaxTensors) return -1;
  int64_t blocks = 0;
  for (int t = 0; t < count; ++t) {
    if (n[t] < 1 || n[t] > INT32_MAX - kChunk) return -1;
    blocks += (n[t] + kChunk - 1) / kChunk;
  }
  return blocks > INT32_MAX ? -1 : static_cast<int>(blocks);
}

// Launches both kernels on `stream`; allocates nothing. g, p, m, v: `count`
// device pointers each, to n[t] fp32 elements; partial: clip_adamw_blocks
// floats of scratch; adam: (step size, √(1 − β2ᵗ)) on the device; norm: one
// float, the gradients' global norm. Returns cudaGetLastError().
int clip_adamw_step(const void* const* g, void* const* p, void* const* m, void* const* v, const int64_t* n,
                    int count, void* partial, const void* adam, float max_norm, int clip, float decay, float w1,
                    float b2, float w2, float eps, void* norm, void* stream) {
  const int blocks = clip_adamw_blocks(n, count);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  Tensors T{};
  T.count = count;
  for (int t = 0; t < count; ++t) {
    T.g[t] = static_cast<const float*>(g[t]);
    T.p[t] = static_cast<float*>(p[t]);
    T.m[t] = static_cast<float*>(m[t]);
    T.v[t] = static_cast<float*>(v[t]);
    T.n[t] = static_cast<int>(n[t]);
    T.first[t + 1] = T.first[t] + static_cast<int>((n[t] + kChunk - 1) / kChunk);
  }
  const Step s{max_norm, clip, decay, w1, b2, w2, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  clip_adamw_norm_kernel<<<blocks, kThreads, 0, st>>>(T, static_cast<float*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  clip_adamw_step_kernel<<<blocks, kThreads, 0, st>>>(T, static_cast<const float*>(partial), blocks,
                                                      static_cast<const float*>(adam), s,
                                                      static_cast<float*>(norm));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
