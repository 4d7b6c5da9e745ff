// C51 target projection for the PQL-D critic, fused over the twin heads.
//
// Replaces the TPU kernel pql_tpu/ops/pallas.py::_projection_kernel
// (launched by categorical_projection_pallas, twice per target by
// categorical_td_target_pallas). For each row b:
//
//   pos_i  = (clip(r_b + (1 - d_b) * gamma * z_i, v_min, v_max) - v_min) / dz,
//   z_i    = i * dz + v_min,
//   proj_j = sum_i p_i * max(0, 1 - |pos_i - j|),
//   out_j  = min(proj(p1)_j, proj(p2)_j)      (twin mode; p2 == nullptr: proj(p1)_j)
//
// What bounds it on an H100: bytes. At B = 8192, A = 51 a twin call reads
// 2·B·A + 2·B floats and writes B·A floats: 5.08 MB, 1.52 us at 3.35 TB/s.
// The arithmetic the function needs is O(A) per row.
//
// The first version (one warp per row, each lane summing the hat weights of
// all A sources for its destination atoms j and j + 32) did O(A^2) work per
// row: 2 x 51 x 3 = 306 shared-memory loads per row at A = 51, about 19 k
// shared-load instructions per SM at B = 8192, which is what its 12.7 us
// measured; 13 of its 64 lane slots per row were idle, and its global loads
// were scalar.
//
// This design does O(A) work per row in the scatter form: source i gives
// p_i * (1 - f_i) to atom l_i = floor(pos_i) and p_i * f_i to l_i + 1, with
// f_i = pos_i - l_i. pos is affine in i and then clipped, so it is monotone in
// i (non-decreasing when (1 - d) * gamma >= 0, non-increasing otherwise; each
// float operation rounds monotonically, so the computed pos is monotone too).
// Walking each row's sources in the order that makes l non-decreasing puts the
// sources of one destination in one contiguous run of that walk. Each lane
// takes kPerLane consecutive sources of one row and sums its runs in
// registers; one segmented scan over the warp's lanes joins the runs that
// cross lanes (clipped ends, done rows where every source shares one pos), and
// the last source of each run writes its sums. Every destination has at most
// one writer and no atomics are used, so two calls on the same inputs give
// bitwise-equal output. The destination j then reads run j's (1 - f) part and
// run j-1's f part.
//
// Layout and bytes: each warp owns whole rows, one contiguous span of
// rows x A floats of each input and of the output, and shares nothing with the
// other warps. It stages its span of p1 and p2 in shared memory with 16-byte
// cp.async copies (4-byte copies for the unaligned head and tail, and for
// reward and done), computes, and writes its output span back with 16-byte
// stores; it synchronises only with itself, so a warp computes as soon as its
// own bytes have landed. A row is ceil(A / 7) lane chunks of up to 7 sources;
// at A = 51 that is 8 chunks (56 slots for 51 sources), so a warp owns 4 rows
// and all 32 lanes hold a chunk; 2048 warps at B = 8192, in blocks of 4.
// Per source, pos takes a reciprocal and one FMA correction in place of the
// division and its slow path (same bits, see pass 1). The ragged last block
// is masked, not padded.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Sources per lane chunk; odd, so lanes that read shared memory at a stride of
// kPerLane floats spread over the banks.
constexpr int kPerLane = 7;
constexpr int kMaxSmem = 232448;  // shared memory one block may use on sm_90
constexpr unsigned kFull = 0xffffffffu;

// The rows one warp owns and the shared memory it stages them in.
struct Tile {
  int chunks_per_row, rows, pairs, stride;

  __host__ __device__ explicit Tile(int A) {
    chunks_per_row = (A + kPerLane - 1) / kPerLane;
    rows = chunks_per_row < 32 ? 32 / chunks_per_row : 1;
    pairs = rows * A;
    stride = (pairs + 4 + 3) & ~3;  // up to 3 floats of alignment pad
  }
  // run sums (float4 per pair) | out | p1 | p2 | reward | done
  __host__ __device__ int floats() const { return 4 * pairs + 3 * stride + 2 * ((rows + 3) & ~3); }
  __host__ __device__ size_t block_smem_bytes() const { return sizeof(float) * kWarps * static_cast<size_t>(floats()); }
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Floats from `p` up to the next 16-byte boundary (at most n).
__device__ __forceinline__ int head_floats(const float* p, int n) {
  const int h = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2);
  return h < n ? h : n;
}

// Shared-memory offset that gives element e of `p` the same alignment mod 16
// bytes in shared memory as in global memory.
__device__ __forceinline__ int smem_pad(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15u) >> 2);
}

// The warp starts copying n floats from global `src` to shared `dst + smem_pad(src)`.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int lane) {
  dst += smem_pad(src);
  const int head = head_floats(src, n);
  const int nvec = (n - head) >> 2;
  if (lane < head) cp_async4(dst + lane, src + lane);
  for (int v = lane; v < nvec; v += 32) cp_async16(dst + head + 4 * v, src + head + 4 * v);
  const int e = head + 4 * nvec + lane;
  if (e < n) cp_async4(dst + e, src + e);
}

// q / d for 0 <= q < 2^22 and small d: the float quotient is off by at most one.
__device__ __forceinline__ int div_small(int q, int d, float inv_d) {
  int r = __float2int_rz((static_cast<float>(q) + 0.5f) * inv_d);
  const int rem = q - r * d;
  r += rem < 0 ? -1 : (rem >= d ? 1 : 0);
  return r;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <bool kTwin>
__device__ __forceinline__ float4 shfl_up4(float4 v, int off) {
  float4 u = make_float4(__shfl_up_sync(kFull, v.x, off), __shfl_up_sync(kFull, v.y, off), 0.f, 0.f);
  if constexpr (kTwin) {
    u.z = __shfl_up_sync(kFull, v.z, off);
    u.w = __shfl_up_sync(kFull, v.w, off);
  }
  return u;
}

template <bool kTwin>
__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  float4 u = make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src), 0.f, 0.f);
  if constexpr (kTwin) {
    u.z = __shfl_sync(kFull, v.z, src);
    u.w = __shfl_sync(kFull, v.w, src);
  }
  return u;
}

struct Args {
  const float* p1;
  const float* p2;
  const float* reward;
  const float* done;
  float* out;
  int B, A;
  float gamma, v_min, v_max;
  Tile tile;
  float dz, inv_dz, inv_cpr;  // dz = (v_max - v_min) / (A - 1), IEEE-rounded as on the card
};

// One warp projects its rows: it stages them, sums each run of sources with
// one key (pass 1), forms its outputs (pass 2) and stores them. Warps share
// nothing, so they synchronise only within themselves.
template <bool kTwin>
__global__ void __launch_bounds__(kThreads) c51_td_target_kernel(Args g) {
  extern __shared__ float4 smem[];
  const Tile& tile = g.tile;
  const int A = g.A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + warp) * tile.rows;
  if (row0 >= g.B) return;  // the ragged last block: a warp without rows leaves
  const int rows = min(tile.rows, g.B - row0);
  const int n = rows * A;
  const size_t g0 = static_cast<size_t>(row0) * A;

  float4* s_run = smem + static_cast<size_t>(warp) * (tile.floats() / 4);
  float* s_out = reinterpret_cast<float*>(s_run + tile.pairs);
  float* s_p1 = s_out + tile.stride;
  float* s_p2 = s_p1 + tile.stride;
  float* s_r = s_p2 + tile.stride;
  float* s_d = s_r + ((tile.rows + 3) & ~3);

  stage(s_p1, g.p1 + g0, n, lane);
  if constexpr (kTwin) stage(s_p2, g.p2 + g0, n, lane);
  for (int k = lane; k < rows; k += 32) {
    cp_async4(s_r + k, g.reward + row0 + k);
    cp_async4(s_d + k, g.done + row0 + k);
  }
  cp_async_commit();
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q = lane; q < n; q += 32) s_run[q] = zero;  // destinations no run reaches stay 0
  cp_async_wait_all();
  __syncwarp();

  const float* p1s = s_p1 + smem_pad(g.p1 + g0);
  const float* p2s = kTwin ? s_p2 + smem_pad(g.p2 + g0) : nullptr;
  float* outs = s_out + smem_pad(g.out + g0);
  const float dz = g.dz, inv_dz = g.inv_dz, inv_cpr = g.inv_cpr;
  const int cpr = tile.chunks_per_row;
  const int chunks = rows * cpr;  // lane chunks of kPerLane sources, one row each

  // Pass 1: per source, (p1 (1-f), p1 f, p2 (1-f), p2 f) keyed by its
  // destination pair row * A + l; sum each run of equal keys. A lane past the
  // warp's chunks reads its last chunk and gets the key INT_MAX; sources past
  // a row's end repeat its last source with zero mass.
  int carry_key = -1;  // a run that continues into the next pass
  float4 carry = zero;
  for (int base = 0; base < chunks; base += 32) {
    const int chunk = min(base + lane, chunks - 1);
    const int row = div_small(chunk, cpr, inv_cpr);
    const int t0 = (chunk - row * cpr) * kPerLane;  // first walk position of this chunk
    const int len = min(kPerLane, A - t0);
    const float last_m = static_cast<float>(len - 1);
    const float scale = (1.0f - s_d[row]) * g.gamma;
    const float rew = s_r[row];
    const bool down = scale < 0.0f;  // then pos falls with i: walk i = A-1-t
    const int row_a = row * A;
    const int src0 = down ? row_a + A - 1 - t0 : row_a + t0;
    const int step = down ? -1 : 1;
    const float fi0 = static_cast<float>(down ? A - 1 - t0 : t0);
    const float fstep = down ? -1.0f : 1.0f;
    const bool live = base + lane < chunks;
    int key[kPerLane];
    float4 acc[kPerLane];
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const float fi = fmaf(fstep, fminf(static_cast<float>(m), last_m), fi0);
      const float z = fi * dz + g.v_min;
      const float tz = fminf(fmaxf(rew + scale * z, g.v_min), g.v_max);
      // pos = x / dz, correctly rounded: one FMA correction of x * RN(1/dz)
      // gives the IEEE quotient (Markstein) without the division's slow path
      const float x = tz - g.v_min;
      const float y = x * inv_dz;
      const float pos = fmaf(fmaf(-y, dz, x), inv_dz, y);
      const float fl = floorf(pos);
      const float f = pos - fl;
      // pos <= A - 1 up to rounding; the unsigned min keeps even a NaN in the row
      const unsigned l = min(static_cast<unsigned>(static_cast<int>(fl)), static_cast<unsigned>(A - 1));
      const float a = m < len ? p1s[src0 + step * m] : 0.0f;
      acc[m] = make_float4(a * (1.0f - f), a * f, 0.f, 0.f);
      if constexpr (kTwin) {
        const float b = m < len ? p2s[src0 + step * m] : 0.0f;
        acc[m].z = b * (1.0f - f);
        acc[m].w = b * f;
      }
      key[m] = live ? row_a + static_cast<int>(l) : INT_MAX;
    }
    if (lane == 0 && carry_key >= 0) {
      if (key[0] == carry_key) {
        acc[0] = add4(carry, acc[0]);
      } else {
        s_run[carry_key] = carry;
      }
    }
#pragma unroll
    for (int m = 1; m < kPerLane; ++m) {  // runs inside the lane
      if (key[m] == key[m - 1]) acc[m] = add4(acc[m - 1], acc[m]);
    }
    // Runs across lanes: segmented inclusive scan of the lanes' last runs over
    // lanes of equal last key (all but the first lane of a segment hold one
    // run only).
    const int k0 = key[0], kl = key[kPerLane - 1];
    float4 tail = acc[kPerLane - 1];
    const int prev_kl = __shfl_up_sync(kFull, kl, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev_kl != kl);
    const int run_pos = lane - (31 - __clz(heads & (kFull >> (31 - lane))));
    const int longest = __reduce_max_sync(kFull, run_pos);
    for (int off = 1; off <= longest; off <<= 1) {
      const float4 u = shfl_up4<kTwin>(tail, off);
      if (run_pos >= off) tail = add4(u, tail);
    }
#pragma unroll
    for (int m = 0; m < kPerLane - 1; ++m) {  // runs that end inside the lane
      if (key[m] != key[m + 1]) s_run[key[m]] = acc[m];
    }
    // The lanes before add to this lane's first run; if it ended inside the
    // lane (it is not also the last), add them to what the lane just wrote.
    const float4 before = shfl_up4<kTwin>(tail, 1);
    if (lane > 0 && prev_kl == k0 && k0 != kl) s_run[k0] = add4(before, s_run[k0]);
    const bool last_pass = base + 32 >= chunks;
    const int next_k0 = __shfl_down_sync(kFull, k0, 1);
    if (kl != INT_MAX && (lane < 31 ? next_k0 != kl : last_pass)) s_run[kl] = tail;  // the run's one writer
    carry_key = -1;
    if (!last_pass) {  // lane 31's last run may go on in the next pass
      carry_key = __shfl_sync(kFull, kl == INT_MAX ? -1 : kl, 31);
      carry = shfl4<kTwin>(tail, 31);
    }
  }
  __syncwarp();

  // Pass 2: out_j = run_j's (1-f) part + run_{j-1}'s f part, min over twins.
  for (int chunk = lane; chunk < chunks; chunk += 32) {
    const int row = div_small(chunk, cpr, inv_cpr);
    const int j0 = (chunk - row * cpr) * kPerLane;
    const int len = min(kPerLane, A - j0);
    const int q0 = row * A + j0;
    float4 below = j0 > 0 ? s_run[q0 - 1] : zero;
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      if (m < len) {
        const float4 here = s_run[q0 + m];
        const float o1 = here.x + below.y, o2 = here.z + below.w;
        outs[q0 + m] = kTwin ? fminf(o1, o2) : o1;
        below = here;
      }
    }
  }
  __syncwarp();

  // The warp's rows are one contiguous span of `out`: 16-byte stores.
  float* dst = g.out + g0;
  const int head = head_floats(dst, n);
  const int nvec = (n - head) >> 2;
  if (lane < head) dst[lane] = outs[lane];
  for (int v = lane; v < nvec; v += 32) {
    *reinterpret_cast<float4*>(dst + head + 4 * v) = *reinterpret_cast<const float4*>(outs + head + 4 * v);
  }
  const int e = head + 4 * nvec + lane;
  if (e < n) dst[e] = outs[e];
}

}  // namespace

extern "C" {

// Shared memory one block needs for A atoms; the kernel takes A while this
// stays within 232,448 bytes (A <= 512 needs at most 57,664).
int c51_td_target_smem_bytes(int A) {
  return A < 2 ? 0 : static_cast<int>(Tile(A).block_smem_bytes());
}

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
int c51_td_target(const void* p1, const void* p2, const void* reward,
                  const void* done, void* out, int B, int A, float gamma,
                  float v_min, float v_max, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (A < 2 || c51_td_target_smem_bytes(A) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = c51_td_target_smem_bytes(A);
  const Tile tile(A);
  const int blocks = (B + kWarps * tile.rows - 1) / (kWarps * tile.rows);
  auto kernel = p2 != nullptr ? c51_td_target_kernel<true> : c51_td_target_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float dz = (v_max - v_min) / static_cast<float>(A - 1);
  const Args args{static_cast<const float*>(p1), static_cast<const float*>(p2),
                  static_cast<const float*>(reward), static_cast<const float*>(done),
                  static_cast<float*>(out), B, A, gamma, v_min, v_max, tile,
                  dz, 1.0f / dz, 1.0f / static_cast<float>(tile.chunks_per_row)};
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
