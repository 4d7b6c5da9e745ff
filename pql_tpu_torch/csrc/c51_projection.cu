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
// 2·B·A + 2·B floats and writes B·A floats (~5.1 MB, ~1.5 us at 3.35 TB/s),
// while the scatter form of the projection needs only O(A) operations per
// row. What the design does about it: every input element is read once
// (coalesced across a warp) and every output element written once; the
// [B, A, A] hat tensor of the plain version never exists, and both twin
// projections share one pos computation and one pass over the rows. The
// hat loop below does O(A^2) operations per row out of shared memory,
// which is simple and deterministic (no atomics) but not the cheapest form.
//
// Layout: one warp per row, WARPS rows per block. The warp stages pos_i,
// p1_i and p2_i of its row in shared memory, then each lane owns the
// destination atoms j = lane, lane + 32, ... and sums over the A source
// atoms. The ragged last block is masked, not padded.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__global__ void c51_td_target_kernel(const float* __restrict__ p1,
                                     const float* __restrict__ p2,
                                     const float* __restrict__ reward,
                                     const float* __restrict__ done,
                                     float* __restrict__ out,
                                     int B, int A, float gamma,
                                     float v_min, float v_max) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B) return;  // warp-uniform: the whole warp leaves together

  float* s_pos = smem + warp * 3 * A;
  float* s_p1 = s_pos + A;
  float* s_p2 = s_p1 + A;
  const bool twin = p2 != nullptr;
  const size_t base = static_cast<size_t>(row) * A;

  const float delta_z = (v_max - v_min) / static_cast<float>(A - 1);
  const float r = reward[row];
  const float scale = (1.0f - done[row]) * gamma;
  for (int i = lane; i < A; i += 32) {
    const float z = static_cast<float>(i) * delta_z + v_min;
    const float tz = fminf(fmaxf(r + scale * z, v_min), v_max);
    s_pos[i] = (tz - v_min) / delta_z;
    s_p1[i] = p1[base + i];
    if (twin) s_p2[i] = p2[base + i];
  }
  __syncwarp();

  for (int j = lane; j < A; j += 32) {
    const float fj = static_cast<float>(j);
    float acc1 = 0.0f, acc2 = 0.0f;
    for (int i = 0; i < A; ++i) {
      const float w = fmaxf(0.0f, 1.0f - fabsf(s_pos[i] - fj));
      acc1 = fmaf(s_p1[i], w, acc1);
      if (twin) acc2 = fmaf(s_p2[i], w, acc2);
    }
    out[base + j] = twin ? fminf(acc1, acc2) : acc1;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for A atoms (the wrapper checks it fits).
int c51_td_target_smem_bytes(int A) {
  return kWarps * 3 * A * static_cast<int>(sizeof(float));
}

// Launches on `stream`; allocates nothing. Returns cudaGetLastError().
int c51_td_target(const void* p1, const void* p2, const void* reward,
                  const void* done, void* out, int B, int A, float gamma,
                  float v_min, float v_max, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (B + kWarps - 1) / kWarps;
  c51_td_target_kernel<<<blocks, kWarps * 32, c51_td_target_smem_bytes(A),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(reward), static_cast<const float*>(done),
      static_cast<float*>(out), B, A, gamma, v_min, v_max);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
