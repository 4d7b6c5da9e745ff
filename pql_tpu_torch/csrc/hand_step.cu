// The in-hand cube task's whole control step (AllegroHand, ShadowHand, flat
// palm) in one launch, one thread per env.
//
// It replaces no TPU kernel: the JAX package's hand step
// (pql_tpu/envs/hand.py) is plain jnp under jit, which XLA fuses. The port's
// first form of it on a card was the eager step captured as one CUDA graph
// (pql_tpu_torch/envs/rigid.py::GraphedStep): 99,957 kernel nodes a control
// step on AllegroHand, each an elementwise op on [E] columns, each costing
// ~1.1-1.5 us of the device's time whatever E is. At 8,192 envs a replay took
// ~111 ms for ~1.1 G operations.
//
// What the step is: per env, 8 substeps of kinematics, body velocities, the
// anchored contacts (finger spheres vs the palm and vs the cube, the cube's
// corners vs the palm), the mass matrix (CRBA), the bias forces (RNEA), the
// actuation, an unrolled Cholesky solve and a semi-implicit Euler step; then
// the reward, the success and fall checks, the goal's re-draw and the
// non-finite check. About 1.3e5 fp32 operations per env (134,026 on
// AllegroHand), on ~1.8 KB of state read and written once. It is bound by
// operations: at 8,192 envs ~1.1 G operations against 67 TFLOP/s is ~16 us,
// the 14 MB of state at 3.35 TB/s ~4 us.
//
// Why one thread per env: envs share nothing, and within one env the step is
// a long chain of dependent scalar ops on ~220 live values (q 23, qd 22, the
// contact state 160, the action 16), with no wide data-parallel axis to
// split across lanes without shuffles at every op. A thread keeps its env in
// registers (and local memory where the registers run out) across the
// substeps and touches global memory twice: one read of its rows, one write.
// The price is occupancy: 8,192 threads are ~2 warps an SM on 132 SMs, so the
// kernel is latency-bound, far above its bound, and still ~100x under the
// graph: on an H100 it takes ~1.14 ms at 8,192 envs and ~1.56 ms at 16,384.
//
// The substep (hand_substep) and the step's end (hand_finish) are generated,
// not written here: the port's own scalar algebra (_step_parts with the
// per-pair anchored contacts, and the hand's _finish_s) runs once on symbolic
// columns and each op it issues becomes one statement
// (pql_tpu_torch/physics/codegen.py; the header hand_step_body.h is written
// next to the build). Every statement rounds as the eager torch op does:
// fp32, Python constants as fp32 literals, IEEE division and sqrt, clamp
// and minimum passing NaN through, and no FMA contraction (built
// with -fmad=false). Sums over pairs run left to right, where the eager
// vectorized groups reduce with torch.sum, so results match the eager step
// to rounding, not bit for bit.
//
// The substep loop stays rolled (8 copies of ~17k statements would multiply
// ptxas's time). __launch_bounds__(128) allows blocks of 32, 64 or 128
// threads and still lets a thread use 255 registers.
//
// Built without nvcc (a C++ compiler alone, as the CPU tests do), the file
// gives hand_control_step_host, the same per-env function over a loop.

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PQL_DEVICE __device__ __forceinline__
#define PQL_ISFINITE(x) isfinite(x)
#else
#define PQL_DEVICE inline
#define PQL_ISFINITE(x) std::isfinite(x)
#endif

// torch's NaN handling: clamp and minimum return a NaN operand
PQL_DEVICE float pql_clamp(float x, float lo, float hi) { return x != x ? x : fminf(fmaxf(x, lo), hi); }
PQL_DEVICE float pql_clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
PQL_DEVICE float pql_clamp_max(float x, float hi) { return x != x ? x : fminf(x, hi); }
PQL_DEVICE float pql_minimum(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }
PQL_DEVICE float pql_sign(float x) { return static_cast<float>((0.0f < x) - (x < 0.0f)); }
PQL_DEVICE bool pql_isfinite(float x) { return PQL_ISFINITE(x); }

// HAND_NQ, HAND_NV, HAND_NC, HAND_NU, HAND_SUBSTEPS, hand_substep, hand_finish
#include "hand_step_body.h"

namespace {

struct HandArgs {
  const float* q;        // [E, NQ]
  const float* qd;       // [E, NV]
  const float* contact;  // [E, NC]
  const float* target;   // [E, 4]
  const float* action;   // [E, NU]
  const float* draw;     // [E, 3]
  float* q_out;
  float* qd_out;
  float* contact_out;
  float* target_out;
  float* reward;         // [E]
  bool* terminated;      // [E]
  float* success;        // [E]
  int envs;
};

PQL_DEVICE void hand_env_step(const HandArgs& a, int64_t e) {
  float q[HAND_NQ], qd[HAND_NV], cs[HAND_NC], act[HAND_NU], target[4], draw[3];
#pragma unroll
  for (int k = 0; k < HAND_NQ; ++k) q[k] = a.q[e * HAND_NQ + k];
#pragma unroll
  for (int k = 0; k < HAND_NV; ++k) qd[k] = a.qd[e * HAND_NV + k];
#pragma unroll
  for (int k = 0; k < HAND_NC; ++k) cs[k] = a.contact[e * HAND_NC + k];
#pragma unroll
  for (int k = 0; k < HAND_NU; ++k) act[k] = a.action[e * HAND_NU + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) target[k] = a.target[e * 4 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) draw[k] = a.draw[e * 3 + k];

#pragma unroll 1
  for (int s = 0; s < HAND_SUBSTEPS; ++s) hand_substep(q, qd, cs, act);

  float reward, success;
  bool terminated;
  hand_finish(q, target, act, draw, &reward, &terminated, &success);

#pragma unroll
  for (int k = 0; k < HAND_NQ; ++k) a.q_out[e * HAND_NQ + k] = q[k];
#pragma unroll
  for (int k = 0; k < HAND_NV; ++k) a.qd_out[e * HAND_NV + k] = qd[k];
#pragma unroll
  for (int k = 0; k < HAND_NC; ++k) a.contact_out[e * HAND_NC + k] = cs[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) a.target_out[e * 4 + k] = target[k];
  a.reward[e] = reward;
  a.terminated[e] = terminated;
  a.success[e] = success;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(128) hand_control_step_kernel(HandArgs a) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < a.envs) hand_env_step(a, e);
}
#endif

}  // namespace

extern "C" {

// The sizes the library was generated for (the header's; the tests read them).
int hand_step_sizes(int* nq, int* nv, int* nc, int* nu, int* substeps) {
  *nq = HAND_NQ;
  *nv = HAND_NV;
  *nc = HAND_NC;
  *nu = HAND_NU;
  *substeps = HAND_SUBSTEPS;
  return 0;
}

#ifdef __CUDACC__
// One control step of `envs` envs on `stream`, blocks of `block` threads
// (1..128). Returns the launch's cudaError_t (0 on success).
int hand_control_step(const float* q, const float* qd, const float* contact, const float* target,
                      const float* action, const float* draw, float* q_out, float* qd_out, float* contact_out,
                      float* target_out, float* reward, bool* terminated, float* success, int envs, int block,
                      void* stream) {
  if (envs <= 0) return 0;
  if (block < 1 || block > 128) return static_cast<int>(cudaErrorInvalidValue);
  HandArgs a{q, qd, contact, target, action, draw, q_out, qd_out, contact_out, target_out,
             reward, terminated, success, envs};
  const int grid = (envs + block - 1) / block;
  hand_control_step_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
#else
// The same per-env step over a loop on the host.
int hand_control_step_host(const float* q, const float* qd, const float* contact, const float* target,
                           const float* action, const float* draw, float* q_out, float* qd_out, float* contact_out,
                           float* target_out, float* reward, bool* terminated, float* success, int envs) {
  HandArgs a{q, qd, contact, target, action, draw, q_out, qd_out, contact_out, target_out,
             reward, terminated, success, envs};
  for (int64_t e = 0; e < envs; ++e) hand_env_step(a, e);
  return 0;
}
#endif

}  // extern "C"
