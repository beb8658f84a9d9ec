// The ICP loop's termination test of one iteration in one launch, for Hopper
// (sm_90a): one block (CTA) per problem.
//
// Replaces no TPU kernel: the JAX package tests termination with XLA's ops,
// fused into the align's one program. The port issued the test from Python
// (icp.py ICP._step: the pair count, two finiteness checks, two
// se3.delta_norms, the stall comparisons and the kept pose), some 264 small
// kernels an ICP iteration for ~3 x 6 x 6 floats of arithmetic, the largest
// single item of the host's issue in every benchmark cell once the
// Gauss-Newton solve was one kernel. This kernel does the same test.
//
// What it computes, per problem b:
//   - the pair count: weight > 0 over the rows of every live pairing block,
//     each thread counting rows thread, thread + 256, ..., summed as
//     integers (exact, in any order); no_pairs is the count equal to 0;
//   - solver_ok: every component of new_pose finite;
//   - (dt1, dr1) = delta_norms(pose, new_pose) and (dt2, dr2) =
//     delta_norms(prev_pose, new_pose), by one thread each (two warps), in
//     float32 and in core/se3.py's operation order as PyTorch runs it on the
//     card: every product and sum rounded on its own (__fmul_rn /
//     __fadd_rn, so nvcc contracts nothing into an FMA), a division by a
//     Python number as a product with its float32 reciprocal (PyTorch's
//     CUDA division by a CPU scalar), a division of two tensors and sqrt
//     correctly rounded, acosf / sinf / cosf from the CUDA math library,
//     a comparison with a Python number against that number rounded to
//     float32, and the three-term reductions (torch.sum, vector_norm) in
//     the order of PyTorch's reduce kernel for three elements: two threads,
//     the first adding elements 0 and 2, then the second's element 1;
//     so3_log's near-pi branch and every Taylor guard are kept;
//   - stalled = (dt1 < eps_t & dr1 < eps_r) | (dt2 < eps_t & dr2 < eps_r);
//   - the kept pose: new_pose if solver_ok and not no_pairs, else pose.
// Outputs: the kept pose (R, t), the flags [no_pairs, solver_ok, stalled]
// and the four norms [dt1, dr1, dt2, dr2] (read by the tests).
//
// What bounds it: nothing of the card's. It reads the live blocks' weights
// (4 bytes a row, 24-33 KB a problem in the benchmark's cells: ~10 ns at
// 3.35 TB/s) and three poses, and then one thread's dependent chain of
// ~400 float32 operations and three transcendental calls, a few
// microseconds. The path it serves is set by the host's issue (the card is
// idle ~95% of an odometry frame), so the design takes one launch where
// there were 264, one block per problem with no second pass, and leaves the
// chain serial.
//
// Plain version: ops/icp_terminate.py terminate_plain (the CPU's path, and
// the card's for poses that are not float32).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 5;  // pairing block types, in BLOCK_TYPES order

// core/se3.py's constants as PyTorch's CUDA kernels see them
constexpr float kEps = 1e-8f;                            // _EPS, as float32
constexpr float kInv12 = 1.0f / 12.0f;                   // x / 12.0
constexpr float kInv720 = 1.0f / 720.0f;                 // x / 720.0
constexpr float kTwelfth = static_cast<float>(1.0 / 12.0);  // the number 1.0 / 12.0
constexpr float kNearPi = static_cast<float>(-1.0 + 1e-5);  // cos_theta < -1.0 + 1e-5

struct Args {
  const float* R[3];  // pose, prev_pose, new_pose: [B?, 3, 3]
  const float* t[3];  // [B?, 3]
  const float* w[kBlocks];  // each live block's weights [B?, n]; null: not live
  // elements between two problems' values of each input above (0: shared)
  long long s_R[3], s_t[3], s_w[kBlocks];
  int n[kBlocks];
  float eps_t, eps_r;
  float* out_R;  // [B, 3, 3]
  float* out_t;  // [B, 3]
  bool* out_flags;  // [B, 3]
  float* out_norms;  // [B, 4]
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.sign: 0 for 0 and NaN
__device__ __forceinline__ float sign(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}

// torch.clamp and clamp(min=): NaN passes through
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.sum / the square sum of vector_norm over three elements on the card
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return add(add(a0, a2), a1);
}
__device__ __forceinline__ float norm3(const float* v) {
  return __fsqrt_rn(sum3(mul(v[0], v[0]), mul(v[1], v[1]), mul(v[2], v[2])));
}

// core/se3.py matmul3 (row-major 3 x 3): three products added in index order
__device__ void matmul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = add(add(mul(A[3 * i], B[j]), mul(A[3 * i + 1], B[3 + j])),
                         mul(A[3 * i + 2], B[6 + j]));
}

__device__ void matvec3(const float* A, const float* v, float* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = add(add(mul(A[3 * i], v[0]), mul(A[3 * i + 1], v[1])), mul(A[3 * i + 2], v[2]));
}

// core/se3.py so3_log
__device__ void so3_log(const float* R, float* w) {
  const float trace = add(add(R[0], R[4]), R[8]);
  const float cos_theta = clamp(mul(sub(trace, 1.0f), 0.5f), -1.0f, 1.0f);
  const float theta = acosf(cos_theta);
  if (cos_theta < kNearPi) {
    // near pi: the axis from the diagonal of (R + I) / 2, signs from the
    // entries coupling each component to the largest (the anchor)
    const float diag[3] = {R[0], R[4], R[8]};
    const float off[3] = {add(R[7], R[5]), add(R[2], R[6]), add(R[3], R[1])};
    const float coupling[3][3] = {{diag[0], off[2], off[1]},
                                  {off[2], diag[1], off[0]},
                                  {off[1], off[0], diag[2]}};
    float axis[3];
    for (int i = 0; i < 3; ++i)
      axis[i] = __fsqrt_rn(clamp(mul(add(diag[i], 1.0f), 0.5f), 0.0f, 1.0f));
    int imax = 0;  // torch.argmax: the first NaN, else the first largest
    for (int j = 1; j < 3; ++j)
      if (isnan(axis[j]) ? !isnan(axis[imax]) : axis[j] > axis[imax]) imax = j;
    const float anchor_sign = sign(add(axis[imax], kEps));
    for (int j = 0; j < 3; ++j) {
      const float s = j == imax ? 1.0f : sign(coupling[imax][j]);
      w[j] = mul(mul(mul(theta, axis[j]), s), anchor_sign);
    }
    return;
  }
  // generic: theta / (2 sin theta) * vee(R - R^T), Taylor-guarded near 0
  const float w_vee[3] = {sub(R[7], R[5]), sub(R[2], R[6]), sub(R[3], R[1])};
  const float sin_theta = sinf(theta);
  const float abs_sin = fabsf(sin_theta);
  const float scale =
      abs_sin < 1e-6f ? add(mul(mul(theta, theta), kInv12), 0.5f)
                      : mul(div(theta, mul(2.0f, clamp_min(abs_sin, kEps))), sign(sin_theta));
  for (int j = 0; j < 3; ++j) w[j] = mul(scale, w_vee[j]);
}

// core/se3.py delta_norms(a, b): the norms of log(inverse(a) o b)
__device__ void delta_norms(const float* Ra, const float* ta, const float* Rb,
                            const float* tb, float* dt, float* dr) {
  // inverse(a): R^T, -R^T t
  float Rt[9], t_inv[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = Ra[3 * j + i];
  matvec3(Rt, ta, t_inv);
  for (int i = 0; i < 3; ++i) t_inv[i] = -t_inv[i];
  // compose(inverse(a), b)
  float R[9], t[3];
  matmul3(Rt, Rb, R);
  matvec3(Rt, tb, t);
  for (int i = 0; i < 3; ++i) t[i] = add(t[i], t_inv[i]);
  // log: theta = so3_log(R), rho = so3_left_jacobian_inv(theta) t
  float w[3];
  so3_log(R, w);
  const float theta_sq = sum3(mul(w[0], w[0]), mul(w[1], w[1]), mul(w[2], w[2]));
  const float theta = __fsqrt_rn(add(theta_sq, kEps));
  const float W[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0], -w[1], w[0], 0.0f};
  const float half = mul(0.5f, theta);
  const float cot =
      theta_sq < kEps
          ? add(mul(theta_sq, kInv720), kTwelfth)
          : div(sub(1.0f, div(mul(half, cosf(half)), clamp_min(sinf(half), kEps))),
                clamp_min(theta_sq, kEps));
  float WW[9], J[9], rho[3];
  matmul3(W, W, WW);
  for (int k = 0; k < 9; ++k)
    J[k] = add(sub(k % 4 == 0 ? 1.0f : 0.0f, mul(0.5f, W[k])), mul(cot, WW[k]));
  matvec3(J, t, rho);
  *dt = norm3(rho);
  *dr = norm3(w);
}

__global__ void __launch_bounds__(kThreads) terminate_kernel(Args a) {
  __shared__ int warp_pairs[kWarps];
  __shared__ float norms[4];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int pairs = 0;
  for (int k = 0; k < kBlocks; ++k) {
    if (a.w[k] == nullptr) continue;
    const float* w = a.w[k] + b * a.s_w[k];
    for (int i = threadIdx.x; i < a.n[k]; i += kThreads) pairs += w[i] > 0.0f;
  }
  pairs = __reduce_add_sync(0xffffffffu, pairs);
  if (lane == 0) warp_pairs[warp] = pairs;

  // the two step norms, one warp each, beside the count
  if (lane == 0 && warp < 2) {
    const float* Ra = a.R[warp] + b * a.s_R[warp];
    const float* ta = a.t[warp] + b * a.s_t[warp];
    delta_norms(Ra, ta, a.R[2] + b * a.s_R[2], a.t[2] + b * a.s_t[2], &norms[2 * warp],
                &norms[2 * warp + 1]);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kWarps; ++k) total += warp_pairs[k];
    const float* R = a.R[0] + b * a.s_R[0];
    const float* t = a.t[0] + b * a.s_t[0];
    const float* Rn = a.R[2] + b * a.s_R[2];
    const float* tn = a.t[2] + b * a.s_t[2];
    bool solver_ok = true;
    for (int k = 0; k < 9; ++k) solver_ok = solver_ok && isfinite(Rn[k]);
    for (int k = 0; k < 3; ++k) solver_ok = solver_ok && isfinite(tn[k]);
    const bool no_pairs = total == 0;
    const bool stalled = (norms[0] < a.eps_t && norms[1] < a.eps_r) ||
                         (norms[2] < a.eps_t && norms[3] < a.eps_r);
    const bool keep_new = solver_ok && !no_pairs;
    for (int k = 0; k < 9; ++k) a.out_R[b * 9 + k] = keep_new ? Rn[k] : R[k];
    for (int k = 0; k < 3; ++k) a.out_t[b * 3 + k] = keep_new ? tn[k] : t[k];
    a.out_flags[b * 3] = no_pairs;
    a.out_flags[b * 3 + 1] = solver_ok;
    a.out_flags[b * 3 + 2] = stalled;
    for (int k = 0; k < 4; ++k) a.out_norms[b * 4 + k] = norms[k];
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). B problems, one block each. Each
// input pointer has its stride in elements between two problems (0: one
// input shared by every problem); a pairing block that is not live has a
// null pointer and n = 0. Launches on `stream`, does not synchronise and
// allocates nothing; returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int mp2p_icp_terminate_f32(
    const float* R, long long s_R, const float* t, long long s_t, const float* prev_R,
    long long s_prev_R, const float* prev_t, long long s_prev_t, const float* new_R,
    long long s_new_R, const float* new_t, long long s_new_t,
    const float* w0, long long s_w0, int n0, const float* w1, long long s_w1, int n1,
    const float* w2, long long s_w2, int n2, const float* w3, long long s_w3, int n3,
    const float* w4, long long s_w4, int n4, int B, float eps_t, float eps_r,
    float* out_R, float* out_t, bool* out_flags, float* out_norms, void* stream) {
  if (B <= 0) return 0;
  Args a;
  const float* Rs[3] = {R, prev_R, new_R};
  const float* ts[3] = {t, prev_t, new_t};
  const long long s_Rs[3] = {s_R, s_prev_R, s_new_R};
  const long long s_ts[3] = {s_t, s_prev_t, s_new_t};
  for (int k = 0; k < 3; ++k) {
    a.R[k] = Rs[k];
    a.t[k] = ts[k];
    a.s_R[k] = s_Rs[k];
    a.s_t[k] = s_ts[k];
  }
  const float* ws[kBlocks] = {w0, w1, w2, w3, w4};
  const long long s_ws[kBlocks] = {s_w0, s_w1, s_w2, s_w3, s_w4};
  const int ns[kBlocks] = {n0, n1, n2, n3, n4};
  for (int k = 0; k < kBlocks; ++k) {
    a.w[k] = ws[k];
    a.s_w[k] = s_ws[k];
    a.n[k] = ns[k];
  }
  a.eps_t = eps_t;
  a.eps_r = eps_r;
  a.out_R = out_R;
  a.out_t = out_t;
  a.out_flags = out_flags;
  a.out_norms = out_norms;
  terminate_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
