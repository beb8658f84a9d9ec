// One Gauss-Newton solve of the live point blocks, every inner iteration, in
// one launch, for Hopper (sm_90a): one block (CTA) per problem.
//
// Replaces no TPU kernel: the JAX package leaves the solver to XLA, which
// fuses it into the align's one program. The port issued it from Python
// (solvers/gauss_newton.py: optimal_tf_gauss_newton over all five pairing
// blocks after float64 copies of each), some 400 small kernels per inner
// iteration, 1,264 launches an ICP iteration of the odometry stream, which
// kept the card idle while the host issued them. This kernel does the same
// arithmetic for the blocks that the benchmark's matchers emit, point to
// point and point to plane, with no robust kernel and no prior.
//
// What it computes, per problem b and for each of `iterations` inner steps:
//   - every row of the pt2pt block (local l, global q, weight) and of the
//     pt2pl block (local l, plane centroid c, unit normal n, weight), read
//     as float32 and widened to float64 (exact), weights scaled by the
//     block's pair weight;
//   - pt2pt in the closed form of _pt2pt_closed_form: sum w, sum w l,
//     sum w l l^T, sum w |l|^2, g = [sum w R^T r ; sum w l x R^T r] with
//     r = R l + t - q, and the error sum w |r|^2;
//   - pt2pl: u = [R^T n ; l x R^T n], e = n . (R l + t - c): H += w u u^T,
//     g += w e u, error += w e^2;
//   - each thread sums its rows (row = thread, thread + 256, ...) in that
//     order, the threads of a warp are added by a shuffle tree, the warps
//     in warp order: one fixed order, the same whatever the number of
//     problems in the launch, so a batch equals its problems launched one
//     by one, bit for bit;
//   - one thread then solves as solve_normal_equations does: damping on the
//     diagonal, Jacobi equilibration, Cholesky (a pivot that is not > 0, or
//     NaN, gives NaN), one refinement step, a non-finite delta component
//     taken as 0; then T <- T exp(delta) with core/se3.py's formulas and
//     product order, and the keep logic of optimal_tf_gauss_newton (a step
//     is kept unless the problem was done or its cost reached max_cost; it
//     is done once the cost reached max_cost or |delta| < min_delta).
// The pose stays in float64 between the inner steps and is rounded to
// float32 once, at the end.
//
// What bounds it: float64 arithmetic on one SM. A pt2pt row costs ~90 and a
// pt2pl row ~115 float64 operations an inner step, so 6,144 pt2pl rows x 3
// steps are 2.1 MFLOP: 0.06 us at the card's 34 TFLOP/s of float64 (vector
// units), but 8.2 us on the one SM a problem runs on (64 float64 FMA a
// clock), and ~3 us of the one thread's 6 x 6 solve and SE(3) update. The
// bytes are 40 (28) a pt2pl (pt2pt) row a step, read from L2 after the
// first step. The design takes that bound on purpose: the path it serves
// is set by the host's issue, not by device time (the odometry frame is
// ~96% idle), so one block per problem is enough, needs no second pass or
// atomics across blocks, and keeps the summation order fixed. 256 threads
// keep 46 float64 sums each in registers.
//
// Plain version: solvers/gauss_newton.py optimal_tf_gauss_newton under
// solvers/solver.py solve_in_f64 (the CPU path, and the card's for every
// other solve).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// pt2pt sums: sum w, sum w l (3), sum w l l^T (00 01 02 11 12 22), sum w
// |l|^2, g (6), error
constexpr int kPt = 18;
// pt2pl sums: H's upper triangle row by row (21), g (6), error
constexpr int kPl = 28;

struct Args {
  const float* pt_local;  // [B?, n_pt, 3]
  const float* pt_global;
  const float* pt_weight;  // [B?, n_pt]
  const float* pl_local;  // [B?, n_pl, 3]
  const float* pl_centroid;
  const float* pl_normal;
  const float* pl_weight;  // [B?, n_pl]
  const float* R;  // [B?, 3, 3]
  const float* t;  // [B?, 3]
  // elements between two problems' rows of each input above (0: shared)
  long long stride[9];
  int n_pt, n_pl, iterations;
  double min_delta, max_cost, damping, w_pt, w_pl;
  float* out_R;  // [B, 3, 3]
  float* out_t;  // [B, 3]
};

__device__ inline void load3(const float* p, int row, double (&v)[3]) {
  v[0] = (double)p[3 * row];
  v[1] = (double)p[3 * row + 1];
  v[2] = (double)p[3 * row + 2];
}

// the sums of every thread of the block, in one fixed order, into out[N]
// (written by the first N threads; visible to all after the call)
template <int N>
__device__ void block_sum(const double (&acc)[N], double (*scratch)[kPl], double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    double v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) scratch[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = scratch[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += scratch[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// 3 x 3 products as core/se3.py's matmul3: three products added in index order
__device__ inline void matmul3(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ inline void matvec3(const double* A, const double* v, double* out) {
  for (int i = 0; i < 3; ++i) out[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

// x = (L L^T)^-1 b for the lower factor L
__device__ inline void cholesky_solve(const double (&L)[6][6], const double* b, double* x) {
  double z[6];
  for (int i = 0; i < 6; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * z[k];
    z[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double s = z[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// One inner step's solve and pose update from the block's sums (one thread):
// pose = [R row-major (9), t (3)] in float64, updated in place.
__device__ void solve_and_update(const Args& a, const double* s_pt, const double* s_pl,
                                 double* pose, int* done) {
  // H, g and the error: the pt2pt closed form, then the pt2pl sums
  const double sw = s_pt[0], sl[3] = {s_pt[1], s_pt[2], s_pt[3]}, lsq = s_pt[10];
  const double M[3][3] = {{s_pt[4], s_pt[5], s_pt[6]},
                          {s_pt[5], s_pt[7], s_pt[8]},
                          {s_pt[6], s_pt[8], s_pt[9]}};
  const double hat_l[3][3] = {{0.0, -sl[2], sl[1]}, {sl[2], 0.0, -sl[0]}, {-sl[1], sl[0], 0.0}};
  double H[6][6], g[6];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      H[i][j] = i == j ? sw : 0.0;
      H[i][3 + j] = -hat_l[i][j];
      H[3 + i][j] = hat_l[i][j];
      H[3 + i][3 + j] = (i == j ? lsq : 0.0) - M[i][j];
    }
  }
  for (int i = 0, k = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j, ++k) {
      H[i][j] += s_pl[k];
      if (j != i) H[j][i] += s_pl[k];
    }
  }
  for (int i = 0; i < 6; ++i) g[i] = s_pt[11 + i] + s_pl[21 + i];
  const double err = s_pt[17] + s_pl[27];

  // solve_normal_equations(H + damping I, g)
  double d[6], Hs[6][6], gs[6], L[6][6], y[6];
  for (int i = 0; i < 6; ++i) H[i][i] += a.damping;
  for (int i = 0; i < 6; ++i) {
    const double h = H[i][i] < 1e-30 ? 1e-30 : H[i][i];  // a NaN stays NaN
    d[i] = 1.0 / sqrt(h);
  }
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) Hs[i][j] = H[i][j] * d[i] * d[j];
    gs[i] = g[i] * d[i];
  }
  bool ok = true;
  for (int j = 0; j < 6; ++j) {
    double s = Hs[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    if (!(s > 0.0)) ok = false;
    L[j][j] = sqrt(s);
    for (int i = j + 1; i < 6; ++i) {
      double v = Hs[i][j];
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / L[j][j];
    }
  }
  if (ok) {
    double r[6], y2[6];
    cholesky_solve(L, gs, y);
    for (int i = 0; i < 6; ++i) {
      double s = 0.0;
      for (int j = 0; j < 6; ++j) s += Hs[i][j] * y[j];
      r[i] = gs[i] - s;
    }
    cholesky_solve(L, r, y2);
    for (int i = 0; i < 6; ++i) y[i] += y2[i];
  } else {
    for (int i = 0; i < 6; ++i) y[i] = nan("");
  }
  double delta[6];
  for (int i = 0; i < 6; ++i) {
    delta[i] = -(y[i] * d[i]);
    if (!isfinite(delta[i])) delta[i] = 0.0;
  }

  // se3.exp(delta): Rodrigues and the left Jacobian, _sinc_coeffs's guards
  const double* rho = delta;
  const double* th = delta + 3;
  const double th_sq = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  const double theta = sqrt(th_sq + 1e-8);
  const bool tiny = th_sq < 1e-8;
  const double A = tiny ? 1.0 - th_sq / 6.0 : sin(theta) / theta;
  const double Bc = tiny ? 0.5 - th_sq / 24.0 : (1.0 - cos(theta)) / th_sq;
  const double Cc = tiny ? 1.0 / 6.0 - th_sq / 120.0 : (1.0 - A) / th_sq;
  const double W[9] = {0.0, -th[2], th[1], th[2], 0.0, -th[0], -th[1], th[0], 0.0};
  double WW[9], Re[9], J[9], te[3];
  matmul3(W, W, WW);
  for (int k = 0; k < 9; ++k) {
    const double eye = (k % 4 == 0) ? 1.0 : 0.0;
    Re[k] = eye + A * W[k] + Bc * WW[k];
    J[k] = eye + Bc * W[k] + Cc * WW[k];
  }
  matvec3(J, rho, te);

  // se3.compose(pose, exp(delta)), then the keep logic
  double Rn[9], tn[3];
  matmul3(pose, Re, Rn);
  matvec3(pose, te, tn);
  for (int i = 0; i < 3; ++i) tn[i] += pose[9 + i];
  const bool reached = sqrt(err) <= a.max_cost;
  double nrm = 0.0;
  for (int i = 0; i < 6; ++i) nrm += delta[i] * delta[i];
  const bool small = sqrt(nrm) < a.min_delta;
  const double keep = (*done || reached) ? 0.0 : 1.0;
  for (int k = 0; k < 9; ++k) pose[k] = pose[k] * (1.0 - keep) + Rn[k] * keep;
  for (int i = 0; i < 3; ++i) pose[9 + i] = pose[9 + i] * (1.0 - keep) + tn[i] * keep;
  *done = *done || reached || small;
}

__global__ void __launch_bounds__(kThreads, 1) gn_solve_kernel(Args a) {
  __shared__ double scratch[kWarps][kPl];
  __shared__ double sum_pt[kPt], sum_pl[kPl];
  __shared__ double pose[12];
  __shared__ int done;
  const long long b = blockIdx.x;
  const float* pt_l = a.pt_local + b * a.stride[0];
  const float* pt_g = a.pt_global + b * a.stride[1];
  const float* pt_w = a.pt_weight + b * a.stride[2];
  const float* pl_l = a.pl_local + b * a.stride[3];
  const float* pl_c = a.pl_centroid + b * a.stride[4];
  const float* pl_n = a.pl_normal + b * a.stride[5];
  const float* pl_w = a.pl_weight + b * a.stride[6];
  if (threadIdx.x < 9) pose[threadIdx.x] = (double)a.R[b * a.stride[7] + threadIdx.x];
  else if (threadIdx.x < 12) pose[threadIdx.x] = (double)a.t[b * a.stride[8] + threadIdx.x - 9];
  if (threadIdx.x == 0) done = 0;
  __syncthreads();

  for (int it = 0; it < a.iterations; ++it) {
    double R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];

    double acc[kPt];
#pragma unroll
    for (int k = 0; k < kPt; ++k) acc[k] = 0.0;
    for (int i = threadIdx.x; i < a.n_pt; i += kThreads) {
      double l[3], q[3], r[3], a3[3];
      load3(pt_l, i, l);
      load3(pt_g, i, q);
      const double w = (double)pt_w[i] * a.w_pt;
#pragma unroll
      for (int k = 0; k < 3; ++k) r[k] = R[3 * k] * l[0] + R[3 * k + 1] * l[1] + R[3 * k + 2] * l[2] + t[k] - q[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) a3[k] = r[0] * R[k] + r[1] * R[3 + k] + r[2] * R[6 + k];  // R^T r
      const double wl[3] = {w * l[0], w * l[1], w * l[2]};
      acc[0] += w;
      acc[1] += wl[0];
      acc[2] += wl[1];
      acc[3] += wl[2];
      acc[4] += wl[0] * l[0];
      acc[5] += wl[0] * l[1];
      acc[6] += wl[0] * l[2];
      acc[7] += wl[1] * l[1];
      acc[8] += wl[1] * l[2];
      acc[9] += wl[2] * l[2];
      acc[10] += wl[0] * l[0] + wl[1] * l[1] + wl[2] * l[2];
      acc[11] += w * a3[0];
      acc[12] += w * a3[1];
      acc[13] += w * a3[2];
      acc[14] += w * (l[1] * a3[2] - l[2] * a3[1]);
      acc[15] += w * (l[2] * a3[0] - l[0] * a3[2]);
      acc[16] += w * (l[0] * a3[1] - l[1] * a3[0]);
      acc[17] += w * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
    }
    block_sum<kPt>(acc, scratch, sum_pt);

    double acc2[kPl];
#pragma unroll
    for (int k = 0; k < kPl; ++k) acc2[k] = 0.0;
    for (int i = threadIdx.x; i < a.n_pl; i += kThreads) {
      double l[3], c[3], n[3], u[6];
      load3(pl_l, i, l);
      load3(pl_c, i, c);
      load3(pl_n, i, n);
      const double w = (double)pl_w[i] * a.w_pl;
      double e = 0.0;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        e += n[k] * (R[3 * k] * l[0] + R[3 * k + 1] * l[1] + R[3 * k + 2] * l[2] + t[k] - c[k]);
#pragma unroll
      for (int k = 0; k < 3; ++k) u[k] = n[0] * R[k] + n[1] * R[3 + k] + n[2] * R[6 + k];  // R^T n
      u[3] = l[1] * u[2] - l[2] * u[1];
      u[4] = l[2] * u[0] - l[0] * u[2];
      u[5] = l[0] * u[1] - l[1] * u[0];
      int k = 0;
#pragma unroll
      for (int i6 = 0; i6 < 6; ++i6) {
        const double wu = w * u[i6];
#pragma unroll
        for (int j6 = i6; j6 < 6; ++j6) acc2[k++] += wu * u[j6];
      }
      const double we = w * e;
#pragma unroll
      for (int i6 = 0; i6 < 6; ++i6) acc2[21 + i6] += we * u[i6];
      acc2[27] += we * e;
    }
    block_sum<kPl>(acc2, scratch, sum_pl);

    if (threadIdx.x == 0) solve_and_update(a, sum_pt, sum_pl, pose, &done);
    __syncthreads();
  }

  if (threadIdx.x < 9) a.out_R[b * 9 + threadIdx.x] = (float)pose[threadIdx.x];
  else if (threadIdx.x < 12) a.out_t[b * 3 + threadIdx.x - 9] = (float)pose[threadIdx.x];
}

}  // namespace

// Plain C entry point (loaded with ctypes). B problems, one block each. Each
// input pointer has its stride in elements between two problems (0: one
// input shared by every problem); a block that is not live has n = 0 and
// null pointers. Launches on `stream`, does not synchronise and allocates
// nothing; returns cudaGetLastError() after the launch (0 on success).
extern "C" int mp2p_gn_solve_f32(
    const float* pt_local, long long s_pt_local, const float* pt_global, long long s_pt_global,
    const float* pt_weight, long long s_pt_weight, int n_pt,
    const float* pl_local, long long s_pl_local, const float* pl_centroid,
    long long s_pl_centroid, const float* pl_normal, long long s_pl_normal,
    const float* pl_weight, long long s_pl_weight, int n_pl,
    const float* R, long long s_R, const float* t, long long s_t, int B, int iterations,
    double min_delta, double max_cost, double damping, double w_pt, double w_pl,
    float* out_R, float* out_t, void* stream) {
  if (B <= 0) return 0;
  Args a;
  a.pt_local = pt_local;
  a.pt_global = pt_global;
  a.pt_weight = pt_weight;
  a.pl_local = pl_local;
  a.pl_centroid = pl_centroid;
  a.pl_normal = pl_normal;
  a.pl_weight = pl_weight;
  a.R = R;
  a.t = t;
  const long long strides[9] = {s_pt_local, s_pt_global, s_pt_weight, s_pl_local,
                                s_pl_centroid, s_pl_normal, s_pl_weight, s_R, s_t};
  for (int k = 0; k < 9; ++k) a.stride[k] = strides[k];
  a.n_pt = n_pt;
  a.n_pl = n_pl;
  a.iterations = iterations;
  a.min_delta = min_delta;
  a.max_cost = max_cost;
  a.damping = damping;
  a.w_pt = w_pt;
  a.w_pl = w_pl;
  a.out_R = out_R;
  a.out_t = out_t;
  gn_solve_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
