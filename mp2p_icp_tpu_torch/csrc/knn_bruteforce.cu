// Exact brute-force k-nearest-neighbour sweep (k <= 8) for Hopper (sm_90a):
// one problem, Q queries against C points.
//
// Replaces the TPU kernel mp2p_icp_tpu/ops/nn_bruteforce.py::_nnk_kernel_gridless
// (the Pallas sweep behind knn_bruteforce, run with k=1 by the DistanceThreshold
// and Adaptive matchers on every ICP iteration).
//
// What it computes: for each query q_i of Q, the K points p_j of C with the
// smallest squared distance (q_i - p_j)^2, ascending, with the lowest index
// winning a tie. Inputs are row-major [Q,3] / [C,3] float32 with the
// sentinels (queries at +1e8, points at -1e8) already applied by the Python
// front end; outputs are d2 [Q,K] float32 and idx [Q,K] int32. Slots that
// received no point keep d2 = +inf and idx = -1.
//
// Unlike the TPU kernel, which fed the matrix unit bf16 hi/mid/lo splits of
// |p|^2 - 2 q.p and left |q|^2 to the caller, this kernel evaluates the
// direct difference form on the CUDA cores: it is exact in f32 and has no
// |q|^2 cancellation. The products and sums are rounded one by one
// (__fmul_rn/__fadd_rn, no FMA contraction), so the result equals the plain
// PyTorch version (knn_plain) bit for bit.
//
// What bounds it: FP32 instruction issue, not memory: 9 instructions per
// pair (3 sub, 3 mul, 2 add, 1 compare) against 33.5 T FP32 instructions/s,
// i.e. 0.018 ms for 8192 x 8192 and 0.144 ms for 8192 x 65536, while the
// bytes moved are only the Q + C points (12 B each) and the Q*K results.
//
// What the design does about it is the shared sweep of knn_sweep.cuh: 8
// queries per thread for k = 1, 16-byte shared-memory reads of the points
// as they lie in memory, a warp-private cp.async tile ring, the index of the
// nearest point found after the sweep, and a split of the point axis (G
// warps per block, S slices across blocks, lists merged in index order) that
// the wrapper sizes so that 6144-8192 queries put 16 warps on every SM in
// blocks that fall evenly on the SMs. Measured on an H100 80GB HBM3 at 700 W
// (device time in a CUDA graph): 0.031 ms at 8192 x 8192 k=1 (57% of the
// bound; the one-thread-per-query kernel before it: 0.138 ms), 0.047 ms at
// 6144 x 16384 (58%), 0.194 ms at 8192 x 65536 (74%; before: 1.09 ms), 0.12
// ms at 8192 x 8192 k=8 (15%; before: 0.30 ms). PERF.md, section 6.

#include "knn_sweep.cuh"

// Plain C entry point (loaded with ctypes). Blocks of `groups` warps, S
// slices of `slice` points (S * slice >= C); part_d / part_i are [S, Q, k]
// scratch, read only when S > 1. Launches on `stream`, does not synchronise
// and allocates nothing; returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int mp2p_knn_sweep_f32(const float* q, int Q, const float* p, int C,
                                  int k, int groups, int slice, int S,
                                  float* part_d, int* part_i, float* out_d,
                                  int* out_i, void* stream) {
  return mp2p_knn::run_sweep(q, Q, 0, p, C, 0, 1, k, groups, slice, S, part_d, part_i,
                             out_d, out_i, stream);
}

// The launch configuration the sweep kernel gets for these arguments, from
// the functions launch_sweep itself uses: out[0..2] = the grid, out[3] =
// threads per block. Launches nothing.
extern "C" void mp2p_knn_sweep_launch_dims(int Q, int B, int k, int groups, int S,
                                           int* out) {
  const dim3 grid = mp2p_knn::sweep_grid(Q, B, k, S);
  out[0] = static_cast<int>(grid.x);
  out[1] = static_cast<int>(grid.y);
  out[2] = static_cast<int>(grid.z);
  out[3] = mp2p_knn::sweep_threads(groups);
}
