// Exact brute-force k-nearest-neighbour sweep (k <= 8) for Hopper (sm_90a).
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
// What bounds it: arithmetic and compares, not memory. Each of the Q*C pairs
// costs 3 subtractions, 3 multiplications, 2 additions and one compare with
// the current K-th best (a K-step register insertion when it wins), while
// the bytes moved are only the Q + C points themselves (12 B each) and the
// Q*K results.
//
// What the design does about that (the sweep itself is knn_sweep.cuh):
//   * one thread per query; its K-best list lives in registers;
//   * a block of kThreads queries sweeps the points in tiles of kTile staged
//     in shared memory, so each point is read from device memory once per
//     block and then broadcast to all threads;
//   * the ragged Q and C edges are masked in the kernel.
// Known limit: with one thread per query, Q = 8192 gives only 8192 threads
// (2 warps per SM on 132 SMs). knn_streamed.cu splits the point axis across
// blocks with a final k-merge; it serves the maps above STREAM_BLOCK.

#include "knn_sweep.cuh"

namespace {

using namespace mp2p_knn;

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_sweep_kernel(const float* __restrict__ q, int Q,
                     const float* __restrict__ p, int C,
                     float* __restrict__ out_d, int* __restrict__ out_i) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < Q;
  float qx, qy, qz;
  load_query(q, qi, live, qx, qy, qz);
  float bd[K];
  int bi[K];
  init_list<K>(bd, bi);
  sweep<K>(qx, qy, qz, p, 0, C, bd, bi);
  if (live) store<K>(out_d, out_i, qi, bd, bi);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int mp2p_knn_sweep_f32(const float* q, int Q, const float* p, int C,
                                  int k, float* out_d, int* out_i,
                                  void* stream) {
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  if (C < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + kThreads - 1) / kThreads);
  const bool ok = with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    knn_sweep_kernel<K><<<grid, kThreads, 0, s>>>(q, Q, p, C, out_d, out_i);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
