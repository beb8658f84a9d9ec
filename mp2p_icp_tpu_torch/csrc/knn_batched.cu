// Exact kNN sweep (k <= 8) over a batch of independent problems for Hopper
// (sm_90a), all in one launch.
//
// Replaces the TPU kernel
// mp2p_icp_tpu/ops/nn_bruteforce.py::_nnk_kernel_gridless_batched, which
// the custom_vmap rule of the Pallas sweep (_make_nnk_pallas.nnk_vmap)
// reached under jax.vmap: the K1 sweep with a leading batch axis,
// [B, Q] queries against [B, C] points, either side possibly unbatched and
// broadcast. Its BATCH_VMEM_BUDGET slabbing was a VMEM limit and is gone.
//
// What it computes: for each problem b and each of its queries, what
// knn_bruteforce.cu computes (the K nearest points of problem b's points,
// ascending, lowest index first on ties, (+inf, -1) in unfilled slots),
// equal to knn_plain on each problem bit for bit. Inputs are row-major;
// problem b's queries start at q + b * q_bstride and its points at
// p + b * p_bstride (floats): a stride of 0 broadcasts one array to every
// problem. Outputs are [B, Q, K].
//
// What bounds it: FP32 instruction issue, as for knn_bruteforce.cu (B*Q*C
// pairs at 3 sub, 3 mul, 2 add and a compare each).
//
// The design: K1's sweep (knn_sweep.cuh) with the problem on blockIdx.y, so
// B = 8 problems of 8192 queries give 1,024 blocks of 64 threads, ~8 per SM;
// the broadcast map of a shared-map batch is read by every problem's blocks
// from the L2 instead of being copied B times.

#include "knn_sweep.cuh"

namespace {

using namespace mp2p_knn;

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_batched_kernel(const float* __restrict__ q, int Q, long long q_bstride,
                       const float* __restrict__ p, int C, long long p_bstride,
                       float* __restrict__ out_d, int* __restrict__ out_i) {
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < Q;
  float qx, qy, qz;
  load_query(q + b * q_bstride, qi, live, qx, qy, qz);
  float bd[K];
  int bi[K];
  init_list<K>(bd, bi);
  sweep<K>(qx, qy, qz, p + b * p_bstride, 0, C, bd, bi);
  if (live) {
    const size_t off = static_cast<size_t>(b) * Q * K;
    store<K>(out_d + off, out_i + off, qi, bd, bi);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int mp2p_knn_sweep_batched_f32(const float* q, int Q,
                                          long long q_bstride, const float* p,
                                          int C, long long p_bstride, int B,
                                          int k, float* out_d, int* out_i,
                                          void* stream) {
  if (Q <= 0 || B == 0) return static_cast<int>(cudaSuccess);
  if (C < 0 || B < 0 || B > 65535 || q_bstride < 0 || p_bstride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + kThreads - 1) / kThreads, B);
  const bool ok = with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    knn_batched_kernel<K><<<grid, kThreads, 0, s>>>(q, Q, q_bstride, p, C,
                                                    p_bstride, out_d, out_i);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
