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
// What bounds it: FP32 instruction issue, as for knn_bruteforce.cu: B*Q*C
// pairs at 9 instructions each against 33.5 T FP32 instructions/s, 1.154 ms
// for 8 x 8192 x 65536.
//
// The design: the shared sweep of knn_sweep.cuh with the problem on
// blockIdx.z. The wrapper counts B * (query chunks) when it sizes the point
// split, so a large batch runs unsplit (S = 1: no scratch, no merge) and a
// small one (B = 2) is split like a single problem. The broadcast map of a
// shared-map batch is read by every problem's blocks from the L2 instead of
// being copied B times. A batch stride of 3*C floats is 16-byte aligned
// only when C is a multiple of 4; the sweep falls back to 4-byte copies for
// the problems whose points start off that grid. Measured on an H100 80GB
// HBM3 at 700 W (device time in a CUDA graph): 1.476 ms at 8 x 8192 x 65536
// k=1, 78% of the bound (the kernel before it: 2.37 ms, 49%); 0.376 ms at
// B = 2 (77%; before: 1.13 ms). PERF.md, section 6.

#include "knn_sweep.cuh"

// Plain C entry point (loaded with ctypes). Blocks of `groups` warps, S
// slices of `slice` points (S * slice >= C); part_d / part_i are
// [S, B * Q, k] scratch, read only when S > 1. Launches on `stream`, does
// not synchronise and allocates nothing; returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int mp2p_knn_sweep_batched_f32(const float* q, int Q,
                                          long long q_bstride, const float* p,
                                          int C, long long p_bstride, int B,
                                          int k, int groups, int slice, int S,
                                          float* part_d, int* part_i,
                                          float* out_d, int* out_i,
                                          void* stream) {
  return mp2p_knn::run_sweep(q, Q, q_bstride, p, C, p_bstride, B, k, groups, slice, S,
                             part_d, part_i, out_d, out_i, stream);
}
