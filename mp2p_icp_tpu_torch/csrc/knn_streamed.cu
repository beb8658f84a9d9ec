// Exact kNN sweep (k <= 8) over large maps for Hopper (sm_90a): the point
// axis is split across blocks, then the per-slice lists are k-merged.
//
// Replaces the TPU kernel
// mp2p_icp_tpu/ops/nn_bruteforce.py::_nnk_kernel_streamed_dbuf (behind
// _knn_pallas_streamed), which swept maps of more than STREAM_BLOCK (131072)
// points: the map stayed in HBM, 65536-point superblocks were
// double-buffered into VMEM by DMA and a running k-merge (_merge_sorted_k)
// combined them, earlier superblocks winning ties. The superblock size and
// the double buffer were VMEM limits; here the map is read from device
// memory through the L2 into the warps' tile rings of knn_sweep.cuh.
//
// What it computes: exactly what knn_bruteforce.cu computes (the K nearest
// points, ascending, lowest index first on ties, (+inf, -1) in unfilled
// slots), and equal to knn_plain over the whole map bit for bit.
//
// What bounds it: FP32 instruction issue, as for knn_bruteforce.cu: 9
// instructions per pair against 33.5 T FP32 instructions/s, 0.577 ms for
// 8192 x 262144. The bytes moved are the points (12 B each, read once per
// chunk of queries, mostly from L2) and the partial lists (S*Q*K*8 B),
// small next to the arithmetic.
//
// The design (slices and a merge, as before; the inner loop and the block
// are the shared sweep of knn_sweep.cuh, so it is the same device code as
// knn_bruteforce.cu behind its own entry point):
//   * the grid is (query chunks) x (S point slices); each block sweeps one
//     slice and writes its sorted K-lists to a partial [S, Q, K] buffer that
//     the wrapper allocates. The wrapper picks the block size and S so that
//     Q = 8192 puts 16 warps on every SM in blocks that fall evenly on them;
//   * a second kernel, one thread per query, merges the S lists in slice
//     order with the same strict-'<' insertion: within a slice entries come
//     in (d, idx) order, and every entry of an earlier slice has a lower
//     index, so the lowest index wins each tie, as in one long sweep.
// Measured on an H100 80GB HBM3 at 700 W (device time in a CUDA graph):
// 0.741 ms at 8192 x 262144 k=1, 78% of the bound (before: 1.18 ms, 49%);
// 1.27 ms for k=8, 45% (before: 1.59 ms). PERF.md, section 6.

#include "knn_sweep.cuh"

// Plain C entry point (loaded with ctypes). Blocks of `groups` warps, S
// slices of `slice` points (S * slice >= C); part_d / part_i are [S, Q, k]
// scratch, read only when S > 1. Launches both kernels on `stream`, does
// not synchronise and allocates nothing; returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int mp2p_knn_sweep_streamed_f32(const float* q, int Q,
                                           const float* p, int C, int k,
                                           int groups, int slice, int S,
                                           float* part_d, int* part_i,
                                           float* out_d, int* out_i,
                                           void* stream) {
  return mp2p_knn::run_sweep(q, Q, 0, p, C, 0, 1, k, groups, slice, S, part_d, part_i,
                             out_d, out_i, stream);
}
