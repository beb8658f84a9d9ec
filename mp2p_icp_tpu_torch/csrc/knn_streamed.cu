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
// memory through the L2 and shared-memory tiles of knn_sweep.cuh.
//
// What it computes: exactly what knn_bruteforce.cu computes (the K nearest
// points, ascending, lowest index first on ties, (+inf, -1) in unfilled
// slots), and equal to knn_plain over the whole map bit for bit.
//
// What bounds it: FP32 instruction issue, as for knn_bruteforce.cu. Each of
// the Q*C pairs costs 3 sub, 3 mul, 2 add and a compare; the bytes moved are
// the points (12 B each, read once per block of 64 queries, mostly from L2)
// and the partial lists (S*Q*K*8 B), small next to the arithmetic.
//
// The design:
//   * the grid is (Q / 64 query blocks) x (S point slices). One thread per
//     query sweeps one slice of `slice` points with the shared sweep and
//     writes its sorted K-list to a partial [S, Q, K] buffer that the
//     wrapper allocates. The Python wrapper picks S so that Q = 8192 gives
//     some 2,000 blocks, about 16 per SM (one thread per query alone gives
//     128 blocks, 2 warps per SM; see knn_bruteforce.cu);
//   * a second kernel, one thread per query, merges the S lists in slice
//     order with the same strict-'<' insertion: within a slice entries come
//     in (d, idx) order, and every entry of an earlier slice has a lower
//     index, so the lowest index wins each tie, as in one long sweep;
//   * no cp.async or TMA prefetch yet: correct and simple first.

#include "knn_sweep.cuh"

namespace {

using namespace mp2p_knn;

constexpr int kMergeThreads = 128;

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_slice_kernel(const float* __restrict__ q, int Q,
                     const float* __restrict__ p, int C, int slice,
                     float* __restrict__ part_d, int* __restrict__ part_i) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < Q;
  const int begin = blockIdx.y * slice;
  const int end = min(C, begin + slice);
  float qx, qy, qz;
  load_query(q, qi, live, qx, qy, qz);
  float bd[K];
  int bi[K];
  init_list<K>(bd, bi);
  sweep<K>(qx, qy, qz, p, begin, end, bd, bi);
  if (live) {
    const size_t off = static_cast<size_t>(blockIdx.y) * Q * K;
    store<K>(part_d + off, part_i + off, qi, bd, bi);
  }
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const float* __restrict__ part_d,
                     const int* __restrict__ part_i, int S, int Q,
                     float* __restrict__ out_d, int* __restrict__ out_i) {
  const int qi = blockIdx.x * kMergeThreads + threadIdx.x;
  if (qi >= Q) return;
  float bd[K];
  int bi[K];
  init_list<K>(bd, bi);
  for (int s = 0; s < S; ++s) {
    const size_t row = (static_cast<size_t>(s) * Q + qi) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      // a slice's list is ascending: once an entry cannot enter, no later
      // entry of that slice can (insert re-checks the same condition)
      const float d = part_d[row + j];
      if (!(d < bd[K - 1])) break;
      insert<K>(d, part_i[row + j], bd, bi);
    }
  }
  store<K>(out_d, out_i, qi, bd, bi);
}

}  // namespace

// Plain C entry point (loaded with ctypes). part_d / part_i are [S, Q, k]
// scratch, S * slice >= C. Launches both kernels on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int mp2p_knn_sweep_streamed_f32(const float* q, int Q,
                                           const float* p, int C, int k,
                                           int slice, int S, float* part_d,
                                           int* part_i, float* out_d,
                                           int* out_i, void* stream) {
  if (Q <= 0) return static_cast<int>(cudaSuccess);
  if (C < 0 || slice <= 0 || S <= 0 || S > 65535 ||
      static_cast<long long>(S) * slice < C)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + kThreads - 1) / kThreads, S);
  const dim3 merge_grid((Q + kMergeThreads - 1) / kMergeThreads);
  const bool ok = with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    knn_slice_kernel<K><<<grid, kThreads, 0, st>>>(q, Q, p, C, slice, part_d,
                                                   part_i);
    knn_merge_kernel<K><<<merge_grid, kMergeThreads, 0, st>>>(
        part_d, part_i, S, Q, out_d, out_i);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
