// Device pieces shared by the three exact kNN sweeps (k <= 8) for Hopper:
// knn_bruteforce.cu (one problem, all points), knn_streamed.cu (the point
// axis split across blocks, then a k-merge) and knn_batched.cu (a batch of
// problems in one launch).
//
// Every sweep computes, for each query, the K points with the smallest
// squared distance (q - p)^2, ascending, with the lowest index winning a
// tie. The distance is the direct difference form with every product and
// sum rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn, no FMA
// contraction), so it equals the plain PyTorch version (knn_plain) bit for
// bit. The K-best list lives in registers (K is a template parameter and
// every list access is unrolled to a static index). Slots that receive no
// point keep d2 = +inf and idx = -1.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <type_traits>

namespace mp2p_knn {

constexpr int kThreads = 64;  // queries per block, one thread each
constexpr int kTile = 512;    // points staged in shared memory per step

template <int K>
__device__ __forceinline__ void init_list(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = -1;
  }
}

// Insert (d, idx) after every entry <= d when d beats the last entry.
// Candidates must arrive in increasing index order: then a strict '<'
// keeps the lower index first among equal distances.
template <int K>
__device__ __forceinline__ void insert(float d, int idx, float (&bd)[K],
                                       int (&bi)[K]) {
  if (!(d < bd[K - 1])) return;
  bool placed = false;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (!placed) {
      if (d < bd[j - 1]) {
        bd[j] = bd[j - 1];
        bi[j] = bi[j - 1];
      } else {
        bd[j] = d;
        bi[j] = idx;
        placed = true;
      }
    }
  }
  if (!placed) {
    bd[0] = d;
    bi[0] = idx;
  }
}

// Coordinates of query qi of a row-major [Q, 3] array (zeros when the
// thread has no query; it still takes part in the block's tile loads).
__device__ __forceinline__ void load_query(const float* __restrict__ q, int qi,
                                           bool live, float& x, float& y,
                                           float& z) {
  x = y = z = 0.f;
  if (live) {
    const float* qq = q + 3 * static_cast<size_t>(qi);
    x = qq[0];
    y = qq[1];
    z = qq[2];
  }
}

// Sweep the points [begin, end) of a row-major [C, 3] array into the
// list, in tiles of kTile staged in shared memory as SoA floats, so each
// point is read from device memory once per block and then broadcast to
// all threads. Every thread of the block must call it with the same range.
// Recorded indices are absolute (begin + offset).
template <int K>
__device__ __forceinline__ void sweep(float qx, float qy, float qz,
                                      const float* __restrict__ p, int begin,
                                      int end, float (&bd)[K], int (&bi)[K]) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  for (int base = begin; base < end; base += kTile) {
    const int n = min(kTile, end - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* pp = p + 3 * static_cast<size_t>(base + t);
      sx[t] = pp[0];
      sy[t] = pp[1];
      sz[t] = pp[2];
    }
    __syncthreads();
    // unrolled so several independent distances are in flight while the
    // insertion of the previous one resolves
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float dx = __fsub_rn(qx, sx[t]);
      const float dy = __fsub_rn(qy, sy[t]);
      const float dz = __fsub_rn(qz, sz[t]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      insert<K>(d, base + t, bd, bi);
    }
  }
}

// Write the list to row `row` of row-major [*, K] outputs.
template <int K>
__device__ __forceinline__ void store(float* __restrict__ out_d,
                                      int* __restrict__ out_i, int row,
                                      const float (&bd)[K], const int (&bi)[K]) {
  float* od = out_d + static_cast<size_t>(row) * K;
  int* oi = out_i + static_cast<size_t>(row) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    od[j] = bd[j];
    oi[j] = bi[j];
  }
}

// Call f(std::integral_constant<int, K>{}) for the runtime k in 1..8;
// false for any other k.
template <class F>
bool with_k(int k, F&& f) {
  switch (k) {
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 3: f(std::integral_constant<int, 3>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 5: f(std::integral_constant<int, 5>{}); return true;
    case 6: f(std::integral_constant<int, 6>{}); return true;
    case 7: f(std::integral_constant<int, 7>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    default: return false;
  }
}

}  // namespace mp2p_knn
