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
// What the design does about that:
//   * one thread per query; its K-best list lives in registers (K is a
//     template parameter, every list access is unrolled to a static index);
//   * a block of kThreads queries sweeps the points in tiles of kTile staged
//     in shared memory as SoA floats, so each point is read from device
//     memory once per block and then broadcast to all threads;
//   * the tile loop is unrolled so several independent distances are in
//     flight while the insertion of the previous one resolves;
//   * the ragged Q and C edges are masked in the kernel.
// Known limit: with one thread per query, Q = 8192 gives only 8192 threads
// (2 warps per SM on 132 SMs); splitting the point axis across blocks with a
// final k-merge is the next step (the >131072-point streamed sweep needs it
// anyway).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;  // queries per block
constexpr int kTile = 512;    // points staged in shared memory per step

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_sweep_kernel(const float* __restrict__ q, int Q,
                     const float* __restrict__ p, int C,
                     float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* qq = q + 3 * static_cast<size_t>(qi);
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = -1;
  }

  for (int base = 0; base < C; base += kTile) {
    const int n = min(kTile, C - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* pp = p + 3 * static_cast<size_t>(base + t);
      sx[t] = pp[0];
      sy[t] = pp[1];
      sz[t] = pp[2];
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float dx = __fsub_rn(qx, sx[t]);
      const float dy = __fsub_rn(qy, sy[t]);
      const float dz = __fsub_rn(qz, sz[t]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < bd[K - 1]) {
        // Insert after every entry <= d: points arrive in increasing index,
        // so equal distances keep the lower index first (strict '<').
        const int idx = base + t;
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
    }
  }

  if (live) {
    float* od = out_d + static_cast<size_t>(qi) * K;
    int* oi = out_i + static_cast<size_t>(qi) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      od[j] = bd[j];
      oi[j] = bi[j];
    }
  }
}

template <int K>
void launch(const float* q, int Q, const float* p, int C, float* out_d,
            int* out_i, cudaStream_t stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads);
  knn_sweep_kernel<K><<<grid, kThreads, 0, stream>>>(q, Q, p, C, out_d, out_i);
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
  switch (k) {
    case 1: launch<1>(q, Q, p, C, out_d, out_i, s); break;
    case 2: launch<2>(q, Q, p, C, out_d, out_i, s); break;
    case 3: launch<3>(q, Q, p, C, out_d, out_i, s); break;
    case 4: launch<4>(q, Q, p, C, out_d, out_i, s); break;
    case 5: launch<5>(q, Q, p, C, out_d, out_i, s); break;
    case 6: launch<6>(q, Q, p, C, out_d, out_i, s); break;
    case 7: launch<7>(q, Q, p, C, out_d, out_i, s); break;
    case 8: launch<8>(q, Q, p, C, out_d, out_i, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
