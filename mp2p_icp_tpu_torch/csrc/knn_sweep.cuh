// The exact kNN sweep (k <= 8) for Hopper (sm_90a), shared by the three
// entry points: knn_bruteforce.cu (one problem), knn_batched.cu (a batch of
// problems in one launch) and knn_streamed.cu (maps above STREAM_BLOCK).
//
// What it computes: for each query, the K points with the smallest squared
// distance (q - p)^2, ascending, with the lowest index winning a tie. The
// distance is the direct difference form with every product and sum rounded
// on its own (__fsub_rn/__fmul_rn/__fadd_rn, no FMA contraction), so it
// equals the plain PyTorch version (knn_plain) bit for bit. Slots that
// receive no point keep d2 = +inf and idx = -1.
//
// What bounds it: FP32 instruction issue. A pair costs 3 subtractions, 3
// multiplications, 2 additions and one compare, none of them an FMA, so the
// card's 67 TFLOP/s are 33.5 T instructions/s and Q*C pairs take at least
// Q*C*9 / 33.5e12 s. The bytes (12 per point and per query, 8 per result)
// are far below the memory rate.
//
// The design, in the order of what it buys:
//   * Register tile. For K = 1 a thread holds R = 8 queries, so one point
//     read from shared memory serves 8 pairs and the loop counter, the index
//     and the address arithmetic are paid once per point. For K > 1 the
//     K-list of one query already fills the registers (R = 2 spills at K = 8
//     and is slower), so R = 1.
//   * Deferred index (K = 1). The loop keeps only the best d2 (one FMNMX per
//     pair) and, once per 4-point group, the group that improved it; the
//     index within the group is found after the sweep by recomputing four
//     distances. 10.0 issued instructions per pair instead of 11.3.
//   * Wide shared-memory reads. A tile of points stays as it lies in device
//     memory, [n, 3] row-major; the point loop is unrolled by 4, so twelve
//     floats arrive in three 16-byte loads, every lane reading the same
//     address (a broadcast, no bank conflicts).
//   * Warp-private asynchronous tile ring. Each warp sweeps its own
//     contiguous part of the points through its own ring of kStages tiles
//     filled by cp.async (16 bytes where the source is 16-byte aligned, 4
//     bytes otherwise: a batch stride or a start that is not a multiple of 4
//     points), so the next tile lands while the current one is swept and
//     the only barriers in the loop are two __syncwarp per tile.
//   * Filling the card. The grid is (query chunks of 32*R) x (S point
//     slices) x (B problems) and a block is G warps that share the chunk's
//     queries and split the slice into G contiguous parts. The wrapper
//     picks G and S so that 16 to 32 warps per SM are in flight whatever Q
//     is and the blocks fall evenly on the SMs (nn_bruteforce.split_chunks).
//     The G lists of a block are merged through shared memory in part
//     order; with S > 1 the slices' lists go to a scratch [S, B*Q, K] and a
//     second kernel merges them in slice order. Both merges use the sweep's
//     strict-'<' insertion: every entry of an earlier part has a lower
//     index, so the lowest index wins each tie as in one long sweep.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_knn_tune.py,
// device time per launch in a CUDA graph; PERF.md section 6 has the table):
// the k = 1 inner loop issues 10.0 instructions per pair (the one-query
// sweep it replaces: 14.25) and runs at 57% of the bound at 8192 x 8192
// (0.031 ms), 74% at 8192 x 65536 and 78% at 8192 x 262144 and at
// 8 x 8192 x 65536. For k = 8 the insertion dominates: 45% at 8192 x 262144.
// The ring depth and the tile size made no measurable difference at these
// card-filling shapes (1, 2 or 3 stages within 1%, 64, 128 or 256 points
// within 2%), so they are plain constants below: the smallest ring that
// overlaps the copy with the sweep.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace mp2p_knn {

constexpr int kWarp = 32;
constexpr int kTile = 128;  // points per ring stage
constexpr int kStages = 2;  // ring depth of each warp
constexpr int kTileFloats = 3 * kTile;
constexpr int kMaxGroups = 16;  // warps per block, at most
constexpr int kMergeThreads = 128;

static_assert(kTile % 4 == 0 && kTile >= 4, "a tile is whole groups of 4 points");
static_assert(kStages >= 1, "the ring has at least one stage");

// Queries held by one thread, the register tile, for k = 1 and for k > 1.
// nn_bruteforce.py sizes the grid's split with the same two numbers
// (queries_per_thread there).
constexpr int kQueriesK1 = 8;
constexpr int kQueriesKn = 1;
__host__ __device__ constexpr int queries_per_thread(int k) {
  return k == 1 ? kQueriesK1 : kQueriesKn;
}

// The grid of a sweep: (query chunks of 32 * R, S slices, B problems).
inline dim3 sweep_grid(int Q, int B, int k, int S) {
  const int per_block = kWarp * queries_per_thread(k);
  return dim3((Q + per_block - 1) / per_block, S, B);
}

// Threads of a block of `groups` warps.
inline int sweep_threads(int groups) { return groups * kWarp; }

// Shared memory of one warp: its tile ring, reused for its R lists of K
// (distance, index) entries per lane when the block merges.
template <int K>
__host__ __device__ constexpr int warp_smem_bytes() {
  constexpr int ring = kStages * kTileFloats * 4;
  constexpr int lists = queries_per_thread(K) * K * kWarp * 8;
  return ring > lists ? ring : lists;
}

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

// Write the list to row `row` of row-major [*, K] outputs.
template <int K>
__device__ __forceinline__ void store(float* __restrict__ out_d,
                                      int* __restrict__ out_i, size_t row,
                                      const float (&bd)[K], const int (&bi)[K]) {
  float* od = out_d + row * K;
  int* oi = out_i + row * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    od[j] = bd[j];
    oi[j] = bi[j];
  }
}

// (q - p)^2 with each difference, product and sum rounded on its own, in the
// order of knn_plain: (dx*dx + dy*dy) + dz*dz.
__device__ __forceinline__ float dist2(float qx, float qy, float qz, float px, float py,
                                       float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ void cp_async_16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of points [first, first + n) of the row-major [*, 3] array
// p into one ring stage, by the whole warp. `wide`: p + 3*first is 16-byte
// aligned, so whole 16-byte pieces can be copied; the rest, and everything
// when it is not, goes float by float. The stage is padded to a whole group
// of 4 points with +inf, whose distance is +inf and enters no list.
__device__ __forceinline__ void load_tile(float* stage, const float* __restrict__ p,
                                          int first, int n, bool wide, int lane) {
  const float* src = p + 3 * static_cast<size_t>(first);
  const int n_floats = 3 * n;
  const int n_wide = wide ? (n_floats >> 2) : 0;
  for (int c = lane; c < n_wide; c += kWarp) cp_async_16(stage + 4 * c, src + 4 * c);
  for (int f = 4 * n_wide + lane; f < n_floats; f += kWarp)
    cp_async_4(stage + f, src + f);
  const int n_padded = 3 * ((n + 3) & ~3);
  for (int f = n_floats + lane; f < n_padded; f += kWarp) stage[f] = CUDART_INF_F;
}

// Sweep one landed stage: n4 groups of 4 points whose first has absolute
// index `first`, against the thread's R queries. A group is three 16-byte
// shared-memory reads, the same address in every lane.
template <int K, int R>
__device__ __forceinline__ void sweep_tile(const float (&qx)[R], const float (&qy)[R],
                                           const float (&qz)[R], const float* stage,
                                           int first, int n4, float (&bd)[R][K],
                                           int (&bi)[R][K]) {
  const float4* s4 = reinterpret_cast<const float4*>(stage);
#pragma unroll 1
  for (int j = 0; j < n4; ++j) {
    const float4 a = s4[3 * j];
    const float4 b = s4[3 * j + 1];
    const float4 c = s4[3 * j + 2];
    const float px[4] = {a.x, a.w, b.z, c.y};
    const float py[4] = {a.y, b.x, b.w, c.z};
    const float pz[4] = {a.z, b.y, c.x, c.w};
    const int idx = first + 4 * j;
    if constexpr (K == 1) {
      // one min per pair; the group's index is kept only when the group
      // improved the best (strictly: an earlier group keeps a tie)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float m = bd[r][0];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          m = fminf(m, dist2(qx[r], qy[r], qz[r], px[u], py[u], pz[u]));
        if (m < bd[r][0]) {
          bd[r][0] = m;
          bi[r][0] = idx;
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          insert<K>(dist2(qx[r], qy[r], qz[r], px[u], py[u], pz[u]), idx + u, bd[r],
                    bi[r]);
      }
    }
  }
}

// After a deferred-index sweep of [*, end): bi holds the first index of the
// 4-point group that gave bd (or -1). Recompute the group's distances, with
// the same roundings, and keep the lowest index that gives bd.
template <int R>
__device__ __forceinline__ void resolve_index(const float (&qx)[R], const float (&qy)[R],
                                              const float (&qz)[R],
                                              const float* __restrict__ p, int end,
                                              const float (&bd)[R][1], int (&bi)[R][1]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int group = bi[r][0];
    if (group < 0) continue;
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      if (group + u < end) {
        const float* pp = p + 3 * static_cast<size_t>(group + u);
        if (dist2(qx[r], qy[r], qz[r], pp[0], pp[1], pp[2]) == bd[r][0])
          bi[r][0] = group + u;
      }
    }
  }
}

// Sweep the points [begin, end) of p into the warp's lists through its ring.
// Every lane of the warp calls it with the same range. Recorded indices are
// absolute.
template <int K, int R>
__device__ __forceinline__ void sweep_range(const float (&qx)[R], const float (&qy)[R],
                                            const float (&qz)[R],
                                            const float* __restrict__ p, int begin,
                                            int end, float* ring, int lane,
                                            float (&bd)[R][K], int (&bi)[R][K]) {
  if (begin >= end) return;
  const bool wide =
      (reinterpret_cast<uintptr_t>(p + 3 * static_cast<size_t>(begin)) & 15) == 0;
  const int n_tiles = (end - begin + kTile - 1) / kTile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      const int first = begin + s * kTile;
      load_tile(ring + s * kTileFloats, p, first, min(kTile, end - first), wide, lane);
    }
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    // the stage refilled here was swept in the previous step, and every
    // lane has passed that step's closing __syncwarp
    const int ahead = t + kStages - 1;
    if (ahead < n_tiles) {
      const int first = begin + ahead * kTile;
      load_tile(ring + (ahead % kStages) * kTileFloats, p, first,
                min(kTile, end - first), wide, lane);
    }
    cp_async_commit();  // one group per step, empty or not, so the count below holds
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's pieces of tile t have landed
    const int first = begin + t * kTile;
    const int n = min(kTile, end - first);
    sweep_tile<K, R>(qx, qy, qz, ring + (t % kStages) * kTileFloats, first,
                     (n + 3) >> 2, bd, bi);
    __syncwarp();  // every lane is done with the stage before it is refilled
  }
}

// One block: G = blockDim.x / 32 warps hold the same 32*R queries (lane l
// of every warp holds queries q0 + r*32 + l) and sweep the G contiguous
// parts of the points [begin, end); the G lists are then merged in part
// order and written to rows [q0, q0 + 32*R) of out_d / out_i ([Q, K]).
template <int K>
__device__ __forceinline__ void sweep_block(const float* __restrict__ q, int Q,
                                            const float* __restrict__ p, int begin,
                                            int end, float* __restrict__ out_d,
                                            int* __restrict__ out_i) {
  constexpr int R = queries_per_thread(K);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int g = threadIdx.x / kWarp;
  const int G = blockDim.x / kWarp;
  float* mine = reinterpret_cast<float*>(smem + g * warp_smem_bytes<K>());
  const int q0 = blockIdx.x * (kWarp * R);

  float qx[R], qy[R], qz[R];
  float bd[R][K];
  int bi[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r * kWarp + lane;
    qx[r] = qy[r] = qz[r] = 0.f;  // a thread without a query still loads tiles
    if (qi < Q) {
      const float* qq = q + 3 * static_cast<size_t>(qi);
      qx[r] = qq[0];
      qy[r] = qq[1];
      qz[r] = qq[2];
    }
    init_list<K>(bd[r], bi[r]);
  }

  // this warp's part: a whole number of 4-point groups, so that every part
  // of an aligned slice starts 16-byte aligned
  const int len = max(end - begin, 0);
  const int part = (((len + G - 1) / G) + 3) & ~3;
  const int part_begin = begin + g * part;
  const int part_end = min(end, part_begin + part);
  sweep_range<K, R>(qx, qy, qz, p, part_begin, part_end, mine, lane, bd, bi);
  if constexpr (K == 1) resolve_index<R>(qx, qy, qz, p, part_end, bd, bi);

  if (G == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + r * kWarp + lane;
      if (qi < Q) store<K>(out_d, out_i, qi, bd[r], bi[r]);
    }
    return;
  }

  // every copy into this warp's ring has landed (the groups still pending
  // are empty), so the ring can hold its lists: [R][K][32] distances, then
  // [R][K][32] indices, the lane fastest
  float* my_d = mine;
  int* my_i = reinterpret_cast<int*>(mine) + R * K * kWarp;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      my_d[(r * K + j) * kWarp + lane] = bd[r][j];
      my_i[(r * K + j) * kWarp + lane] = bi[r][j];
    }
  }
  __syncthreads();
  // warp g merges query slot r = g, g + G, ... over the parts in order
  for (int r = g; r < R; r += G) {
    float md[K];
    int mi[K];
    init_list<K>(md, mi);
    for (int w = 0; w < G; ++w) {
      const float* wd = reinterpret_cast<const float*>(smem + w * warp_smem_bytes<K>());
      const int* wi = reinterpret_cast<const int*>(wd) + R * K * kWarp;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        // a part's list is ascending: once an entry cannot enter, no later
        // entry of that part can
        const float d = wd[(r * K + j) * kWarp + lane];
        if (!(d < md[K - 1])) break;
        insert<K>(d, wi[(r * K + j) * kWarp + lane], md, mi);
      }
    }
    const int qi = q0 + r * kWarp + lane;
    if (qi < Q) store<K>(out_d, out_i, qi, md, mi);
  }
}

// Grid (query chunks, S slices, B problems). Problem b's queries start at
// q + b * q_bstride and its points at p + b * p_bstride (floats; 0 shares
// one array among all problems). Slice s covers points [s * slice,
// min(C, (s + 1) * slice)) and writes rows [(s * B + b) * Q, +Q) of out:
// the final [B, Q, K] output when S = 1, else the scratch [S, B * Q, K].
template <int K>
__global__ void __launch_bounds__(kMaxGroups* kWarp)
    knn_sweep_kernel(const float* __restrict__ q, int Q, long long q_bstride,
                     const float* __restrict__ p, int C, long long p_bstride,
                     int slice, float* __restrict__ out_d, int* __restrict__ out_i) {
  const int b = blockIdx.z;
  const int begin = min(C, static_cast<int>(blockIdx.y) * slice);
  const int end = min(C, begin + slice);
  const size_t row0 = (static_cast<size_t>(blockIdx.y) * gridDim.z + b) * Q;
  sweep_block<K>(q + b * q_bstride, Q, p + b * p_bstride, begin, end,
                 out_d + row0 * K, out_i + row0 * K);
}

// One thread per output row merges that row's S lists of the scratch
// [S, rows, K] in slice order.
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                     int S, long long rows, float* __restrict__ out_d,
                     int* __restrict__ out_i) {
  const long long row = static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (row >= rows) return;
  float bd[K];
  int bi[K];
  init_list<K>(bd, bi);
  for (int s = 0; s < S; ++s) {
    const size_t at = (static_cast<size_t>(s) * rows + row) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = part_d[at + j];
      if (!(d < bd[K - 1])) break;
      insert<K>(d, part_i[at + j], bd, bi);
    }
  }
  store<K>(out_d, out_i, static_cast<size_t>(row), bd, bi);
}

// Launch the sweep (and, for S > 1, the merge) on `stream`: B problems of Q
// queries against C points each, blocks of `groups` warps, S slices of
// `slice` points (S * slice >= C). part_d / part_i are [S, B * Q, K] scratch,
// read only when S > 1. Does not synchronise and allocates nothing.
template <int K>
cudaError_t launch_sweep(const float* q, int Q, long long q_bstride, const float* p,
                         int C, long long p_bstride, int B, int groups, int slice,
                         int S, float* part_d, int* part_i, float* out_d, int* out_i,
                         cudaStream_t stream) {
  const int smem = groups * warp_smem_bytes<K>();
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(knn_sweep_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  knn_sweep_kernel<K><<<sweep_grid(Q, B, K, S), sweep_threads(groups), smem, stream>>>(
      q, Q, q_bstride, p, C, p_bstride, slice, S > 1 ? part_d : out_d,
      S > 1 ? part_i : out_i);
  if (S > 1) {
    const long long rows = static_cast<long long>(B) * Q;
    const unsigned blocks =
        static_cast<unsigned>((rows + kMergeThreads - 1) / kMergeThreads);
    knn_merge_kernel<K><<<blocks, kMergeThreads, 0, stream>>>(part_d, part_i, S, rows,
                                                              out_d, out_i);
  }
  return cudaGetLastError();
}

// Check the launch parameters and dispatch the runtime k in 1..8 to its
// template; what the three C entry points share. Returns a cudaError_t as
// int (0 on success).
inline int run_sweep(const float* q, int Q, long long q_bstride, const float* p, int C,
                     long long p_bstride, int B, int k, int groups, int slice, int S,
                     float* part_d, int* part_i, float* out_d, int* out_i,
                     void* stream) {
  if (Q <= 0 || B == 0) return static_cast<int>(cudaSuccess);
  if (C < 0 || B < 0 || B > 65535 || q_bstride < 0 || p_bstride < 0 || groups < 1 ||
      groups > kMaxGroups || slice <= 0 || S <= 0 || S > 65535 ||
      static_cast<long long>(S) * slice < C || (S > 1 && (!part_d || !part_i)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  auto go = [&](auto kc) {
    err = launch_sweep<decltype(kc)::value>(q, Q, q_bstride, p, C, p_bstride, B, groups,
                                            slice, S, part_d, part_i, out_d, out_i, st);
  };
  switch (k) {
    case 1: go(std::integral_constant<int, 1>{}); break;
    case 2: go(std::integral_constant<int, 2>{}); break;
    case 3: go(std::integral_constant<int, 3>{}); break;
    case 4: go(std::integral_constant<int, 4>{}); break;
    case 5: go(std::integral_constant<int, 5>{}); break;
    case 6: go(std::integral_constant<int, 6>{}); break;
    case 7: go(std::integral_constant<int, 7>{}); break;
    case 8: go(std::integral_constant<int, 8>{}); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace mp2p_knn
