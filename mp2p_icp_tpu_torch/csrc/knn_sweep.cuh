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
//   * Counts on the device. The front ends pass two optional int32 arrays,
//     the leading query rows to answer and point rows to sweep of each
//     problem (nn_bruteforce.valid_count: the last valid row + 1, computed
//     on the card). A block of query rows at or past its count writes
//     (+inf, -1) and leaves; the S slices split [0, np) on the device. A
//     padded layer costs the work of its valid rows, and no host read
//     enters the call, so it still runs inside a CUDA graph.
//   * Register tile. A thread holds R queries, so one point read from
//     shared memory serves R pairs and the loop counter, the index and the
//     address arithmetic are paid once per point: R = 8 for k = 1; for
//     k > 1 the launch takes 1, 2 or 4 (register_tile: the longest parts).
//   * Deferred index (K = 1). The loop keeps only the best d2 (one FMNMX per
//     pair) and, once per 4-point group, the group that improved it; the
//     index within the group is found after the sweep by recomputing four
//     distances. 10.0 issued instructions per pair instead of 11.3.
//   * Deferred insertion (K > 1). The loop keeps a threshold per query, at
//     most its K-th distance and the pooled K-th distances of the block's
//     other warps and of the other slices: a 4-point group costs one min
//     per pair and, when its nearest point is at or below the threshold,
//     one bit in the query's hit mask. After a window of groups (the first
//     one fills the lists, each next one is twice as long, up to 32), each
//     thread recomputes its hit groups' distances with the same roundings
//     and inserts the points below its list's last entry in index order.
//     The group loop is unrolled to about 8 queries' work an iteration.
//     9.9-12.0 issued instructions per pair in the loop, against about 42
//     for the insertion per pair that it replaces, which the compiler had
//     turned into predicated code in the loop.
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
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (scripts/torch_knn_tune.py
// and chip_smoke.py, device time per launch in a CUDA graph; PERF.md
// section 6 has the table): the k = 1 inner loop issues 10.0 instructions
// per pair (the one-query sweep it replaced: 14.25) and runs at 56% of the
// bound at 8192 x 8192 (0.032 ms), 74% at 8192 x 65536 and 78% at 8192 x
// 262144 and at 8 x 8192 x 65536. For k = 8 the loop issues 9.9 (R = 4)
// to 12.0 (R = 1) per pair; what remains of the insertion is each part's
// own list, filled and refined about K (1 + ln(part / K)) times per query
// on unordered points: 0.074 ms at 8192 x 8192 (24% of the bound; before,
// 0.121), 0.055 at 2048 x 22528 (23%; 0.077), 0.96 at 8192 x 262144 (60%;
// 1.27). With counts, the padded shapes cost their valid rows: 131072^2
// k = 1 with 471 x 478 valid rows 0.011 ms (before, 5.80), k = 8 with
// 3,990 0.093 ms (8.47).
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

// Queries held by one thread, the register tile R: kQueriesK1 for k = 1;
// for k > 1 the launch takes 1, 2 or kQueriesKn = 4 (nn_bruteforce.py's
// register_tile chooses, for the longest parts: a part refills its K-lists
// once per query).
constexpr int kQueriesK1 = 8;
constexpr int kQueriesKn = 4;
// For k > 1 a thread inserts the hits of a window of 4-point groups at once
// and then pools its K-th distances with the block and, when the points are
// split into slices, with the launch. A part's first window is the groups
// that fill a list; each next one is twice as long, up to this many groups
// (at most 32: the hits of a query are one bit each in a 32-bit mask).
constexpr int kShareGroups = 32;
static_assert(kShareGroups >= 1 && kShareGroups <= 32, "a window's hits fit in 32 bits");
// For k > 1 the group loop is unrolled to about this many queries' work per
// iteration (kUnrollQueries / R groups), as k = 1's R = 8 holds.
constexpr int kUnrollQueries = 8;
// The register tiles a launch may take for k.
inline bool tile_allowed(int k, int r) {
  return k == 1 ? r == kQueriesK1 : (r == 1 || r == 2 || r == kQueriesKn);
}

// The grid of a sweep: (query chunks of 32 * R, S slices, B problems).
inline dim3 sweep_grid(int Q, int B, int r, int S) {
  const int per_block = kWarp * r;
  return dim3((Q + per_block - 1) / per_block, S, B);
}

// Threads of a block of `groups` warps.
inline int sweep_threads(int groups) { return groups * kWarp; }

// Shared memory of one warp: its tile ring, reused for its R lists of K
// (distance, index) entries per lane when the block merges.
template <int K, int R>
__host__ __device__ constexpr int warp_smem_bytes() {
  constexpr int ring = kStages * kTileFloats * 4;
  constexpr int lists = R * K * kWarp * 8;
  return ring > lists ? ring : lists;
}

// Shared memory of a block of `groups` warps: the warps' regions, then for
// k > 1 the block's pooled bound of each of its 32 * R queries and each
// warp's ceil(K/2)-th distance of each (Thresholds).
template <int K, int R>
__host__ __device__ constexpr int block_smem_bytes(int groups) {
  return groups * warp_smem_bytes<K, R>() + (K > 1 ? (1 + groups) * R * kWarp * 4 : 0);
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

// k > 1: a thread's thresholds. th[r] is at most the K-th distance of query
// slot r's list and of the pools': the block's (its warps hold the same
// queries) in shared memory, and the launch's (one word per query row, read
// and lowered by every slice of the points) in device memory, or none. Any
// list's K-th distance bounds the final one from above: the list holds K
// points at or below it. Distances are >= 0, so their bits order as
// unsigned integers, and a pool only ever falls.
template <int R>
struct Thresholds {
  float th[R];
  unsigned* block;   // [R][32] of the block
  float* halves;     // [G][R][32]: each warp's ceil(K/2)-th distance
  unsigned* launch;  // [Q] of this problem, or null
  int row[R];        // each slot's row of `launch`, -1 without a query
  unsigned seen[R];  // `launch` as read at the start of the window
  int window;        // groups of the next window (the same in every lane)
};

// Read the launch's pool at the start of a window (used at its end, so the
// read's latency hides behind the window's sweep).
template <int R>
__device__ __forceinline__ void read_launch_pool(Thresholds<R>& ts) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    ts.seen[r] = ts.launch && ts.row[r] >= 0
                     ? *reinterpret_cast<volatile const unsigned*>(ts.launch + ts.row[r])
                     : __float_as_uint(CUDART_INF_F);
}

// After a window: pool slot r's bounds and lower its threshold. Besides the
// K-th distances, each warp publishes its ceil(K/2)-th while its windows
// are still growing: the second smallest of those over the block's warps
// has two lists' ceil(K/2) points at or below it, at least K points of two
// parts, and early in a sweep of unordered points it lies far below any one
// part's K-th distance (later, a long part's own K-th is as good).
template <int K, int R>
__device__ __forceinline__ void pool_threshold(const float (&bd)[K], Thresholds<R>& ts, int r,
                                               int lane, int g, int G) {
  unsigned mine = __float_as_uint(bd[K - 1]);
  if (ts.window < kShareGroups) {
    constexpr int H = (K + 1) / 2;
    volatile float* halves = ts.halves + r * kWarp + lane;  // warp w's at [w * R * 32]
    halves[g * R * kWarp] = bd[H - 1];
    float m1 = CUDART_INF_F, m2 = CUDART_INF_F;
    for (int w = 0; w < G; ++w) {
      const float v = halves[w * R * kWarp];
      m2 = fminf(m2, fmaxf(m1, v));
      m1 = fminf(m1, v);
    }
    mine = min(mine, __float_as_uint(m2));
  }
  const unsigned block = min(atomicMin(ts.block + r * kWarp + lane, mine), mine);
  if (ts.launch && ts.row[r] >= 0 && block < ts.seen[r])
    atomicMin(ts.launch + ts.row[r], block);  // its result unused: a reduction, no wait
  ts.th[r] = __uint_as_float(min(block, ts.seen[r]));
}

// k > 1: insert the points of the groups marked in `hits` (bit w: group
// j0 + w of the stage) into one query's list, in index order: each group's
// four distances recomputed with the same roundings, and each point that
// beats the list's last entry entered with the strict '<' of insert<K>
// (one insertion per such point, not four per group).
template <int K>
__device__ __forceinline__ void insert_hits(float qx, float qy, float qz, const float* stage,
                                           int first, int j0, unsigned hits,
                                           float (&bd)[K], int (&bi)[K]) {
  const float4* s4 = reinterpret_cast<const float4*>(stage);
  while (hits) {
    const int j = j0 + __ffs(hits) - 1;
    hits &= hits - 1;
    const float4 a = s4[3 * j];
    const float4 b = s4[3 * j + 1];
    const float4 c = s4[3 * j + 2];
    float d[4] = {dist2(qx, qy, qz, a.x, a.y, a.z), dist2(qx, qy, qz, a.w, b.x, b.y),
                  dist2(qx, qy, qz, b.z, b.w, c.x), dist2(qx, qy, qz, c.y, c.z, c.w)};
    unsigned in = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) in |= (d[u] < bd[K - 1] ? 1u : 0u) << u;
    while (in) {  // in index order; a later point of the group meets the updated list
      const int u = __ffs(in) - 1;
      in &= in - 1;
      const float du = u == 0 ? d[0] : u == 1 ? d[1] : u == 2 ? d[2] : d[3];
      insert<K>(du, first + 4 * j + u, bd, bi);
    }
  }
}

// Sweep one landed stage: n4 groups of 4 points whose first has absolute
// index `first`, against the thread's R queries. A group is three 16-byte
// shared-memory reads, the same address in every lane.
//
// k = 1 keeps the best distance and, per group, the group that improved it
// (resolve_index finds the point). k > 1 keeps a threshold per query
// (Thresholds) and sweeps windows of groups, the part's first window only
// the (K + 3) / 4 groups that fill its lists, each next one twice as long up
// to kShareGroups: in the loop a
// group costs one min per pair and, when its nearest point is at or below
// the threshold, one bit in the query's hit mask; after the window each
// thread inserts its own hits (insert_hits) and pools its K-th distances. A
// group above the threshold cannot enter the final list, and a point at it
// may still win its tie by index.
template <int K, int R>
__device__ __forceinline__ void sweep_tile(const float (&qx)[R], const float (&qy)[R],
                                           const float (&qz)[R], const float* stage,
                                           int first, int n4, float (&bd)[R][K],
                                           int (&bi)[R][K], Thresholds<R>& ts, int lane,
                                           int g, int G) {
  const float4* s4 = reinterpret_cast<const float4*>(stage);
  if constexpr (K == 1) {
#pragma unroll 1
    for (int j = 0; j < n4; ++j) {
      const float4 a = s4[3 * j];
      const float4 b = s4[3 * j + 1];
      const float4 c = s4[3 * j + 2];
      const float px[4] = {a.x, a.w, b.z, c.y};
      const float py[4] = {a.y, b.x, b.w, c.z};
      const float pz[4] = {a.z, b.y, c.x, c.w};
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
          bi[r][0] = first + 4 * j;
        }
      }
    }
  } else {
#pragma unroll 1
    for (int j0 = 0; j0 < n4; j0 += ts.window, ts.window = min(2 * ts.window, kShareGroups)) {
      const int n = min(ts.window, n4 - j0);
      read_launch_pool<R>(ts);
      unsigned hits[R];
#pragma unroll
      for (int r = 0; r < R; ++r) hits[r] = 0u;
#pragma unroll(kUnrollQueries / R > 0 ? kUnrollQueries / R : 1)
      for (int w = 0; w < n; ++w) {
        const int j = j0 + w;
        const float4 a = s4[3 * j];
        const float4 b = s4[3 * j + 1];
        const float4 c = s4[3 * j + 2];
        const float px[4] = {a.x, a.w, b.z, c.y};
        const float py[4] = {a.y, b.x, b.w, c.z};
        const float pz[4] = {a.z, b.y, c.x, c.w};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float m = dist2(qx[r], qy[r], qz[r], px[0], py[0], pz[0]);
#pragma unroll
          for (int u = 1; u < 4; ++u)
            m = fminf(m, dist2(qx[r], qy[r], qz[r], px[u], py[u], pz[u]));
          if (m <= ts.th[r]) hits[r] |= 1u << w;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        insert_hits<K>(qx[r], qy[r], qz[r], stage, first, j0, hits[r], bd[r], bi[r]);
        pool_threshold<K, R>(bd[r], ts, r, lane, g, G);
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
// absolute. ts: sweep_tile's thresholds (k > 1).
template <int K, int R>
__device__ __forceinline__ void sweep_range(const float (&qx)[R], const float (&qy)[R],
                                            const float (&qz)[R],
                                            const float* __restrict__ p, int begin,
                                            int end, float* ring, int lane,
                                            float (&bd)[R][K], int (&bi)[R][K],
                                            Thresholds<R>& ts, int g, int G) {
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
                     (n + 3) >> 2, bd, bi, ts, lane, g, G);
    __syncwarp();  // every lane is done with the stage before it is refilled
  }
}

// One block: G = blockDim.x / 32 warps hold the same 32*R queries (lane l
// of every warp holds queries q0 + r*32 + l) and sweep the G contiguous
// parts of the points [begin, end); the G lists are then merged in part
// order and written to rows [q0, q0 + 32*R) of out_d / out_i ([Q, K]).
// Rows in [nq, Q) are no queries: they get (+inf, -1). launch_pool: the
// launch's thresholds of this problem's Q queries (k > 1), or null.
template <int K, int R>
__device__ __forceinline__ void sweep_block(const float* __restrict__ q, int Q, int nq,
                                            const float* __restrict__ p, int begin,
                                            int end, unsigned* __restrict__ launch_pool,
                                            float* __restrict__ out_d,
                                            int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int g = threadIdx.x / kWarp;
  const int G = blockDim.x / kWarp;
  float* mine = reinterpret_cast<float*>(smem + g * warp_smem_bytes<K, R>());
  const int q0 = blockIdx.x * (kWarp * R);

  float qx[R], qy[R], qz[R];
  float bd[R][K];
  int bi[R][K];
  Thresholds<R> ts;
  ts.block = reinterpret_cast<unsigned*>(smem + G * warp_smem_bytes<K, R>());
  ts.halves = reinterpret_cast<float*>(ts.block + R * kWarp);
  ts.launch = launch_pool;
  ts.window = (K + 3) / 4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + r * kWarp + lane;
    qx[r] = qy[r] = qz[r] = 0.f;  // a thread without a query still loads tiles
    if (qi < nq) {
      const float* qq = q + 3 * static_cast<size_t>(qi);
      qx[r] = qq[0];
      qy[r] = qq[1];
      qz[r] = qq[2];
    }
    ts.th[r] = CUDART_INF_F;
    ts.row[r] = qi < nq ? qi : -1;
    init_list<K>(bd[r], bi[r]);
  }
  if constexpr (K > 1) {
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) ts.block[r * kWarp + lane] = __float_as_uint(CUDART_INF_F);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) ts.halves[(g * R + r) * kWarp + lane] = CUDART_INF_F;
    __syncthreads();
  }

  // this warp's part: a whole number of 4-point groups, so that every part
  // of an aligned slice starts 16-byte aligned
  const int len = max(end - begin, 0);
  const int part = (((len + G - 1) / G) + 3) & ~3;
  const int part_begin = begin + g * part;
  const int part_end = min(end, part_begin + part);
  sweep_range<K, R>(qx, qy, qz, p, part_begin, part_end, mine, lane, bd, bi, ts, g, G);
  if constexpr (K == 1) resolve_index<R>(qx, qy, qz, p, part_end, bd, bi);

  if (G == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + r * kWarp + lane;
      if (qi < nq) {
        store<K>(out_d, out_i, qi, bd[r], bi[r]);
      } else if (qi < Q) {
        init_list<K>(bd[r], bi[r]);
        store<K>(out_d, out_i, qi, bd[r], bi[r]);
      }
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
    const int qi = q0 + r * kWarp + lane;
    for (int w = 0; w < G && qi < nq; ++w) {
      const float* wd = reinterpret_cast<const float*>(smem + w * warp_smem_bytes<K, R>());
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
    if (qi < Q) store<K>(out_d, out_i, qi, md, mi);
  }
}

// The sweep's range of a block's problem: the leading rows to answer (nq)
// and to sweep (np), from the optional device counts (one entry per problem,
// or a single entry for an array shared by every problem: batch stride 0);
// null means the capacity. Counts are clamped to [0, capacity].
__device__ __forceinline__ int count_of(const int* __restrict__ n, int b, long long bstride,
                                        int capacity) {
  return n ? min(max(n[bstride ? b : 0], 0), capacity) : capacity;
}

// Grid (query chunks, S slices, B problems). Problem b's queries start at
// q + b * q_bstride and its points at p + b * p_bstride (floats; 0 shares
// one array among all problems). Without a point count, slice s covers
// points [s * slice, min(C, (s + 1) * slice)); with one (np), the S slices
// split [0, np) on the device: [s * L, min(np, (s + 1) * L)) with L =
// ceil(np / S) rounded up to whole 4-point groups. A block of query rows at
// or past nq sweeps nothing. Slice s writes rows [(s * B + b) * Q, +Q) of
// out: the final [B, Q, K] output when S = 1, else the scratch [S, B * Q,
// K], whose rows at or past nq knn_merge_kernel does not read. part_th: the
// launch's pool of thresholds, [B * Q] at +inf (k > 1 with S > 1), or null.
template <int K, int R>
__global__ void __launch_bounds__(kMaxGroups* kWarp)
    knn_sweep_kernel(const float* __restrict__ q, int Q, long long q_bstride,
                     const float* __restrict__ p, int C, long long p_bstride,
                     int slice, const int* __restrict__ nq_of,
                     const int* __restrict__ np_of, unsigned* __restrict__ part_th,
                     float* __restrict__ out_d, int* __restrict__ out_i) {
  const int b = blockIdx.z;
  const int S = gridDim.y;
  const int nq = count_of(nq_of, b, q_bstride, Q);
  const size_t row0 = (static_cast<size_t>(blockIdx.y) * gridDim.z + b) * Q;
  const int q0 = blockIdx.x * (kWarp * R);
  if (q0 >= nq) {  // no query in this block: the whole block leaves here
    if (S == 1) {
      const int rows = min(Q - q0, kWarp * R);
      for (int e = threadIdx.x; e < rows * K; e += blockDim.x) {
        out_d[(row0 + q0) * K + e] = CUDART_INF_F;
        out_i[(row0 + q0) * K + e] = -1;
      }
    }
    return;
  }
  int begin, end;
  if (np_of) {
    const int np = count_of(np_of, b, p_bstride, C);
    const int len = (((np + S - 1) / S) + 3) & ~3;
    begin = min(np, static_cast<int>(blockIdx.y) * len);
    end = min(np, begin + len);
  } else {
    begin = min(C, static_cast<int>(blockIdx.y) * slice);
    end = min(C, begin + slice);
  }
  sweep_block<K, R>(q + b * q_bstride, Q, nq, p + b * p_bstride, begin, end,
                 part_th ? part_th + static_cast<size_t>(b) * Q : nullptr, out_d + row0 * K,
                 out_i + row0 * K);
}

// One thread per output row merges that row's S lists of the scratch
// [S, B * Q, K] in slice order; a row at or past its problem's query count
// gets (+inf, -1) without reading the scratch.
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                     int S, int B, int Q, long long q_bstride,
                     const int* __restrict__ nq_of, float* __restrict__ out_d,
                     int* __restrict__ out_i) {
  const long long rows = static_cast<long long>(B) * Q;
  const long long row = static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (row >= rows) return;
  float bd[K];
  int bi[K];
  init_list<K>(bd, bi);
  const int b = static_cast<int>(row / Q);
  if (row - static_cast<long long>(b) * Q < count_of(nq_of, b, q_bstride, Q)) {
    for (int s = 0; s < S; ++s) {
      // a slice's list in one round of loads, then merged from registers
      const size_t at = (static_cast<size_t>(s) * rows + row) * K;
      float d[K];
      int idx[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        d[j] = part_d[at + j];
        idx[j] = part_i[at + j];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!(d[j] < bd[K - 1])) break;
        insert<K>(d[j], idx[j], bd, bi);
      }
    }
  }
  store<K>(out_d, out_i, static_cast<size_t>(row), bd, bi);
}

// Launch the sweep (and, for S > 1, the merge) on `stream`: B problems of Q
// queries against C points each, blocks of `groups` warps, S slices of
// `slice` points (S * slice >= C). part_d / part_i are [S, B * Q, K] scratch,
// read only when S > 1; part_th [B * Q] at +inf, used when S > 1 and K > 1
// (may be null: no pooling across slices). nq / np: the optional device
// counts of knn_sweep_kernel. Does not synchronise and allocates nothing.
template <int K, int R>
cudaError_t launch_sweep(const float* q, int Q, long long q_bstride, const float* p,
                         int C, long long p_bstride, int B, int groups, int slice,
                         int S, const int* nq, const int* np, float* part_d, int* part_i,
                         unsigned* part_th, float* out_d, int* out_i,
                         cudaStream_t stream) {
  const int smem = block_smem_bytes<K, R>(groups);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(knn_sweep_kernel<K, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  knn_sweep_kernel<K, R><<<sweep_grid(Q, B, R, S), sweep_threads(groups), smem, stream>>>(
      q, Q, q_bstride, p, C, p_bstride, slice, nq, np,
      K > 1 && S > 1 ? part_th : nullptr, S > 1 ? part_d : out_d,
      S > 1 ? part_i : out_i);
  if (S > 1) {
    const long long rows = static_cast<long long>(B) * Q;
    const unsigned blocks =
        static_cast<unsigned>((rows + kMergeThreads - 1) / kMergeThreads);
    knn_merge_kernel<K><<<blocks, kMergeThreads, 0, stream>>>(part_d, part_i, S, B, Q,
                                                              q_bstride, nq, out_d, out_i);
  }
  return cudaGetLastError();
}

// Check the launch parameters and dispatch the runtime k in 1..8 and the
// register tile r (tile_allowed) to their template; what the three C entry
// points share. Returns a cudaError_t as int (0 on success).
inline int run_sweep(const float* q, int Q, long long q_bstride, const float* p, int C,
                     long long p_bstride, int B, int k, int r, int groups, int slice, int S,
                     const int* nq, const int* np, float* part_d, int* part_i,
                     unsigned* part_th, float* out_d, int* out_i, void* stream) {
  if (Q <= 0 || B == 0) return static_cast<int>(cudaSuccess);
  if (C < 0 || B < 0 || B > 65535 || q_bstride < 0 || p_bstride < 0 || groups < 1 ||
      groups > kMaxGroups || slice <= 0 || S <= 0 || S > 65535 ||
      static_cast<long long>(S) * slice < C || (S > 1 && (!part_d || !part_i)) ||
      k < 1 || k > 8 || !tile_allowed(k, r))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  auto go = [&](auto kc, auto rc) {
    err = launch_sweep<decltype(kc)::value, decltype(rc)::value>(
        q, Q, q_bstride, p, C, p_bstride, B, groups, slice, S, nq, np, part_d, part_i,
        part_th, out_d, out_i, st);
  };
  auto tiles = [&](auto kc) {
    if (r == 1) go(kc, std::integral_constant<int, 1>{});
    else if (r == 2) go(kc, std::integral_constant<int, 2>{});
    else go(kc, std::integral_constant<int, kQueriesKn>{});
  };
  switch (k) {
    case 1: go(std::integral_constant<int, 1>{}, std::integral_constant<int, kQueriesK1>{});
      break;
    case 2: tiles(std::integral_constant<int, 2>{}); break;
    case 3: tiles(std::integral_constant<int, 3>{}); break;
    case 4: tiles(std::integral_constant<int, 4>{}); break;
    case 5: tiles(std::integral_constant<int, 5>{}); break;
    case 6: tiles(std::integral_constant<int, 6>{}); break;
    case 7: tiles(std::integral_constant<int, 7>{}); break;
    default: tiles(std::integral_constant<int, 8>{}); break;
  }
  return static_cast<int>(err);
}

}  // namespace mp2p_knn
