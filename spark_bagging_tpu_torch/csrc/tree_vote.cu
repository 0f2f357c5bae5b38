// The replica-summed hard vote of a bag of decision-tree classifiers on
// Hopper: out[i, c] = the number of trees that route row i to a leaf
// whose class is c.
//
// Replaces no TPU kernel: the JAX package leaves routing and the hard
// vote to XLA (`_route` in spark_bagging_tpu/models/tree.py and
// `predict_ensemble_classifier` in spark_bagging_tpu/ensemble.py). In the
// port it was a chain of torch's generic gathers and elementwise kernels
// over (R, n) int64 tensors: at config 3 (n = 581,012 rows, R = 256
// depth-5 trees on 43 of 54 columns) ~78 ms a call for a 16 MB answer.
//
// What bounds it on an H100: bytes, X read once (4 n F) against
// n R D = 744 M compares, ~42 us at 3.35 TB/s; in practice the routing's
// dependent shared-memory lookups, two a level of every (row, tree).
// The design keeps every lookup on chip and free of bank conflicts:
//   * a persistent block an SM (1024 threads) walks row tiles of kRows =
//     128 rows. Each tile of X is staged in shared memory column-major,
//     Xs[col][row], by 4-byte cp.async (cached in L1, so a row's sectors
//     are read from device memory once) into one of two buffers while
//     the block walks the other. The lanes of a warp are consecutive
//     rows, so Xs[col][row] falls in bank row % 32 whatever column each
//     row reads. X wider than half the shared memory is read from device
//     memory through L1 instead;
//   * the trees' tables are staged in shared memory once a block: each
//     node's global column and float32 threshold (8 bytes, heap order)
//     and each leaf's class (a byte). At config 3 all 256 trees fit
//     (71.5 KB). A bag too large for one stage is split over grid.y, and
//     its stages' counts are added in device memory (float atomics of
//     whole numbers: exact, in any order);
//   * the block's warps split the tile into four warps of rows and eight
//     groups of trees; each thread walks kTrees trees side by side, so the
//     dependent chain (node, then X, then the compare) of one tree hides
//     behind the others';
//   * each row's votes stay in registers as 8-bit counters packed in
//     64-bit words (8 classes a word), added into the tile's counts in
//     shared memory at most every 252 trees, and the tile's counts are
//     written once, coalesced, as float32 (whole numbers, exact).
// Every row takes the same comparison as the chain, x > t in fp32 (a NaN
// goes left), so the counts have the chain's bits.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

// The tiling is decided in ops/tree_vote.py (CUDA_DEFINES), which also
// computes the launch geometry from it; utils/native.py passes it here.
#if !defined(SBT_TV_ROWS) || !defined(SBT_TV_WARPS) || \
    !defined(SBT_TV_TREES) || !defined(SBT_TV_SMEM)
#error "build through spark_bagging_tpu_torch/utils/native.py (-D tiling)"
#endif

namespace {

constexpr int kRows = SBT_TV_ROWS;
constexpr int kThreads = 32 * SBT_TV_WARPS;
constexpr int kRowWarps = kRows / 32;
constexpr int kGroups = SBT_TV_WARPS / kRowWarps;
constexpr int kTrees = SBT_TV_TREES;
// trees a thread counts in its 8-bit counters before adding them up
constexpr int kFlushEvery = 255 / kTrees * kTrees;
constexpr int kSmemBytes = SBT_TV_SMEM;
static_assert(kRows % 32 == 0, "a tile is whole warps of rows");
static_assert(SBT_TV_WARPS % kRowWarps == 0, "whole groups of trees");

struct TreeVoteArgs {
  const float* X;         // (n, F)
  const int2* nodes;      // (R, M): column, threshold bits
  const uint8_t* leaf;    // (R, L): class
  float* out;             // (n, C): the counts
  int n, F, C, R, D;
  int per_stage;          // trees a stage (grid.y)
  int row_tiles;
  int accumulate;         // more than one stage: add into out
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from src, or zeros where bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The row tile's X, column-major: element e = col kRows + row of the
// tile, zeros past n.
__device__ __forceinline__ void load_tile(const TreeVoteArgs& a, float* dst,
                                          int tile, int tid) {
  const int r0 = tile * kRows;
  const int total = a.F * kRows;
  for (int e = tid; e < total; e += kThreads) {
    const int col = e / kRows, row = r0 + e % kRows;
    const bool live = row < a.n;
    cp_async4(dst + e, a.X + (live ? (long long)row * a.F + col : 0),
              live ? 4 : 0);
  }
}

// one vote for class c: an 8-bit counter of word c / 8
template <int NW>
__device__ __forceinline__ void add_vote(uint64_t (&acc)[NW], int c) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
    if ((c >> 3) == w) acc[w] += 1ull << ((c & 7) * 8);
}

// the counters into the tile's counts (class-major, row r), then zero
template <int NW>
__device__ __forceinline__ void flush(uint64_t (&acc)[NW], int* cnt, int r) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int v = static_cast<int>((acc[w] >> (8 * j)) & 0xffu);
      if (v) atomicAdd(cnt + (8 * w + j) * kRows + r, v);
    }
    acc[w] = 0;
  }
}

template <int NW, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1) tree_vote(TreeVoteArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = (warp % kRowWarps) * 32 + lane;  // the thread's row
  const int grp = warp / kRowWarps;               // its group of trees
  const int M = (1 << a.D) - 1, L = 1 << a.D;
  const int t0 = blockIdx.y * a.per_stage;
  const int S = min(a.per_stage, a.R - t0);
  const int xf = STAGED ? a.F * kRows : 0;
  int* cnt = reinterpret_cast<int*>(smem);  // [C][kRows]
  float* xs = reinterpret_cast<float*>(cnt + a.C * kRows);  // 2 x [F][kRows]
  int2* nodes = reinterpret_cast<int2*>(xs + 2 * xf);
  uint8_t* leaf = reinterpret_cast<uint8_t*>(nodes + S * M);

  int tile = blockIdx.x;
  if constexpr (STAGED) {
    load_tile(a, xs, tile, tid);
    cp_async_commit();
  }
  // the stage's tables and zero counts (before the first tile's barrier)
  const int2* gn = a.nodes + (long long)t0 * M;
  for (int i = tid; i < S * M; i += kThreads) nodes[i] = gn[i];
  const uint8_t* gl = a.leaf + (long long)t0 * L;
  for (int i = tid; i < S * L; i += kThreads) leaf[i] = gl[i];
  for (int i = tid; i < a.C * kRows; i += kThreads) cnt[i] = 0;
  // the group's trees: grp, grp + kGroups, ...
  const int per = grp < S ? (S - grp + kGroups - 1) / kGroups : 0;

  for (int it = 0; tile < a.row_tiles; tile += gridDim.x, ++it) {
    if constexpr (STAGED) {
      const int next = tile + gridDim.x;
      if (next < a.row_tiles)  // lands in the other buffer meanwhile
        load_tile(a, xs + ((it + 1) & 1) * xf, next, tid);
      cp_async_commit();
      cp_async_wait_but_one();
    }
    __syncthreads();  // the tile is in; the last tile's counts are out
    const float* xt = xs + (it & 1) * xf;
    const int row = tile * kRows + r;
    const float* xrow = a.X + (long long)min(row, a.n - 1) * a.F;

    uint64_t acc[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] = 0;
    int held = 0;
    for (int k0 = 0; k0 < per; k0 += kTrees) {
      int tree[kTrees], base[kTrees], rel[kTrees];
#pragma unroll
      for (int g = 0; g < kTrees; ++g) {
        tree[g] = grp + kGroups * min(k0 + g, per - 1);
        base[g] = tree[g] * M;
        rel[g] = 0;
      }
      for (int off = 0; off < M; off = 2 * off + 1) {
        int2 e[kTrees];
#pragma unroll
        for (int g = 0; g < kTrees; ++g) e[g] = nodes[base[g] + off + rel[g]];
        float x[kTrees];
#pragma unroll
        for (int g = 0; g < kTrees; ++g)
          x[g] = STAGED ? xt[e[g].x * kRows + r] : __ldg(xrow + e[g].x);
#pragma unroll
        for (int g = 0; g < kTrees; ++g)
          rel[g] = 2 * rel[g] + (x[g] > __int_as_float(e[g].y) ? 1 : 0);
      }
#pragma unroll
      for (int g = 0; g < kTrees; ++g)
        if (k0 + g < per)
          add_vote<NW>(acc, leaf[tree[g] * L + rel[g]]);
      held += kTrees;
      if (held == kFlushEvery) {
        flush<NW>(acc, cnt, r);
        held = 0;
      }
    }
    flush<NW>(acc, cnt, r);
    __syncthreads();  // the tile's counts are in

    // out, coalesced: the tile's rows are one run of kRows C floats
    const int rows = min(kRows, a.n - tile * kRows);
    float* o = a.out + (long long)tile * kRows * a.C;
    for (int i = tid; i < kRows * a.C; i += kThreads) {
      const int rr = i / a.C, c = i - rr * a.C;
      const int v = cnt[c * kRows + rr];
      cnt[c * kRows + rr] = 0;
      if (rr < rows) {
        if (a.accumulate)
          atomicAdd(o + i, static_cast<float>(v));
        else
          o[i] = static_cast<float>(v);
      }
    }
  }
}

template <int NW>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      tree_vote<NW, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(tree_vote<NW, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

template <int NW>
cudaError_t launch(const TreeVoteArgs& a, int stages, int blocks, int staged,
                   int smem, cudaStream_t st) {
  const dim3 grid(blocks, stages);
  if (staged)
    tree_vote<NW, true><<<grid, kThreads, smem, st>>>(a);
  else
    tree_vote<NW, false><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Once a device, before the first launch there: the kernels' dynamic
// shared memory size.
int sbt_tree_vote_init() {
  cudaError_t err = set_smem<1>();
  if (err == cudaSuccess) err = set_smem<2>();
  if (err == cudaSuccess) err = set_smem<3>();
  if (err == cudaSuccess) err = set_smem<4>();
  return static_cast<int>(err);
}

// X: (n, F) float32; nodes: (R, 2^D - 1) int2 (column, threshold bits);
// leaf: (R, 2^D) uint8 classes < C <= 32; out: (n, C) float32, zeroed
// where accumulate. Geometry (per_stage trees a stage, stages, blocks a
// stage, staged X, shared memory bytes) comes from the Python wrapper
// (ops/tree_vote.py).
int sbt_tree_vote(const void* X, const void* nodes, const void* leaf,
                  void* out, int n, int F, int C, int R, int D,
                  int per_stage, int stages, int blocks, int staged,
                  int accumulate, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TreeVoteArgs a{static_cast<const float*>(X),
                       static_cast<const int2*>(nodes),
                       static_cast<const uint8_t*>(leaf),
                       static_cast<float*>(out),
                       n, F, C, R, D, per_stage,
                       (n + kRows - 1) / kRows, accumulate};
  switch ((C + 7) / 8) {
    case 1: return static_cast<int>(launch<1>(a, stages, blocks, staged, smem, st));
    case 2: return static_cast<int>(launch<2>(a, stages, blocks, staged, smem, st));
    case 3: return static_cast<int>(launch<3>(a, stages, blocks, staged, smem, st));
    case 4: return static_cast<int>(launch<4>(a, stages, blocks, staged, smem, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
