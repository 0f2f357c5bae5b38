// Binned left statistics on Hopper: one tree level's split-search table
//   out[r, f, b, n, k] = sum_i [X[i, c_r(f)] <= E_r[f, b]] [node_r[i] == n] S_r[i, k]
// where c_r(f) is replica r's column of its feature f (its subspace
// index; the identity where none is given).
//
// Replaces the TPU kernel spark_bagging_tpu/ops/hist.py `_hist_kernel`
// (reached through `binned_left_stats`, whose pl.pallas_call builds a
// (rows, F_t*B) 0/1 indicator block and a (rows, N*K) node-scattered
// statistics block in VMEM and multiplies them on the MXU).
//
// Two kernels and a finalize pass:
//   * bin_codes: code[i, f] = the first b with X[i, f] <= E[f, b] (NaN
//     edges read as +inf), B where there is none (NaN x, or x above every
//     edge). For ascending edges [x <= E[b]] == [code <= b], so the
//     indicator table is the cumulative sum over b of a histogram of the
//     codes. The edges are fixed for a whole fit, so the tree fit bins
//     its shared (n, F_all) X once (uint8 codes for B <= 255, int16
//     beyond), and every level of every replica reads those codes
//     through the replica's column index: no per-replica copy of X;
//   * hist_partial: one block owns (replica, node tile [x feature tile],
//     row split) and keeps a shared-memory histogram of all the
//     replica's features for as many nodes as fit (features are tiled
//     only where one node's full-width histogram does not fit a block);
//   * hist_finalize: sums row-split partials in split order, takes the
//     cumulative sum over b, and writes 0 where the edge is NaN (the
//     indicator [x <= NaN] is 0).
//
// What bounds it on an H100: shared-memory atomics and bytes. At the
// headline tree level (n = 581,012 rows, 43 of 54 features, N = 16
// nodes, K = 7 classes, ~63% of rows with a nonzero Poisson weight) a
// replica needs ~16 M (row, feature) adds, one shared atomic each, and
// reads ~16 MB of statistics and ~2.3 MB of nodes per node tile, plus
// the codes (31 MB for all replicas, resident in the 50 MB L2). On an
// H100 80GB HBM3 (700 W) the int32 atomics did not bind (a plain
// read-modify-write in their place was slower): the pair walk's
// instructions and its L2 code loads did. What the design does about
// each:
//   * atomics: the histogram is laid out [b][node][k][f], feature
//     fastest, and the bin stride is padded to a multiple of 32 words
//     (of the power of two at or above the block's feature count, where
//     that is below 32), so the features one warp adds for one row fall
//     on distinct banks whatever their bins. Each staged item is one
//     nonzero (row, k) statistic: a one-hot classification row is one
//     item, so a (row, feature) pair costs one code load, one address
//     and one atomic, with no bin search, no division and no loop over K.
//     Items x features are walked flat, so 43 features keep all 32 lanes
//     busy. Both accumulators add integers, so a table is the same in
//     every run whatever order the atomics land in: with `integral`
//     (integer statistics: Poisson counts times one-hot classes) the
//     histogram is int32 and each block writes its partial as float32;
//     float statistics are fixed point, each value v staged as the int64
//     rint(v * 2**s_r), s_r replica r's power-of-two scale (ops/hist.py
//     sets it from max |S_r| and the row count so that every sum of the
//     table stays below 2**52), summed in int64 and converted back once,
//     in the finalize pass;
//   * bytes: a block reads the 4-byte node of every row of its split and
//     the statistics only of rows in its node tile; nodes are tiled
//     before features, so each row's codes and statistics are read once
//     a level. A pass lists the rows of the block's node tile from 4
//     nodes a thread (the next pass's nodes loading meanwhile); listed
//     rows, one a thread, load their statistics in one batch and append
//     their items to a staging buffer, walked (4 pairs a thread at a
//     time, so 4 code loads are in flight) only when full. So the work
//     per row outside the tile is one node load and a ballot's share.
// Row splits write partials (float32 of the int32 sums; the int64
// fixed-point sums as they are) that the finalize pass sums in split
// order: no atomics in global memory. A fixed-point entry becomes
// float32 once, as float(double(sum) * 2**-s_r): the sum is below 2**52,
// so the double is exact and the one rounding is the float's, the same
// on the card and in the plain version (ops/hist.py), which sums the
// same integers.
// bf16 != 0 rounds S to bfloat16 (round to nearest even) before it is
// added (before it is scaled, in fixed point).
// A launch on the bin slice [b0, b0 + B) of a wider table adds a row
// whose code is below b0 into the slice's first bin and drops a code at
// or above b0 + B (ops/hist.stat_tiles plans such slices).
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns the first CUDA error of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The block size is decided in ops/hist.py (CUDA_DEFINES), which also
// computes the launch geometry from it; utils/native.py passes it here.
#if !defined(SBT_HIST_THREADS) || !defined(SBT_HIST_ROWS_PER_THREAD)
#error "build through spark_bagging_tpu_torch/utils/native.py (-D block size)"
#endif

namespace {

constexpr int kThreads = SBT_HIST_THREADS;
static_assert(kThreads % 32 == 0, "whole warps");
// rows a thread lists a pass (ops/hist.py sizes the row list from it),
// statistics of a row loaded at once, and (item, feature) pairs a
// thread walks at a time
constexpr int kRowsPerThread = SBT_HIST_ROWS_PER_THREAD;
constexpr int kPassRows = kThreads * kRowsPerThread;
constexpr int kListRows = kPassRows + kThreads;
constexpr int kKRegs = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The two accumulators, both kept in 32-bit shared words so that every
// add is a native ATOMS.ADD (a 64-bit shared atomicAdd compiles to a
// compare-and-swap loop, ATOMS.CAST.SPIN.64): int32 sums of integer
// statistics, one plane, written as float32 partials; int64 fixed-point
// sums of float statistics in two planes, the low words and, `plane`
// words on, the high words, written as int64 partials. A fixed-point
// add puts the addend's low word into the low plane and its high word
// plus the carry the low add made (read from the old value it returns)
// into the high plane: whatever order the adds land in, the two planes
// end as the exact 64-bit sum. `stage` turns a statistic into the
// integer it adds.
template <typename Acc>
struct AccOps;

template <>
struct AccOps<int> {
  using Part = float;
  static constexpr int kPlanes = 1;
  static __device__ __forceinline__ int stage(float v, float) {
    return static_cast<int>(v);
  }
  static __device__ __forceinline__ void add(unsigned* h, int e, int v, int) {
    atomicAdd(reinterpret_cast<int*>(h) + e, v);
  }
  static __device__ __forceinline__ float load(const unsigned* h, int e,
                                               int) {
    return static_cast<float>(static_cast<int>(h[e]));
  }
};

template <>
struct AccOps<long long> {
  using Part = long long;
  static constexpr int kPlanes = 2;
  static __device__ __forceinline__ long long stage(float v, float scale) {
    return __float2ll_rn(v * scale);  // exact product: scale is 2**s
  }
  static __device__ __forceinline__ void add(unsigned* h, int e, long long v,
                                             int plane) {
    const unsigned lo = static_cast<unsigned>(v);
    const unsigned old = atomicAdd(h + e, lo);
    const int hi = static_cast<int>(v >> 32) + (old + lo < old ? 1 : 0);
    if (hi != 0) atomicAdd(reinterpret_cast<int*>(h + plane) + e, hi);
  }
  static __device__ __forceinline__ long long load(const unsigned* h, int e,
                                                   int plane) {
    return static_cast<long long>(static_cast<int>(h[plane + e])) *
               4294967296LL +
           static_cast<long long>(h[e]);
  }
};

// codes[r, i, f] for the (R, n, F) output; grid (blocks, R). X is
// (n, F) shared (x_rstride = 0) or (R, n, F), E (F, B) shared or (R, F,
// B); with staged != 0 a block first copies replica r's edges into
// shared memory (NaN as +inf), rows B | 1 words apart so that the
// neighbouring features a warp searches start on distinct banks. A
// thread walks elements gridDim.x * blockDim.x apart, its feature
// advanced without a division.
template <typename Code>
__global__ void bin_codes_kernel(const float* __restrict__ X,
                                 long long x_rstride,
                                 const float* __restrict__ E,
                                 long long e_rstride, Code* __restrict__ codes,
                                 long long n, int F, int B, int staged) {
  extern __shared__ float s_e[];
  const float inf = __int_as_float(0x7f800000);
  const int r = blockIdx.y;
  const float* Er = E + r * e_rstride;
  const int e_row = staged ? B | 1 : B;
  if (staged) {
    for (int e = threadIdx.x; e < F * B; e += blockDim.x) {
      const float v = Er[e];
      s_e[e / B * e_row + e % B] = v != v ? inf : v;
    }
    __syncthreads();
  }
  const float* Xr = X + r * x_rstride;
  Code* Cr = codes + r * n * F;
  const long long step = (long long)gridDim.x * blockDim.x;
  const int f_step = static_cast<int>(step % F);
  long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  int f = static_cast<int>(q % F);
  for (; q < n * F; q += step) {
    const float x = Xr[q];
    const float* e = (staged ? s_e : Er) + f * e_row;
    int lo = 0, hi = B;
    while (lo < hi) {  // the first b with x <= e[b]; NaN x finds none
      const int mid = (lo + hi) >> 1;
      float v = e[mid];
      if (v != v) v = inf;
      if (x <= v) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    Cr[q] = static_cast<Code>(lo);
    f += f_step;
    if (f >= F) f -= F;
  }
}

// Adds every staged item x every feature of the tile: one code load and
// one atomic a pair. Thread t starts at pair t (item t / nf, feature
// t % nf) and steps kThreads pairs, kUnroll at a time so that many code
// loads are in flight. Pairs past the last item, and codes at or above
// the slice's last bin, add into the junk bin row B.
template <typename Code, typename Acc>
__device__ __forceinline__ void add_pairs(
    unsigned* __restrict__ hist, const Code* __restrict__ Cr,
    const int* __restrict__ s_col, const int* __restrict__ s_off,
    const int* __restrict__ s_hoff, const Acc* __restrict__ s_val, int items,
    int nf, int b0, int B, int b_stride, int plane, int a_start, int f_start,
    int a_step, int f_step) {
  int a = a_start, f = f_start;
  while (a < items) {
    int aa[kUnroll], ff[kUnroll], bb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      aa[u] = a < items ? a : 0;
      ff[u] = f;
      bb[u] = a < items ? 0 : B;
      a += a_step;
      f += f_step;
      if (f >= nf) {
        f -= nf;
        ++a;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int code = static_cast<int>(__ldg(Cr + s_off[aa[u]] + s_col[ff[u]]));
      bb[u] = max(bb[u], min(max(code - b0, 0), B));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      AccOps<Acc>::add(hist, bb[u] * b_stride + s_hoff[aa[u]] + ff[u],
                       s_val[aa[u]], plane);
  }
}

// Claims each thread's numbers in a block-wide sequence: `count` items
// of this thread, numbered after those of lower lanes of its warp and
// of the warps that claimed before it. Sets the block's total; one
// barrier. ctr holds three counters used in turn, so resetting one never
// races with a claim that reads or adds to another.
__device__ __forceinline__ int claim(int* ctr, int& turn, int count,
                                     int& total) {
  const int lane = threadIdx.x & 31;
  int incl = count;  // the warp's inclusive prefix sum
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int* t = ctr + turn % 3;
  int wbase = 0;
  if (lane == 31 && incl != 0) wbase = atomicAdd(t, incl);
  wbase = __shfl_sync(0xffffffffu, wbase, 31);
  __syncthreads();
  if (threadIdx.x == 0) ctr[(turn + 2) % 3] = 0;
  total = *t;
  ++turn;
  return wbase + incl - count;
}

// grid (R, f_tiles * n_tiles, splits); block (r, tile, split) histograms
// rows [split * rows_per_split, (split + 1) * rows_per_split) of replica
// r for features [f0, f0 + f_tile) and nodes [n0, n0 + n_tile) into its
// slot of dst, (splits, R, F, B, N, K), uncumulated. codes: row i of
// replica r at codes + r * c_rstride + i * c_row; cols (R, F) or null;
// scale (R,): the fixed-point scales (unread by the int32 accumulator).
//
// Rows go through two phases. A: a pass reads kPassRows nodes (the next
// pass's load while this one runs) and lists the rows of the node tile.
// B: each listed row, one a thread, loads its statistics and stages one
// item per nonzero one; the staged items are walked against every
// feature when the buffer is full. So the statistics of a row are read
// by one block, and only blocks of its node tile work on it.
template <typename Code, typename Acc>
__global__ void __launch_bounds__(kThreads)
hist_partial(const Code* __restrict__ codes, long long c_rstride, int c_row,
             const int* __restrict__ cols, const int* __restrict__ node,
             const float* __restrict__ S, const float* __restrict__ scale,
             typename AccOps<Acc>::Part* __restrict__ dst, int n,
             int F, int B, int b0, int N, int K, int R, int f_tile,
             int n_tile, int n_tiles, int b_stride, int cap,
             int rows_per_split, int bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // planes of [B + 1][b_stride] 32-bit words: bin B takes the pairs
  // that add nothing. The addends follow, 8-byte aligned in fixed point
  using Ops = AccOps<Acc>;
  const int plane = (B + 1) * b_stride;
  unsigned* hist = reinterpret_cast<unsigned*>(smem_raw);
  Acc* s_val = reinterpret_cast<Acc*>(hist + Ops::kPlanes * plane);  // [cap]
  int* s_col = reinterpret_cast<int*>(s_val + cap);  // [f_tile]
  int* s_off = s_col + f_tile;      // [cap] the item row's code offset
  int* s_hoff = s_off + cap;        // [cap] (node, k) offset in hist
  int* s_rows = s_hoff + cap;       // [kListRows]
  int* s_lctr = s_rows + kListRows;  // [3] row-list claims
  int* s_ictr = s_lctr + 3;          // [3] item claims

  const int r = blockIdx.x;
  const int f0 = (blockIdx.y / n_tiles) * f_tile;
  const int n0 = (blockIdx.y % n_tiles) * n_tile;
  const int split = blockIdx.z;
  const int nf = min(f_tile, F - f0);
  const int nn = min(n_tile, N - n0);

  for (int e = threadIdx.x; e < Ops::kPlanes * plane; e += kThreads)
    hist[e] = 0u;
  for (int f = threadIdx.x; f < nf; f += kThreads)
    s_col[f] = cols != nullptr ? cols[(long long)r * F + f0 + f] : f0 + f;
  if (threadIdx.x < 6) s_lctr[threadIdx.x] = 0;

  const Code* Cr = codes + r * c_rstride;
  const float sc = scale != nullptr ? scale[r] : 1.f;
  const int* noder = node + (long long)r * n;
  const float* Sr = S + (long long)r * n * K;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int a_start = threadIdx.x / nf;
  const int f_start = threadIdx.x - a_start * nf;
  const int a_step = kThreads / nf;
  const int f_step = kThreads - a_step * nf;

  int lturn = 0, iturn = 0;
  int g = 0;     // items staged so far, numbered in staging order
  int g_lo = 0;  // the number of the buffer's first item

  // phase B on listed rows [0, limit), kThreads at a time
  auto stage_rows = [&](int limit) {
    for (int base = 0; base < limit; base += kThreads) {
      const int idx = base + threadIdx.x;
      const int row = idx < limit ? s_rows[idx] : -1;
      const int nd = row >= 0 ? noder[row] - n0 : 0;
      const float* s = Sr + (long long)max(row, 0) * K;
      // the statistics, kKRegs at a time, the first kKRegs kept
      float sv[kKRegs];
      int c = 0;
      for (int k0 = 0; k0 < K; k0 += kKRegs) {
        float v[kKRegs];
#pragma unroll
        for (int u = 0; u < kKRegs; ++u)
          v[u] = row >= 0 && k0 + u < K ? s[k0 + u] : 0.f;
#pragma unroll
        for (int u = 0; u < kKRegs; ++u) {
          c += v[u] != 0.f;
          if (k0 == 0) sv[u] = v[u];
        }
      }
      int total;
      const int mine = g + claim(s_ictr, iturn, c, total);
      const int g_end = g + total;  // block-uniform
      const int off = max(row, 0) * c_row;
      const int hb = nd * K * f_tile;
      for (;;) {
        // write this thread's items numbered in [g_lo, g_lo + cap)
        if (c != 0 && mine < g_lo + cap && mine + c > g_lo) {
          int gi = mine;
          auto put = [&](int k, float v) {
            if (v == 0.f) return;
            if (gi >= g_lo && gi < g_lo + cap) {
              const int slot = gi - g_lo;
              s_off[slot] = off;
              s_hoff[slot] = hb + k * f_tile;
              s_val[slot] = Ops::stage(bf16 ? round_bf16(v) : v, sc);
            }
            ++gi;
          };
#pragma unroll
          for (int u = 0; u < kKRegs; ++u)
            if (u < K) put(u, sv[u]);
          for (int k = kKRegs; k < K; ++k) put(k, s[k]);
        }
        if (g_end < g_lo + cap) break;  // room left: keep filling
        __syncthreads();                // the buffer is full: walk it
        add_pairs(hist, Cr, s_col, s_off, s_hoff, s_val, cap, nf, b0, B,
                  b_stride, plane, a_start, f_start, a_step, f_step);
        __syncthreads();
        g_lo += cap;
      }
      g = g_end;
    }
  };

  // phase A: kRowsPerThread rows a thread a pass, row t0 + j * kThreads
  // + threadIdx.x, listed after the rows still waiting from earlier passes
  int nd_next[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = row_begin + j * kThreads + threadIdx.x;
    nd_next[j] = row < row_end ? noder[row] - n0 : -1;
  }
  __syncthreads();
  int listed = 0;  // rows waiting in s_rows, block-uniform
  for (int t0 = row_begin; t0 < row_end; t0 += kPassRows) {
    bool in[kRowsPerThread];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      in[j] = nd_next[j] >= 0 && nd_next[j] < nn;
      cnt += in[j];
      const int row = t0 + kPassRows + j * kThreads + threadIdx.x;
      nd_next[j] = row < row_end ? noder[row] - n0 : -1;
    }
    int total;
    int pos = listed + claim(s_lctr, lturn, cnt, total);
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      if (in[j]) s_rows[pos++] = t0 + j * kThreads + threadIdx.x;
    listed += total;
    if (listed >= kThreads) {
      // stage the whole kThreads-row groups, then move the rest first
      const int done = listed / kThreads * kThreads;
      __syncthreads();
      stage_rows(done);
      const int keep = threadIdx.x < listed - done ? s_rows[done + threadIdx.x] : 0;
      __syncthreads();
      if (threadIdx.x < listed - done) s_rows[threadIdx.x] = keep;
      listed -= done;
    }
  }
  __syncthreads();
  stage_rows(listed);
  __syncthreads();
  add_pairs(hist, Cr, s_col, s_off, s_hoff, s_val, g - g_lo, nf, b0, B,
            b_stride, plane, a_start, f_start, a_step, f_step);
  __syncthreads();

  // the block's partial, (f, b, node, k) order: runs of nn * K floats
  using Part = typename Ops::Part;
  Part* out = dst + ((long long)split * R + r) * F * B * N * K;
  const int run = nn * K;
  for (int e = threadIdx.x; e < nf * B * run; e += kThreads) {
    const int j = e % run;  // node * K + k within the tile
    const int q = e / run;
    const int b = q % B;
    const int f = q / B;
    out[(((long long)(f0 + f) * B + b) * N + n0) * K + j] =
        Ops::load(hist, b * b_stride + j * f_tile + f, plane);
  }
}

// out[r, f, b, n, k] = sum over b' <= b of (sum over splits s, in order,
// of partials[s, r, f, b', n, k]); 0 where edge[f, b] is NaN, as the
// indicator [x <= NaN] is. One thread per (r, f, n, k) column; float
// partials may be out itself (one split), each entry read before it is
// written. int64 partials (inv_scale != null) are fixed point: the sums
// stay integers and each entry is float(double(sum) * inv_scale[r]).
template <typename Part>
__global__ void hist_finalize(const Part* partials, float* out,
                              const float* __restrict__ E,
                              long long e_rstride,
                              const double* __restrict__ inv_scale, int R,
                              int F, int B, int N, int K, int splits) {
  const long long cols = (long long)R * F * N * K;
  const long long per_split = cols * B;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < cols; c += (long long)gridDim.x * blockDim.x) {
    const int k = static_cast<int>(c % K);
    long long q = c / K;
    const int nd = static_cast<int>(q % N);
    q /= N;
    const int f = static_cast<int>(q % F);
    const long long r = q / F;
    const float* Er = E + r * e_rstride + (long long)f * B;
    const double inv = inv_scale != nullptr ? inv_scale[r] : 1.0;
    Part acc = 0;
    for (int b = 0; b < B; ++b) {
      const long long idx = (((r * F + f) * B + b) * N + nd) * K + k;
      Part s = 0;
      for (int p = 0; p < splits; ++p) s += partials[p * per_split + idx];
      acc += s;
      const float e = Er[b];
      float v;
      if constexpr (sizeof(Part) == 8) {
        v = __double2float_rn(__ll2double_rn(acc) * inv);
      } else {
        v = acc;
      }
      out[idx] = e != e ? 0.f : v;
    }
  }
}

template <typename Code, typename Acc>
cudaError_t launch_partial(dim3 grid, int smem, cudaStream_t st,
                           const void* codes, long long c_rstride, int c_row,
                           const void* cols, const void* node, const void* S,
                           const float* scale, void* dst, int n, int F,
                           int B, int b0, int N, int K, int R, int f_tile,
                           int n_tile, int n_tiles, int b_stride, int cap,
                           int rows_per_split, int bf16) {
  auto kern = hist_partial<Code, Acc>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const Code*>(codes), c_rstride, c_row,
      static_cast<const int*>(cols), static_cast<const int*>(node),
      static_cast<const float*>(S), scale,
      static_cast<typename AccOps<Acc>::Part*>(dst), n, F, B, b0, N, K, R,
      f_tile, n_tile, n_tiles, b_stride, cap, rows_per_split, bf16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// X: (n, F) shared (x_rstride = 0) or (R, n, F) (x_rstride = n * F);
// E: (F, B) shared (e_rstride = 0) or (R, F, B); codes: (R, n, F) of
// code_bytes 1 (uint8) or 2 (int16), R the larger replica count (at most
// 65,535); blocks: a replica's blocks.
int sbt_bin_codes(const void* X, long long x_rstride, const void* E,
                  long long e_rstride, void* codes, long long n, int F, int B,
                  int R, int code_bytes, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* Ef = static_cast<const float*>(E);
  // a replica's edges in shared memory where they fit the default 48 KB
  const long long e_bytes = 4LL * F * (B | 1);
  const int staged = e_bytes <= 48 * 1024;
  const int smem = staged ? static_cast<int>(e_bytes) : 0;
  const dim3 grid(blocks, R);
  if (code_bytes == 1) {
    bin_codes_kernel<uint8_t><<<grid, 256, smem, st>>>(
        Xf, x_rstride, Ef, e_rstride, static_cast<uint8_t*>(codes), n, F, B,
        staged);
  } else if (code_bytes == 2) {
    bin_codes_kernel<int16_t><<<grid, 256, smem, st>>>(
        Xf, x_rstride, Ef, e_rstride, static_cast<int16_t*>(codes), n, F, B,
        staged);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// codes: (n, c_row) shared (c_rstride = 0) or (R, n, c_row), code_bytes
// 1 or 2; cols: (R, F) int32 columns of codes, or null for the identity;
// E: the launch's (F, B) or (R, F, B) edges (e_rstride 0 or F * B), read
// by the finalize pass only; node: (R, n) int32; S: (R, n, K); out:
// (R, F, B, N, K); partials: (splits, R, F, B, N, K) float32, unused
// when splits == 1, or int64 in fixed point. b0: the launch's first bin
// in the codes' numbering. Geometry (f_tile, n_tile, f_tiles, n_tiles,
// b_stride, cap, splits, rows_per_split, smem) comes from the Python
// wrapper (ops/hist.py). scale and inv_scale null: the int32
// accumulator (S must hold integers); else (R,) float32 2**s_r and
// float64 2**-s_r of the int64 fixed-point accumulator.
int sbt_binned_left_stats(const void* codes, long long c_rstride, int c_row,
                          int code_bytes, const void* cols, const void* E,
                          long long e_rstride, const void* node,
                          const void* S, void* out, void* partials, int n,
                          int F, int B, int b0, int N, int K, int R,
                          int f_tile, int n_tile, int f_tiles, int n_tiles,
                          int b_stride, int cap, int splits,
                          int rows_per_split, int smem, int bf16,
                          const void* scale, const void* inv_scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fixed = scale != nullptr;
  if (fixed != (inv_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  void* dst = fixed || splits > 1 ? partials : out;
  const float* sc = static_cast<const float*>(scale);
  const dim3 grid(R, f_tiles * n_tiles, splits);
#define SBT_HIST_LAUNCH(CODE, ACC)                                          \
  launch_partial<CODE, ACC>(grid, smem, st, codes, c_rstride, c_row, cols, \
                            node, S, sc, dst, n, F, B, b0, N, K, R,        \
                            f_tile, n_tile, n_tiles, b_stride, cap,        \
                            rows_per_split, bf16)
  cudaError_t err;
  if (code_bytes == 1) {
    err = fixed ? SBT_HIST_LAUNCH(uint8_t, long long)
                : SBT_HIST_LAUNCH(uint8_t, int);
  } else if (code_bytes == 2) {
    err = fixed ? SBT_HIST_LAUNCH(int16_t, long long)
                : SBT_HIST_LAUNCH(int16_t, int);
  } else {
    err = cudaErrorInvalidValue;
  }
#undef SBT_HIST_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cols_out = (long long)R * F * N * K;
  const long long want = (cols_out + 255) / 256;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  const float* Ef = static_cast<const float*>(E);
  float* outf = static_cast<float*>(out);
  if (fixed) {
    hist_finalize<long long><<<blocks, 256, 0, st>>>(
        static_cast<const long long*>(dst), outf, Ef, e_rstride,
        static_cast<const double*>(inv_scale), R, F, B, N, K, splits);
  } else {
    hist_finalize<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(dst), outf, Ef, e_rstride, nullptr, R, F,
        B, N, K, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
