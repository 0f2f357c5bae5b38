// Binned left statistics on Hopper: one tree level's split-search table
//   out[r, f, b, n, k] = sum_i [X_r[i, f] <= E_r[f, b]] [node_r[i] == n] S_r[i, k]
//
// Replaces the TPU kernel spark_bagging_tpu/ops/hist.py `_hist_kernel`
// (reached through `binned_left_stats`, whose pl.pallas_call builds a
// (rows, F_t*B) 0/1 indicator block and a (rows, N*K) node-scattered
// statistics block in VMEM and multiplies them on the MXU).
//
// What bounds it on an H100: bytes. The function needs n*F*K adds, and
// reads X, node and S once and writes the (F, B, N, K) table once: at
// the headline tree level (n = 581,012, F = 43, N = 16, K = 7) ~119 MB
// per replica, ~36 us at 3.35 TB/s, against 0.17 G adds. The indicator
// product the TPU runs is 179 GFLOP per replica at N = 16; a histogram
// needs none of it. So the design does not multiply:
//   * each (row, feature) pair finds its bin once, the first b with
//     x <= edge[f, b] (a binary search over B staged edges: 5 compares
//     at B = 32), and adds the row's statistics into a shared-memory
//     histogram (f_tile, B, n_tile, K) at [f, bin, node, k]; a second
//     pass takes the cumulative sum over b, which is the indicator
//     form's table because the edges ascend. A NaN x finds no bin and
//     adds nothing, as its indicator row is all zero;
//   * rows are staged per tile with their node and statistics, and only
//     rows of the block's node tile with a nonzero statistic are kept
//     (a Poisson bootstrap leaves ~37% of rows at weight 0, and one-hot
//     class statistics have one nonzero of K), so each kept pair costs
//     one shared-memory atomic add for classification;
//   * a block owns (replica, feature tile x node tile, row split); row
//     splits write float32 partials that the second pass sums in split
//     order: no float atomics in global memory.
// Shared-memory atomics add in an order that changes from run to run.
// With integer statistics below 2**24 in every partial sum (Poisson
// counts times one-hot classes) every order gives the same bits; float
// statistics (regression moments) repeat to rounding only.
// bf16 != 0 rounds S to bfloat16 (round to nearest even) before it is
// added; sums stay float32. Tensor cores, TMA and reading X through each
// replica's subspace index instead of a gathered copy are left for a
// later revision.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns the first CUDA error of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The block size is decided in ops/hist.py (CUDA_DEFINES), which also
// computes the launch geometry from it; utils/native.py passes it here.
#if !defined(SBT_HIST_THREADS)
#error "build through spark_bagging_tpu_torch/utils/native.py (-D block size)"
#endif

namespace {

constexpr int kThreads = SBT_HIST_THREADS;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The first b in [0, B) with x <= e[b], or B when there is none (x is
// NaN or above every edge); e is non-decreasing.
__device__ __forceinline__ int bin_of(const float* e, int B, float x) {
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x <= e[mid]) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// grid (R, f_tiles * n_tiles, splits); block (r, tile, split) bins rows
// [split * rows_per_split, (split + 1) * rows_per_split) of replica r for
// features [f0, f0 + f_tile) and nodes [n0, n0 + n_tile) into its slot of
// dst, (splits, R, F, B, N, K), uncumulated.
__global__ void __launch_bounds__(kThreads)
hist_partial(const float* __restrict__ X, long long x_rstride,
             const float* __restrict__ E, long long e_rstride,
             const int* __restrict__ node, const float* __restrict__ S,
             float* __restrict__ dst, int n, int F, int B, int N, int K,
             int R, int f_tile, int n_tile, int n_tiles, int row_tile,
             int rows_per_split, int bf16) {
  extern __shared__ float smem[];
  const int hist_len = f_tile * B * n_tile * K;
  float* hist = smem;                        // [f_tile][B][n_tile][K]
  float* sedge = hist + hist_len;            // [f_tile][B]
  float* sS = sedge + f_tile * B;            // [row_tile][K] kept rows
  int* srow = reinterpret_cast<int*>(sS + row_tile * K);  // [row_tile]
  int* snode = srow + row_tile;              // [row_tile]
  int* s_count = snode + row_tile;           // kept rows of the tile

  const int r = blockIdx.x;
  const int f0 = (blockIdx.y / n_tiles) * f_tile;
  const int n0 = (blockIdx.y % n_tiles) * n_tile;
  const int split = blockIdx.z;
  const int nf = min(f_tile, F - f0);
  const int nn = min(n_tile, N - n0);
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);

  for (int e = threadIdx.x; e < hist_len; e += blockDim.x) hist[e] = 0.f;
  // NaN edges (a suffix; the finalize pass writes their entries as 0)
  // are staged as +inf so the binary search sees ascending edges
  const float* Er = E + r * e_rstride;
  for (int e = threadIdx.x; e < f_tile * B; e += blockDim.x) {
    const int f = e / B;
    float v = inf;
    if (f < nf) {
      v = Er[(long long)(f0 + f) * B + e % B];
      if (v != v) v = inf;
    }
    sedge[e] = v;
  }

  const float* Xr = X + r * x_rstride;
  const int* noder = node + (long long)r * n;
  const float* Sr = S + (long long)r * n * K;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);

  for (int t0 = row_begin; t0 < row_end; t0 += row_tile) {
    const int rows = min(row_tile, row_end - t0);
    if (threadIdx.x == 0) *s_count = 0;
    __syncthreads();
    // keep the tile's rows of this node tile with a nonzero statistic;
    // each warp claims its slots with one shared atomic
    for (int base = 0; base < row_tile; base += blockDim.x) {
      const int t = base + threadIdx.x;
      int nd = -1;
      bool keep = false;
      if (t < rows) {
        nd = noder[t0 + t] - n0;
        if (nd >= 0 && nd < nn) {
          const float* s = Sr + (long long)(t0 + t) * K;
          for (int k = 0; k < K; ++k) keep |= s[k] != 0.f;
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      int first = 0;
      if (lane == 0 && ballot != 0u) first = atomicAdd(s_count, __popc(ballot));
      first = __shfl_sync(0xffffffffu, first, 0);
      if (keep) {
        const int slot = first + __popc(ballot & ((1u << lane) - 1u));
        const float* s = Sr + (long long)(t0 + t) * K;
        srow[slot] = t0 + t;
        snode[slot] = nd;
        for (int k = 0; k < K; ++k)
          sS[slot * K + k] = bf16 ? round_bf16(s[k]) : s[k];
      }
    }
    __syncthreads();
    // one (kept row, feature) pair per thread: neighbouring threads read
    // neighbouring features of a row
    const int active = *s_count;
    for (int e = threadIdx.x; e < active * nf; e += blockDim.x) {
      const int a = e / nf;
      const int f = e - a * nf;
      const float x = Xr[(long long)srow[a] * F + f0 + f];
      const int b = bin_of(sedge + f * B, B, x);
      if (b < B) {
        float* h = hist + ((f * B + b) * n_tile + snode[a]) * K;
        const float* s = sS + a * K;
        for (int k = 0; k < K; ++k)
          if (s[k] != 0.f) atomicAdd(h + k, s[k]);
      }
    }
    __syncthreads();
  }
  __syncthreads();

  float* slot = dst + ((long long)split * R + r) * F * B * N * K;
  for (int e = threadIdx.x; e < hist_len; e += blockDim.x) {
    const int k = e % K;
    int q = e / K;
    const int nl = q % n_tile;
    q /= n_tile;
    const int b = q % B;
    const int f = q / B;
    if (f < nf && nl < nn)
      slot[(((long long)(f0 + f) * B + b) * N + n0 + nl) * K + k] = hist[e];
  }
}

// out[r, f, b, n, k] = sum over b' <= b of (sum over splits s, in order,
// of partials[s, r, f, b', n, k]); 0 where edge[f, b] is NaN, as the
// indicator [x <= NaN] is. One thread per (r, f, n, k) column; partials
// may be out itself (one split), each entry read before it is written.
__global__ void hist_finalize(const float* partials, float* out,
                              const float* __restrict__ E,
                              long long e_rstride, int R, int F, int B,
                              int N, int K, int splits) {
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
    float acc = 0.f;
    for (int b = 0; b < B; ++b) {
      const long long idx = (((r * F + f) * B + b) * N + nd) * K + k;
      float s = 0.f;
      for (int p = 0; p < splits; ++p) s += partials[p * per_split + idx];
      acc += s;
      const float e = Er[b];
      out[idx] = e != e ? 0.f : acc;
    }
  }
}

}  // namespace

extern "C" {

// X: (n, F) shared (x_rstride = 0) or (R, n, F) (x_rstride = n * F);
// E: (F, B) shared (e_rstride = 0) or (R, F, B); node: (R, n) int32;
// S: (R, n, K); out: (R, F, B, N, K); partials: (splits, R, F, B, N, K),
// unused when splits == 1. Geometry (f_tile, n_tile, f_tiles, n_tiles,
// row_tile, splits, rows_per_split, smem) comes from the Python wrapper
// (ops/hist.py).
int sbt_binned_left_stats(const void* X, long long x_rstride, const void* E,
                          long long e_rstride, const void* node,
                          const void* S, void* out, void* partials, int n,
                          int F, int B, int N, int K, int R, int f_tile,
                          int n_tile, int f_tiles, int n_tiles, int row_tile,
                          int splits, int rows_per_split, int smem, int bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* dst = static_cast<float*>(splits == 1 ? out : partials);
  const float* Ef = static_cast<const float*>(E);
  dim3 grid(R, f_tiles * n_tiles, splits);
  hist_partial<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(X), x_rstride, Ef, e_rstride,
      static_cast<const int*>(node), static_cast<const float*>(S), dst, n, F,
      B, N, K, R, f_tile, n_tile, n_tiles, row_tile, rows_per_split, bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cols = (long long)R * F * N * K;
  const long long want = (cols + 255) / 256;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  hist_finalize<<<blocks, 256, 0, st>>>(dst, static_cast<float*>(out), Ef,
                                        e_rstride, R, F, B, N, K, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
