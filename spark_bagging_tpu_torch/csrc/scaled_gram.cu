// Scaled Gram matrices on Hopper: out[r, p] = X_r^T diag(S[r, :, p]) X_r.
//
// Replaces the TPU kernel spark_bagging_tpu/ops/gram.py
// `_scaled_gram_kernel` (reached through `scaled_grams`, whose
// pl.pallas_call builds the (rows, P*d) scaled operand in VMEM and feeds
// the MXU). The products are the C(C+1)/2 upper-triangle blocks of the
// multinomial Newton Hessian (models/logistic.py, hessian_impl="pallas").
//
// What bounds it on an H100: operations. One replica-iteration at the
// headline shape (n = 581,012 rows, d = 55, P = 28) needs the i <= j half
// of each symmetric Gram, n*P*d*(d+1) ~ 5.0e10 flops, against 193 MB of
// input (X once, S once): ~260 flops per byte, far above the card's ~20
// (fp32) or ~295 (bf16 tensor core) balance points. So the design keeps
// operands on chip and spends its shared memory traffic on register
// reuse:
//   * a block owns (replica r, a group of pairs, a split of the rows);
//     it stages `row_tile` rows of X and of the scaled operand x*s for
//     its pairs in shared memory, once per row tile;
//   * each thread accumulates up to four 4x4 output tiles in fp32
//     registers, 16 FMAs per pair of float4 loads; only the upper
//     triangle (i <= j) of 4x4 tiles is computed (the Grams are
//     symmetric) and it is mirrored on the way out:
//     out[p][i][j] = out[p][j][i] = sum_n x_i * (x_j s_p);
//   * neighbouring threads share a pair and a row block of the tile, so
//     one of the two shared-memory loads of a warp is a broadcast;
//   * a block sums at most ops/gram.py MAX_SPLIT_ROWS rows, which bounds
//     the fp32 accumulation depth; row splits write fp32 partials that a
//     second kernel sums in split order: no float atomics, so two runs
//     give the same bits.
// Operand modes: bf16 != 0 rounds x and x*s to bfloat16 (round to
// nearest even) before the multiply; products and sums stay fp32, as
// the TPU kernel's bf16 operands with fp32 accumulation. wgmma, TMA and
// staging one X tile for many replicas are left for a later revision.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The tiling is decided in ops/gram.py (CUDA_DEFINES), which also
// computes the launch geometry from it; utils/native.py passes it here.
#if !defined(SBT_GRAM_TILES_PER_THREAD) || !defined(SBT_GRAM_MAX_THREADS)
#error "build through spark_bagging_tpu_torch/utils/native.py (-D tiling)"
#endif

namespace {

constexpr int kTilesPerThread = SBT_GRAM_TILES_PER_THREAD;
constexpr int kMaxThreads = SBT_GRAM_MAX_THREADS;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// grid (R, groups, splits); block (r, g, split) sums rows
// [split * rows_per_split, (split + 1) * rows_per_split) of replica r for
// pairs [g * pg, g * pg + pg) into its slot of `out`:
// out[((split * R) + r) * P * d * d + p * d * d + i * d + j].
__global__ void __launch_bounds__(kMaxThreads)
scaled_gram_partial(const float* __restrict__ X, long long x_rstride,
                    const float* __restrict__ S, float* __restrict__ out,
                    int n, int d, int P, int R, int d_pad, int pg,
                    int rows_per_split, int row_tile, int bf16) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);   // [row_tile][d_pad]
  float* sxs = sx + row_tile * d_pad;             // [row_tile][pg][d_pad]

  // replicas vary fastest: the blocks in flight read the same rows of
  // a shared X, which then stays in L2
  const int r = blockIdx.x;
  const int p0 = blockIdx.y * pg;
  const int split = blockIdx.z;
  const int npg = min(pg, P - p0);
  const int nb = d_pad / 4;
  const int tpp = nb * (nb + 1) / 2;  // upper-triangle 4x4 tiles per pair
  const int n_tiles = npg * tpp;

  // This thread's tiles: (pair in group, row block, column block).
  // Tiles past n_tiles compute on tile 0 and are not written.
  int tp[kTilesPerThread], ti[kTilesPerThread], tj[kTilesPerThread];
#pragma unroll
  for (int k = 0; k < kTilesPerThread; ++k) {
    int tile = threadIdx.x + k * blockDim.x;
    if (tile >= n_tiles) tile = 0;
    tp[k] = tile / tpp;
    int rem = tile % tpp;
    int bi = 0;
    while (rem >= nb - bi) {
      rem -= nb - bi;
      ++bi;
    }
    ti[k] = bi;
    tj[k] = bi + rem;
  }

  float acc[kTilesPerThread][16];
#pragma unroll
  for (int k = 0; k < kTilesPerThread; ++k)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[k][e] = 0.f;

  const float* Xr = X + (long long)r * x_rstride;
  const float* Sr = S + (long long)r * n * P;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int stage_x = row_tile * d_pad;
  const int stage_xs = row_tile * pg * d_pad;

  for (int t0 = row_begin; t0 < row_end; t0 += row_tile) {
    const int rows = min(row_tile, row_end - t0);
    for (int e = threadIdx.x; e < stage_x; e += blockDim.x) {
      const int t = e / d_pad, i = e % d_pad;
      float v = 0.f;
      if (t < rows && i < d) {
        v = Xr[(long long)(t0 + t) * d + i];
        if (bf16) v = round_bf16(v);
      }
      sx[e] = v;
    }
    for (int e = threadIdx.x; e < stage_xs; e += blockDim.x) {
      const int t = e / (pg * d_pad);
      const int rem = e % (pg * d_pad);
      const int pl = rem / d_pad, i = rem % d_pad;
      float v = 0.f;
      if (t < rows && i < d && pl < npg) {
        v = Xr[(long long)(t0 + t) * d + i] *
            Sr[(long long)(t0 + t) * P + p0 + pl];
        if (bf16) v = round_bf16(v);
      }
      sxs[e] = v;
    }
    __syncthreads();
    for (int t = 0; t < rows; ++t) {
      const float* xrow = sx + t * d_pad;
      const float* xsrow = sxs + t * pg * d_pad;
#pragma unroll
      for (int k = 0; k < kTilesPerThread; ++k) {
        // rows i take x, columns j the scaled operand x*s, as the TPU
        // kernel's dot(x, rhs); which side is scaled matters in bf16
        const float4 a = *reinterpret_cast<const float4*>(xrow + 4 * ti[k]);
        const float4 b =
            *reinterpret_cast<const float4*>(xsrow + tp[k] * d_pad + 4 * tj[k]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[k][ii * 4 + jj] = fmaf(av[ii], bv[jj], acc[k][ii * 4 + jj]);
      }
    }
    __syncthreads();
  }

  float* slot = out + ((long long)split * R + r) * P * d * d;
#pragma unroll
  for (int k = 0; k < kTilesPerThread; ++k) {
    if (threadIdx.x + k * blockDim.x >= n_tiles) continue;
    float* g = slot + (long long)(p0 + tp[k]) * d * d;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = 4 * ti[k] + ii, j = 4 * tj[k] + jj;
        // diagonal tiles: take the upper half so both mirrors are equal
        if (i >= d || j >= d || (ti[k] == tj[k] && ii > jj)) continue;
        const float v = acc[k][ii * 4 + jj];
        g[i * d + j] = v;
        g[j * d + i] = v;
      }
    }
  }
}

// out[idx] = sum over s of partials[s * total + idx], in split order.
__global__ void sum_partials(const float* __restrict__ partials,
                             float* __restrict__ out, long long total,
                             int splits) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partials[(long long)k * total + idx];
    out[idx] = s;
  }
}

}  // namespace

extern "C" {

// X: (n, d) shared (x_rstride = 0) or (R, n, d) (x_rstride = n * d);
// S: (R, n, P); out: (R, P, d, d); partials: (splits, R, P, d, d), unused
// when splits == 1. Geometry (d_pad, pg, groups, splits, rows_per_split,
// row_tile, threads) comes from the Python wrapper (ops/gram.py).
int sbt_scaled_gram(const void* X, long long x_rstride, const void* S,
                    void* out, void* partials, int n, int d, int P, int R,
                    int d_pad, int pg, int groups, int splits,
                    int rows_per_split, int row_tile, int threads, int bf16,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)row_tile * (pg + 1) * d_pad;
  float* dst = static_cast<float*>(splits == 1 ? out : partials);
  dim3 grid(R, groups, splits);
  scaled_gram_partial<<<grid, threads, smem, st>>>(
      static_cast<const float*>(X), x_rstride, static_cast<const float*>(S),
      dst, n, d, P, R, d_pad, pg, rows_per_split, row_tile, bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = (long long)R * P * d * d;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials<<<blocks, 256, 0, st>>>(static_cast<const float*>(partials),
                                       static_cast<float*>(out), total, splits);
  return static_cast<int>(cudaGetLastError());
}

const char* sbt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
