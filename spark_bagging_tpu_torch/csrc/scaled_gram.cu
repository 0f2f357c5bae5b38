// Scaled Gram matrices on Hopper's tensor cores:
// out[r, p] = X_r^T diag(S[r, :, p]) X_r.
//
// Replaces the TPU kernel spark_bagging_tpu/ops/gram.py:53
// `_scaled_gram_kernel` (reached through `scaled_grams`, whose
// pl.pallas_call builds the (rows, P*d) scaled operand in VMEM and feeds
// the MXU). The products are the C(C+1)/2 upper-triangle blocks of the
// multinomial Newton Hessian (models/logistic.py, hessian_impl="pallas").
//
// What bounds it on an H100: operations. One replica-iteration at the
// headline shape (n = 581,012 rows, d = 55, P = 28) needs the i <= j half
// of each symmetric Gram, n*P*d*(d+1) ~ 5.0e10 flops, against 193 MB of
// input (X once, S once): ~260 flops per byte, above the tensor cores'
// balance point (~148 flop/B in TF32, ~295 in bf16). The design keeps
// the tensor cores fed and X out of device memory:
//   * warp-level mma.sync. op_dtype "float32" runs m16n8k8 TF32 as
//     3xTF32: each fp32 operand is split a = big + small (split_tf32)
//     and acc += small*big + big*small + big*big, small terms first;
//     a product is off by < 3 * 2^-20 of its size, so the result keeps
//     the fp32 error scale. (The split cuts rather than rounds with
//     cvt.rna.tf32, which costs more instructions: see split_tf32.)
//     "bfloat16" runs m16n8k16 with bf16 operands: x rounded to bf16,
//     and the fp32 product x*s rounded to bf16 (never bf16(x)*bf16(s)),
//     as the plain version does;
//   * rows i take x (operand A = X_tile^T) and columns j the scaled
//     operand (operand B = X_tile * s); only the 16x8 tiles that touch
//     the upper triangle are computed and the output is mirrored on the
//     way out, diagonal tiles taking their upper half;
//   * one staged X row tile serves many accumulators: a block stages
//     `kRowTile` rows of X (and the S values of its pairs) in shared
//     memory, and each of its warps owns one (replica, pair)'s output
//     tile in registers and scales its B fragments by its own s in
//     registers (x*s is never materialised per pair). With a shared X a
//     block's warps take consecutive (replica, pair) indices, so X is
//     read R*P/warps times from L2, not once per (replica, pair group);
//   * cp.async double buffering: the next row tile's loads run while
//     the tensor cores work on this one;
//   * an output-tile grid dimension: 64x64 tiles (I, J), I <= J; a
//     diagonal tile is one block item, an off-diagonal one two items of
//     32 rows each, so the registers of a warp hold at most 20 16x8
//     accumulator tiles and any d works;
//   * accumulation: the tensor cores' own fp32 accumulation does not
//     round to nearest (summed in the MMA accumulators alone, a block's
//     16,384 rows gave entry errors past the kernel's tolerance on an
//     H100), so each row tile is summed in MMA accumulators started
//     from zero and then added into separate fp32 registers (FADD,
//     round to nearest); a block sums at most
//     ops/gram.py MAX_SPLIT_ROWS rows, and row splits write fp32 partials
//     that a second kernel sums in split order: no float atomics, so two
//     runs give the same bits.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The tiling is decided in ops/gram.py (CUDA_DEFINES), which also
// computes the launch geometry from it; utils/native.py passes it here.
#if !defined(SBT_GRAM_WARPS) || !defined(SBT_GRAM_TILE) || \
    !defined(SBT_GRAM_ROW_TILE)
#error "build through spark_bagging_tpu_torch/utils/native.py (-D tiling)"
#endif

namespace {

// warps a block: each keeps one (replica, pair)'s output tile
constexpr int kWarps = SBT_GRAM_WARPS;
constexpr int kThreads = 32 * kWarps;
// output tile edge
constexpr int kTile = SBT_GRAM_TILE;
// rows of X a pipeline stage holds (also the promotion interval)
constexpr int kRowTile = SBT_GRAM_ROW_TILE;
static_assert(kTile == 64, "the warp tiling assumes 64x64 output tiles");
static_assert(kRowTile % 16 == 0, "a row tile is whole k16 steps");

// Shared-memory layout of one pipeline stage, in floats: the B side
// (kTile columns of X), the A side of an off-diagonal half tile
// (kTile / 2 columns; a diagonal tile reads A from the B side) and the
// S values of the block's warps, [warp][row]. Rows are padded so that
// the fragment loads hit 32 distinct banks: a TF32 fragment reads 4
// rows x 8 columns (row stride = 8 mod 32), a bf16 one pairs of rows
// (row stride = 4 mod 32).
template <bool BF16>
struct Layout {
  static constexpr int kPad = BF16 ? 4 : 8;
  static constexpr int kLdB = kTile + kPad;
  static constexpr int kLdA = kTile / 2 + kPad;
  static constexpr int kStage = kRowTile * (kLdB + kLdA) + kWarps * kRowTile;
  static constexpr size_t kSmemBytes = 2 * sizeof(float) * kStage;
};

struct GramArgs {
  const float* X;       // (n, d) shared or (R, n, d)
  long long x_rstride;  // 0 (shared) or n * d
  const float* S;       // (R, n, P)
  float* out;           // (splits, R, P, d, d)
  int n, d, P, R;
  int pg;               // (replica, pair)s a block, at most kWarps
  int groups;           // blocks along the pairs of one X
  int nt;               // 64-wide tiles along d
  int rows_per_split;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 4 bytes to shared memory asynchronously; writes 0 when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = big + small: big is v cut to TF32 (its top 19 bits), small the
// exact fp32 rest, which the tensor core reads cut to TF32 in turn. A
// rounded split (cvt.rna.tf32 of both parts) takes two conversions a
// value where the cut takes one AND, and the fp32 mode's time follows
// its instruction count; the cut leaves a product off by < 3 * 2^-20 of
// its size (toward zero), against fp32's 2^-24 rounding, well inside
// the error scale the kernel is held to. Values with at most 11
// significant bits (the exact probe's) split with small = 0 either way.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(v, __uint_as_float(big)));
}

// two floats rounded to bf16 (nearest even), lo in the low half: the
// element of the smaller k index, as the mma fragments order them
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments, with g = lane / 4 and q = lane % 4. A tile is staged
// [k][column] with row stride ld; A[m][k] = tile[k][m0 + m] (x) and
// B[k][n] = tile[k][n0 + n] * s[k] (the scaled operand).
//
// m16n8k8 TF32: a0 (m g, k q), a1 (m g+8, k q), a2 (m g, k q+4),
// a3 (m g+8, k q+4); b0 (k q, n g), b1 (k q+4, n g).
__device__ __forceinline__ void load_a_tf32(const float* t, int ld, int k0,
                                            int m0, int g, int q,
                                            uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
  const float* r0 = t + (k0 + q) * ld + m0 + g;
  const float* r4 = r0 + 4 * ld;
  split_tf32(r0[0], big[0], small[0]);
  split_tf32(r0[8], big[1], small[1]);
  split_tf32(r4[0], big[2], small[2]);
  split_tf32(r4[8], big[3], small[3]);
}

__device__ __forceinline__ void load_b_tf32(const float* t, int ld, int k0,
                                            int n0, int g, int q, float s0,
                                            float s4, uint32_t (&big)[2],
                                            uint32_t (&small)[2]) {
  const float* r0 = t + (k0 + q) * ld + n0 + g;
  split_tf32(__fmul_rn(r0[0], s0), big[0], small[0]);
  split_tf32(__fmul_rn(r0[4 * ld], s4), big[1], small[1]);
}

// m16n8k16 bf16 (two k per register, low half first): a0 (m g,
// k 2q..2q+1), a1 (m g+8, k 2q..), a2 (m g, k 2q+8..), a3 (m g+8,
// k 2q+8..); b0 (k 2q..2q+1, n g), b1 (k 2q+8..2q+9, n g).
__device__ __forceinline__ void load_a_bf16(const float* t, int ld, int k0,
                                            int m0, int g, int q,
                                            uint32_t (&a)[4]) {
  const float* r0 = t + (k0 + 2 * q) * ld + m0 + g;
  const float* r8 = r0 + 8 * ld;
  a[0] = pack_bf16(r0[0], r0[ld]);
  a[1] = pack_bf16(r0[8], r0[ld + 8]);
  a[2] = pack_bf16(r8[0], r8[ld]);
  a[3] = pack_bf16(r8[8], r8[ld + 8]);
}

__device__ __forceinline__ void load_b_bf16(const float* t, int ld, int k0,
                                            int n0, int g, int q,
                                            const float (&s)[4],
                                            uint32_t (&b)[2]) {
  const float* r0 = t + (k0 + 2 * q) * ld + n0 + g;
  const float* r8 = r0 + 8 * ld;
  b[0] = pack_bf16(__fmul_rn(r0[0], s[0]), __fmul_rn(r0[ld], s[1]));
  b[1] = pack_bf16(__fmul_rn(r8[0], s[2]), __fmul_rn(r8[ld], s[3]));
}

// Which 16x8 accumulator tiles a warp keeps: MI row blocks of 16 x 8
// column blocks of 8; on a diagonal tile only those touching i <= j.
template <bool DIAG>
__device__ __forceinline__ constexpr bool kept(int mi, int nj) {
  return !DIAG || nj >= 2 * mi;
}

// One k step (8 rows in TF32, 16 in bf16) of a warp's output tile:
// c += A^T B over the step, B the x tile scaled by the warp's s (sS),
// for the kept tiles inside d (mi < mi_n, nj < nj_n).
template <bool BF16, int MI, bool DIAG, int LDA, int LDB>
__device__ __forceinline__ void mma_step(float (&c)[MI][8][4],
                                         const float* sA, const float* sB,
                                         const float* sS, int k0, int mi_n,
                                         int nj_n, int g, int q) {
  if constexpr (BF16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) load_a_bf16(sA, LDA, k0, 16 * mi, g, q, a[mi]);
    const float* sk = sS + k0 + 2 * q;
    const float s[4] = {sk[0], sk[1], sk[8], sk[9]};
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      if (nj >= nj_n) break;
      uint32_t b[2];
      load_b_bf16(sB, LDB, k0, 8 * nj, g, q, s, b);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        if (kept<DIAG>(mi, nj) && mi < mi_n) mma_bf16(c[mi][nj], a[mi], b);
    }
  } else {
    uint32_t ab[MI][4], as[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      load_a_tf32(sA, LDA, k0, 16 * mi, g, q, ab[mi], as[mi]);
    const float s0 = sS[k0 + q], s4 = sS[k0 + q + 4];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      if (nj >= nj_n) break;
      uint32_t bb[2], bs[2];
      load_b_tf32(sB, LDB, k0, 8 * nj, g, q, s0, s4, bb, bs);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        if (!(kept<DIAG>(mi, nj) && mi < mi_n)) continue;
        mma_tf32(c[mi][nj], as[mi], bb);  // small terms first
        mma_tf32(c[mi][nj], ab[mi], bs);
        mma_tf32(c[mi][nj], ab[mi], bb);
      }
    }
  }
}

// The accumulator element e of a 16x8 tile: (row g + 8*(e/2),
// column 2q + e%2).
__device__ __forceinline__ int frag_row(int e, int g) { return g + 8 * (e >> 1); }
__device__ __forceinline__ int frag_col(int e, int q) { return 2 * q + (e & 1); }

template <int MI>
__device__ __forceinline__ void zero(float (&c)[MI][8][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mi][nj][e] = 0.f;
}

// Block (group, item, split). Item < nt is the diagonal tile
// (item, item): rows and columns [64 item, 64 item + 64), four row
// blocks. Item nt + 2u + h is half h of the u-th off-diagonal tile
// (I, J), I < J in row-major order: rows [64 I + 32 h, +32), columns
// [64 J, +64), two row blocks. Group gx of X index xi = gx / groups
// takes the flattened (replica, pair)s xi*Q + [qb, qb + pg), Q = R*P
// for a shared X, P for one X per replica; warp w takes the w-th.
template <bool BF16, bool DIAG>
__device__ __forceinline__ void gram_block(const GramArgs& a, float* smem) {
  using L = Layout<BF16>;
  constexpr int MI = DIAG ? 4 : 2;
  constexpr int KSTEP = BF16 ? 16 : 8;
  constexpr int LDA = DIAG ? L::kLdB : L::kLdA;
  constexpr int ACOLS = kTile / 2;
  constexpr int NT = kThreads;
  constexpr int BR = NT / kTile, AR = NT / ACOLS, SR = NT / kWarps;
  static_assert(NT % kTile == 0 && NT % kWarps == 0, "staging passes");
  static_assert(kRowTile % BR == 0 && kRowTile % AR == 0 &&
                kRowTile % SR == 0, "staging passes");

  int row0, col0;
  if (DIAG) {
    row0 = col0 = kTile * static_cast<int>(blockIdx.y);
  } else {
    int u = (static_cast<int>(blockIdx.y) - a.nt) >> 1;
    const int h = (static_cast<int>(blockIdx.y) - a.nt) & 1;
    int I = 0;
    while (u >= a.nt - 1 - I) {
      u -= a.nt - 1 - I;
      ++I;
    }
    row0 = kTile * I + ACOLS * h;
    col0 = kTile * (I + 1 + u);
  }
  const int mi_n = min(MI, (a.d - row0 + 15) / 16);
  const int nj_n = min(8, (a.d - col0 + 7) / 8);

  const bool shared_x = a.x_rstride == 0;
  const int Q = shared_x ? a.R * a.P : a.P;
  const int xi = blockIdx.x / a.groups;
  const int qb = (blockIdx.x % a.groups) * a.pg;
  const int nq = min(a.pg, Q - qb);
  const long long q0 = (long long)xi * Q + qb;
  const float* Xb = a.X + xi * a.x_rstride;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool active = warp < nq;

  const int row_begin = blockIdx.z * a.rows_per_split;
  const int row_end = min(a.n, row_begin + a.rows_per_split);
  const int n_stages = (row_end - row_begin + kRowTile - 1) / kRowTile;

  // Each thread copies the same columns (and S slot) at every stage:
  // its sources are computed once.
  const int bc = tid % kTile, bt = tid / kTile;
  const bool b_ok = col0 + bc < a.d;
  const float* b_src = Xb + (long long)(row_begin + bt) * a.d + col0 + bc;
  const int ac = tid % ACOLS, at = tid / ACOLS;
  const bool a_ok = row0 + ac < a.d;
  const float* a_src = Xb + (long long)(row_begin + at) * a.d + row0 + ac;
  // consecutive threads take consecutive (replica, pair)s of one row:
  // with one replica's P pairs contiguous, the loads coalesce
  const int slot = tid % kWarps, s_t = tid / kWarps;
  const bool s_ok = slot < nq;
  const float* s_src = a.S;
  if (s_ok) {
    const long long qw = q0 + slot;
    const long long r = qw / a.P;
    s_src = a.S + (r * a.n + row_begin + s_t) * a.P + (qw - r * a.P);
  }

  auto stage = [&](int buf, int st) {
    float* sB = smem + buf * L::kStage;
    float* sA = sB + kRowTile * L::kLdB;
    float* sS = sA + kRowTile * L::kLdA;
    const int t0 = st * kRowTile;
    const int rows = row_end - row_begin - t0;  // rows left, > 0
#pragma unroll
    for (int i = 0; i < kRowTile / BR; ++i) {
      const int t = bt + BR * i;
      const bool ok = b_ok && t < rows;
      cp_async4(sB + t * L::kLdB + bc,
                ok ? b_src + (long long)(t0 + BR * i) * a.d : Xb, ok);
    }
    if (!DIAG) {
#pragma unroll
      for (int i = 0; i < kRowTile / AR; ++i) {
        const int t = at + AR * i;
        const bool ok = a_ok && t < rows;
        cp_async4(sA + t * L::kLdA + ac,
                  ok ? a_src + (long long)(t0 + AR * i) * a.d : Xb, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowTile / SR; ++i) {
      const int t = s_t + SR * i;
      const bool ok = s_ok && t < rows;
      cp_async4(sS + slot * kRowTile + t,
                ok ? s_src + (long long)(t0 + SR * i) * a.P : a.S, ok);
    }
  };

  float acc[MI][8][4];
  zero(acc);

  if (n_stages > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      stage((st + 1) & 1, st + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* sB = smem + (st & 1) * L::kStage;
      const float* sA = DIAG ? sB : sB + kRowTile * L::kLdB;
      const float* sS =
          sB + kRowTile * (L::kLdB + L::kLdA) + warp * kRowTile;
      // the row tile's sum in MMA accumulators from zero, then promoted
      // into the round-to-nearest registers
      float part[MI][8][4];
      zero(part);
#pragma unroll 1
      for (int k0 = 0; k0 < kRowTile; k0 += KSTEP)
        mma_step<BF16, MI, DIAG, LDA, L::kLdB>(part, sA, sB, sS, k0, mi_n,
                                               nj_n, g, q);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
          if (kept<DIAG>(mi, nj))
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mi][nj][e] = __fadd_rn(acc[mi][nj][e], part[mi][nj][e]);
    }
    __syncthreads();
  }

  if (!active) return;
  const long long qw = q0 + warp;
  const long long r = qw / a.P;
  const long long p = qw - r * a.P;
  float* o = a.out + ((blockIdx.z * (long long)a.R + r) * a.P + p) *
                         (long long)a.d * a.d;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      if (!kept<DIAG>(mi, nj)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 16 * mi + frag_row(e, g), jl = 8 * nj + frag_col(e, q);
        const int i = row0 + il, j = col0 + jl;
        // diagonal tiles: take the upper half so both mirrors are equal
        if (i >= a.d || j >= a.d || (DIAG && il > jl)) continue;
        const float v = acc[mi][nj][e];
        o[(long long)i * a.d + j] = v;
        o[(long long)j * a.d + i] = v;
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
scaled_gram_mma(GramArgs a) {
  extern __shared__ float smem[];
  if (static_cast<int>(blockIdx.y) < a.nt)
    gram_block<BF16, true>(a, smem);
  else
    gram_block<BF16, false>(a, smem);
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

// One warp, one 16x8 accumulator tile, one k step, through the Gram
// kernel's own staging layout, fragment loads and mma: out[m][n] =
// sum_k xa[k][m] * (xb[k][n] * s[k]), xa (K, 16), xb (K, 8), K = 8
// (TF32) or 16 (bf16). For the card tests of the fragment layouts.
template <bool BF16>
__global__ void mma_probe(const float* __restrict__ xa,
                          const float* __restrict__ xb,
                          const float* __restrict__ s,
                          float* __restrict__ out) {
  constexpr int K = BF16 ? 16 : 8;
  constexpr int LD = Layout<BF16>::kLdB;
  __shared__ float sa[K * LD], sb[K * LD], ss[K];
  const int lane = threadIdx.x;
  for (int e = lane; e < K * LD; e += 32) sa[e] = sb[e] = 0.f;
  __syncwarp();
  for (int e = lane; e < K * 16; e += 32) sa[(e / 16) * LD + e % 16] = xa[e];
  for (int e = lane; e < K * 8; e += 32) sb[(e / 8) * LD + e % 8] = xb[e];
  if (lane < K) ss[lane] = s[lane];
  __syncwarp();
  float c[1][8][4] = {};
  mma_step<BF16, 1, false, LD, LD>(c, sa, sb, ss, 0, 1, 1, lane >> 2,
                                   lane & 3);
  for (int e = 0; e < 4; ++e)
    out[frag_row(e, lane >> 2) * 8 + frag_col(e, lane & 3)] = c[0][0][e];
}

template <bool BF16>
cudaError_t launch_gram(const GramArgs& a, int n_x, int splits,
                        cudaStream_t st) {
  const size_t smem = Layout<BF16>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      scaled_gram_mma<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(n_x * a.groups, a.nt * a.nt, splits);
  scaled_gram_mma<BF16><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// X: (n, d) shared (x_rstride = 0) or (R, n, d) (x_rstride = n * d);
// S: (R, n, P); out: (R, P, d, d); partials: (splits, R, P, d, d), unused
// when splits == 1. Geometry (n_x X matrices, pg pairs a block, groups
// of blocks along one X's pairs, nt output tiles along d, splits,
// rows_per_split) comes from the Python wrapper (ops/gram.py).
int sbt_scaled_gram(const void* X, long long x_rstride, const void* S,
                    void* out, void* partials, int n, int d, int P, int R,
                    int n_x, int pg, int groups, int nt, int splits,
                    int rows_per_split, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits == 1 ? out : partials);
  const GramArgs a{static_cast<const float*>(X), x_rstride,
                   static_cast<const float*>(S), dst, n, d, P, R, pg, groups,
                   nt, rows_per_split};
  cudaError_t err = bf16 ? launch_gram<true>(a, n_x, splits, st)
                         : launch_gram<false>(a, n_x, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = (long long)R * P * d * d;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials<<<blocks, 256, 0, st>>>(static_cast<const float*>(partials),
                                       static_cast<float*>(out), total, splits);
  return static_cast<int>(cudaGetLastError());
}

// xa (K, 16), xb (K, 8), s (K,) -> out (16, 8); K = 16 if bf16 else 8.
int sbt_gram_mma_probe(const void* xa, const void* xb, const void* s,
                       void* out, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(xa);
  const float* b = static_cast<const float*>(xb);
  const float* sv = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  if (bf16)
    mma_probe<true><<<1, 32, 0, st>>>(a, b, sv, o);
  else
    mma_probe<false><<<1, 32, 0, st>>>(a, b, sv, o);
  return static_cast<int>(cudaGetLastError());
}

const char* sbt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
