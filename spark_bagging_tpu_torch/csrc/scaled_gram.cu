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
// balance point (~148 flop/B in TF32, ~295 in bf16).
//
// op_dtype "float32" (every Hessian of a fit at precision "highest") is
// the warpgroup design, scaled_gram_mma_wgmma:
//   * 3xTF32 on wgmma. The scaled operand a = x_i * s (the fp32 product)
//     is split a = big + small in registers: big is a cut to TF32's top
//     19 bits, small the exact fp32 rest, which the tensor core reads cut
//     in turn. X needs no split of its big half: the tensor core reads an
//     fp32 value's bits cut to TF32, so X itself is big, and x - cut(x)
//     is its small. A k step is small*big + big*small + big*big, small
//     terms first; a product is off by < 3 * 2^-20 of its size, so the
//     result keeps the fp32 error scale;
//   * scaled_gram_mma_prep writes, once a launch, every 64-row tile of X
//     (and of its remainder) in the K-major layout wgmma reads B from:
//     16 bytes hold 4 rows of one feature, 8 features x 4 rows make a
//     core matrix (no swizzle), and one 8-feature group of a tile is 2 KB
//     contiguous, so a window of groups is one copy;
//   * a block is two consumer warpgroups and a producer warpgroup, one
//     warp of which works (setmaxnreg: 232 and 40 registers). The
//     producer stages each row tile's windows by TMA bulk copies
//     (cp.async.bulk, completing on the stage's "full" mbarrier) and the
//     block's S values by cp.async, into a ring of kStages stages that
//     the consumers release on an "empty" mbarrier;
//   * each consumer warp owns one (replica, pair). The four warps of a
//     warpgroup take the same 16-feature band of rows i of four
//     (replica, pairs)s: the wgmma's 64 rows are 4 x 16, and its B, the
//     staged x_j, serves all four. A warp builds its A fragments (x_i * s,
//     split) in registers from the staged X and its own s: x*s is never
//     written to memory. The A registers of two k steps alternate, so one
//     step's products run while the next step's operands are built;
//   * only the upper triangle's bands are multiplied: a band's wgmma
//     takes the columns j from its first row on, N = 8 x groups (at
//     d = 55: N = 56, 40, 24, 8, and 75% of the products issued are
//     needed, against ~60% for 16x8 tiles inside a 64x64 tile). Any d:
//     the output is cut into 64x64 tiles I <= J, and a block item is a
//     set of bands of one tile whose accumulators fit the registers
//     (SBT_GRAM_SHAPES and decode_item, the one statement of the bands;
//     sbt_gram_items gives ops/gram.py their count);
//   * accumulation: the tensor cores' own fp32 accumulation does not
//     round to nearest (summed in the MMA accumulators alone, a block's
//     16,384 rows gave entry errors past the kernel's tolerance on an
//     H100), so each 64-row tile is summed in wgmma accumulators from
//     zero and then added into fp32 registers rounding to nearest; a
//     block sums at most ops/gram.py MAX_SPLIT_ROWS rows, and row splits
//     write fp32 partials that sum_partials adds in split order: no float
//     atomics, so two runs give the same bits.
//
// op_dtype "bfloat16" is the warp-level design, scaled_gram_mma_sync:
// mma.sync m16n8k16 with x rounded to bf16 against the fp32 product x*s
// rounded to bf16 (never bf16(x)*bf16(s)), rows i taking x and columns j
// the scaled operand, as the plain version does (in bf16 the side that
// carries the scale is part of the function, and the wgmma design's
// shared B cannot carry it). Each warp keeps one (replica, pair)'s 64x64
// output tile, or a 32-row half of one above the diagonal, in registers;
// X row tiles are staged by cp.async double buffering; the same
// promotion and row splits.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The tiling is decided in ops/gram.py (CUDA_DEFINES), which also
// computes the launch geometry from it; utils/native.py passes it here.
#if !defined(SBT_GRAM_ROW_TILE) || !defined(SBT_GRAM_STAGES) || \
    !defined(SBT_GRAM_CONSUMERS) || !defined(SBT_GRAM_WARPS) ||  \
    !defined(SBT_GRAM_TILE)
#error "build through spark_bagging_tpu_torch/utils/native.py (-D tiling)"
#endif

namespace {

// rows of X a stage holds, and the promotion interval (both designs)
constexpr int kRowTile = SBT_GRAM_ROW_TILE;
// output tile edge (both designs)
constexpr int kTile = SBT_GRAM_TILE;
static_assert(kTile == 64, "the tilings assume 64x64 output tiles");
static_assert(kRowTile == 64, "a row tile is 8 k8 steps or 4 k16 steps");

struct GramArgs {
  const float* X;       // (n, d) shared or (R, n, d)
  long long x_rstride;  // 0 (shared) or n * d
  const float* S;       // (R, n, P)
  float* out;           // (splits, R, P, d, d)
  const float* img;     // float32: X's images, (2, n_x, tiles, g8, 512)
  long long img_half;   // floats of one image (X; then its remainder)
  int n, d, P, R;
  int pg;               // (replica, pair)s a block
  int groups;           // blocks along the pairs of one X
  int rows_per_split;
  int tiles;            // 64-row tiles of X
  int g8;               // 8-feature groups of X
};

// The block's (replica, pair)s: group gx of X index xi = gx / groups
// takes the flattened (replica, pair)s xi*Q + [qb, qb + nq), Q = R*P for
// a shared X, P for one X per replica.
struct Pairs {
  int xi, nq;
  long long q0;
};

__device__ __forceinline__ Pairs block_pairs(const GramArgs& a) {
  const int Q = a.x_rstride == 0 ? a.R * a.P : a.P;
  Pairs b;
  b.xi = blockIdx.x / a.groups;
  const int qb = (blockIdx.x % a.groups) * a.pg;
  b.nq = min(a.pg, Q - qb);
  b.q0 = (long long)b.xi * Q + qb;
  return b;
}

// the output matrix of (replica, pair) qw in row split z
__device__ __forceinline__ float* out_matrix(const GramArgs& a,
                                             long long qw) {
  const long long r = qw / a.P;
  const long long p = qw - r * a.P;
  return a.out + ((blockIdx.z * (long long)a.R + r) * a.P + p) *
                     (long long)a.d * a.d;
}

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

// v cut to TF32 (its top 19 bits), as the tensor core reads an fp32 value
__device__ __forceinline__ uint32_t cut_tf32(float v) {
  return __float_as_uint(v) & 0xffffe000u;
}

// ---------------------------------------------------------------------
// float32: warpgroup wgmma, 3xTF32

// consumer warpgroups a block
constexpr int kConsumers = SBT_GRAM_CONSUMERS;
// (replica, pair)s a block: one a consumer warp
constexpr int kPairs = 4 * kConsumers;
// the consumer warpgroups and the producer's (one warp of it works:
// setmaxnreg moves registers between whole warpgroups)
constexpr int kWgThreads = 128 * (kConsumers + 1);
// the producer's ring of row tiles
constexpr int kStages = SBT_GRAM_STAGES;
constexpr int kKSteps = kRowTile / 8;
// One 8-feature group of a row tile's image, in floats: [k step][4-row
// half][feature][4 rows]
constexpr int kGroup = 8 * kRowTile;
constexpr int kGroupBytes = 4 * kGroup;
// A stage, in bytes: the raw window (<= 8 groups of X: the B columns,
// and a diagonal item's rows), the remainder window (the same groups of
// x - cut(x)), the A window (4 groups of tile I: an off-diagonal item's
// rows) and the S values, [pair][row], rows padded so that the
// producer's writes spread over the banks.
constexpr int kSLd = kRowTile + 4;
constexpr int kRawOff = 0;
constexpr int kRemOff = 8 * kGroupBytes;
constexpr int kAOff = 16 * kGroupBytes;
constexpr int kSOff = 20 * kGroupBytes;
constexpr int kStageBytes = kSOff + 4 * kPairs * kSLd;
// the stages' full barriers, then their empty barriers
constexpr int kBarOff = kStages * kStageBytes;
constexpr int kWgSmemBytes = kBarOff + 2 * kStages * 8;
// registers a thread: launched at 65536 / kWgThreads (168), the
// producer's warpgroup gives back what the consumers take
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kStageBytes % 128 == 0, "stages keep 128-byte alignment");
static_assert(kWgSmemBytes <= 232448, "a block's shared memory");
static_assert(kConsumerRegs * 128 * kConsumers + kProducerRegs * 128 <= 65536,
              "the SM's registers");
// a full barrier's arrivals: the producer's expect_tx and its 32 lanes'
// cp.async of the S values
constexpr int kFullArrivals = 33;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// TMA: bytes contiguous bytes into shared memory, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// an arrival on bar once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of r across the
// asynchronous products
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// The no-swizzle K-major descriptor of a B window: its start address,
// LBO (a k step's two 4-row halves, 128 bytes apart) and SBO (the next 8
// features, a group of 2 KB further), in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32);
}

// d (+)= a @ B, m64n(8W)k8 TF32 (acc = 0: d = a @ B): A from registers
// (a0 (row g, k q), a1 (row g+8, k q), a2 (row g, k q+4), a3 (row g+8,
// k q+4) of the warp's 16 rows), B by descriptor; d[4j + e] is (row
// g + 8 (e / 2), column 8j + 2q + e % 2).
template <int W>
struct Wgmma;

template <>
struct Wgmma<1> {
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3},"
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wgmma<2> {
  __device__ __forceinline__ static void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wgmma<3> {
  __device__ __forceinline__ static void run(float (&d)[12],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11},"
        "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wgmma<4> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15},"
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wgmma<5> {
  __device__ __forceinline__ static void run(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19},"
        "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wgmma<6> {
  __device__ __forceinline__ static void run(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23},"
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wgmma<7> {
  __device__ __forceinline__ static void run(float (&d)[28],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27},"
        "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Wgmma<8> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, uint32_t acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31},"
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <int K>
struct Ic {
  static constexpr int value = K;
};

// The item shapes: an item's bands' widths W0..W3 in 8-feature groups
// of columns (0: no band), and whether the item lies off the diagonal.
// A diagonal item's windows start at its widest band's first group, and
// band k's rows and columns start W0 - Wk groups in. An off-diagonal
// item's bands are two row bands of tile I (its A window's groups 0-1
// and 2-3) against all of tile J's columns (its raw window).
template <int W0, int W1, int W2, int W3, bool OFF>
struct Shape {
  static constexpr bool kOff = OFF;
  template <int K>
  __host__ __device__ static constexpr int w() {
    return K == 0 ? W0 : K == 1 ? W1 : K == 2 ? W2 : W3;
  }
  template <int K>
  __host__ __device__ static constexpr int b_off() {
    return OFF ? 0 : W0 - w<K>();
  }
  template <int K>
  __host__ __device__ static constexpr int a_off() {
    return OFF ? 2 * K : W0 - w<K>();
  }
  // whether the band's second 8 rows lie in the window (not so for the
  // last band of a diagonal item of odd width: those rows are past d)
  template <int K>
  __host__ __device__ static constexpr bool upper() {
    return OFF || a_off<K>() + 1 < W0;
  }
};

// The item shapes: SBT_GRAM_SHAPES(X) calls X(index, W0, W1, W2, W3,
// OFF) for each, the Shape's parameters. This list is the one statement
// of the bands: the kernel's switch, the windows and sbt_gram_items read
// it.
#define SBT_GRAM_SHAPES(X) \
  X(0, 1, 0, 0, 0, false)  \
  X(1, 2, 0, 0, 0, false)  \
  X(2, 3, 1, 0, 0, false)  \
  X(3, 4, 2, 0, 0, false)  \
  X(4, 5, 3, 1, 0, false)  \
  X(5, 6, 4, 2, 0, false)  \
  X(6, 7, 5, 3, 1, false)  \
  X(7, 8, 2, 0, 0, false)  \
  X(8, 6, 4, 0, 0, false)  \
  X(9, 1, 1, 0, 0, true)   \
  X(10, 2, 2, 0, 0, true)  \
  X(11, 3, 3, 0, 0, true)  \
  X(12, 4, 4, 0, 0, true)  \
  X(13, 5, 5, 0, 0, true)  \
  X(14, 6, 6, 0, 0, true)  \
  X(15, 7, 7, 0, 0, true)  \
  X(16, 8, 8, 0, 0, true)

struct Item {
  int shape;  // index of the item's Shape (SBT_GRAM_SHAPES)
  int jb0;    // first group of the raw window (columns; diagonal rows)
  int ja0;    // first group of the A window (off-diagonal rows)
};

// Items of the diagonal tiles over g8 8-feature groups: tiles T = 0 ..
// nt - 1 along d, the last wl groups wide. A full diagonal tile is two
// items, bands {0, 3} and {1, 2} (shapes 7 and 8); a narrower last tile
// is one item of all its bands (shape wl - 1).
__host__ __device__ __forceinline__ int diagonal_items(int g8) {
  const int nt = (g8 + 7) / 8;
  return 2 * (nt - 1) + (g8 - 8 * (nt - 1) == 8 ? 2 : 1);
}

// A launch's items, the grid's y extent: the diagonal tiles', then two
// for each tile (I, J) above them.
__host__ __device__ __forceinline__ int item_count(int g8) {
  const int nt = (g8 + 7) / 8;
  return diagonal_items(g8) + nt * (nt - 1);
}

// Item y of a launch over g8 groups: the diagonal tiles' items, then
// each tile (I, J), I < J, in row-major order, as two items (h = 0, 1)
// of two row bands each (shape 8 + tile J's width).
__host__ __device__ __forceinline__ Item decode_item(int y, int g8) {
  const int nt = (g8 + 7) / 8;
  const int wl = g8 - 8 * (nt - 1);
  const int n_diag = diagonal_items(g8);
  Item it;
  if (y < n_diag) {
    const int T = (y >> 1) < nt - 1 ? (y >> 1) : nt - 1;
    if (T < nt - 1 || wl == 8) {
      const int h = y - 2 * T;
      it.shape = 7 + h;
      it.jb0 = 8 * T + 2 * h;
    } else {
      it.shape = wl - 1;
      it.jb0 = 8 * T;
    }
    it.ja0 = it.jb0;
    return it;
  }
  int u = (y - n_diag) >> 1;
  const int h = (y - n_diag) & 1;
  int I = 0;
  while (u >= nt - 1 - I) {
    u -= nt - 1 - I;
    ++I;
  }
  const int J = I + 1 + u;
  it.shape = 8 + (g8 - 8 * J < 8 ? g8 - 8 * J : 8);
  it.jb0 = 8 * J;
  it.ja0 = 8 * I + 4 * h;
  return it;
}

// groups of the raw (and remainder) window of a shape: its W0
__host__ __device__ __forceinline__ int window_groups(int shape) {
#define SBT_GRAM_W0(I, W0, W1, W2, W3, OFF) \
  case I:                                   \
    return W0;
  switch (shape) { SBT_GRAM_SHAPES(SBT_GRAM_W0) }
#undef SBT_GRAM_W0
  return 0;
}

// groups of 8 columns a shape's bands multiply, each 16 rows deep, for
// each of the item's (replica, pair)s
int band_groups(int shape) {
#define SBT_GRAM_BANDS(I, W0, W1, W2, W3, OFF) \
  case I:                                      \
    return W0 + W1 + W2 + W3;
  switch (shape) { SBT_GRAM_SHAPES(SBT_GRAM_BANDS) }
#undef SBT_GRAM_BANDS
  return 0;
}

struct WgBlock {
  Pairs pr;
  Item it;
  int row_begin, row_end;  // the row split's rows
  int tile0, n_tiles;      // and their 64-row tiles
};

// A consumer warp's accumulators of one band and its A fragments of two
// k steps.
template <int W>
struct Band {
  static constexpr int kN = 4 * (W > 0 ? W : 1);
  float part[kN];  // the row tile's products, from zero
  float sum[kN];   // the block's sums, rounded to nearest
  uint32_t big[2][4], small[2][4];
};

template <class S>
struct Bands {
  Band<S::template w<0>()> b0;
  Band<S::template w<1>()> b1;
  Band<S::template w<2>()> b2;
  Band<S::template w<3>()> b3;
};

template <int K, class B>
__device__ __forceinline__ auto& band(B& bs) {
  if constexpr (K == 0) return bs.b0;
  else if constexpr (K == 1) return bs.b1;
  else if constexpr (K == 2) return bs.b2;
  else return bs.b3;
}

// f(Ic<K>) for each band K of the shape
template <class S, class F>
__device__ __forceinline__ void for_bands(F&& f) {
  f(Ic<0>{});
  if constexpr (S::template w<1>() > 0) f(Ic<1>{});
  if constexpr (S::template w<2>() > 0) f(Ic<2>{});
  if constexpr (S::template w<3>() > 0) f(Ic<3>{});
}

// The warp's A fragments of k step ks: x_i * s (the fp32 product) for
// the band's 16 rows i, whose image groups start at x, split into big
// (cut to TF32) and small (the exact rest); lane = 4 g + q reads (row g,
// k q) at the lane's own 4 bytes, so a warp's loads hit 32 banks.
template <bool UPPER>
__device__ __forceinline__ void build_a(const float* x, int ks, int lane,
                                        float s0, float s4,
                                        uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  const float* p = x + ks * 64 + lane;
  const float v[4] = {__fmul_rn(p[0], s0),
                      UPPER ? __fmul_rn(p[kGroup], s0) : 0.f,
                      __fmul_rn(p[32], s4),
                      UPPER ? __fmul_rn(p[kGroup + 32], s4) : 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    big[e] = cut_tf32(v[e]);
    small[e] = __float_as_uint(__fsub_rn(v[e], __uint_as_float(big[e])));
    fence_operand(big[e]);
    fence_operand(small[e]);
  }
}

// One band's k step, 3xTF32: small*big + big*small + big*big, B's big
// half X itself (raw) and its small half the remainder (rem)
template <int W>
__device__ __forceinline__ void issue_band(float (&part)[4 * W],
                                           const uint32_t (&big)[4],
                                           const uint32_t (&small)[4],
                                           uint64_t raw, uint64_t rem,
                                           uint32_t acc) {
  Wgmma<W>::run(part, small, raw, acc);
  Wgmma<W>::run(part, big, rem, 1);
  Wgmma<W>::run(part, big, raw, 1);
}

// k step ks of a row tile into A buffer BUF: wait for step ks - 2 (it
// read this buffer), build the bands' A fragments, issue and commit
template <class S, int BUF>
__device__ __forceinline__ void k_step(Bands<S>& bs, const float* ax,
                                       const float* ss, uint64_t raw,
                                       uint64_t rem, int ks, int lane) {
  wgmma_wait<1>();
  const int q = lane & 3;
  const float s0 = ss[8 * ks + q], s4 = ss[8 * ks + q + 4];
  for_bands<S>([&](auto k) {
    constexpr int K = decltype(k)::value;
    auto& b = band<K>(bs);
    build_a<S::template upper<K>()>(ax + S::template a_off<K>() * kGroup, ks,
                                    lane, s0, s4, b.big[BUF], b.small[BUF]);
  });
  wgmma_fence();
  const uint32_t acc = ks > 0;
  const uint64_t step = static_cast<uint64_t>(ks * (256 >> 4));
  for_bands<S>([&](auto k) {
    constexpr int K = decltype(k)::value;
    auto& b = band<K>(bs);
    constexpr uint64_t off = S::template b_off<K>() * (kGroupBytes >> 4);
    issue_band<S::template w<K>()>(b.part, b.big[BUF], b.small[BUF],
                                   raw + off + step, rem + off + step, acc);
  });
  wgmma_commit();
}

// A consumer warp (cw: its (replica, pair) slot) over the block's row
// tiles, then its bands' entries of the upper triangle, mirrored.
template <class S>
__device__ __forceinline__ void consume(const GramArgs& a, const WgBlock& blk,
                                        const unsigned char* smem,
                                        uint32_t bars, int cw, int lane) {
  Bands<S> bs;
  for_bands<S>([&](auto k) {
    auto& b = band<decltype(k)::value>(bs);
#pragma unroll
    for (int i = 0; i < b.kN; ++i) b.sum[i] = b.part[i] = 0.f;
  });
  const uint32_t base = smem_addr(smem);
  for (int st = 0; st < blk.n_tiles; ++st) {
    const int slot = st % kStages;
    mbar_wait(bars + 8 * slot, (st / kStages) & 1);
    const unsigned char* stage = smem + slot * kStageBytes;
    const float* ax =
        reinterpret_cast<const float*>(stage + (S::kOff ? kAOff : kRawOff));
    const float* ss =
        reinterpret_cast<const float*>(stage + kSOff) + cw * kSLd;
    const uint32_t sa = base + slot * kStageBytes;
    const uint64_t raw = b_desc(sa + kRawOff), rem = b_desc(sa + kRemOff);
#pragma unroll 1
    for (int ks = 0; ks < kKSteps; ks += 2) {
      k_step<S, 0>(bs, ax, ss, raw, rem, ks, lane);
      k_step<S, 1>(bs, ax, ss, raw, rem, ks + 1, lane);
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + slot));
    for_bands<S>([&](auto k) {
      auto& b = band<decltype(k)::value>(bs);
#pragma unroll
      for (int i = 0; i < b.kN; ++i) {
        fence_operand(b.part[i]);
        b.sum[i] = __fadd_rn(b.sum[i], b.part[i]);
      }
    });
  }

  if (cw >= blk.pr.nq) return;
  float* o = out_matrix(a, blk.pr.q0 + cw);
  const int g = lane >> 2, q = lane & 3;
  const int rows0 = 8 * (S::kOff ? blk.it.ja0 : blk.it.jb0);
  for_bands<S>([&](auto k) {
    constexpr int K = decltype(k)::value;
    auto& b = band<K>(bs);
    const int i0 = rows0 + 8 * S::template a_off<K>();
    const int j0 = 8 * (blk.it.jb0 + S::template b_off<K>());
#pragma unroll
    for (int jj = 0; jj < S::template w<K>(); ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1);
        const int j = j0 + 8 * jj + 2 * q + (e & 1);
        if (i >= a.d || j >= a.d || (!S::kOff && j < i)) continue;
        const float v = b.sum[4 * jj + e];
        o[(long long)i * a.d + j] = v;
        o[(long long)j * a.d + i] = v;
      }
    }
  });
}

// The producer warp: each row tile's windows by TMA (lane 0) and the S
// values of the block's (replica, pair)s by cp.async (every lane: lane l
// takes pair l % kPairs, rows l / kPairs + 32 / kPairs i), into the ring.
__device__ __forceinline__ void produce(const GramArgs& a, const WgBlock& blk,
                                        unsigned char* smem, uint32_t bars,
                                        int lane) {
  const int wr = window_groups(blk.it.shape);
  const bool off = blk.it.shape > 8;
  const uint32_t bytes = (2 * wr + (off ? 4 : 0)) * kGroupBytes;
  const float* x_tiles = a.img + (long long)blk.pr.xi * a.tiles * a.g8 * kGroup;
  const int w = lane % kPairs;
  const bool w_ok = w < blk.pr.nq;
  const float* s_src = a.S;
  if (w_ok) {
    const long long qw = blk.pr.q0 + w;
    const long long r = qw / a.P;
    s_src = a.S + r * a.n * a.P + (qw - r * a.P);
  }
  constexpr int kRowStep = 32 / kPairs;
  for (int st = 0; st < blk.n_tiles; ++st) {
    const int slot = st % kStages;
    mbar_wait(bars + 8 * (kStages + slot), ((st / kStages) & 1) ^ 1);
    unsigned char* stage = smem + slot * kStageBytes;
    const uint32_t full = bars + 8 * slot;
    const float* tile = x_tiles + (long long)(blk.tile0 + st) * a.g8 * kGroup;
    if (lane == 0) {
      mbar_expect_tx(full, bytes);
      const float* src = tile + blk.it.jb0 * kGroup;
      bulk_load(smem_addr(stage + kRawOff), src, wr * kGroupBytes, full);
      bulk_load(smem_addr(stage + kRemOff), src + a.img_half,
                wr * kGroupBytes, full);
      if (off)
        bulk_load(smem_addr(stage + kAOff), tile + blk.it.ja0 * kGroup,
                  4 * kGroupBytes, full);
    }
    float* ss = reinterpret_cast<float*>(stage + kSOff) + w * kSLd;
    const int row0 = blk.row_begin + st * kRowTile;
#pragma unroll
    for (int i = 0; i < kRowTile / kRowStep; ++i) {
      const int t = lane / kPairs + kRowStep * i;
      const bool ok = w_ok && row0 + t < blk.row_end;
      cp_async4(ss + t, ok ? s_src + (long long)(row0 + t) * a.P : a.S, ok);
    }
    cp_async_arrive(full);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

#define SBT_GRAM_CASE(I, W0, W1, W2, W3, OFF)                            \
  case I:                                                                \
    consume<Shape<W0, W1, W2, W3, OFF>>(a, blk, smem, bars, warp, lane); \
    break;

// Block (pair group, item, row split): warps 0 .. kPairs - 1 are the
// consumers (two warpgroups), warp kPairs the producer; the rest of the
// producer's warpgroup only gives its registers back.
__global__ void __launch_bounds__(kWgThreads, 1)
scaled_gram_mma_wgmma(const GramArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  WgBlock blk;
  blk.pr = block_pairs(a);
  blk.it = decode_item(blockIdx.y, a.g8);
  blk.row_begin = blockIdx.z * a.rows_per_split;
  blk.row_end = min(a.n, blk.row_begin + a.rows_per_split);
  blk.tile0 = blk.row_begin / kRowTile;
  blk.n_tiles = (blk.row_end - blk.row_begin + kRowTile - 1) / kRowTile;
  const uint32_t bars = smem_addr(smem + kBarOff);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, kFullArrivals);
      mbar_init(bars + 8 * (kStages + s), kPairs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= kPairs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kPairs) produce(a, blk, smem, bars, lane);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    switch (blk.it.shape) {
      SBT_GRAM_SHAPES(SBT_GRAM_CASE)
      default:
        break;
    }
  }
}

#undef SBT_GRAM_CASE

// The launch's images of X: 16-byte unit u = ((xi * tiles + t) * g8 + j)
// * 128 + 16 ks + 8 h + f holds rows 64 t + 8 ks + 4 h .. +3 of feature
// 8 j + f of X index xi; the first image X itself, the second (img_half
// further) x - cut(x). Rows past n and features past d are 0.
__global__ void __launch_bounds__(256)
scaled_gram_mma_prep(const float* __restrict__ X, long long x_rstride,
                     float4* __restrict__ img, int n, int d, int tiles,
                     int g8, long long units) {
  const long long u = blockIdx.x * 256LL + threadIdx.x;
  if (u >= units) return;
  const int f = static_cast<int>(u & 7);
  const int h = static_cast<int>((u >> 3) & 1);
  const int ks = static_cast<int>((u >> 4) & 7);
  const long long tg = u >> 7;
  const int j = static_cast<int>(tg % g8);
  const long long xt = tg / g8;
  const int t = static_cast<int>(xt % tiles);
  const float* src = X + (xt / tiles) * x_rstride;
  const int col = 8 * j + f;
  const int row0 = kRowTile * t + 8 * ks + 4 * h;
  float v[4], r[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int row = row0 + c;
    v[c] = row < n && col < d ? __ldg(src + (long long)row * d + col) : 0.f;
    r[c] = __fsub_rn(v[c], __uint_as_float(cut_tf32(v[c])));
  }
  img[u] = make_float4(v[0], v[1], v[2], v[3]);
  img[units + u] = make_float4(r[0], r[1], r[2], r[3]);
}

// One warpgroup, one band of 8 columns, one k step, through the wgmma
// design's image layout, A fragments (x * s split, each warp its own s),
// descriptors and three wgmma: out[16 w + m][c] = sum_k xa[k][m] *
// s[w][k] * xb[k][c]; xa (8, 16), xb (8, 8), s (4, 8), out (64, 8). For
// the card tests of the fragment layouts.
__global__ void __launch_bounds__(128)
wgmma_probe(const float* __restrict__ xa, const float* __restrict__ xb,
            const float* __restrict__ s, float* __restrict__ out) {
  // the A window's two groups, then B's raw and remainder groups
  __shared__ __align__(128) float img[4 * kGroup];
  __shared__ float ss[4 * kSLd];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  for (int e = tid; e < 4 * kGroup; e += 128) img[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < 8 * 16; e += 128) {
    const int k = e / 16, m = e % 16;
    img[(m / 8) * kGroup + (k / 4) * 32 + (m % 8) * 4 + k % 4] = xa[e];
  }
  if (tid < 64) {
    const int k = tid / 8, c = tid % 8;
    const int at = (k / 4) * 32 + c * 4 + k % 4;
    const float v = xb[tid];
    img[2 * kGroup + at] = v;
    img[3 * kGroup + at] = __fsub_rn(v, __uint_as_float(cut_tf32(v)));
  }
  if (tid < 32) ss[(tid / 8) * kSLd + tid % 8] = s[tid];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int g = lane >> 2, q = lane & 3;
  uint32_t big[4], small[4];
  build_a<true>(img, 0, lane, ss[w * kSLd + q], ss[w * kSLd + q + 4], big,
                small);
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t base = smem_addr(img);
  wgmma_fence();
  issue_band<1>(part, big, small, b_desc(base + 2 * kGroupBytes),
                b_desc(base + 3 * kGroupBytes), 0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    fence_operand(part[e]);
    out[(16 * w + g + 8 * (e >> 1)) * 8 + 2 * q + (e & 1)] = part[e];
  }
}

cudaError_t launch_wgmma(const GramArgs& a, int n_x, int items, int splits,
                         cudaStream_t st) {
  const long long units = (long long)n_x * a.tiles * a.g8 * 128;
  scaled_gram_mma_prep<<<static_cast<unsigned>((units + 255) / 256), 256, 0,
                         st>>>(a.X, a.x_rstride,
                               reinterpret_cast<float4*>(
                                   const_cast<float*>(a.img)),
                               a.n, a.d, a.tiles, a.g8, units);
  cudaError_t err = cudaFuncSetAttribute(
      scaled_gram_mma_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_x * a.groups, items, splits);
  scaled_gram_mma_wgmma<<<grid, kWgThreads, kWgSmemBytes, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bfloat16: warp-level mma.sync m16n8k16

// warps a block: each keeps one (replica, pair)'s output tile
constexpr int kWarps = SBT_GRAM_WARPS;
constexpr int kThreads = 32 * kWarps;

// Shared-memory layout of one pipeline stage, in floats: the B side
// (kTile columns of X), the A side of an off-diagonal half tile
// (kTile / 2 columns; a diagonal tile reads A from the B side) and the
// S values of the block's warps, [warp][row]. Rows are padded so that
// the fragment loads, which pair rows, hit 32 distinct banks (row
// stride = 4 mod 32).
struct Layout {
  static constexpr int kPad = 4;
  static constexpr int kLdB = kTile + kPad;
  static constexpr int kLdA = kTile / 2 + kPad;
  static constexpr int kStage = kRowTile * (kLdB + kLdA) + kWarps * kRowTile;
  static constexpr size_t kSmemBytes = 2 * sizeof(float) * kStage;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats rounded to bf16 (nearest even), lo in the low half: the
// element of the smaller k index, as the mma fragments order them
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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
// B[k][n] = tile[k][n0 + n] * s[k] (the scaled operand). m16n8k16 bf16
// (two k per register, low half first): a0 (m g, k 2q..2q+1), a1 (m g+8,
// k 2q..), a2 (m g, k 2q+8..), a3 (m g+8, k 2q+8..); b0 (k 2q..2q+1,
// n g), b1 (k 2q+8..2q+9, n g).
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

// One k16 step of a warp's output tile: c += A^T B over the step, B the
// x tile scaled by the warp's s (sS), for the kept tiles inside d
// (mi < mi_n, nj < nj_n).
template <int MI, bool DIAG, int LDA, int LDB>
__device__ __forceinline__ void mma_step(float (&c)[MI][8][4],
                                         const float* sA, const float* sB,
                                         const float* sS, int k0, int mi_n,
                                         int nj_n, int g, int q) {
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

// Block (group, item, split). With nt = ceil(d / 64), item < nt is the
// diagonal tile (item, item): rows and columns [64 item, 64 item + 64),
// four row blocks. Item nt + 2u + h is half h of the u-th off-diagonal
// tile (I, J), I < J in row-major order: rows [64 I + 32 h, +32),
// columns [64 J, +64), two row blocks. Warp w takes the block's w-th
// (replica, pair).
template <bool DIAG>
__device__ __forceinline__ void gram_block(const GramArgs& a, float* smem) {
  using L = Layout;
  constexpr int MI = DIAG ? 4 : 2;
  constexpr int KSTEP = 16;
  constexpr int LDA = DIAG ? L::kLdB : L::kLdA;
  constexpr int ACOLS = kTile / 2;
  constexpr int NT = kThreads;
  constexpr int BR = NT / kTile, AR = NT / ACOLS, SR = NT / kWarps;
  static_assert(NT % kTile == 0 && NT % kWarps == 0, "staging passes");
  static_assert(kRowTile % BR == 0 && kRowTile % AR == 0 &&
                kRowTile % SR == 0, "staging passes");

  const int nt = (a.d + kTile - 1) / kTile;
  int row0, col0;
  if (DIAG) {
    row0 = col0 = kTile * static_cast<int>(blockIdx.y);
  } else {
    int u = (static_cast<int>(blockIdx.y) - nt) >> 1;
    const int h = (static_cast<int>(blockIdx.y) - nt) & 1;
    int I = 0;
    while (u >= nt - 1 - I) {
      u -= nt - 1 - I;
      ++I;
    }
    row0 = kTile * I + ACOLS * h;
    col0 = kTile * (I + 1 + u);
  }
  const int mi_n = min(MI, (a.d - row0 + 15) / 16);
  const int nj_n = min(8, (a.d - col0 + 7) / 8);

  const Pairs pr = block_pairs(a);
  const float* Xb = a.X + pr.xi * a.x_rstride;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool active = warp < pr.nq;

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
  const bool s_ok = slot < pr.nq;
  const float* s_src = a.S;
  if (s_ok) {
    const long long qw = pr.q0 + slot;
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
        mma_step<MI, DIAG, LDA, L::kLdB>(part, sA, sB, sS, k0, mi_n, nj_n,
                                         g, q);
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
  float* o = out_matrix(a, pr.q0 + warp);
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

__global__ void __launch_bounds__(kThreads, 1)
scaled_gram_mma_sync(GramArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);
  if (static_cast<int>(blockIdx.y) < (a.d + kTile - 1) / kTile)
    gram_block<true>(a, stages);
  else
    gram_block<false>(a, stages);
}

// One warp, one 16x8 accumulator tile, one k16 step, through the bf16
// design's staging layout, fragment loads and mma: out[m][n] = sum_k
// xa[k][m] * (xb[k][n] * s[k]), xa (16, 16), xb (16, 8). For the card
// tests of the fragment layouts.
__global__ void mma_probe(const float* __restrict__ xa,
                          const float* __restrict__ xb,
                          const float* __restrict__ s,
                          float* __restrict__ out) {
  constexpr int K = 16;
  constexpr int LD = Layout::kLdB;
  __shared__ float sa[K * LD], sb[K * LD], ss[K];
  const int lane = threadIdx.x;
  for (int e = lane; e < K * LD; e += 32) sa[e] = sb[e] = 0.f;
  __syncwarp();
  for (int e = lane; e < K * 16; e += 32) sa[(e / 16) * LD + e % 16] = xa[e];
  for (int e = lane; e < K * 8; e += 32) sb[(e / 8) * LD + e % 8] = xb[e];
  if (lane < K) ss[lane] = s[lane];
  __syncwarp();
  float c[1][8][4] = {};
  mma_step<1, false, LD, LD>(c, sa, sb, ss, 0, 1, 1, lane >> 2, lane & 3);
  for (int e = 0; e < 4; ++e)
    out[frag_row(e, lane >> 2) * 8 + frag_col(e, lane & 3)] = c[0][0][e];
}

cudaError_t launch_sync(const GramArgs& a, int n_x, int items, int splits,
                        cudaStream_t st) {
  const size_t smem = Layout::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      scaled_gram_mma_sync, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_x * a.groups, items, splits);
  scaled_gram_mma_sync<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------

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
// when splits == 1; img: float32 mode's scratch for X's images, (2, n_x,
// ceil(n / 64), ceil(d / 8), 512) floats, unused in bf16 mode. Geometry
// (n_x X matrices, pg pairs a block, groups of blocks along one X's
// pairs, splits, rows_per_split) comes from the Python wrapper
// (ops/gram.py); the items along d are the design's own. *wgmma is set
// to 1 when the wgmma design was launched, 0 when mma.sync was.
int sbt_scaled_gram(const void* X, long long x_rstride, const void* S,
                    void* out, void* partials, void* img, int n, int d,
                    int P, int R, int n_x, int pg, int groups, int splits,
                    int rows_per_split, int bf16, int* wgmma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits == 1 ? out : partials);
  const int tiles = (n + kRowTile - 1) / kRowTile, g8 = (d + 7) / 8;
  const int nt = (d + kTile - 1) / kTile;
  const GramArgs a{static_cast<const float*>(X),
                   x_rstride,
                   static_cast<const float*>(S),
                   dst,
                   static_cast<const float*>(img),
                   (long long)n_x * tiles * g8 * kGroup,
                   n, d, P, R, pg, groups, rows_per_split, tiles, g8};
  *wgmma = 0;
  cudaError_t err = bf16 ? launch_sync(a, n_x, nt * nt, splits, st)
                         : launch_wgmma(a, n_x, item_count(g8), splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  *wgmma = !bf16;
  if (splits == 1) return 0;
  const long long total = (long long)R * P * d * d;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_partials<<<blocks, 256, 0, st>>>(static_cast<const float*>(partials),
                                       static_cast<float*>(out), total, splits);
  return static_cast<int>(cudaGetLastError());
}

// The float32 (wgmma) design's items over d features, the grid's y
// extent, and in *issued the groups of 8 columns their bands multiply
// for one (replica, pair): 16 x 8 products a row of X each. Host
// arithmetic only.
int sbt_gram_items(int d, long long* issued) {
  const int g8 = (d + 7) / 8, items = item_count(g8);
  long long groups = 0;
  for (int y = 0; y < items; ++y) groups += band_groups(decode_item(y, g8).shape);
  *issued = groups;
  return items;
}

// The fragment probes: bf16, mma.sync: xa (16, 16), xb (16, 8), s (16,)
// -> out (16, 8); float32, wgmma: xa (8, 16), xb (8, 8), s (4, 8) -> out
// (64, 8).
int sbt_gram_mma_probe(const void* xa, const void* xb, const void* s,
                       void* out, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(xa);
  const float* b = static_cast<const float*>(xb);
  const float* sv = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  if (bf16)
    mma_probe<<<1, 32, 0, st>>>(a, b, sv, o);
  else
    wgmma_probe<<<1, 128, 0, st>>>(a, b, sv, o);
  return static_cast<int>(cudaGetLastError());
}

const char* sbt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
