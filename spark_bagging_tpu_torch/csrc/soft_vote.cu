// The replica-summed soft vote of linear-softmax learners on Hopper's
// tensor cores: out[i, c] = sum_r softmax([X_i, 1] @ W_r)[c].
//
// Replaces no TPU kernel: the JAX package leaves this forward to XLA
// (`predict_ensemble_classifier` in spark_bagging_tpu/ensemble.py). In the
// port it was a chain of library calls a replica chunk: the bias column's
// copy, one batched fp32 GEMM (R, n, d+1) @ (d+1, C), a softmax and a sum
// over replicas, which wrote the (R, n, C) scores to device memory and
// read them twice. At the headline shape (n = 581,012, d + 1 = 55,
// R = 1000, C = 7) the scores are 16.3 GB a call for a 16.3 MB answer,
// and the GEMM, with N = C = 7, leaves the card's tiles mostly empty.
//
// What bounds it on an H100: operations. 2 n R (d+1) C = 447 GFLOP a
// call against 143 MB that must move (X, W, the output): ~3,100 flops a
// byte. The design keeps the scores on chip and feeds the tensor cores:
//   * wgmma, TF32, as 3xTF32: each fp32 operand is split a = big + small,
//     big rounded to TF32, and acc += small*big + big*small + big*big; a
//     product is off by < 2^-20 of its size (the rounded split leaves
//     errors of either sign, which the replica mean averages instead of
//     piling up toward zero). mma.sync m16n8k8 ran ~4x below the card's
//     TF32 rate here (1.55 ms a 121-replica chunk without the softmax);
//   * one warpgroup a block owns kRows = 64 rows. Their X, split, sits in
//     registers as the A operand for the block's whole life (d + 1 up to
//     kKB columns; wider X is loaded a k step at a time);
//   * the n tile holds kPairs (replica, n8 class tile) pairs: one
//     replica's C <= 8 classes fill one n8 tile (C <= 32 takes NT
//     tiles); pad classes get a bias of -1e30, so their exponential is 0.
//     An accumulator row of a tile lives in the quad of threads that owns
//     it, so the softmax's max and sum are two shuffles each;
//   * W is split once a call (soft_vote_split, a launch before the main
//     one) into each stage's shared-memory image: scaled by log2(e) (so
//     a softmax term is one ex2), the TF32 halves, K-major, in the
//     canonical no-swizzle layout wgmma reads. A block copies a stage's
//     image with 16-byte cp.async into one of two buffers while it
//     computes on the other;
//   * the softmax takes its steps for all the stage's replicas at once
//     (their maxima's shuffles, then their exponentials, ...): one
//     replica's softmax is a chain of dependent shuffles and MUFU
//     operations, and 8 independent chains hide each other's latency
//     (13% off a chunk's time on an H100 against one replica after
//     another);
//   * each replica's probability enters the sums in fixed point, as two
//     64-bit integers: whole quanta of 2^-22 and a rest in quanta of
//     2^-68, found from the fp32 probability by exact float steps. The
//     rest keeps fp32's relative precision down to probabilities of
//     ~1e-13 (a class at 1e-12 in every replica keeps its size, where
//     2^-22 quanta alone would vote it 0). Integer sums do not depend on
//     their order: the sum over a bag's replicas has the same bits
//     however the replicas are split into chunks, grid.y splits (a
//     launch over few rows splits the replicas to fill the card; the
//     wrapper adds the splits' partials) or mesh shards. No atomics: two
//     runs give the same bits;
//   * the tensor cores sum in the accumulator truncating, not rounding
//     to nearest, which shrinks a score a little with every product
//     added; in a bag of near-equal replicas that does not average away.
//     So the big terms (7 products over the 55 columns) and the small
//     ones sum in accumulators of their own, added in fp32 after: at
//     the headline's shapes the mean probabilities of such a bag came
//     3x closer to float64 than in one accumulator (1.0e-6 against
//     3.1e-6 at unit weights, on an H100). Wider X adds each k step's
//     products into round-to-nearest fp32 registers;
//   * three blocks share an SM (57 KB of shared memory and 128 threads
//     each), so one block's softmax can run beside another's products.
//     (Keeping a block's next products in flight across its softmax
//     took more registers than it saved: 2 blocks an SM, slower.) The
//     dynamic shared memory size is set on the functions once a device
//     (sbt_soft_vote_init), before any capture: a CUDA-graph capture of
//     the launches needs no host call but them.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

// The tiling is decided in ops/soft_vote.py (CUDA_DEFINES), which also
// computes the launch geometry from it; utils/native.py passes it here.
#if !defined(SBT_SV_KBLOCK) || !defined(SBT_SV_PAIRS)
#error "build through spark_bagging_tpu_torch/utils/native.py (-D tiling)"
#endif

namespace {

// one warpgroup a block: four warps of 16 rows each
constexpr int kThreads = 128;
constexpr int kRows = 64;
// k block: columns of X (bias column included) a stage holds
constexpr int kKB = SBT_SV_KBLOCK;
constexpr int kKS = kKB / 8;
// (replica, n8 class tile) pairs a stage: the wgmma's n = 8 kPairs
constexpr int kPairs = SBT_SV_PAIRS;
constexpr int kAcc = 4 * kPairs;  // accumulator registers a thread
// a stage's B operand, in 16-byte units: per k step, pair J's 8 rows
// (classes) x two 4-wide k halves, rows one unit apart (the halves
// kLBO apart, the pairs kSBO apart)
constexpr int kLBO = 8;
constexpr int kSBO = 16;
constexpr int kStepUnits = kPairs * kSBO;
constexpr int kStageUnits = kKS * kStepUnits;
// the bias of a pad class: its score is ~-1e30, its exponential 0
constexpr float kPadBias = -1e30f;
// W is scaled by log2(e) as it is split, so the scores come out in
// base 2 and a softmax term is one ex2 of a difference
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kKB % 8 == 0, "a k block is whole k8 steps");
static_assert(kPairs == 8, "the products are wgmma m64n64k8");
static_assert((2 * kStageUnits) % kThreads == 0, "whole copy passes");
// two stage buffers: the next stage's copy lands while this one computes
constexpr int kSmemBytes = 2 * 2 * kStageUnits * 16;

struct SoftVoteArgs {
  const float* X;   // (n, d)
  const uint4* B;   // the stages' split W images, [stage][big, small]
  longlong2* out;   // (splits, n, C): the sums, hi and lo
  int n, d, C, R;
  int nkb;          // k blocks over d + 1 (1: X stays in registers)
  int gps;          // replica groups a split
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of r across the
// asynchronous products
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// 2^x, approximate (2 ulp), flushing subnormal results to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// v rounded to TF32 (nearest, ties away), in a b32 register
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small: big rounded to TF32; small the exact fp32 rest
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(v);
  small = __float_as_uint(__fsub_rn(v, __uint_as_float(big)));
}

// The no-swizzle K-major descriptor of a B tile (start address, LBO, SBO
// in 16-byte units; layout type 0)
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3fff) |
         (static_cast<uint64_t>(kLBO) << 16) |
         (static_cast<uint64_t>(kSBO) << 32);
}

// d += a @ B, m64n64k8 (wgmma_first: d = a @ B): A from registers (a0
// (row g, k q), a1 (row g+8, k q), a2 (row g, k q+4), a3 (row g+8, k q+4)
// of the warp's 16 rows), B by descriptor; d[4j + e] is (row g + 8 (e / 2),
// column 8j + 2q + e % 2).
#define SBT_SV_WGMMA(SCALE_D)                                      \
  "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "    \
  SCALE_D ", 1, 1;\n"

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(SBT_SV_WGMMA("1")
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// The old accumulator is not an input: nothing but this product defines
// it, which keeps the compiler from serializing the products
__device__ __forceinline__ void wgmma_first(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(SBT_SV_WGMMA("0")
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// NT n8 tiles a replica (C <= 8 NT), NR replicas a stage.
template <int NT>
struct Tiling {
  static constexpr int NR = kPairs / NT;
};

// The split image of stage s = group nkb + kb: 16-byte unit (ks, pair J,
// half h, row j) holds k = kb kKB + ks 8 + 4h .. +3 of replica
// group NR + J / NT, class (J % NT) 8 + j; the big halves, then the small
// ones. One thread a unit.
template <int NT>
__global__ void __launch_bounds__(256)
soft_vote_split(const float* __restrict__ W, uint4* __restrict__ B, int d,
                int C, int R, int nkb, long long units) {
  constexpr int NR = Tiling<NT>::NR;
  const long long t = blockIdx.x * 256LL + threadIdx.x;
  if (t >= units) return;
  const int u = static_cast<int>(t % kStageUnits);
  const long long stage = t / kStageUnits;
  const int group = static_cast<int>(stage / nkb);
  const int kb = static_cast<int>(stage % nkb);
  const int ks = u / kStepUnits;
  const int pair = (u / kSBO) % kPairs;
  const int h = (u / kLBO) % 2;
  const int j = u % kLBO;
  const int rep = group * NR + pair / NT;
  const int c = (pair % NT) * 8 + j;
  const bool live = pair / NT < NR && rep < R;
  uint32_t b[4], s[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = kb * kKB + ks * 8 + 4 * h + kk;
    const float v =
        !live || k > d ? 0.f
        : c < C        ? __fmul_rn(W[((long long)rep * (d + 1) + k) * C + c],
                                   kLog2e)
        : k == d       ? kPadBias
                       : 0.f;
    split_tf32(v, b[kk], s[kk]);
    s[kk] = tf32_rna(__uint_as_float(s[kk]));
  }
  uint4* img = B + stage * 2 * kStageUnits;
  img[u] = make_uint4(b[0], b[1], b[2], b[3]);
  img[kStageUnits + u] = make_uint4(s[0], s[1], s[2], s[3]);
}

// Stage s's image into a stage buffer.
__device__ __forceinline__ void copy_stage(const SoftVoteArgs& a, uint4* buf,
                                           long long s, int tid) {
  const uint4* src = a.B + s * 2 * kStageUnits;
#pragma unroll 4
  for (int i = tid; i < 2 * kStageUnits; i += kThreads)
    cp_async16(buf + i, src + i);
  cp_async_commit();
}

// The warp's A fragments of k step ks of block kb, split: X where it
// exists, 1 in column d (the bias), 0 beyond it and in rows past n.
__device__ __forceinline__ void load_a(const SoftVoteArgs& a, int row0,
                                       int k0, int g, int q,
                                       uint32_t (&ab)[4], uint32_t (&as)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + g + 8 * (e & 1);
    const int k = k0 + q + 4 * (e >> 1);
    float v = 0.f;
    if (row < a.n)
      v = k < a.d ? __ldg(a.X + (long long)row * a.d + k)
                  : (k == a.d ? 1.f : 0.f);
    split_tf32(v, ab[e], as[e]);
    fence_operand(ab[e]);
    fence_operand(as[e]);
  }
}

// acc = the k step's products, 3xTF32, the small terms first
__device__ __forceinline__ void step_products(float (&acc)[kAcc],
                                              const uint32_t (&ab)[4],
                                              const uint32_t (&as)[4],
                                              uint64_t db, uint64_t ds,
                                              int ks) {
  const uint64_t off = static_cast<uint64_t>(ks * kStepUnits);
  wgmma_first(acc, as, db + off);
  wgmma_tf32(acc, ab, ds + off);
  wgmma_tf32(acc, ab, db + off);
}

// Each replica's probability p enters the sums exactly, in fixed point:
// p 2^22 = e q (its exponential e times q = 2^22 / the exponentials'
// sum) is split into three whole numbers, e q = h0 + h1 2^-23 + h2
// 2^-46 + a rest below 2^-25, by rounding with a magic number and taking
// the rest. Adding kWhole (2^23) to a value in [0, 2^23) rounds it to
// the nearest whole number (the floats in [2^23, 2^24] are the
// integers); adding kMagic (1.5 2^23) does the same for a value within
// 2^22 of 0. h0 = rn(e q) takes one fused multiply-add, and so does
// its rest r0 = e q - h0 (one rounding, within 2^-25 as |r0| <= 1/2);
// h1 and h2 are r0 2^23 and its rest 2^23 rounded, exact steps. h0
// counts quanta of 2^-22 and h1 2^23 + h2 quanta of 2^-68; the integer
// sums are exact in any order, so the sums over any partition of the
// replicas (chunks, splits, mesh shards) add up to the same bits.
constexpr float kQuanta = 4194304.f;  // 2^22 quanta a unit of probability
constexpr float kWhole = 8388608.f;   // 2^23
constexpr float kMagic = 12582912.f;  // 1.5 2^23
constexpr float kRest = 8388608.f;    // 2^23: a rest's next 23 bits
constexpr int kRestBits = 23;

// The group's replicas: the softmax of each accumulator row, summed in
// fixed point (hi: quanta of 2^-22; lo: quanta of 2^-68). Each step runs
// for every replica before the next step starts (the maxima's shuffles,
// the exponentials, the sums' shuffles, ...): one replica's softmax is a
// chain of dependent shuffles and MUFU operations, and the group's
// independent chains side by side hide each other's latency.
template <int NT>
__device__ __forceinline__ void vote(const float (&acc)[kAcc], int group,
                                     int R, long long (&hi)[NT][4],
                                     long long (&lo)[NT][4]) {
  constexpr int NR = Tiling<NT>::NR;
  float m[NR][2], s[NR][2], p[NR][NT][4];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float* v = acc + 4 * r * NT;
    m[r][0] = v[0];
    m[r][1] = v[2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        m[r][h] = fmaxf(m[r][h],
                        fmaxf(v[4 * nt + 2 * h], v[4 * nt + 2 * h + 1]));
  }
#pragma unroll
  for (int lane_bit = 1; lane_bit <= 2; lane_bit <<= 1)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        m[r][h] = fmaxf(m[r][h],
                        __shfl_xor_sync(0xffffffffu, m[r][h], lane_bit));
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    s[r][0] = s[r][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[r][nt][e] = ex2(__fsub_rn(acc[4 * (r * NT + nt) + e], m[r][e >> 1]));
        s[r][e >> 1] += p[r][nt][e];
      }
  }
#pragma unroll
  for (int lane_bit = 1; lane_bit <= 2; lane_bit <<= 1)
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[r][h] += __shfl_xor_sync(0xffffffffu, s[r][h], lane_bit);
  float q[NR][2];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    q[r][0] = __fdividef(kQuanta, s[r][0]);
    q[r][1] = __fdividef(kQuanta, s[r][1]);
  }
  // the group's live replicas (uniform over the block). A float y in
  // [2^23, 2^24] holds the whole number y - kWhole (or y - kMagic),
  // which is its bits less kWhole's (kMagic's): the group's bits are
  // summed unsigned (wrapping) and the magic numbers' taken off once;
  // each term and each group's sum fits in 32 bits signed
  const int live = min(NR, R - group * NR);
  const uint32_t bias0 = static_cast<uint32_t>(live) * __float_as_uint(kWhole);
  const uint32_t bias = static_cast<uint32_t>(live) * __float_as_uint(kMagic);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t w0 = 0, w1 = 0, w2 = 0;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r >= live) break;
        const float pe = p[r][nt][e], qe = q[r][e >> 1];
        const float y0 = __fmaf_rn(pe, qe, kWhole);
        const float r0 = __fmaf_rn(pe, qe, -__fsub_rn(y0, kWhole));
        const float y1 = __fmaf_rn(r0, kRest, kMagic);
        const float r1 = __fmaf_rn(r0, kRest, -__fsub_rn(y1, kMagic));
        const float y2 = __fmaf_rn(r1, kRest, kMagic);
        w0 += __float_as_uint(y0);
        w1 += __float_as_uint(y1);
        w2 += __float_as_uint(y2);
      }
      hi[nt][e] += static_cast<int>(w0 - bias0);
      lo[nt][e] += static_cast<long long>(static_cast<int>(w1 - bias)) *
                       (1LL << kRestBits) +
                   static_cast<int>(w2 - bias);
    }
}

// A stage's products from buffer buf, issued and committed: the big
// terms and the small ones in accumulators of their own, since the
// tensor cores truncate each sum to the accumulator's ulp: the small
// terms' truncations stay 2^-11 of the scores', and the scores' take 7
// truncations, not 21
__device__ __forceinline__ void issue_stage(float (&big)[kAcc],
                                            float (&small)[kAcc],
                                            const uint4* buf,
                                            const uint32_t (&ab)[kKS][4],
                                            const uint32_t (&as)[kKS][4]) {
  const uint64_t db = b_desc(buf), ds = b_desc(buf + kStageUnits);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    const uint64_t off = static_cast<uint64_t>(ks * kStepUnits);
    if (ks == 0) {
      wgmma_first(small, as[ks], db + off);
      wgmma_tf32(small, ab[ks], ds + off);
      wgmma_first(big, ab[ks], db + off);
    } else {
      wgmma_tf32(small, as[ks], db + off);
      wgmma_tf32(small, ab[ks], ds + off);
      wgmma_tf32(big, ab[ks], db + off);
    }
  }
  wgmma_commit();
}

// After the wait: the scores, big += small
__device__ __forceinline__ void settle(float (&big)[kAcc],
                                       float (&small)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    fence_operand(big[i]);
    fence_operand(small[i]);
    big[i] = __fadd_rn(big[i], small[i]);
  }
}

template <int NT, bool WIDE>
__global__ void __launch_bounds__(kThreads)
soft_vote_wgmma(SoftVoteArgs a) {
  extern __shared__ __align__(128) uint4 smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wrow0 = blockIdx.x * kRows + 16 * warp;
  const int groups = (a.R + Tiling<NT>::NR - 1) / Tiling<NT>::NR;
  const int g_begin = blockIdx.y * a.gps;
  const int g_end = min(groups, g_begin + a.gps);
  const int stages = (g_end - g_begin) * a.nkb;
  const long long s0 = (long long)g_begin * a.nkb;
  const int kp = (a.d + 1 + 7) / 8 * 8;

  float acc[kAcc];
  // the probabilities' sums in fixed point: quanta of 2^-22 and 2^-68
  long long hi[NT][4], lo[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hi[nt][e] = lo[nt][e] = 0;

  // the resident X: every k step of the one block (zeros past d)
  uint32_t ab[kKS][4], as[kKS][4];
  if (stages > 0) copy_stage(a, smem, s0, tid);
  if constexpr (!WIDE) {
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
      load_a(a, wrow0, 8 * ks, g, q, ab[ks], as[ks]);
  }
  float racc[kAcc];  // WIDE: the round-to-nearest sums of the k steps

  for (int st = 0; st < stages; ++st) {
    const uint4* buf = smem + (st & 1) * 2 * kStageUnits;
    const int group = g_begin + st / a.nkb;
    const int kb = st % a.nkb;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // the stage's image is in; the last stage is done
    if (st + 1 < stages)  // lands in the other buffer while this computes
      copy_stage(a, smem + ((st + 1) & 1) * 2 * kStageUnits, s0 + st + 1,
                 tid);

    if constexpr (WIDE) {
      // each k step's products summed apart, then added into racc
      // rounding to nearest
      const int ksn = min(kKS, (kp - kb * kKB) / 8);
      const uint64_t db = b_desc(buf), ds = b_desc(buf + kStageUnits);
      if (kb == 0) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) racc[i] = 0.f;
      }
      for (int ks = 0; ks < ksn; ++ks) {
        load_a(a, wrow0, kb * kKB + 8 * ks, g, q, ab[0], as[0]);
        wgmma_fence();
        step_products(acc, ab[0], as[0], db, ds, ks);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          fence_operand(acc[i]);
          racc[i] = __fadd_rn(racc[i], acc[i]);
        }
      }
      if (kb == a.nkb - 1) vote<NT>(racc, group, a.R, hi, lo);
    } else {
      float small[kAcc];
      issue_stage(acc, small, buf, ab, as);
      wgmma_wait_all();
      settle(acc, small);
      vote<NT>(acc, group, a.R, hi, lo);
    }
  }

  longlong2* o = a.out + (long long)blockIdx.y * a.n * a.C;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wrow0 + g + 8 * (e >> 1);
      const int c = nt * 8 + 2 * q + (e & 1);
      if (row < a.n && c < a.C)
        o[(long long)row * a.C + c] = make_longlong2(hi[nt][e], lo[nt][e]);
    }
}

template <int NT>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      soft_vote_wgmma<NT, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(soft_vote_wgmma<NT, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

template <int NT>
cudaError_t launch(const float* W, const SoftVoteArgs& a, int splits,
                   cudaStream_t st) {
  const int groups = (a.R + Tiling<NT>::NR - 1) / Tiling<NT>::NR;
  const long long units = (long long)groups * a.nkb * kStageUnits;
  soft_vote_split<NT><<<static_cast<unsigned>((units + 255) / 256), 256, 0,
                        st>>>(W, const_cast<uint4*>(a.B), a.d, a.C, a.R,
                              a.nkb, units);
  const dim3 grid((a.n + kRows - 1) / kRows, splits);
  if (a.nkb > 1)
    soft_vote_wgmma<NT, true><<<grid, kThreads, kSmemBytes, st>>>(a);
  else
    soft_vote_wgmma<NT, false><<<grid, kThreads, kSmemBytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Once a device, before the first launch there: the kernels' dynamic
// shared memory size.
int sbt_soft_vote_init() {
  cudaError_t err = set_smem<1>();
  if (err == cudaSuccess) err = set_smem<2>();
  if (err == cudaSuccess) err = set_smem<3>();
  if (err == cudaSuccess) err = set_smem<4>();
  return static_cast<int>(err);
}

// X: (n, d); W: (R, d + 1, C), C <= 32; B: the split images, 2 x
// stage_units 16-byte units for each of groups x nkb stages; out:
// (splits, n, C, 2) int64, 16-byte aligned: the sums in quanta of 2^-22
// and of 2^-68. Geometry (nkb k
// blocks, gps replica groups a split, splits) comes from the Python
// wrapper (ops/soft_vote.py).
int sbt_soft_vote(const void* X, const void* W, void* B, void* out, int n,
                  int d, int C, int R, int nkb, int gps, int splits,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SoftVoteArgs a{static_cast<const float*>(X),
                       static_cast<const uint4*>(B),
                       static_cast<longlong2*>(out), n, d, C, R, nkb, gps};
  const float* w = static_cast<const float*>(W);
  switch ((C + 7) / 8) {
    case 1: return static_cast<int>(launch<1>(w, a, splits, st));
    case 2: return static_cast<int>(launch<2>(w, a, splits, st));
    case 3: return static_cast<int>(launch<3>(w, a, splits, st));
    case 4: return static_cast<int>(launch<4>(w, a, splits, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 16-byte units of one stage's split image (its big or its small half)
int sbt_soft_vote_stage_units() { return kStageUnits; }

}  // extern "C"
