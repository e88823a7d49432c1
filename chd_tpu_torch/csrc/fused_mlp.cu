// Fused, BN-folded contact MLP (5 layers) for Hopper: wgmma on tensor cores
// in chd_tpu's matmul precisions, weight tiles multicast over a cluster by
// bulk copies, persistent clusters.
//
// Replaces chd_tpu/ops/pallas_mlp.py::_kernel (fused_mlp, pallas_call at
// :72), which runs the whole folded MLP (351 -> 1024 -> 512 -> 128 -> 32 ->
// 20, ReLU after the first four layers) as one Pallas kernel per 256-row
// batch tile with every weight resident in VMEM. chd_tpu's detector runs its
// contact matmuls at a `precision` (infer.py:76-118), or with bf16 storage
// (`mlp_dtype`). On its TPU each is a number of bf16 passes: every f32
// operand a is split into bf16 parts a1 = bf16(a), a2 = bf16(a - a1), a3 =
// bf16(a - a1 - a2) (round to nearest even; each difference is exact in
// f32), and a*b is a sum of products of parts with f32 sums. This kernel
// computes layers 0-2 (99 % of the 954 k multiply-adds of a row) with
// wgmma.mma_async m64nNk16 bf16 -> f32 in one of four modes, a template
// parameter:
//
//   mode       precision           parts  products, in this order
//   kDefault   None / "default"    1      a1*b1
//   kHigh      "high"              2      a2*b1, a1*b2, a1*b1
//   kHighest   "highest"           3      a3*b1, a1*b3, a2*b2, a2*b1, a1*b2, a1*b1
//   kBf16      mlp_dtype=bfloat16  1      a1*b1, inputs, weights and biases
//                                         bf16; each layer's f32 sum rounded
//                                         to bf16, the bias added and the sum
//                                         rounded again, then the ReLU
//
// Layers 3 and 4 run in f32 on CUDA cores (in kBf16 with the same bf16
// roundings). ops/fused_mlp.fused_mlp_split_plain (and, for kBf16,
// fused_mlp_bf16_plain) is the same arithmetic in plain torch.
//
// What bounds it: the passes of layers 0-2 are n x 226.6 GFLOP for the
// 118,784 windows of 512 videos x 240 frames, 0.23 ms a pass at the card's
// 989 TFLOP/s bf16 peak, which only wgmma reaches. The split weights (2
// bytes a part: 3.9 MB at two parts) do not fit in a block's 227 KB of
// shared memory, so every 64-row tile streams all of them from L2; at 64
// rows a weight byte carries 96 FLOP in kHigh, and feeding the peak at that
// ratio would take ~10 TB/s of L2 reads. The register file caps a tile at 64
// rows (h2, 64 x 512 f32, lives in registers across the layer-0/1 chunks),
// so the rows that share one weight fetch go up by sharing it across blocks.
//
// The design:
// - A block has three warpgroups. Warpgroup 0 produces: its warp 0 issues
//   the weight copies, warps 1-3 gather the first-layer rows. Warpgroups 1
//   and 2 consume; setmaxnreg moves registers from the producer (40 a
//   thread) to them (232). Each consumer warpgroup owns half of every
//   layer's outputs: 64 of each 128-column h1 chunk, 256 of h2's 512 columns
//   (m64n256: 128 f32 accumulators a thread across the chunks), and half of
//   layer 2's inputs (a partial h3, summed in a fixed order: bias + the
//   first warpgroup's + the second's), one 64-output half at a time so that
//   its 32 accumulators fit beside h2's 128. Named barriers between the two
//   take the place of __syncthreads.
// - wgmma reads B, the weights, from shared memory through descriptors, and
//   A from registers: the first-layer rows and the h1 chunk are kept in f32
//   in shared memory and split into the mode's bf16 parts as each A fragment
//   is loaded, and layer 2's A is h2 itself, converted in registers from the
//   layer-1 accumulators (whose layout is wgmma's A fragment layout). Each
//   pass of a mode is one wgmma into the same accumulators, in PASS_ORDER.
//   A k16 step's wgmmas are one group. At one part the A fragments are
//   double-buffered and a step waits for all but its own group; at two or
//   three, a step waits for its own (see kWait).
// - Weights: ops/fused_mlp.pack_weights lays layers 0-2 out once per layers
//   object as a stream of 16 KB-a-part stages, in the order a tile consumes
//   them and in wgmma's no-swizzle K-major layout (8 x 8 core matrices: 8
//   rows of 16 bytes, the two k halves of a k16 slab 128 bytes apart, 8-row
//   groups 256 bytes apart). Per 128-column h1 chunk: layer 0's 128-output x
//   64-input stages, then layer 1's 512-output x 16-input stages; then layer
//   2's, for each half of its 128 outputs four stages of four k16 slabs of
//   each warpgroup's 256 inputs; then layers 3-4 in f32 (tail_stages). A
//   ring of stages (full and empty mbarriers) holds 6-7, 3 or 2 stages at 1,
//   2 or 3 parts. The blocks of a cluster of kCluster walk the same stages:
//   each block copies 1/kCluster of each stage with
//   cp.async.bulk...multicast::cluster into the same slot of every block, so
//   each stage leaves L2 once per cluster; a slot's empty barrier collects
//   the release of every consumer warpgroup of the cluster before any block
//   refills it.
// - Persistent clusters: as many clusters as fit (cudaOccupancyMaxActive-
//   Clusters) walk groups of kCluster consecutive 64-row tiles, cluster k
//   the groups k, k + clusters, ..., so the weight stream runs on from one
//   tile to the next, and the next tile's first stages and first-layer rows
//   load while the consumers run layers 2-4 of the current one.
// - First-layer rows are read through strides (below), 4 bytes at a time by
//   cp.async into shared memory (their stride, 156 bytes for the lower body,
//   is no multiple of 16, so no bulk copy can fetch them), tracked by an
//   mbarrier. Up to kD0Resident inputs a tile's rows stay resident for the
//   whole tile; wider rows (`full`, 675) come in 64-input slabs through a
//   ring of four, re-read for each chunk (L2 holds them). Each row's offset
//   in x is computed once a tile.
// - Layers 3 and 4 (0.017 ms of the bound) run in f32 on CUDA cores, their
//   weights read from the stream's last stage in shared memory: each output
//   bias + sum over its inputs in ascending order (kBf16: the sum, rounded,
//   + the bias, rounded), a row's 32 layer-3 outputs shared by warp
//   shuffles.
//
// What was hard, and where it is solved:
// - kHighest sums each k16 step's six passes from zero and adds that to the
//   accumulator in IEEE f32, because the tensor cores round their f32 sums
//   toward zero (about an ulp of the running sum per MMA), which over a long
//   accumulation is more than its f32-level accuracy allows. A second
//   accumulator set does not fit beside h2's 128 registers, so kHighest
//   issues every product as n32 sub-blocks into a 16-register temporary,
//   waits, and adds it (mma()).
// - A block past the last tile (a ragged last cluster) runs the same stage
//   sequence on zero rows and stores nothing, so every block of a cluster
//   arrives on every barrier; the producer waits for the last release of
//   every slot before its block exits (a peer's consumers arrive on its
//   barriers). Every mbarrier wait traps after ~10 s instead of hanging.
// - Registers: a consumer thread holds 128 (h2) + 32 (the h1 chunk's
//   layer-0 outputs) or 32 (half its partial h3) accumulators and its A
//   fragments, within setmaxnreg's 232. Where ptxas finds too few
//   registers to keep wgmmas in flight, or finds a wgmma's accumulators set
//   in a divergent path or read while one is in flight, it serializes every
//   wgmma of the kernel (its C7512/C7515/C7518 notes, printed by
//   chip_smoke.py [2] with the registers and spills of -Xptxas -v): hence
//   the branch-free accumulator inits, the warp-uniform warpgroup index,
//   the drain after each chunk's layer 1, layer 2 in halves waiting at each
//   k16 step, and kWait.
// - Build: the 8 instantiations (2 first-layer layouts x 4 modes) build in
//   ~23 s. chip_smoke.py [24] finds the kernel in a trace by its demangled
//   name, `fused_mlp_kernel`, which stays.
//
// First-layer rows are read through strides, so the same kernel serves the
// materialized window batch and the conv-fused path: row g of the batch
// starts at x + (g / rows_per_group) * group_stride + (g % rows_per_group) *
// row_stride and is d0 floats long. With x = the preprocessed frames
// (V, F * J * 3), row_stride = J * 3 and the layer-1 weights of
// ops/windows.layer1_conv_kernel reshaped to (W * J * 3, H), row g is the
// contiguous strip of W frames that window g reads: an implicit im2col, and
// the (V, N, W, J, C) window tensor never exists.
//
// Every row runs the same code in a fixed order, whichever block, cluster
// slot or tile it lands in, with masks only at the loads and stores, and no
// sum crosses tiles: a row's logits do not depend on the batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Hidden widths the kernel is built for (models/contact_mlp.HIDDEN).
constexpr int kD1 = 1024, kD2 = 512, kD3 = 128, kD4 = 32;
constexpr int kD0Resident = 368;  // widest first layer whose rows stay resident
constexpr int kD0Max = 768;       // `full` (675) is the widest joint set
constexpr int kD5Max = 32;

// The modes (ops/fused_mlp.MODES, in this order).
constexpr int kDefault = 0, kHigh = 1, kHighest = 2, kBf16 = 3;
constexpr int kModes = 4;

constexpr int kCluster = 2;                   // blocks sharing each weight stage
constexpr int kRows = 64;                     // rows per tile
constexpr int kThreads = 3 * 128;             // a producer and two consumer warpgroups
constexpr int kLoaders = 96;                  // the producer's warps 1-3
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kNc = 128;                      // h1 columns per chunk
constexpr int kChunks = kD1 / kNc;
constexpr int kK0 = 64;                       // layer-0 inputs per stage
constexpr int kL1Stages = kNc / 16;           // layer-1 stages per chunk, one k16 slab each
constexpr int kL2Stages = 8;                  // 64 outputs x 4 k16 slabs of each warpgroup's inputs
constexpr int kPartBytes = 16384;             // one part of a stage
constexpr int kSlabBytes = 4096;              // a k16 slab of 128 rows
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;
constexpr int kLdH1 = kNc + 8;                // f32 rows, 8 banks apart
constexpr int kLdH3 = kD3 + 4;
constexpr int kLdSlab = kK0 + 8;
constexpr int kXSlabs = 4;                    // first-layer slabs in flight (slab mode)
// the h1 chunk, then the tail's h3
constexpr int kH1Bytes = 4 * kRows * (kLdH1 > kLdH3 ? kLdH1 : kLdH3);
constexpr int kRowSrcOffset = 256;           // after the barriers: a tile's row offsets
constexpr int kBarBytes = kRowSrcOffset + 8 * kRows;
constexpr int kBarFree = 1, kBarFull = 2;     // named barriers of the consumers,
constexpr int kBarHalf = 3;                   // and one for each half of h3;
constexpr int kBarLoaders = 5;                // the loader warps' barrier
constexpr long long kHangCycles = 20000000000LL;

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int parts(int m) { return m == kHigh ? 2 : m == kHighest ? 3 : 1; }
__host__ __device__ constexpr int passes(int m) { return m == kHigh ? 3 : m == kHighest ? 6 : 1; }
// Pass q multiplies part pass_a(m, q) of the activations by part
// pass_b(m, q) of the weights (0 = the largest), smallest products first.
__host__ __device__ constexpr int pass_a(int m, int q) {
  return m == kHigh ? (q == 0 ? 1 : 0)
                    : m == kHighest ? (q == 0 ? 2 : (q == 2 || q == 3) ? 1 : 0) : 0;
}
__host__ __device__ constexpr int pass_b(int m, int q) {
  return m == kHigh ? (q == 1 ? 1 : 0)
                    : m == kHighest ? (q == 1 ? 2 : (q == 2 || q == 4) ? 1 : 0) : 0;
}
// kHighest sums each k16 step's passes from zero (see the note above).
__host__ __device__ constexpr bool flushes(int m) { return m == kHighest; }
__host__ __device__ constexpr int stage_bytes(int m) { return parts(m) * kPartBytes; }

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr bool slabs(int d0) { return d0 > kD0Resident; }
__host__ __device__ constexpr int ld_x(int d0) { return slabs(d0) ? kLdSlab : round16(d0) + 8; }
__host__ __device__ constexpr int x_slots(int d0) { return slabs(d0) ? kXSlabs : 1; }
__host__ __device__ constexpr int x_slot_bytes(int d0) { return 4 * kRows * ld_x(d0); }
__host__ __device__ constexpr int k_tiles0(int d0) { return (round16(d0) + kK0 - 1) / kK0; }
// Stages of a tile's weight stream: layers 0-2 in bf16 parts, then layers
// 3 and 4 in f32 (w3, then w4, b3 and b4 padded to kD5Max outputs), 16 KB
// each, in one stage, or two at one part.
__host__ __device__ constexpr int tail_stages(int m) { return parts(m) == 1 ? 2 : 1; }
__host__ __device__ constexpr int n_stages(int d0, int m) {
  return kChunks * (k_tiles0(d0) + kL1Stages) + kL2Stages + tail_stages(m);
}
__host__ __device__ constexpr int ring_stages(int d0, int m) {
  return imin(kMaxStages, (kSmemMax - x_slots(d0) * x_slot_bytes(d0) - kH1Bytes - kBarBytes) /
                              stage_bytes(m));
}
// Shared memory: the ring, the first-layer rows, h1 (h3 in the tail), the
// barriers and the tile's row offsets.
__host__ __device__ constexpr int smem_bytes(int d0, int m) {
  return ring_stages(d0, m) * stage_bytes(m) + x_slots(d0) * x_slot_bytes(d0) + kH1Bytes +
         kBarBytes;
}

// -- PTX -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the phase of parity `parity` to complete; traps after
// kHangCycles, so that a deadlock fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > kHangCycles) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives on the barrier at the same offset in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` from global src to shared dst of every block of the cluster, each
// completing on the barrier at `bar`'s offset in that block.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  if constexpr (kCluster > 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "h"((uint16_t)((1 << kCluster) - 1))
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// 4 bytes from src to dst, or zeros where !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// The barrier's arrival once this thread's cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t n_clusters() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// The two consumer warpgroups' barrier, and an arrival on it that does not
// wait.
template <int kId>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "n"(2 * 128) : "memory");
}
template <int kId>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(kId), "n"(2 * 128) : "memory");
}
// The producer's loader warps' barrier.
__device__ __forceinline__ void loader_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBarLoaders), "n"(kLoaders) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of wgmma's accumulators above a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Descriptor of a K-major, no-swizzle operand at shared address `addr`:
// core matrices of 8 rows x 16 bytes, the two k halves 128 bytes apart
// (leading byte offset), 8-row groups 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (m64nN f32) += a (m64k16 bf16, registers) * b (k16nN bf16, descriptor);
// scale_d = 0 sets d = a * b. One per N.
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// -- fragments -------------------------------------------------------------

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as P bf16 pairs, each rounded to nearest even, into a[.][i].
template <int P>
__device__ __forceinline__ void split(float x, float y, uint32_t (&a)[P][4], int i) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  a[0][i] = as_u32(h);
  if constexpr (P > 1) {
    const float rx = x - __low2float(h), ry = y - __high2float(h);
    const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
    a[1][i] = as_u32(m);
    if constexpr (P > 2)
      a[2][i] = as_u32(__floats2bfloat162_rn(rx - __low2float(m), ry - __high2float(m)));
  }
}

// A fragment parts of rows m0 .. m0 + 15 (the warp's) and columns k0 ..
// k0 + 15 of the f32 activations f (ld floats a row).
template <int P>
__device__ __forceinline__ void load_a(const float* f, int ld, int m0, int k0, int lane,
                                       uint32_t (&a)[P][4]) {
  const int r = m0 + (lane >> 2), c = k0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v =
        *reinterpret_cast<const float2*>(f + (r + 8 * (i & 1)) * ld + c + 8 * (i >> 1));
    split<P>(v.x, v.y, a, i);
  }
}

// An accumulator's start: the bias, or 0 in kBf16, which adds it after
// rounding the sum.
template <int M>
__device__ __forceinline__ float acc0_of(float b) {
  return M == kBf16 ? 0.f : b;
}
// A hidden layer's output from its accumulator v (and bias b in kBf16).
template <int M>
__device__ __forceinline__ float act(float v, float b) {
  if constexpr (M == kBf16) return fmaxf(bf16r(bf16r(v) + b), 0.f);
  return fmaxf(v, 0.f);
}

// Accumulators of an m64nN tile (N = 2 * NR) from the bias at b (the
// tile's first column) times `scale` (1, or 0 for none), without a branch:
// a wgmma's accumulators set in a divergent path serialize every wgmma of
// the kernel.
template <int M, int NR>
__device__ __forceinline__ void init_acc(float (&acc)[NR], const float* b, int tq,
                                         float scale = 1.f) {
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
    const float v0 = scale * acc0_of<M>(__ldg(b + 8 * j + 2 * tq));
    const float v1 = scale * acc0_of<M>(__ldg(b + 8 * j + 2 * tq + 1));
    acc[4 * j] = acc[4 * j + 2] = v0;
    acc[4 * j + 1] = acc[4 * j + 3] = v1;
  }
  fence_regs(acc);
}

// acc (m64nN, NR = N / 2 registers) += a * b over one k16 step, the mode's
// passes in order; b is the shared address of part 0 of the step's B, the
// parts kPartBytes apart. kHighest sums the passes of each n32 sub-block
// from zero and adds them in IEEE f32.
template <int M, int NR>
__device__ __forceinline__ void mma(float (&acc)[NR], const uint32_t (&a)[parts(M)][4],
                                    uint32_t b) {
  if constexpr (!flushes(M)) {
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < passes(M); ++q)
      wgmma(acc, a[pass_a(M, q)], desc(b + pass_b(M, q) * kPartBytes), 1);
  } else {
#pragma unroll
    for (int s = 0; s < NR / 16; ++s) {
      float t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) t[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < passes(M); ++q)
        wgmma(t, a[pass_a(M, q)], desc(b + pass_b(M, q) * kPartBytes + s * 1024), q > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[16 * s + i] += t[i];
    }
  }
}

// The producer's and the consumers' view of the weight ring: slot `slot`
// of `stages`, in phase `phase`.
struct Ring {
  uint32_t full, empty;  // shared addresses of the barrier arrays
  int stages, slot = 0;
  uint32_t phase = 0;
  int last = -1;  // consumers: the slot of the last k16 step, not yet released
  __device__ __forceinline__ int next() {
    const int s = slot;
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
    return s;
  }
  // Consumers: waits for the next stage; returns its slot.
  __device__ __forceinline__ int acquire() {
    mbar_wait(full + 8 * slot, phase);
    return next();
  }
  // Consumers: slot s is free in every block of the cluster, as far as this
  // warpgroup is concerned (its threads ct < kCluster arrive).
  __device__ __forceinline__ void release(int s, int ct) {
    if (ct < kCluster) mbar_arrive_cluster(empty + 8 * s, ct);
  }
  // After a k16 step's wgmmas on slot s: commits them as a group, waits for
  // the previous one (kWait: for this one too), and releases its slot if
  // that was its stage's last.
  template <bool kWait>
  __device__ __forceinline__ void step(int s, int ct) {
    wgmma_commit();
    wgmma_wait<kWait ? 0 : 1>();
    if (last >= 0 && last != s) release(last, ct);
    last = s;
  }
  __device__ __forceinline__ void drain(int ct) {
    wgmma_wait<0>();
    if (last >= 0) release(last, ct);
    last = -1;
  }
};

// kSlab: the first-layer rows come in 64-input slabs (d0 > kD0Resident);
// otherwise they stay resident for the tile. M: the mode.
template <bool kSlab, int M>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_kernel(const float* __restrict__ x, long long n_rows,
                     long long rows_per_group, long long group_stride,
                     long long row_stride, int d0, const bf16* __restrict__ wpack,
                     const float* __restrict__ b0, const float* __restrict__ b1,
                     const float* __restrict__ b2, int d5, float* __restrict__ out) {
  constexpr int P = parts(M), kStage = stage_bytes(M);
  // With more than one part, a k16 step waits for its own wgmmas and the A
  // fragments have one buffer: two buffers of two or three parts beside h2
  // leave ptxas too few registers, and it then serializes every wgmma.
  constexpr bool kWait = P > 1;
  extern __shared__ __align__(1024) unsigned char smem[];

  const int S = ring_stages(d0, M), XS = x_slots(d0), ldx = ld_x(d0);
  const int k0p = round16(d0), kt0 = k_tiles0(d0), stages = n_stages(d0, M);
  unsigned char* xs = smem + S * kStage;
  float* h1 = reinterpret_cast<float*>(xs + XS * x_slot_bytes(d0));
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = smem_u32(h1) + kH1Bytes;
  const uint32_t full = bars, empty = bars + 8 * kMaxStages;
  const uint32_t xfull = bars + 16 * kMaxStages, xempty = xfull + 8 * kXSlabs;

  // the warpgroup, uniform in each warp as far as the compiler can tell
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0), lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const int groups = (int)(((n_rows + kRows - 1) / kRows + kCluster - 1) / kCluster);
  const int first = cluster_id(), step = n_clusters();

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * kCluster);
    }
    for (int i = 0; i < XS; ++i) {
      mbar_init(xfull + 8 * i, kLoaders);
      mbar_init(xempty + 8 * i, 2 * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any copy or remote arrival

  if (wg == 0) {
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      // The weight stream: every stage of every tile group, this block's
      // 1/kCluster of it multicast to the cluster.
      Ring r{full, empty, S};
      constexpr int kSlice = kStage / kCluster;
      const char* src = reinterpret_cast<const char*>(wpack) + rank * kSlice;
      for (int g = first; g < groups; g += step) {
        for (int t = 0; t < stages; ++t) {
          mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
          mbar_expect_tx(full + 8 * r.slot, kStage);
          bulk_copy(ring + r.slot * kStage + rank * kSlice, src + (size_t)t * kStage, kSlice,
                    full + 8 * r.slot);
          r.next();
        }
      }
      // The block leaves once every consumer of the cluster has released
      // every slot, so no peer arrives on its barriers afterwards.
      for (int s = 0; s < S; ++s) {
        mbar_wait(empty + 8 * r.slot, r.phase ^ 1);
        r.next();
      }
    } else if (tid >= 32) {
      // The first-layer rows of this block's tile of each group: all of
      // them (resident), or a 64-input slab for each (chunk, layer-0 stage).
      const int lt = tid - 32, lw = lt >> 5;
      long long* row_src = reinterpret_cast<long long*>(
          reinterpret_cast<unsigned char*>(h1) + kH1Bytes + kRowSrcOffset);
      int xslot = 0;
      uint32_t xphase = 0;
      auto fill = [&](int c0, int ncols) {
        mbar_wait(xempty + 8 * xslot, xphase ^ 1);
        const uint32_t dst = smem_u32(xs + xslot * x_slot_bytes(d0));
        for (int r = lw; r < kRows; r += kLoaders / 32) {
          const long long src = row_src[r];
          for (int cc = lane; cc < ncols; cc += 32) {
            const int col = c0 + cc;
            const bool ok = src >= 0 && col < d0;
            cp_async4(dst + 4 * (r * ldx + cc), ok ? x + src + col : x, ok);
          }
        }
        cp_async_arrive(xfull + 8 * xslot);
        if (++xslot == XS) {
          xslot = 0;
          xphase ^= 1;
        }
      };
      for (int g = first; g < groups; g += step) {
        // The offset in x of each row of the tile (-1 past the end), once a
        // tile: a slab tile reads its rows again for each (chunk, stage).
        const long long row0 = ((long long)g * kCluster + rank) * kRows;
        loader_sync();  // every loader is done with the last tile's offsets
        if (lt < kRows) {
          const long long gr = row0 + lt;
          row_src[lt] = gr < n_rows ? (gr / rows_per_group) * group_stride +
                                          (gr % rows_per_group) * row_stride
                                    : -1;
        }
        loader_sync();
        if constexpr (kSlab) {
          for (int c = 0; c < kChunks; ++c)
            for (int kt = 0; kt < kt0; ++kt) fill(kt * kK0, kK0);
        } else {
          fill(0, k0p);
        }
      }
    }
    return;
  }

  // -- consumers ------------------------------------------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int w = wg - 1, ct = tid & 127, wi = ct >> 5, g = lane >> 2, tq = lane & 3;
  Ring r{full, empty, S};
  int xslot = 0;
  uint32_t xphase = 0;
  uint32_t a[2][P][4];

#pragma unroll 1
  for (int grp = first; grp < groups; grp += step) {
    const long long row0 = ((long long)grp * kCluster + rank) * kRows;
    float acc2[128];  // h2 columns w * 256 .. w * 256 + 255
    init_acc<M>(acc2, b1 + w * 256, tq);

#pragma unroll 1
    for (int c = 0; c < kChunks; ++c) {
      // Layer 0: h1 columns c * kNc + w * 64 .. + 63.
      float acc0[32];
      init_acc<M>(acc0, b0 + c * kNc + w * 64, tq);
#pragma unroll 1
      for (int kt = 0; kt < kt0; ++kt) {
        const bool x_in = kSlab || (c == 0 && kt == 0);
        const bool x_out = kSlab || (c == kChunks - 1 && kt == kt0 - 1);
        if (x_in) mbar_wait(xfull + 8 * xslot, xphase);
        const float* xa = reinterpret_cast<const float*>(xs + xslot * x_slot_bytes(d0));
        const int col0 = kSlab ? 0 : kt * kK0;
        const int nks = imin(kK0, k0p - kt * kK0) / 16;
        const int s = r.acquire();
#pragma unroll
        for (int ks = 0; ks < kK0 / 16; ++ks) {
          if (ks < nks) {
            load_a<P>(xa, ldx, 16 * wi, col0 + 16 * ks, lane, a[kWait ? 0 : ks & 1]);
            mma<M>(acc0, a[kWait ? 0 : ks & 1], ring + s * kStage + ks * kSlabBytes + w * 2048);
            r.step<kWait>(s, ct);
          }
        }
        if (x_out) {  // every warp's reads of this slab are done
          __syncwarp();
          if (lane == 0) mbar_arrive(xempty + 8 * xslot);
          if (++xslot == XS) {
            xslot = 0;
            xphase ^= 1;
          }
        }
      }
      r.drain(ct);
      fence_regs(acc0);
      bar_sync<kBarFree>();  // the other warpgroup is done with the last h1 (or h3)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = w * 64 + 8 * j + 2 * tq;
        const float v0 = __ldg(b0 + c * kNc + col), v1 = __ldg(b0 + c * kNc + col + 1);
        const int row = 16 * wi + g;
        *reinterpret_cast<float2*>(h1 + row * kLdH1 + col) =
            make_float2(act<M>(acc0[4 * j], v0), act<M>(acc0[4 * j + 1], v1));
        *reinterpret_cast<float2*>(h1 + (row + 8) * kLdH1 + col) =
            make_float2(act<M>(acc0[4 * j + 2], v0), act<M>(acc0[4 * j + 3], v1));
      }
      bar_sync<kBarFull>();

      // Layer 1: h2 += h1 chunk @ W1[chunk rows, w's columns], a k16 slab a
      // stage.
#pragma unroll 1
      for (int kp = 0; kp < kL1Stages / 2; ++kp) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = r.acquire();
          load_a<P>(h1, kLdH1, 16 * wi, 16 * (2 * kp + h), lane, a[kWait ? 0 : h]);
          mma<M>(acc2, a[kWait ? 0 : h], ring + s * kStage + w * 8192);
          r.step<kWait>(s, ct);
        }
      }
      // Drained here, no wgmma is in flight where the chunk loop carries h2's
      // accumulators round (ptxas would otherwise wait there itself).
      r.drain(ct);
    }

    // Layer 2 in two halves of its 128 outputs: this warpgroup's 256 h2
    // columns, converted from the accumulators into A fragments, times W2's
    // rows of them, a partial h3 half; h3 = act(bias + the first warpgroup's
    // partial + the second's), in f32 shared memory over h1. Each k16 step
    // waits for its wgmmas: h2's 128 registers are read here, and ptxas
    // serializes every wgmma of the kernel if these can overlap.
    fence_regs(acc2);
    float* h3 = h1;
    bar_sync<kBarFree>();  // both warpgroups are done with h1
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc3[32];
      init_acc<M>(acc3, b2 + 64 * hf, tq, w == 0 ? 1.f : 0.f);
      int s2 = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j % 4 == 0) s2 = r.acquire();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 8 * j + 2 * i, col = w * 256 + 16 * j + 8 * (i >> 1) + 2 * tq;
          split<P>(act<M>(acc2[e], __ldg(b1 + col)), act<M>(acc2[e + 1], __ldg(b1 + col + 1)),
                   a[0], i);
        }
        mma<M>(acc3, a[0], ring + s2 * kStage + w * 8192 + (j % 4) * 2048);
        r.step<true>(s2, ct);
      }
      r.drain(ct);
      fence_regs(acc3);
      if (w == 1) {  // the first warpgroup's partial is there
        if (hf == 0) bar_sync<kBarHalf>();
        else bar_sync<kBarHalf + 1>();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * hf + 8 * j + 2 * tq;
        const float v0 = __ldg(b2 + col), v1 = __ldg(b2 + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* q = reinterpret_cast<float2*>(h3 + (16 * wi + g + 8 * h) * kLdH3 + col);
          if (w == 0) {
            *q = make_float2(acc3[4 * j + 2 * h], acc3[4 * j + 2 * h + 1]);
          } else {
            const float2 o = *q;
            *q = make_float2(act<M>(o.x + acc3[4 * j + 2 * h], v0),
                             act<M>(o.y + acc3[4 * j + 2 * h + 1], v1));
          }
        }
      }
      if (w == 0) {
        if (hf == 0) bar_arrive<kBarHalf>();
        else bar_arrive<kBarHalf + 1>();
      }
    }
    bar_sync<kBarFull>();

    // Layers 3 and 4 in f32, their weights the stream's last stage(s): a
    // thread takes a row and 8 of its outputs.
    const int st3 = r.acquire(), st4 = P == 1 ? r.acquire() : st3;
    const float* w3s = reinterpret_cast<const float*>(smem + st3 * kStage);
    const float* w4s = reinterpret_cast<const float*>(smem + st4 * kStage + (P == 1 ? 0 : kPartBytes));
    const float* b3s = w4s + kD4 * kD5Max;
    const float* b4s = b3s + kD4;
    const int ct2 = w * 128 + ct, row = ct2 >> 2, n0 = (ct2 & 3) * 8;
    float a3[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a3[j] = acc0_of<M>(b3s[n0 + j]);
#pragma unroll 8
    for (int k = 0; k < kD3; ++k) {
      const float h = h3[row * kLdH3 + k];
      const float4 wa = *reinterpret_cast<const float4*>(w3s + k * kD4 + n0);
      const float4 wb = *reinterpret_cast<const float4*>(w3s + k * kD4 + n0 + 4);
      a3[0] = fmaf(h, wa.x, a3[0]);
      a3[1] = fmaf(h, wa.y, a3[1]);
      a3[2] = fmaf(h, wa.z, a3[2]);
      a3[3] = fmaf(h, wa.w, a3[3]);
      a3[4] = fmaf(h, wb.x, a3[4]);
      a3[5] = fmaf(h, wb.y, a3[5]);
      a3[6] = fmaf(h, wb.z, a3[6]);
      a3[7] = fmaf(h, wb.w, a3[7]);
    }
    float h4[8], o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h4[j] = act<M>(a3[j], b3s[n0 + j]);
      o[j] = acc0_of<M>(b4s[n0 + j]);
    }
    const int quad = lane & ~3;  // the row's four threads
#pragma unroll
    for (int k = 0; k < kD4; ++k) {
      const float hk = __shfl_sync(0xffffffffu, h4[k & 7], quad + (k >> 3));
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = fmaf(hk, w4s[k * kD5Max + n0 + j], o[j]);
    }
    const long long gr = row0 + row;
    if (gr < n_rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + j;
        if (n < d5) out[gr * d5 + n] = M == kBf16 ? bf16r(bf16r(o[j]) + b4s[n]) : o[j];
      }
    }
    bar_sync<kBarFull>();  // both warpgroups are done with the tail's stage(s)
    r.release(st3, ct);
    if (P == 1) r.release(st4, ct);
  }
}

typedef void (*KernelFn)(const float*, long long, long long, long long, long long, int,
                         const bf16*, const float*, const float*, const float*, int, float*);

template <int M>
KernelFn kernel_for(int d0) {
  return slabs(d0) ? fused_mlp_kernel<true, M> : fused_mlp_kernel<false, M>;
}

KernelFn kernel_of(int d0, int mode) {
  switch (mode) {
    case kDefault: return kernel_for<kDefault>(d0);
    case kHigh: return kernel_for<kHigh>(d0);
    case kHighest: return kernel_for<kHighest>(d0);
    case kBf16: return kernel_for<kBf16>(d0);
    default: return nullptr;
  }
}

cudaLaunchConfig_t launch_config(long long clusters, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's shared-memory limit and returns how many of its
// clusters fit on the card at once (0 on an error, in *err).
int prepare(KernelFn kernel, int smem, cudaError_t* err) {
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err != cudaSuccess) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, smem, 0, &attr);
  int clusters = 0;
  *err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (*err == cudaSuccess && clusters < 1) *err = cudaErrorInvalidConfiguration;
  return clusters;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for a d0-wide first layer in `mode`.
int chd_fused_mlp_smem_bytes(int d0, int mode) {
  return mode >= 0 && mode < kModes ? smem_bytes(d0, mode) : 0;
}

// Stages (tiles) in the packed weight stream for a d0-wide first layer in
// `mode`.
int chd_fused_mlp_tiles(int d0, int mode) {
  return mode >= 0 && mode < kModes ? n_stages(d0, mode) : 0;
}

// bf16 parts of each packed weight stage in a mode (0 for an unknown mode).
int chd_fused_mlp_parts(int mode) { return mode >= 0 && mode < kModes ? parts(mode) : 0; }

// Blocks of a cluster, which share each weight stage.
int chd_fused_mlp_cluster_size() { return kCluster; }

// Stages of a block's weight ring for a d0-wide first layer in `mode`.
int chd_fused_mlp_ring_stages(int d0, int mode) {
  return mode >= 0 && mode < kModes ? ring_stages(d0, mode) : 0;
}

// Clusters the card runs at once for a d0-wide first layer in `mode` (the
// persistent grid's size), or minus the CUDA error.
int chd_fused_mlp_clusters(int d0, int mode) {
  const KernelFn kernel = kernel_of(d0, mode);
  if (kernel == nullptr || d0 < 1 || d0 > kD0Max) return -(int)cudaErrorInvalidValue;
  cudaError_t err;
  const int clusters = prepare(kernel, smem_bytes(d0, mode), &err);
  return err == cudaSuccess ? clusters : -(int)err;
}

// logits (n_rows, d5) of the folded MLP on the strided rows of x, with the
// widths d0 -> 1024 -> 512 -> 128 -> 32 -> d5, in `mode` (kDefault, kHigh,
// kHighest, kBf16). wpack is the stage stream of layers 0-2 in the mode's
// bf16 parts and of layers 3-4 in f32 (ops/fused_mlp.pack_weights); b0, b1
// and b2 are layers 0-2's f32 biases.
// Launches on `stream` and returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for widths or a mode the kernel does not
// take).
int chd_fused_mlp_forward(const float* x, long long n_rows,
                          long long rows_per_group, long long group_stride,
                          long long row_stride, int d0, const void* wpack,
                          const float* b0, const float* b1, const float* b2, int d5,
                          int mode, float* out, void* stream) {
  if (d0 < 1 || d0 > kD0Max || d5 < 1 || d5 > kD5Max) return (int)cudaErrorInvalidValue;
  const KernelFn kernel = kernel_of(d0, mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(d0, mode);
  // The cluster count of the last (kernel, smem) asked, per instantiation.
  static KernelFn known_kernel[2 * kModes];
  static int known_smem[2 * kModes], known_clusters[2 * kModes];
  const int k = 2 * mode + (slabs(d0) ? 1 : 0);
  if (known_kernel[k] != kernel || known_smem[k] != smem) {
    cudaError_t err;
    known_clusters[k] = prepare(kernel, smem, &err);
    if (err != cudaSuccess) return (int)err;
    known_kernel[k] = kernel;
    known_smem[k] = smem;
  }
  const long long tiles = (n_rows + kRows - 1) / kRows;
  const long long groups = (tiles + kCluster - 1) / kCluster;
  const long long clusters = groups < known_clusters[k] ? groups : known_clusters[k];
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(clusters, smem, (cudaStream_t)stream, &attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, n_rows, rows_per_group, group_stride,
                                       row_stride, d0, static_cast<const bf16*>(wpack), b0, b1,
                                       b2, d5, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* chd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
