// Fused, BN-folded contact MLP (5 layers) for Hopper, on tensor cores in
// chd_tpu's matmul precisions.
//
// Replaces chd_tpu/ops/pallas_mlp.py::_kernel, which runs the whole folded
// MLP (351 -> 1024 -> 512 -> 128 -> 32 -> 20, ReLU after the first four
// layers) as one Pallas kernel per 256-row batch tile with every weight
// resident in VMEM. chd_tpu's detector runs its contact matmuls at a
// `precision` (infer.py:76-118), or with bf16 storage (`mlp_dtype`). On its
// TPU each is a number of bf16 passes: every f32 operand a is split into
// bf16 parts a1 = bf16(a), a2 = bf16(a - a1), a3 = bf16(a - a1 - a2) (round
// to nearest even; each difference is exact in f32), and a*b is a sum of
// products of parts with f32 sums. This kernel computes layers 0-2 (99 % of
// the 954 k multiply-adds of a row) with mma.sync.m16n8k16.bf16 and f32
// accumulators in one of four modes, a template parameter:
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
// 989 TFLOP/s bf16 peak, which only wgmma reaches; with mma.sync every
// operand also passes from shared memory through registers (ldmatrix). On
// the card the 3-pass kernel keeps two thirds of its time without any MMA
// (operand loads, barriers, staging), and nearly all of it without the
// weight copies. The split weights (2 bytes a part: 3.9 MB at two parts)
// do not fit in a block's 227 KB of shared memory, so every row tile
// streams all of them from L2 (50 MB, which holds them): 7.3 GB per call at
// two parts, hidden behind the rest. A 64-row tile is as many rows as the
// activations leave room for; larger tiles need weights shared across a
// cluster (TMA multicast).
//
// The design:
// - A block takes kRows = 64 rows. It gathers their first-layer inputs
//   through the strides, splits them, and keeps them in shared memory for
//   the whole block, for a first layer up to kD0Resident = 432 wide (every
//   joint set but `full`). Wider rows (`full`, 675) do not fit beside the h1
//   chunk and the weight ring: the block then stages, for each layer-0 tile
//   of each chunk, only that tile's 128 inputs of its rows into one of two
//   slab buffers, and re-reads them through the strides each chunk (L2 holds
//   them). The tile's inputs are staged before the barrier that hands out
//   its weight tile, so one warp's staging overlaps the others' MMAs. Split
//   values, tiles and sum order are the same in both cases, so a row's
//   logits do not depend on them.
// - Activations take 4 bytes an element in every mode: bf16 parts a1 and a2
//   in two arrays (kHigh; kDefault and kBf16 keep a1 only), or the f32 value
//   itself (kHighest), split into its three parts as each A fragment is
//   read, since three bf16 arrays would not fit.
// - Layers 0 and 1 are fused over 16 chunks of 64 h1 columns: the chunk's
//   h1 = relu(x @ W0[:, chunk] + b0) goes to shared memory, and h2 +=
//   h1_chunk @ W1[chunk, :] accumulates in registers (64 x 512 f32 over 8
//   warps: 128 a thread). h1 never leaves the SM.
// - h2 = relu(...) goes to shared memory over the first-layer inputs (or
//   slabs) and h1; layer 2 (512 -> 128) runs from there, and layers 3-4 in
//   f32.
// - Weights arrive as a stream of tiles of 16 KB a part (the mode's parts
//   one after the other) that ops/fused_mlp.pack_weights lays out once per
//   layers object, in exactly the order a block consumes them and in their
//   shared-memory layout, through a 96 KB ring of cp.async copies (6, 3 or
//   2 tiles deep at 1, 2 or 3 parts), so loads overlap the MMAs. Three
//   parts of today's 64 x 128 and 512 x 16 tiles take 48 KB, so kHighest
//   keeps those tiles and double-buffers them. Layers 0 and 2 take
//   64-output x 128-input tiles, a warp 16 rows x 32 outputs of each;
//   layer 1 takes 512-output x 16-input tiles, a warp 64 outputs for all 64
//   rows, so each B fragment is read once a block and a warp has 32
//   independent accumulators between barriers.
// - The bf16 activations' shared rows are padded by 16 bytes (the f32 rows
//   by 32, to 8 banks mod 32) and the weight tiles' 16-byte chunks
//   XOR-swizzled by row, so the rows a warp reads fall in distinct banks.
//
// First-layer rows are read through strides, so the same kernel serves the
// materialized window batch and the conv-fused path: row g of the batch
// starts at x + (g / rows_per_group) * group_stride + (g % rows_per_group) *
// row_stride and is d0 floats long. With x = the preprocessed frames
// (V, F * J * 3), row_stride = J * 3 and the layer-1 weights of
// ops/windows.layer1_conv_kernel reshaped to (W * J * 3, H), row g is the
// contiguous strip of W frames that window g reads: an implicit im2col, and
// the (V, N, W, J, C) window tensor never exists. (TMA cannot fetch these
// rows: their stride, 156 bytes for the lower body, is not a multiple of 16.)
//
// Every row runs the same code in a fixed order, full tile or ragged, with
// masks only at the loads and stores, and no sum crosses blocks: a row's
// logits do not depend on the batch or on the row's place in its tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Hidden widths the kernel is built for (models/contact_mlp.HIDDEN).
constexpr int kD1 = 1024, kD2 = 512, kD3 = 128, kD4 = 32;
constexpr int kD0Resident = 432;  // widest first layer whose split rows stay resident
constexpr int kD0Max = 768;       // six layer-0 tiles; `full` (675) is the widest joint set
constexpr int kD5Max = 32;

// The modes (ops/fused_mlp.MODES, in this order).
constexpr int kDefault = 0, kHigh = 1, kHighest = 2, kBf16 = 3;
constexpr int kModes = 4;

constexpr int kRows = 64;      // rows per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kNc = 64;        // h1 columns per chunk
constexpr int kChunks = kD1 / kNc;
constexpr int kTileN = 64, kTileK = 128;  // layers 0 and 2: 64 outputs x 128 inputs
constexpr int kKs1 = kNc / 16;            // layer-1 tiles per chunk: 512 outputs x 16 inputs
constexpr int kNt2 = kD3 / kTileN, kKt2 = kD2 / kTileK;  // layer-2 tiles
constexpr int kPartBytes = 16384;         // one part of a packed tile
constexpr int kRingBytes = 6 * kPartBytes;
constexpr int kPad = 8;                   // elements of padding per activation row
constexpr int kLdH1 = kNc + kPad;
constexpr int kLdH2 = kD2 + kPad;
constexpr int kLdH3 = kD3 + 4;  // f32
constexpr int kLdH4 = kD4 + 1;  // f32
constexpr int kLdSlab = kTileK + kPad;
constexpr int kSlabBytes = 4 * kRows * kLdSlab;  // one staged layer-0 tile of inputs

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
__host__ __device__ constexpr int tile_bytes(int m) { return parts(m) * kPartBytes; }
__host__ __device__ constexpr int stages(int m) { return kRingBytes / tile_bytes(m); }

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int ld_x(int d0) { return round16(d0) + kPad; }
__host__ __device__ constexpr int k_tiles0(int d0) { return (round16(d0) + kTileK - 1) / kTileK; }
__host__ __device__ constexpr int n_tiles(int d0) {
  return kChunks * (k_tiles0(d0) + kKs1) + kKt2 * kNt2;
}
__host__ __device__ constexpr bool slabs(int d0) { return d0 > kD0Resident; }
// Bytes of the first-layer inputs: all of them, or two slabs.
__host__ __device__ constexpr int x_bytes(int d0) {
  return slabs(d0) ? 2 * kSlabBytes : 4 * kRows * ld_x(d0);
}

// Bytes of the activation region: x and the h1 chunk, then h2 over them,
// then h3 and h4 in f32 over those. The weight ring follows.
__host__ __device__ constexpr int act_bytes(int d0) {
  return (imax(x_bytes(d0) + 4 * kRows * kLdH1,
               imax(4 * kRows * kLdH2, 4 * kRows * (kLdH3 + kLdH4))) + 127) & ~127;
}
__host__ __device__ constexpr int smem_bytes(int d0) { return act_bytes(d0) + kRingBytes; }

struct Tail {
  const float* b0;  // (kD1,)
  const float* b1;  // (kD2,)
  const float* b2;  // (kD3,)
  const float* w3;  // (kD3, kD4) row-major
  const float* b3;  // (kD4,)
  const float* w4;  // (kD4, d5) row-major
  const float* b4;  // (d5,)
  int d5;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as three bf16 pairs a1, a2, a3, each rounded to nearest even.
__device__ __forceinline__ void split3(float2 v, uint32_t& a1, uint32_t& a2, uint32_t& a3) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float rx = v.x - __low2float(h), ry = v.y - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  a1 = as_u32(h);
  a2 = as_u32(m);
  a3 = as_u32(__floats2bfloat162_rn(rx - __low2float(m), ry - __high2float(m)));
}

// A fragment parts: rows m0 .. m0 + 15, columns k0 .. k0 + 15 of the
// activations at `base` (ld elements a row): ldmatrix of each bf16 part
// array, or, for kHighest, the f32 values split in registers.
template <int M>
__device__ __forceinline__ void load_a(const unsigned char* base, int ld, int m0, int k0,
                                       int lane, uint32_t (&a)[parts(M)][4]) {
  if constexpr (M == kHighest) {
    const float* f = reinterpret_cast<const float*>(base);
    const int r = m0 + (lane >> 2), c = k0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(f + (r + 8 * (i & 1)) * ld + c +
                                                        8 * (i >> 1));
      split3(v, a[0][i], a[1][i], a[2][i]);
    }
  } else {
    const uint32_t s = smem_u32(base) + ((m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3)) * 2;
#pragma unroll
    for (int p = 0; p < parts(M); ++p) ldsm_x4(s + p * kRows * ld * 2, a[p]);
  }
}

// B fragments of four n8 tiles, outputs n0 .. n0 + 31 at inputs k0 .. k0 + 15,
// of one part of a 64 x 128 tile: (out, in) rows of 256 bytes, 16-byte
// chunk c of row n stored at chunk c ^ (n & 7).
__device__ __forceinline__ void load_b_k(uint32_t part, int n0, int k0, int lane,
                                         uint32_t (&b)[4][2]) {
  const int n = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = (k0 >> 3) + ((lane >> 3) & 1);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    ldsm_x4(part + (n + 16 * p) * 256 + ((c ^ (n & 7)) << 4), r);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
}

// B fragments of two n8 tiles, outputs n0 .. n0 + 15, of one part of a
// 512 x 16 tile: (out, in) rows of 32 bytes, chunk c of row n stored at
// chunk c ^ ((n >> 2) & 1).
__device__ __forceinline__ void load_b_n(uint32_t part, int n0, int lane,
                                         uint32_t (&b)[2][2]) {
  const int n = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = (lane >> 3) & 1;
  uint32_t r[4];
  ldsm_x4(part + n * 32 + ((c ^ ((n >> 2) & 1)) << 4), r);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// acc[j] += a * b_j over one k16 step, the mode's passes in a fixed order.
// A pass covers all the tiles before the next begins, so a tile's dependent
// MMAs are spread apart. The tensor cores round their f32 sums toward zero,
// about an ulp of the running sum per MMA, which over the hundreds of MMAs
// of a long accumulation is more than kHighest's f32-level accuracy allows;
// so kHighest (flushes(M)) sums each k16 step's six passes from zero and
// adds that to acc in IEEE f32.
__host__ __device__ constexpr bool flushes(int m) { return m == kHighest; }

template <int M, int NT>
__device__ __forceinline__ void mma_passes(float (&acc)[NT][4], const uint32_t (&a)[parts(M)][4],
                                           const uint32_t (&b)[parts(M)][NT][2]) {
  float t[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[j][e] = flushes(M) ? 0.f : acc[j][e];
#pragma unroll
  for (int q = 0; q < passes(M); ++q)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_bf16(t[j], a[pass_a(M, q)], b[pass_b(M, q)][j][0], b[pass_b(M, q)][j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = flushes(M) ? acc[j][e] + t[j][e] : t[j][e];
}

// Columns c, c + 1 of row r of the activations at `base` (ld elements a
// row) set to (x, y), in the mode's layout.
template <int M>
__device__ __forceinline__ void store_act(unsigned char* base, int ld, int r, int c, float x,
                                          float y) {
  if constexpr (M == kHighest) {
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(base) + r * ld + c) = make_float2(x, y);
  } else {
    bf16* hi = reinterpret_cast<bf16*>(base) + r * ld + c;
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    *reinterpret_cast<__nv_bfloat162*>(hi) = h;
    if constexpr (parts(M) == 2)
      *reinterpret_cast<__nv_bfloat162*>(hi + kRows * ld) =
          __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
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

template <int M>
__device__ __forceinline__ void init_acc(float (&v)[4], const float* b, int c) {
  v[0] = v[2] = acc0_of<M>(__ldg(b + c));
  v[1] = v[3] = acc0_of<M>(__ldg(b + c + 1));
}

// The layer's output of an accumulator fragment (rows r and r + 8, columns
// c and c + 1) stored as activations.
template <int M>
__device__ __forceinline__ void store_out(unsigned char* base, int ld, int r, int c,
                                          const float (&v)[4], const float* b) {
  const float b0 = __ldg(b + c), b1 = __ldg(b + c + 1);
  store_act<M>(base, ld, r, c, act<M>(v[0], b0), act<M>(v[1], b1));
  store_act<M>(base, ld, r + 8, c, act<M>(v[2], b0), act<M>(v[3], b1));
}

// Inputs c0 .. c0 + n - 1 (n even) of the block's rows, stored as
// activations at columns 0 .. n - 1; zero past d0 and for rows past the end
// of the batch. A warp takes rows warp, warp + 8, ..., and sends their loads
// together.
template <int M>
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           const long long* row_start, int c0, int n,
                                           int d0, unsigned char* base, int ld, int warp,
                                           int lane) {
  constexpr int kWarps = kThreads / 32, kRowsPerWarp = kRows / kWarps;
  long long start[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) start[i] = row_start[warp + kWarps * i];
  for (int c = 2 * lane; c < n; c += 64) {
    const int col = c0 + c;
    float v[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      v[i][0] = start[i] >= 0 && col < d0 ? x[start[i] + col] : 0.f;
      v[i][1] = start[i] >= 0 && col + 1 < d0 ? x[start[i] + col + 1] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      store_act<M>(base, ld, warp + kWarps * i, c, v[i][0], v[i][1]);
  }
}

// kSlabs: the first-layer inputs are staged a layer-0 tile at a time
// (d0 > kD0Resident); otherwise they stay resident. M: the mode.
template <bool kSlabs, int M>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_kernel(const float* __restrict__ x, long long n_rows,
                     long long rows_per_group, long long group_stride,
                     long long row_stride, int d0, const bf16* __restrict__ wpack,
                     Tail p, float* __restrict__ out) {
  constexpr int P = parts(M), kStages = stages(M), kTileBytes = tile_bytes(M);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long row_start[kRows];  // offset of each row in x; -1 past the end

  const int k0p = round16(d0), ldx = kSlabs ? kLdSlab : ld_x(d0), kt0 = k_tiles0(d0);
  const int tiles = n_tiles(d0);
  unsigned char* xs = smem;  // resident inputs, or slab 0 then slab 1
  unsigned char* h1 = smem + x_bytes(d0);
  unsigned char* h2 = smem;
  float* h3 = reinterpret_cast<float*>(smem);
  float* h4 = h3 + kRows * kLdH3;
  const uint32_t ring = smem_u32(smem + act_bytes(d0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 16;  // layers 0 and 2: the warp's 16 rows
  const int wn = (warp & 1) * 32;   // and 32 outputs of each 64-output tile
  const int w1n = warp * 64;        // layer 1: the warp's 64 outputs
  const int g = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)blockIdx.x * kRows;

  // Tile t of the stream into ring slot t % kStages; always one commit
  // group, empty past the end, so that the waits count uniformly.
  auto fetch = [&](int t) {
    if (t < tiles) {
      const char* src = reinterpret_cast<const char*>(wpack) + (size_t)t * kTileBytes;
      const uint32_t dst = ring + (t % kStages) * kTileBytes;
      for (int i = tid; i < kTileBytes / 16; i += kThreads) cp_async16(dst + i * 16, src + i * 16);
    }
    cp_async_commit();
  };
  // Waits for tile t, then refills the slot every warp has finished with;
  // returns the shared address of tile t.
  int t = 0;
  auto next = [&]() -> uint32_t {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(t + kStages - 1);
    return ring + (t++ % kStages) * kTileBytes;
  };

  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  // The block's first-layer rows, gathered through the strides and split
  // (all of them now, or a tile's slab at a time below).
  if (tid < kRows) {
    const long long gr = row0 + tid;
    row_start[tid] = gr < n_rows ? (gr / rows_per_group) * group_stride +
                                       (gr % rows_per_group) * row_stride
                                 : -1;
  }
  __syncthreads();
  if constexpr (!kSlabs) stage_rows<M>(x, row_start, 0, k0p, d0, xs, ldx, warp, lane);

  float acc2[4][8][4];  // [16-row group][n8 tile of the warp's 64 outputs]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j) init_acc<M>(acc2[mi][j], p.b1, w1n + j * 8 + 2 * tq);

#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    // Layer 0 for h1 columns c * 64 .. c * 64 + 63.
    float acc0[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) init_acc<M>(acc0[j], p.b0, c * kNc + wn + j * 8 + 2 * tq);
#pragma unroll 1
    for (int kt = 0; kt < kt0; ++kt) {
      const int kn = min(kTileK, k0p - kt * kTileK);  // inputs of this tile
      // The tile's inputs: columns k0 .. of rows ldx apart at tx. A slab is
      // written before the barrier in next(); the one it overwrites was last
      // read two tiles back, before the previous barrier.
      unsigned char* tx = kSlabs ? xs + ((c * kt0 + kt) & 1) * kSlabBytes : xs;
      const int k0 = kSlabs ? 0 : kt * kTileK;
      if constexpr (kSlabs) stage_rows<M>(x, row_start, kt * kTileK, kn, d0, tx, ldx, warp, lane);
      const uint32_t w = next();
      const int ksteps = kn / 16;
#pragma unroll
      for (int ks = 0; ks < kTileK / 16; ++ks) {
        if (ks < ksteps) {
          uint32_t a[P][4], b[P][4][2];
          load_a<M>(tx, ldx, wm, k0 + ks * 16, lane, a);
#pragma unroll
          for (int q = 0; q < P; ++q) load_b_k(w + q * kPartBytes, wn, ks * 16, lane, b[q]);
          mma_passes<M>(acc0, a, b);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_out<M>(h1, kLdH1, wm + g, wn + j * 8 + 2 * tq, acc0[j], p.b0 + c * kNc);
    __syncthreads();

    // Layer 1: h2 += h1 chunk @ W1[chunk rows, :], one 16-input tile at a
    // time; per 16-input step each accumulator takes the mode's passes.
#pragma unroll 1
    for (int ks = 0; ks < kKs1; ++ks) {
      const uint32_t w = next();
      uint32_t a[4][P][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) load_a<M>(h1, kLdH1, mi * 16, ks * 16, lane, a[mi]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[P][2][2];
#pragma unroll
        for (int q = 0; q < P; ++q) load_b_n(w + q * kPartBytes, w1n + np * 16, lane, b[q]);
        float t[4][2][4];  // the k16 step's sums (flushes(M)), or acc2 itself
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[mi][jj][e] = flushes(M) ? 0.f : acc2[mi][np * 2 + jj][e];
#pragma unroll
        for (int q = 0; q < passes(M); ++q)
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
              mma_bf16(t[mi][jj], a[mi][pass_a(M, q)], b[pass_b(M, q)][jj][0],
                       b[pass_b(M, q)][jj][1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc2[mi][np * 2 + jj][e] =
                  flushes(M) ? acc2[mi][np * 2 + jj][e] + t[mi][jj][e] : t[mi][jj][e];
      }
    }
  }

  // h2 = relu(...) over x and h1, once every warp is done with h1.
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store_out<M>(h2, kLdH2, mi * 16 + g, w1n + j * 8 + 2 * tq, acc2[mi][j], p.b1);

  // Layer 2 (512 -> 128), tiles k-major.
  float acc3[kNt2][4][4];
#pragma unroll
  for (int nt = 0; nt < kNt2; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) init_acc<M>(acc3[nt][j], p.b2, nt * kTileN + wn + j * 8 + 2 * tq);
#pragma unroll 1
  for (int kt = 0; kt < kKt2; ++kt) {
#pragma unroll
    for (int nt = 0; nt < kNt2; ++nt) {
      const uint32_t w = next();
#pragma unroll
      for (int ks = 0; ks < kTileK / 16; ++ks) {
        uint32_t a[P][4], b[P][4][2];
        load_a<M>(h2, kLdH2, wm, kt * kTileK + ks * 16, lane, a);
#pragma unroll
        for (int q = 0; q < P; ++q) load_b_k(w + q * kPartBytes, wn, ks * 16, lane, b[q]);
        mma_passes<M>(acc3[nt], a, b);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncthreads();     // every warp is done with h2 and the ring

  // h3 = relu(...) in f32; layers 3 and 4 on CUDA cores, each output
  // bias + sum over k in ascending order (kBf16: the sum, rounded, + the
  // bias, rounded), their weights staged in the ring.
  float* w3s = reinterpret_cast<float*>(smem + act_bytes(d0));  // (kD3, kD4)
  float* w4s = w3s + kD3 * kD4;                                // (kD4, d5)
  float* b3s = w4s + kD4 * kD5Max;
  float* b4s = b3s + kD4;
  for (int i = tid; i < kD3 * kD4; i += kThreads) w3s[i] = __ldg(p.w3 + i);
  for (int i = tid; i < kD4 * p.d5; i += kThreads) w4s[i] = __ldg(p.w4 + i);
  if (tid < kD4) b3s[tid] = __ldg(p.b3 + tid);
  if (tid < p.d5) b4s[tid] = __ldg(p.b4 + tid);
#pragma unroll
  for (int nt = 0; nt < kNt2; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = nt * kTileN + wn + j * 8 + 2 * tq;
      const float b0 = __ldg(p.b2 + col), b1 = __ldg(p.b2 + col + 1);
      *reinterpret_cast<float2*>(h3 + (wm + g) * kLdH3 + col) =
          make_float2(act<M>(acc3[nt][j][0], b0), act<M>(acc3[nt][j][1], b1));
      *reinterpret_cast<float2*>(h3 + (wm + g + 8) * kLdH3 + col) =
          make_float2(act<M>(acc3[nt][j][2], b0), act<M>(acc3[nt][j][3], b1));
    }
  __syncthreads();

  const int r = tid >> 2, n0 = (tid & 3) * 8;  // a row, and 8 of its outputs
  {
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = acc0_of<M>(b3s[n0 + j]);
#pragma unroll 4
    for (int k = 0; k < kD3; ++k) {
      const float h = h3[r * kLdH3 + k];
      const float4 wa = *reinterpret_cast<const float4*>(w3s + k * kD4 + n0);
      const float4 wb = *reinterpret_cast<const float4*>(w3s + k * kD4 + n0 + 4);
      a[0] = fmaf(h, wa.x, a[0]);
      a[1] = fmaf(h, wa.y, a[1]);
      a[2] = fmaf(h, wa.z, a[2]);
      a[3] = fmaf(h, wa.w, a[3]);
      a[4] = fmaf(h, wb.x, a[4]);
      a[5] = fmaf(h, wb.y, a[5]);
      a[6] = fmaf(h, wb.z, a[6]);
      a[7] = fmaf(h, wb.w, a[7]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) h4[r * kLdH4 + n0 + j] = act<M>(a[j], b3s[n0 + j]);
  }
  __syncthreads();

  const long long gr = row0 + r;
  if (gr < n_rows) {
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j;
      if (n >= p.d5) break;
      float a = acc0_of<M>(b4s[n]);
#pragma unroll 8
      for (int k = 0; k < kD4; ++k) a = fmaf(h4[r * kLdH4 + k], w4s[k * p.d5 + n], a);
      out[gr * p.d5 + n] = M == kBf16 ? bf16r(bf16r(a) + b4s[n]) : a;
    }
  }
}

typedef void (*KernelFn)(const float*, long long, long long, long long, long long, int,
                         const bf16*, Tail, float*);

template <int M>
KernelFn kernel_for(int d0) {
  return slabs(d0) ? fused_mlp_kernel<true, M> : fused_mlp_kernel<false, M>;
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for a d0-wide first layer.
int chd_fused_mlp_smem_bytes(int d0) { return smem_bytes(d0); }

// Tiles in the packed weight stream for a d0-wide first layer.
int chd_fused_mlp_tiles(int d0) { return n_tiles(d0); }

// bf16 parts of each packed weight tile in a mode (0 for an unknown mode).
int chd_fused_mlp_parts(int mode) { return mode >= 0 && mode < kModes ? parts(mode) : 0; }

// logits (n_rows, d5) of the folded MLP on the strided rows of x, with the
// widths d0 -> 1024 -> 512 -> 128 -> 32 -> d5, in `mode` (kDefault, kHigh,
// kHighest, kBf16). wpack is the bf16 tile stream of layers 0-2 with the
// mode's parts (ops/fused_mlp.pack_weights); w3 and w4 are f32 (in, out).
// Launches on `stream` and returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for widths or a mode the kernel does not
// take).
int chd_fused_mlp_forward(const float* x, long long n_rows,
                          long long rows_per_group, long long group_stride,
                          long long row_stride, int d0, const void* wpack,
                          const float* b0, const float* b1, const float* b2,
                          const float* w3, const float* b3, const float* w4,
                          const float* b4, int d5, int mode, float* out, void* stream) {
  if (d0 < 1 || d0 > kD0Max || d5 < 1 || d5 > kD5Max) return (int)cudaErrorInvalidValue;
  KernelFn kernel;
  switch (mode) {
    case kDefault: kernel = kernel_for<kDefault>(d0); break;
    case kHigh: kernel = kernel_for<kHigh>(d0); break;
    case kHighest: kernel = kernel_for<kHighest>(d0); break;
    case kBf16: kernel = kernel_for<kBf16>(d0); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const Tail p = {b0, b1, b2, w3, b3, w4, b4, d5};
  const int smem = smem_bytes(d0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows + kRows - 1) / kRows;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, n_rows, rows_per_group, group_stride, row_stride, d0,
      static_cast<const bf16*>(wpack), p, out);
  return (int)cudaGetLastError();
}

const char* chd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
