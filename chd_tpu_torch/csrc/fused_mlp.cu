// Fused, BN-folded contact MLP (5 layers) for Hopper, on tensor cores in a
// 3-pass bf16 split.
//
// Replaces chd_tpu/ops/pallas_mlp.py::_kernel, which runs the whole folded
// MLP (351 -> 1024 -> 512 -> 128 -> 32 -> 20, ReLU after the first four
// layers) as one Pallas kernel per 256-row batch tile with every weight
// resident in VMEM. chd_tpu runs its contact matmuls at precision="high":
// each f32 operand a is split into a_hi = bf16(a) and a_lo = bf16(a - a_hi)
// (round to nearest even), and a*b is taken as a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi with f32 sums. This kernel computes the same for layers 0-2
// (99 % of the 954 k multiply-adds of a row) with
// mma.sync.m16n8k16.bf16 and f32 accumulators; layers 3 and 4 run in f32 on
// CUDA cores. ops/fused_mlp.fused_mlp_split_plain is the same arithmetic in
// plain torch.
//
// What bounds it: the three passes are 3 x 226.6 GFLOP for the 118,784
// windows of 512 videos x 240 frames, 0.69 ms at the card's 989 TFLOP/s
// bf16 peak, which only wgmma reaches; with mma.sync every operand also
// passes from shared memory through registers (ldmatrix). On the card,
// without any MMA the kernel keeps two thirds of its time (operand loads,
// barriers, staging), and without the weight copies nearly all of it. The
// 3.9 MB of split weights (a bf16 hi/lo pair is 4 bytes, as one f32 is) do
// not fit in a block's 227 KB of shared memory, so every row tile streams
// all of them from L2 (50 MB, which holds them): 7.3 GB per call, hidden
// behind the rest. A 64-row tile is as many rows as the split activations
// leave room for; larger tiles need weights shared across a cluster (TMA
// multicast).
//
// The design:
// - A block takes kRows = 64 rows. It gathers their first-layer inputs
//   through the strides, splits them into bf16 hi and lo, and keeps them in
//   shared memory for the whole block, for a first layer up to kD0Resident
//   = 432 wide (every joint set but `full`). Wider rows (`full`, 675) do not
//   fit beside the h1 chunk and the weight ring: the block then stages, for
//   each layer-0 tile of each chunk, only that tile's 128 inputs of its rows,
//   split, into one of two slab buffers, and re-reads them through the
//   strides each chunk (L2 holds them). The tile's inputs are staged before
//   the barrier that hands out its weight tile, so one warp's staging
//   overlaps the others' MMAs. Split values, tiles and sum order are the
//   same in both modes, so a row's logits do not depend on the mode.
// - Layers 0 and 1 are fused over 16 chunks of 64 h1 columns: the chunk's
//   h1 = relu(x @ W0[:, chunk] + b0) goes to shared memory, split, and
//   h2 += h1_chunk @ W1[chunk, :] accumulates in registers (64 x 512 f32
//   over 8 warps: 128 a thread). h1 never leaves the SM.
// - h2 = relu(...) goes to shared memory, split, over the first-layer
//   inputs (or slabs) and h1; layer 2 (512 -> 128) runs from there, and
//   layers 3-4 in f32.
// - Weights arrive as a stream of 32 KB tiles (hi then lo) that
//   ops/fused_mlp.pack_weights lays out once per layers object, in exactly
//   the order a block consumes them and in their shared-memory layout,
//   through a kStages-deep ring of cp.async copies, so loads overlap the
//   MMAs. Layers 0 and 2 take 64-output x 128-input tiles, a warp 16 rows
//   x 32 outputs of each; layer 1 takes 512-output x 16-input tiles, a warp
//   64 outputs for all 64 rows, so each B fragment is read once a block and
//   a warp has 32 independent accumulators between barriers.
// - The activations' shared rows are padded by 16 bytes and the weight
//   tiles' 16-byte chunks XOR-swizzled by row, so the 8 rows an ldmatrix
//   reads fall in 8 distinct bank groups.
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

constexpr int kRows = 64;      // rows per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kNc = 64;        // h1 columns per chunk
constexpr int kChunks = kD1 / kNc;
constexpr int kTileN = 64, kTileK = 128;  // layers 0 and 2: 64 outputs x 128 inputs
constexpr int kKs1 = kNc / 16;            // layer-1 tiles per chunk: 512 outputs x 16 inputs
constexpr int kNt2 = kD3 / kTileN, kKt2 = kD2 / kTileK;  // layer-2 tiles
constexpr int kTileBytes = 32768;         // one packed tile: hi, then lo
constexpr int kHalfBytes = kTileBytes / 2;
constexpr int kStages = 3;                // tiles in the shared ring
constexpr int kPad = 8;                   // bf16 of padding per activation row
constexpr int kLdH1 = kNc + kPad;
constexpr int kLdH2 = kD2 + kPad;
constexpr int kLdH3 = kD3 + 4;  // f32
constexpr int kLdH4 = kD4 + 1;  // f32
constexpr int kLdSlab = kTileK + kPad;
constexpr int kSlabBytes = 4 * kRows * kLdSlab;  // one staged layer-0 tile of inputs, hi and lo

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int ld_x(int d0) { return round16(d0) + kPad; }
__host__ __device__ constexpr int k_tiles0(int d0) { return (round16(d0) + kTileK - 1) / kTileK; }
__host__ __device__ constexpr int n_tiles(int d0) {
  return kChunks * (k_tiles0(d0) + kKs1) + kKt2 * kNt2;
}
__host__ __device__ constexpr bool slabs(int d0) { return d0 > kD0Resident; }
// Bytes of the split first-layer inputs: all of them, or two slabs.
__host__ __device__ constexpr int x_bytes(int d0) {
  return slabs(d0) ? 2 * kSlabBytes : 4 * kRows * ld_x(d0);
}

// Bytes of the activation region: split x and the h1 chunk, then split h2
// over them, then h3 and h4 in f32 over those. The weight ring follows.
__host__ __device__ constexpr int act_bytes(int d0) {
  return (imax(x_bytes(d0) + 4 * kRows * kLdH1,
               imax(4 * kRows * kLdH2, 4 * kRows * (kLdH3 + kLdH4))) + 127) & ~127;
}
__host__ __device__ constexpr int smem_bytes(int d0) {
  return act_bytes(d0) + kStages * kTileBytes;
}

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

// A fragment: rows m0 .. m0 + 15, columns k0 .. k0 + 15 of a row-major bf16
// array at shared address `base` with `ld` elements per row.
__device__ __forceinline__ void load_a(uint32_t base, int ld, int m0, int k0,
                                       int lane, uint32_t (&a)[4]) {
  ldsm_x4(base + ((m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3)) * 2, a);
}

// B fragments of four n8 tiles, outputs n0 .. n0 + 31 at inputs k0 .. k0 + 15,
// of one half (hi or lo) of a 64 x 128 tile: (out, in) rows of 256 bytes,
// 16-byte chunk c of row n stored at chunk c ^ (n & 7).
__device__ __forceinline__ void load_b_k(uint32_t half, int n0, int k0, int lane,
                                         uint32_t (&b)[4][2]) {
  const int n = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = (k0 >> 3) + ((lane >> 3) & 1);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r[4];
    ldsm_x4(half + (n + 16 * p) * 256 + ((c ^ (n & 7)) << 4), r);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
}

// B fragments of two n8 tiles, outputs n0 .. n0 + 15, of one half of a
// 512 x 16 tile: (out, in) rows of 32 bytes, chunk c of row n stored at
// chunk c ^ ((n >> 2) & 1).
__device__ __forceinline__ void load_b_n(uint32_t half, int n0, int lane,
                                         uint32_t (&b)[2][2]) {
  const int n = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = (lane >> 3) & 1;
  uint32_t r[4];
  ldsm_x4(half + n * 32 + ((c ^ ((n >> 2) & 1)) << 4), r);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// acc[j] += a * b_j over one k16 step, in three bf16 passes in a fixed
// order: lo*hi, hi*lo, hi*hi. A pass covers all four tiles before the next
// begins, so a tile's three dependent MMAs are spread apart.
__device__ __forceinline__ void mma3(float (&acc)[4][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[4][2],
                                     const uint32_t (&bl)[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_bf16(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_bf16(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma_bf16(acc[j], ah, bh[j][0], bh[j][1]);
}

// (x, y) split into bf16 hi and lo pairs, each rounded to nearest even.
__device__ __forceinline__ void split2(float x, float y, bf16* hi, bf16* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
}

// relu of an accumulator fragment (rows r and r + 8, columns c and c + 1),
// split into the hi and lo arrays.
__device__ __forceinline__ void store_split_relu(bf16* hi, bf16* lo, int ld, int r,
                                                 int c, const float (&v)[4]) {
  split2(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f), hi + r * ld + c, lo + r * ld + c);
  split2(fmaxf(v[2], 0.f), fmaxf(v[3], 0.f), hi + (r + 8) * ld + c, lo + (r + 8) * ld + c);
}

__device__ __forceinline__ void init_bias(float (&v)[4], const float* b, int c) {
  v[0] = v[2] = __ldg(b + c);
  v[1] = v[3] = __ldg(b + c + 1);
}

// Inputs c0 .. c0 + n - 1 (n even) of the block's rows, split into hi and
// lo at columns 0 .. n - 1 of rows ld elements apart; zero past d0 and for
// rows past the end of the batch. A warp takes rows warp, warp + 8, ...,
// and sends their loads together.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           const long long* row_start, int c0, int n,
                                           int d0, bf16* hi, bf16* lo, int ld,
                                           int warp, int lane) {
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
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      split2(v[i][0], v[i][1], hi + r * ld + c, lo + r * ld + c);
    }
  }
}

// kSlabs: the first-layer inputs are staged a layer-0 tile at a time
// (d0 > kD0Resident); otherwise they stay resident.
template <bool kSlabs>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_kernel(const float* __restrict__ x, long long n_rows,
                     long long rows_per_group, long long group_stride,
                     long long row_stride, int d0, const bf16* __restrict__ wpack,
                     Tail p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long row_start[kRows];  // offset of each row in x; -1 past the end

  const int k0p = round16(d0), ldx = kSlabs ? kLdSlab : ld_x(d0), kt0 = k_tiles0(d0);
  const int tiles = n_tiles(d0);
  bf16* xh = reinterpret_cast<bf16*>(smem);  // resident inputs, or slab 0 then slab 1
  bf16* h1h = reinterpret_cast<bf16*>(smem + x_bytes(d0));
  bf16* h1l = h1h + kRows * kLdH1;
  bf16* h2h = reinterpret_cast<bf16*>(smem);
  bf16* h2l = h2h + kRows * kLdH2;
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
  if constexpr (!kSlabs) stage_rows(x, row_start, 0, k0p, d0, xh, xh + kRows * ldx, ldx, warp, lane);

  const uint32_t sh1h = smem_u32(h1h), sh1l = smem_u32(h1l);

  float acc2[4][8][4];  // [16-row group][n8 tile of the warp's 64 outputs]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j) init_bias(acc2[mi][j], p.b1, w1n + j * 8 + 2 * tq);

#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    // Layer 0 for h1 columns c * 64 .. c * 64 + 63.
    float acc0[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) init_bias(acc0[j], p.b0, c * kNc + wn + j * 8 + 2 * tq);
#pragma unroll 1
    for (int kt = 0; kt < kt0; ++kt) {
      const int kn = min(kTileK, k0p - kt * kTileK);  // inputs of this tile
      // The tile's split inputs: columns k0 .. of rows ldx apart at sxh, sxl.
      // A slab is written before the barrier in next(); the one it
      // overwrites was last read two tiles back, before the previous barrier.
      bf16* th = kSlabs ? xh + ((c * kt0 + kt) & 1) * (kSlabBytes / 2) : xh;
      const int k0 = kSlabs ? 0 : kt * kTileK;
      if constexpr (kSlabs)
        stage_rows(x, row_start, kt * kTileK, kn, d0, th, th + kRows * ldx, ldx, warp, lane);
      const uint32_t sxh = smem_u32(th), sxl = smem_u32(th + kRows * ldx);
      const uint32_t w = next();
      const int ksteps = kn / 16;
#pragma unroll
      for (int ks = 0; ks < kTileK / 16; ++ks) {
        if (ks < ksteps) {
          uint32_t ah[4], al[4], bh[4][2], bl[4][2];
          load_a(sxh, ldx, wm, k0 + ks * 16, lane, ah);
          load_a(sxl, ldx, wm, k0 + ks * 16, lane, al);
          load_b_k(w, wn, ks * 16, lane, bh);
          load_b_k(w + kHalfBytes, wn, ks * 16, lane, bl);
          mma3(acc0, ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_split_relu(h1h, h1l, kLdH1, wm + g, wn + j * 8 + 2 * tq, acc0[j]);
    __syncthreads();

    // Layer 1: h2 += h1 chunk @ W1[chunk rows, :], one 16-input tile at a
    // time; per 16-input step each accumulator takes lo*hi, hi*lo, hi*hi.
#pragma unroll 1
    for (int ks = 0; ks < kKs1; ++ks) {
      const uint32_t w = next();
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        load_a(sh1h, kLdH1, mi * 16, ks * 16, lane, ah[mi]);
        load_a(sh1l, kLdH1, mi * 16, ks * 16, lane, al[mi]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bh[2][2], bl[2][2];
        load_b_n(w, w1n + np * 16, lane, bh);
        load_b_n(w + kHalfBytes, w1n + np * 16, lane, bl);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) mma_bf16(acc2[mi][np * 2 + jj], al[mi], bh[jj][0], bh[jj][1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) mma_bf16(acc2[mi][np * 2 + jj], ah[mi], bl[jj][0], bl[jj][1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) mma_bf16(acc2[mi][np * 2 + jj], ah[mi], bh[jj][0], bh[jj][1]);
      }
    }
  }

  // h2 = relu(...), split, over x and h1, once every warp is done with h1.
  __syncthreads();
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store_split_relu(h2h, h2l, kLdH2, mi * 16 + g, w1n + j * 8 + 2 * tq, acc2[mi][j]);

  // Layer 2 (512 -> 128), tiles k-major.
  const uint32_t sh2h = smem_u32(h2h), sh2l = smem_u32(h2l);
  float acc3[kNt2][4][4];
#pragma unroll
  for (int nt = 0; nt < kNt2; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) init_bias(acc3[nt][j], p.b2, nt * kTileN + wn + j * 8 + 2 * tq);
#pragma unroll 1
  for (int kt = 0; kt < kKt2; ++kt) {
#pragma unroll
    for (int nt = 0; nt < kNt2; ++nt) {
      const uint32_t w = next();
#pragma unroll
      for (int ks = 0; ks < kTileK / 16; ++ks) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        load_a(sh2h, kLdH2, wm, kt * kTileK + ks * 16, lane, ah);
        load_a(sh2l, kLdH2, wm, kt * kTileK + ks * 16, lane, al);
        load_b_k(w, wn, ks * 16, lane, bh);
        load_b_k(w + kHalfBytes, wn, ks * 16, lane, bl);
        mma3(acc3[nt], ah, al, bh, bl);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncthreads();     // every warp is done with h2 and the ring

  // h3 = relu(...) in f32; layers 3 and 4 on CUDA cores, each output
  // bias + sum over k in ascending order, their weights staged in the ring.
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
      *reinterpret_cast<float2*>(h3 + (wm + g) * kLdH3 + col) =
          make_float2(fmaxf(acc3[nt][j][0], 0.f), fmaxf(acc3[nt][j][1], 0.f));
      *reinterpret_cast<float2*>(h3 + (wm + g + 8) * kLdH3 + col) =
          make_float2(fmaxf(acc3[nt][j][2], 0.f), fmaxf(acc3[nt][j][3], 0.f));
    }
  __syncthreads();

  const int r = tid >> 2, n0 = (tid & 3) * 8;  // a row, and 8 of its outputs
  {
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = b3s[n0 + j];
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
    for (int j = 0; j < 8; ++j) h4[r * kLdH4 + n0 + j] = fmaxf(a[j], 0.f);
  }
  __syncthreads();

  const long long gr = row0 + r;
  if (gr < n_rows) {
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j;
      if (n >= p.d5) break;
      float a = b4s[n];
#pragma unroll 8
      for (int k = 0; k < kD4; ++k) a = fmaf(h4[r * kLdH4 + k], w4s[k * p.d5 + n], a);
      out[gr * p.d5 + n] = a;
    }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for a d0-wide first layer.
int chd_fused_mlp_smem_bytes(int d0) { return smem_bytes(d0); }

// Tiles in the packed weight stream for a d0-wide first layer.
int chd_fused_mlp_tiles(int d0) { return n_tiles(d0); }

// logits (n_rows, d5) of the folded MLP on the strided rows of x, with the
// widths d0 -> 1024 -> 512 -> 128 -> 32 -> d5. wpack is the bf16 tile
// stream of layers 0-2 (ops/fused_mlp.pack_weights); w3 and w4 are f32
// (in, out). Launches on `stream` and returns the CUDA error of the launch
// (0 on success; cudaErrorInvalidValue for widths the kernel does not take).
int chd_fused_mlp_forward(const float* x, long long n_rows,
                          long long rows_per_group, long long group_stride,
                          long long row_stride, int d0, const void* wpack,
                          const float* b0, const float* b1, const float* b2,
                          const float* w3, const float* b3, const float* w4,
                          const float* b4, int d5, float* out, void* stream) {
  if (d0 < 1 || d0 > kD0Max || d5 < 1 || d5 > kD5Max) return (int)cudaErrorInvalidValue;
  const Tail p = {b0, b1, b2, w3, b3, w4, b4, d5};
  const int smem = smem_bytes(d0);
  const auto kernel = slabs(d0) ? fused_mlp_kernel<true> : fused_mlp_kernel<false>;
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
