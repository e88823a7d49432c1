// Fused, BN-folded contact MLP (5 layers) for Hopper, f32 on CUDA cores.
//
// Replaces chd_tpu/ops/pallas_mlp.py::_kernel, which runs the whole folded
// MLP (351 -> 1024 -> 512 -> 128 -> 32 -> 20, ReLU after the first four
// layers) as one Pallas kernel per 256-row batch tile with every weight
// resident in VMEM.
//
// What bounds it here: the weights are 3.8 MB of f32 and a block has at
// most 227 KB of shared memory, so they cannot stay resident. Each block
// takes a tile of kTile rows, keeps the tile's activations in shared memory
// (two ping-pong buffers, 1024 + 512 floats wide at the contact model's
// widths: 192 KB at kTile = 32), and streams every weight element from L2
// (50 MB, which holds all of them) once per tile rather than once per row.
// That is 3.8 MB of L2 weight traffic per 32 rows: 14 GB for the 118,784
// windows of 512 videos x 240 frames, a few ms at L2 rates. The (in, out)
// weight layout makes those reads coalesced across a warp, and each weight
// element read feeds kTile FMAs, so the other bound is the FP32 pipe fed
// from shared memory: 113 G FMA for those windows, 3.4 ms at the card's
// 67 TFLOP/s FP32 peak. One 512-thread block fits on an SM; larger row
// tiles, bf16 storage and tensor cores are the ways past both bounds.
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
// Full f32 with fmaf, no TF32 and no tensor cores. Each output is
// bias + sum over k in ascending order, so a row's result does not depend on
// the batch size or on the row's position in its tile.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // rows (windows) per block
constexpr int kThreads = 512;  // one output column per thread per pass
constexpr int kLayers = 5;

struct MlpWeights {
  const float* w[kLayers];  // layer i: (dims[i], dims[i + 1]) row-major
  const float* b[kLayers];  // layer i: (dims[i + 1],)
  int dims[kLayers + 1];
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

constexpr int imax(int a, int b) { return a > b ? a : b; }

// Floats per row of the two ping-pong buffers: A holds the inputs of layers
// 0, 2 and 4, B their outputs (and the logits).
constexpr int ld_a_of(int d0, int d2, int d4) {
  return imax(round4(d0), imax(round4(d2), round4(d4)));
}
constexpr int ld_b_of(int d1, int d3, int d5) {
  return imax(round4(d1), imax(round4(d3), d5));
}

// out[r, n] = act(b[n] + sum_k in[r, k] * w[k, n]) for the kTile rows of the
// tile. `in` and `out` live in shared memory with leading dimensions ld_in
// and ld_out; ld_in is a multiple of 4 so rows are float4-aligned.
__device__ __forceinline__ void dense_layer(const float* __restrict__ in,
                                            int ld_in, int K,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b, int N,
                                            float* __restrict__ out, int ld_out,
                                            bool relu) {
  const int K4 = K & ~3;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc[kTile];
    const float bias = __ldg(b + n);
#pragma unroll
    for (int r = 0; r < kTile; ++r) acc[r] = bias;
#pragma unroll 2
    for (int k = 0; k < K4; k += 4) {
      const float w0 = __ldg(w + (size_t)k * N + n);
      const float w1 = __ldg(w + (size_t)(k + 1) * N + n);
      const float w2 = __ldg(w + (size_t)(k + 2) * N + n);
      const float w3 = __ldg(w + (size_t)(k + 3) * N + n);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(in + r * ld_in + k);
        acc[r] = fmaf(a.x, w0, acc[r]);
        acc[r] = fmaf(a.y, w1, acc[r]);
        acc[r] = fmaf(a.z, w2, acc[r]);
        acc[r] = fmaf(a.w, w3, acc[r]);
      }
    }
    for (int k = K4; k < K; ++k) {
      const float wk = __ldg(w + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] = fmaf(in[r * ld_in + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      out[r * ld_out + n] = relu ? fmaxf(acc[r], 0.f) : acc[r];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_kernel(const float* __restrict__ x, long long n_rows,
                     long long rows_per_group, long long group_stride,
                     long long row_stride, MlpWeights p, int ld_a,
                     float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* buf_a = reinterpret_cast<float*>(smem4);
  float* buf_b = buf_a + kTile * ld_a;
  const long long row0 = (long long)blockIdx.x * kTile;

  // The tile's first-layer rows, gathered through the strides; rows past
  // the end of the batch are zero and never written out.
  const int d0 = p.dims[0];
  const int ld0 = round4(d0);
  for (int i = threadIdx.x; i < kTile * d0; i += blockDim.x) {
    const int r = i / d0;
    const int c = i - r * d0;
    const long long g = row0 + r;
    float v = 0.f;
    if (g < n_rows) {
      const long long grp = g / rows_per_group;
      const long long n = g - grp * rows_per_group;
      v = x[grp * group_stride + n * row_stride + c];
    }
    buf_a[r * ld0 + c] = v;
  }
  __syncthreads();

  // Ping-pong: A -> B -> A -> B -> A -> B.
  float* src = buf_a;
  float* dst = buf_b;
  int ld_in = ld0;
  for (int l = 0; l < kLayers; ++l) {
    const bool last = l == kLayers - 1;
    const int ld_out = last ? p.dims[l + 1] : round4(p.dims[l + 1]);
    dense_layer(src, ld_in, p.dims[l], p.w[l], p.b[l], p.dims[l + 1], dst,
                ld_out, !last);
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
    ld_in = ld_out;
  }

  // src now holds the (kTile, d5) logits.
  const int d5 = p.dims[kLayers];
  for (int i = threadIdx.x; i < kTile * d5; i += blockDim.x) {
    const long long g = row0 + i / d5;
    if (g < n_rows) out[row0 * d5 + i] = src[i];
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at these widths.
int chd_fused_mlp_smem_bytes(int d0, int d1, int d2, int d3, int d4, int d5) {
  return kTile * (ld_a_of(d0, d2, d4) + ld_b_of(d1, d3, d5)) *
         (int)sizeof(float);
}

// logits (n_rows, d5) of the folded MLP on the strided rows of x. Launches
// on `stream` and returns the CUDA error of the launch (0 on success).
int chd_fused_mlp_forward(const float* x, long long n_rows,
                          long long rows_per_group, long long group_stride,
                          long long row_stride, const float* w0,
                          const float* b0, const float* w1, const float* b1,
                          const float* w2, const float* b2, const float* w3,
                          const float* b3, const float* w4, const float* b4,
                          int d0, int d1, int d2, int d3, int d4, int d5,
                          float* out, void* stream) {
  MlpWeights p = {{w0, w1, w2, w3, w4}, {b0, b1, b2, b3, b4},
                  {d0, d1, d2, d3, d4, d5}};
  const int ld_a = ld_a_of(d0, d2, d4);
  const int smem = chd_fused_mlp_smem_bytes(d0, d1, d2, d3, d4, d5);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows + kTile - 1) / kTile;
  fused_mlp_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, n_rows, rows_per_group, group_stride, row_stride, p, ld_a, out);
  return (int)cudaGetLastError();
}

const char* chd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
