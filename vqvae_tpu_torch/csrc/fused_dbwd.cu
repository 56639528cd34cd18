// The discriminator's fused backward on Hopper (sm_90a): kernels B3 and B4.
//
// B3 replaces vqvae_tpu/ops/fused_dbwd.py::blur_t_gate_pallas (body
// _make_kernel). For each DiscriminatorBlock, the cotangent dY of the blurred
// tensor (B, C, H+1, W+1) goes back through the [1,3,3,1]/8 FIR (pads 2) and
// conv0's bias + lrelu:
//     dP0[i, j] = gate(P0 + b0) * sum_{s,t} f[s] f[t] dY[i-1+s, j-1+t]
//     db0[c]    = sum over (b, i, j) of dP0
// with gate = gain where (P0 + b0), summed in P0's dtype, is >= 0, else
// gain * alpha (a NaN takes the alpha branch, as the plain version's where).
// A block owns a 32 x 32 output tile of one (b, c) plane: it stages the tile's
// dY with a 3-row, 3-column halo in shared memory, runs the vertical 4-tap
// pass, then the horizontal one, in fp32, applies the gate and writes dP0 in
// P0's dtype. Its fp32 sum of the tile's unrounded dP0 goes to a scratch slot
// of its own; a second launch adds each channel's slots in a fixed order in
// float64. No atomics, so db0 has the same bits on every run.
//
// B4 replaces fused_dbwd.py::skip_fanout_bwd_pallas (body _make_skip_kernel):
//     out = dC + up2_blur_T(dYs)
// the adjoint of the skip path's down-2 FIR (pads 1) plus the fan-out add. By
// the parity of its row, an output pixel reads two rows of dYs: an even row
// 2m takes taps (f0, f2) of rows m-1 and m, an odd row 2m+1 taps (f1, f3) of
// rows m and m+1; columns likewise. Rows and columns outside dYs are 0, so any
// H and W work (dYs is floor(H/2) x floor(W/2), as the forward makes it). One
// thread per output, the sum in fp32, rounded once to dC's dtype.
//
// What bounds them: bytes. At the D's first block (C 128, 256^2) and batch
// 32 in fp32, B3 reads dY and P0 and writes dP0, 3.2 GB, >= 0.96 ms at
// 3.35 TB/s; its ~19 flops per element are 0.08 ms at 67 TFLOP/s. B4 moves
// 2.4 GB (>= 0.72 ms). bf16 halves both. b0 is always fp32. This is the
// simple version: B3 re-reads its halo (about 20% more dY traffic at 32 x 32
// tiles) and wastes threads on planes narrower than 32; B4 reads each dYs
// value from L1/L2 once per output pixel it feeds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TW = 32;                 // tile width = threads in x
constexpr int TH = 32;                 // B3 tile height
constexpr int TY = 8;                  // threads in y
constexpr int THREADS = TW * TY;
constexpr int SUM_THREADS = 256;       // db0's fixed-order channel sum
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// p0 + b0 in p0's dtype: b0 cast to it first, then one rounded add, as the
// forward's bias_act adds them.
__device__ __forceinline__ float add_in_dtype(float p, float b, const float*) { return p + b; }
__device__ __forceinline__ float add_in_dtype(float p, float b, const __nv_bfloat16*) {
  const float bb = __bfloat162float(__float2bfloat16_rn(b));
  return __bfloat162float(__float2bfloat16_rn(p + bb));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blur_t_gate_kernel(const T* __restrict__ dy, const T* __restrict__ p0,
                   const float* __restrict__ b0, T* __restrict__ dp0,
                   float* __restrict__ partial, int C, int H, int W, int tiles_w,
                   float t0, float t1, float t2, float t3, float alpha, float gain) {
  __shared__ float g[TH + 3][TW + 3];  // dY rows r0-1 .. r0+TH+1, cols c0-1 .. c0+TW+1
  __shared__ float v[TH][TW + 3];      // after the vertical pass
  __shared__ float warp_sum[THREADS / 32];

  const int plane = blockIdx.x;        // b * C + c
  const int c = plane % C;
  const int b = plane / C;
  const int tile = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int r0 = (tile / tiles_w) * TH;
  const int c0 = (tile % tiles_w) * TW;
  const int H1 = H + 1;
  const int W1 = W + 1;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const T* dyp = dy + static_cast<size_t>(plane) * H1 * W1;

  for (int k = tid; k < (TH + 3) * (TW + 3); k += THREADS) {
    const int i = k / (TW + 3);
    const int j = k % (TW + 3);
    const int r = r0 - 1 + i;
    const int q = c0 - 1 + j;
    g[i][j] = (r >= 0 && r < H1 && q >= 0 && q < W1)
                  ? load(dyp, static_cast<size_t>(r) * W1 + q) : 0.f;
  }
  __syncthreads();
  for (int k = tid; k < TH * (TW + 3); k += THREADS) {
    const int i = k / (TW + 3);
    const int j = k % (TW + 3);
    v[i][j] = t0 * g[i][j] + t1 * g[i + 1][j] + t2 * g[i + 2][j] + t3 * g[i + 3][j];
  }
  __syncthreads();

  const float bias = b0[c];
  const int j = threadIdx.x;
  const int q = c0 + j;
  float acc = 0.f;
  for (int i = threadIdx.y; i < TH; i += TY) {
    const int r = r0 + i;
    if (r < H && q < W) {
      const float u = t0 * v[i][j] + t1 * v[i][j + 1] + t2 * v[i][j + 2] + t3 * v[i][j + 3];
      const size_t idx = static_cast<size_t>(plane) * H * W + static_cast<size_t>(r) * W + q;
      const float s = add_in_dtype(load(p0, idx), bias, p0);
      const float d = u * (s >= 0.f ? gain : gain * alpha);
      store(dp0, idx, d);
      acc += d;
    }
  }
  // fixed-order block sum: warp tree, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sum[w];
    const int B = gridDim.x / C;
    partial[(static_cast<size_t>(c) * B + b) * n_tiles + tile] = s;
  }
}

// db0[c] = the float64 sum of channel c's per-block partial sums, in a fixed
// order (strided per thread, then a tree).
__global__ void __launch_bounds__(SUM_THREADS)
channel_sum_kernel(const float* __restrict__ partial, float* __restrict__ db0,
                   int per_channel) {
  __shared__ double s[SUM_THREADS];
  const float* p = partial + static_cast<size_t>(blockIdx.x) * per_channel;
  double acc = 0.0;
  for (int k = threadIdx.x; k < per_channel; k += SUM_THREADS) acc += p[k];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int off = SUM_THREADS / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) db0[blockIdx.x] = static_cast<float>(s[0]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
skip_fanout_bwd_kernel(const T* __restrict__ dc, const T* __restrict__ dys,
                       T* __restrict__ out, int H, int W, int Hs, int Ws, int tiles_w,
                       float t0, float t1, float t2, float t3) {
  const int plane = blockIdx.x;
  const int tile = blockIdx.y;
  const int i = (tile / tiles_w) * TY + threadIdx.y;
  const int j = (tile % tiles_w) * TW + threadIdx.x;
  if (i >= H || j >= W) return;
  const T* d = dys + static_cast<size_t>(plane) * Hs * Ws;
  const int m = i >> 1;
  const int n = j >> 1;
  const int ra = (i & 1) ? m : m - 1;
  const int ca = (j & 1) ? n : n - 1;
  const float wr[2] = {(i & 1) ? t1 : t0, (i & 1) ? t3 : t2};
  const float wc[2] = {(j & 1) ? t1 : t0, (j & 1) ? t3 : t2};
  float u = 0.f;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int q = ca + b;
    float col = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ra + a;
      if (r >= 0 && r < Hs && q >= 0 && q < Ws)
        col += wr[a] * load(d, static_cast<size_t>(r) * Ws + q);
    }
    u += wc[b] * col;
  }
  const size_t idx = static_cast<size_t>(plane) * H * W + static_cast<size_t>(i) * W + j;
  store(out, idx, load(dc, idx) + u);
}

int tiles(int n, int t) { return (n + t - 1) / t; }

}  // namespace

// Floats of scratch that vqt_blur_t_gate needs for B x C planes of H x W.
extern "C" long long vqt_blur_t_gate_partials(int B, int C, int H, int W) {
  return static_cast<long long>(B) * C * tiles(H, TH) * tiles(W, TW);
}

// dy (B, C, H+1, W+1), p0 and dp0 (B, C, H, W), all fp32 (bf16 = 0) or bf16
// (bf16 = 1); b0 and db0 (C,) fp32; partial: vqt_blur_t_gate_partials floats.
// All contiguous on the current device, B, C, H, W > 0. Launches both passes
// on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronize.
extern "C" int vqt_blur_t_gate(const void* dy, const void* p0, const void* b0, void* dp0,
                               void* partial, void* db0, int B, int C, int H, int W,
                               int bf16, float t0, float t1, float t2, float t3,
                               float alpha, float gain, void* stream) {
  const int tiles_w = tiles(W, TW);
  const int n_tiles = tiles(H, TH) * tiles_w;
  if (n_tiles > MAX_GRID_Y) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(B * C, n_tiles);
  const dim3 block(TW, TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    blur_t_gate_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(p0),
        static_cast<const float*>(b0), static_cast<__nv_bfloat16*>(dp0),
        static_cast<float*>(partial), C, H, W, tiles_w, t0, t1, t2, t3, alpha, gain);
  } else {
    blur_t_gate_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(p0),
        static_cast<const float*>(b0), static_cast<float*>(dp0),
        static_cast<float*>(partial), C, H, W, tiles_w, t0, t1, t2, t3, alpha, gain);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  channel_sum_kernel<<<C, SUM_THREADS, 0, s>>>(static_cast<const float*>(partial),
                                               static_cast<float*>(db0), B * n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// dc and out (B, C, H, W), dys (B, C, Hs, Ws), all fp32 (bf16 = 0) or bf16
// (bf16 = 1), contiguous on the current device; B, C, H, W > 0. Launches on
// `stream` and returns cudaGetLastError(); does not synchronize.
extern "C" int vqt_skip_fanout_bwd(const void* dc, const void* dys, void* out, int B, int C,
                                   int H, int W, int Hs, int Ws, int bf16, float t0,
                                   float t1, float t2, float t3, void* stream) {
  const int tiles_w = tiles(W, TW);
  const int n_tiles = tiles(H, TY) * tiles_w;
  if (n_tiles > MAX_GRID_Y) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(B * C, n_tiles);
  const dim3 block(TW, TY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    skip_fanout_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dc), static_cast<const __nv_bfloat16*>(dys),
        static_cast<__nv_bfloat16*>(out), H, W, Hs, Ws, tiles_w, t0, t1, t2, t3);
  } else {
    skip_fanout_bwd_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(dc), static_cast<const float*>(dys),
        static_cast<float*>(out), H, W, Hs, Ws, tiles_w, t0, t1, t2, t3);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vqt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
