// Nearest-code assignment fused with the EMA codebook-update statistics, on
// Hopper (sm_90a).
//
// Replaces vqvae_tpu/ops/vq_pallas.py::nearest_codes_stats_pallas (body
// _vq_stats_kernel). For latents x (M, D) and a codebook (N, D) it returns
//     codes[m]  = B1's nearest code of row m,
//     counts[n] = #{m : codes[m] = n}             (fp32, an exact integer),
//     dw[n]     = sum of x[m] over {m : codes[m] = n}.
//
// Two passes on one stream:
//   1. the assignment: nearest_codes.cuh's 3xTF32 tensor-core scan over code
//      ranges, its merge and its near-tie rescoring, the very code of B1, so
//      B1 and B2 pick the same code for every row (tie and NaN rules
//      included);
//   2. the sums: a block owns SC codes and SD columns of dw. It walks all M
//      codes in ascending row order, SD rows at a time: each thread tests one
//      row, a warp ballot and a block-wide prefix compact the rows that fall
//      in the block's codes into a list in row order, then each thread adds
//      its column of those rows into a float64 accumulator in shared memory.
//      Each dw entry is thus a sequential sum in row order, rounded once to
//      fp32: no atomics, the same bits on every run (the TPU grid also sums in
//      a fixed order, vq_pallas.py:46-47), and at least as close to the exact
//      sum as the plain fp32 one-hot product. Every row of x is read by the
//      one block that owns its code; unused codes get counts 0 and dw rows 0.
//
// What bounds it: pass 1's 3 TF32 passes x 2*M*N*D (51.5 GFLOP at the EMA
// training shape M = 8192, N = 4096, D = 256: 0.1041 ms at 495 TFLOP/s);
// pass 2 reads x once and M codes per block (from L2) and writes N*(D+1)
// floats, a few microseconds of traffic. Later work: folding pass 2 into
// pass 1's epilogue.

#include "nearest_codes.cuh"

namespace {

constexpr int SC = 16;    // codes per block of pass 2
constexpr int SD = 256;   // columns per block = threads per block = rows per step
constexpr int WARPS = SD / 32;

template <bool VEC>
__global__ void __launch_bounds__(vqt::TPB, 1)
nearest_codes_stats_scan_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                                const float* __restrict__ c2, float* __restrict__ part_score,
                                int32_t* __restrict__ part_index, float* __restrict__ part_second,
                                int32_t* __restrict__ c2_max_bits, int M, int N, int D) {
  vqt::nearest_codes_scan_block<VEC>(x, cb, c2, part_score, part_index, part_second,
                                     c2_max_bits, M, N, D);
}

__global__ void __launch_bounds__(vqt::MERGE_TPB)
nearest_codes_stats_merge_kernel(const float* __restrict__ x, const float* __restrict__ part_score,
                                 const int32_t* __restrict__ part_index,
                                 const float* __restrict__ part_second,
                                 const int32_t* __restrict__ c2_max_bits,
                                 int32_t* __restrict__ out, int32_t* __restrict__ near_rows,
                                 int32_t* __restrict__ near_count,
                                 unsigned long long* __restrict__ near_keys,
                                 int M, int D, int splits) {
  vqt::nearest_codes_merge_rows(x, part_score, part_index, part_second, c2_max_bits, out,
                                near_rows, near_count, near_keys, M, D, splits);
}

__global__ void __launch_bounds__(vqt::RESCORE_WARPS * 32)
nearest_codes_stats_rescore_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                                   const float* __restrict__ c2,
                                   const int32_t* __restrict__ near_rows,
                                   const int32_t* __restrict__ near_count,
                                   unsigned long long* __restrict__ near_keys, int N, int D) {
  vqt::nearest_codes_rescore_block(x, cb, c2, near_rows, near_count, near_keys, N, D);
}

__global__ void __launch_bounds__(vqt::MERGE_TPB)
nearest_codes_stats_pick_kernel(const int32_t* __restrict__ near_rows,
                                const int32_t* __restrict__ near_count,
                                const unsigned long long* __restrict__ near_keys,
                                int32_t* __restrict__ out) {
  vqt::nearest_codes_pick_rows(near_rows, near_count, near_keys, out);
}

__global__ void __launch_bounds__(SD)
nearest_codes_stats_sum_kernel(const float* __restrict__ x, const int32_t* __restrict__ codes,
                               float* __restrict__ counts, float* __restrict__ dw,
                               int M, int N, int D) {
  __shared__ double acc[SC][SD];   // 32 KB: one column per thread
  __shared__ int rows[SD];         // this step's rows of the block's codes, ascending
  __shared__ int slots[SD];        // their code minus n0
  __shared__ int warp_total[WARPS];
  __shared__ int cnt[SC];          // touched by thread 0 only

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * SC;
  const int d = blockIdx.y * SD + tid;
#pragma unroll
  for (int k = 0; k < SC; ++k) acc[k][tid] = 0.0;
  if (tid == 0)
    for (int k = 0; k < SC; ++k) cnt[k] = 0;

  for (int r0 = 0; r0 < M; r0 += SD) {
    const int m = r0 + tid;
    const int slot = m < M ? codes[m] - n0 : -1;
    const bool mine = slot >= 0 && slot < SC;
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0;
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = warp_total[w];
      offset += w < warp ? t : 0;
      total += t;
    }
    if (mine) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      rows[pos] = m;
      slots[pos] = slot;
    }
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const int k = slots[i];
      if (d < D) acc[k][tid] += static_cast<double>(x[static_cast<int64_t>(rows[i]) * D + d]);
      if (tid == 0) ++cnt[k];
    }
    __syncthreads();   // the next step overwrites rows, slots and warp_total
  }

  for (int k = 0; k < SC; ++k) {
    const int n = n0 + k;
    if (n < N && d < D) dw[static_cast<int64_t>(n) * D + d] = static_cast<float>(acc[k][tid]);
  }
  if (blockIdx.y == 0 && tid < SC && n0 + tid < N) counts[n0 + tid] = static_cast<float>(cnt[tid]);
}

}  // namespace

// x (M, D), cb (N, D), c2 (N,) fp32; codes (M,) int32, counts (N,) fp32 and
// dw (N, D) fp32 outputs; all contiguous on the current device; the scan's
// scratch as vqt_nearest_codes takes it; M > 0, N > 0, D > 0,
// 1 <= splits <= min(N, 65535). Launches the scan, its merge, rescoring and
// pick, and the sums on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success); does not synchronize.
extern "C" int vqt_nearest_codes_stats(const void* x, const void* cb, const void* c2,
                                       void* part_score, void* part_second, void* part_index,
                                       void* near_rows, void* near_count, void* near_keys,
                                       void* codes, void* counts, void* dw, int M, int N, int D,
                                       int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const vqt::ScanScratch scratch{static_cast<float*>(part_score),
                                 static_cast<float*>(part_second),
                                 static_cast<int32_t*>(part_index),
                                 static_cast<int32_t*>(near_rows),
                                 static_cast<int32_t*>(near_count),
                                 static_cast<unsigned long long*>(near_keys)};
  const vqt::NearestCodeKernels kernels{
      nearest_codes_stats_scan_kernel<true>, nearest_codes_stats_scan_kernel<false>,
      nearest_codes_stats_merge_kernel, nearest_codes_stats_rescore_kernel,
      nearest_codes_stats_pick_kernel};
  const cudaError_t err = vqt::launch_nearest_codes(
      kernels, static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<const float*>(c2), scratch,
      static_cast<int32_t*>(codes), M, N, D, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + SC - 1) / SC, (D + SD - 1) / SD);
  nearest_codes_stats_sum_kernel<<<grid, SD, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(codes),
      static_cast<float*>(counts), static_cast<float*>(dw), M, N, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vqt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
