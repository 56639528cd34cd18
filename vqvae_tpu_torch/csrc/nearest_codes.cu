// Nearest-code assignment for vector quantization on Hopper (sm_90a).
//
// Replaces vqvae_tpu/ops/vq_pallas.py::nearest_codes_pallas (body _vq_kernel).
// The scan itself, its bound and its design are in nearest_codes.cuh, which
// nearest_codes_stats.cu (B2) shares: a 3xTF32 tensor-core scan over code
// ranges split across blocks, a merge of each row's partials, and an fp32
// rescoring of the rows whose best two scores nearly tie.

#include "nearest_codes.cuh"

namespace {

template <bool VEC>
__global__ void __launch_bounds__(vqt::TPB, 1)
nearest_codes_scan_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                          const float* __restrict__ c2, float* __restrict__ part_score,
                          int32_t* __restrict__ part_index, float* __restrict__ part_second,
                          int32_t* __restrict__ c2_max_bits, int M, int N, int D) {
  vqt::nearest_codes_scan_block<VEC>(x, cb, c2, part_score, part_index, part_second,
                                     c2_max_bits, M, N, D);
}

__global__ void __launch_bounds__(vqt::MERGE_TPB)
nearest_codes_merge_kernel(const float* __restrict__ x, const float* __restrict__ part_score,
                           const int32_t* __restrict__ part_index,
                           const float* __restrict__ part_second,
                           const int32_t* __restrict__ c2_max_bits, int32_t* __restrict__ out,
                           int32_t* __restrict__ near_rows,
                           int32_t* __restrict__ near_count,
                           unsigned long long* __restrict__ near_keys,
                           int M, int D, int splits) {
  vqt::nearest_codes_merge_rows(x, part_score, part_index, part_second, c2_max_bits, out,
                                near_rows, near_count, near_keys, M, D, splits);
}

__global__ void __launch_bounds__(vqt::RESCORE_WARPS * 32)
nearest_codes_rescore_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                             const float* __restrict__ c2,
                             const int32_t* __restrict__ near_rows,
                             const int32_t* __restrict__ near_count,
                             unsigned long long* __restrict__ near_keys, int N, int D) {
  vqt::nearest_codes_rescore_block(x, cb, c2, near_rows, near_count, near_keys, N, D);
}

__global__ void __launch_bounds__(vqt::MERGE_TPB)
nearest_codes_pick_kernel(const int32_t* __restrict__ near_rows,
                          const int32_t* __restrict__ near_count,
                          const unsigned long long* __restrict__ near_keys,
                          int32_t* __restrict__ out) {
  vqt::nearest_codes_pick_rows(near_rows, near_count, near_keys, out);
}

}  // namespace

// x (M, D), cb (N, D), c2 (N,) fp32, out (M,) int32, all contiguous on the
// current device; scratch: part_score, part_second (splits, M) fp32,
// part_index (splits, M) int32, near_rows (M,) and near_count (2,) int32,
// near_keys (M,) uint64;
// M > 0, N > 0, D > 0, 1 <= splits <= min(N, 65535). Launches the scan, the
// merge, the rescoring and the pick on `stream` and returns the first nonzero
// cudaGetLastError() (0 on success); does not synchronize.
extern "C" int vqt_nearest_codes(const void* x, const void* cb, const void* c2,
                                 void* part_score, void* part_second, void* part_index,
                                 void* near_rows, void* near_count, void* near_keys, void* out,
                                 int M, int N, int D, int splits, void* stream) {
  const vqt::ScanScratch scratch{static_cast<float*>(part_score),
                                 static_cast<float*>(part_second),
                                 static_cast<int32_t*>(part_index),
                                 static_cast<int32_t*>(near_rows),
                                 static_cast<int32_t*>(near_count),
                                 static_cast<unsigned long long*>(near_keys)};
  const vqt::NearestCodeKernels kernels{nearest_codes_scan_kernel<true>,
                                         nearest_codes_scan_kernel<false>,
                                         nearest_codes_merge_kernel, nearest_codes_rescore_kernel,
                                         nearest_codes_pick_kernel};
  return static_cast<int>(vqt::launch_nearest_codes(
      kernels, static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<const float*>(c2), scratch,
      static_cast<int32_t*>(out), M, N, D, splits, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* vqt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
