// Nearest-code assignment for vector quantization on Hopper (sm_90a).
//
// Replaces vqvae_tpu/ops/vq_pallas.py::nearest_codes_pallas (body _vq_kernel).
// The scan itself, its bound and its design are in nearest_codes.cuh, which
// nearest_codes_stats.cu (B2) shares.

#include "nearest_codes.cuh"

namespace {

__global__ void __launch_bounds__(vqt::TPB)
nearest_codes_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                     const float* __restrict__ c2, int32_t* __restrict__ out,
                     int M, int N, int D) {
  vqt::nearest_codes_block(x, cb, c2, out, M, N, D);
}

}  // namespace

// x (M, D), cb (N, D), c2 (N,) fp32 and out (M,) int32, all contiguous on the
// current device; M > 0, N > 0, D > 0. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronize.
extern "C" int vqt_nearest_codes(const void* x, const void* cb, const void* c2,
                                 void* out, int M, int N, int D, void* stream) {
  nearest_codes_kernel<<<vqt::nearest_codes_grid(M), vqt::TPB, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cb),
      static_cast<const float*>(c2), static_cast<int32_t*>(out), M, N, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vqt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
