// Nearest-code scan for vector quantization on Hopper (sm_90a), shared by
// nearest_codes.cu (B1) and nearest_codes_stats.cu (B2) so that both pick the
// same code for every row.
//
// For every row m of the latents x (M, D) the scan finds
//     argmin_n  c2[n] - 2 * dot(x[m], cb[n])        (c2[n] = |cb[n]|^2)
// in true fp32, the first index on ties, without writing the (M, N) score
// matrix to device memory. The |x|^2 term is constant per row and dropped,
// as in the plain version (vqvae_tpu_torch/ops/vq.py::nearest_codes_reference).
//
// What bounds it: 2*M*N*D fp32 FMAs on the CUDA cores (no tensor cores: TF32
// and bf16 accumulation flip near-ties), against a read of only (M + N) * D
// floats and a write of M ints, so it is compute bound. The design is a
// classic register-blocked SGEMM whose epilogue folds each score tile into a
// running per-row (best score, best index) pair instead of storing it:
//   - a block owns BM = 64 rows for the whole codebook, so each row's result
//     comes from exactly one block: no atomics, deterministic output;
//   - the codebook (1 MB fp32 at N = 1024, D = 256, above the 227 KB of shared
//     memory) is streamed through shared memory in BN x BK tiles;
//   - 256 threads as 16 x 16, each accumulating a 4 x 4 micro-tile in
//     registers (rows ty + 16 i, codes tx + 16 j, so that a warp's shared
//     memory reads hit distinct banks);
//   - the 16 threads sharing a row merge their pairs with warp shuffles.
// Any M, N, D: ragged tiles are zero-filled on load (zeros add nothing to a
// dot product), codes past N are never scored, rows past M never stored.
// NaN: a NaN score ranks below every number and the first NaN wins, which is
// torch.argmin's rule, so a NaN in x or in the codebook gives the plain
// version's code. Later work: wgmma with an fp32-exact split (3 x bf16 or
// 3 x TF32 terms), TMA loads, and splitting N across blocks at small M.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace vqt {

constexpr int BM = 64;        // rows of x per block
constexpr int BN = 64;        // codes per shared-memory tile
constexpr int BK = 32;        // depth per shared-memory tile
constexpr int TPB = 256;      // threads per block, 16 x 16
constexpr int TM = BM / 16;   // rows per thread
constexpr int TN = BN / 16;   // codes per thread

// (s, i) ranks before (bs, bi) under torch.argmin's order: NaN first, then
// smaller score, then smaller index.
__device__ __forceinline__ bool ranks_before(float s, int i, float bs, int bi) {
  const bool s_nan = isnan(s);
  const bool b_nan = isnan(bs);
  if (s_nan || b_nan) return s_nan && (!b_nan || i < bi);
  return s < bs || (s == bs && i < bi);
}

// Grid of the scan: one block of TPB threads per BM rows.
inline dim3 nearest_codes_grid(int M) { return dim3((M + BM - 1) / BM); }

// The body of a scan block: rows [blockIdx.x * BM, + BM) of x against the
// whole codebook, codes written to out. Call from a __global__ launched with
// nearest_codes_grid(M) blocks of TPB threads.
__device__ __forceinline__ void nearest_codes_block(
    const float* __restrict__ x, const float* __restrict__ cb,
    const float* __restrict__ c2, int32_t* __restrict__ out, int M, int N, int D) {
  // +1 pad: the transposed stores of a warp fall on distinct banks
  __shared__ float xs[BK][BM + 1];
  __shared__ float cs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;

  float best[TM];
  int best_idx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    best_idx[i] = INT_MAX;
  }

  for (int n0 = 0; n0 < N; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      // consecutive threads read consecutive k of one row: coalesced
      for (int e = tid; e < BM * BK; e += TPB) {
        const int r = e / BK;
        const int k = e % BK;
        const int kk = k0 + k;
        const int64_t m = m0 + r;
        const int n = n0 + r;
        xs[k][r] = (m < M && kk < D) ? x[m * D + kk] : 0.0f;
        cs[k][r] = (n < N && kk < D) ? cb[static_cast<int64_t>(n) * D + kk] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = cs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // codes visit in increasing index within a thread, so the tie rule of
    // ranks_before keeps the first index
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) {
        const float cn = c2[n];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = cn - 2.0f * acc[i][j];
          if (ranks_before(s, n, best[i], best_idx[i])) {
            best[i] = s;
            best_idx[i] = n;
          }
        }
      }
    }
  }

  // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_idx[i], off);
      if (ranks_before(os, oi, best[i], best_idx[i])) {
        best[i] = os;
        best_idx[i] = oi;
      }
    }
    const int64_t m = m0 + ty + 16 * i;
    if (tx == 0 && m < M) out[m] = best_idx[i];
  }
}

}  // namespace vqt
