// Nearest-code scan for vector quantization on Hopper (sm_90a), shared by
// nearest_codes.cu (B1, replaces vqvae_tpu/ops/vq_pallas.py:141,
// nearest_codes_pallas) and nearest_codes_stats.cu (B2, replaces
// vq_pallas.py:89, nearest_codes_stats_pallas), so that both pick the same
// code for every row.
//
// For every row m of the latents x (M, D) the scan finds
//     argmin_n  c2[n] - 2 * dot(x[m], cb[n])        (c2[n] = |cb[n]|^2)
// with torch.argmin's order (NaN first, then the smaller score, then the
// first index), without writing the (M, N) score matrix to device memory. The
// |x|^2 term is constant per row and dropped, as in the plain version
// (vqvae_tpu_torch/ops/vq.py::nearest_codes_reference).
//
// Precision. The TPU kernel takes the product on the matrix unit at
// precision=HIGHEST, a multi-pass bf16 split with fp32 accuracy. Its
// counterpart here is the 3xTF32 split on the tensor cores: each operand
// v = hi + lo with hi = rna_tf32(v) and lo = rna_tf32(v - hi), and
// dot = hi.hi + (hi.lo + lo.hi), accumulated in fp32, the two small terms in
// an accumulator of their own that is added once per code tile. Dropping
// lo.lo costs about 2^-22 of each product. Where the hi.hi sum is not finite
// the small terms are ignored, so an inf or NaN input gives the plain
// version's inf or NaN score (not the NaN of inf - inf); that also makes a
// select of lo = 0 for a non-finite hi needless in the inner loop.
//
// Bound: 3 TF32 passes x 2*M*N*D at 495 TFLOP/s, 0.0260 ms at
// (8192, 1024, 256) and 0.1041 ms at (8192, 4096, 256); the bytes,
// (M + N) * D * 4, take 0.003 ms, so operations bound it; the rescoring's
// fp32 FMAs are N * D per listed row. What the design does about what held
// the FFMA scan it replaces at 19% of its FFMA bound, and about near ties:
//   1. tensor cores: mma.sync.m16n8k8 TF32 through inline PTX, 3 MMAs per
//      fragment pair, instead of fp32 FMAs on the CUDA cores;
//   2. shared-memory traffic: a block owns BM = 128 rows and BN = 128 codes
//      per tile, 8 warps as 2 (rows) x 4 (codes), each on a 64 x 32 tile:
//      64 bytes of shared memory per MMA. Shared rows are BK + 8 floats and
//      each 8-deep step is read as float2 at depth (2t, 2t + 1), taken as the
//      MMA's depth (t, t + 4) for A and B alike, which leaves the dot
//      product unchanged: conflict-free 64-bit loads, half as many;
//   3. asynchronous loads: BK = 64-deep tiles of x and the codebook stream
//      through a STAGES-deep ring of cp.async 16-byte copies (4-byte copies
//      when D % 4 != 0 or an address is not 16-byte aligned), zero-filled
//      past M, past the block's codes and past D; one __syncthreads a step,
//      the copies of step s + 2 in flight while step s computes (BK = 64
//      halves the barriers of BK = 32); each code tile's c2 rides with its
//      first stage into shared memory, so the fold that ends a tile reads it
//      without a global load;
//   4. enough blocks: the codebook is split across blocks. gridDim.y code
//      ranges, range r = [r N / S, (r + 1) N / S), as many as one wave of
//      one block per SM holds (the scan holds one per SM), chosen by the
//      wrapper (vq_cuda.scan_splits). Each block folds
//      each code tile's scores into a running per-row (score, index) in
//      registers; the 4 lanes of a quad that share a row merge by shuffles,
//      the 4 warps that share a row through shared memory, and the block
//      writes one partial per (range, row). A second launch merges each
//      row's partials, a warp per row: the same bits on every run, the
//      first index on ties across ranges.
//   5. near ties: the 3xTF32 sums are as accurate as fp32 ones but not the
//      same sums as the plain version's fp32 matmul, so where a row's best
//      two scores nearly tie the two can pick different codes (1 row of
//      8192 on latents of an EMA-trained model, on the H100). The scan keeps
//      each row's second-best score; the merge lists the rows whose best two
//      lie within NEAR_RTOL (|x| max|c| + |best|): either dot product's
//      error is about 1e-6 of |x||c|, the subtraction's 2^-24 |s| (with
//      |x|^2 + |c|^2 in place of |x| max|c|, a codebook far smaller than
//      the latents, as at initialisation, put most rows on the list). Two
//      last launches rescore the listed rows against the whole codebook in
//      fp32 FMAs in depth order, the arithmetic of the FFMA scan this one
//      replaces, which picked the plain version's code on every row checked:
//      blocks of 32 codes staged in shared memory, a warp per listed row, an
//      atomicMin of (score, index) keys per row, then the pick.
//      chip_smoke.py prints how many rows were listed.
// Any M, N, D: ragged tiles are zero-filled, codes outside the block's
// range are never scored, rows past M never stored; a warp whose codes lie
// past the range skips its MMAs.

#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace vqt {

constexpr int BM = 128;                    // rows of x per block
constexpr int BN = 128;                    // codes per code tile
constexpr int BK = 64;                     // depth per stage
constexpr int STAGES = 3;                  // depth of the cp.async ring
constexpr int TPB = 256;                   // threads per block: 8 warps
constexpr int LDS = BK + 8;                // floats per shared row
constexpr int WARP_M = 64;                 // rows per warp
constexpr int WARP_N = 32;                 // codes per warp
constexpr int WARPS_N = BN / WARP_N;       // warps that share a row: 4
constexpr int MT = WARP_M / 16;            // m16 tiles per warp
constexpr int NT = WARP_N / 8;             // n8 tiles per warp
constexpr int STAGE_FLOATS = (BM + BN) * LDS;
// the ring, then c2 of the code tiles in flight (one per stage at most)
constexpr int SCAN_SMEM = STAGES * (STAGE_FLOATS + BN) * 4;   // 222,720 bytes
constexpr int MERGE_TPB = 256;             // 8 rows per merge block, a warp each
constexpr int RESCORE_CODES = 32;          // codes per rescoring block, a lane each
constexpr int RESCORE_WARPS = 8;           // listed rows per rescoring round, a warp each
constexpr int RESCORE_SLAB = 256;          // depth of the code rows a block stages at once
constexpr int RESCORE_GROUPS = 16;         // grid columns that share the rounds
constexpr int PICK_BLOCKS = 64;            // blocks of the pick, MERGE_TPB threads each
// a row whose best two scores lie within NEAR_RTOL (|x| max|c| + |best|) is
// rescored in fp32 FMAs; vq_cuda.NEAR_RTOL, BM and BN hold the same values
// (a test compares them)
constexpr float NEAR_RTOL = 2e-5f;
static_assert((BM / WARP_M) * WARPS_N * 32 == TPB, "the warps tile the block");
static_assert(WARPS_N * BM * 12 <= SCAN_SMEM, "the cross-warp merge reuses the ring");

// (s, i) ranks before (bs, bi) under torch.argmin's order: NaN first, then
// smaller score, then smaller index.
__device__ __forceinline__ bool ranks_before(float s, int i, float bs, int bi) {
  const bool s_nan = isnan(s);
  const bool b_nan = isnan(bs);
  if (s_nan || b_nan) return s_nan && (!b_nan || i < bi);
  return s < bs || (s == bs && i < bi);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; zeros when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// v = hi + lo in TF32, both rounded to nearest, ties away from zero. v - hi
// is exact and far from overflow wherever v is finite, and adding half a
// TF32 ulp to its bits and clearing the 13 low ones is cvt.rna's rounding in
// two integer operations (sm_90 has no single instruction for the cvt). Where
// hi is not finite lo is junk; combine() never reads a sum that holds it.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// d += a b for one 16x8x8 TF32 tile. Fragments (g = lane / 4, t = lane % 4):
// a = A(g, t), A(g + 8, t), A(g, t + 4), A(g + 8, t + 4); b = B(t, g),
// B(t + 4, g); d = D(g, 2t), D(g, 2t + 1), D(g + 8, 2t), D(g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v = hi + lo for the A fragments of one m16 tile (p: depth 2t, 2t + 1 of
// row g; q: of row g + 8) and the B fragment of one n8 tile (c: depth 2t,
// 2t + 1 of code g), in the register order of mma_tf32.
__device__ __forceinline__ void split_a(float2 p, float2 q, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(p.x, hi[0], lo[0]);
  split_tf32(q.x, hi[1], lo[1]);
  split_tf32(p.y, hi[2], lo[2]);
  split_tf32(q.y, hi[3], lo[3]);
}

__device__ __forceinline__ void split_b(float2 c, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(c.x, hi[0], lo[0]);
  split_tf32(c.y, hi[1], lo[1]);
}

// big += hi.hi; small += hi.lo + lo.hi
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  mma_tf32(big, ahi, bhi);
  mma_tf32(small, ahi, blo);
  mma_tf32(small, alo, bhi);
}

// One warp's share of one stage: its 64 rows x 32 codes over the stage's BK
// depth. xs and cs point at the warp's first row and code, at depth 2t.
// FULL: all 32 codes lie below n_hi and the whole depth below D, so the
// loop has no branch and the compiler can overlap one step's shared loads
// with the previous step's MMAs; otherwise codes past n_hi and depth past D
// are skipped (their shared entries are zeros).
template <bool FULL>
__device__ __forceinline__ void warp_tile_stage(const float* xs, const float* cs, int wn0,
                                                int n_hi, int depth,
                                                float (&big)[MT][NT][4],
                                                float (&small)[MT][NT][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    if (FULL || kk < depth) {
      float2 a[MT][2];
      float2 b[NT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        a[i][0] = *reinterpret_cast<const float2*>(xs + i * 16 * LDS + kk);
        a[i][1] = *reinterpret_cast<const float2*>(xs + (i * 16 + 8) * LDS + kk);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = *reinterpret_cast<const float2*>(cs + j * 8 * LDS + kk);
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) split_a(a[i][0], a[i][1], ahi[i], alo[i]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (FULL || wn0 + j * 8 < n_hi) {
          uint32_t bhi[2], blo[2];
          split_b(b[j], bhi, blo);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_3xtf32(big[i][j], small[i][j], ahi[i], alo[i], bhi, blo);
        }
      }
    }
  }
}

// The dot product from the two accumulators: the small terms only where the
// large one is finite. A non-finite input element makes every hi.hi sum it
// enters non-finite, so its lo (NaN, or a NaN or inf product) is never read:
// an inf or NaN input gives the plain version's inf or NaN score.
__device__ __forceinline__ float combine(float big, float small) {
  return isfinite(big) ? big + small : big;
}

// Folds candidate (s, n), if valid, into a row's running (best, best_idx,
// second) whose candidates came in increasing code order: torch.argmin's
// order (NaN first, then the smaller score, the earlier code on ties)
// without comparing indices; the initial (inf, INT_MAX) takes any
// candidate; second is the least score beside the best. Bitwise, not
// short-circuit, operators: with && and || the compiler emits two branches
// per candidate instead of selects.
__device__ __forceinline__ void fold(float s, int n, bool valid, float& best, int& best_idx,
                                     float& second) {
  const bool take = valid & (best == best) & (!(s >= best) | (best_idx == INT_MAX));
  const float other = take ? best : s;
  second = (valid & (other < second)) ? other : second;
  best = take ? s : best;
  best_idx = take ? n : best_idx;
}

// Merges record (os, oi, o2) into (bs, bi, b2), any two sets of codes: the
// winner by ranks_before; the union's second-best score is the least of
// both seconds and the loser's best (fminf skips a NaN).
__device__ __forceinline__ void merge_record(float os, int oi, float o2, float& bs, int& bi,
                                             float& b2) {
  const bool take = ranks_before(os, oi, bs, bi);
  b2 = fminf(fminf(b2, o2), take ? bs : os);
  bs = take ? os : bs;
  bi = take ? oi : bi;
}

// One stage: depth [k0, k0 + BK) of rows [m0, m0 + BM) of x and of codes
// [n0, n0 + BN) of cb, zero past M, past n_hi and past D.
template <bool VEC, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int64_t r0, int64_t r_end, int D, int k0) {
  constexpr int WIDTH = VEC ? 4 : 1;             // floats per copy
  constexpr int PER_ROW = BK / WIDTH;
  static_assert(ROWS * PER_ROW % TPB == 0, "every thread issues the same copies");
  // the 4-byte path issues 4x the copies: unrolled less, it keeps fewer
  // addresses live beside the accumulators
#pragma unroll (VEC ? ROWS * PER_ROW / TPB : 4)
  for (int i = 0; i < ROWS * PER_ROW / TPB; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * TPB;
    const int r = e / PER_ROW;
    const int c = (e % PER_ROW) * WIDTH;
    const int k = k0 + c;
    const bool ok = r0 + r < r_end && k < D;
    const float* from = ok ? src + (r0 + r) * D + k : src;
    if (VEC)
      cp_async16(dst + r * LDS + c, from, ok);
    else
      cp_async4(dst + r * LDS + c, from, ok);
  }
}

// Step f of a block: code tile f / k_steps at depth slab f % k_steps into
// stage f % STAGES; with a tile's first slab, its c2 into c2 slot
// tile % STAGES (tiles in flight are consecutive, so their slots differ).
template <bool VEC>
__device__ __forceinline__ void load_step(float* smem, const float* __restrict__ x,
                                          const float* __restrict__ cb,
                                          const float* __restrict__ c2, int64_t m0, int M,
                                          int n_lo, int n_hi, int D, int k_steps, int f) {
  const int tile = f / k_steps;
  const int kstep = f % k_steps;
  const int n0 = n_lo + tile * BN;
  float* stage = smem + f % STAGES * STAGE_FLOATS;
  load_rows<VEC, BM>(stage, x, m0, M, D, kstep * BK);
  load_rows<VEC, BN>(stage + BM * LDS, cb, n0, n_hi, D, kstep * BK);
  if (kstep == 0 && threadIdx.x < BN) {
    const int n = n0 + threadIdx.x;
    cp_async4(smem + STAGES * STAGE_FLOATS + tile % STAGES * BN + threadIdx.x,
              n < n_hi ? c2 + n : c2, n < n_hi);
  }
}

// The body of a scan block: rows [blockIdx.x * BM, + BM) of x against code
// range blockIdx.y of gridDim.y; writes the range's best (score, index) of
// each row, and its second-best score, to part_score / part_index /
// part_second[blockIdx.y * M + m]; the blocks of row tile 0 put the range's
// largest c2 into *c2_max_bits (zeroed before). Launch with TPB
// threads and SCAN_SMEM bytes of dynamic shared memory.
template <bool VEC>
__device__ __forceinline__ void nearest_codes_scan_block(
    const float* __restrict__ x, const float* __restrict__ cb, const float* __restrict__ c2,
    float* __restrict__ part_score, int32_t* __restrict__ part_index,
    float* __restrict__ part_second, int32_t* __restrict__ c2_max_bits, int M, int N, int D) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int range = blockIdx.y;
  const int n_lo = static_cast<int>(static_cast<int64_t>(range) * N / gridDim.y);
  const int n_hi = static_cast<int>(static_cast<int64_t>(range + 1) * N / gridDim.y);
  const int k_steps = (D + BK - 1) / BK;
  const int steps = (n_hi - n_lo + BN - 1) / BN * k_steps;

  float big[MT][NT][4];
  float small[MT][NT][4];
  float best[MT][2];
  int best_idx[MT][2];
  float second[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) big[i][j][e] = small[i][j][e] = 0.0f;
    best[i][0] = best[i][1] = second[i][0] = second[i][1] = INFINITY;
    best_idx[i][0] = best_idx[i][1] = INT_MAX;
  }

  // step s covers code tile s / k_steps at depth slab s % k_steps
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_step<VEC>(smem, x, cb, c2, m0, M, n_lo, n_hi, D, k_steps, s);
    cp_async_commit();
  }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    // stage s has landed for every thread, and every warp is done with
    // stage s - 1, whose slot the next copy refills
    __syncthreads();
    const int f = s + STAGES - 1;
    if (f < steps) load_step<VEC>(smem, x, cb, c2, m0, M, n_lo, n_hi, D, k_steps, f);
    cp_async_commit();

    const int kstep = s % k_steps;
    const int wn0 = n_lo + s / k_steps * BN + wn * WARP_N;   // this warp's first code
    const float* stage = smem + s % STAGES * STAGE_FLOATS;
    const float* xs = stage + (wm * WARP_M + g) * LDS + 2 * t;
    const float* cs = stage + (BM + wn * WARP_N + g) * LDS + 2 * t;
    const int depth = D - kstep * BK;
    if (wn0 + WARP_N <= n_hi && depth >= BK)
      warp_tile_stage<true>(xs, cs, wn0, n_hi, depth, big, small);
    else if (wn0 < n_hi)
      warp_tile_stage<false>(xs, cs, wn0, n_hi, depth, big, small);

    if (kstep == k_steps - 1) {
      // the code tile is complete: fold its scores, codes in increasing order
      const float* c2s = smem + STAGES * STAGE_FLOATS + s / k_steps % STAGES * BN + wn * WARP_N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = wn0 + j * 8 + 2 * t + e;
          const float cn = c2s[j * 8 + 2 * t + e];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              fold(cn - 2.0f * combine(big[i][j][2 * h + e], small[i][j][2 * h + e]), n,
                   n < n_hi, best[i][h], best_idx[i][h], second[i][h]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[i][j][e] = small[i][j][e] = 0.0f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: reuse it for the cross-warp merge

  // the 4 lanes of a quad hold the same rows
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best[i][h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_idx[i][h], off);
        const float o2 = __shfl_xor_sync(0xffffffffu, second[i][h], off);
        merge_record(os, oi, o2, best[i][h], best_idx[i][h], second[i][h]);
      }
    }
  }
  float* red_score = smem;                                      // [WARPS_N][BM]
  int* red_index = reinterpret_cast<int*>(smem + WARPS_N * BM);  // [WARPS_N][BM]
  float* red_second = smem + 2 * WARPS_N * BM;                  // [WARPS_N][BM]
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * WARP_M + i * 16 + h * 8 + g;
        red_score[wn * BM + row] = best[i][h];
        red_index[wn * BM + row] = best_idx[i][h];
        red_second[wn * BM + row] = second[i][h];
      }
    }
  }
  __syncthreads();
  if (tid < BM && m0 + tid < M) {
    float bs = red_score[tid];
    int bi = red_index[tid];
    float b2 = red_second[tid];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w)
      merge_record(red_score[w * BM + tid], red_index[w * BM + tid], red_second[w * BM + tid],
                   bs, bi, b2);
    const int64_t at = static_cast<int64_t>(range) * M + m0 + tid;
    part_score[at] = bs;
    part_index[at] = bi;
    part_second[at] = b2;
  }
  if (blockIdx.x == 0) {
    // the range's largest c2 into *c2_max_bits (c2 >= 0, so its bits order
    // as the value does; fmaxf skips a NaN, whose rows are never listed)
    float cmax = 0.0f;
    for (int n = n_lo + tid; n < n_hi; n += TPB) cmax = fmaxf(cmax, c2[n]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
    if (lane == 0) atomicMax(c2_max_bits, __float_as_int(cmax));
  }
}

// The body of the merge: one warp per row. |x_m| from the row, the ranges'
// partials merged into the code, written to out, and the row put on the
// rescoring list (its key set to the largest) when its best two scores lie
// within NEAR_RTOL (|x_m| max|c| + |best|), max|c|^2 the float whose bits
// c2_max_bits holds. Launch with MERGE_TPB threads per block, MERGE_TPB / 32
// rows each, after the scan.
__device__ __forceinline__ void nearest_codes_merge_rows(
    const float* __restrict__ x, const float* __restrict__ part_score,
    const int32_t* __restrict__ part_index, const float* __restrict__ part_second,
    const int32_t* __restrict__ c2_max_bits, int32_t* __restrict__ out,
    int32_t* __restrict__ near_rows, int32_t* __restrict__ near_count,
    unsigned long long* __restrict__ near_keys, int M, int D, int splits) {
  const int lane = threadIdx.x % 32;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * (MERGE_TPB / 32) + threadIdx.x / 32;
  if (m >= M) return;   // the whole warp
  float xx = 0.0f;
  for (int k = lane; k < D; k += 32) {
    const float v = x[m * D + k];
    xx = fmaf(v, v, xx);
  }
  float bs = INFINITY;
  int bi = INT_MAX;
  float b2 = INFINITY;
  for (int r = lane; r < splits; r += 32) {
    const int64_t at = static_cast<int64_t>(r) * M + m;
    merge_record(part_score[at], part_index[at], part_second[at], bs, bi, b2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    xx += __shfl_xor_sync(0xffffffffu, xx, off);
    const float os = __shfl_xor_sync(0xffffffffu, bs, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, b2, off);
    merge_record(os, oi, o2, bs, bi, b2);
  }
  if (lane == 0) {
    out[m] = bi;
    const float c2_max = __int_as_float(*c2_max_bits);
    if (isfinite(bs) && b2 - bs <= NEAR_RTOL * (sqrtf(xx * c2_max) + fabsf(bs))) {
      const int item = atomicAdd(near_count, 1);
      near_rows[item] = static_cast<int32_t>(m);
      near_keys[item] = ~0ull;
    }
  }
}

// (s, n) as a 64-bit key whose unsigned order is torch.argmin's: NaN first
// (the earliest code among NaNs), then the smaller score (-0 as +0), then
// the smaller index.
__device__ __forceinline__ unsigned long long score_key(float s, int n) {
  const uint32_t b = __float_as_uint(s + 0.0f);
  const uint32_t order = isnan(s) ? 0u : (b & 0x80000000u) ? ~b : b | 0x80000000u;
  return static_cast<unsigned long long>(order) << 32 | static_cast<uint32_t>(n);
}

// The body of the rescoring: codes [blockIdx.y * RESCORE_CODES, +
// RESCORE_CODES) of the listed rows, RESCORE_WARPS rows a round (rounds
// blockIdx.x, + gridDim.x, ...), in fp32 FMAs, depth in order (acc =
// fma(x[k], cb[n][k], acc), k = 0 .. D - 1) and score c2[n] - 2 acc, the
// arithmetic of the plain version's fp32 matmul rows. Lane l of warp w owns
// code l of the block and row w of the round; the block's code rows sit in
// shared memory (a row on its own banks), read once per round; the least
// key of a warp goes into its row's near_keys entry by atomicMin
// (order-free, so the same result on every run). Launch with
// RESCORE_WARPS * 32 threads on a (RESCORE_GROUPS, ceil(N / RESCORE_CODES))
// grid.
__device__ __forceinline__ void nearest_codes_rescore_block(
    const float* __restrict__ x, const float* __restrict__ cb, const float* __restrict__ c2,
    const int32_t* __restrict__ near_rows, const int32_t* __restrict__ near_count,
    unsigned long long* __restrict__ near_keys, int N, int D) {
  __shared__ float cs[RESCORE_CODES][RESCORE_SLAB + 1];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c0 = blockIdx.y * RESCORE_CODES;
  const int count = *near_count;
  for (int first = blockIdx.x * RESCORE_WARPS; first < count;
       first += gridDim.x * RESCORE_WARPS) {
    const int item = first + warp;
    const bool live = item < count;
    const float* xr = x + (live ? static_cast<int64_t>(near_rows[item]) * D : 0);
    float acc = 0.0f;
    for (int k0 = 0; k0 < D; k0 += RESCORE_SLAB) {
      __syncthreads();   // every warp is done with the previous slab
      for (int e = threadIdx.x; e < RESCORE_CODES * RESCORE_SLAB; e += RESCORE_WARPS * 32) {
        const int r = e / RESCORE_SLAB;
        const int k = k0 + e % RESCORE_SLAB;
        cs[r][e % RESCORE_SLAB] =
            c0 + r < N && k < D ? cb[static_cast<int64_t>(c0 + r) * D + k] : 0.0f;
      }
      __syncthreads();
      if (live) {
        const int depth = min(RESCORE_SLAB, D - k0);
        for (int k = 0; k < depth; ++k) acc = fmaf(xr[k0 + k], cs[lane][k], acc);
      }
    }
    const int n = c0 + lane;
    unsigned long long key = live && n < N ? score_key(c2[n] - 2.0f * acc, n) : ~0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
      key = other < key ? other : key;
    }
    if (lane == 0 && live) atomicMin(near_keys + item, key);
  }
}

// The body of the last step: each listed row's code from its key. Launch
// with MERGE_TPB threads on PICK_BLOCKS blocks.
__device__ __forceinline__ void nearest_codes_pick_rows(
    const int32_t* __restrict__ near_rows, const int32_t* __restrict__ near_count,
    const unsigned long long* __restrict__ near_keys, int32_t* __restrict__ out) {
  const int count = *near_count;
  for (int item = blockIdx.x * MERGE_TPB + threadIdx.x; item < count;
       item += gridDim.x * MERGE_TPB)
    out[near_rows[item]] = static_cast<int32_t>(near_keys[item] & 0xFFFFFFFFull);
}

using ScanKernel = void (*)(const float*, const float*, const float*, float*, int32_t*, float*,
                            int32_t*, int, int, int);
using MergeKernel = void (*)(const float*, const float*, const int32_t*, const float*,
                             const int32_t*, int32_t*, int32_t*, int32_t*, unsigned long long*,
                             int, int, int);
using RescoreKernel = void (*)(const float*, const float*, const float*, const int32_t*,
                               const int32_t*, unsigned long long*, int, int);
using PickKernel = void (*)(const int32_t*, const int32_t*, const unsigned long long*, int32_t*);

// The kernels of one library, the scan in its two copy widths.
struct NearestCodeKernels {
  ScanKernel scan_vec;
  ScanKernel scan_any;
  MergeKernel merge;
  RescoreKernel rescore;
  PickKernel pick;
};

// The scratch of one call: splits * M partial best scores, second-best
// scores and indices; the rescoring list (up to M rows), then its count and
// the bits of max c2 side by side; one key per listed row.
struct ScanScratch {
  float* part_score;
  float* part_second;
  int32_t* part_index;
  int32_t* near_rows;
  int32_t* near_count;   // near_count[1]: the bits of max c2
  unsigned long long* near_keys;
};

// Launches, on `stream`: the scan on a grid of row tiles x `splits` code
// ranges (scan_vec when D % 4 == 0 and x and cb are 16-byte aligned, else
// scan_any), the merge into out, and the rescoring of near-tie rows. Returns
// the first CUDA error (cudaSuccess if none).
inline cudaError_t launch_nearest_codes(const NearestCodeKernels& k, const float* x,
                                        const float* cb, const float* c2,
                                        const ScanScratch& scratch, int32_t* out, int M, int N,
                                        int D, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > N || splits > 65535 ||
      (N + RESCORE_CODES - 1) / RESCORE_CODES > 65535)
    return cudaErrorInvalidValue;
  const bool vec = D % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(cb)) % 16 == 0;
  const ScanKernel scan = vec ? k.scan_vec : k.scan_any;
  const MergeKernel merge = k.merge;
  const RescoreKernel rescore = k.rescore;
  const PickKernel pick = k.pick;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(scan),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SCAN_SMEM);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch.near_count, 0, 2 * sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  scan<<<dim3((M + BM - 1) / BM, splits), TPB, SCAN_SMEM, stream>>>(
      x, cb, c2, scratch.part_score, scratch.part_index, scratch.part_second,
      scratch.near_count + 1, M, N, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int rows_per_block = MERGE_TPB / 32;
  merge<<<(M + rows_per_block - 1) / rows_per_block, MERGE_TPB, 0, stream>>>(
      x, scratch.part_score, scratch.part_index, scratch.part_second, scratch.near_count + 1,
      out, scratch.near_rows, scratch.near_count, scratch.near_keys, M, D, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rescore<<<dim3(RESCORE_GROUPS, (N + RESCORE_CODES - 1) / RESCORE_CODES), RESCORE_WARPS * 32, 0,
            stream>>>(x, cb, c2, scratch.near_rows, scratch.near_count, scratch.near_keys, N,
                      D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pick<<<PICK_BLOCKS, MERGE_TPB, 0, stream>>>(scratch.near_rows, scratch.near_count,
                                              scratch.near_keys, out);
  return cudaGetLastError();
}

}  // namespace vqt
