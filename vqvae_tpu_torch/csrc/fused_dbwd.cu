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
//
// B4 replaces fused_dbwd.py::skip_fanout_bwd_pallas (body _make_skip_kernel):
//     out = dC + up2_blur_T(dYs)
// the adjoint of the skip path's down-2 FIR (pads 1) plus the fan-out add. By
// the parity of its row, an output pixel reads two rows of dYs: an even row
// 2m takes taps (f0, f2) of rows m-1 and m, an odd row 2m+1 taps (f1, f3) of
// rows m and m+1; columns likewise. Rows and columns outside dYs are 0, so any
// H and W work (dYs is floor(H/2) x floor(W/2), as the forward makes it).
//
// What bounds them: bytes. At the D's first block (C 128, 256^2) and batch
// 32, B3 reads dY and P0 and writes dP0: 1.6 GB in bf16, >= 0.48 ms at
// 3.35 TB/s (3.2 GB, 0.96 ms in fp32); its ~19 flops per element are 0.08 ms
// at 67 TFLOP/s. B4 moves 1.2 GB in bf16 (>= 0.36 ms; 0.72 ms in fp32). So
// the design moves each byte once, with many bytes in flight, and P0, dP0,
// dC and B4's output in 16-byte accesses; the tensor cores have no role.
//
// Both kernels give a "worker" -- a segment of `sw` lanes of one warp (a
// power of two <= 32) -- a strip of rows of one (b, c) plane, and the worker
// walks down its strip. A lane owns 8 adjacent output columns (one 16-byte
// vector in bf16, two in fp32). A row of a plane up to 256 wide is one
// segment; narrower planes put several segments, so several planes, in one
// warp, so that every lane has outputs on the 32^2, 16^2 and 8^2 planes; wider
// rows take several segments. The wrapper (ops/fused_dbwd_cuda.py, geometry)
// picks `sw` and the strip height: strips of up to 64 rows, shorter where the
// grid would be under a few waves of the card's SMs.
//
// B3 keeps the 4-row window of dY in registers, rolling down the strip: each
// dY row is read once per strip, plus 3 halo rows; dY row r+3 and P0 row r+1
// are loaded while row r is computed. dY rows have W+1 elements, so a row
// starts at any element boundary (514 B apart in bf16 at 256^2; TMA cannot
// describe that tensor): a lane loads the 4-byte words that cover its 8
// elements, with a __funnelshift_r of a half word in bf16. (Loading the
// aligned 16-byte words that cover them and shifting in registers is the
// other way; on an H100 the two were not told apart beyond the run-to-run
// spread: PERF.md.) bf16 rows stay packed two to a word in the window and
// are widened where they are used: under the bf16 register cap below, 3
// blocks fit on an SM instead of 2, for more bytes in flight (fp32 moves
// twice the bytes per load and spills under the cap, so it has none). The
// vertical taps are summed first, then the 3 horizontal neighbours come from
// the next lanes by __shfl_up_sync / __shfl_down_sync; a segment's edge lanes
// read their halo columns themselves. Each worker sums its unrounded dP0 (fp32 per row,
// float64 across rows and lanes in a fixed order) into one float64 partial
// per (plane, strip, segment). The worker that arrives last at its channel
// (a __threadfence, then an atomic arrival counter per channel) adds that
// channel's partials in a fixed order in float64, SUM_WAYS running sums per
// lane and writes db0. The launcher zeroes the counters (one memset) before
// each launch; db0 has the same bits on every run whichever worker arrives
// last.
//
// B4 gives a lane a patch of 2 output rows x 8 columns: output rows 2m and
// 2m+1, both phases, which read dYs rows m-1, m, m+1 at columns n-1 .. n+4
// (n = 4 x the lane's index in the row). The 3 dYs rows stay in registers down
// the strip, so each dYs value is read once per strip (plus 2 halo rows), not
// once per output it feeds; dC is loaded a patch ahead, as 16-byte vectors,
// and the output stored as such. Its register cap leaves 3 blocks per SM in
// bf16 (at a 12-byte spill) and 2 in fp32.
//
// The vector path needs W % 8 == 0 and 16-byte aligned P0 / dP0 (B3), dC /
// out and dYs aligned to 4 elements (B4); otherwise the same kernels run with
// one column per lane (B3) or one dYs column per lane (B4) and scalar loads:
// ragged and misaligned inputs. Sums in fp32, rounded once to the output's
// dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;   // threads per block: THREADS / sw workers
constexpr int VEC = 8;         // output columns per lane on the vector path
constexpr int SUM_WAYS = 8;    // B3's channel sum: independent running sums per lane

// ---------------------------------------------------------------- loads

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf_pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 elements from a 16-byte aligned pointer
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) { v[2 * i] = bf_lo(u[i]); v[2 * i + 1] = bf_hi(u[i]); }
}

__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(bf_pack(v[0], v[1]), bf_pack(v[2], v[3]),
                                            bf_pack(v[4], v[5]), bf_pack(v[6], v[7]));
}

// 8 elements from a pointer aligned only to its element, in 4-byte words: 8
// of them in fp32; in bf16 the 5 words that cover them, shifted by a half
// word where the row starts mid-word (the shift is the same for every lane
// of a row, so the funnel shift never diverges)
__device__ __forceinline__ void ld8_any(const float* p, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __ldg(p + i);
}
// bf16: the 8 elements as 4 packed words (element 2i in the low half of
// word i)
__device__ __forceinline__ void ld8_any(const __nv_bfloat16* p, uint32_t (&v)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned sh = static_cast<unsigned>(a & 2) * 8;     // 0 or 16 bits
  uint32_t u[5];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = __ldg(w + i);
  u[4] = sh ? __ldg(w + 4) : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(u[i], u[i + 1], sh);
}

// 4 elements from a pointer aligned to 4 elements (B4's dYs)
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf_lo(a.x); v[1] = bf_hi(a.x); v[2] = bf_lo(a.y); v[3] = bf_hi(a.y);
}

// p0 + b0 in p0's dtype: b0 cast to it first, then one rounded add, as the
// forward's bias_act adds them.
__device__ __forceinline__ float bias_in_dtype(float b, const float*) { return b; }
__device__ __forceinline__ float bias_in_dtype(float b, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(b));
}
__device__ __forceinline__ float add_in_dtype(float p, float b, const float*) { return p + b; }
__device__ __forceinline__ float add_in_dtype(float p, float b, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p + b));
}

// A worker: `sw` lanes of one warp. Its lanes' mask, its index in the grid
// and its lane.
struct Worker {
  unsigned mask;
  int id;
  int lane;
};

__device__ __forceinline__ Worker worker(int sw) {
  const int lane32 = threadIdx.x & 31;
  const unsigned seg = sw == 32 ? 0xffffffffu : ((1u << sw) - 1u) << (lane32 & ~(sw - 1));
  return {seg, static_cast<int>(blockIdx.x) * (THREADS / sw) + static_cast<int>(threadIdx.x) / sw,
          lane32 & (sw - 1)};
}

template <typename V>
__device__ __forceinline__ V seg_sum(V x, unsigned mask, int sw) {
  for (int off = sw >> 1; off > 0; off >>= 1) x += __shfl_down_sync(mask, x, off, sw);
  return x;
}

// ------------------------------------------------------------------- B3

// A lane's NV columns of a row as floats; bf16 rows on the vector path stay
// packed, two to a word, and are widened where they are used: the window
// of rows then takes half the registers, which leaves room for a second
// row in flight.
template <typename T, int NV>
struct Cols {
  float v[NV];
  __device__ __forceinline__ float get(int k) const { return v[k]; }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = 0.f;
  }
  __device__ __forceinline__ void load_any(const T* p) {
    if constexpr (NV == VEC) {
      ld8_any(p, v);
    } else {
      v[0] = ld1(p);
    }
  }
  __device__ __forceinline__ void load(const T* p) {   // 16-byte aligned on the vector path
    if constexpr (NV == VEC) {
      ld8(p, v);
    } else {
      v[0] = ld1(p);
    }
  }
};

template <>
struct Cols<__nv_bfloat16, VEC> {
  uint32_t w[VEC / 2];
  __device__ __forceinline__ float get(int k) const {
    return k & 1 ? bf_hi(w[k >> 1]) : bf_lo(w[k >> 1]);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) w[k] = 0u;
  }
  __device__ __forceinline__ void load_any(const __nv_bfloat16* p) { ld8_any(p, w); }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  }
};

// One dY row as a lane sees it: its own NV columns q0 .. q0+NV-1 and the
// halo columns q0-1, q0+NV, q0+NV+1 (read only where no other lane of the
// segment owns them: by the segment's edge lanes, or by every lane on the
// scalar path).
template <typename T, int NV>
struct DyRow {
  Cols<T, NV> own;
  float l, r0, r1;
};

template <typename T, int NV>
__device__ __forceinline__ void load_dy_row(DyRow<T, NV>& row, const T* plane, int rho, int H,
                                            int W, int q0, bool active, bool left_edge,
                                            bool right_edge) {
  row.own.zero();
  row.l = row.r0 = row.r1 = 0.f;
  if (rho < 0 || rho > H || !active) return;
  const T* p = plane + static_cast<size_t>(rho) * (W + 1) + q0;
  row.own.load_any(p);
  // dY has columns 0 .. W
  if (left_edge && q0 >= 1) row.l = ld1(p - 1);
  if (right_edge) {
    if (q0 + NV <= W) row.r0 = ld1(p + NV);
    if (q0 + NV + 1 <= W) row.r1 = ld1(p + NV + 1);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 1)
blur_t_gate_kernel(const T* __restrict__ dy, const T* __restrict__ p0,
                   const float* __restrict__ b0, T* __restrict__ dp0,
                   double* __restrict__ partial, unsigned* __restrict__ arrivals,
                   float* __restrict__ db0, int B, int C, int H, int W, int sw, int nseg,
                   int strip, int nstrips, float t0, float t1, float t2, float t3,
                   float alpha, float gain) {
  const Worker wk = worker(sw);
  if (wk.id >= B * C * nseg * nstrips) return;   // a whole segment leaves together
  const int g = wk.id % nseg;
  const int st = (wk.id / nseg) % nstrips;
  const int plane = wk.id / (nseg * nstrips);
  const int c = plane % C;
  const int b = plane / C;

  const int lanes = (W + NV - 1) / NV;                 // lanes of a row
  const int li = g * sw + wk.lane;                     // this lane in the row
  const int q0 = li * NV;
  const bool active = li < lanes;
  const int seg_hi = min(lanes, (g + 1) * sw);         // one past the segment's last lane
  const bool scalar = NV == 1;
  const bool left_edge = active && (scalar || wk.lane == 0);
  const bool right_edge = active && (scalar || li == seg_hi - 1);

  const T* dyp = dy + static_cast<size_t>(plane) * (H + 1) * (W + 1);
  const size_t out0 = static_cast<size_t>(plane) * H * W;
  const float bias = bias_in_dtype(b0[c], p0);
  const float g_neg = gain * alpha;
  const int r0 = st * strip;
  const int r1 = min(H, r0 + strip);

  // the window of dY rows r-1 .. r+2 and P0 row r; dY row r+3 and P0 row
  // r+1 are loaded a row ahead
  const T* p0p = p0 + out0;
  DyRow<T, NV> w0, w1, w2, w3;
  load_dy_row(w0, dyp, r0 - 1, H, W, q0, active, left_edge, right_edge);
  load_dy_row(w1, dyp, r0, H, W, q0, active, left_edge, right_edge);
  load_dy_row(w2, dyp, r0 + 1, H, W, q0, active, left_edge, right_edge);
  load_dy_row(w3, dyp, r0 + 2, H, W, q0, active, left_edge, right_edge);
  Cols<T, NV> pv;
  if (active) pv.load(p0p + static_cast<size_t>(r0) * W + q0);
  double acc = 0.0;
  for (int r = r0; r < r1; ++r) {
    const bool more = active && r + 1 < r1;
    DyRow<T, NV> next;
    load_dy_row(next, dyp, r + 3, H, W, q0, more, left_edge, right_edge);
    Cols<T, NV> pn;
    if (more) pn.load(p0p + static_cast<size_t>(r + 1) * W + q0);
    // vertical taps, then the horizontal neighbours
    float ext[NV + 3];
#pragma unroll
    for (int k = 0; k < NV; ++k)
      ext[k + 1] = t0 * w0.own.get(k) + t1 * w1.own.get(k) + t2 * w2.own.get(k) +
                   t3 * w3.own.get(k);
    const float hl = t0 * w0.l + t1 * w1.l + t2 * w2.l + t3 * w3.l;
    const float hr0 = t0 * w0.r0 + t1 * w1.r0 + t2 * w2.r0 + t3 * w3.r0;
    const float hr1 = t0 * w0.r1 + t1 * w1.r1 + t2 * w2.r1 + t3 * w3.r1;
    if constexpr (NV == VEC) {
      const float l = __shfl_up_sync(wk.mask, ext[NV], 1, sw);
      const float n0 = __shfl_down_sync(wk.mask, ext[1], 1, sw);
      const float nn = __shfl_down_sync(wk.mask, ext[2], 1, sw);
      ext[0] = left_edge ? hl : l;
      ext[NV + 1] = right_edge ? hr0 : n0;
      ext[NV + 2] = right_edge ? hr1 : nn;
    } else {
      ext[0] = hl;
      ext[NV + 1] = hr0;
      ext[NV + 2] = hr1;
    }
    if (active) {
      float d[NV];
      float row_sum = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float u = t0 * ext[k] + t1 * ext[k + 1] + t2 * ext[k + 2] + t3 * ext[k + 3];
        d[k] = u * (add_in_dtype(pv.get(k), bias, p0) >= 0.f ? gain : g_neg);
        row_sum += d[k];
      }
      T* out = dp0 + out0 + static_cast<size_t>(r) * W + q0;
      if constexpr (NV == VEC) {
        st8(out, d);
      } else {
        st1(out, d[0]);
      }
      acc += row_sum;
    }
    w0 = w1;
    w1 = w2;
    w2 = w3;
    w3 = next;
    pv = pn;
  }

  // db0: one partial per worker, in a fixed order; the channel's last worker
  // adds the channel's partials in a fixed order
  acc = seg_sum(acc, wk.mask, sw);
  const int per_channel = B * nstrips * nseg;
  unsigned last = 0;
  if (wk.lane == 0) {
    partial[static_cast<size_t>(c) * per_channel + (b * nstrips + st) * nseg + g] = acc;
    __threadfence();
    last = atomicAdd(arrivals + c, 1u) == static_cast<unsigned>(per_channel - 1);
  }
  last = __shfl_sync(wk.mask, last, 0, sw);
  if (last) {
    __threadfence();
    const double* pc = partial + static_cast<size_t>(c) * per_channel;
    // SUM_WAYS running sums per lane keep that many loads in flight; all
    // in a fixed order
    double part[SUM_WAYS] = {};
    for (int k0 = 0; k0 < per_channel; k0 += SUM_WAYS * sw) {
#pragma unroll
      for (int j = 0; j < SUM_WAYS; ++j) {
        const int k = k0 + j * sw + wk.lane;
        if (k < per_channel) part[j] += __ldcg(pc + k);
      }
    }
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < SUM_WAYS; ++j) s += part[j];
    s = seg_sum(s, wk.mask, sw);
    if (wk.lane == 0) {
      db0[c] = static_cast<float>(s);
    }
  }
}

// ------------------------------------------------------------------- B4

// One dYs row as a lane sees it: its own NK columns n0 .. n0+NK-1 and the
// halo columns n0-1, n0+NK.
template <int NK>
struct DysRow {
  float own[NK];
  float l, r;
};

template <typename T, int NK>
__device__ __forceinline__ void load_dys_row(DysRow<NK>& row, const T* plane, int rho, int Hs,
                                             int Ws, int n0, bool active, bool left_edge,
                                             bool right_edge) {
#pragma unroll
  for (int k = 0; k < NK; ++k) row.own[k] = 0.f;
  row.l = row.r = 0.f;
  if (rho < 0 || rho >= Hs || !active) return;
  const T* p = plane + static_cast<size_t>(rho) * Ws + n0;
  if constexpr (NK == VEC / 2) {
    ld4(p, row.own);
  } else {
    if (n0 < Ws) row.own[0] = ld1(p);
  }
  if (left_edge && n0 >= 1) row.l = ld1(p - 1);
  if (right_edge && n0 + NK < Ws) row.r = ld1(p + NK);
}

// a lane's 2 NK columns of dC rows 2m and 2m+1 (the latter where < H)
template <typename T, int NK>
__device__ __forceinline__ void load_dc(float (&ce)[2 * NK], float (&co)[2 * NK], const T* p,
                                        int c0, int W, bool odd_row) {
  if constexpr (NK == VEC / 2) {
    ld8(p, ce);
    if (odd_row) ld8(p + W, co);
  } else {
    ce[0] = ld1(p);
    ce[1] = c0 + 1 < W ? ld1(p + 1) : 0.f;
    co[0] = odd_row ? ld1(p + W) : 0.f;
    co[1] = odd_row && c0 + 1 < W ? ld1(p + W + 1) : 0.f;
  }
}

template <typename T, int NK>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 3 : 2)
skip_fanout_bwd_kernel(const T* __restrict__ dc, const T* __restrict__ dys,
                       T* __restrict__ out, int planes, int H, int W, int Hs, int Ws, int sw,
                       int nseg, int strip, int nstrips, float t0, float t1, float t2,
                       float t3) {
  const Worker wk = worker(sw);
  if (wk.id >= planes * nseg * nstrips) return;
  const int g = wk.id % nseg;
  const int st = (wk.id / nseg) % nstrips;
  const int plane = wk.id / (nseg * nstrips);

  constexpr int NC = 2 * NK;                           // output columns per lane
  const int lanes = (W + NC - 1) / NC;
  const int li = g * sw + wk.lane;
  const int n0 = li * NK;                              // first dYs column
  const int c0 = li * NC;                              // first output column
  const bool active = li < lanes;
  const int seg_hi = min(lanes, (g + 1) * sw);
  const bool scalar = NK == 1;
  const bool left_edge = active && (scalar || wk.lane == 0);
  const bool right_edge = active && (scalar || li == seg_hi - 1);

  const T* dsp = dys + static_cast<size_t>(plane) * Hs * Ws;
  const size_t out0 = static_cast<size_t>(plane) * H * W;
  const int m0 = st * strip;                           // patch rows: output rows 2m, 2m+1
  const int m1 = min((H + 1) / 2, m0 + strip);

  // the window of dYs rows m-1, m, m+1 and dC rows 2m, 2m+1; dYs row m+2
  // and dC rows 2m+2, 2m+3 are loaded a patch ahead
  DysRow<NK> x0, x1, x2;
  load_dys_row(x0, dsp, m0 - 1, Hs, Ws, n0, active, left_edge, right_edge);
  load_dys_row(x1, dsp, m0, Hs, Ws, n0, active, left_edge, right_edge);
  load_dys_row(x2, dsp, m0 + 1, Hs, Ws, n0, active, left_edge, right_edge);
  float ce[NC] = {}, co[NC] = {};
  if (active) load_dc<T, NK>(ce, co, dc + out0 + static_cast<size_t>(2 * m0) * W + c0, c0, W,
                      2 * m0 + 1 < H);
  for (int m = m0; m < m1; ++m) {
    const bool more = active && m + 1 < m1;
    DysRow<NK> next;
    load_dys_row(next, dsp, m + 2, Hs, Ws, n0, more, left_edge, right_edge);
    float cen[NC] = {}, con[NC] = {};
    if (more) load_dc<T, NK>(cen, con, dc + out0 + static_cast<size_t>(2 * m + 2) * W + c0, c0, W,
                      2 * m + 3 < H);
    // vertical taps per phase: e for output row 2m, o for 2m+1; index 0 is
    // column n0-1, NK+1 is n0+NK
    float e[NK + 2], o[NK + 2];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      e[k + 1] = t0 * x0.own[k] + t2 * x1.own[k];
      o[k + 1] = t1 * x1.own[k] + t3 * x2.own[k];
    }
    const float el = t0 * x0.l + t2 * x1.l, ol = t1 * x1.l + t3 * x2.l;
    const float er = t0 * x0.r + t2 * x1.r, orr = t1 * x1.r + t3 * x2.r;
    if constexpr (NK == VEC / 2) {
      const float sel = __shfl_up_sync(wk.mask, e[NK], 1, sw);
      const float sol = __shfl_up_sync(wk.mask, o[NK], 1, sw);
      const float ser = __shfl_down_sync(wk.mask, e[1], 1, sw);
      const float sor = __shfl_down_sync(wk.mask, o[1], 1, sw);
      e[0] = left_edge ? el : sel;
      o[0] = left_edge ? ol : sol;
      e[NK + 1] = right_edge ? er : ser;
      o[NK + 1] = right_edge ? orr : sor;
    } else {
      e[0] = el;
      o[0] = ol;
      e[NK + 1] = er;
      o[NK + 1] = orr;
    }
    if (active) {
      float ve[NC], vo[NC];
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        // even output column 2n: (f0, f2) of dYs columns n-1, n; odd 2n+1:
        // (f1, f3) of n, n+1
        ve[2 * k] = ce[2 * k] + (t0 * e[k] + t2 * e[k + 1]);
        ve[2 * k + 1] = ce[2 * k + 1] + (t1 * e[k + 1] + t3 * e[k + 2]);
        vo[2 * k] = co[2 * k] + (t0 * o[k] + t2 * o[k + 1]);
        vo[2 * k + 1] = co[2 * k + 1] + (t1 * o[k + 1] + t3 * o[k + 2]);
      }
      const bool odd_row = 2 * m + 1 < H;
      T* pe = out + out0 + static_cast<size_t>(2 * m) * W + c0;
      if constexpr (NK == VEC / 2) {
        st8(pe, ve);
        if (odd_row) st8(pe + W, vo);
      } else {
        st1(pe, ve[0]);
        if (c0 + 1 < W) st1(pe + 1, ve[1]);
        if (odd_row) {
          st1(pe + W, vo[0]);
          if (c0 + 1 < W) st1(pe + W + 1, vo[1]);
        }
      }
    }
    x0 = x1;
    x1 = x2;
    x2 = next;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      ce[k] = cen[k];
      co[k] = con[k];
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// workers = planes x segments x strips, as an int; -1 if the geometry is not
// one the kernels take
long long workers(long long planes, int lanes, int rows, int sw, int strip) {
  if (sw < 1 || sw > 32 || (sw & (sw - 1)) || strip < 1 || lanes < 1 || rows < 1) return -1;
  const long long nseg = (lanes + sw - 1) / sw;
  const long long nstrips = (rows + strip - 1) / strip;
  const long long n = planes * nseg * nstrips;
  return n > INT_MAX - THREADS ? -1 : n;
}

int blocks(long long n, int sw) {
  const int per_block = THREADS / sw;
  return static_cast<int>((n + per_block - 1) / per_block);
}

}  // namespace

// B3. dy (B, C, H+1, W+1), p0 and dp0 (B, C, H, W), all fp32 (bf16 = 0) or
// bf16 (bf16 = 1); b0 and db0 (C,) fp32; partial: n_partial float64 scratch,
// which must be C * B * ceil(lanes / sw) * ceil(H / strip), lanes = W / 8
// (vec = 1) or W (vec = 0); arrivals: C uint32 counters, zeroed here on
// `stream` before the kernel. vec = 1 needs W % 8 == 0 and p0, dp0 16-byte
// aligned. All contiguous on the current device, B, C, H, W > 0. Launches
// one memset and one kernel on `stream` and returns the first error (0 on
// success); does not synchronize.
extern "C" int vqt_blur_t_gate(const void* dy, const void* p0, const void* b0, void* dp0,
                               void* partial, long long n_partial, void* arrivals, void* db0,
                               int B, int C, int H, int W, int bf16, int vec, int sw,
                               int strip, float t0, float t1, float t2, float t3,
                               float alpha, float gain, void* stream) {
  const int lanes = vec ? W / VEC : W;
  const long long n = workers(static_cast<long long>(B) * C, lanes, H, sw, strip);
  if (n < 0 || n != n_partial ||
      (vec && (W % VEC != 0 || !aligned(p0, 16) || !aligned(dp0, 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = (lanes + sw - 1) / sw;
  const int nstrips = (H + strip - 1) / strip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks(n, sw));
  const auto* bp = static_cast<const float*>(b0);
  auto* part = static_cast<double*>(partial);
  auto* arr = static_cast<unsigned*>(arrivals);
  auto* db = static_cast<float*>(db0);
  const cudaError_t zeroed = cudaMemsetAsync(arr, 0, sizeof(unsigned) * C, s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
#define VQT_B3(T, NV)                                                                     \
  blur_t_gate_kernel<T, NV><<<grid, THREADS, 0, s>>>(                                     \
      static_cast<const T*>(dy), static_cast<const T*>(p0), bp, static_cast<T*>(dp0),     \
      part, arr, db, B, C, H, W, sw, nseg, strip, nstrips, t0, t1, t2, t3, alpha, gain)
  if (bf16) {
    if (vec) VQT_B3(__nv_bfloat16, VEC); else VQT_B3(__nv_bfloat16, 1);
  } else {
    if (vec) VQT_B3(float, VEC); else VQT_B3(float, 1);
  }
#undef VQT_B3
  return static_cast<int>(cudaGetLastError());
}

// B4. dc and out (B, C, H, W), dys (B, C, H/2, W/2), all fp32 (bf16 = 0) or
// bf16 (bf16 = 1), contiguous on the current device; B, C, H, W > 0. lanes =
// W / 8 (vec = 1: W % 8 == 0, dc and out 16-byte aligned, dys aligned to 4
// elements) or ceil(W / 2) (vec = 0); rows = ceil(H / 2). Launches on
// `stream` and returns cudaGetLastError(); does not synchronize.
extern "C" int vqt_skip_fanout_bwd(const void* dc, const void* dys, void* out, int B, int C,
                                   int H, int W, int bf16, int vec, int sw, int strip,
                                   float t0, float t1, float t2, float t3, void* stream) {
  const int lanes = vec ? W / VEC : (W + 1) / 2;
  const long long planes = static_cast<long long>(B) * C;
  const long long n = workers(planes, lanes, (H + 1) / 2, sw, strip);
  const uintptr_t esize = bf16 ? 2 : 4;
  if (n < 0 || (vec && (W % VEC != 0 || !aligned(dc, 16) || !aligned(out, 16) ||
                        !aligned(dys, 4 * esize))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = (lanes + sw - 1) / sw;
  const int nstrips = ((H + 1) / 2 + strip - 1) / strip;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks(n, sw));
  const int P = static_cast<int>(planes);
#define VQT_B4(T, NK)                                                                     \
  skip_fanout_bwd_kernel<T, NK><<<grid, THREADS, 0, s>>>(                                 \
      static_cast<const T*>(dc), static_cast<const T*>(dys), static_cast<T*>(out), P, H,  \
      W, H / 2, W / 2, sw, nseg, strip, nstrips, t0, t1, t2, t3)
  if (bf16) {
    if (vec) VQT_B4(__nv_bfloat16, VEC / 2); else VQT_B4(__nv_bfloat16, 1);
  } else {
    if (vec) VQT_B4(float, VEC / 2); else VQT_B4(float, 1);
  }
#undef VQT_B4
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vqt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
