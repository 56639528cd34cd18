// GroupNorm -> SiLU on Hopper (sm_90a): the autoencoder's norm_act in one kernel.
//
// Replaces no TPU kernel. The JAX package fuses the pair as GNSiLU /
// _gn_silu_core (vqvae_tpu/models/autoencoder.py:172-272), a composition that
// XLA fuses, with no Pallas kernel. The port's plain form
// (ops/gn_silu.py, gn_silu_reference) runs it as about 13 launches, most of
// which read and write a full-size fp32 tensor. This kernel serves the calls
// that autograd does not record (ops/gn_silu.py says which).
//
// For each (batch, group) of a contiguous NCHW tensor -- a contiguous run of
// n = (C / G) H W elements -- or of a channels-last (NHWC) one -- C / G
// adjacent channels at each of the H W pixels -- it computes
//     mean = sum x / n,   var = sum (x - mean)^2 / max(n - ddof, 1)
//     z    = round_T((x - mean) a + b[c]),   a = rsqrt(var + eps) w[c]
//     out  = act ? round_T(z / (1 + exp(-z))) : z
// with fp32 statistics from centred squares (never E[x^2] - mean^2), the
// affine in fp32 as a subtraction and an FMA an element (the plain form's
// ((x - mean) rstd) w + b with rstd w rounded once: kernel_error in
// tests/gn_silu_check.py holds the two to an ulp of the affine's scale),
// and the SiLU in fp32 from the value already rounded to the output's type
// T, as F.silu on a tensor of type T computes it.
//
// What bounds it: bytes, with the arithmetic close behind. At (32, 128, 256,
// 256) bf16 one read and one write of x are 1.07 GB, 0.32 ms at 3.35 TB/s;
// with F.silu's IEEE quotient in every SiLU the kernel took 0.62 ms there,
// with the reciprocal unit's 0.49 ms (PERF.md). So the design reads x once
// and writes the output once, with many 16-byte accesses in flight, keeps
// everything between the two on chip, and spends few instructions an
// element: the affine as a subtraction and an FMA, bf16 values rounded two
// to a conversion, the SiLU's quotient from the reciprocal unit where that
// keeps F.silu's bits.
//
// Cluster form (4 B / 8 B an element in bf16 / fp32): a thread-block cluster
// of `cs` CTAs (1 to 16) takes one group. CTA r copies elements
// [r slice, (r + 1) slice) of the group into shared memory with 16-byte loads
// (UNROLL in flight a thread), summing them as they arrive; takes its local
// mean, then its centred squares from shared memory; the cluster's CTAs
// exchange (mean, M2) through distributed shared memory and each merges the
// cs partials in rank order (Chan's formula, in double), so every CTA of a
// group holds the same statistics; then each normalises its slice from shared
// memory and stores it. A thread only ever touches the shared-memory slots it
// loaded itself, so the passes need no barrier but the reductions'. The
// wrapper (ops/gn_silu_cuda.py, plan) picks cs so that a slice is at most
// 64 KB, which lets three CTAs share an SM and one CTA's loads overlap
// another's arithmetic: (32, 128, 256, 256) bf16 takes clusters of 8, the
// export encoder's (256, 128, 256, 256) fp32 clusters of 16 (above 8, the
// H100's non-portable size: a card that cannot place it fails at launch).
//
// Two-pass form (6 B / 12 B an element), for groups no cluster holds (the
// 4096^2 fp32 resolution probe: 256 MB a group): a statistics kernel gives
// each of `parts` CTAs per group a range of chunks, each chunk's (mean, M2)
// taken as above and merged in order into one partial in double; an apply
// kernel merges a group's partials in the same order and normalises from
// device memory.
//
// NHWC forms, for channels-last bf16 tensors, which the bf16 inference
// autoencoder keeps so that cuDNN's NHWC convolutions take them as they lie
// (models/autoencoder.py). A group is C / G adjacent channels at every
// pixel: at 128 channels in bf16, 4 of them, 8 bytes. A cluster that held a
// band of whole 32-byte sectors of groups, at every pixel of one image, was
// tried first and ran at 27-41% of the byte bound at the decoders' shapes
// whatever its band, cluster and CTA size (PERF.md): a band's accesses are
// strided, and at 256^2 a band (2 MB) takes a whole SM per CTA, whose
// phases then run in lockstep with the others'. What is kept:
//
// Grid form: one cooperative launch of one CTA an SM, NHWC_THREADS threads.
// A round holds `images` whole images (one at 256^2 x 128 in bf16: 16 MB
// over 132 CTAs of 124 KB), each CTA a slice of whole pixels, all channels,
// read contiguously by cp.async. Each CTA takes its slice's (mean, M2) of
// every group as the cluster form does (its threads' sums, the mean, the
// centred squares) and writes them out; a grid barrier; every CTA of an
// image then stages the image's partials in shared memory, merges them in
// the same order (in double: the mean from the counts times means, M2 from
// theirs plus the counts times the means' squared distance), and normalises
// its slice from shared memory, each thread with its column's affine in
// registers, issuing the copy of its slice of the next round's image into
// each slot once the slot's output is stored. Each element is read once and
// written once; the partials take two buffers, by the round's parity.
//
// Two-pass form, for what the grid form does not take (an image more than
// its round holds, widths unsuited to 16-byte accesses, misaligned
// pointers): a band is `band` groups whose channels fill a 32-byte sector
// at every pixel of one image; a statistics kernel takes chunks of a
// band's pixels as above and writes each group's merged (mean, M2) per
// part; an apply kernel merges them and normalises from device memory,
// the images last to first so that the last ones read may come from L2.
//
// Offsets into the tensor are 64-bit (it may pass 2^31 elements); offsets
// within a group are 32-bit (the wrapper refuses n >= 2^31). Every sum is
// taken in a fixed order, so two launches give the same bits. The 16-byte
// path needs x, out 16-byte aligned and, in NCHW, n and H W to be multiples
// of 16 bytes' worth of elements, in NHWC a band's channels and a group's
// channels a multiple of it (or a group a half or a quarter of it);
// otherwise the same kernels read one element at a time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;       // threads per CTA
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;          // 16-byte loads a thread keeps in flight
constexpr int MAX_CLUSTER = 16;    // CTAs per group in the cluster form, at most
constexpr int NHWC_THREADS = 512;  // threads per CTA of the NHWC forms
constexpr int NHWC_WARPS = NHWC_THREADS / 32;
constexpr int MAX_BAND = 32;       // groups a CTA sums in the NHWC forms, at most

// ---------------------------------------------------------------- element access

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf_pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Io<T, V>: V elements of T as one access, 16 bytes or one element; pack
// rounds to T, round rounds in place
template <typename T, int V> struct Io;

template <> struct Io<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const Raw* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ void round(float (&)[4]) {}
};

template <> struct Io<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const Raw* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) { f[0] = r; }
  static __device__ __forceinline__ Raw pack(const float (&f)[1]) { return f[0]; }
  static __device__ __forceinline__ void round(float (&)[1]) {}
};

template <> struct Io<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const Raw* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) { f[2 * i] = bf_lo(u[i]); f[2 * i + 1] = bf_hi(u[i]); }
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[8]) {
    return make_uint4(bf_pack(f[0], f[1]), bf_pack(f[2], f[3]), bf_pack(f[4], f[5]),
                      bf_pack(f[6], f[7]));
  }
  // each value rounded to bf16, two to a conversion
  static __device__ __forceinline__ void round(float (&f)[8]) {
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const uint32_t u = bf_pack(f[i], f[i + 1]);
      f[i] = bf_lo(u);
      f[i + 1] = bf_hi(u);
    }
  }
};

template <> struct Io<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ Raw load(const Raw* p) { return __ldg(p); }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[1]) {
    return __float2bfloat16_rn(f[0]);
  }
  static __device__ __forceinline__ void round(float (&f)[1]) {
    f[0] = __bfloat162float(__float2bfloat16_rn(f[0]));
  }
};


// F.silu's arithmetic, z / (1 + exp(-z)) in fp32, on V values in place.
__device__ __forceinline__ float silu(float z) { return z / (1.0f + expf(-z)); }

// For fp32 outputs the IEEE quotient and expf (F.silu's bits). For bf16
// outputs, where no value of the access is below -80, the hardware
// reciprocal's quotient (__fdividef) and __expf: rounded to bf16 they give
// F.silu's bits at every bf16 z above -80 (all 65536 bf16 values are checked
// on the card, tests/test_torch_gn_silu.py); below, where 1 + exp(-z) nears
// 2^126 and __fdividef flushes the quotient to 0, the IEEE path.
template <typename T, int V> __device__ __forceinline__ void silu_all(float (&f)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = silu(f[v]);
}
template <int V> __device__ __forceinline__ void silu_bf16(float (&f)[V]) {
  float lo = f[0];
#pragma unroll
  for (int v = 1; v < V; ++v) lo = fminf(lo, f[v]);
  if (lo > -80.0f) {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = __fdividef(f[v], 1.0f + __expf(-f[v]));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = silu(f[v]);
  }
}
template <> __device__ __forceinline__ void silu_all<__nv_bfloat16, 8>(float (&f)[8]) {
  silu_bf16<8>(f);
}
template <> __device__ __forceinline__ void silu_all<__nv_bfloat16, 1>(float (&f)[1]) {
  silu_bf16<1>(f);
}

// pairwise sum of V values in a fixed order
template <int V> __device__ __forceinline__ float tree_sum(float (&f)[V]) {
#pragma unroll
  for (int width = V; width > 1; width /= 2) {
#pragma unroll
    for (int i = 0; i < width / 2; ++i) f[i] = f[2 * i] + f[2 * i + 1];
  }
  return f[0];
}

// ---------------------------------------------------------------- statistics

// The CTA's sum of v, the same on every thread: each warp by shuffles (lane
// 0's value), then the warps in order. `red` holds WARPS floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();   // the previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s += red[w];
  return s;
}

// (n_a, mean_a, m2_a) <- the merge of (n_a, mean_a, m2_a) and (n_b, mean_b,
// m2_b) (Chan, Golub and LeVeque); n_b > 0
__device__ __forceinline__ void chan_merge(double& n_a, double& mean_a, double& m2_a, double n_b,
                                           double mean_b, double m2_b) {
  const double n = n_a + n_b;
  const double d = mean_b - mean_a;
  mean_a += d * (n_b / n);
  m2_a += m2_b + d * d * (n_a * n_b / n);
  n_a = n;
}

// Copies nvec accesses of src to sm (the thread's own slots j = threadIdx.x +
// k THREADS) and returns the thread's sum of them.
template <typename T, int V>
__device__ __forceinline__ float load_slice(const typename Io<T, V>::Raw* __restrict__ src,
                                            typename Io<T, V>::Raw* sm, int nvec) {
  using IO = Io<T, V>;
  using R = typename IO::Raw;
  float acc = 0.f;
  int j = threadIdx.x;
  for (; j + (UNROLL - 1) * THREADS < nvec; j += UNROLL * THREADS) {
    R r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = IO::load(src + j + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      sm[j + u * THREADS] = r[u];
      float f[V];
      IO::unpack(r[u], f);
      acc += tree_sum<V>(f);
    }
  }
  for (; j < nvec; j += THREADS) {
    const R r = IO::load(src + j);
    sm[j] = r;
    float f[V];
    IO::unpack(r, f);
    acc += tree_sum<V>(f);
  }
  return acc;
}

// The thread's sum of (x - mean)^2 over its slots of sm.
template <typename T, int V>
__device__ __forceinline__ float centred_squares(const typename Io<T, V>::Raw* sm, int nvec,
                                                 float mean) {
  float acc[2] = {0.f, 0.f};
  for (int j = threadIdx.x; j < nvec; j += THREADS) {
    float f[V];
    Io<T, V>::unpack(sm[j], f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = f[v] - mean;
      acc[v & 1] = fmaf(d, d, acc[v & 1]);
    }
  }
  return acc[0] + acc[1];
}

// (mean, M2) of cnt elements, nvec accesses, copied from src to sm; every
// thread gets them
template <typename T, int V>
__device__ __forceinline__ float2 range_stats(const typename Io<T, V>::Raw* __restrict__ src,
                                              typename Io<T, V>::Raw* sm, int nvec, int cnt,
                                              float* red) {
  const float total = block_sum(load_slice<T, V>(src, sm, nvec), red);
  const float mean = cnt > 0 ? total / cnt : 0.f;
  return make_float2(mean, block_sum(centred_squares<T, V>(sm, nvec, mean), red));
}

__device__ __forceinline__ float2 mean_rstd(double mean, double m2, int n, int ddof, float eps) {
  const float var = static_cast<float>(m2 / max(n - ddof, 1));
  return make_float2(static_cast<float>(mean), rsqrtf(var + eps));
}

// ---------------------------------------------------------------- normalise

// Writes the output of the thread's accesses j of src (element e0 + j V of the
// group) to dst. w and b start at the group's first channel; a channel is hw
// elements, a multiple of V.
template <typename T, int V, bool ACT>
__device__ __forceinline__ void apply_range(const typename Io<T, V>::Raw* src,
                                            typename Io<T, V>::Raw* __restrict__ dst, int nvec,
                                            int e0, int hw, const float* __restrict__ w,
                                            const float* __restrict__ b, float2 stat) {
  using IO = Io<T, V>;
  int j = threadIdx.x;
  if (j >= nvec) return;
  const int e = e0 + j * V;
  int ch = e / hw, rem = e - ch * hw;
  const int step = THREADS * V, sq = step / hw, sr = step - sq * hw;
  for (; j < nvec; j += THREADS) {
    // the channel's affine: (x - mean) a + b, a = rstd w
    const float a = stat.y * __ldg(w + ch);
    const float c = __ldg(b + ch);
    float f[V];
    IO::unpack(src[j], f);
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = fmaf(f[v] - stat.x, a, c);
    if (ACT) {
      IO::round(f);
      silu_all<T, V>(f);
    }
    dst[j] = IO::pack(f);
    rem += sr;
    ch += sq;
    if (rem >= hw) { rem -= hw; ++ch; }
  }
}

template <typename T, int V>
__device__ __forceinline__ void apply(const typename Io<T, V>::Raw* src,
                                      typename Io<T, V>::Raw* __restrict__ dst, int nvec, int e0,
                                      int hw, const float* __restrict__ w,
                                      const float* __restrict__ b, float2 stat, int act) {
  if (act) apply_range<T, V, true>(src, dst, nvec, e0, hw, w, b, stat);
  else apply_range<T, V, false>(src, dst, nvec, e0, hw, w, b, stat);
}

// ---------------------------------------------------------------- kernels

// Cluster form: grid groups * cs CTAs in clusters of cs, one cluster a group;
// dynamic shared memory slice * sizeof(T).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 3)
gn_silu_cluster_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y, int G, int n, int hw,
                       int cs, int slice, int act, float eps, int ddof) {
  using R = typename Io<T, V>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  R* sm = reinterpret_cast<R*>(smem);
  __shared__ float red[WARPS];
  __shared__ float2 part;   // this CTA's (mean, M2), read by the whole cluster
  __shared__ float2 stat;   // the group's (mean, rstd)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long group = blockIdx.x / cs;
  const int e0 = rank * slice;
  const int cnt = max(0, min(slice, n - e0));
  const long long base = group * n + (cnt > 0 ? e0 : 0);
  const R* src = reinterpret_cast<const R*>(x + base);
  R* dst = reinterpret_cast<R*>(y + base);
  const float2 local = range_stats<T, V>(src, sm, cnt / V, cnt, red);
  if (threadIdx.x == 0) part = local;
  cluster.sync();
  if (threadIdx.x == 0) {
    double na = 0.0, mean = 0.0, m2 = 0.0;
    for (int r = 0; r < cs; ++r) {
      const int nb = max(0, min(slice, n - r * slice));
      if (nb == 0) continue;
      const float2 p = *cluster.map_shared_rank(&part, r);
      chan_merge(na, mean, m2, nb, p.x, p.y);
    }
    stat = mean_rstd(mean, m2, n, ddof, eps);
  }
  cluster.sync();   // the merge is done: no CTA reads another's part after this
  const int c0 = static_cast<int>(group % G) * (n / hw);
  apply<T, V>(sm, dst, cnt / V, e0, hw, w + c0, b + c0, stat, act);
}

// Two-pass form, statistics: grid groups * parts; CTA p of a group takes
// chunks [p per, (p + 1) per) of `chunk` elements, per = ceil(chunks / parts),
// and writes their merged (mean, M2) to partials[group * parts + p]; dynamic
// shared memory chunk * sizeof(T).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 3)
gn_stats_kernel(const T* __restrict__ x, double2* __restrict__ partials, int n, int chunk,
                int parts) {
  using R = typename Io<T, V>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  R* sm = reinterpret_cast<R*>(smem);
  __shared__ float red[WARPS];
  const long long group = blockIdx.x / parts;
  const int p = blockIdx.x % parts;
  const int chunks = static_cast<int>((n + static_cast<long long>(chunk) - 1) / chunk);
  const int per = (chunks + parts - 1) / parts;
  const int first = min(chunks, p * per), last = min(chunks, first + per);
  double na = 0.0, mean = 0.0, m2 = 0.0;
  for (int c = first; c < last; ++c) {
    const int e0 = c * chunk;
    const int cnt = min(chunk, n - e0);
    const R* src = reinterpret_cast<const R*>(x + group * n + e0);
    const float2 s = range_stats<T, V>(src, sm, cnt / V, cnt, red);
    if (threadIdx.x == 0) chan_merge(na, mean, m2, cnt, s.x, s.y);
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = make_double2(mean, m2);
}

// Two-pass form, apply: grid groups * chunks, a CTA a chunk.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const double2* __restrict__ partials,
                const float* __restrict__ w, const float* __restrict__ b, T* __restrict__ y, int G,
                int n, int hw, int chunk, int parts, int act, float eps, int ddof) {
  using R = typename Io<T, V>::Raw;
  __shared__ float2 stat;
  const int chunks = static_cast<int>((n + static_cast<long long>(chunk) - 1) / chunk);
  const long long group = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  if (threadIdx.x == 0) {
    const long long per = (chunks + parts - 1) / parts;
    double na = 0.0, mean = 0.0, m2 = 0.0;
    for (int p = 0; p < parts; ++p) {
      const long long lo = min(static_cast<long long>(n), p * per * chunk);
      const long long hi = min(static_cast<long long>(n), (p + 1) * per * chunk);
      if (hi <= lo) continue;
      const double2 q = partials[group * parts + p];
      chan_merge(na, mean, m2, static_cast<double>(hi - lo), q.x, q.y);
    }
    stat = mean_rstd(mean, m2, n, ddof, eps);
  }
  __syncthreads();
  const int e0 = c * chunk;
  const int cnt = min(chunk, n - e0);
  const long long base = group * n + e0;
  const int c0 = static_cast<int>(group % G) * (n / hw);
  apply<T, V>(reinterpret_cast<const R*>(x + base), reinterpret_cast<R*>(y + base), cnt / V, e0,
              hw, w + c0, b + c0, stat, act);
}

// ---------------------------------------------------------------- NHWC form

// A band is `band` adjacent groups, bc = band cg channels, at every pixel of
// one image; a pixel's part of it is apx = bc / V accesses (columns). The
// CTA's threads take rows = NHWC_THREADS / apx pixels at a time: thread t
// column t % apx of pixel t / apx, the threads past rows apx none. A column's
// V channels lie in the band's groups g0 .. g0 + GPA - 1 (GPA > 1 only where
// a group is V / GPA channels).
struct Lane {
  int q, p0, rows, g0;
};

__device__ __forceinline__ Lane lane_of(int apx, int V, int cg) {
  Lane l;
  l.rows = NHWC_THREADS / apx;
  l.q = threadIdx.x % apx;
  l.p0 = static_cast<int>(threadIdx.x) < l.rows * apx ? threadIdx.x / apx : (1 << 30);
  l.g0 = l.q * V / cg;
  return l;
}

// adds an access's V values to the sums of its GPA groups, V / GPA values
// each, in a fixed order
template <int V, int GPA>
__device__ __forceinline__ void add_groups(const float (&f)[V], float (&acc)[GPA]) {
  constexpr int CG = V / GPA;
#pragma unroll
  for (int i = 0; i < GPA; ++i) {
    float part[CG];
#pragma unroll
    for (int v = 0; v < CG; ++v) part[v] = f[i * CG + v];
    acc[i] += tree_sum<CG>(part);
  }
}

// Issues the copies of the thread's columns of pixels [0, npix) from src
// (`stride` 16-byte accesses a pixel) to the shared memory at s0 (apx
// accesses a pixel) by cp.async, all in flight at once with no registers
// held; cp.async.wait_all ends them.
template <typename T, int V>
__device__ __forceinline__ void issue_band(const typename Io<T, V>::Raw* src, long long stride,
                                           unsigned s0, int npix, int apx, const Lane& l) {
  static_assert(sizeof(typename Io<T, V>::Raw) == 16, "cp.async copies 16-byte accesses");
  for (int p = l.p0; p < npix; p += l.rows)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     s0 + static_cast<unsigned>(p * apx + l.q) * 16u),
                 "l"(src + p * stride + l.q)
                 : "memory");
}

// Adds the thread's own slots of pixels [0, npix) of sm to its sums (no
// barrier: no thread reads another's slots).
template <typename T, int V, int GPA>
__device__ __forceinline__ void sum_band(const typename Io<T, V>::Raw* sm, int npix, int apx,
                                         const Lane& l, float (&acc)[GPA]) {
#pragma unroll 4
  for (int p = l.p0; p < npix; p += l.rows) {
    float f[V];
    Io<T, V>::unpack(sm[p * apx + l.q], f);
    add_groups<V, GPA>(f, acc);
  }
}

// Copies the thread's columns of pixels [0, npix) from src (`stride`
// accesses a pixel) to sm (apx accesses a pixel) and adds them to its sums:
// 16-byte accesses by cp.async, single elements through registers, UNROLL
// in flight.
template <typename T, int V, int GPA>
__device__ __forceinline__ void load_band(const typename Io<T, V>::Raw* __restrict__ src,
                                          long long stride, typename Io<T, V>::Raw* sm, int npix,
                                          int apx, const Lane& l, float (&acc)[GPA]) {
  using IO = Io<T, V>;
  using R = typename IO::Raw;
  if constexpr (sizeof(R) == 16) {
    issue_band<T, V>(src, stride, static_cast<unsigned>(__cvta_generic_to_shared(sm)), npix,
                     apx, l);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    sum_band<T, V, GPA>(sm, npix, apx, l, acc);
  } else {
    int p = l.p0;
    for (; p + (UNROLL - 1) * l.rows < npix; p += UNROLL * l.rows) {
      R r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) r[u] = IO::load(src + (p + u * l.rows) * stride + l.q);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        sm[(p + u * l.rows) * apx + l.q] = r[u];
        float f[V];
        IO::unpack(r[u], f);
        add_groups<V, GPA>(f, acc);
      }
    }
    for (; p < npix; p += l.rows) {
      const R r = IO::load(src + p * stride + l.q);
      sm[p * apx + l.q] = r;
      float f[V];
      IO::unpack(r, f);
      add_groups<V, GPA>(f, acc);
    }
  }
}

// The sum of v over a warp, the same in every lane (IEEE addition commutes,
// so lanes l and l ^ o add the same pair).
template <typename F> __device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sum of each of the band's groups into out[g], g < band, in a
// fixed order. The threads' values go to red as `units` rows of apx columns
// (red[(u apx + q) GPA + i]): where apx is a power of two up to 32 (every
// 16-byte path) a lane's column is lane % apx, shuffles first sum each
// warp's lanes of a column and a unit is a warp; otherwise a unit is a row
// of threads. Then warp w sums groups w, w + NHWC_WARPS, ..., its lanes over
// the units of the group's columns [g cg / V, ceil((g + 1) cg / V)).
template <int GPA>
__device__ __forceinline__ void band_sums(const float (&acc)[GPA], float* red, float* out,
                                          int band, int apx, int V, int cg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();   // the previous call's readers are done with red and out
  int units;
  if (apx <= 32 && (apx & (apx - 1)) == 0) {
    float v[GPA];
#pragma unroll
    for (int i = 0; i < GPA; ++i) {
      v[i] = acc[i];
      for (int o = 16; o >= apx; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
    if (lane < apx) {
#pragma unroll
      for (int i = 0; i < GPA; ++i) red[(warp * apx + lane) * GPA + i] = v[i];
    }
    units = NHWC_WARPS;
  } else {
#pragma unroll
    for (int i = 0; i < GPA; ++i) red[threadIdx.x * GPA + i] = acc[i];
    units = NHWC_THREADS / apx;
  }
  __syncthreads();
  for (int g = warp; g < band; g += NHWC_WARPS) {
    const int qlo = g * cg / V, nq = ((g + 1) * cg + V - 1) / V - qlo;
    float s = 0.f;
    for (int i = lane; i < nq * units; i += 32) {
      const int q = qlo + i % nq;
      s += red[((i / nq) * apx + q) * GPA + g - q * V / cg];
    }
    s = warp_sum(s);
    if (lane == 0) out[g] = s;
  }
  __syncthreads();
}

// Each of the band's groups' (mean, M2) over the npix pixels the CTA holds in
// sm (acc: the thread's sums from load_band), written to part[g] by thread g.
template <typename T, int V, int GPA>
__device__ __forceinline__ void band_stats(const typename Io<T, V>::Raw* sm, int npix, int apx,
                                           const Lane& l, int band, int cg, float (&acc)[GPA],
                                           float* red, float* sums, float* means, float2* part) {
  constexpr int CG = V / GPA;
  band_sums<GPA>(acc, red, sums, band, apx, V, cg);
  const float cnt = static_cast<float>(npix) * cg;
  if (static_cast<int>(threadIdx.x) < band) means[threadIdx.x] = npix > 0 ? sums[threadIdx.x] / cnt : 0.f;
  __syncthreads();
  float mean[GPA], sq[2][GPA];
#pragma unroll
  for (int i = 0; i < GPA; ++i) {
    mean[i] = means[l.g0 + i];
    sq[0][i] = sq[1][i] = 0.f;
  }
#pragma unroll 4
  for (int p = l.p0; p < npix; p += l.rows) {
    float f[V];
    Io<T, V>::unpack(sm[p * apx + l.q], f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = f[v] - mean[v / CG];
      sq[v & 1][v / CG] = fmaf(d, d, sq[v & 1][v / CG]);
    }
  }
#pragma unroll
  for (int i = 0; i < GPA; ++i) sq[0][i] += sq[1][i];
  band_sums<GPA>(sq[0], red, sums, band, apx, V, cg);
  if (static_cast<int>(threadIdx.x) < band)
    part[threadIdx.x] = make_float2(means[threadIdx.x], sums[threadIdx.x]);
}

// Writes the output of the thread's columns of pixels [0, npix) of src
// (`sstride` accesses a pixel) to dst (`dstride`). w and b start at the
// band's first channel; stat holds the band's groups' (mean, rstd).
template <typename T, int V, bool ACT>
__device__ __forceinline__ void apply_band_range(const typename Io<T, V>::Raw* src, long long sstride,
                                                 typename Io<T, V>::Raw* __restrict__ dst,
                                                 long long dstride, int npix, const Lane& l,
                                                 const float* __restrict__ w,
                                                 const float* __restrict__ b, const float2* stat,
                                                 int cg) {
  using IO = Io<T, V>;
  // the column's affine: (x - mean) a + b, a = rstd w, the same at every pixel
  float mu[V], a[V], c[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int ch = l.q * V + v;
    const float2 s = stat[ch / cg];
    mu[v] = s.x;
    a[v] = s.y * __ldg(w + ch);
    c[v] = __ldg(b + ch);
  }
#pragma unroll 4
  for (int p = l.p0; p < npix; p += l.rows) {
    float f[V];
    IO::unpack(src[p * sstride + l.q], f);
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = fmaf(f[v] - mu[v], a[v], c[v]);
    if (ACT) {
      IO::round(f);
      silu_all<T, V>(f);
    }
    dst[p * dstride + l.q] = IO::pack(f);
  }
}

template <typename T, int V>
__device__ __forceinline__ void apply_band(const typename Io<T, V>::Raw* src, long long sstride,
                                           typename Io<T, V>::Raw* __restrict__ dst,
                                           long long dstride, int npix, const Lane& l,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, const float2* stat,
                                           int cg, int act) {
  if (act) apply_band_range<T, V, true>(src, sstride, dst, dstride, npix, l, w, b, stat, cg);
  else apply_band_range<T, V, false>(src, sstride, dst, dstride, npix, l, w, b, stat, cg);
}

// Each group's (mean, rstd) of an image into stat[g], from the (mean, M2)
// of its cs CTAs in `from` ([CTA][group], written in this launch), the same
// in every CTA. The block is first copied to `stage` in shared memory by
// 16-byte cp.async.cg copies, past L1 (G even, so the block is 16-byte
// aligned), all in flight at once. Then, in double, lane g of warp w sums
// group g over CTAs w, w + NHWC_WARPS, ... (a warp's reads of one CTA's
// groups are consecutive: no bank conflicts) into red[w][g], and lane g of
// warp 0 sums the warps' in order: first the counts times the means, for
// the image's mean; then the CTAs' M2 and their counts times their means'
// squared distance from it. G is at most 32.
__device__ __forceinline__ void merge_image(const float2* from, float2* stage, double* red, int cs,
                                            int slice, int hw, int G, int cg, int ddof, float eps,
                                            float2* stat) {
  const unsigned st = static_cast<unsigned>(__cvta_generic_to_shared(stage));
  for (int i = threadIdx.x; 2 * i < cs * G; i += NHWC_THREADS)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(st + 16u * i),
                 "l"(from + 2 * i)
                 : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int g = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double n = static_cast<double>(cg) * hw;
  double v = 0.0;
  if (g < G) {
    for (int c = warp; c < cs; c += NHWC_WARPS) {
      const int nb = max(0, min(slice, hw - c * slice));
      v = fma(static_cast<double>(nb) * cg, static_cast<double>(stage[c * G + g].x), v);
    }
  }
  red[warp * 32 + g] = v;
  __syncthreads();
  if (warp == 0) {
    double sum = 0.0;
    for (int w = 0; w < NHWC_WARPS; ++w) sum += red[w * 32 + g];
    red[NHWC_WARPS * 32 + g] = sum / n;
  }
  __syncthreads();
  const double mean = red[NHWC_WARPS * 32 + g];
  v = 0.0;
  if (g < G) {
    for (int c = warp; c < cs; c += NHWC_WARPS) {
      const int nb = max(0, min(slice, hw - c * slice));
      if (nb == 0) continue;
      const float2 p = stage[c * G + g];
      const double d = static_cast<double>(p.x) - mean;
      v += p.y + static_cast<double>(nb) * cg * d * d;
    }
  }
  __syncthreads();   // every warp has read the mean
  red[warp * 32 + g] = v;
  __syncthreads();
  if (warp == 0 && g < G) {
    double m2 = 0.0;
    for (int w = 0; w < NHWC_WARPS; ++w) m2 += red[w * 32 + g];
    stat[g] = mean_rstd(mean, m2, cg * hw, ddof, eps);
  }
}

// Normalises the thread's slots of pixels [0, npix) of sm into dst
// (`stride` accesses a pixel), issuing the copy of the same slot of `next`
// (if any) into each slot once its value is out.
template <typename T, int V, bool ACT>
__device__ __forceinline__ void apply_prefetch(const typename Io<T, V>::Raw* sm, unsigned s0,
                                               int apx, typename Io<T, V>::Raw* __restrict__ dst,
                                               const typename Io<T, V>::Raw* next,
                                               long long stride, int npix, const Lane& l,
                                               const float* __restrict__ w,
                                               const float* __restrict__ b, const float2* stat,
                                               int cg) {
  using IO = Io<T, V>;
  float mu[V], a[V], c[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int ch = l.q * V + v;
    const float2 s = stat[ch / cg];
    mu[v] = s.x;
    a[v] = s.y * __ldg(w + ch);
    c[v] = __ldg(b + ch);
  }
  // UNROLL slots at a time: their values read, normalised and stored, then
  // the next image's copies into them issued (each after the store that
  // needs the slot's value)
  int p = l.p0;
  for (; p < npix; p += UNROLL * l.rows) {
    typename IO::Raw r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u * l.rows < npix) r[u] = sm[(p + u * l.rows) * apx + l.q];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pu = p + u * l.rows;
      if (pu >= npix) break;
      float f[V];
      IO::unpack(r[u], f);
#pragma unroll
      for (int v = 0; v < V; ++v) f[v] = fmaf(f[v] - mu[v], a[v], c[v]);
      if (ACT) {
        IO::round(f);
        silu_all<T, V>(f);
      }
      dst[pu * stride + l.q] = IO::pack(f);
    }
    if (next != nullptr) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int pu = p + u * l.rows;
        if (pu >= npix) break;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         s0 + static_cast<unsigned>(pu * apx + l.q) * 16u),
                     "l"(next + pu * stride + l.q)
                     : "memory");
      }
    }
  }
}

// NHWC grid form: a cooperative grid of `images` cs CTAs, all resident, one
// an SM. Round r takes images [r images, (r + 1) images): CTA c holds
// pixels [s slice, (s + 1) slice), s = c % cs, of image r images + c / cs,
// all its channels, in shared memory; its groups' (mean, M2) go to partials
// (one of two buffers, by the round's parity: a CTA writes round r + 2's
// only after the barrier of round r + 1, which every CTA reaches after
// merging round r's), a grid barrier, then every CTA of the image merges the
// image's partials and normalises its slice, issuing the copy of its slice
// of the next round's image into each slot as it frees it. 16-byte accesses
// only; dynamic shared memory slice C sizeof(T) + cs G sizeof(float2).
template <typename T, int V, int GPA>
__global__ void __launch_bounds__(NHWC_THREADS, 1)
gn_silu_nhwc_grid_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, T* __restrict__ y, float2* partials,
                         long long batch, int G, int cg, int hw, int cs, int slice, int images,
                         int act, float eps, int ddof) {
  using R = typename Io<T, V>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  R* sm = reinterpret_cast<R*>(smem);
  __shared__ float red[NHWC_THREADS * GPA];
  __shared__ float sums[MAX_BAND], means[MAX_BAND];
  __shared__ float2 part[MAX_BAND];   // this CTA's (mean, M2) a group
  __shared__ float2 stat[MAX_BAND];   // the image's groups' (mean, rstd)
  __shared__ double mred[(NHWC_WARPS + 1) * 32];   // the merge's per-warp sums, then the means
  cg::grid_group grid = cg::this_grid();
  const int C = G * cg, apx = C / V;
  // after the slice: the image's partials, staged for the merge
  float2* stage = reinterpret_cast<float2*>(smem + static_cast<size_t>(slice) * C * sizeof(T));
  const int j = blockIdx.x / cs, s = blockIdx.x % cs;
  const int npix = max(0, min(slice, hw - s * slice));
  const long long stride = C / V, per_image = static_cast<long long>(hw) * stride;
  const long long first = static_cast<long long>(s) * slice * stride;   // the slice in an image
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(sm));
  const Lane l = lane_of(apx, V, cg);
  const long long rounds = (batch + images - 1) / images;
  if (j < batch) issue_band<T, V>(reinterpret_cast<const R*>(x) + j * per_image + first, stride,
                                  s0, npix, apx, l);
  for (long long r = 0; r < rounds; ++r) {
    const long long image = r * images + j;
    const bool live = image < batch && npix > 0;
    float2* buf = partials + (r & 1) * static_cast<long long>(images) * cs * G;
    if (live) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      float acc[GPA] = {};
      sum_band<T, V, GPA>(sm, npix, apx, l, acc);
      band_stats<T, V, GPA>(sm, npix, apx, l, G, cg, acc, red, sums, means, part);
      if (static_cast<int>(threadIdx.x) < G) buf[blockIdx.x * G + threadIdx.x] = part[threadIdx.x];
    }
    __threadfence();
    grid.sync();
    if (live) {
      merge_image(buf + static_cast<long long>(j) * cs * G, stage, mred, cs, slice, hw, G, cg, ddof,
                  eps, stat);
      __syncthreads();
      const bool more = image + images < batch;
      const R* next = more ? reinterpret_cast<const R*>(x) + (image + images) * per_image + first
                           : nullptr;
      R* dst = reinterpret_cast<R*>(y) + image * per_image + first;
      if (act)
        apply_prefetch<T, V, true>(sm, s0, apx, dst, next, stride, npix, l, w, b, stat, cg);
      else
        apply_prefetch<T, V, false>(sm, s0, apx, dst, next, stride, npix, l, w, b, stat, cg);
    }
  }
}

// NHWC two-pass form, statistics: grid B (G / band) parts; CTA p of an
// (image, band) takes chunks [p per, (p + 1) per) of `chunk` pixels, per =
// ceil(chunks / parts), and writes each group's merged (mean, M2) to
// partials[(image G + group) parts + p]; dynamic shared memory chunk band cg
// sizeof(T).
template <typename T, int V, int GPA>
__global__ void __launch_bounds__(NHWC_THREADS, 1)
gn_nhwc_stats_kernel(const T* __restrict__ x, double2* __restrict__ partials, int G, int cg,
                     int hw, int band, int chunk, int parts) {
  using R = typename Io<T, V>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  R* sm = reinterpret_cast<R*>(smem);
  __shared__ float red[NHWC_THREADS * GPA];
  __shared__ float sums[MAX_BAND], means[MAX_BAND];
  __shared__ float2 part[MAX_BAND];
  const long long id = blockIdx.x / parts;
  const int p = blockIdx.x % parts;
  const int bands = G / band;
  const long long image = id / bands;
  const int k = static_cast<int>(id % bands);
  const int C = G * cg, bc = band * cg, apx = bc / V;
  const int chunks = (hw + chunk - 1) / chunk;
  const int per = (chunks + parts - 1) / parts;
  const int first = min(chunks, p * per), last = min(chunks, first + per);
  const Lane l = lane_of(apx, V, cg);
  double na = 0.0, mean = 0.0, m2 = 0.0;   // thread g's group
  for (int c = first; c < last; ++c) {
    const int p0 = c * chunk;
    const int npix = min(chunk, hw - p0);
    const long long base = (image * hw + p0) * C + static_cast<long long>(k) * bc;
    float acc[GPA] = {};
    load_band<T, V, GPA>(reinterpret_cast<const R*>(x + base), C / V, sm, npix, apx, l, acc);
    band_stats<T, V, GPA>(sm, npix, apx, l, band, cg, acc, red, sums, means, part);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < band)
      chan_merge(na, mean, m2, static_cast<double>(npix) * cg, part[threadIdx.x].x,
                 part[threadIdx.x].y);
  }
  if (static_cast<int>(threadIdx.x) < band)
    partials[(image * G + k * band + threadIdx.x) * parts + p] = make_double2(mean, m2);
}

// NHWC two-pass form, apply: grid B (G / band) chunks, a CTA a chunk of an
// (image, band), the last image first: the statistics kernel read it last,
// so its second read may come from L2.
template <typename T, int V>
__global__ void __launch_bounds__(NHWC_THREADS, 1)
gn_nhwc_apply_kernel(const T* __restrict__ x, const double2* __restrict__ partials,
                     const float* __restrict__ w, const float* __restrict__ b, T* __restrict__ y,
                     long long images, int G, int cg, int hw, int band, int chunk, int parts,
                     int act, float eps, int ddof) {
  using R = typename Io<T, V>::Raw;
  __shared__ float2 stat[MAX_BAND];
  const int bands = G / band;
  const int chunks = (hw + chunk - 1) / chunk;
  const long long per_image = static_cast<long long>(bands) * chunks;
  const long long image = images - 1 - blockIdx.x / per_image;
  const int k = static_cast<int>(blockIdx.x % per_image / chunks);
  const int c = static_cast<int>(blockIdx.x % chunks);
  if (static_cast<int>(threadIdx.x) < band) {
    const long long per = (chunks + parts - 1) / parts;
    double na = 0.0, mean = 0.0, m2 = 0.0;
    for (int p = 0; p < parts; ++p) {
      const long long lo = min(static_cast<long long>(hw), p * per * chunk);
      const long long hi = min(static_cast<long long>(hw), (p + 1) * per * chunk);
      if (hi <= lo) continue;
      const double2 q = partials[(image * G + k * band + threadIdx.x) * parts + p];
      chan_merge(na, mean, m2, static_cast<double>(hi - lo) * cg, q.x, q.y);
    }
    stat[threadIdx.x] = mean_rstd(mean, m2, cg * hw, ddof, eps);
  }
  __syncthreads();
  const int C = G * cg, bc = band * cg;
  const int p0 = c * chunk;
  const long long base = (image * hw + p0) * C + static_cast<long long>(k) * bc;
  const Lane l = lane_of(bc / V, V, cg);
  apply_band<T, V>(reinterpret_cast<const R*>(x + base), C / V, reinterpret_cast<R*>(y + base),
                   C / V, min(chunk, hw - p0), l, w + k * bc, b + k * bc, stat, cg, act);
}

// ---------------------------------------------------------------- launch

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// Opts a kernel in to the card's largest dynamic shared memory, the
// carve-out that favours shared memory and (cluster kernel) clusters of 16,
// once per device (`done`: one bit a device).
template <typename Kernel>
cudaError_t opt_in(Kernel kern, bool cluster, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ((done >> dev) & 1ull)) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - static_cast<int>(attr.sharedSizeBytes));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  if (cluster) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  if (dev < 64) done |= 1ull << dev;
  return cudaSuccess;
}

template <typename T, int V>
cudaError_t launch(const void* x, const float* w, const float* b, void* y, double2* partials,
                   long long groups, int G, int n, int hw, int cs, int slice, int parts, int act,
                   float eps, int ddof, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const size_t smem = static_cast<size_t>(slice) * sizeof(T);
  cudaError_t e;
  if (parts == 0) {
    static unsigned long long done = 0;
    const auto kern = &gn_silu_cluster_kernel<T, V>;
    e = opt_in(kern, true, done);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(groups * cs));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, xt, w, b, yt, G, n, hw, cs, slice, act, eps, ddof);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  static unsigned long long done_stats = 0;
  e = opt_in(&gn_stats_kernel<T, V>, false, done_stats);
  if (e != cudaSuccess) return e;
  gn_stats_kernel<T, V><<<static_cast<unsigned>(groups * parts), THREADS, smem, s>>>(
      xt, partials, n, slice, parts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long chunks = (n + static_cast<long long>(slice) - 1) / slice;
  gn_apply_kernel<T, V><<<static_cast<unsigned>(groups * chunks), THREADS, 0, s>>>(
      xt, partials, w, b, yt, G, n, hw, slice, parts, act, eps, ddof);
  return cudaGetLastError();
}

// The NHWC form of a call: the grid form (images > 0: `images` cs CTAs,
// slices of `slice` pixels, partials 2 images cs G float2) or the two-pass
// form (chunks of `slice` pixels, bands of `band` groups, partials groups
// parts double2).
template <typename T, int V, int GPA>
cudaError_t launch_nhwc(const void* x, const float* w, const float* b, void* y, void* partials,
                        long long groups, int G, int n, int hw, int band, int cs, int slice,
                        int parts, int images, int act, float eps, int ddof, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int cg = n / hw;
  const long long batch = groups / G;
  cudaError_t e;
  if (images > 0) {
    if constexpr (V == 1) {
      return cudaErrorInvalidValue;   // the grid form copies 16-byte accesses
    } else {
      static unsigned long long done = 0;
      const auto kern = &gn_silu_nhwc_grid_kernel<T, V, GPA>;
      e = opt_in(kern, false, done);
      if (e != cudaSuccess) return e;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeCooperative;
      attr.val.cooperative = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned>(images * cs));
      cfg.blockDim = dim3(NHWC_THREADS);
      cfg.dynamicSmemBytes = static_cast<size_t>(slice) * G * cg * sizeof(T) +
                             static_cast<size_t>(cs) * G * sizeof(float2);
      cfg.stream = s;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      e = cudaLaunchKernelEx(&cfg, kern, xt, w, b, yt, static_cast<float2*>(partials), batch, G,
                             cg, hw, cs, slice, images, act, eps, ddof);
      return e != cudaSuccess ? e : cudaGetLastError();
    }
  }
  const long long bands = batch * (G / band);
  const size_t smem = static_cast<size_t>(slice) * band * cg * sizeof(T);
  static unsigned long long done_stats = 0;
  e = opt_in(&gn_nhwc_stats_kernel<T, V, GPA>, false, done_stats);
  if (e != cudaSuccess) return e;
  auto* part = static_cast<double2*>(partials);
  gn_nhwc_stats_kernel<T, V, GPA><<<static_cast<unsigned>(bands * parts), NHWC_THREADS, smem, s>>>(
      xt, part, G, cg, hw, band, slice, parts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long chunks = (hw + static_cast<long long>(slice) - 1) / slice;
  gn_nhwc_apply_kernel<T, V><<<static_cast<unsigned>(bands * chunks), NHWC_THREADS, 0, s>>>(
      xt, part, w, b, yt, batch, G, cg, hw, band, slice, parts, act, eps, ddof);
  return cudaGetLastError();
}

// The NHWC form's template for V elements an access, a group cg channels:
// GPA = V / cg groups an access where cg < V, else 1.
template <typename T, int V>
cudaError_t launch_nhwc_groups(const void* x, const float* w, const float* b, void* y,
                               void* partials, long long groups, int G, int n, int hw, int band,
                               int cs, int slice, int parts, int images, int act, float eps,
                               int ddof, cudaStream_t s) {
  const int gpa = V > n / hw ? V / (n / hw) : 1;
  switch (gpa) {
    case 1:
      return launch_nhwc<T, V, 1>(x, w, b, y, partials, groups, G, n, hw, band, cs, slice, parts,
                                  images, act, eps, ddof, s);
    case 2:
      return launch_nhwc<T, V, (V >= 2 ? 2 : 1)>(x, w, b, y, partials, groups, G, n, hw, band,
                                                 cs, slice, parts, images, act, eps, ddof, s);
    case 4:
      return launch_nhwc<T, V, (V >= 4 ? 4 : 1)>(x, w, b, y, partials, groups, G, n, hw, band,
                                                 cs, slice, parts, images, act, eps, ddof, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// A call's shape and form, which the wrapper keeps from call to call
// (ops/gn_silu_cuda.py, Args: the same fields in this order).
struct GnArgs {
  long long groups;   // B G
  int G, n, hw;       // groups a batch, elements a group (C / G) H W, H W
  int bf16;           // the element type: fp32 (0) or bf16 (1)
  int vec;            // elements an access: 1 or 16 / sizeof(T)
  int cs;             // NCHW cluster form: CTAs a group; NHWC grid form: CTAs an image
  int slice;          // elements (NCHW) or pixels (NHWC) a CTA, or a chunk (two-pass forms)
  int parts;          // two-pass forms: statistics CTAs a group or band; 0 otherwise
  int act;            // SiLU after the GroupNorm
  int ddof;           // the variance's divisor is max(n - ddof, 1)
  int nhwc;           // the layout: contiguous NCHW (0) or channels-last (1)
  int band;           // NHWC two-pass form: groups a band
  int images;         // NHWC grid form: images a round; 0 in the two-pass form
  float eps;
};

// x and y (B, C, H, W), both fp32 or bf16 on the current device, both
// contiguous (nhwc 0) or, in bf16, both channels-last (nhwc 1); w and b C
// fp32 values;
// *args the shape and form: groups > 0, n a multiple of hw; vec 1 or 16 /
// sizeof(T) (then x and y 16-byte aligned). NCHW: with vec > 1, n and hw
// multiples of vec; cluster form (parts = 0): cs in {1, 2, 4, 8, 16}, slice a
// multiple of vec with cs slice >= n; two-pass form (parts >= 1): chunks of
// `slice` elements, `partials` groups parts double2 of scratch. NHWC grid
// form (images >= 1): vec > 1, C / G a multiple of vec or a half or quarter
// of it, C a multiple of vec, C / vec at most NHWC_THREADS, G at most
// MAX_BAND and even, cs slice >= hw, images cs CTAs that can all be resident on the
// card (the launch fails otherwise), `partials` 2 images cs G float2.
// NHWC two-pass form (images 0, parts >= 1): bands of `band` groups, dividing
// G, at most MAX_BAND, with vec > 1 band C / G a multiple of vec and C / G as
// above, band C / G / vec at most NHWC_THREADS; chunks of `slice` pixels;
// `partials` groups parts double2. Launches one kernel (cluster and grid
// forms) or two (two-pass) on `stream` and returns the first error (0 on
// success); does not synchronize.
extern "C" int vqt_gn_silu(const void* x, const void* w, const void* b, void* y, void* partials,
                           const GnArgs* args, void* stream) {
  const long long groups = args->groups;
  const int G = args->G, n = args->n, hw = args->hw, bf16 = args->bf16, vec = args->vec;
  const int cs = args->cs, slice = args->slice, parts = args->parts, act = args->act;
  const int ddof = args->ddof, nhwc = args->nhwc, band = args->band, images = args->images;
  const float eps = args->eps;
  const int wide = bf16 ? 8 : 4;
  bool ok = groups > 0 && G > 0 && n > 0 && hw > 0 && n % hw == 0 && slice > 0 &&
            (vec == 1 || vec == wide) && (nhwc == 0 || (nhwc == 1 && bf16)) && groups % G == 0;
  if (ok && vec > 1) ok = aligned(x, 16) && aligned(y, 16);
  const int cg = n / hw;
  const bool widths = vec == 1 || cg % vec == 0 || (vec % cg == 0 && vec / cg <= 4);
  if (ok && nhwc && images > 0) {
    ok = vec > 1 && widths && (G * cg) % vec == 0 && G * cg / vec <= NHWC_THREADS &&
         G <= MAX_BAND && G % 2 == 0 && cs >= 1 &&
         static_cast<long long>(cs) * slice >= hw &&
         static_cast<long long>(images) * cs <= INT_MAX && partials != nullptr;
  } else if (ok && nhwc) {
    const long long bands = groups / (band > 0 ? band : 1);
    ok = band >= 1 && band <= MAX_BAND && G % band == 0 && band * cg / vec <= NHWC_THREADS &&
         (band * cg) % vec == 0 && widths && parts > 0 && partials != nullptr &&
         bands * parts <= INT_MAX && bands * ((hw + static_cast<long long>(slice) - 1) / slice) <= INT_MAX;
  } else if (ok) {
    ok = slice % vec == 0 && (vec == 1 || (n % vec == 0 && hw % vec == 0));
    if (ok && parts == 0)
      ok = cs >= 1 && cs <= MAX_CLUSTER && (cs & (cs - 1)) == 0 &&
           static_cast<long long>(cs) * slice >= n &&
           static_cast<long long>(cs) * slice <= INT_MAX && groups * cs <= INT_MAX;
    if (ok && parts != 0)
      ok = parts > 0 && partials != nullptr && groups * parts <= INT_MAX &&
           groups * ((n + static_cast<long long>(slice) - 1) / slice) <= INT_MAX;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (nhwc) {
    e = vec > 1 ? launch_nhwc_groups<__nv_bfloat16, 8>(x, wp, bp, y, partials, groups, G, n, hw,
                                                       band, cs, slice, parts, images, act, eps,
                                                       ddof, s)
                : launch_nhwc_groups<__nv_bfloat16, 1>(x, wp, bp, y, partials, groups, G, n, hw,
                                                       band, cs, slice, parts, images, act, eps,
                                                       ddof, s);
  } else {
    auto* part = static_cast<double2*>(partials);
    if (bf16)
      e = vec > 1 ? launch<__nv_bfloat16, 8>(x, wp, bp, y, part, groups, G, n, hw, cs, slice,
                                             parts, act, eps, ddof, s)
                  : launch<__nv_bfloat16, 1>(x, wp, bp, y, part, groups, G, n, hw, cs, slice,
                                             parts, act, eps, ddof, s);
    else
      e = vec > 1 ? launch<float, 4>(x, wp, bp, y, part, groups, G, n, hw, cs, slice, parts, act,
                                     eps, ddof, s)
                  : launch<float, 1>(x, wp, bp, y, part, groups, G, n, hw, cs, slice, parts, act,
                                     eps, ddof, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* vqt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
