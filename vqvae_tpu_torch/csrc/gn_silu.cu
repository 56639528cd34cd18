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
// n = (C / G) H W elements -- it computes
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
// Offsets into the tensor are 64-bit (it may pass 2^31 elements); offsets
// within a group are 32-bit (the wrapper refuses n >= 2^31). Every sum is
// taken in a fixed order, so two launches give the same bits. The 16-byte
// path needs n and H W to be multiples of 16 bytes' worth of elements and x,
// out 16-byte aligned; otherwise the same kernels read one element at a time.

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

}  // namespace

// A call's shape and form, which the wrapper keeps from call to call
// (ops/gn_silu_cuda.py, Args: the same fields in this order).
struct GnArgs {
  long long groups;   // B G
  int G, n, hw;       // groups a batch, elements a group (C / G) H W, H W
  int bf16;           // the element type: fp32 (0) or bf16 (1)
  int vec;            // elements an access: 1 or 16 / sizeof(T)
  int cs;             // cluster form: CTAs a group
  int slice;          // elements a CTA (cluster form) or a chunk (two-pass form)
  int parts;          // two-pass form: statistics CTAs a group; 0 in the cluster form
  int act;            // SiLU after the GroupNorm
  int ddof;           // the variance's divisor is max(n - ddof, 1)
  float eps;
};

// x and y (B, C, H, W), both fp32 or bf16, contiguous on the current device;
// w and b C fp32 values; *args the shape and form: groups > 0, n a multiple
// of hw; vec 1 or 16 / sizeof(T) (then n and hw multiples of it, x and y
// 16-byte aligned). Cluster form (parts = 0): cs in {1, 2, 4, 8, 16}, slice a
// multiple of vec with cs slice >= n. Two-pass form (parts >= 1): chunks of
// `slice` elements, `partials` groups * parts double2 of scratch. Launches
// one kernel (cluster form) or two (two-pass) on `stream` and returns the
// first error (0 on success); does not synchronize.
extern "C" int vqt_gn_silu(const void* x, const void* w, const void* b, void* y, void* partials,
                           const GnArgs* args, void* stream) {
  const long long groups = args->groups;
  const int G = args->G, n = args->n, hw = args->hw, bf16 = args->bf16, vec = args->vec;
  const int cs = args->cs, slice = args->slice, parts = args->parts, act = args->act;
  const int ddof = args->ddof;
  const float eps = args->eps;
  const int wide = bf16 ? 8 : 4;
  bool ok = groups > 0 && G > 0 && n > 0 && hw > 0 && n % hw == 0 && slice > 0 &&
            (vec == 1 || vec == wide) && slice % vec == 0;
  if (ok && vec > 1)
    ok = n % vec == 0 && hw % vec == 0 && aligned(x, 16) && aligned(y, 16);
  if (ok && parts == 0)
    ok = cs >= 1 && cs <= MAX_CLUSTER && (cs & (cs - 1)) == 0 &&
         static_cast<long long>(cs) * slice >= n &&
         static_cast<long long>(cs) * slice <= INT_MAX && groups * cs <= INT_MAX;
  if (ok && parts != 0)
    ok = parts > 0 && partials != nullptr && groups * parts <= INT_MAX &&
         groups * ((n + static_cast<long long>(slice) - 1) / slice) <= INT_MAX;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* part = static_cast<double2*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16)
    e = vec > 1 ? launch<__nv_bfloat16, 8>(x, wp, bp, y, part, groups, G, n, hw, cs, slice, parts,
                                           act, eps, ddof, s)
                : launch<__nv_bfloat16, 1>(x, wp, bp, y, part, groups, G, n, hw, cs, slice, parts,
                                           act, eps, ddof, s);
  else
    e = vec > 1 ? launch<float, 4>(x, wp, bp, y, part, groups, G, n, hw, cs, slice, parts, act,
                                   eps, ddof, s)
                : launch<float, 1>(x, wp, bp, y, part, groups, G, n, hw, cs, slice, parts, act,
                                   eps, ddof, s);
  return static_cast<int>(e);
}

extern "C" const char* vqt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
