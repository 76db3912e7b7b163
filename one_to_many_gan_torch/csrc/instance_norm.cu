// Instance norm (+ optional fused ReLU) for Hopper (sm_90a), forward only.
//
// Replaces the JAX package's TPU kernel ops/pallas/instance_norm.py
// (_instance_norm_pallas, body _in_kernel): per (image, channel) plane,
// statistics over (H, W) in float32, biased variance, rsqrt(var + eps),
// optional ReLU, output in the input's dtype (float32 or bfloat16).
//
// What bounds it: bytes. It does a few flops per element, far below the
// card's ~295 operations per byte, so the least time is one read of the
// input and one write of the output at 3.35 TB/s.
//
// Design: each plane is read from device memory once and kept in shared
// memory while its statistics are taken, as the TPU kernel keeps it in
// VMEM. Every block owns one contiguous range of the flattened input and
// copies it into shared memory with 1-D bulk copies (TMA, cp.async.bulk)
// of 16-byte-aligned chunks, each completing on its own mbarrier; the
// copy covers the range rounded out to 16 bytes, so a range that starts
// mid-vector (hw no multiple of 8 in bf16, or a view at an odd offset)
// still moves as aligned 16-byte transfers. The chunks are summed as they
// land (pass 1: the sum, and in bfloat16 the sum of squares too); in
// float32 the centred variance (pass 2) and in both dtypes the
// normalise-and-write pass (3) read the on-chip copy. The output leaves
// as 16-byte stores, with scalar stores only where a plane's first or
// last 16 bytes are shared with a neighbour. The host-side wrapper
// (ops/cuda/instance_norm.py::plan) picks one of three layouts from
// (planes, hw, dtype) and passes it in; this entry validates it and never
// picks another:
//   packed    planes of at most 16 KB (the trunks' 30^2 and 62^2, the
//             encode's 64^2, serving's 128x64 in bf16): up to 8
//             consecutive planes per block of 256 threads, one warp or
//             more per plane;
//   resident  one plane per block, up to 128 KB (the 126^2, 128^2 and
//             256^2 bf16 planes);
//   cluster   a thread-block cluster of 2, 4 or 8 blocks per plane (the
//             plan takes 8, for planes over 128 KB: serving's 512x256):
//             each block holds a slice; the partial sums meet through
//             distributed shared memory, read in the same rank order by
//             every block.
// One block per plane for planes that fit, even where the planes are too
// few to fill the 132 SMs, measured faster than a cluster (PERF.md, PR 5).
// Sums run in float32 in a fixed order (per-thread, warp shuffles, warps
// in order, cluster ranks in order), with no atomics: the output is
// bitwise the same from run to run. The variance follows the function
// each dtype replaces. float32: the centred sum of squares over the
// on-chip copy, as the float32 oracle (ops/norm.py::instance_norm) and
// the JAX model path's float32 branch compute it. bfloat16: the moment
// statistics of the Pallas body (_in_kernel) and of the JAX model path's
// bf16 branch (ops/norm.py), var = max(E[x^2] - E[x]^2, 0) in float32,
// the squares summed in pass 1 beside the values (a bf16 value's square
// is exact in float32); the two differ where |mean| / std is of order
// 10^2 or more. In bfloat16 the normalisation rounds as ops/norm.py's
// bf16 path does: mean and rstd rounded to bf16, then
// bf16(bf16(x - mean) * rstd). A NaN passes through the ReLU.
//
// The split form (a plane whose rows are split into bands over the ranks
// of a spatial group, one_to_many_gan_torch/parallel/halo.py) runs the
// same kernel in two more modes, on the same layouts of the band's
// planes:
//   partials  statistics of each plane's band: float32 its mean and its
//             centred sum of squares (pass 1 and pass 2 over the on-chip
//             copy), bfloat16 its sum and sum of squares (pass 1); block
//             0 also writes the band's element count after the planes;
//   apply     combines the partials of every band, gathered [S, planes +
//             1, 2] in band order, in that fixed order (float32 by Chan's
//             pairwise update: n, mean and centred sum; bfloat16 by
//             summing the sums and squares, then the moment form), so
//             that every rank gets bitwise the same statistics, then
//             normalises the band (pass 3) as the whole-plane kernel
//             does.
// Between them the caller all-gathers the partials over the group.
//
// The bulk copy reads up to 15 bytes before and after a block's range,
// inside the 16-byte-aligned chunks that hold its first and last
// element; those bytes lie in the same page and allocation granule as
// the range and are never used.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// One bulk copy (and one mbarrier) per 16 KB of a block's range.
constexpr int kChunkBytes = 16384;
constexpr int kMaxChunks = 15;
// Dynamic shared memory a block may ask for: the card's 227 KB per block
// less 1 KB for the static arrays below (mbarriers, partial sums).
constexpr int kMaxDynamicSmem = 232448 - 1024;
constexpr int kMaxCluster = 8;
constexpr int kMaxThreads = 1024;

// 16 bytes of shared memory as float: 4 floats or 8 bf16 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static constexpr bool kMoments = false;  // centred variance
  __device__ __forceinline__ static void unpack(const uint4& q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ __forceinline__ static float get(const float* p) { return *p; }
  __device__ __forceinline__ static void put(float* p, float v) { *p = v; }
  __device__ __forceinline__ static float round(float v) { return v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr bool kMoments = true;  // E[x^2] - E[x]^2
  // bf16 is the high half of a float32: element 2k is the low half of
  // word k (little-endian), element 2k+1 the high half.
  __device__ __forceinline__ static void unpack(const uint4& q, float* v) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float get(const __nv_bfloat16* p) {
    return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// Thread 0: expect `bytes` on `bar` and start their bulk copy.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every thread: wait for the first phase of `bar` (its chunk has landed).
// A copy that never completes (a fault) traps after 2^22 polls instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 22)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Calls f(v) for each element of the shared-memory index range [lo, hi)
// that lies in the 16-byte vectors [qa, qb), visiting vectors
// qa + t, qa + t + stride, ... Interior vectors take no per-element test.
template <typename T, typename F>
__device__ __forceinline__ void visit(const T* s, int qa, int qb, int t, int stride, int lo,
                                      int hi, F f) {
  constexpr int N = Vec<T>::N;
#pragma unroll 2
  for (int q = qa + t; q < qb; q += stride) {
    float v[N];
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(s + q * N), v);
    const int e0 = q * N;
    if (e0 >= lo && e0 + N <= hi) {
#pragma unroll
      for (int k = 0; k < N; ++k) f(v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (e0 + k >= lo && e0 + k < hi) f(v[k]);
      }
    }
  }
}

// Sum of one float per thread over the `warps` warps from warp `w0` on,
// in warp order; every thread of the block calls it (one barrier).
__device__ __forceinline__ float group_sum(float v, float* red, int w0, int warps) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < warps; ++k) total += red[w0 + k];
  return total;
}

// The sum of `slot` over the cluster's ranks 0..size-1, the same tree in
// every warp of every block: lane r reads rank r, then xor shuffles.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* slot, int size) {
  const int lane = threadIdx.x & 31;
  return warp_sum(lane < size ? *cluster.map_shared_rank(slot, lane) : 0.f);
}

enum Mode { kWhole = 0, kPartials = 1, kApply = 2 };

// The statistics of `plane` from the partials of `parts` bands, gathered
// [parts, planes + 1, 2] (row `planes` of each band: its element count),
// combined in band order -> (mean, biased variance).
template <bool kMoments>
__device__ __forceinline__ void combine(const float* __restrict__ gathered, int parts,
                                        long long planes, long long plane, float* mean,
                                        float* var) {
  float n = 0.f, a = 0.f, b = 0.f;
  for (int t = 0; t < parts; ++t) {
    const float* g = gathered + static_cast<long long>(t) * (planes + 1) * 2;
    const float nt = g[planes * 2];
    const float pa = g[plane * 2];
    const float pb = g[plane * 2 + 1];
    if (kMoments) {
      a = __fadd_rn(a, pa);
      b = __fadd_rn(b, pb);
      n = __fadd_rn(n, nt);
    } else {
      // Chan: a = mean, b = centred sum of squares of the first bands
      const float nn = __fadd_rn(n, nt);
      const float f = __fdiv_rn(nt, fmaxf(nn, 1.f));
      const float delta = __fsub_rn(pa, a);
      a = __fadd_rn(a, __fmul_rn(delta, f));
      b = __fadd_rn(__fadd_rn(b, pb), __fmul_rn(__fmul_rn(delta, delta), __fmul_rn(n, f)));
      n = nn;
    }
  }
  if (kMoments) {
    *mean = a / n;
    *var = fmaxf(__fsub_rn(b / n, __fmul_rn(*mean, *mean)), 0.f);
  } else {
    *mean = a;
    *var = b / n;
  }
}

// One launch. Block b owns the contiguous range [start, start + n) of the
// flattened input:
//   cluster == 1: planes [b * ppb, b * ppb + ppb), one segment each,
//                 served by blockDim / ppb threads;
//   cluster  > 1: slice rank = b % cluster of plane b / cluster, one
//                 segment served by the whole block.
// kMode: kWhole (statistics and output), kPartials (the band's statistics
// into part[plane * 2 + {0, 1}], no output), kApply (statistics from
// `gathered`, the output).
template <typename T, bool kRelu, int kMode>
__global__ void __launch_bounds__(kMaxThreads)
    instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y, long long planes,
                         long long hw, int ppb, int cluster_size, float eps,
                         float* __restrict__ part, const float* __restrict__ gathered,
                         int parts) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bars[kMaxChunks];
  __shared__ float red_sum[kMaxThreads / 32];
  __shared__ float red_sq[kMaxThreads / 32];
  __shared__ float cl_part[2];

  const long long blk = blockIdx.x;
  long long start, n, plane0;
  int nseg;
  if (cluster_size > 1) {
    const long long plane = blk / cluster_size;
    plane0 = plane;
    const long long rank = blk % cluster_size;
    const long long slice = (hw + cluster_size - 1) / cluster_size;
    const long long s0 = min(rank * slice, hw);
    const long long s1 = min(s0 + slice, hw);
    start = plane * hw + s0;
    n = s1 - s0;
    nseg = 1;
  } else {
    const long long p0 = blk * ppb;
    plane0 = p0;
    const long long np = min(static_cast<long long>(ppb), planes - p0);
    start = p0 * hw;
    n = np * hw;
    nseg = static_cast<int>(np);
  }

  // The range rounded out to 16 bytes, in x and (for the stores) in y.
  const uintptr_t xs = reinterpret_cast<uintptr_t>(x + start);
  const uintptr_t xa = xs & ~static_cast<uintptr_t>(15);
  const int shift = static_cast<int>((xs - xa) / sizeof(T));
  const uint32_t nbytes =
      n > 0 ? static_cast<uint32_t>(((xs + n * sizeof(T) + 15) & ~static_cast<uintptr_t>(15)) - xa)
            : 0u;
  const int nchunks = static_cast<int>((nbytes + kChunkBytes - 1) / kChunkBytes);
  const uintptr_t ys = reinterpret_cast<uintptr_t>(y + start);
  T* ya = reinterpret_cast<T*>(ys & ~static_cast<uintptr_t>(15));
  const int yshift = static_cast<int>((ys - reinterpret_cast<uintptr_t>(ya)) / sizeof(T));
  const T* s = reinterpret_cast<const T*>(smem);

  if (threadIdx.x == 0) {
    for (int c = 0; c < nchunks; ++c) mbar_init(&bars[c]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < nchunks; ++c) {
      const uint32_t off = static_cast<uint32_t>(c) * kChunkBytes;
      const uint32_t bytes = min(static_cast<uint32_t>(kChunkBytes), nbytes - off);
      bulk_load(smem + off, reinterpret_cast<const unsigned char*>(xa) + off, bytes, &bars[c]);
    }
  }
  __syncthreads();  // the mbarriers are initialised before anyone waits

  // This thread's segment: elements [lo, hi) of the shared copy.
  const int gsize = blockDim.x / (cluster_size > 1 ? 1 : ppb);
  const int seg = threadIdx.x / gsize;
  const int gt = threadIdx.x % gsize;
  const bool active = seg < nseg;
  const int seg_len = cluster_size > 1 ? static_cast<int>(n) : static_cast<int>(hw);
  const int lo = shift + (active ? seg * seg_len : 0);
  const int hi = active ? lo + seg_len : lo;
  const int qlo = lo / N;
  const int qhi = (hi + N - 1) / N;
  const int w0 = seg * (gsize / 32);
  const int gwarps = gsize / 32;
  const float count = static_cast<float>(hw);

  // pass 1: the sum (bfloat16: and the sum of squares), each chunk as it
  // lands (kApply: only the wait)
  constexpr bool kMoments = Vec<T>::kMoments;
  float acc = 0.f, acc_sq = 0.f;
  constexpr int kChunkVecs = kChunkBytes / 16;
  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(&bars[c]);
    if (kMode != kApply && active) {
      visit(s, max(qlo, c * kChunkVecs), min(qhi, (c + 1) * kChunkVecs), gt, gsize, lo, hi,
            [&](float v) {
              acc += v;
              if (kMoments) acc_sq = __fadd_rn(acc_sq, __fmul_rn(v, v));
            });
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  float mean, var;
  if (kMode == kApply) {
    combine<kMoments>(gathered, parts, planes, plane0 + (active ? seg : 0), &mean, &var);
  } else {
    float total = group_sum(acc, red_sum, w0, gwarps);
    float total_sq = kMoments ? group_sum(acc_sq, red_sq, w0, gwarps) : 0.f;
    if (cluster_size > 1) {
      if (threadIdx.x == 0) {
        cl_part[0] = total;
        cl_part[1] = total_sq;
      }
      cluster.sync();
      total = cluster_sum(cluster, &cl_part[0], cluster_size);
      if (kMoments) total_sq = cluster_sum(cluster, &cl_part[1], cluster_size);
    }
    mean = total / count;

    if (kMoments) {
      // E[x^2] - E[x]^2, each step rounded (no FMA), clamped at 0
      var = fmaxf(__fsub_rn(total_sq / count, __fmul_rn(mean, mean)), 0.f);
      if (kMode == kPartials) var = total_sq;  // the band's sum of squares
      if (kMode == kPartials) mean = total;    // and its sum
    } else {
      // pass 2: the centred sum of squares, from the on-chip copy
      acc = 0.f;
      if (active) {
        visit(s, qlo, qhi, gt, gsize, lo, hi, [&](float v) {
          const float d = v - mean;
          acc += d * d;
        });
      }
      total = group_sum(acc, red_sq, w0, gwarps);
      if (cluster_size > 1) {
        if (threadIdx.x == 0) cl_part[1] = total;
        cluster.sync();
        total = cluster_sum(cluster, &cl_part[1], cluster_size);
      }
      var = kMode == kPartials ? total : total / count;
    }
  }
  if (kMode == kPartials) {
    // one writer per plane: its segment's first thread (cluster rank 0)
    const bool writer = active && gt == 0 && (cluster_size == 1 || blk % cluster_size == 0);
    if (writer) {
      part[(plane0 + seg) * 2] = mean;
      part[(plane0 + seg) * 2 + 1] = var;
    }
    if (blk == 0 && threadIdx.x == 0) {
      part[planes * 2] = static_cast<float>(hw);
      part[planes * 2 + 1] = 0.f;
    }
  }
  const float m = Vec<T>::round(mean);
  const float r = Vec<T>::round(rsqrtf(var + eps));

  // pass 3: normalise (+ReLU) and write. Output element e of the aligned
  // y base is shared-memory element e + d.
  if (kMode != kPartials && active) {
    const int d = shift - yshift;
    const int ylo = lo - d;
    const int yhi = hi - d;
    for (int q = ylo / N + gt; q < (yhi + N - 1) / N; q += gsize) {
      const int e0 = q * N;
      const bool full = e0 >= ylo && e0 + N <= yhi;
      float v[N];
      if (d == 0) {
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(s + e0), v);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int e = e0 + k;
          v[k] = (e >= ylo && e < yhi) ? Vec<T>::get(s + e + d) : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        // the store rounds the product to T; the ReLU keeps its sign test
        const float o = Vec<T>::round(v[k] - m) * r;
        v[k] = kRelu && o < 0.f ? 0.f : o;  // NaN passes
      }
      if (full) {
        *reinterpret_cast<uint4*>(ya + e0) = Vec<T>::pack(v);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int e = e0 + k;
          if (e >= ylo && e < yhi) Vec<T>::put(ya + e, v[k]);
        }
      }
    }
  }
  // No block leaves while another may still read its partial sums.
  if (cluster_size > 1) cluster.sync();
}

// Shared memory for a range of `elems` elements at any element alignment.
long long range_smem(long long elems, int esize) {
  return (elems * esize + 15 + 15) / 16 * 16;
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long planes, long long hw, int relu, float eps,
                   int ppb, int cluster, int threads, cudaStream_t stream, int mode = kWhole,
                   float* part = nullptr, const float* gathered = nullptr, int parts = 0) {
  const long long elems = cluster > 1 ? (hw + cluster - 1) / cluster : ppb * hw;
  const long long smem = range_smem(elems, sizeof(T));
  const long long grid = cluster > 1 ? planes * cluster : (planes + ppb - 1) / ppb;
  if (smem > kMaxDynamicSmem || grid > INT_MAX) return cudaErrorInvalidValue;
  using Kernel = void (*)(const T*, T*, long long, long long, int, int, float, float*,
                          const float*, int);
  const Kernel kernels[5] = {
      instance_norm_kernel<T, false, kWhole>,   instance_norm_kernel<T, true, kWhole>,
      instance_norm_kernel<T, false, kPartials>, instance_norm_kernel<T, false, kApply>,
      instance_norm_kernel<T, true, kApply>,
  };
  const int which = mode == kWhole ? (relu ? 1 : 0) : mode == kPartials ? 2 : (relu ? 4 : 3);
  const Kernel kernel = kernels[which];
  // Allow the largest dynamic shared memory once per kernel and device
  // (host threads may launch on several cards at once).
  static std::atomic<unsigned long long> ready[5];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(ready[which].load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
    ready[which].fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y), planes,
                           hw, ppb, cluster, eps, part, gathered, parts);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: contiguous NCHW device buffers of planes = N*C planes of hw = H*W
// elements (any element alignment). dtype: 0 float32, 1 bfloat16. The
// plan: planes_per_block (ppb) consecutive planes per block when
// cluster == 1, or one plane per cluster of `cluster` blocks (2, 4 or 8;
// ppb must be 1), `threads` per block (a power of two, 32..1024, at least
// 32 per plane of a block). A plan this entry cannot run (a bad value, a
// block range over the shared memory limit, a grid over 2^31 - 1 blocks)
// returns cudaErrorInvalidValue and launches nothing. Otherwise returns
// the launch's error, then cudaGetLastError() (0 = launched).
bool plan_ok(long long planes, long long hw, int ppb, int cluster, int threads) {
  if (planes <= 0 || hw <= 0 || hw > INT_MAX / 8) return false;
  if (threads < 32 || threads > kMaxThreads || (threads & (threads - 1)) != 0) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster) return false;
  return !(ppb < 1 || (cluster > 1 && ppb != 1) || (ppb & (ppb - 1)) != 0 || threads / ppb < 32);
}

int otm_instance_norm(const void* x, void* y, long long planes, long long hw, int dtype,
                      int relu, float eps, int ppb, int cluster, int threads, void* stream) {
  if (!plan_ok(planes, hw, ppb, cluster, threads)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, planes, hw, relu, eps, ppb, cluster, threads, s);
    case 1:
      return launch<__nv_bfloat16>(x, y, planes, hw, relu, eps, ppb, cluster, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The split form's first launch: x is one band of every plane (planes
// planes of hw elements, as otm_instance_norm's x), part a float32 device
// buffer of (planes + 1) * 2: per plane (float32 input) the band's mean
// and centred sum of squares or (bfloat16) its sum and sum of squares,
// then (hw, 0). The plan as otm_instance_norm's.
int otm_instance_norm_partials(const void* x, void* part, long long planes, long long hw,
                               int dtype, int ppb, int cluster, int threads, void* stream) {
  if (!plan_ok(planes, hw, ppb, cluster, threads) || hw >= (1 << 24)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case 0:
      return launch<float>(x, nullptr, planes, hw, 0, 0.f, ppb, cluster, threads, s, kPartials,
                           p);
    case 1:
      return launch<__nv_bfloat16>(x, nullptr, planes, hw, 0, 0.f, ppb, cluster, threads, s,
                                   kPartials, p);
    default:
      return cudaErrorInvalidValue;
  }
}

// The split form's second launch: gathered holds every band's partials,
// [parts, planes + 1, 2] float32 in band order (1 <= parts <= 64); y, the
// band x normalised by the combined statistics (+ReLU).
int otm_instance_norm_apply(const void* x, void* y, const void* gathered, int parts,
                            long long planes, long long hw, int dtype, int relu, float eps,
                            int ppb, int cluster, int threads, void* stream) {
  if (!plan_ok(planes, hw, ppb, cluster, threads) || parts < 1 || parts > 64) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gathered);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, planes, hw, relu, eps, ppb, cluster, threads, s, kApply,
                           nullptr, g, parts);
    case 1:
      return launch<__nv_bfloat16>(x, y, planes, hw, relu, eps, ppb, cluster, threads, s,
                                   kApply, nullptr, g, parts);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* otm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
