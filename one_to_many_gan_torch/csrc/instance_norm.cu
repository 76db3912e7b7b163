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
// Design (simple and right first): input is contiguous NCHW, one thread
// block of 1024 threads per (b, c) plane, 16-byte vector loads and
// stores (4 floats or 8 bf16) when the plane size and pointers allow,
// each thread issuing kUnroll of them before it uses any, so that enough
// bytes are in flight to cover the memory latency.
//   pass 1  block-wide sum (warp shuffles + shared memory) -> mean;
//   pass 2  block-wide centered sum of squares -> var, rstd;
//   pass 3  normalize (+ReLU) and write.
// The centered second pass is chosen over the TPU kernel's
// E[x^2] - E[x]^2 because it is what the float32 oracle
// (ops/norm.py::instance_norm) computes and it has no cancellation. It
// reads the plane three times; the largest plane on the serving path is
// 512x256 float32 = 512 KB, so the re-reads are served from the 50 MB L2
// as far as the planes in flight fit there, and from device memory
// beyond that. Keeping the plane on chip (registers, or the shared memory
// of a block cluster) to reach the one-read bound, and splitting a plane
// over several blocks when B*C is below the SM count, is later work.
// In bfloat16 the normalization rounds as ops/norm.py's bf16 path does:
// mean and rstd rounded to bf16, then bf16(bf16(x - mean) * rstd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
// 16-byte loads each thread keeps in flight (64 bytes a thread).
constexpr int kUnroll = 4;

// Round a float to the storage type and back (identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16-byte vectors: 4 floats or 8 bf16 values, unpacked to float.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 is the high half of a float32: element 2k is the low half of
  // word k (little-endian), element 2k+1 the high half.
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Sum of one float per thread over the whole block; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red is reused by the next reduction
  return total;
}

// Calls f(v) on every 16-byte vector of the plane xp[0, n_vec * N), v
// unpacked to float. Each thread loads kUnroll vectors before it hands
// any to f, so that kUnroll loads are in flight per thread.
template <typename T, typename F>
__device__ __forceinline__ void for_each_vec(const T* xp, int64_t n_vec, F f) {
  constexpr int N = Vec<T>::N;
  const int64_t stride = blockDim.x;
  int64_t i = threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    float v[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Vec<T>::load(xp + (i + u * stride) * N, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f(i + u * stride, v[u]);
  }
  for (; i < n_vec; i += stride) {
    float v[N];
    Vec<T>::load(xp + i * N, v);
    f(i, v);
  }
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    instance_norm_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t hw,
                         float eps, bool vec) {
  __shared__ float red[33];
  constexpr int N = Vec<T>::N;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const T* xp = x + base;
  T* yp = y + base;
  const int64_t n_vec = vec ? hw / N : 0;
  const int64_t tail = n_vec * N;
  const float count = static_cast<float>(hw);

  // pass 1: mean
  float acc = 0.f;
  for_each_vec(xp, n_vec, [&](int64_t, const float* v) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc += v[k];
  });
  for (int64_t i = tail + threadIdx.x; i < hw; i += blockDim.x) acc += load1(xp + i);
  const float mean = block_sum(acc, red) / count;

  // pass 2: centered variance
  acc = 0.f;
  for_each_vec(xp, n_vec, [&](int64_t, const float* v) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float d = v[k] - mean;
      acc += d * d;
    }
  });
  for (int64_t i = tail + threadIdx.x; i < hw; i += blockDim.x) {
    const float d = load1(xp + i) - mean;
    acc += d * d;
  }
  const float var = block_sum(acc, red) / count;
  const float m = round_to<T>(mean);
  const float s = round_to<T>(rsqrtf(var + eps));

  // pass 3: normalize (+ReLU) and write; NaN passes through the ReLU
  for_each_vec(xp, n_vec, [&](int64_t i, const float* v) {
    float o[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      o[k] = round_to<T>(round_to<T>(v[k] - m) * s);
      if (kRelu) o[k] = o[k] < 0.f ? 0.f : o[k];
    }
    Vec<T>::store(yp + i * N, o);
  });
  for (int64_t i = tail + threadIdx.x; i < hw; i += blockDim.x) {
    float o = round_to<T>(round_to<T>(load1(xp + i) - m) * s);
    if (kRelu) o = o < 0.f ? 0.f : o;
    store1(yp + i, o);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long planes, long long hw, int relu,
                   float eps, cudaStream_t stream) {
  const bool vec = hw % Vec<T>::N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(planes));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (relu) {
    instance_norm_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, yt, hw, eps, vec);
  } else {
    instance_norm_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, yt, hw, eps, vec);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: contiguous NCHW device buffers of planes = N*C planes of hw = H*W
// elements. dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch (0 = launched).
int otm_instance_norm(const void* x, void* y, long long planes, long long hw,
                      int dtype, int relu, float eps, void* stream) {
  if (planes <= 0 || planes > INT_MAX || hw <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, planes, hw, relu, eps, s);
    case 1:
      return launch<__nv_bfloat16>(x, y, planes, hw, relu, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* otm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
