// The decoder's 2x upsample for Hopper (sm_90a): bilinear doubling then the
// [1, 2, 1] / 4 blur, along both axes, with the edge (replication) pads, in
// one launch.
//
// Replaces: in this package, ops/resample.py::upsample2x of a whole map,
// which ran _double_blur twice (along H, then W): each an edge pad
// (_edge_pad, a replication_pad kernel) and a depthwise stride-2 transposed
// FIR (F.conv_transpose2d with groups = C, cuDNN's
// dgrad2d_grouped_direct_kernel). In the JAX package the same function is
// ops/resample.py::_double_blur_axis twice, XLA's lhs-dilated conv; no
// Pallas kernel. The plain version (ops/resample.py::upsample2x_plain) is
// those two passes, kept for the CPU and as this kernel's oracle.
//
// What it computes, in polyphase form, for an input plane x of h x w and
// an output plane of 2h x 2w:
//   y[2i + p, 2j + q] = sum_{a, b in -1..1} tH_p[a] tW_q[b]
//                       x[clamp(i + a, 0, h - 1), clamp(j + b, 0, w - 1)]
// with the taps even t_0 = (5, 10, 1) / 16 and odd t_1 = (1, 10, 5) / 16
// on (i - 1, i, i + 1). The clamp is the edge pad: no padded copy exists.
// The sums run in float32, the H taps first (as the plain version's first
// pass), and round once to the output type; the plain version rounds
// between its two passes too, so in bfloat16 the two can differ by a bf16
// ulp of the output (at most 3 * 2^-8 of the largest |x|).
//
// What bounds it: bytes. It does ~10 flops an output, far below the card's
// ~295 operations a byte, so the least time is one read of the input and
// one write of the 4x larger output at 3.35 TB/s: 5 * h * w * esize bytes a
// plane. At the shipped config's serving decode (a chunk of 86 images,
// bfloat16): site 1, 256 planes of 128 x 64 an image, 0.54 ms a chunk;
// site 2, 128 planes of 256 x 128, 1.08 ms. The two cuDNN passes and their
// pads moved 1.8x those bytes, at ~6 % of the card's bandwidth.
//
// Design. A thread owns 4 consecutive input columns of one plane and walks
// down a strip of `rows` input rows, keeping three rows of the 6-column
// window (its columns, one on each side, clamped) in registers: each step
// loads one new row (one 8- or 16-byte load and two scalar loads of the
// neighbours' edge columns, which the neighbouring threads load in the same
// instruction and so come from L1) while the next row's load is already in
// flight, and writes 2 output rows x 8 columns: one 16-byte store a row in
// bfloat16, two in float32, neighbouring threads on neighbouring
// addresses. Consecutive threads take consecutive column groups, then
// strips, then planes, so a warp's loads and stores cover whole lines, and
// each input element is read from device memory once: the strips' halo
// rows are read a second time, from L2, by the thread of the next strip.
// No shared memory, no atomics: every output is one fixed expression of
// its inputs, bitwise the same from run to run. A plane whose width is no
// multiple of 4, or a buffer off 16-byte alignment, takes the same walk
// with scalar loads and stores (odd sizes; never the serving shapes).
// The strip height and block size are the wrapper's (ops/cuda/upsample.py:
// ROWS, THREADS), the fastest pair of a sweep on an H100
// (scripts/sweep_torch_kernels.py up-plans; PERF.md): 2 rows in bfloat16
// and 1 in float32, 512 threads a block, at 85 % (bfloat16) and ~80 %
// (float32) of the bound at both serving sites; 8 rows took 10 % longer in
// bfloat16 and 40 % in float32. Short strips put more threads, so more
// loads, in flight, which gains more than a long strip's reuse of its rows
// (from L1 in any case) saves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kCols = 4;  // input columns a thread owns

// The taps of one output parity on (i - 1, i, i + 1), exact in float32.
constexpr float kT5 = 0.3125f;  // 5 / 16
constexpr float kT10 = 0.625f;  // 10 / 16
constexpr float kT1 = 0.0625f;  // 1 / 16

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kAlign = 16;  // bytes of one 4-column load
  __device__ __forceinline__ static float load(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static void load4(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
  __device__ __forceinline__ static void store8(float* p, const float* v) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kAlign = 8;
  // A bfloat16 is the high half of the float32 of the same value.
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned>(u) << 16);
  }
  __device__ __forceinline__ static void load4(const __nv_bfloat16* p, float* v) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static unsigned pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  __device__ __forceinline__ static void store8(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
};

// Columns c0 - 1 .. c0 + 4 of one input row, clamped to [0, w - 1].
template <typename T, bool kVec>
__device__ __forceinline__ void load_row(const T* row, int c0, int w, float* v) {
  if (kVec) {  // w % 4 == 0: columns c0 .. c0 + 3 lie inside the row
    v[0] = Io<T>::load(row + max(c0 - 1, 0));
    Io<T>::load4(row + c0, v + 1);
    v[5] = Io<T>::load(row + min(c0 + kCols, w - 1));
  } else {
#pragma unroll
    for (int k = 0; k < kCols + 2; ++k) v[k] = Io<T>::load(row + min(max(c0 - 1 + k, 0), w - 1));
  }
}

// Output columns 2 c0 .. 2 c0 + 7 of one output row from the H pass's
// window v (input columns c0 - 1 .. c0 + 4), those inside the row.
template <typename T, bool kVec>
__device__ __forceinline__ void store_row(T* row, int c0, int w, const float* v) {
  float o[2 * kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    o[2 * m] = fmaf(kT1, v[m + 2], fmaf(kT10, v[m + 1], kT5 * v[m]));
    o[2 * m + 1] = fmaf(kT5, v[m + 2], fmaf(kT10, v[m + 1], kT1 * v[m]));
  }
  if (kVec) {
    Io<T>::store8(row + 2 * c0, o);
  } else {
#pragma unroll
    for (int k = 0; k < 2 * kCols; ++k) {
      if (2 * c0 + k < 2 * w) Io<T>::store(row + 2 * c0 + k, o[k]);
    }
  }
}

// One thread: column group g (input columns 4 g .. 4 g + 3) of strip s
// (input rows s * rows .. ) of one plane. Items run group fastest, then
// strip, then plane.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    upsample2x_kernel(const T* __restrict__ x, T* __restrict__ y, long long items, int h,
                      int w, int groups, int strips, int rows) {
  const long long item = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= items) return;
  const int g = static_cast<int>(item % groups);
  const long long rest = item / groups;
  const int s = static_cast<int>(rest % strips);
  const long long plane = rest / strips;
  const long long hw = static_cast<long long>(h) * w;
  const T* xp = x + plane * hw;
  T* yp = y + plane * 4 * hw;
  const int c0 = kCols * g;
  const int r0 = s * rows;
  const int r1 = min(r0 + rows, h);
  float top[kCols + 2], mid[kCols + 2], bot[kCols + 2], next[kCols + 2];
  load_row<T, kVec>(xp + static_cast<long long>(max(r0 - 1, 0)) * w, c0, w, top);
  load_row<T, kVec>(xp + static_cast<long long>(r0) * w, c0, w, mid);
  load_row<T, kVec>(xp + static_cast<long long>(min(r0 + 1, h - 1)) * w, c0, w, next);
  for (int i = r0; i < r1; ++i) {
#pragma unroll
    for (int k = 0; k < kCols + 2; ++k) bot[k] = next[k];
    if (i + 1 < r1) {  // the next step's new row, in flight while this one computes
      load_row<T, kVec>(xp + static_cast<long long>(min(i + 2, h - 1)) * w, c0, w, next);
    }
    float even[kCols + 2], odd[kCols + 2];
#pragma unroll
    for (int k = 0; k < kCols + 2; ++k) {
      even[k] = fmaf(kT1, bot[k], fmaf(kT10, mid[k], kT5 * top[k]));
      odd[k] = fmaf(kT5, bot[k], fmaf(kT10, mid[k], kT1 * top[k]));
    }
    T* out = yp + static_cast<long long>(2 * i) * (2 * w);
    store_row<T, kVec>(out, c0, w, even);
    store_row<T, kVec>(out + 2 * w, c0, w, odd);
#pragma unroll
    for (int k = 0; k < kCols + 2; ++k) {
      top[k] = mid[k];
      mid[k] = bot[k];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long planes, int h, int w, int rows,
                   int threads, cudaStream_t stream) {
  const int groups = (w + kCols - 1) / kCols;
  const int strips = (h + rows - 1) / rows;
  const long long items = planes * strips * groups;
  const long long grid = (items + threads - 1) / threads;
  if (grid > INT_MAX) return cudaErrorInvalidValue;
  const bool vec = w % kCols == 0 && reinterpret_cast<uintptr_t>(x) % Io<T>::kAlign == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec) {
    upsample2x_kernel<T, true><<<static_cast<unsigned>(grid), threads, 0, stream>>>(
        xt, yt, items, h, w, groups, strips, rows);
  } else {
    upsample2x_kernel<T, false><<<static_cast<unsigned>(grid), threads, 0, stream>>>(
        xt, yt, items, h, w, groups, strips, rows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: a contiguous NCHW device buffer of `planes` = N * C planes of h x w
// elements; y: one of `planes` planes of 2h x 2w. dtype: 0 float32, 1
// bfloat16. `rows`: input rows a thread walks (>= 1); `threads` per block
// (a multiple of 32, at most 1024). A value this entry cannot take (an
// empty shape, a plane over 2^31 - 1 output elements, a grid over 2^31 - 1
// blocks) returns cudaErrorInvalidValue and launches nothing; otherwise
// the launch's error (0 = launched).
int otm_upsample2x(const void* x, void* y, long long planes, int h, int w, int dtype, int rows,
                   int threads, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || rows <= 0) return cudaErrorInvalidValue;
  if (4LL * h * w > INT_MAX) return cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, planes, h, w, rows, threads, s);
    case 1:
      return launch<__nv_bfloat16>(x, y, planes, h, w, rows, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* otm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
