// ADA affine warp of single-channel images for Hopper (sm_90a), forward.
//
// Replaces the JAX package's TPU kernel ops/pallas/warp.py
// (_warp_fwd_impl, body _fwd_kernel, the pl.pallas_call at :177):
//
//   out[b,y,x] = sum_y' wy(y') * sum_x' wx(x') * img[b,y',x']
//
// with separable tent weights around the source position (sx, sy)[b,y,x]:
//   antialias off: w(i) = relu(1 - |c - i|) over the in-frame taps, i.e.
//     exact bilinear sampling with zeros outside the frame;
//   antialias on:  k(i) = relu(1 - |(c - i) / width[b]|), normalised by
//     its sum over the taps of the EXTENDED range [-r, n + r) (floored at
//     1e-8, so a position far outside the frame gives exactly 0), and only
//     then cut to the frame [0, n).
// Rounding follows the Pallas kernel (not the XLA contraction, whose
// inner sum is rounded to bfloat16): wx is cast to the image's dtype
// before its product with the image, the sums accumulate in float32, wy
// stays float32, and the output is cast to the image's dtype. The
// antialias normaliser is the correctly rounded float32 sum (exact in
// double, below); a float32 sum in another order, as the Pallas kernel's,
// may differ from it in the last bits.
//
// The TPU kernel contracts DENSE tent matrices ([pixels, W] x [W, H] on
// the MXU) because TPU gathers are slow. On Hopper the same function reads
// only the taps in each tent's support: 2 x 2 at width 1, at most 9 x 9 at
// the pipeline's largest width (4).
//
// What bounds it: bytes. Per output pixel it reads sx and sy (8 bytes)
// and writes one value, and the image is read once at least; the taps
// (4 to 81 multiply-adds) are far below the card's ~295 operations per
// byte. Design (simple and right first): one thread per output pixel,
// 256 threads a block; the image is read through the read-only cache
// (ld.global.nc) and neighbouring threads' overlapping taps are served by
// L1. The tap weights live in registers (loops fully unrolled over at most
// kMaxTaps taps per axis). Tiling the image through shared memory is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// Taps per axis the registers hold: a tent of width <= 5 spans at most 11
// integer positions (12 with the float rounding of c -/+ width). The
// pipeline clips widths to [1, 4]; a wider tent writes NaN, never a
// silently truncated sum.
constexpr int kMaxTaps = 12;

__device__ __forceinline__ float load_img(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_img(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Round a float to the image dtype and back (identity for float).
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The in-frame taps of one axis: positions first .. first + count - 1 of
// [0, n) and their weights. Returns false when the tent needs more than
// kMaxTaps positions.
template <bool kAA>
__device__ __forceinline__ bool axis_taps(float c, float width, int n, int r, int& first,
                                          int& count, float (&wt)[kMaxTaps]) {
  first = 0;
  count = 0;
  if (!kAA) {
    // relu(1 - |c - i|) > 0 only for i in (c - 1, c + 1): floor(c), +1.
    if (!(c > -1.f && c < static_cast<float>(n))) return true;
    const int lo = static_cast<int>(floorf(c));
    const int a = lo < 0 ? 0 : lo;
    const int b = lo + 1 > n - 1 ? n - 1 : lo + 1;
    first = a;
    count = b - a + 1;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < count) wt[t] = fmaxf(1.f - fabsf(c - static_cast<float>(a + t)), 0.f);
    }
    return true;
  }
  // Support of the tent: |c - i| < width. Positions outside it have
  // weight exactly 0 (the quotient rounds to >= 1), so a superset is safe.
  const float elo = static_cast<float>(-r);
  const float ehi = static_cast<float>(n + r - 1);
  const float lo_f = fmaxf(floorf(c - width), elo);
  const float hi_f = fminf(ceilf(c + width), ehi);
  if (!(lo_f <= hi_f)) return true;  // beyond the extended range: sum 0 -> 0
  if (hi_f - lo_f + 1.f > static_cast<float>(kMaxTaps)) return false;
  const int lo = static_cast<int>(lo_f);
  const int hi = static_cast<int>(hi_f);
  // Normaliser over the extended range. Each nonzero k = 1 - |q| (|q| < 1,
  // float32) is a multiple of 2^-24 in (0, 1], so the sum of at most
  // kMaxTaps of them is exact in double: every summation order gives the
  // same sum, rounded once to float (the plain version's too).
  double sum = 0.0;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (lo + t <= hi) {
      sum += static_cast<double>(
          fmaxf(1.f - fabsf((c - static_cast<float>(lo + t)) / width), 0.f));
    }
  }
  const float norm = fmaxf(static_cast<float>(sum), 1e-8f);
  const int a = lo < 0 ? 0 : lo;
  const int b = hi > n - 1 ? n - 1 : hi;
  if (a > b) return true;  // support entirely outside the frame
  first = a;
  count = b - a + 1;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t < count) {
      const float k = fmaxf(1.f - fabsf((c - static_cast<float>(a + t)) / width), 0.f);
      wt[t] = k / norm;
    }
  }
  return true;
}

template <typename T, bool kAA>
__global__ void __launch_bounds__(kThreads)
    warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ sx,
                    const float* __restrict__ sy, const float* __restrict__ width_x,
                    const float* __restrict__ width_y, T* __restrict__ out, int64_t total,
                    int h, int w, int r) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t b = i / plane;
  const float cx = __ldg(sx + i);
  const float cy = __ldg(sy + i);
  const float wdx = kAA ? __ldg(width_x + b) : 1.f;
  const float wdy = kAA ? __ldg(width_y + b) : 1.f;

  constexpr int kTaps = kAA ? kMaxTaps : 2;  // taps per axis the loops visit
  int x0, nx, y0, ny;
  float wx[kMaxTaps] = {}, wy[kMaxTaps] = {};
  const bool ok_x = axis_taps<kAA>(cx, wdx, w, r, x0, nx, wx);
  const bool ok_y = axis_taps<kAA>(cy, wdy, h, r, y0, ny, wy);
  if (!(ok_x && ok_y)) {
    store_out(out + i, __int_as_float(0x7fc00000));  // NaN: tent wider than kMaxTaps
    return;
  }
#pragma unroll
  for (int t = 0; t < kTaps; ++t) wx[t] = round_to(wx[t], img);  // as the Pallas kernel

  const T* base = img + b * plane;
  float acc = 0.f;
#pragma unroll
  for (int ty = 0; ty < kTaps; ++ty) {
    if (ty < ny) {
      const T* row = base + static_cast<int64_t>(y0 + ty) * w + x0;
      float g = 0.f;
#pragma unroll
      for (int tx = 0; tx < kTaps; ++tx) {
        if (tx < nx) g += wx[tx] * load_img(row + tx);
      }
      acc += wy[ty] * g;
    }
  }
  store_out(out + i, acc);
}

template <typename T>
cudaError_t launch(const void* img, const void* sx, const void* sy, const void* width_x,
                   const void* width_y, void* out, long long total, int h, int w,
                   int antialias, int radius, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  const T* it = static_cast<const T*>(img);
  const float* sxf = static_cast<const float*>(sx);
  const float* syf = static_cast<const float*>(sy);
  const float* wxf = static_cast<const float*>(width_x);
  const float* wyf = static_cast<const float*>(width_y);
  T* ot = static_cast<T*>(out);
  if (antialias) {
    warp_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(it, sxf, syf, wxf, wyf, ot, total,
                                                            h, w, radius);
  } else {
    warp_fwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(it, sxf, syf, wxf, wyf, ot, total,
                                                             h, w, radius);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img, out: contiguous [b, h, w] device buffers of dtype (0 float32,
// 1 bfloat16); sx, sy: contiguous [b, h, w] float32; width_x, width_y:
// [b] float32 (read only when antialias != 0). radius: the extended tap
// range of the antialias normaliser. Returns cudaGetLastError() after the
// launch (0 = launched).
int otm_warp_fwd(const void* img, const void* sx, const void* sy, const void* width_x,
                 const void* width_y, void* out, long long b, long long h, long long w,
                 int dtype, int antialias, int radius, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || h > (1 << 30) || w > (1 << 30) || radius < 0) {
    return cudaErrorInvalidValue;
  }
  const long long total = b * h * w;
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(img, sx, sy, width_x, width_y, out, total, static_cast<int>(h),
                           static_cast<int>(w), antialias, radius, s);
    case 1:
      return launch<__nv_bfloat16>(img, sx, sy, width_x, width_y, out, total,
                                   static_cast<int>(h), static_cast<int>(w), antialias, radius,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* otm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
