// ADA affine warp of single-channel images for Hopper (sm_90a), forward
// and backward (the image cotangent).
//
// Replaces the JAX package's TPU kernels in ops/pallas/warp.py: the
// forward _warp_fwd_impl (body _fwd_kernel, the pl.pallas_call at :177)
//
//   out[b,y,x] = sum_y' wy(y') * sum_x' wx(x') * img[b,y',x']
//
// and the backward _warp_bwd (body _bwd_kernel, the pl.pallas_call at :209)
//
//   dimg[b,y',x'] = sum_{y,x} wy(y,x; y') * dout[b,y,x] * wx(y,x; x')
//
// with separable tent weights around the source position (sx, sy)[b,y,x]:
//   antialias off: w(i) = relu(1 - |c - i|) over the in-frame taps, i.e.
//     exact bilinear sampling with zeros outside the frame;
//   antialias on:  k(i) = relu(1 - |(c - i) / width[b]|), normalised by
//     its sum over the taps of the EXTENDED range [-r, n + r) (floored at
//     1e-8, so a position far outside the frame gives exactly 0), and only
//     then cut to the frame [0, n).
// Both directions compute the weights with the same device function
// (axis_taps). Rounding follows the Pallas kernels (not the XLA
// contraction, whose inner sum is rounded to bfloat16, nor autograd of
// the forward). Forward: wx is cast to the image's dtype before its
// product with the image, the sums accumulate in float32, wy stays
// float32, and the output is cast to the image's dtype. Backward: wx
// stays float32 (NOT rounded to the dtype), dout is cast to float32,
// wy * dout is formed in float32 and then multiplied by wx, the sums are
// float32, and dimg is cast to dout's dtype. The antialias normaliser is
// the correctly rounded float32 sum (exact in integers of 2^-24, below); a
// float32 sum in another order, as the Pallas kernel's, may differ from
// it in the last bits.
//
// The TPU kernels contract DENSE tent matrices ([pixels, W] x [W, H] on
// the MXU) because TPU gathers are slow. On Hopper the same functions
// visit only the taps in each tent's support.
//
// What bounds them: bytes, as long as the tap arithmetic stays small. Per
// output pixel the forward reads sx and sy (8 bytes) and writes one
// value, and the image is read once at least; the taps (4 to 81
// multiply-adds, and the antialias weights' divisions) are below the
// card's ~295 operations per byte only if each weight is computed once.
// On the card the forward is held back by latency instead (below).
//
// Taps (axis_taps, both directions). Every block lies inside one image
// (blockIdx.y is the image), so the widths are uniform across a block. The
// block reads them once and dispatches to a fully unrolled loop of
// NT = tap_count(width) taps per axis, the longer axis's (a template per
// length): the nonzero taps of k(i) = relu(1 - |(c - i) / width|) lie in
// the open interval (c - width, c + width), which holds at most
// ceil(2 width) integers, and the loop starts at floor(fl(c - width)),
// which is that interval's first integer or the one before it (rounding
// is monotone, so fl(c - width) does not pass an integer that c - width is
// below): ceil(2 width) + 1 taps cover it. A position i is in the support
// exactly when the float32 k(i) is nonzero: if |c - i| >= width, then
// fl(|c - i|) >= width and the quotient rounds to >= 1. Each k is computed
// once and kept in registers; the divisions by the width and by the
// normaliser are multiplications by a reciprocal, corrected to the IEEE
// quotient (div_rn), and the normaliser is an exact integer sum. Widths
// above AA_MAX_WIDTH (or not positive) are refused per block: the block
// writes NaN, never a silently truncated sum. Without antialiasing the taps
// are floor(c) and floor(c) + 1 (bilinear).
//
// Forward: one thread per output pixel, 128 threads a block, registers
// capped at 32 so that 64 warps fit an SM. The image taps go through the
// read-only cache (ld.global.nc); neighbouring pixels' overlapping taps
// are served by L1. The kernel is bound by latency (a coordinate load,
// then the weights, then the tap loads, per thread): on the card, 4 or 8
// pixels per thread with 16-byte coordinate loads and vector stores, or
// 2 pixels a lane apart, ran slower or no faster than this, and the
// register cap gained ~10 % (PERF.md, PR 5). Staging the source in shared
// memory was not tried: under a rotation a block's source footprint is
// unbounded, and with antialias off the kernel already matches
// F.grid_sample.
//
// The backward scatters: one thread per pixel of dout, the same taps, and
// one float32 atomicAdd of wy * dout * wx into a float32 accumulator
// [B,H,W] per tap of nonzero weight. The accumulator is zeroed on the same
// stream first (cudaMemsetAsync); in bfloat16 a second small pass casts it
// to dimg, in float32 it IS dimg. The atomics add in an order that varies
// from run to run, so the float32 sums (and, rarely, a bfloat16 rounding)
// vary in their last bits between runs: the kernel is not deterministic,
// and the wrapper refuses it under torch.use_deterministic_algorithms.
// Later work: a deterministic gather that inverts each image's affine,
// and fewer atomics by reducing within a warp first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// The forward: 128 threads a block and 16 blocks per SM, its registers
// capped at 32, so that the common 3 x 3 taps run at full occupancy (the
// rare wide tents spill).
constexpr int kFwdThreads = 128;
constexpr int kFwdBlocksPerSM = 16;
// Antialias taps per axis: ceil(2 width) + 1 for widths in (0, 4], at
// least kMinTaps (widths of 1 and below).
constexpr float kMaxWidth = 4.f;
constexpr int kMinTaps = 3;
constexpr int kMaxTaps = 9;

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

// Taps per axis of an antialiasing tent of width wd; 0 when the width is
// above kMaxWidth, not positive or NaN.
__device__ __forceinline__ int tap_count(float wd) {
  if (!(wd > 0.f && wd <= kMaxWidth)) return 0;
  const int n = static_cast<int>(ceilf(2.f * wd)) + 1;
  return n < kMinTaps ? kMinTaps : n;
}

// a / b rounded to nearest, from y = RN(1 / b): q = RN(a y) and two
// corrections q + (a - b q) y, each remainder exact by the FMA; by
// Markstein's theorem the IEEE quotient while a / b and 1 / b are normal.
// Where they are not here, the quotient is below 2^-24 (k rounds to 1
// either way) or far above 1 (k is 0 either way). The card tests hold the
// weights bitwise to the plain version's divisions.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// The NT taps of one axis from position `first` (returned) and their
// weights in wt, 0 outside the frame [0, n). Antialias, width wd and
// rwd = RN(1 / wd): k = relu(1 - |(c - i) / wd|), each computed once, then
// k / norm, norm the sum of k over the taps in the extended range
// [-r, n + r), floored at 1e-8 so that a position far outside the frame
// gives exactly 0. Each nonzero k = 1 - |q| is a multiple of 2^-24 in
// (0, 1], so the sum is exact in integers of 2^-24 (at most 9 * 2^24) and
// rounds once to float: the plain version's float64 sum, rounded once. A
// norm of exactly 1 (a width-1 tent between two pixels) divides nothing.
// Without antialias: relu(1 - |c - i|). `first` is clamped so that a huge
// or infinite c keeps every tap outside the extended range.
template <int NT, bool kAA>
__device__ __forceinline__ int axis_taps(float c, float wd, float rwd, int n, int r,
                                         float (&wt)[NT]) {
  const float lo_f = floorf(kAA ? c - wd : c);
  const int first =
      static_cast<int>(fminf(fmaxf(lo_f, static_cast<float>(-r - NT)), static_cast<float>(n + r)));
  if (!kAA) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int i = first + t;
      wt[t] = (i >= 0 && i < n) ? fmaxf(1.f - fabsf(c - static_cast<float>(i)), 0.f) : 0.f;
    }
    return first;
  }
  float k[NT];
  int sum = 0;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int i = first + t;
    k[t] = fmaxf(1.f - fabsf(div_rn(c - static_cast<float>(i), wd, rwd)), 0.f);
    if (i >= -r && i < n + r) sum += __float2int_rn(k[t] * 0x1p24f);
  }
  const float norm = fmaxf(__int2float_rn(sum) * 0x1p-24f, 1e-8f);
  if (norm == 1.f) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int i = first + t;
      wt[t] = (i >= 0 && i < n) ? k[t] : 0.f;
    }
  } else {
    const float rnorm = 1.f / norm;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int i = first + t;
      wt[t] = (i >= 0 && i < n) ? div_rn(k[t], norm, rnorm) : 0.f;
    }
  }
  return first;
}

// One output pixel of the forward: sum_y wy * sum_x wx * img over the
// nonzero taps; wx rounded to the image dtype first, as the Pallas kernel.
template <typename T, int NT, bool kAA>
__device__ __forceinline__ float fwd_pixel(const T* __restrict__ base, float cx, float cy,
                                           float wdx, float wdy, float rwdx, float rwdy, int h,
                                           int w, int r) {
  float wx[NT], wy[NT];
  const int x0 = axis_taps<NT, kAA>(cx, wdx, rwdx, w, r, wx);
  const int y0 = axis_taps<NT, kAA>(cy, wdy, rwdy, h, r, wy);
#pragma unroll
  for (int t = 0; t < NT; ++t) wx[t] = round_to(wx[t], base);
  float acc = 0.f;
#pragma unroll
  for (int ty = 0; ty < NT; ++ty) {
    if (wy[ty] != 0.f) {
      const T* row = base + static_cast<int64_t>(y0 + ty) * w + x0;
      float g = 0.f;
#pragma unroll
      for (int tx = 0; tx < NT; ++tx) {
        if (wx[tx] != 0.f) g += wx[tx] * load_img(row + tx);
      }
      acc += wy[ty] * g;
    }
  }
  if (kAA && (cx != cx || cy != cy)) acc = __int_as_float(0x7fc00000);  // NaN position
  return acc;
}

// Calls f.template run<NT>() for the block's tap count NT (kMinTaps..
// kMaxTaps), the longer of its two axes': one switch per block, each case a
// fully unrolled loop of NT x NT taps. (A case per pair of axis lengths
// took nvcc ten times as long and ran no faster; PERF.md, PR 5.)
template <typename F>
__device__ __forceinline__ void dispatch(int nt, F& f) {
  static_assert(kMinTaps == 3 && kMaxTaps == 9, "the cases below run kMinTaps..kMaxTaps");
  switch (nt) {
    case 3: f.template run<3>(); break;
    case 4: f.template run<4>(); break;
    case 5: f.template run<5>(); break;
    case 6: f.template run<6>(); break;
    case 7: f.template run<7>(); break;
    case 8: f.template run<8>(); break;
    default: f.template run<9>(); break;
  }
}

template <typename T>
struct FwdAA {
  const T* base;
  float cx, cy, wdx, wdy;
  T* out;
  int h, w, r;
  template <int NT>
  __device__ __forceinline__ void run() {
    store_out(out, fwd_pixel<T, NT, true>(base, cx, cy, wdx, wdy, 1.f / wdx, 1.f / wdy, h, w, r));
  }
};

// Grid (ceil(h * w / kFwdThreads), b): one thread per output pixel;
// blockIdx.y is the image.
template <typename T, bool kAA>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSM)
    warp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ sx,
                    const float* __restrict__ sy, const float* __restrict__ width_x,
                    const float* __restrict__ width_y, T* __restrict__ out, int h, int w,
                    int r) {
  const int b = blockIdx.y;
  const int hw = h * w;
  const int p = blockIdx.x * kFwdThreads + threadIdx.x;
  if (p >= hw) return;
  const int64_t off = static_cast<int64_t>(b) * hw;
  const float cx = __ldg(sx + off + p);
  const float cy = __ldg(sy + off + p);
  if (!kAA) {
    store_out(out + off + p, fwd_pixel<T, 2, false>(img + off, cx, cy, 1.f, 1.f, 1.f, 1.f, h, w,
                                                    r));
    return;
  }
  const float wdx = __ldg(width_x + b);
  const float wdy = __ldg(width_y + b);
  const int nx = tap_count(wdx);
  const int ny = tap_count(wdy);
  if (nx == 0 || ny == 0) {  // NaN: a tent wider than the dispatch takes
    store_out(out + off + p, __int_as_float(0x7fc00000));
    return;
  }
  FwdAA<T> f{img + off, cx, cy, wdx, wdy, out + off + p, h, w, r};
  dispatch(nx > ny ? nx : ny, f);
}

// One pixel of dout scattered over its taps.
template <int NT, bool kAA>
__device__ __forceinline__ void bwd_pixel(float d, float cx, float cy, float wdx, float wdy,
                                          float* __restrict__ base, int h, int w, int r) {
  float wx[NT], wy[NT];
  const int x0 = axis_taps<NT, kAA>(cx, wdx, 1.f / wdx, w, r, wx);
  const int y0 = axis_taps<NT, kAA>(cy, wdy, 1.f / wdy, h, r, wy);
  if (kAA && (cx != cx || cy != cy)) {
    atomicAdd(base, __int_as_float(0x7fc00000));  // NaN position
    return;
  }
  // wx stays float32 here (the forward rounds it to the image dtype).
#pragma unroll
  for (int ty = 0; ty < NT; ++ty) {
    if (wy[ty] != 0.f) {
      const float a = wy[ty] * d;  // wy * dout in float32, then * wx
      float* row = base + static_cast<int64_t>(y0 + ty) * w + x0;
#pragma unroll
      for (int tx = 0; tx < NT; ++tx) {
        if (wx[tx] != 0.f) atomicAdd(row + tx, a * wx[tx]);
      }
    }
  }
}

struct BwdAA {
  float d, cx, cy, wdx, wdy;
  float* base;
  int h, w, r;
  template <int NT>
  __device__ __forceinline__ void run() {
    bwd_pixel<NT, true>(d, cx, cy, wdx, wdy, base, h, w, r);
  }
};

// Grid (ceil(h * w / kThreads), b): one thread per pixel of dout.
template <typename T, bool kAA>
__global__ void __launch_bounds__(kThreads)
    warp_bwd_kernel(const T* __restrict__ dout, const float* __restrict__ sx,
                    const float* __restrict__ sy, const float* __restrict__ width_x,
                    const float* __restrict__ width_y, float* __restrict__ acc, int h, int w,
                    int r) {
  const int b = blockIdx.y;
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int64_t off = static_cast<int64_t>(b) * hw;
  const float d = load_img(dout + off + p);  // dout cast to float32, as the Pallas kernel
  if (d == 0.f) return;  // every term is 0 (a NaN dout goes on and spreads)
  const float cx = __ldg(sx + off + p);
  const float cy = __ldg(sy + off + p);
  float* base = acc + off;
  if (!kAA) {
    bwd_pixel<2, false>(d, cx, cy, 1.f, 1.f, base, h, w, r);
    return;
  }
  const float wdx = __ldg(width_x + b);
  const float wdy = __ldg(width_y + b);
  const int nx = tap_count(wdx);
  const int ny = tap_count(wdy);
  if (nx == 0 || ny == 0) {
    atomicAdd(base, __int_as_float(0x7fc00000));  // NaN: a tent wider than the dispatch takes
    return;
  }
  BwdAA f{d, cx, cy, wdx, wdy, base, h, w, r};
  dispatch(nx > ny ? nx : ny, f);
}

__global__ void __launch_bounds__(kThreads)
    cast_bf16_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ out,
                     int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < total) out[i] = __float2bfloat16_rn(acc[i]);
}

template <typename T>
cudaError_t launch_bwd(const void* dout, const void* sx, const void* sy, const void* width_x,
                       const void* width_y, float* acc, int b, int h, int w, int antialias,
                       int radius, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((static_cast<int64_t>(h) * w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  const T* dt = static_cast<const T*>(dout);
  const float* sxf = static_cast<const float*>(sx);
  const float* syf = static_cast<const float*>(sy);
  const float* wxf = static_cast<const float*>(width_x);
  const float* wyf = static_cast<const float*>(width_y);
  if (antialias) {
    warp_bwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(dt, sxf, syf, wxf, wyf, acc, h, w,
                                                            radius);
  } else {
    warp_bwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(dt, sxf, syf, wxf, wyf, acc, h, w,
                                                             radius);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* img, const void* sx, const void* sy, const void* width_x,
                   const void* width_y, void* out, int b, int h, int w, int antialias, int radius,
                   cudaStream_t stream) {
  const dim3 grid(
      static_cast<unsigned>((static_cast<int64_t>(h) * w + kFwdThreads - 1) / kFwdThreads),
      static_cast<unsigned>(b));
  const T* it = static_cast<const T*>(img);
  const float* sxf = static_cast<const float*>(sx);
  const float* syf = static_cast<const float*>(sy);
  const float* wxf = static_cast<const float*>(width_x);
  const float* wyf = static_cast<const float*>(width_y);
  T* ot = static_cast<T*>(out);
  if (antialias) {
    warp_fwd_kernel<T, true><<<grid, kFwdThreads, 0, stream>>>(it, sxf, syf, wxf, wyf, ot, h, w,
                                                               radius);
  } else {
    warp_fwd_kernel<T, false><<<grid, kFwdThreads, 0, stream>>>(it, sxf, syf, wxf, wyf, ot, h,
                                                                w, radius);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img, out: contiguous [b, h, w] device buffers of dtype (0 float32,
// 1 bfloat16); sx, sy: contiguous [b, h, w] float32; width_x, width_y:
// [b] float32 (read only when antialias != 0). radius: the extended tap
// range of the antialias normaliser. b <= 65535 and h * w < 2^31 - 2^12.
// Returns cudaGetLastError() after the launch (0 = launched).
int otm_warp_fwd(const void* img, const void* sx, const void* sy, const void* width_x,
                 const void* width_y, void* out, long long b, long long h, long long w,
                 int dtype, int antialias, int radius, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || h * w > INT_MAX - 4096 || radius < 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bi = static_cast<int>(b), hi = static_cast<int>(h), wi = static_cast<int>(w);
  switch (dtype) {
    case 0:
      return launch<float>(img, sx, sy, width_x, width_y, out, bi, hi, wi, antialias, radius, s);
    case 1:
      return launch<__nv_bfloat16>(img, sx, sy, width_x, width_y, out, bi, hi, wi, antialias,
                                   radius, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The image cotangent. dout, dimg: contiguous [b, h, w] device buffers of
// dtype (0 float32, 1 bfloat16); acc: a contiguous [b, h, w] float32
// device buffer, the accumulator (zeroed here), which must be dimg itself
// in float32; sx, sy, width_x, width_y, radius and the limits on b, h, w
// as otm_warp_fwd. Returns the first CUDA error of the memset and the
// launches (0 = launched).
int otm_warp_bwd(const void* dout, const void* sx, const void* sy, const void* width_x,
                 const void* width_y, void* acc, void* dimg, long long b, long long h,
                 long long w, int dtype, int antialias, int radius, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || h * w > INT_MAX - 4096 || radius < 0) {
    return cudaErrorInvalidValue;
  }
  if ((dtype == 0) != (acc == dimg) || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const long long total = b * h * w;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bi = static_cast<int>(b), hi = static_cast<int>(h), wi = static_cast<int>(w);
  float* accf = static_cast<float*>(acc);
  cudaError_t err = cudaMemsetAsync(accf, 0, static_cast<size_t>(total) * sizeof(float), s);
  if (err != cudaSuccess) return err;
  if (dtype == 0) {
    return launch_bwd<float>(dout, sx, sy, width_x, width_y, accf, bi, hi, wi, antialias, radius,
                             s);
  }
  err = launch_bwd<__nv_bfloat16>(dout, sx, sy, width_x, width_y, accf, bi, hi, wi, antialias,
                                  radius, s);
  if (err != cudaSuccess) return err;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  cast_bf16_kernel<<<grid, kThreads, 0, s>>>(accf, static_cast<__nv_bfloat16*>(dimg), total);
  return cudaGetLastError();
}

const char* otm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
