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
// The backward gathers: one thread per pixel q of dimg sums, in a fixed
// order, every term wy * dout * wx that reaches it from the pixels p of
// dout whose taps cover q. Two launches:
//
// 1. The pre-pass (warp_bwd_hint_kernel, a few blocks per image) fits a
//    hint affine source(p) ~ o + A p per image from three of the image's
//    own coordinates (pixels (0, 0), (w-1, 0) and (0, h-1)) and measures
//    the largest deviation of the coordinates from it, per axis, over the
//    pixels that can reach the frame at all; each block writes its
//    maxima (and whether it saw a NaN coordinate) to its own slot of a
//    small per-image record, and block 0 the hint and its inverse. A max
//    does not depend on the order of its operands, and no slot is shared,
//    so there are no atomics and nothing to zero.
// 2. The gather (warp_bwd_gather_kernel): each block owns a 32 x 32 tile
//    of dimg and reduces its image's maxima. A pixel p can reach q only
//    if |source(p) - q| < width per axis, so |o + A p - q| < width +
//    deviation: p lies in the preimage under the hint of a box around q.
//    The block maps its tile, widened by that much, back through the
//    hint's inverse into a box of output pixels (its region) and stages
//    the region in shared memory in chunks: per staged pixel its first
//    taps, its float32 wx per x tap and wy * dout per y tap (the
//    scatter's a), each computed once with axis_taps, as the forward does.
//    A staged pixel whose hint position lies outside the widened tile
//    cannot reach it and is marked empty instead (under a rotation the
//    region's bounding box is up to twice the parallelogram it holds).
//    Each thread owns a 2 x 2 quad of q and loops over its box (the
//    preimage of the quad widened by the reach, intersected with the
//    chunk) in row-major order; a term counts exactly when both its
//    float32 weights are nonzero, as in the scatter this kernel replaced:
//    the same taps, the same weights, wy * dout formed in float32 and then
//    multiplied by wx (no FMA contraction), only the order of the sum
//    changed. Two launches give the same bits: there are no atomics.
//
// The deviation is measured, not assumed, so any coordinates are exact;
// coordinates far from affine are merely slow, the boxes growing toward
// the whole frame, and so is a strong magnification (a tile's region
// grows with it and is staged in several chunks). A non-finite or
// singular hint gives every thread the whole frame. The hint and the
// regions are computed in double, the deviation, the thread boxes and the
// staging test in float32, each with a margin far above its rounding; a
// pixel outside a box has a zero weight for that q.
// tests/test_torch_kernel_plans.py mirrors the arithmetic on the CPU. With
// antialias on, an image with a NaN coordinate, or a tent wider than the
// dispatch takes (tap_count 0), gets a NaN cotangent over the whole image,
// never a silently truncated sum. What bounds it on the card: the tap
// arithmetic of the staged pixels, the loop over each thread's candidates
// and the pre-pass, not the bytes (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

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

// ---------------------------------------------------------------- backward

// The gather's tile of dimg, one per block: square, since under a
// rotation a tile's region is the bounding box of the tile turned, and
// large, so that the region's halo and the block's set-up are shared by
// many pixels. Each thread sums a 2 x 2 quad of pixels: their boxes
// overlap, so one pass over the union reads each staged pixel's taps once
// for four sums.
constexpr int kTileX = 32;
constexpr int kTileY = 32;
constexpr int kQuad = 2;
constexpr int kGatherThreads = (kTileX / kQuad) * (kTileY / kQuad);
constexpr int kGatherBlocksPerSM = 4;
// Shared memory for one chunk of staged pixels: per pixel its two first
// taps (8 bytes) and NT floats each of wx and wy * dout.
constexpr int kStageBytes = 47104;
// The pre-pass: blocks of kHintThreads, at most kMaxHintBlocks per image,
// kHintUnroll independent loads in flight per thread.
constexpr int kHintThreads = 256;
constexpr int kMaxHintBlocks = 128;
constexpr int kHintUnroll = 4;
// The pre-pass's record per image (doubles): the hint (o, A), its inverse,
// its magnitude and whether it is usable, then (devx, devy, nan) per block.
constexpr int kRecHint = 12;
// Margins of the box arithmetic, far above its rounding. The reach takes
// kReachSlack of the hint's magnitude (the pre-pass measures the deviation
// in float32). A tile's region (double) widens its ends by kBoxSlack of
// their size (the inverse of a poorly conditioned hint errs the most); a
// thread's box and the staging test (float32, from the tile's corner)
// widen theirs by kFloatSlack plus kFloatRel of their size.
constexpr double kReachSlack = 0x1p-18;
constexpr double kBoxSlack = 1e-6;
constexpr float kFloatSlack = 0x1p-10f;
constexpr float kFloatRel = 0x1p-20f;
// The first tap of an empty staged pixel: no q is within NT taps of it.
constexpr int kFar = 1 << 30;

// The hint affine of one image: source(x, y) ~ (ox + axx x + axy y,
// oy + ayx x + ayy y), through the coordinates of pixels (0, 0), (w-1, 0)
// and (0, h-1), in double; its inverse, magnitude (a scale for the
// margins) and whether it can be inverted.
struct Hint {
  double ox, oy, axx, axy, ayx, ayy, ixx, ixy, iyx, iyy, mag, usable;
};
static_assert(sizeof(Hint) == kRecHint * sizeof(double), "the record's layout");

__device__ __forceinline__ Hint make_hint(const float* __restrict__ sx,
                                          const float* __restrict__ sy, int h, int w) {
  Hint g;
  g.ox = __ldg(sx);
  g.oy = __ldg(sy);
  const int i10 = w - 1;
  const int i01 = (h - 1) * w;
  g.axx = w > 1 ? (static_cast<double>(__ldg(sx + i10)) - g.ox) / (w - 1) : 0.0;
  g.ayx = w > 1 ? (static_cast<double>(__ldg(sy + i10)) - g.oy) / (w - 1) : 0.0;
  g.axy = h > 1 ? (static_cast<double>(__ldg(sx + i01)) - g.ox) / (h - 1) : 0.0;
  g.ayy = h > 1 ? (static_cast<double>(__ldg(sy + i01)) - g.oy) / (h - 1) : 0.0;
  const double det = g.axx * g.ayy - g.axy * g.ayx;
  g.ixx = g.ayy / det;
  g.ixy = -g.axy / det;
  g.iyx = -g.ayx / det;
  g.iyy = g.axx / det;
  g.mag = 1.0 + fabs(g.ox) + fabs(g.oy) + (fabs(g.axx) + fabs(g.ayx)) * w +
          (fabs(g.axy) + fabs(g.ayy)) * h;
  g.usable = det != 0.0 && isfinite(det) && isfinite(g.mag) && isfinite(g.ixx) &&
             isfinite(g.ixy) && isfinite(g.iyx) && isfinite(g.iyy);
  return g;
}

// Grid (blocks, b): per image, the largest |sx - hint_x| and |sy - hint_y|
// over the pixels whose coordinates can reach the frame, sx in
// (-wdx - 1, w + wdx) and sy likewise (a tap q in [0, n) takes a nonzero
// weight only if |c - q| < width), and whether any coordinate is NaN.
// Block k of image b writes rec[b][kRecHint + 3 k + {0, 1, 2}], block 0
// also the hint, rec[b][0, kRecHint). A non-finite hint gives +inf (the
// gather then takes the whole frame anyway).
template <bool kAA>
__global__ void __launch_bounds__(kHintThreads)
    warp_bwd_hint_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                         const float* __restrict__ width_x, const float* __restrict__ width_y,
                         double* __restrict__ rec, int h, int w) {
  const int b = blockIdx.y;
  const int blocks = gridDim.x;
  const int hw = h * w;
  const int64_t off = static_cast<int64_t>(b) * hw;
  const float* bx = sx + off;
  const float* by = sy + off;
  const float wdx = kAA ? __ldg(width_x + b) : 1.f;
  const float wdy = kAA ? __ldg(width_y + b) : 1.f;
  const float xlo = -wdx - 1.f, xhi = static_cast<float>(w) + wdx;
  const float ylo = -wdy - 1.f, yhi = static_cast<float>(h) + wdy;
  // kHintUnroll coordinates a batch, kHintThreads * blocks apart; -inf
  // (outside the window) past the image
  const int stride = blocks * kHintThreads;
  const int sdy = stride / w, sdx = stride - sdy * w;
  int p = blockIdx.x * kHintThreads + threadIdx.x;
  int y = p / w, x = p - y * w;
  float cx[kHintUnroll], cy[kHintUnroll];
  int xs[kHintUnroll], ys[kHintUnroll];
  const auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kHintUnroll; ++u) {
      cx[u] = p < hw ? __ldg(bx + p) : -INFINITY;
      cy[u] = p < hw ? __ldg(by + p) : -INFINITY;
      xs[u] = x;
      ys[u] = y;
      p += stride;
      x += sdx;
      y += sdy;
      if (x >= w) {
        x -= w;
        ++y;
      }
    }
  };
  bool more = p < hw;
  load();  // the first batch in flight while thread 0 fits the hint
  __shared__ Hint hint;
  if (threadIdx.x == 0) hint = make_hint(bx, by, h, w);
  __syncthreads();
  const Hint& g = hint;
  double* out = rec + static_cast<int64_t>(b) * (kRecHint + 3 * blocks);
  if (blockIdx.x == 0 && threadIdx.x < kRecHint) {
    out[threadIdx.x] = reinterpret_cast<const double*>(&g)[threadIdx.x];
  }
  // the hint in float32: it errs from the double one by a few 2^-24 of
  // the hint's magnitude, which the reach's kReachSlack covers
  const float ox = static_cast<float>(g.ox), oy = static_cast<float>(g.oy);
  const float axx = static_cast<float>(g.axx), axy = static_cast<float>(g.axy);
  const float ayx = static_cast<float>(g.ayx), ayy = static_cast<float>(g.ayy);
  float devx = 0.f, devy = 0.f;
  int nan = 0;
  while (more) {
#pragma unroll
    for (int u = 0; u < kHintUnroll; ++u) {
      nan |= (cx[u] != cx[u]) | (cy[u] != cy[u]);
      if (cx[u] > xlo && cx[u] < xhi && cy[u] > ylo && cy[u] < yhi) {
        const float fx = static_cast<float>(xs[u]), fy = static_cast<float>(ys[u]);
        const float ex = fabsf(cx[u] - fmaf(axx, fx, fmaf(axy, fy, ox)));
        const float ey = fabsf(cy[u] - fmaf(ayx, fx, fmaf(ayy, fy, oy)));
        devx = ex <= devx ? devx : (ex == ex ? ex : INFINITY);  // NaN: +inf
        devy = ey <= devy ? devy : (ey == ey ? ey : INFINITY);
      }
    }
    more = p < hw;
    if (more) load();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    devx = fmaxf(devx, __shfl_xor_sync(0xffffffffu, devx, o));
    devy = fmaxf(devy, __shfl_xor_sync(0xffffffffu, devy, o));
  }
  nan = __any_sync(0xffffffffu, nan);
  __shared__ double red[kHintThreads / 32][3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp][0] = devx;
    red[warp][1] = devy;
    red[warp][2] = nan;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double m = red[0][threadIdx.x];
    for (int k = 1; k < kHintThreads / 32; ++k) m = fmax(m, red[k][threadIdx.x]);
    out[kRecHint + 3 * blockIdx.x + threadIdx.x] = m;
  }
}

// The integer range [lo, hi] of [0, n) within c -/+ (r + slack); empty
// (lo > hi) where they do not meet.
__device__ __forceinline__ void box_range(double c, double r, int n, int& lo, int& hi) {
  const double s = kBoxSlack * (1.0 + fabs(c) + r);
  const double a = fmin(fmax(ceil(c - r - s), 0.0), static_cast<double>(n));
  const double z = fmax(fmin(floor(c + r + s), static_cast<double>(n - 1)), -1.0);
  lo = static_cast<int>(a);
  hi = static_cast<int>(z);
}

// A tile's region of output pixels [rx0, rx1] x [ry0, ry1]; the preimage
// (cx, cy) of the tile's corner q0 = (qx0, qy0), and the hint position
// (hx, hy) of the region's corner less q0, in float32 for the threads.
struct Region {
  int rx0, rx1, ry0, ry1;
  float cx, cy, hx, hy;
};

// What the block's threads share: the image's hint, the reach of a tap
// (tent width + deviation + slack) per axis, float32 copies for the
// threads (the hint's matrix and inverse, the reach and the half-sizes of
// a quad's box, rounded up), and the tile's region.
struct Frame {
  Hint g;
  double ex, ey;
  float axx, axy, ayx, ayy, ixx, ixy, iyx, iyy, fex, fey, bx, by;
  int whole;  // no usable hint: every box is the whole frame
  int nan;    // the image's cotangent is NaN
  Region region;
};

__device__ __forceinline__ void tile_region(const Frame& f, int h, int w, int qx0, int qx1,
                                            int qy0, int qy1, Region& r);

// Warp 0: the frame of image b from its record (the hint, and the
// pre-pass blocks' maxima, reduced in lane order), and the region of the
// tile [qx0, qx1] x [qy0, qy1].
__device__ __forceinline__ void load_frame(Frame& f, const double* __restrict__ rec, int blocks,
                                           float wdx, float wdy, int h, int w, int qx0, int qx1,
                                           int qy0, int qy1) {
  const int lane = threadIdx.x & 31;
  double devx = 0.0, devy = 0.0, nan = 0.0;
  for (int k = lane; k < blocks; k += 32) {
    const double* q = rec + kRecHint + 3 * k;
    devx = fmax(devx, q[0]);
    devy = fmax(devy, q[1]);
    nan = fmax(nan, q[2]);
  }
  if (lane < kRecHint) reinterpret_cast<double*>(&f.g)[lane] = rec[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    devx = fmax(devx, __shfl_xor_sync(0xffffffffu, devx, o));
    devy = fmax(devy, __shfl_xor_sync(0xffffffffu, devy, o));
    nan = fmax(nan, __shfl_xor_sync(0xffffffffu, nan, o));
  }
  __syncwarp();
  if (lane == 0) {
    const Hint& g = f.g;
    f.ex = wdx + devx + kReachSlack * g.mag;
    f.ey = wdy + devy + kReachSlack * g.mag;
    f.whole = !(g.usable != 0.0 && isfinite(f.ex) && isfinite(f.ey));
    f.nan = nan != 0.0;
    f.axx = static_cast<float>(g.axx);
    f.axy = static_cast<float>(g.axy);
    f.ayx = static_cast<float>(g.ayx);
    f.ayy = static_cast<float>(g.ayy);
    f.ixx = static_cast<float>(g.ixx);
    f.ixy = static_cast<float>(g.ixy);
    f.iyx = static_cast<float>(g.iyx);
    f.iyy = static_cast<float>(g.iyy);
    f.fex = __double2float_ru(f.ex);
    f.fey = __double2float_ru(f.ey);
    const double qx = f.ex + 0.5 * (kQuad - 1), qy = f.ey + 0.5 * (kQuad - 1);
    f.bx = __double2float_ru(fabs(g.ixx) * qx + fabs(g.ixy) * qy);
    f.by = __double2float_ru(fabs(g.iyx) * qx + fabs(g.iyy) * qy);
    tile_region(f, h, w, qx0, qx1, qy0, qy1, f.region);
  }
}

// The integer range [lo, hi] of [0, n) within c -/+ (r + slack), in
// float32; empty (lo > hi) where they do not meet.
__device__ __forceinline__ void box_range_f(float c, float r, int n, int& lo, int& hi) {
  const float s = kFloatSlack + kFloatRel * (fabsf(c) + r);
  lo = static_cast<int>(fminf(fmaxf(ceilf(c - r - s), 0.f), static_cast<float>(n)));
  hi = static_cast<int>(fmaxf(fminf(floorf(c + r + s), static_cast<float>(n - 1)), -1.f));
}

// The region of the tile [qx0, qx1] x [qy0, qy1]: the tile widened by the
// reach, mapped back through the hint's inverse.
__device__ __forceinline__ void tile_region(const Frame& f, int h, int w, int qx0, int qx1,
                                            int qy0, int qy1, Region& r) {
  if (f.whole) {
    r = Region{0, w - 1, 0, h - 1, 0.f, 0.f, 0.f, 0.f};
    return;
  }
  const Hint& g = f.g;
  const double cx = 0.5 * (qx0 + qx1) - g.ox, cy = 0.5 * (qy0 + qy1) - g.oy;
  const double hx = 0.5 * (qx1 - qx0) + f.ex, hy = 0.5 * (qy1 - qy0) + f.ey;
  box_range(g.ixx * cx + g.ixy * cy, fabs(g.ixx) * hx + fabs(g.ixy) * hy, w, r.rx0, r.rx1);
  box_range(g.iyx * cx + g.iyy * cy, fabs(g.iyx) * hx + fabs(g.iyy) * hy, h, r.ry0, r.ry1);
  const double dx = qx0 - g.ox, dy = qy0 - g.oy;
  r.cx = static_cast<float>(g.ixx * dx + g.ixy * dy);
  r.cy = static_cast<float>(g.iyx * dx + g.iyy * dy);
  r.hx = static_cast<float>(g.ox + g.axx * r.rx0 + g.axy * r.ry0 - qx0);
  r.hy = static_cast<float>(g.oy + g.ayx * r.rx0 + g.ayy * r.ry0 - qy0);
}

// One tile of the gather, NT taps per axis: its region staged in chunks.
// The thread's quad: pixels (qx + i, qy + j), i, j in {0, 1}, acc[2 j + i].
template <typename T, bool kAA>
struct Gather {
  const T* dout;
  const float *sx, *sy;
  const Frame* f;
  unsigned char* stage;
  float wdx, wdy;
  int h, w, r, qx, qy, qx0, qx1, qy0, qy1;
  float acc[kQuad * kQuad];

  template <int NT>
  __device__ __forceinline__ void run() {
    static_assert(kQuad == 2, "the sums below take a 2 x 2 quad");
    constexpr int kCap = kStageBytes / (8 + 8 * NT);
    int2* s_first = reinterpret_cast<int2*>(stage);
    float* s_wx = reinterpret_cast<float*>(stage + 8 * kCap);
    float* s_a = s_wx + NT * kCap;
    const float rwdx = 1.f / wdx, rwdy = 1.f / wdy;
    const Region rg = f->region;
    const int rx0 = rg.rx0, rx1 = rg.rx1, ry0 = rg.ry0, ry1 = rg.ry1;
    if (rx0 > rx1 || ry0 > ry1) return;  // nothing reaches the tile (the whole block)
    // This thread's box: the preimage of its quad widened by the reach,
    // from the tile corner's (float32).
    int bx0 = 0, bx1 = w - 1, by0 = 0, by1 = h - 1;
    if (!f->whole) {
      const float dqx = qx - qx0 + 0.5f * (kQuad - 1), dqy = qy - qy0 + 0.5f * (kQuad - 1);
      box_range_f(rg.cx + (f->ixx * dqx + f->ixy * dqy), f->bx, w, bx0, bx1);
      box_range_f(rg.cy + (f->iyx * dqx + f->iyy * dqy), f->by, h, by0, by1);
    }
    // The staging test: a staged pixel's hint position, relative to the
    // tile's corner, within the tile widened by the reach.
    const float tx_lo = -f->fex, tx_hi = static_cast<float>(qx1 - qx0) + f->fex;
    const float ty_lo = -f->fey, ty_hi = static_cast<float>(qy1 - qy0) + f->fey;
    const int cw_max = min(rx1 - rx0 + 1, kCap);
    const int ch_max = max(1, kCap / cw_max);
    for (int cy0 = ry0; cy0 <= ry1; cy0 += ch_max) {
      const int ch = min(ch_max, ry1 - cy0 + 1);
      for (int cx0 = rx0; cx0 <= rx1; cx0 += cw_max) {
        const int cw = min(cw_max, rx1 - cx0 + 1);
        // stage: taps and weights of each pixel of the chunk, once; slot i
        // is (row, col) of the chunk, stepped by kGatherThreads slots
        const int step_r = kGatherThreads / cw, step_c = kGatherThreads % cw;
        int row = static_cast<int>(threadIdx.x) / cw;
        int col = static_cast<int>(threadIdx.x) % cw;
        for (int i = threadIdx.x; i < ch * cw; i += kGatherThreads) {
          const int py = cy0 + row, px = cx0 + col;
          row += step_r;
          col += step_c;
          if (col >= cw) {
            col -= cw;
            ++row;
          }
          if (!f->whole) {
            const float ux = static_cast<float>(px - rx0), uy = static_cast<float>(py - ry0);
            const float hx = rg.hx + (f->axx * ux + f->axy * uy);
            const float hy = rg.hy + (f->ayx * ux + f->ayy * uy);
            const float mx = kFloatSlack + kFloatRel * fabsf(hx);
            const float my = kFloatSlack + kFloatRel * fabsf(hy);
            if (!(hx >= tx_lo - mx && hx <= tx_hi + mx && hy >= ty_lo - my &&
                  hy <= ty_hi + my)) {
              s_first[i] = make_int2(kFar, kFar);  // cannot reach the tile
              continue;
            }
          }
          const int p = py * w + px;
          const float d = load_img(dout + p);  // dout cast to float32, as the Pallas kernel
          float wx[NT], wy[NT];
          const int x0 = axis_taps<NT, kAA>(__ldg(sx + p), wdx, rwdx, w, r, wx);
          const int y0 = axis_taps<NT, kAA>(__ldg(sy + p), wdy, rwdy, h, r, wy);
          s_first[i] = make_int2(x0, y0);
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            s_wx[t * kCap + i] = wx[t];  // float32, not rounded to the dtype
            s_a[t * kCap + i] = wy[t] != 0.f ? __fmul_rn(wy[t], d) : 0.f;
          }
        }
        __syncthreads();
        // gather: this thread's box within the chunk, row-major; a tap
        // outside a staged pixel's NT taps weighs 0
        const int ya = max(by0, cy0), yb = min(by1, cy0 + ch - 1);
        const int xa = max(bx0, cx0), xb = min(bx1, cx0 + cw - 1);
        for (int py = ya; py <= yb; ++py) {
          const int base = (py - cy0) * cw - cx0;
#pragma unroll 2
          for (int px = xa; px <= xb; ++px) {
            const int i = base + px;
            const int2 ft = s_first[i];
            const int dx = qx - ft.x, dy = qy - ft.y;
            const float w0 = static_cast<unsigned>(dx) < NT ? s_wx[dx * kCap + i] : 0.f;
            const float w1 = static_cast<unsigned>(dx + 1) < NT ? s_wx[(dx + 1) * kCap + i] : 0.f;
            const float a0 = static_cast<unsigned>(dy) < NT ? s_a[dy * kCap + i] : 0.f;
            const float a1 = static_cast<unsigned>(dy + 1) < NT ? s_a[(dy + 1) * kCap + i] : 0.f;
            // a term counts when both its weights are nonzero (wy * dout
            // stands for wy: it is 0 exactly where wy or dout is)
            if (a0 != 0.f) {
              if (w0 != 0.f) acc[0] = __fadd_rn(acc[0], __fmul_rn(a0, w0));
              if (w1 != 0.f) acc[1] = __fadd_rn(acc[1], __fmul_rn(a0, w1));
            }
            if (a1 != 0.f) {
              if (w0 != 0.f) acc[2] = __fadd_rn(acc[2], __fmul_rn(a1, w0));
              if (w1 != 0.f) acc[3] = __fadd_rn(acc[3], __fmul_rn(a1, w1));
            }
          }
        }
        __syncthreads();
      }
    }
  }
};

// Grid (ceil(w / kTileX), ceil(h / kTileY), b): one thread per 2 x 2
// quad of a tile of dimg; blockIdx.z is the image.
template <typename T, bool kAA>
__global__ void __launch_bounds__(kGatherThreads, kGatherBlocksPerSM)
    warp_bwd_gather_kernel(const T* __restrict__ dout, const float* __restrict__ sx,
                           const float* __restrict__ sy, const float* __restrict__ width_x,
                           const float* __restrict__ width_y, const double* __restrict__ rec,
                           int blocks, T* __restrict__ dimg, int h, int w, int r) {
  __shared__ __align__(16) unsigned char stage[kStageBytes];
  __shared__ Frame frame;
  const int b = blockIdx.z;
  const int64_t off = static_cast<int64_t>(b) * h * w;
  const int qx0 = blockIdx.x * kTileX, qy0 = blockIdx.y * kTileY;
  const int qx1 = min(qx0 + kTileX, w) - 1, qy1 = min(qy0 + kTileY, h) - 1;
  const int qx = qx0 + kQuad * (static_cast<int>(threadIdx.x) % (kTileX / kQuad));
  const int qy = qy0 + kQuad * (static_cast<int>(threadIdx.x) / (kTileX / kQuad));
  const float wdx = kAA ? __ldg(width_x + b) : 1.f;
  const float wdy = kAA ? __ldg(width_y + b) : 1.f;
  const int nx = kAA ? tap_count(wdx) : 2;
  const int ny = kAA ? tap_count(wdy) : 2;
  if (threadIdx.x < 32) {
    load_frame(frame, rec + static_cast<int64_t>(b) * (kRecHint + 3 * blocks), blocks, wdx, wdy,
               h, w, qx0, qx1, qy0, qy1);
  }
  __syncthreads();
  // NaN over the whole image: a tent wider than the dispatch takes, or a
  // NaN position
  const bool nan_image = nx == 0 || ny == 0 || (kAA && frame.nan);
  Gather<T, kAA> g{dout + off, sx + off, sy + off, &frame, stage, wdx, wdy,
                   h, w, r, qx, qy, qx0, qx1, qy0, qy1, {0.f, 0.f, 0.f, 0.f}};
  if (!nan_image) {
    if constexpr (kAA) {
      dispatch(nx > ny ? nx : ny, g);
    } else {
      g.template run<2>();
    }
  }
#pragma unroll
  for (int k = 0; k < kQuad * kQuad; ++k) {
    const int x = qx + k % kQuad, y = qy + k / kQuad;
    if (x <= qx1 && y <= qy1) {
      store_out(dimg + off + static_cast<int64_t>(y) * w + x,
                nan_image ? __int_as_float(0x7fc00000) : g.acc[k]);
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* dout, const void* sx, const void* sy, const void* width_x,
                       const void* width_y, double* rec, int blocks, void* dimg, int b, int h,
                       int w, int antialias, int radius, cudaStream_t stream) {
  const T* dt = static_cast<const T*>(dout);
  const float* sxf = static_cast<const float*>(sx);
  const float* syf = static_cast<const float*>(sy);
  const float* wxf = static_cast<const float*>(width_x);
  const float* wyf = static_cast<const float*>(width_y);
  T* out = static_cast<T*>(dimg);
  const dim3 hint_grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  const dim3 grid(static_cast<unsigned>((w + kTileX - 1) / kTileX),
                  static_cast<unsigned>((h + kTileY - 1) / kTileY), static_cast<unsigned>(b));
  if (antialias) {
    warp_bwd_hint_kernel<true><<<hint_grid, kHintThreads, 0, stream>>>(sxf, syf, wxf, wyf, rec,
                                                                        h, w);
    warp_bwd_gather_kernel<T, true><<<grid, kGatherThreads, 0, stream>>>(
        dt, sxf, syf, wxf, wyf, rec, blocks, out, h, w, radius);
  } else {
    warp_bwd_hint_kernel<false><<<hint_grid, kHintThreads, 0, stream>>>(sxf, syf, wxf, wyf,
                                                                         rec, h, w);
    warp_bwd_gather_kernel<T, false><<<grid, kGatherThreads, 0, stream>>>(
        dt, sxf, syf, wxf, wyf, rec, blocks, out, h, w, radius);
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
// dtype (0 float32, 1 bfloat16); rec: a [b, 12 + 3 hint_blocks] float64
// device buffer, the pre-pass's record (written before it is read; no
// zeroing), hint_blocks in [1, 128]; sx, sy, width_x, width_y, radius and
// the limits on b, h, w as otm_warp_fwd. Two launches on `stream`, the
// pre-pass and the gather; returns cudaGetLastError() after them
// (0 = launched).
int otm_warp_bwd(const void* dout, const void* sx, const void* sy, const void* width_x,
                 const void* width_y, void* rec, void* dimg, long long b, long long h,
                 long long w, int dtype, int antialias, int radius, int hint_blocks,
                 void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || h * w > INT_MAX - 4096 || radius < 0) {
    return cudaErrorInvalidValue;
  }
  if (hint_blocks < 1 || hint_blocks > kMaxHintBlocks) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bi = static_cast<int>(b), hi = static_cast<int>(h), wi = static_cast<int>(w);
  double* rd = static_cast<double*>(rec);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(dout, sx, sy, width_x, width_y, rd, hint_blocks, dimg, bi, hi,
                               wi, antialias, radius, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(dout, sx, sy, width_x, width_y, rd, hint_blocks, dimg,
                                       bi, hi, wi, antialias, radius, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* otm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
