// Int8 convolution with int32 accumulation and a per-(image, output
// channel) rescale, for Hopper (sm_90a): the decoder's modulated convs on
// the int8 serving path (serve --int8, generate --int8).
//
// Replaces no TPU kernel: the JAX package computes this conv with XLA's
// conv_general_dilated(..., preferred_element_type=int32)
// (its ops/quantize.py:79-89), not in Pallas. PyTorch has
// no int8 convolution on CUDA, and the only library route, an im2col
// (F.unfold) followed by torch._int_mm, writes and reads nine times the
// activations; this kernel reads each activation tile into shared memory
// instead and folds the dequantisation into its epilogue.
//
// What it computes (codes already quantised, ops/quantize.py):
//   y[b,o,h,w] = float(sum_{kh,kw,c} xq[b,h+kh,w+kw,c] * wq[o,kh,kw,c])
//                * (xs[b] * ws[o])
// a VALID conv of an already padded channels-last int8 input xq [B,Hp,Wp,C]
// with int8 weights wq [O,KH,KW,C], the sum exact in int32 (|sum| <=
// 127^2 * KH*KW*C), the result float32 NCHW [B,O,Ho,Wo]. The rescale forms
// the scale product first and multiplies with round-to-nearest intrinsics
// (no contraction), as the plain version does: integer sums are exact in
// any order, so the output is bitwise the plain version's and the same
// from run to run.
//
// What bounds it: at the shipped config's n = 64 decode, operations at the
// 256-channel sites (ops / 1979 TOP/s, the int8 tensor-core rate) and
// bytes at the last up conv, whose float32 output (2.1 GB) dominates.
//
// Design (simple first): an implicit GEMM with M = B*Ho*Wo output pixels,
// N = O output channels and K = KH*KW*C, K ordered (kh, kw, c) so that a
// 32-byte K slice is 32 consecutive channels of one tap (C % 32 == 0). A
// block of 256 threads (8 warps, 4 along M by 2 along N) owns a tile of
// 128 pixels by BN = 128 (or 64, where O <= 64) channels. Each K slice of
// the pixel tile (with its halo, through the tap offset) and of the
// weights is copied into shared memory with 16-byte cp.async, in a ring of
// 4 stages; rows are padded to 48 bytes so that ldmatrix reads them
// without bank conflicts. Each warp runs mma.sync m16n8k32 s8 x s8 -> s32
// on fragments loaded with ldmatrix; out-of-range pixels and channels are
// zero-filled and never stored. The epilogue writes the float32 output
// straight from the accumulators: eight consecutive pixels of one channel
// per 32-byte segment.
//
// Later work (ROADMAP.md): wgmma with TMA loads and a persistent grid;
// fusing the quantisation into the loads; an epilogue staged through
// shared memory for full-line stores.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBM = 128;      // output pixels per block
constexpr int kBK = 32;       // bytes of K per stage (one mma k-step)
constexpr int kStages = 4;    // cp.async ring depth
constexpr int kThreads = 256;  // 8 warps: 4 along M, 2 along N
constexpr int kRow = 48;      // bytes per shared row: 32 data + 16 pad

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ xs, const float* __restrict__ ws,
                     float* __restrict__ y, int Hp, int Wp, int C, int O, int KW, int Ho,
                     int Wo, int M, int KT) {
  constexpr int kWarpN = BN / 2;     // channels per warp
  constexpr int kNT = kWarpN / 8;    // n8 tiles per warp
  constexpr int kStageBytes = (kBM + BN) * kRow;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;
  const int warp_n = warp >> 2;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int hw = Ho * Wo;
  const long long K = static_cast<long long>(KT) * kBK;

  // This thread's 16-byte chunk of the pixel tile: row tid / 2, half tid % 2.
  const int a_row = tid >> 1;
  const int half = tid & 1;
  const int am = m0 + a_row;
  const bool a_valid = am < M;
  long long a_base = 0;
  if (a_valid) {
    const int b = am / hw;
    const int p = am - b * hw;
    const int h = p / Wo;
    const int col = p - h * Wo;
    a_base = ((static_cast<long long>(b) * Hp + h) * Wp + col) * C + half * 16;
  }
  // ... and of the weight tile (BN rows of 2 chunks: threads < 2 * BN).
  const bool b_loader = tid < 2 * BN;
  const int bo = n0 + a_row;
  const bool b_valid = b_loader && bo < O;
  const long long b_base = b_valid ? static_cast<long long>(bo) * K + half * 16 : 0;

  auto load_stage = [&](int stage, int kt) {
    unsigned char* sa = smem + stage * kStageBytes;
    unsigned char* sb = sa + kBM * kRow;
    const int k0 = kt * kBK;
    const int tap = k0 / C;
    const int c0 = k0 - tap * C;
    const int kh = tap / KW;
    const int kw = tap - kh * KW;
    const long long a_off = (static_cast<long long>(kh) * Wp + kw) * C + c0;
    cp_async16(sa + a_row * kRow + half * 16, a_valid ? x + a_base + a_off : x, a_valid);
    if (b_loader) {
      cp_async16(sb + a_row * kRow + half * 16, b_valid ? w + b_base + k0 : w, b_valid);
    }
  };

  int acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix row / byte offsets of this lane: A (16 x 32 bytes) takes its
  // four 8 x 16-byte matrices as rows 0-7 | 8-15 by bytes 0-15 | 16-31;
  // B (two n8 tiles x 32 bytes) as tile 0 bytes 0-15 | 16-31, tile 1 ...
  const int mat = lane >> 3;
  const int a_ld = ((mat & 1) * 8 + (lane & 7)) * kRow + (mat >> 1) * 16;
  const int b_ld = ((mat >> 1) * 8 + (lane & 7)) * kRow + (mat & 1) * 16;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();

    const unsigned char* sa = smem + (kt % kStages) * kStageBytes;
    const unsigned char* sb = sa + kBM * kRow;
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(af[i], sa + (warp_m * 32 + i * 16) * kRow + a_ld);
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, sb + (warp_n * kWarpN + j * 8) * kRow + b_ld);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_s8(acc[i][j], af[i], bf[0], bf[1]);
        mma_s8(acc[i][j + 1], af[i], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator (i, j, r) is pixel m0 + warp_m*32 + i*16 + g
  // (+8 for r >= 2) and channel n0 + warp_n*kWarpN + j*8 + 2*t (+1 for odd r),
  // g = lane / 4, t = lane % 4.
  const int g = lane >> 2;
  const int t = lane & 3;
  long long out_base[2][2];
  float out_scale[2][2];
  bool out_valid[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = m0 + warp_m * 32 + i * 16 + g + rr * 8;
      out_valid[i][rr] = m < M;
      const int b = out_valid[i][rr] ? m / hw : 0;
      const int p = out_valid[i][rr] ? m - b * hw : 0;
      out_base[i][rr] = static_cast<long long>(b) * O * hw + p;
      out_scale[i][rr] = out_valid[i][rr] ? xs[b] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int o = n0 + warp_n * kWarpN + j * 8 + 2 * t + cc;
      if (o >= O) continue;
      const float wso = ws[o];
      const long long o_off = static_cast<long long>(o) * hw;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (!out_valid[i][rr]) continue;
          const float scale = __fmul_rn(out_scale[i][rr], wso);
          y[out_base[i][rr] + o_off] = __fmul_rn(__int2float_rn(acc[i][j][rr * 2 + cc]), scale);
        }
    }
}

template <int BN>
int launch(const int8_t* x, const int8_t* w, const float* xs, const float* ws, float* y,
           int B, int Hp, int Wp, int C, int O, int KH, int KW, cudaStream_t stream) {
  const int Ho = Hp - KH + 1;
  const int Wo = Wp - KW + 1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long K = static_cast<long long>(KH) * KW * C;
  if (M > INT_MAX - kBM || K / kBK > INT_MAX) return cudaErrorInvalidValue;
  const int smem = kStages * (kBM + BN) * kRow;
  auto kernel = int8_conv_kernel<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((O + BN - 1) / BN));
  kernel<<<grid, kThreads, smem, stream>>>(x, w, xs, ws, y, Hp, Wp, C, O, KW, Ho, Wo,
                                           static_cast<int>(M), static_cast<int>(K / kBK));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous [B, Hp, Wp, C] int8 codes (already padded), w: contiguous
// [O, KH, KW, C] int8 codes, xs: [B] and ws: [O] float32 scales, y:
// contiguous [B, O, Hp-KH+1, Wp-KW+1] float32, all device buffers, x and w
// 16-byte aligned. Shapes the kernel cannot take (C not a multiple of 32,
// an empty output, more than 2^31 - 1 - 128 output pixels, a misaligned
// buffer) return cudaErrorInvalidValue and launch nothing. Otherwise
// returns the launch's error (0 = launched).
int otm_int8_conv(const void* x, const void* w, const void* xs, const void* ws, void* y,
                  int B, int Hp, int Wp, int C, int O, int KH, int KW, void* stream) {
  if (B <= 0 || C <= 0 || O <= 0 || KH <= 0 || KW <= 0 || Hp < KH || Wp < KW) {
    return cudaErrorInvalidValue;
  }
  if (C % kBK != 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* xsf = static_cast<const float*>(xs);
  const auto* wsf = static_cast<const float*>(ws);
  auto* out = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (O <= 64) return launch<64>(xq, wq, xsf, wsf, out, B, Hp, Wp, C, O, KH, KW, s);
  return launch<128>(xq, wq, xsf, wsf, out, B, Hp, Wp, C, O, KH, KW, s);
}

const char* otm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
