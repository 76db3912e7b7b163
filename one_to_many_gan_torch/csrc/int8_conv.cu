// The int8 serving path's modulated 3x3 conv, fused, for Hopper (sm_90a):
// the decoder's ModulatedConv(int8=True) (serve --int8, generate --int8) in
// two launches, an amax pre-pass and the conv.
//
// Replaces no TPU kernel: the JAX package computes this conv with XLA's
// conv_general_dilated(..., preferred_element_type=int32) (its
// ops/quantize.py:79-89), after modulating, padding and quantising its
// input in separate XLA ops (its ops/modulated.py:105-106 and
// ops/quantize.py:53-64) and before casting and demodulating its output
// (ops/modulated.py:111, 129), not in Pallas. PyTorch has no int8
// convolution on CUDA.
//
// What it computes (ops/modulated.py, ops/quantize.py; Act is the
// activation type, float32 or bfloat16, and every product rounds once to
// it, as torch's elementwise ops do):
//   v[b,c,i,j] = Act(Act(x[b,c,i,j]) * Act(s[b,c]))   (s absent: ones)
//   vp         = v padded by `pad` (0 or 1) with zeros or by reflection
//   x_scale[b] = max(max |v[b]|, 1e-12) / 127          (pre-pass)
//   q          = clamp(rint(vp / x_scale[b]), -127, 127)  (int8 codes)
//   acc[b,o,h,w] = sum_{c,kh,kw} q[b,c,h+kh,w+kw] * wq[o,c,kh,kw]  (int32)
//   y[b,o,h,w] = Act(Act(float(acc) * (x_scale[b] * w_scale[o])) * Act(d[b,o]))
// with d absent taken as ones, written once in Act. The plain version
// composes the same steps in torch (ops/cuda/int8_conv.py). Neither pad
// changes the maximum (reflection copies values, zeros are no larger than
// |v|), divisions and products round to nearest without contraction, and
// integer sums are exact in any order: the output is bitwise the plain
// version's and the same from run to run.
//
// What bounds it: at the shipped config's n = 64 decode, bytes (two reads
// of x, one write of y) at the up convs and in float32, operations (at the
// dense int8 rate) at the 256-channel resnet convs in bfloat16.
//
// Design. The pre-pass reads x once, forms v and takes the largest |v| of
// each sample with one atomicMax on the bits of a non-negative float (exact
// in any order); the last block of each sample, counted with an atomic
// ticket, writes x_scale[b] as an IEEE quotient.
//
// The conv is an implicit GEMM with M = output pixels, N = output channels
// and K = 9 taps x C. A block of two warpgroups owns kRows output rows x 64
// output columns (one wgmma M = 64 per row) and all N of one N tile (64,
// 128 or 256 channels: 128 int32 accumulators a thread). K runs in slices
// of 32 channels. For each slice the block
//   1. copies the raw activations of its tile with their 3x3 halo, rows
//      y0-1 .. y0+kRows and columns x0-kLead .. x0+64+kLead, into shared
//      memory with 16-byte cp.async (reflected rows are copied from the row
//      they mirror; rows and chunks outside the image are zero-filled);
//   2. modulates and quantises them, the reflected columns and the zero
//      border resolved in the index maths (a table of each item's offsets,
//      the same for every slice, is built once), into int8 codes laid out as
//      [K half][halo pixel][16 bytes], no swizzle: eight consecutive pixels
//      are one 128-byte core matrix, so each of the 9 taps is the same tile
//      at a start offset of ((row + dy) * 66 + dx) * 16 bytes;
//   3. brings the slice's weights, packed by the wrapper as [tap][K half]
//      [n][16 bytes], in one bulk copy (cp.async.bulk) completing on an
//      mbarrier;
//   4. issues wgmma.mma_async m64nNk32 s32.s8.s8 for each tap and row.
// Codes and weights are double-buffered: the copies and the quantisation
// of slice k+1 run while the tensor cores work on slice k. Each float is
// read from device memory once per slice and block (halo rows again, from
// L2, by the neighbouring block), not nine times. The epilogue rescales,
// casts and demodulates in registers, stages the tile through shared
// memory as [row][channel][pixel] and writes each output row's 64 pixels
// as full lines, NCHW, once.
//
// A code is clamp(rint(v * (1 / x_scale))) unless that product lies within
// 1e-4 of a half-integer, where the quotient itself decides (codes8): the
// division's codes, with a multiply in place of most divisions.
//
// Later work (ROADMAP.md): a persistent, warp-specialised grid whose next
// tile's loads and quantisation overlap this tile's epilogue, and a deeper
// raw-input ring. (Multicasting each weight slice to a cluster of 2 or 4
// blocks was measured slower: PERF.md.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileW = 64;             // output pixels of one tile row: one wgmma M
constexpr int kHaloW = kTileW + 2;     // input columns that a tile row's taps read
constexpr int kSlice = 32;             // input channels per K slice: one wgmma K
constexpr int kGroup = 8;              // channels a loader item quantises
constexpr int kTaps = 9;               // 3 x 3
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kPitch = kTileW + 4;     // floats per staged output row: conflict-free writes
constexpr int kAmaxThreads = 256;
constexpr int kAmaxBlocks = 528;       // pre-pass blocks per call (4 per SM of 132)

// Tile shape per N tile: every thread holds 128 int32 accumulators.
template <int N>
struct Tile {
  static constexpr int kRowsPerWg = 256 / N;              // 1, 2 or 4
  static constexpr int kRows = kRowsPerWg * kWarpgroups;  // output rows per block
  static constexpr int kPix = (kRows + 2) * kHaloW;       // halo pixels
  static constexpr int kAStage = kSlice * kPix;           // code bytes per slice
  static constexpr int kBStage = kTaps * kSlice * N;      // weight bytes per slice
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to T as torch's cast rounds it (to nearest, ties to even).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// The modulated value Act(Act(x) * sr), sr = Act(s) already rounded.
template <typename Act, typename In>
__device__ __forceinline__ float modulate(In x, float sr) {
  float v = to_float(x);
  if constexpr (!std::is_same_v<In, Act>) v = round_to<Act>(v);
  return round_to<Act>(__fmul_rn(v, sr));
}

// The int8 codes of v[0..7] (ops/quantize.py::_codes: clamp(rint(v /
// scale), -127, 127), the quotient rounded to nearest), one byte a code.
// t = v * (1 / scale) lies within 2e-5 of the rounded quotient when
// |t| < 128 (two roundings), so where the clamped t lies farther than 1e-4
// from a half-integer both round to the same integer; near one the codes
// are taken from the quotient itself. Clamping before rounding gives the
// same codes (127.5 and above round to at least 128, then clamp to 127).
// Adding 1.5 * 2^23 rounds the clamped t to an integer, ties to even, and
// leaves it in the low byte of the sum's bits.
__device__ __forceinline__ uint2 codes8(const float (&v)[8], float scale, float inv_scale) {
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  uint32_t u[8];
  bool near_tie = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t = fminf(fmaxf(__fmul_rn(v[j], inv_scale), -127.f), 127.f);
    const float r = __fadd_rn(t, kRound);
    near_tie |= fabsf(fabsf(__fsub_rn(t, __fsub_rn(r, kRound))) - 0.5f) < 1e-4f;
    u[j] = __float_as_uint(r);
  }
  if (near_tie) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.f), 127.f);
      u[j] = __float_as_uint(__fadd_rn(q, kRound));
    }
  }
  // the low bytes of u[0..3] and u[4..7]
  return make_uint2(
      __byte_perm(__byte_perm(u[0], u[1], 0x0040), __byte_perm(u[2], u[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(u[4], u[5], 0x0040), __byte_perm(u[6], u[7], 0x0040), 0x5410));
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// This thread arrives on `bar` and tells it to expect `bytes`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) global -> shared,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared-memory writes of this thread made visible to the async proxy
// (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma operand descriptor, no swizzle: `lbo` the byte stride between the
// two 16-byte K halves, `sbo` between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk32, s32 += s8 x s8, A and B from shared memory
// (K-major), accumulating into d.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]),
        "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------------- pre-pass

template <typename In, typename Act>
__global__ void __launch_bounds__(kAmaxThreads)
    amax_kernel(const In* __restrict__ x, const float* __restrict__ s,
                unsigned* __restrict__ amax_bits, unsigned* __restrict__ tickets,
                float* __restrict__ x_scale, int C, long long plane, int parts, int vec) {
  const int b = blockIdx.y;
  float m = 0.f;
  for (int c = blockIdx.x; c < C; c += parts) {
    const long long bc = static_cast<long long>(b) * C + c;
    const float sr = s != nullptr ? round_to<Act>(s[bc]) : 1.f;
    const In* p = x + bc * plane;
    if (vec) {
      constexpr int kV = 16 / sizeof(In);
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
      for (long long i = threadIdx.x; i < plane / kV; i += kAmaxThreads) {
        const uint4 u = __ldg(p4 + i);
        const In* e = reinterpret_cast<const In*>(&u);
#pragma unroll
        for (int k = 0; k < kV; ++k) m = fmaxf(m, fabsf(modulate<Act>(e[k], sr)));
      }
    } else {
      for (long long i = threadIdx.x; i < plane; i += kAmaxThreads) {
        m = fmaxf(m, fabsf(modulate<Act>(p[i], sr)));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kAmaxThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kAmaxThreads / 32; ++i) m = fmaxf(m, warp_max[i]);
    // non-negative floats order as their bits do
    atomicMax(amax_bits + b, __float_as_uint(m));
    __threadfence();
    if (atomicAdd(tickets + b, 1u) == static_cast<unsigned>(parts - 1)) {
      const float amax = __uint_as_float(atomicMax(amax_bits + b, 0u));
      x_scale[b] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    }
  }
}

// ----------------------------------------------------------------- conv

template <typename In, typename Out, int N>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(const In* __restrict__ x, const float* __restrict__ s,
                const float* __restrict__ x_scale, const int8_t* __restrict__ wpk,
                const float* __restrict__ w_scale, const float* __restrict__ d,
                Out* __restrict__ y, int C, int H, int W, int O, int Ho, int Wo, int pad,
                int reflect, int strips, int row_groups, int aligned) {
  using T = Tile<N>;
  constexpr int kLead = 16 / sizeof(In);            // raw columns left of the strip
  constexpr int kRawW = kTileW + 2 * kLead;         // raw columns per row
  constexpr int kRawRows = T::kRows + 2;
  constexpr int kChunks = kRawW / kLead;            // 16-byte chunks per raw row
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sb = smem;                         // 2 stages of weights
  unsigned char* sa = sb + 2 * T::kBStage;          // 2 stages of codes
  In* raw = reinterpret_cast<In*>(sa + 2 * T::kAStage);  // one slice of raw inputs
  // Where each 16-byte raw chunk comes from (elements past the slice's
  // first, -1 outside the image) and what each quantiser item does (its
  // raw offset + 1 in the high half, 0 outside; its code offset in the
  // low half): the same for every slice.
  constexpr int kRawChunks = kSlice * kRawRows * kChunks;
  constexpr int kItems = 4 * T::kPix;
  int* chunk_src = reinterpret_cast<int*>(raw + kSlice * kRawRows * kRawW);
  uint32_t* items = reinterpret_cast<uint32_t*>(chunk_src + kRawChunks);
  __shared__ __align__(8) uint64_t full[2];
  __shared__ float s_slice[kSlice];
  __shared__ float out_scale[N];
  __shared__ float out_d[N];
  __shared__ int raw_row[kRawRows];

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int strip = blk % strips;
  blk /= strips;
  const int b = blk / row_groups;
  const int x0 = strip * kTileW;
  const int y0 = (blk - b * row_groups) * T::kRows;
  const int ntile = blockIdx.y;
  const int kt_count = C / kSlice;
  const long long plane = static_cast<long long>(H) * W;
  const In* xb = x + static_cast<long long>(b) * C * plane;
  const float scale = x_scale[b];
  const float inv_scale = __frcp_rn(scale);

  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int n = tid; n < N; n += kThreads) {
    const int o = ntile * N + n;
    out_scale[n] = o < O ? __fmul_rn(scale, w_scale[o]) : 0.f;
    out_d[n] = (o < O && d != nullptr) ? round_to<Out>(d[static_cast<long long>(b) * O + o])
                                       : 1.f;
  }
  if (tid < kRawRows) {
    int iy = y0 - pad + tid;
    if (reflect) iy = iy < 0 ? -iy : (iy >= H ? 2 * H - 2 - iy : iy);
    raw_row[tid] = (iy >= 0 && iy < H && y0 - pad + tid <= H) ? iy : -1;
  }
  __syncthreads();
  if (aligned) {
    for (int i = tid; i < kRawChunks; i += kThreads) {
      const int rc = i / kChunks;  // c * kRawRows + r
      const int iy = raw_row[rc % kRawRows];
      const int ix = x0 - kLead + (i - rc * kChunks) * kLead;
      // W % kLead == 0: a chunk lies all in or all out
      chunk_src[i] = (iy >= 0 && ix >= 0 && ix < W)
                         ? (rc / kRawRows) * static_cast<int>(plane) + iy * W + ix
                         : -1;
    }
  }
  for (int i = tid; i < kItems; i += kThreads) {
    const int g = i / T::kPix;
    const int p = i - g * T::kPix;
    const int ty = p / kHaloW;
    int ix = x0 - pad + (p - ty * kHaloW);
    if (reflect) ix = ix < 0 ? -ix : (ix == W ? W - 2 : ix);
    const bool ok = raw_row[ty] >= 0 && ix >= 0 && ix < W;
    const uint32_t from = ok ? (g * kGroup * kRawRows + ty) * kRawW + (ix - x0 + kLead) + 1 : 0;
    items[i] = from << 16 | ((g >> 1) * T::kPix * 16 + p * 16 + (g & 1) * 8);
  }
  __syncthreads();

  const int8_t* wtile = wpk + static_cast<long long>(ntile) * kt_count * T::kBStage;
  // Weight slice kt into stage st, one bulk copy.
  auto load_weights = [&](int kt, int st) {
    mbar_expect_tx(&full[st], T::kBStage);
    bulk_load(sb + st * T::kBStage, wtile + static_cast<long long>(kt) * T::kBStage,
              T::kBStage, &full[st]);
  };
  auto load_raw = [&](int kt) {
    const In* src = xb + static_cast<long long>(kt) * kSlice * plane;
    if (tid < kSlice) {
      s_slice[tid] =
          s != nullptr ? round_to<Out>(s[static_cast<long long>(b) * C + kt * kSlice + tid]) : 1.f;
    }
    if (aligned) {
      for (int i = tid; i < kRawChunks; i += kThreads) {
        const int off = chunk_src[i];
        cp_async16(raw + i * kLead, off >= 0 ? src + off : src, off >= 0);
      }
    } else {
      for (int i = tid; i < kSlice * kRawRows * kRawW; i += kThreads) {
        const int col = i % kRawW;
        const int rc = i / kRawW;
        const int iy = raw_row[rc % kRawRows];
        const int ix = x0 - kLead + col;
        if (iy >= 0 && ix >= 0 && ix < W) {
          raw[i] = src[(rc / kRawRows) * plane + static_cast<long long>(iy) * W + ix];
        }
      }
    }
  };
  // Codes of the raw slice into code stage `st`: item i quantises 8
  // channels of one halo pixel.
  auto quantise = [&](int st) {
    unsigned char* dst = sa + st * T::kAStage;
#pragma unroll 1
    for (int i = tid; i < kItems; i += kThreads) {
      const uint32_t item = items[i];
      const uint32_t to = item & 0xffffu;
      uint2 codes = make_uint2(0u, 0u);
      if (item >> 16) {
        const In* from = raw + (item >> 16) - 1;
        const int g = (to >= T::kPix * 16 ? 2 : 0) + ((to >> 3) & 1);
        float v[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          v[j] = modulate<Out>(from[j * kRawRows * kRawW], s_slice[g * kGroup + j]);
        }
        codes = codes8(v, scale, inv_scale);
      }
      asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(smem_addr(dst + to)),
                   "r"(codes.x), "r"(codes.y)
                   : "memory");
    }
    fence_proxy_async();
  };

  int acc[T::kRowsPerWg][N / 2];
#pragma unroll
  for (int r = 0; r < T::kRowsPerWg; ++r)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[r][i] = 0;

  const int wg = tid / 128;
  const uint32_t a_base = smem_addr(sa);
  const uint32_t b_base = smem_addr(sb);
  if (tid == 0) {
    load_weights(0, 0);
    if (kt_count > 1) load_weights(1, 1);
  }
  load_raw(0);
  cp_async_wait_all();
  __syncthreads();
  quantise(0);
  __syncthreads();
  if (kt_count > 1) load_raw(1);

  for (int kt = 0; kt < kt_count; ++kt) {
    const int st = kt & 1;
    mbar_wait(&full[st], (kt >> 1) & 1);
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < T::kRowsPerWg; ++r) {
      fence_regs(acc[r]);
      const int ry = wg * T::kRowsPerWg + r;
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        const uint32_t a = a_base + st * T::kAStage + ((ry + tap / 3) * kHaloW + tap % 3) * 16;
        const uint32_t bw = b_base + st * T::kBStage + tap * kSlice * N;
        wgmma_s8(acc[r], smem_desc(a, T::kPix * 16, 128), smem_desc(bw, N * 16, 128));
      }
      fence_regs(acc[r]);
    }
    wgmma_commit();
    if (kt + 1 < kt_count) {
      cp_async_wait_all();
      __syncthreads();  // the raw slice kt+1 has landed
      // code stage st^1 was last read by slice kt-1's products, which every
      // warpgroup waited for before the barrier that ended slice kt-1
      quantise(st ^ 1);
    }
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < T::kRowsPerWg; ++r) fence_regs(acc[r]);
    // every warpgroup has slice kt's products: weight stage st and the raw
    // buffer are free
    __syncthreads();
    if (kt + 2 < kt_count) {
      if (tid == 0) load_weights(kt + 2, st);
      load_raw(kt + 2);
    }
  }

  // Epilogue: rescale, cast, demodulate; stage as [row][channel][pixel].
  // Accumulator j*4+q of row r is pixel warp*16 + lane/4 (+8 for q >= 2)
  // and channel j*8 + 2*(lane%4) (+1 for odd q). The loop's last barrier
  // has passed: the shared memory is free.
  float* stage = reinterpret_cast<float*>(smem);
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int r = 0; r < T::kRowsPerWg; ++r) {
    float* rows = stage + (wg * T::kRowsPerWg + r) * N * kPitch;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = warp * 16 + (lane >> 2) + (q >> 1) * 8;
        const int n = j * 8 + (lane & 3) * 2 + (q & 1);
        const float v = round_to<Out>(__fmul_rn(__int2float_rn(acc[r][j * 4 + q]), out_scale[n]));
        rows[n * kPitch + m] = round_to<Out>(__fmul_rn(v, out_d[n]));
      }
  }
  __syncthreads();
  constexpr int kVec = 16 / sizeof(Out);
  constexpr int kSegs = kTileW / kVec;
  const bool vec_ok = Wo % kVec == 0;
  for (int i = tid; i < T::kRows * N * kSegs; i += kThreads) {
    const int seg = i % kSegs;
    const int row = i / kSegs;  // ry * N + n
    const int oy = y0 + row / N;
    const int o = ntile * N + row % N;
    const int ox = x0 + seg * kVec;
    if (oy >= Ho || o >= O || ox >= Wo) continue;
    Out* to = y + ((static_cast<long long>(b) * O + o) * Ho + oy) * Wo + ox;
    const float* from = stage + row * kPitch + seg * kVec;
    if (vec_ok && ox + kVec <= Wo) {
      if constexpr (std::is_same_v<Out, float>) {
        *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(from);
      } else {
        __align__(16) __nv_bfloat16 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16_rn(from[e]);
        *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(h);
      }
    } else {
      for (int e = 0; e < kVec && ox + e < Wo; ++e) {
        if constexpr (std::is_same_v<Out, float>) {
          to[e] = from[e];
        } else {
          to[e] = __float2bfloat16_rn(from[e]);
        }
      }
    }
  }
}

template <typename In, typename Out, int N>
int launch_conv(const void* x, const void* s, const void* xs, const void* wpk, const void* ws,
                const void* d, void* y, int B, int C, int H, int W, int O, int pad, int reflect,
                cudaStream_t stream) {
  using T = Tile<N>;
  constexpr int kLead = 16 / sizeof(In);
  const int raw = kSlice * (T::kRows + 2) * (kTileW + 2 * kLead) * static_cast<int>(sizeof(In));
  const int tables = 4 * (kSlice * (T::kRows + 2) * (kTileW / kLead + 2) + 4 * T::kPix);
  const int pipeline = 2 * T::kBStage + 2 * T::kAStage + raw + tables;
  const int staged = T::kRows * N * kPitch * static_cast<int>(sizeof(float));
  const int smem = pipeline > staged ? pipeline : staged;
  const int Ho = H + 2 * pad - 2;
  const int Wo = W + 2 * pad - 2;
  const int strips = (Wo + kTileW - 1) / kTileW;
  const int row_groups = (Ho + T::kRows - 1) / T::kRows;
  const long long blocks = static_cast<long long>(B) * row_groups * strips;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int aligned = W % kLead == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      static_cast<long long>(kSlice) * H * W <= INT_MAX;
  auto kernel = conv_kernel<In, Out, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((O + N - 1) / N));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(x), static_cast<const float*>(s), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wpk), static_cast<const float*>(ws),
      static_cast<const float*>(d), static_cast<Out*>(y), C, H, W, O, Ho, Wo, pad, reflect,
      strips, row_groups, aligned);
  return cudaGetLastError();
}

template <typename In, typename Out>
int dispatch_conv(int n_tile, const void* x, const void* s, const void* xs, const void* wpk,
                  const void* ws, const void* d, void* y, int B, int C, int H, int W, int O,
                  int pad, int reflect, cudaStream_t stream) {
  if (n_tile == 64) {
    return launch_conv<In, Out, 64>(x, s, xs, wpk, ws, d, y, B, C, H, W, O, pad, reflect, stream);
  }
  if (n_tile == 128) {
    return launch_conv<In, Out, 128>(x, s, xs, wpk, ws, d, y, B, C, H, W, O, pad, reflect,
                                     stream);
  }
  return launch_conv<In, Out, 256>(x, s, xs, wpk, ws, d, y, B, C, H, W, O, pad, reflect, stream);
}

template <typename In, typename Act>
int launch_amax(const void* x, const void* s, unsigned* work, void* xs, int B, int C,
                long long plane, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(work, 0, 2 * static_cast<size_t>(B) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  const int parts = std::min(C, std::max(1, (kAmaxBlocks + B - 1) / B));
  const int vec = plane % (16 / sizeof(In)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  amax_kernel<In, Act><<<dim3(parts, B), kAmaxThreads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<const float*>(s), work, work + B,
      static_cast<float*>(xs), C, plane, parts, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The pre-pass. x: contiguous [B, C, H, W] float32 (in_bf16 = 0) or
// bfloat16 (1); s: contiguous [B, C] float32 or null (ones); act_bf16: the
// type the modulation rounds to; work: 2*B unsigned ints of scratch; xs:
// [B] float32, written. All device buffers. Returns the launch's error
// (0 = launched); shapes the kernel cannot take return
// cudaErrorInvalidValue and launch nothing.
int otm_int8_amax(const void* x, const void* s, void* work, void* xs, int B, int C,
                  long long plane, int in_bf16, int act_bf16, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || plane <= 0) return cudaErrorInvalidValue;
  auto* w = static_cast<unsigned*>(work);
  const auto st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return act_bf16 ? launch_amax<__nv_bfloat16, __nv_bfloat16>(x, s, w, xs, B, C, plane, st)
                    : launch_amax<__nv_bfloat16, float>(x, s, w, xs, B, C, plane, st);
  }
  return act_bf16 ? launch_amax<float, __nv_bfloat16>(x, s, w, xs, B, C, plane, st)
                  : launch_amax<float, float>(x, s, w, xs, B, C, plane, st);
}

// The fused conv. x: contiguous [B, C, H, W] float32 or bfloat16 (in_bf16),
// 16-byte aligned; s: [B, C] float32 or null (ones); xs: [B] float32 (the
// pre-pass's); wpk: the int8 weight codes packed by the wrapper as
// [ceil(O / n_tile)][C / 32][3][3][2][n_tile][16], zero past O, 16-byte
// aligned; ws: [O] float32; d: [B, O] float32 or null (ones); y: contiguous
// [B, O, H + 2*pad - 2, W + 2*pad - 2] in the output type (out_bf16), which
// is also the type the modulation rounds to. A 3x3 conv, pad 0 or 1,
// reflect only with pad 1 (then H, W >= 2), C a multiple of 32, n_tile 64,
// 128 or 256. Returns the launch's error (0 = launched); what the kernel
// cannot take returns cudaErrorInvalidValue and launches nothing.
int otm_int8_modconv(const void* x, const void* s, const void* xs, const void* wpk,
                     const void* ws, const void* d, void* y, int B, int C, int H, int W, int O,
                     int pad, int reflect, int n_tile, int in_bf16, int out_bf16, void* stream) {
  if (B <= 0 || C <= 0 || O <= 0 || C % kSlice != 0 || (pad != 0 && pad != 1)) {
    return cudaErrorInvalidValue;
  }
  if (H + 2 * pad < 3 || W + 2 * pad < 3 || (reflect && (pad != 1 || H < 2 || W < 2))) {
    return cudaErrorInvalidValue;
  }
  if (n_tile != 64 && n_tile != 128 && n_tile != 256) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wpk)) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16 ? dispatch_conv<__nv_bfloat16, __nv_bfloat16>(n_tile, x, s, xs, wpk, ws, d, y,
                                                                   B, C, H, W, O, pad, reflect, st)
                    : dispatch_conv<__nv_bfloat16, float>(n_tile, x, s, xs, wpk, ws, d, y, B, C,
                                                          H, W, O, pad, reflect, st);
  }
  return out_bf16 ? dispatch_conv<float, __nv_bfloat16>(n_tile, x, s, xs, wpk, ws, d, y, B, C, H,
                                                        W, O, pad, reflect, st)
                  : dispatch_conv<float, float>(n_tile, x, s, xs, wpk, ws, d, y, B, C, H, W, O,
                                                pad, reflect, st);
}

const char* otm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
