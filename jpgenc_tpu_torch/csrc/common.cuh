// Device code shared by the encode kernels (k1a_fused.cu, k1a_gray.cu,
// k1_dct.cu, block_pack.cu).
//
// Two halves, each used by a fused kernel and by its split counterpart, so
// that both hold the same values bit for bit:
//
//  * the transform: tile_arithmetic behind one of two loaders (colour, the
//    dense operator over an MCU's raw RGB bytes; tile_transform is the row
//    kernels' pair) and gray_tile_transform ((x - 128) @ KDCT_ZZ). An image
//    can be coded by K1A (no optimize) and by K1 + kernel A (optimize), and
//    the capacity ladder may switch between them, so the per-coefficient
//    float sequence is ONE function: sums in k order with explicit
//    __fmaf_rn, then (+ bias), / q (a true division, never a reciprocal:
//    jpgenc_tpu/ops/pallas/k1_dct.py:72-74) and round half away, all with
//    _rn intrinsics so no contraction choice can differ between call sites.
//  * the entropy coder: code_block, one warp per 8x8 block (T.81 F.1.2).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace jpgenc {

constexpr int kWordScratch = 64;   // per-warp words; w_blk <= 56 fits
constexpr unsigned kFull = 0xffffffffu;

struct Tables {
  int ac[2 * 256];   // [tab][sym] (code << 5) | len
  int dc[2][16];     // [tab][ssss]
  int misc[4];       // zrl tab0, zrl tab1, eob tab0, eob tab1
};

// Block-wide load of one table set (ac_rows [4,128], dc_rows [2,128],
// misc [4]) into shared memory; the caller synchronises.
__device__ __forceinline__ void load_tables(Tables& t, const int* ac_rows,
                                            const int* dc_rows,
                                            const int* misc, int tid,
                                            int n_threads) {
  for (int i = tid; i < 2 * 256; i += n_threads) t.ac[i] = ac_rows[i];
  for (int i = tid; i < 32; i += n_threads)
    t.dc[i >> 4][i & 15] = dc_rows[(i >> 4) * 128 + (i & 15)];
  if (tid < 4) t.misc[tid] = misc[tid];
}

// ---------------------------------------------------------------------------
// Transform
// ---------------------------------------------------------------------------

__device__ __forceinline__ int round_div(float x, float q) {
  const float y = __fdiv_rn(x, q);
  return static_cast<int>(truncf(__fadd_rn(y, copysignf(0.5f, y))));
}

__device__ __forceinline__ int quantize(float acc, float bias, float q) {
  return round_div(__fadd_rn(acc, bias), q);
}

// Colour, in two parts so that every colour kernel of the dense operator
// shares ONE arithmetic: a loader that fills xs [SLOTS][K] with the MCUs'
// pixel bytes as floats in natural order (pixel row, pixel, channel), and
// tile_arithmetic. L = (HS*VS + 2) * 64 threads, one per output coefficient.
//
// Loader 1, from the image: SLOTS consecutive MCUs (raster order) of one
// image, starting at MCU first_g (which may be -1: the slot is then zero),
// read as strided 3*8*HS-byte row pieces with row and column clamped to H-1 /
// W-1: that clamp is the replicate pad.
template <int HS, int VS, int SLOTS>
__device__ __forceinline__ void load_tile_image(
    const uint8_t* __restrict__ im, int H, int W, int mx, int n_mcus,
    int first_g, float* xs, int tid) {
  constexpr int L = (HS * VS + 2) * 64;
  constexpr int MH = 8 * VS, ROW = 3 * 8 * HS;   // MCU rows, bytes per row
  constexpr int K = MH * ROW;                    // input bytes per MCU
  for (int i = tid; i < SLOTS * K; i += L) {
    const int s = i / K, e = i - s * K;
    const int g = first_g + s;
    float val = 0.f;
    if (g >= 0 && g < n_mcus) {
      const int my_i = g / mx, mx_i = g - my_i * mx;
      const int r = e / ROW, b = e - r * ROW;
      const int px = b / 3, c = b - px * 3;
      const int y = min(my_i * MH + r, H - 1);
      const int x = min(mx_i * 8 * HS + px, W - 1);
      val = static_cast<float>(im[(static_cast<size_t>(y) * W + x) * 3 + c]);
    }
    xs[i] = val;
  }
}

// Loader 2, from the MCU-contiguous repack (k1_dct.mcu_bytes: each MCU's K
// padded bytes back to back, already in natural order): n_valid <= SLOTS
// MCUs starting at src, read as 16-byte vectors (K is a multiple of 16 and
// src is 16-byte aligned, so a vector never straddles two MCUs); the slots
// past n_valid are zero.
template <int K, int SLOTS>
__device__ __forceinline__ void load_tile_packed(
    const uint8_t* __restrict__ src, int n_valid, float* xs, int tid,
    int n_threads) {
  static_assert(K % 16 == 0, "an MCU is a whole number of 16-byte vectors");
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (int i = tid; i < SLOTS * K / 16; i += n_threads) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i * 16 < n_valid * K) v = __ldg(s4 + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float4* d = reinterpret_cast<float4*>(xs + i * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d[j] = make_float4(static_cast<float>(w[j] & 255u),
                         static_cast<float>((w[j] >> 8) & 255u),
                         static_cast<float>((w[j] >> 16) & 255u),
                         static_cast<float>(w[j] >> 24));
  }
}

// The arithmetic, on xs as a loader left it (it synchronises first):
//  1. Thread tid computes coefficient tid of every slot as a dot product with
//     column tid of the dense operator m [K, L] (k1_dct._dense_operator
//     'natural'), read through L1/L2.
//  2. The quantized values replace xs as int zq [SLOTS][L] (returned).
// Every thread of the block must call it; it synchronises the block.
template <int HS, int VS, int SLOTS>
__device__ __forceinline__ int* tile_arithmetic(
    const float* __restrict__ m, const float* __restrict__ bias,
    const float* __restrict__ q, float* xs, int tid) {
  constexpr int L = (HS * VS + 2) * 64;
  constexpr int K = 8 * VS * 3 * 8 * HS;         // input bytes per MCU
  static_assert(L <= K, "coefficients reuse the pixel scratch");
  __syncthreads();                               // xs is loaded

  float acc[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) acc[s] = 0.f;
  for (int k = 0; k < K; k += 4) {
    const float m0 = __ldg(m + (k + 0) * L + tid);
    const float m1 = __ldg(m + (k + 1) * L + tid);
    const float m2 = __ldg(m + (k + 2) * L + tid);
    const float m3 = __ldg(m + (k + 3) * L + tid);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[s * K + k]);
      acc[s] = __fmaf_rn(xv.x, m0, acc[s]);
      acc[s] = __fmaf_rn(xv.y, m1, acc[s]);
      acc[s] = __fmaf_rn(xv.z, m2, acc[s]);
      acc[s] = __fmaf_rn(xv.w, m3, acc[s]);
    }
  }
  const float bc = bias[tid], qc = q[tid];
  __syncthreads();                               // xs becomes zq below
  int* zq = reinterpret_cast<int*>(xs);          // [SLOTS][L] quantized
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) zq[s * L + tid] = quantize(acc[s], bc, qc);
  __syncthreads();
  return zq;
}

// The row kernels' transform (K1A, K1): loader 1 + the arithmetic.
template <int HS, int VS, int SLOTS>
__device__ __forceinline__ int* tile_transform(
    const uint8_t* __restrict__ im, int H, int W, int mx, int n_mcus,
    int first_g, const float* __restrict__ m, const float* __restrict__ bias,
    const float* __restrict__ q, float* xs, int tid) {
  load_tile_image<HS, VS, SLOTS>(im, H, W, mx, n_mcus, first_g, xs, tid);
  return tile_arithmetic<HS, VS, SLOTS>(m, bias, q, xs, tid);
}

// Gray. SLOTS consecutive 8x8 blocks (raster order over the block grid, mx
// blocks per row) starting at block first_g (-1: a zero slot). 256 threads:
// thread tid owns coefficient tid & 63 of slots tid >> 6, + 4, + 8, ...
//  1. xs [SLOTS][64] takes float(pixel) - 128 (exact), clamped as above; ks
//     [64][64] takes the operator KDCT_ZZ (pixel -> zigzag coefficient).
//  2. Each coefficient is 64 FMAs in k order, / q, round half away.
//  3. The quantized values replace xs as int zq [SLOTS][64] (returned).
constexpr int kGrayThreads = 256;

template <int SLOTS>
__device__ __forceinline__ int* gray_tile_transform(
    const uint8_t* __restrict__ im, int H, int W, int mx, int n_mcus,
    int first_g, const float* __restrict__ kdct, const float* __restrict__ q,
    float* xs, float* ks, int tid) {
  for (int i = tid; i < 64 * 64; i += kGrayThreads) ks[i] = kdct[i];
  for (int i = tid; i < SLOTS * 64; i += kGrayThreads) {
    const int s = i >> 6, e = i & 63;
    const int g = first_g + s;
    float val = 0.f;
    if (g >= 0 && g < n_mcus) {
      const int my_i = g / mx, mx_i = g - my_i * mx;
      const int y = min(my_i * 8 + (e >> 3), H - 1);
      const int x = min(mx_i * 8 + (e & 7), W - 1);
      val = __fsub_rn(static_cast<float>(im[static_cast<size_t>(y) * W + x]),
                      128.0f);
    }
    xs[i] = val;
  }
  __syncthreads();

  constexpr int PER = (SLOTS + 3) / 4;           // slots per thread
  const int c = tid & 63, s0 = tid >> 6;
  int out[PER];
  const float qc = q[c];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = s0 + 4 * j;
    float acc = 0.f;
    if (s < SLOTS) {
      for (int k = 0; k < 64; ++k)
        acc = __fmaf_rn(xs[s * 64 + k], ks[k * 64 + c], acc);
    }
    out[j] = round_div(acc, qc);
  }
  __syncthreads();                               // xs becomes zq below
  int* zq = reinterpret_cast<int*>(xs);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = s0 + 4 * j;
    if (s < SLOTS) zq[s * 64 + c] = out[j];
  }
  __syncthreads();
  return zq;
}

// ---------------------------------------------------------------------------
// Entropy coding: one warp per 8x8 block
// ---------------------------------------------------------------------------

__device__ __forceinline__ int bit_length(int a) {   // a >= 0
  return a ? 32 - __clz(a) : 0;
}

__device__ __forceinline__ int amplitude(int v, int s) {
  return (v >= 0 ? v : v + (1 << s) - 1) & ((1 << s) - 1);
}

// OR a len-bit piece (len <= 32) into the MSB-first word scratch at bit off.
__device__ __forceinline__ void put_bits(uint32_t* ws, int w_blk, int off,
                                         uint32_t val, int len) {
  if (len <= 0) return;
  const int word = off >> 5;
  const uint64_t x = static_cast<uint64_t>(val) << (64 - len - (off & 31));
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  const uint32_t lo = static_cast<uint32_t>(x);
  if (hi && word < w_blk) atomicOr(&ws[word], hi);
  if (lo && word + 1 < w_blk) atomicOr(&ws[word + 1], lo);
}

struct Piece {       // one zigzag position's share of the block's bitstream
  int n_zrl;         // ZRL codes before the main piece (run >> 4)
  uint32_t val;      // main piece: DC/AC code + amplitude, or EOB
  int len;
};

__device__ __forceinline__ Piece analyze(int p, int v, uint64_t nz_mask,
                                         int dcdiff, int dctab, int actab,
                                         const Tables& t) {
  Piece r{0, 0u, 0};
  if (p == 0) {
    const int s = bit_length(abs(dcdiff));
    const int e = t.dc[dctab][s];
    r.val = (static_cast<uint32_t>(e >> 5) << s) | amplitude(dcdiff, s);
    r.len = (e & 31) + s;
  } else if (v != 0) {
    const uint64_t below = nz_mask & ((1ull << p) - 1ull);
    const int prev = below ? 63 - __clzll(static_cast<long long>(below)) : 0;
    const int run = p - prev - 1;
    const int s = bit_length(abs(v));
    const int e = t.ac[actab * 256 + (((run & 15) << 4) | s)];
    r.n_zrl = run >> 4;
    r.val = (static_cast<uint32_t>(e >> 5) << s) | amplitude(v, s);
    r.len = (e & 31) + s;
  } else if (p == 63) {          // zero tail: EOB
    const int e = t.misc[2 + actab];
    r.val = static_cast<uint32_t>(e >> 5);
    r.len = e & 31;
  }
  return r;
}

// One warp codes one 8x8 block. Each lane owns zigzag positions lane (v_lo)
// and lane + 32 (v_hi). Ballots of the nonzero mask give the runs,
// 32 - clz(|v|) the SSSS (equal to the reference's f32-exponent _ssss for
// |v| < 2^24), a shuffle scan the bit offsets, and pieces are ORed into the
// per-warp word scratch ws in shared memory. Words at or past w_blk are
// dropped; the true bit count is written, so callers detect overflow as
// bits > 32*w_blk.
__device__ __forceinline__ void code_block(int v_lo, int v_hi, int dcdiff,
                                           int dctab, int actab,
                                           const Tables& t, uint32_t* ws,
                                           int w_blk, uint32_t* words,
                                           int* bits, int lane) {
  ws[lane] = 0u;
  ws[lane + 32] = 0u;
  const unsigned b_lo = __ballot_sync(kFull, lane > 0 && v_lo != 0);
  const unsigned b_hi = __ballot_sync(kFull, v_hi != 0);
  const uint64_t mask = (static_cast<uint64_t>(b_hi) << 32) | b_lo;
  const Piece a = analyze(lane, v_lo, mask, dcdiff, dctab, actab, t);
  const Piece b = analyze(lane + 32, v_hi, mask, dcdiff, dctab, actab, t);
  const int zrl = t.misc[actab];
  const int zlen = zrl & 31;
  const uint32_t zval = static_cast<uint32_t>(zrl >> 5);
  const int len_a = a.n_zrl * zlen + a.len;
  const int len_b = b.n_zrl * zlen + b.len;

  // both halves' exclusive prefixes in one scan: each half's total is at
  // most 32 * 75 bits, so the low 16 bits never carry into the high ones
  const int packed = (len_b << 16) | len_a;
  int incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int excl = incl - packed;
  const int tot = __shfl_sync(kFull, incl, 31);
  const int tot_a = tot & 0xffff;
  const int off_a = excl & 0xffff;
  const int off_b = tot_a + (excl >> 16);
  __syncwarp();                                   // scratch zeroed

  for (int z = 0; z < a.n_zrl; ++z) put_bits(ws, w_blk, off_a + z * zlen, zval, zlen);
  put_bits(ws, w_blk, off_a + a.n_zrl * zlen, a.val, a.len);
  for (int z = 0; z < b.n_zrl; ++z) put_bits(ws, w_blk, off_b + z * zlen, zval, zlen);
  put_bits(ws, w_blk, off_b + b.n_zrl * zlen, b.val, b.len);
  __syncwarp();

  for (int j = lane; j < w_blk; j += 32) words[j] = ws[j];
  if (lane == 0) *bits = tot_a + (tot >> 16);
  __syncwarp();                                   // scratch free for reuse
}

}  // namespace jpgenc
