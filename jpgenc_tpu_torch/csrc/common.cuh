// Device code shared by the encode kernels (k1a_fused.cu, k1a_gray.cu,
// k1_dct.cu, block_pack.cu).
//
// Two halves, each used by a fused kernel and by its split counterpart, so
// that both hold the same values bit for bit:
//
//  * the transform. Colour: one per-block formulation for K1A, K1 rows and
//    the K1 repack kernel, in place of the dense [768, 384] operator that
//    jpgenc_tpu/ops/pallas/k1_dct.py (_dense_operator, _dense_dma_kernel,
//    _dense_kernel) and k1a_fused.py (_k1a_kernel) build for a matrix unit:
//    BT.601 per pixel, box-mean subsample, level shift, then every 8x8 block
//    times KDCT_ZZ [64, 64], divide, round half away. 24 576 FMAs per 4:2:0
//    MCU instead of the dense operator's 294 912, and the one operand is
//    16 KB, so it lives in shared memory. Gray (gray K1A, gray K1): the
//    same block product on (x - 128), gray_tile_product. An image can be
//    coded by K1A (no optimize) and by K1 + kernel A (optimize), and the
//    capacity ladder may switch between them, so the per-coefficient float
//    sequence is ONE function (convert_* then tile_product; gray: the loader
//    then gray_tile_product; both run block_products): every product and sum
//    is an explicit _rn intrinsic, so no contraction choice can differ
//    between call sites; the division is a true division, never a reciprocal
//    (jpgenc_tpu/ops/pallas/k1_dct.py:72-74).
//  * the entropy coder (T.81 F.1.2), as two device functions that emit the
//    same pieces in the same order, so that both give the same words and
//    bits: code_block, one warp per 8x8 block (K1A, gray K1A), and
//    code_block_serial, one lane per block, whose work follows the block's
//    nonzero coefficients (kernel A). chip_smoke.py holds kernel A on K1's
//    coefficients equal to K1A and gray K1A word for word.
//
// What bounds the colour transform on the H100 now: instruction throughput,
// not device memory. K1 rows takes 0.28 ms for 16 x 1080p 4:2:0 (H100 at
// 700 W) against 0.096 ms for the products' own FMAs at the float32 peak and
// a bytes bound of 0.06 ms: the rest is the products' shared-memory loads
// (about 11 FMAs per 16-byte load), the quantizer's true divisions (one per
// 64 FMAs, some ten instructions each) and the loaders' byte-to-float
// conversion. The gray transform, the same product with a plain loader:
// gray K1 takes 0.153-0.1554 ms for 16 x 1080p gray (NVIDIA H100 80GB HBM3
// at 700 W) against 0.0634 ms for its FMAs at the float32 peak and a bytes
// bound of 0.0297. Its products issue 128 FMAs per 16 shared-memory
// wavefronts, so by count the FMA pipe limits them, not the loads; the rest
// (not measured apart) is the quantizer's 32 true divisions a thread, the
// loader and the padding of a row's last tile (a 1080p row is 128 + 112
// blocks). PERF.md section 6 holds the measured times beside the bounds.
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

// Colour. A thread block of (nb+2)*64 threads takes a tile of T = kTileMcus
// = 4*kBpt MCUs and works in three steps on two shared arrays, ks [64][64]
// (KDCT_ZZ, pixel -> zigzag coefficient) and xs [T (+1)][STRIDE] (the
// samples):
//
//  1. A loader fills xs: per MCU its nb+2 blocks of 64 level-shifted float
//     samples in scan order (Y blocks row-major, Cb, Cr), block-major, each
//     MCU's slot padded by 4 floats. The loaders work in units of 48 raw
//     bytes (16 pixels) by VS rows, one thread per unit, converted in
//     registers as the bytes arrive: the thread writes its luma samples and
//     the box means of its HS x VS quads, so full-resolution chroma is never
//     staged. The pad makes the 16-byte stores of eight neighbouring units
//     (eight neighbouring MCUs where HS = 2) fall into eight different bank
//     groups. Three loaders: load_tile_image (rows of the image, 16-byte,
//     4-byte or clamped single-byte loads by the alignment of the row pitch
//     and the unit's position; the clamp is the replicate pad),
//     load_mcu_image (one MCU, K1A's predecessor) and load_tile_packed (the
//     MCU-contiguous repack).
//  2. tile_product: thread (bg, cg) = (tid >> 4, tid & 15) owns coefficients
//     4*cg..4*cg+3 of the kBpt blocks bg, bg + 4*(nb+2), ...: the same block
//     of MCUs m, m + 4, ... It reads four ks rows and each block's four
//     samples as 16-byte vectors per four k: 4 + kBpt loads for 16 * kBpt
//     FMAs. The 16 threads of a half-warp read one sample address (a
//     broadcast) and 16 consecutive ks vectors, so neither operand has a bank
//     conflict. Every accumulator is one __fmaf_rn chain from 0 with k
//     ascending (block_products): the chain of dc_of_block.
//  3. The quantized values replace xs as int16 zq [T][(nb+2)*64]: the MCUs'
//     coefficients in scan order, which is the layout of the output.
//
// Blocks per thread of the block product, kBpt, sets the tile for K1A, K1
// rows and the K1 repack kernel alike. It is a compile-time constant
// (-DJPGENC_BPT=n rebuilds the three kernels with another; kernels/
// tile_sweep.py does so for 4, 6, 8 and 10 and times them).
#ifndef JPGENC_BPT
#define JPGENC_BPT 10
#endif
constexpr int kBpt = JPGENC_BPT;
constexpr int kTileMcus = 4 * kBpt;

template <int HS, int VS>
struct Geo {
  static constexpr int NB = HS * VS;             // luma blocks per MCU
  static constexpr int NB2 = NB + 2;             // blocks per MCU
  static constexpr int L = NB2 * 64;             // coefficients = threads
  static constexpr int STRIDE = L + 4;           // floats per MCU slot of xs
  static constexpr int K = 8 * VS * 3 * 8 * HS;  // raw bytes per MCU
};

// Step 1 of the formulation, per pixel, in the order of
// jpgenc_tpu/ops/color.py:15-23: every product and sum rounded on its own,
// left to right.
__device__ __forceinline__ float luma_of(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                   __fmul_rn(0.114f, b));
}

// Cb and Cr before their + 128: the separable formulation's chroma samples
// (k1_dct.py:212-214 folds the level shift in).
__device__ __forceinline__ float cb_centred_of(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(-0.168735892f, r),
                             __fmul_rn(-0.331264108f, g)),
                   __fmul_rn(0.5f, b));
}

__device__ __forceinline__ float cr_centred_of(float r, float g, float b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.5f, r),
                             __fmul_rn(-0.418687589f, g)),
                   __fmul_rn(-0.081312411f, b));
}

__device__ __forceinline__ float cb_of(float r, float g, float b) {
  return __fadd_rn(cb_centred_of(r, g, b), 128.0f);
}

__device__ __forceinline__ float cr_of(float r, float g, float b) {
  return __fadd_rn(cr_centred_of(r, g, b), 128.0f);
}

// Byte b of 48 raw bytes held as 12 little-endian words.
__device__ __forceinline__ float byte_of(const uint32_t (&w)[12], int b) {
  return static_cast<float>((w[b >> 2] >> ((b & 3) * 8)) & 255u);
}

__device__ __forceinline__ void store8(float* d, const float* v) {
  reinterpret_cast<float4*>(d)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// One unit where HS = 2: w[i] holds the 16 pixels of luma row VS*rp + i of
// one MCU, whose sample slot is `slot`. Writes the rows' luma samples into
// their two blocks and row rp of Cb and Cr. Steps 2 and 3: the HS x VS box
// is summed in row-major order, scaled by the exact 1 / (HS*VS), and 128 is
// subtracted from every sample.
template <int VS>
__device__ __forceinline__ void convert_h2(const uint32_t (&w)[VS][12],
                                           float* slot, int rp) {
  constexpr int NB = 2 * VS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {        // 8 pixels: luma block column h
    float cb[4], cr[4];
#pragma unroll
    for (int i = 0; i < VS; ++i) {
      float y[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int o = 3 * (8 * h + p);
        const float r = byte_of(w[i], o), g = byte_of(w[i], o + 1),
                    b = byte_of(w[i], o + 2);
        y[p] = __fsub_rn(luma_of(r, g, b), 128.0f);
        if (i == 0 && (p & 1) == 0) {
          cb[p >> 1] = cb_of(r, g, b);
          cr[p >> 1] = cr_of(r, g, b);
        } else {
          cb[p >> 1] = __fadd_rn(cb[p >> 1], cb_of(r, g, b));
          cr[p >> 1] = __fadd_rn(cr[p >> 1], cr_of(r, g, b));
        }
      }
      const int row = VS * rp + i;
      store8(slot + ((row >> 3) * 2 + h) * 64 + (row & 7) * 8, y);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cb[j] = __fsub_rn(__fmul_rn(cb[j], 1.0f / NB), 128.0f);
      cr[j] = __fsub_rn(__fmul_rn(cr[j], 1.0f / NB), 128.0f);
    }
    float* c = slot + NB * 64 + rp * 8 + 4 * h;
    *reinterpret_cast<float4*>(c) = make_float4(cb[0], cb[1], cb[2], cb[3]);
    *reinterpret_cast<float4*>(c + 64) =
        make_float4(cr[0], cr[1], cr[2], cr[3]);
  }
}

// One unit where HS = VS = 1: w holds two runs of 8 pixels; run j is row
// row_j of the MCU whose sample slot is slot_j (Y, Cb, Cr blocks).
__device__ __forceinline__ void convert_h1(const uint32_t (&w)[12],
                                           float* slot0, int row0,
                                           float* slot1, int row1) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float y[8], cb[8], cr[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int o = 3 * (8 * j + p);
      const float r = byte_of(w, o), g = byte_of(w, o + 1),
                  b = byte_of(w, o + 2);
      y[p] = __fsub_rn(luma_of(r, g, b), 128.0f);
      cb[p] = __fsub_rn(cb_of(r, g, b), 128.0f);
      cr[p] = __fsub_rn(cr_of(r, g, b), 128.0f);
    }
    float* d = (j ? slot1 : slot0) + (j ? row1 : row0) * 8;
    store8(d, y);
    store8(d + 64, cb);
    store8(d + 128, cr);
  }
}

// 48 bytes at p as 12 words: VEC = 16 (p 16-byte aligned) or 4.
template <int VEC>
__device__ __forceinline__ void gather_vec(const uint8_t* __restrict__ p,
                                           uint32_t (&w)[12]) {
  if constexpr (VEC == 16) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint4 v = __ldg(q + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 12; ++i) w[i] = __ldg(q + i);
  }
}

// 8 pixels of image row y from pixel x as words w[OFF..OFF+5], one byte at
// a time, row and column clamped to H-1 / W-1: the replicate pad.
template <int OFF>
__device__ __forceinline__ void gather_clamped(const uint8_t* __restrict__ im,
                                               int H, int W, int y, int x,
                                               uint32_t (&w)[12]) {
  const uint8_t* row = im + static_cast<size_t>(min(y, H - 1)) * W * 3;
#pragma unroll
  for (int i = 0; i < 6; ++i) w[OFF + i] = 0u;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint8_t* px = row + static_cast<size_t>(min(x + p, W - 1)) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int b = 3 * p + c;
      w[OFF + (b >> 2)] |= static_cast<uint32_t>(__ldg(px + c))
                           << ((b & 3) * 8);
    }
  }
}

// 16 pixels of image row y from pixel x: a vector load where the unit lies
// inside the image and vec (16, 4 or 1: what the image's base and row pitch
// are aligned to) allows one, the clamped path otherwise.
__device__ __forceinline__ void gather_row(const uint8_t* __restrict__ im,
                                           int H, int W, int vec, bool inside,
                                           int y, int x, uint32_t (&w)[12]) {
  if (inside && vec > 1) {
    const uint8_t* p = im + (static_cast<size_t>(y) * W + x) * 3;
    if (vec == 16) gather_vec<16>(p, w);
    else gather_vec<4>(p, w);
  } else {
    gather_clamped<0>(im, H, W, y, x, w);
    gather_clamped<6>(im, H, W, y, x + 8, w);
  }
}

// Loader 1, from the image: the T = kTileMcus MCUs mx0 .. mx0+T-1 of MCU row
// my_i (those past mx-1 are skipped: their slots hold garbage that no one
// stores). Neighbouring threads take neighbouring units of one pixel row.
template <int HS, int VS>
__device__ __forceinline__ void load_tile_image(
    const uint8_t* __restrict__ im, int H, int W, int vec, int mx, int my_i,
    int mx0, float* xs, int tid) {
  using G = Geo<HS, VS>;
  constexpr int T = kTileMcus;
  constexpr int COLS = T * HS / 2;               // units per pixel row
  for (int u = tid; u < COLS * 8; u += G::L) {
    const int cu = u % COLS, rp = u / COLS;      // rp: 0..7
    const int m = mx0 + cu * (2 / HS);           // the unit's (first) MCU
    if (m >= mx) continue;
    const int x = m * 8 * HS, y = (my_i * 8 + rp) * VS;
    const bool inside = x + 16 <= W && y + VS <= H;
    float* slot = xs + cu * (2 / HS) * G::STRIDE;
    if constexpr (HS == 2) {
      uint32_t w[VS][12];
#pragma unroll
      for (int i = 0; i < VS; ++i)
        gather_row(im, H, W, vec, inside, y + i, x, w[i]);
      convert_h2<VS>(w, slot, rp);
    } else {
      uint32_t w[12];
      gather_row(im, H, W, vec, inside, y, x, w);
      convert_h1(w, slot, rp, slot + G::STRIDE, rp);
    }
  }
}

// Loader 2, one MCU (mx_i, my_i) of the image into `slot`: K1A's predecessor.
// The calling thread takes unit j of the MCU's 8 (HS = 2) or 4; a thread with
// another j does nothing.
template <int HS, int VS>
__device__ __forceinline__ void load_mcu_image(
    const uint8_t* __restrict__ im, int H, int W, int vec, int mx_i, int my_i,
    float* slot, int j) {
  const int x = mx_i * 8 * HS;
  if constexpr (HS == 2) {
    if (j >= 8) return;
    const int y = (my_i * 8 + j) * VS;
    const bool inside = x + 16 <= W && y + VS <= H;
    uint32_t w[VS][12];
#pragma unroll
    for (int i = 0; i < VS; ++i)
      gather_row(im, H, W, vec, inside, y + i, x, w[i]);
    convert_h2<VS>(w, slot, j);
  } else {
    if (j >= 4) return;
    uint32_t w[12];
    gather_clamped<0>(im, H, W, my_i * 8 + 2 * j, x, w);
    gather_clamped<6>(im, H, W, my_i * 8 + 2 * j + 1, x, w);
    convert_h1(w, slot, 2 * j, slot, 2 * j + 1);
  }
}

// Loader 3, from the MCU-contiguous repack (k1_dct.mcu_bytes: each MCU's K
// padded bytes back to back in memory order: pixel row, pixel, channel):
// n_valid <= T MCUs starting at src, which is 16-byte aligned as K is a
// multiple of 16. Neighbouring threads read neighbouring 48*VS bytes.
template <int HS, int VS>
__device__ __forceinline__ void load_tile_packed(
    const uint8_t* __restrict__ src, int n_valid, float* xs, int tid) {
  using G = Geo<HS, VS>;
  constexpr int T = kTileMcus;
  constexpr int PER = HS == 2 ? 8 : 4;           // units per MCU
  for (int u = tid; u < T * PER; u += G::L) {
    const int s = u / PER, j = u - s * PER;
    if (s >= n_valid) break;
    float* slot = xs + s * G::STRIDE;
    const uint8_t* p = src + static_cast<size_t>(s) * G::K + j * 48 * VS;
    if constexpr (HS == 2) {
      uint32_t w[VS][12];
#pragma unroll
      for (int i = 0; i < VS; ++i) gather_vec<16>(p + 48 * i, w[i]);
      convert_h2<VS>(w, slot, j);
    } else {
      uint32_t w[12];
      gather_vec<16>(p, w);
      convert_h1(w, slot, 2 * j, slot, 2 * j + 1);
    }
  }
}

// Host side: what the launchers check and choose.
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The widest load (16, 4 or 1 bytes) that every row of every image of a
// contiguous u8 batch at img is aligned to, rows of pitch bytes: 3 * W for
// [B, H, W, 3], W for gray [B, H, W].
inline int load_alignment(const void* img, int pitch) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(img) | static_cast<uintptr_t>(pitch);
  return a % 16 == 0 ? 16 : a % 4 == 0 ? 4 : 1;
}

// KDCT_ZZ [64][64] into ks, 16 bytes a thread; kdct is 16-byte aligned.
__device__ __forceinline__ void load_operator(const float* __restrict__ kdct,
                                              float* ks, int tid,
                                              int n_threads) {
  const float4* s = reinterpret_cast<const float4*>(kdct);
  float4* d = reinterpret_cast<float4*>(ks);
  for (int i = tid; i < 64 * 64 / 4; i += n_threads) d[i] = __ldg(s + i);
}

// Coefficient 0 of one block of samples x [64], quantized by q0: the chain
// tile_product runs for every coefficient, so the value is the owner's bit
// for bit.
__device__ __forceinline__ int dc_of_block(const float* x, const float* ks,
                                           float q0) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < 64; ++k) acc = __fmaf_rn(x[k], ks[k * 64], acc);
  return round_div(acc, q0);
}

// The register tile of tile_product and gray_tile_product: coefficients
// 4*cg..4*cg+3 (kb = ks + 4*cg) of the N blocks at xb, xb + STEP, ...,
// each block's 64 samples contiguous and 16-byte aligned. Per four k, four
// 16-byte ks reads and one 16-byte sample read per block: 4 + N shared loads
// for 16 * N FMAs. Every accumulator is one __fmaf_rn chain from 0 with k
// ascending: the chain of dc_of_block.
template <int N, int STEP>
__device__ __forceinline__ void block_products(const float* xb,
                                               const float* kb,
                                               float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // not unrolled: a second iteration's operands in flight would not fit
  // beside 40 accumulators in 80 registers, and it measured no faster
#pragma unroll 1
  for (int k = 0; k < 64; k += 4) {
    const float4 k0 = *reinterpret_cast<const float4*>(kb + (k + 0) * 64);
    const float4 k1 = *reinterpret_cast<const float4*>(kb + (k + 1) * 64);
    const float4 k2 = *reinterpret_cast<const float4*>(kb + (k + 2) * 64);
    const float4 k3 = *reinterpret_cast<const float4*>(kb + (k + 3) * 64);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(xb + j * STEP + k);
      acc[j][0] = __fmaf_rn(x.x, k0.x, acc[j][0]);
      acc[j][1] = __fmaf_rn(x.x, k0.y, acc[j][1]);
      acc[j][2] = __fmaf_rn(x.x, k0.z, acc[j][2]);
      acc[j][3] = __fmaf_rn(x.x, k0.w, acc[j][3]);
      acc[j][0] = __fmaf_rn(x.y, k1.x, acc[j][0]);
      acc[j][1] = __fmaf_rn(x.y, k1.y, acc[j][1]);
      acc[j][2] = __fmaf_rn(x.y, k1.z, acc[j][2]);
      acc[j][3] = __fmaf_rn(x.y, k1.w, acc[j][3]);
      acc[j][0] = __fmaf_rn(x.z, k2.x, acc[j][0]);
      acc[j][1] = __fmaf_rn(x.z, k2.y, acc[j][1]);
      acc[j][2] = __fmaf_rn(x.z, k2.z, acc[j][2]);
      acc[j][3] = __fmaf_rn(x.z, k2.w, acc[j][3]);
      acc[j][0] = __fmaf_rn(x.w, k3.x, acc[j][0]);
      acc[j][1] = __fmaf_rn(x.w, k3.y, acc[j][1]);
      acc[j][2] = __fmaf_rn(x.w, k3.z, acc[j][2]);
      acc[j][3] = __fmaf_rn(x.w, k3.w, acc[j][3]);
    }
  }
}

// Four accumulators / their quantizers qv, round half away, as four int16
// packed in two words (the first in the low half).
__device__ __forceinline__ uint2 quantize4(const float (&a)[4], float4 qv) {
  const uint32_t v0 = static_cast<uint32_t>(round_div(a[0], qv.x));
  const uint32_t v1 = static_cast<uint32_t>(round_div(a[1], qv.y));
  const uint32_t v2 = static_cast<uint32_t>(round_div(a[2], qv.z));
  const uint32_t v3 = static_cast<uint32_t>(round_div(a[3], qv.w));
  return make_uint2((v0 & 0xffffu) | (v1 << 16), (v2 & 0xffffu) | (v3 << 16));
}

// quantize4 stored at d (8-byte aligned).
__device__ __forceinline__ void store_quantized(const float (&a)[4],
                                                float4 qv, int16_t* d) {
  *reinterpret_cast<uint2*>(d) = quantize4(a, qv);
}

// Steps 4 and 5 on xs and ks as the loaders left them (the caller has
// synchronised): the block products, then quantized int16 zq [T][L] in
// place of xs (returned). q [L] f32, 16-byte aligned: the quantizer of every
// coefficient of an MCU. Every thread of the block must call it; it
// synchronises the block before it overwrites xs and before it returns.
template <int HS, int VS>
__device__ __forceinline__ int16_t* tile_product(float* xs, const float* ks,
                                                 const float* __restrict__ q,
                                                 int tid) {
  using G = Geo<HS, VS>;
  const int cg = tid & 15, bg = tid >> 4;
  const int m0 = bg / G::NB2, blk = bg - m0 * G::NB2;
  float acc[kBpt][4];
  block_products<kBpt, 4 * G::STRIDE>(xs + m0 * G::STRIDE + blk * 64,
                                      ks + 4 * cg, acc);
  const float4 qv = __ldg(reinterpret_cast<const float4*>(q + blk * 64) + cg);
  __syncthreads();                               // xs becomes zq below
  int16_t* zq = reinterpret_cast<int16_t*>(xs);
#pragma unroll
  for (int j = 0; j < kBpt; ++j)
    store_quantized(acc[j], qv,
                    zq + ((m0 + 4 * j) * G::NB2 + blk) * 64 + 4 * cg);
  __syncthreads();
  return zq;
}

// n int16 values of zq (16-byte aligned, n a multiple of 8) to dst (16-byte
// aligned), 16 bytes a thread.
__device__ __forceinline__ void copy_zz(const int16_t* zq, int n,
                                        int16_t* __restrict__ dst, int tid,
                                        int n_threads) {
  const uint4* s = reinterpret_cast<const uint4*>(zq);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = tid; i < n / 8; i += n_threads) d[i] = s[i];
}

// Gray. A thread block of kGrayThreads = 256 threads takes a tile of
// kGrayTile = 16 * kGrayBpt consecutive 8x8 blocks inside one block row of
// one image (grid: tiles per row, block rows, images), so each of the tile's
// 8 pixel rows is one contiguous run of bytes. Shared arrays: ks [64][64]
// (KDCT_ZZ, pixel -> zigzag coefficient) and xs [kGrayTile][kGrayStride].
//  1. load_gray_tile fills xs with float(pixel) - 128 (exact), one block's
//     64 samples row-major per slot. A unit is one pixel row of two
//     neighbouring blocks, 16 bytes: one 16-byte load, four 4-byte loads or
//     16 clamped byte loads by the alignment of the image and its width W
//     (load_alignment) and the unit's position (the clamp is the
//     replicate pad; rows past H-1 read row H-1 with the unit's own load).
//     Neighbouring threads take neighbouring units of one pixel row. Bytes
//     become floats through the float adder (2^23 + b - (2^23 + 128)), not
//     the conversion unit. The slot pad of 4 floats puts the two blocks a
//     warp reads in the products into different bank groups.
//  2. gray_tile_product: thread (bg, cg) = (tid >> 4, tid & 15) owns
//     coefficients 4*cg..4*cg+3 of the kGrayBpt blocks bg, bg + 16, ...
//     (block_products: 4 + kGrayBpt 16-byte shared loads for 16 * kGrayBpt
//     FMAs; a half-warp reads one sample address, a broadcast, and one ks
//     row), / q, round half away.
//  3. The quantized values replace xs as int16 zq [kGrayTile][64]: the
//     tile's blocks in raster order, the layout of the output.
// Blocks per thread, kGrayBpt, is a compile-time constant (-DJPGENC_GRAY_BPT=n
// rebuilds gray K1A and gray K1 with another; kernels/gray_sweep.py does so
// and times them); ops/cuda/k1_dct.GRAY_TILE mirrors kGrayTile.
#ifndef JPGENC_GRAY_BPT
#define JPGENC_GRAY_BPT 8
#endif
constexpr int kGrayThreads = 256;
constexpr int kGrayBpt = JPGENC_GRAY_BPT;
constexpr int kGrayTile = 16 * kGrayBpt;
constexpr int kGrayStride = 64 + 4;              // floats per slot of xs

// float(byte i of w) - 128, exactly: 2^23 + b is a float whose low mantissa
// bits are b, and the difference of two floats in [2^23, 2^24) is exact.
__device__ __forceinline__ float level_shift(uint32_t w, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440 | i)),
                   8388736.0f);
}

// The 16 pixels x .. x+15 of one image row as four little-endian words.
__device__ __forceinline__ void gather_gray(const uint8_t* __restrict__ row,
                                            int W, int vec, int x,
                                            uint32_t (&w)[4]) {
  if (x + 16 <= W && vec == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + x));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if (x + 16 <= W && vec == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __ldg(reinterpret_cast<const uint32_t*>(row + x) + i);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0u;
#pragma unroll
    for (int b = 0; b < 16; ++b)
      w[b >> 2] |= static_cast<uint32_t>(__ldg(row + min(x + b, W - 1)))
                   << ((b & 3) * 8);
  }
}

// Loader: blocks mx0 .. mx0+kGrayTile-1 of block row by (those past mx-1
// are skipped: their slots hold garbage that no one stores).
__device__ __forceinline__ void load_gray_tile(
    const uint8_t* __restrict__ im, int H, int W, int vec, int mx, int by,
    int mx0, float* xs, int tid) {
  constexpr int COLS = kGrayTile / 2;            // units per pixel row
  for (int u = tid; u < COLS * 8; u += kGrayThreads) {
    const int cu = u % COLS, r = u / COLS;
    if (mx0 + 2 * cu >= mx) continue;
    uint32_t w[4];
    gather_gray(im + static_cast<size_t>(min(8 * by + r, H - 1)) * W, W, vec,
                8 * (mx0 + 2 * cu), w);
    float* d = xs + 2 * cu * kGrayStride + 8 * r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];
#pragma unroll
      for (int p = 0; p < 8; ++p)
        v[p] = level_shift(w[2 * h + (p >> 2)], p & 3);
      store8(d + h * kGrayStride, v);
    }
  }
}

// One block (bx, by) of the image into x [64]: gray K1A's predecessor. The
// calling thread takes pixel row j; a thread with another j does nothing.
__device__ __forceinline__ void load_gray_block(
    const uint8_t* __restrict__ im, int H, int W, int bx, int by, float* x,
    int j) {
  if (j >= 8) return;
  const uint8_t* row = im + static_cast<size_t>(min(8 * by + j, H - 1)) * W;
#pragma unroll
  for (int p = 0; p < 8; ++p)
    x[8 * j + p] = level_shift(__ldg(row + min(8 * bx + p, W - 1)), 0);
}

// Steps 2 and 3 on xs and ks as the loaders left them (the caller has
// synchronised); q [64] f32, 16-byte aligned. Every thread of the block must
// call it; it synchronises the block before it overwrites xs and before it
// returns.
__device__ __forceinline__ int16_t* gray_tile_product(
    float* xs, const float* ks, const float* __restrict__ q, int tid) {
  const int cg = tid & 15, bg = tid >> 4;
  float acc[kGrayBpt][4];
  block_products<kGrayBpt, 16 * kGrayStride>(xs + bg * kGrayStride,
                                             ks + 4 * cg, acc);
  const float4 qv = __ldg(reinterpret_cast<const float4*>(q) + cg);
  __syncthreads();                               // xs becomes zq below
  int16_t* zq = reinterpret_cast<int16_t*>(xs);
#pragma unroll
  for (int j = 0; j < kGrayBpt; ++j)
    store_quantized(acc[j], qv, zq + (bg + 16 * j) * 64 + 4 * cg);
  __syncthreads();
  return zq;
}

// Separable colour (K1 separable, k1_dct.cu's k1_color_kernel): the
// reference's _color_kernel sequence, which subsamples after the products.
// A thread block takes a tile of T MCUs inside one MCU row of one image
// (grid: tiles per row, MCU rows, images) and works on two shared arrays,
// ks [64][64] (KDCT_ZZ) and xs [T][SLOT]:
//  1. load_sep_tile fills each MCU's slot with its three full-resolution
//     planes, P = nb*64 samples each in Y-block order (block, row, column:
//     the reference's mcu_pack): y = luma - 128, and cb, cr without + 128
//     times the exact 1 / (hs*vs). Units of 16 pixels of one pixel row, 48
//     bytes read by gather_row, neighbouring threads on neighbouring units;
//     8 samples of a plane leave a unit as two 16-byte stores. The slot pad
//     of 4 floats puts neighbouring MCUs in different bank groups.
//  2. Luma: block_products over each luma block's 64 samples. Chroma:
//     plane_products over all P samples of a plane, the operand row of
//     sample k being KDCT_ZZ[cpos(k)], cpos(k) the chroma position k falls
//     into. The reference multiplies the unscaled sample by sc = S_sub @
//     KDCT_ZZ, whose row k is KDCT_ZZ[cpos(k)] * 1/(hs*vs) exactly (one
//     power-of-two weight a row of S_sub; pinned by a CPU test): the
//     scaled sample times the ks row is the same exact product, so each
//     __fmaf_rn rounds as the reference's does and sc is never read.
//  3. Every thread does the same FMAs: a chroma term costs what a luma term
//     does, and a chroma plane has nb times a luma block's terms, so a luma
//     thread takes NL MCUs and a chroma thread NL / nb. At the default tile
//     64 threads run the luma blocks, 128 the chroma planes: 2048 FMAs each.
// The tile, T = JPGENC_SEP_TILE * 4 / nb MCUs (32 luma blocks at the
// default 8: 120 MCUs of a 1080p row fill 15 tiles of 4:2:0), and NL =
// JPGENC_SEP_N are compile-time constants; kernels/separable_sweep.py
// rebuilds with others and times them (PERF.md section 6);
// ops/cuda/k1_dct.SEP_TILE mirrors JPGENC_SEP_TILE.
#ifndef JPGENC_SEP_TILE
#define JPGENC_SEP_TILE 8
#endif
#ifndef JPGENC_SEP_N
#define JPGENC_SEP_N 8
#endif

template <int HS, int VS>
struct SepGeo {
  static constexpr int NB = HS * VS;             // luma blocks per MCU
  static constexpr int P = NB * 64;              // samples of a plane
  static constexpr int L = (NB + 2) * 64;        // coefficients per MCU
  static constexpr int T = JPGENC_SEP_TILE * 4 / NB;   // MCUs a tile
  static constexpr int NL = JPGENC_SEP_N;        // MCUs a luma thread
  static constexpr int NC = NL / NB;             // MCUs a chroma thread
  static constexpr int GL = T / NL, GC = T / NC; // MCU groups
  static constexpr int LUMA = 16 * NB * GL;      // luma threads
  static constexpr int THREADS = LUMA + 32 * GC;
  static constexpr int MIN_BLOCKS = THREADS >= 768 ? 1 : 768 / THREADS;
  static constexpr int SLOT = 3 * P + 4;         // floats per MCU slot
  static constexpr size_t SMEM = 4 * (64 * 64 + static_cast<size_t>(T) * SLOT);
  static_assert(NC >= 1 && NL % NB == 0 && T % NL == 0 && T % NC == 0 &&
                    T % 2 == 0 && LUMA % 32 == 0,
                "separable tile: T, NL and nb do not divide");
};

// One unit of 16 pixels of pixel row `row` of an MCU row into the planes:
// HS = 2, the row of one MCU (slot), both its luma blocks of that row;
// HS = 1, the row of two neighbouring MCUs (slot, slot + SLOT).
template <int HS, int VS>
__device__ __forceinline__ void convert_sep(const uint32_t (&w)[12],
                                            float* slot, int row) {
  using G = SepGeo<HS, VS>;
  constexpr float kScale = 1.0f / G::NB;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float y[8], cb[8], cr[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int o = 3 * (8 * h + p);
      const float r = byte_of(w, o), g = byte_of(w, o + 1),
                  b = byte_of(w, o + 2);
      y[p] = __fsub_rn(luma_of(r, g, b), 128.0f);
      cb[p] = __fmul_rn(cb_centred_of(r, g, b), kScale);
      cr[p] = __fmul_rn(cr_centred_of(r, g, b), kScale);
    }
    float* d = (HS == 2 ? slot + ((row >> 3) * 2 + h) * 64
                        : slot + h * G::SLOT) + (row & 7) * 8;
    store8(d, y);
    store8(d + G::P, cb);
    store8(d + 2 * G::P, cr);
  }
}

// The T MCUs mx0 .. mx0+T-1 of MCU row my_i (those past mx-1 are skipped:
// their slots hold garbage that no one stores). A unit inside the image
// is three 16-byte or twelve 4-byte loads by vec (load_alignment); a unit
// that crosses the right edge takes the clamped path; rows past H-1 read
// row H-1 (the replicate pad).
template <int HS, int VS>
__device__ __forceinline__ void load_sep_tile(
    const uint8_t* __restrict__ im, int H, int W, int vec, int mx, int my_i,
    int mx0, float* xs, int tid) {
  using G = SepGeo<HS, VS>;
  constexpr int COLS = G::T * HS / 2;            // units per pixel row
  for (int u = tid; u < COLS * 8 * VS; u += G::THREADS) {
    const int cu = u % COLS, row = u / COLS;
    const int m = cu * (2 / HS);                 // the unit's (first) MCU
    if (mx0 + m >= mx) continue;
    const int x = (mx0 + m) * 8 * HS;
    uint32_t w[12];
    gather_row(im, H, W, vec, x + 16 <= W, min(my_i * 8 * VS + row, H - 1),
               x, w);
    convert_sep<HS, VS>(w, xs + m * G::SLOT, row);
  }
}

// The chroma counterpart of block_products where HS = 2: coefficients
// 4*cg..4*cg+3 (kb = ks + 4*cg) of one plane of the N MCUs at xb, xb +
// STEP, ..., each plane's 128 * VS samples in Y-block order. Samples 4i ..
// 4i+3 of a block lie in one pixel row and fall into two chroma positions,
// two samples each: per four k, two 16-byte ks reads and one sample read
// per MCU, 2 + N shared loads for 16 * N FMAs. Every accumulator is one
// __fmaf_rn chain from 0 with k ascending over all the plane's samples.
template <int N, int STEP, int VS>
__device__ __forceinline__ void plane_products(const float* xb,
                                               const float* kb,
                                               float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
  for (int blk = 0; blk < 2 * VS; ++blk) {
    // luma block (blk >> 1, blk & 1) covers chroma rows from
    // (blk >> 1) * 8 / VS and chroma columns from (blk & 1) * 4
    const float* kr = kb + ((blk >> 1) * (8 / VS) * 8 + (blk & 1) * 4) * 64;
    const float* xr = xb + blk * 64;
#pragma unroll
    for (int i = 0; i < 16; ++i) {               // pixel row i >> 1
      const float* kq = kr + (((i >> 1) / VS) * 8 + 2 * (i & 1)) * 64;
      const float4 k0 = *reinterpret_cast<const float4*>(kq);
      const float4 k1 = *reinterpret_cast<const float4*>(kq + 64);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float4 x =
            *reinterpret_cast<const float4*>(xr + j * STEP + 4 * i);
        acc[j][0] = __fmaf_rn(x.x, k0.x, acc[j][0]);
        acc[j][1] = __fmaf_rn(x.x, k0.y, acc[j][1]);
        acc[j][2] = __fmaf_rn(x.x, k0.z, acc[j][2]);
        acc[j][3] = __fmaf_rn(x.x, k0.w, acc[j][3]);
        acc[j][0] = __fmaf_rn(x.y, k0.x, acc[j][0]);
        acc[j][1] = __fmaf_rn(x.y, k0.y, acc[j][1]);
        acc[j][2] = __fmaf_rn(x.y, k0.z, acc[j][2]);
        acc[j][3] = __fmaf_rn(x.y, k0.w, acc[j][3]);
        acc[j][0] = __fmaf_rn(x.z, k1.x, acc[j][0]);
        acc[j][1] = __fmaf_rn(x.z, k1.y, acc[j][1]);
        acc[j][2] = __fmaf_rn(x.z, k1.z, acc[j][2]);
        acc[j][3] = __fmaf_rn(x.z, k1.w, acc[j][3]);
        acc[j][0] = __fmaf_rn(x.w, k1.x, acc[j][0]);
        acc[j][1] = __fmaf_rn(x.w, k1.y, acc[j][1]);
        acc[j][2] = __fmaf_rn(x.w, k1.z, acc[j][2]);
        acc[j][3] = __fmaf_rn(x.w, k1.w, acc[j][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Entropy coding: one warp per 8x8 block (code_block) or one lane per block
// (code_block_serial)
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

// One lane codes one 8x8 block: z [64] its zigzag coefficients (shared
// memory), ac_mask bit p set where AC coefficient p is nonzero (bit 0
// clear). The pieces of code_block, in its order: the DC piece, then for
// each set bit (__ffsll) the run's ZRLs and the AC piece, then EOB unless
// position 63 is nonzero. They collect MSB-first in a 64-bit register that
// leaves 32 bits at a time into row[0, w_blk), which the caller has zeroed;
// words at or past w_blk are dropped. Returns the true bit count, so callers
// detect overflow as bits > 32*w_blk.
__device__ __forceinline__ int code_block_serial(const int16_t* z,
                                                 uint64_t ac_mask, int dcdiff,
                                                 int dctab, int actab,
                                                 const Tables& t,
                                                 uint32_t* row, int w_blk) {
  uint64_t acc = 0;     // pending bits, MSB-aligned
  int n = 0, k = 0, total = 0;
  auto put = [&](uint32_t val, int len) {     // len <= 32, n < 32
    if (len <= 0) return;
    acc |= static_cast<uint64_t>(val) << (64 - n - len);
    n += len;
    total += len;
    if (n >= 32) {
      if (k < w_blk) row[k] = static_cast<uint32_t>(acc >> 32);
      ++k;
      acc <<= 32;
      n -= 32;
    }
  };
  {
    const int s = bit_length(abs(dcdiff));
    const int e = t.dc[dctab][s];
    put((static_cast<uint32_t>(e >> 5) << s) | amplitude(dcdiff, s),
        (e & 31) + s);
  }
  const int* ac = t.ac + actab * 256;
  const int zrl = t.misc[actab];
  int prev = 0;
  while (ac_mask) {
    const int p = __ffsll(static_cast<long long>(ac_mask)) - 1;
    ac_mask &= ac_mask - 1;
    int run = p - prev - 1;
    for (; run >= 16; run -= 16) put(static_cast<uint32_t>(zrl >> 5), zrl & 31);
    const int v = z[p];
    const int s = bit_length(abs(v));
    const int e = ac[(run << 4) | s];
    put((static_cast<uint32_t>(e >> 5) << s) | amplitude(v, s), (e & 31) + s);
    prev = p;
  }
  if (prev != 63) {
    const int e = t.misc[2 + actab];
    put(static_cast<uint32_t>(e >> 5), e & 31);
  }
  if (n > 0 && k < w_blk) row[k] = static_cast<uint32_t>(acc >> 32);
  return total;
}

}  // namespace jpgenc
