// Decoder reconstruction: quantized zigzag coefficients (int16, MCU-major) ->
// uint8 pixels, in one pass with every intermediate on chip.
//
// Replaces jpgenc_tpu/ops/pallas/recon.py: the inner `kernel` of
// `_make_kernel` (colour, 4:4:4 / 4:2:2 / 4:2:0) and `_gray_kernel`. The
// Python wrapper and the plain version are in ops/cuda/recon.py.
//
// The function, per component sample and per pixel:
//   1. xf = float(coefficient) * quant, zigzag order;
//   2. sample = clamp(rint(xf . KIDCT_ZZ[:, pos] + 128), 0, 255): the T.81
//      range limit on every component's samples, chroma too;
//   3. chroma to luma resolution with the centered 3:1 triangle, vertically
//      first, then horizontally, over the CLAMPED samples, plane edges
//      replicated;
//   4. BT.601 full range, rint, clamp, uint8;
//   5. rows >= h and columns >= w are not written.
//
// Sums are written with __fmaf_rn in k order and the colour stage with _rn
// multiplies and adds in the order of ops/color.py, so the result does not
// depend on nvcc's contraction. The upsample is exact in float32 (samples
// are integers <= 255, the weights are 3/4 and 1/4), so the only place where
// the kernel and the plain version (a cuBLAS/CPU matmul) can differ is the
// order of the 64-term sum of step 2, on a knife edge of rint.
//
// Design. A thread block reconstructs a tile of kTile consecutive MCUs of one
// MCU row (gray: kGrayTile blocks of one block row). Its blocks, and the
// neighbouring chroma blocks that the triangle filter of its border pixels
// needs (the halo), sit in shared memory dequantized, in groups of four,
// transposed so that coefficient k of a group's four blocks is one 16-byte
// word, each block with a 64-bit mask of its nonzero coefficients. A thread
// issues all its 16-byte loads (coefficients, then its part of KIDCT_ZZ)
// before it stores any.
//
//  * product: a thread computes 4 consecutive positions of the 4 blocks of
//    a group: per k one 16-byte read of row k of KIDCT_ZZ, one 16-byte read
//    of the group's coefficient k, 16 FMAs in registers. A half-warp covers
//    the 16 position quads of one group, so a warp reads per k 256 bytes of
//    the operator (2 wavefronts) and two coefficient words (1 wavefront):
//    3 wavefronts per 16 warp FMA instructions, where one sample a thread
//    with both operands from shared memory pays 2 per one.
//  * zero terms: the warp ORs the masks of the 8 blocks it serves
//    (__reduce_or_sync) and walks, in increasing k, the nibbles (k = 4n ..
//    4n+3) that hold a set bit, so the loop is uniform across the warp and
//    each step has constant offsets. Leaving out a term whose xf is 0, and
//    keeping one, are both exact: fma(+-0, K, acc) returns acc unless acc is
//    a zero, and then only that zero's sign can change; a later fma(x, K,
//    +-0) with x*K != 0 rounds x*K alike for both zeros, and the sign of a
//    zero does not survive + 128. Each sample is therefore the dense chain
//    bit for bit. The two warps of the halo rows serve 16 groups each; they
//    walk each thread's own mask instead of the union.
//  * halo: the chroma blocks of the MCU row above and below (row 7 / row 0,
//    two position quads each) and of the MCUs left and right (column 7 /
//    column 0: one group, all 16 quads) are computed by the same product
//    from the same shared copy as the owner's samples, so both sides of an
//    MCU boundary see the same clamped sample bit for bit. Outside the
//    padded chroma plane the extended plane copies the nearest computed
//    sample: the edge replication. For a full 4:2:0 tile of 16 MCUs that is
//    832 samples beside 6144 owned ones (13.5 % more products on dense
//    input; the 552 halo samples alone would be 9.0 %).
//  * pixels: a thread per chroma position computes its VS x HS pixels from
//    the 3 x 3 uint8 samples around it, converts with the float adder
//    instead of the conversion unit, and stages them; rows leave as aligned
//    4-byte words, the unaligned head and tail bytes of a row one by one.
//
// What bounds it on the H100: the function's bytes (2 bytes per coefficient
// in, 1 byte per sample out) bound it at 0.06 ms for 16 x 1080p 4:2:0. The
// kernel is far from that. On sparse coefficients its time splits between
// the loads (the halo's included), the products, the colour stage and the
// stores, each waiting on the one before it within a block; on dense ones
// the products' instruction issue dominates. PERF.md section 6 holds the
// measured times beside the bounds.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// MCUs (colour) and 8x8 blocks (gray) per thread block; -D rebuilds with
// another tile for a measurement.
#ifndef JPGENC_RECON_TILE
#define JPGENC_RECON_TILE 16
#endif
#ifndef JPGENC_RECON_GRAY_TILE
#define JPGENC_RECON_GRAY_TILE 64
#endif
constexpr int kTile = JPGENC_RECON_TILE;
constexpr int kGrayTile = JPGENC_RECON_GRAY_TILE;
static_assert(kTile >= 1 && kGrayTile % 8 == 0, "tile sizes");

constexpr unsigned kFull = 0xffffffffu;
// One group of four blocks in shared memory: coefficient k of the four at
// float4 row k + k / 8 (a pad row after every 8, so that the loader's
// stores spread over the banks), one more pad row so that two groups read at
// the same k sit on other banks.
constexpr int kGroupFloats = 73 * 4;

__device__ __forceinline__ int xs_row(int k) { return k + (k >> 3); }

// Conversions by the float adder, not the conversion unit (a quarter of
// the FMA rate on the H100), exact for the ranges used: 1.5 * 2^23 + v for
// |v| < 2^22 lies in the binade whose ulp is 1, so the sum is v rounded to
// an integer (ties to even, as rintf) and its low bits are that integer.
constexpr float kMagic = 12582912.f;             // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float int_small(int v) {         // |v| < 2^22
  return __fsub_rn(__int_as_float(kMagicBits + v), kMagic);
}

// clamp(rint(v), 0, 255) for any v, as clamp first, then rint (the bounds
// are integers, so the order changes no result): the low byte of the sum.
__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(
      __float_as_int(__fadd_rn(fminf(fmaxf(v, 0.f), 255.f), kMagic)));
}

// 0.75 a + 0.25 b as ops/color._upsample2_axis writes it. a and b are
// integers <= 255 or quarters of them, so both products and the sum are
// exact in float32 and the fused form gives the same bits.
__device__ __forceinline__ float tri(float a, float b) {
  return __fmaf_rn(0.75f, a, __fmul_rn(0.25f, b));
}

// KIDCT_ZZ [64][64] (row k = basis image of coefficient k), a block of
// THREADS threads: fetch() issues a thread's loads, store() puts them into
// ks, so that a kernel can have them in flight beside its other loads.
template <int THREADS>
struct OperatorLoad {
  static constexpr int N = (64 * 64 / 4 + THREADS - 1) / THREADS;
  float4 v[N];
  __device__ __forceinline__ void fetch(const float* __restrict__ kidct,
                                        int tid) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (tid + n * THREADS < 64 * 64 / 4)
        v[n] = __ldg(reinterpret_cast<const float4*>(kidct) + tid +
                     n * THREADS);
  }
  __device__ __forceinline__ void store(float* ks, int tid) const {
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (tid + n * THREADS < 64 * 64 / 4)
        reinterpret_cast<float4*>(ks)[tid + n * THREADS] = v[n];
  }
};

// Coefficients 8c..8c+7 of one block slot as read (8 int16 in 16 bytes):
// dequantized by q into the slot's column of its group xg, their nonzero
// bits into the slot's mask byte c. q == nullptr (a padding slot, a
// neighbour outside the image) gives zeros.
__device__ __forceinline__ void stage_chunk(int4 raw,
                                            const float* __restrict__ q,
                                            float* xg, uint8_t* mask_byte,
                                            int c) {
  float v[8];
  unsigned nz = 0;
  if (q != nullptr) {
    const float4 q0 = __ldg(reinterpret_cast<const float4*>(q + 8 * c));
    const float4 q1 = __ldg(reinterpret_cast<const float4*>(q + 8 * c) + 1);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
    const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const unsigned u = static_cast<unsigned>(words[e >> 1]);
      const int16_t xe =
          static_cast<int16_t>((e & 1) ? (u >> 16) : (u & 0xffffu));
      v[e] = __fmul_rn(int_small(xe), qv[e]);
      nz |= static_cast<unsigned>(xe != 0) << e;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) xg[xs_row(8 * c + e) * 4] = v[e];
  *mask_byte = static_cast<uint8_t>(nz);
}

// Positions 4*quad..4*quad+3 of the four blocks of group xg: every sample one
// __fmaf_rn chain from 0 over k increasing, then + 128, rint and the range
// limit. The chain runs over the nibbles (k = 4n .. 4n+3) that hold a
// nonzero coefficient of one of the blocks and leaves out the rest, all
// zero. m is the OR of this thread's group masks (0 for a thread without a
// job). With warp_union (the same for the whole warp, which must call it
// together) the warp walks the OR of its threads' masks, in step; without,
// each thread walks its own (the halo rows' warps, whose 16 groups would
// make the union long).
__device__ __forceinline__ void group_product(const float* ks, const float* xg,
                                              int quad, uint64_t m,
                                              bool warp_union,
                                              uint8_t (&px)[4][4]) {
  uint64_t left = m;
  if (warp_union) {
    const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(m));
    const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(m >> 32));
    left = (static_cast<uint64_t>(hi) << 32) | lo;
  }
  const float* kq = ks + 4 * quad;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  while (left) {
    const int k0 = (__ffsll(static_cast<long long>(left)) - 1) & ~3;
    left &= ~(0xfull << k0);
    const float* kr = kq + k0 * 64;
    const float* xr = xg + xs_row(k0) * 4;      // rows k0..k0+3 are adjacent
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d * 64);
      const float4 xv = *reinterpret_cast<const float4*>(xr + d * 4);
      const float xj[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] = __fmaf_rn(xj[j], kv.x, acc[j][0]);
        acc[j][1] = __fmaf_rn(xj[j], kv.y, acc[j][1]);
        acc[j][2] = __fmaf_rn(xj[j], kv.z, acc[j][2]);
        acc[j][3] = __fmaf_rn(xj[j], kv.w, acc[j][3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      px[j][e] = to_u8(__fadd_rn(acc[j][e], 128.f));
}

// The OR of the nonzero masks of group g's four slots.
__device__ __forceinline__ uint64_t group_mask(const uint8_t* mb, int g) {
  const uint64_t* m = reinterpret_cast<const uint64_t*>(mb) + 4 * g;
  return m[0] | m[1] | m[2] | m[3];
}

// n staged bytes (byte j at src[(dst & 3) + j]; src 4-byte aligned) to dst by
// the 32 lanes of a warp: aligned 4-byte words, head and tail bytes alone.
__device__ __forceinline__ void store_row(uint8_t* __restrict__ dst,
                                          const uint8_t* src, int n,
                                          int lane) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 3);
  const int head = min(n, (4 - off) & 3);
  const int nw = (n - head) >> 2;
  const int items = n - 3 * nw;                  // head + nw + tail
  src += off;
  for (int t = lane; t < items; t += 32) {
    if (t < head) {
      dst[t] = src[t];
    } else if (t < head + nw) {
      const int j = head + 4 * (t - head);
      *reinterpret_cast<uint32_t*>(dst + j) =
          *reinterpret_cast<const uint32_t*>(src + j);
    } else {
      const int j = t + 3 * nw;
      dst[j] = src[j];
    }
  }
}

// The colour tile: block slots in groups of four, the jobs over them, and
// the shared-memory layout (byte offsets).
//   groups [0, G_OWN): the tile's MCUs in scan order (luma NB, Cb, Cr),
//     16 jobs each (the position quads);
//   group G_OWN (4:2:0, 4:2:2): Cb, Cr of the MCU left, then of the MCU
//     right, 16 jobs;
//   G_ROW groups from G_TOP (4:2:0): Cb, Cr of MCUs x0-1 .. x0+kTile of the
//     row above, quads 14, 15 (sample row 7); then G_ROW groups of the row
//     below, quads 0, 1 (sample row 0).
template <int HS, int VS>
struct Tile {
  static constexpr int NB = HS * VS, NB2 = NB + 2, L = NB2 * 64;
  static constexpr int MH = 8 * VS, MW = 8 * HS;
  static constexpr int G_OWN = (kTile * NB2 + 3) / 4;
  static constexpr int G_TOP = G_OWN + (HS == 2 ? 1 : 0);
  static constexpr int G_ROW = VS == 2 ? (2 * (kTile + 2) + 3) / 4 : 0;
  static constexpr int G = G_TOP + 2 * G_ROW;
  static constexpr int JOBS = 16 * G_TOP + 4 * G_ROW;
  static constexpr int THREADS = (JOBS + 31) / 32 * 32;
  static constexpr int TW = kTile * MW;          // pixel columns of a tile
  static constexpr int CP = 8 * kTile + 8;       // extended chroma row pitch
  static constexpr int SP = TW * 3 + 4;          // staged output row pitch
  static constexpr int KS = 0;                   // float [64][64]
  static constexpr int XS = KS + 64 * 64 * 4;    // float [G][kGroupFloats]
  static constexpr int MB = XS + G * kGroupFloats * 4;  // u8 [4G][8]
  static constexpr int YS = MB + G * 32;         // u8 [kTile * NB][64]
  static constexpr int CS = YS + kTile * NB * 64;  // u8 [2][10][CP]
  static constexpr int BYTES = CS + 2 * 10 * CP;
  static_assert(MH * SP <= G * kGroupFloats * 4, "the stage aliases xs");
};

// Extended chroma plane of component c: row er (0 and 9: the rows above and
// below the tile), column ec (0 and n_cols - 1: left and right) at byte
// ec + 3, so that the tile's own samples (ec = 1 + 8 m + col) are 4-aligned.
template <class T>
__device__ __forceinline__ uint8_t* cs_at(uint8_t* cs, int c, int er, int ec) {
  return cs + (c * 10 + er) * T::CP + ec + 3;
}

template <int HS, int VS>
__global__ void __launch_bounds__(Tile<HS, VS>::THREADS)
recon_kernel(const int16_t* __restrict__ x, const float* __restrict__ q,
             const float* __restrict__ kidct, uint8_t* __restrict__ out,
             int my, int mx, int h, int w) {
  using T = Tile<HS, VS>;
  constexpr int NB = T::NB, NB2 = T::NB2, L = T::L;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* ks = reinterpret_cast<float*>(smem + T::KS);
  float* xs = reinterpret_cast<float*>(smem + T::XS);
  uint8_t* mb = smem + T::MB;
  uint8_t* ys = smem + T::YS;
  uint8_t* cs = smem + T::CS;

  const int tid = threadIdx.x;
  const int b = blockIdx.z, i = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int n_valid = min(kTile, mx - x0);
  const int n_cols = 8 * n_valid + 2;            // extended plane columns
  const float* qb = q + static_cast<size_t>(b) * L;
  const int16_t* xb = x + static_cast<size_t>(b) * my * mx * L;

  // every slot's coefficients, 8 per thread and a warp per group, and the
  // operator: all of a thread's loads first, then the stores
  constexpr int UNITS = T::G * 32;
  constexpr int ITERS = (UNITS + T::THREADS - 1) / T::THREADS;
  int4 raw[ITERS];
  int qoff[ITERS];                               // slot's lanes in q, or -1
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int u = tid + it * T::THREADS;
    const int c = u & 7, s = u >> 3;
    int mi = -1, mj = 0, blk = 0;                // MCU row, column; block
    if (u < UNITS && s < 4 * T::G_OWN) {
      if (s < n_valid * NB2) {
        mi = i;
        mj = x0 + s / NB2;
        blk = s % NB2;
      }
    } else if (u < UNITS && s < 4 * T::G_TOP) {  // left Cb, Cr; right Cb, Cr
      const int r = s - 4 * T::G_OWN;
      mj = r < 2 ? x0 - 1 : x0 + n_valid;
      blk = NB + (r & 1);
      if (mj >= 0 && mj < mx) mi = i;
    } else if (u < UNITS) {                      // the rows above and below
      int r = s - 4 * T::G_TOP;
      const bool below = r >= 4 * T::G_ROW;
      if (below) r -= 4 * T::G_ROW;
      const int row = below ? i + 1 : i - 1;
      mj = x0 + (r >> 1) - 1;
      blk = NB + (r & 1);
      if (r < 2 * (n_valid + 2) && row >= 0 && row < my && mj >= 0 && mj < mx)
        mi = row;
    }
    raw[it] = make_int4(0, 0, 0, 0);
    qoff[it] = -1;
    if (mi >= 0) {
      raw[it] = __ldg(reinterpret_cast<const int4*>(
          xb + (static_cast<size_t>(mi) * mx + mj) * L + blk * 64 + 8 * c));
      qoff[it] = blk * 64;
    }
  }
  OperatorLoad<T::THREADS> op;
  op.fetch(kidct, tid);
  op.store(ks, tid);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int u = tid + it * T::THREADS;
    if (u >= UNITS) break;
    const int c = u & 7, s = u >> 3;
    stage_chunk(raw[it], qoff[it] < 0 ? nullptr : qb + qoff[it],
                xs + (s >> 2) * kGroupFloats + (s & 3), mb + s * 8 + c, c);
  }
  __syncthreads();

  // one job a thread: position quad `quad` of group g's four slots
  int g = 0, quad = 0;
  bool active = true;
  if (tid < 16 * T::G_TOP) {
    g = tid >> 4;
    quad = tid & 15;
  } else {
    int u = tid - 16 * T::G_TOP;
    const bool below = u >= 2 * T::G_ROW;
    if (below) u -= 2 * T::G_ROW;
    active = u < 2 * T::G_ROW;
    g = T::G_TOP + (below ? T::G_ROW : 0) + (u >> 1);
    quad = (below ? 0 : 14) + (u & 1);
  }
  uint8_t px[4][4];
  group_product(ks, xs + (active ? g : 0) * kGroupFloats, quad,
                active ? group_mask(mb, g) : 0,
                (tid | 31) < 16 * T::G_OWN, px);
  if (active) {
    const int row = quad >> 1, col0 = (quad & 1) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * g + j;
      const uint32_t word = px[j][0] | (px[j][1] << 8) | (px[j][2] << 16) |
                            (static_cast<uint32_t>(px[j][3]) << 24);
      if (g < T::G_OWN) {
        if (s >= n_valid * NB2) continue;
        const int m = s / NB2, bk = s - m * NB2;
        uint8_t* d = bk < NB ? ys + (m * NB + bk) * 64 + 4 * quad
                             : cs_at<T>(cs, bk - NB, row + 1, 8 * m + col0 + 1);
        *reinterpret_cast<uint32_t*>(d) = word;
      } else if (g < T::G_TOP) {
        const int r = s - 4 * T::G_OWN;
        if (r < 2 && x0 > 0 && (quad & 1))
          *cs_at<T>(cs, r & 1, row + 1, 0) = px[j][3];
        else if (r >= 2 && x0 + n_valid < mx && !(quad & 1))
          *cs_at<T>(cs, r & 1, row + 1, n_cols - 1) = px[j][0];
      } else {
        const bool below = g >= T::G_TOP + T::G_ROW;
        const int r = s - 4 * (below ? T::G_TOP + T::G_ROW : T::G_TOP);
        const int mrow = below ? i + 1 : i - 1, dx = (r >> 1) - 1;
        if (r >= 2 * (n_valid + 2) || mrow < 0 || mrow >= my ||
            x0 + dx < 0 || x0 + dx >= mx)
          continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ec = 8 * dx + col0 + e + 1;
          if (ec >= 0 && ec < n_cols)
            *cs_at<T>(cs, r & 1, below ? 9 : 0, ec) = px[j][e];
        }
      }
    }
  }
  __syncthreads();

  // edge replication: an extended-plane cell outside the padded chroma
  // plane takes the computed cell at the clamped coordinate
  if constexpr (HS == 2 || VS == 2) {
    const bool top = VS == 2 && i == 0, bot = VS == 2 && i == my - 1;
    const bool left = HS == 2 && x0 == 0, right = HS == 2 && x0 + n_valid == mx;
    const int n_rowc = VS == 2 ? 2 * n_cols : 0;     // rows 0 and 9
    const int n_colc = HS == 2 ? 16 : 0;             // cols 0, n_cols - 1
    const int per_c = n_rowc + n_colc;
    if (top || bot || left || right) {
      for (int t = tid; t < 2 * per_c; t += T::THREADS) {
        const int c = t >= per_c;
        int e = t - c * per_c, er, ec;
        if (e < n_rowc) {
          er = e < n_cols ? 0 : 9;
          ec = e < n_cols ? e : e - n_cols;
        } else {
          e -= n_rowc;
          er = (e & 7) + 1;
          ec = e < 8 ? 0 : n_cols - 1;
        }
        int sr = er, sc = ec;
        if ((er == 0 && top) || (er == 9 && bot)) sr = er == 0 ? 1 : 8;
        if ((ec == 0 && left) || (ec == n_cols - 1 && right))
          sc = ec == 0 ? 1 : n_cols - 2;
        if (sr != er || sc != ec)
          *cs_at<T>(cs, c, er, ec) = *cs_at<T>(cs, c, sr, sc);
      }
      __syncthreads();
    }
  }

  // pixels, a thread per chroma position: its VS x HS pixels' chroma by the
  // triangle (vertically, then horizontally) from the 3 x 3 samples around
  // it, BT.601, round, clamp, into the stage (which takes the place of xs);
  // then out row by row
  const int rh = min(T::MH, h - i * T::MH);
  const int tw = min(n_valid * T::MW, w - x0 * T::MW);
  uint8_t* ob = out + static_cast<size_t>(b) * h * w * 3;
  uint8_t* st = smem + T::XS;
  // a row's first byte modulo 4 (32-bit arithmetic wraps modulo 2^32)
  const unsigned row_base =
      static_cast<unsigned>(reinterpret_cast<uintptr_t>(out)) +
      ((static_cast<unsigned>(b) * h + i * T::MH) * w + x0 * T::MW) * 3u;
  constexpr int CWT = 8 * kTile;                 // chroma columns of a tile
  for (int t = tid; t < 8 * CWT; t += T::THREADS) {
    const int cr = t / CWT, cc = t % CWT;
    if (VS * cr >= rh || HS * cc >= tw) continue;
    // chroma of pixel (VS cr + dy, HS cc + dx): the sample's own row and
    // column and, for a factor of 2, the nearer neighbour (above for the
    // even row, below for the odd one; left for the even column, right for
    // the odd one)
    float ch[2][VS][HS];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float v[VS][3];                            // columns cc, cc + 1, cc + 2
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (HS == 1 && j != 1) continue;
        const float mid = int_small(*cs_at<T>(cs, k, cr + 1, cc + j));
        if constexpr (VS == 2) {
          v[0][j] = tri(mid, int_small(*cs_at<T>(cs, k, cr, cc + j)));
          v[1][j] = tri(mid, int_small(*cs_at<T>(cs, k, cr + 2, cc + j)));
        } else {
          v[0][j] = mid;
        }
      }
#pragma unroll
      for (int dy = 0; dy < VS; ++dy) {
        if constexpr (HS == 2) {
          ch[k][dy][0] = tri(v[dy][1], v[dy][0]);
          ch[k][dy][1] = tri(v[dy][1], v[dy][2]);
        } else {
          ch[k][dy][0] = v[dy][1];
        }
      }
    }
#pragma unroll
    for (int dy = 0; dy < VS; ++dy) {
      const int r = VS * cr + dy;
      if (r >= rh) break;
      uint8_t* o = st + r * T::SP + ((row_base + r * w * 3u) & 3u);
#pragma unroll
      for (int dx = 0; dx < HS; ++dx) {
        const int c = HS * cc + dx;
        if (c >= tw) break;
        const int s = c / T::MW, px_ = c % T::MW;
        const float y = int_small(ys[(s * NB + (r >> 3) * HS + (px_ >> 3)) *
                                         64 + (r & 7) * 8 + (px_ & 7)]);
        const float cb = __fsub_rn(ch[0][dy][dx], 128.f);
        const float cr_ = __fsub_rn(ch[1][dy][dx], 128.f);
        const float rr = __fadd_rn(y, __fmul_rn(1.402f, cr_));
        const float gg = __fsub_rn(__fsub_rn(y, __fmul_rn(0.344136286f, cb)),
                                   __fmul_rn(0.714136286f, cr_));
        const float bl = __fadd_rn(y, __fmul_rn(1.772f, cb));
        o[3 * c] = to_u8(rr);
        o[3 * c + 1] = to_u8(gg);
        o[3 * c + 2] = to_u8(bl);
      }
    }
  }
  __syncthreads();
  for (int r = tid >> 5; r < rh; r += T::THREADS / 32)
    store_row(ob + (static_cast<size_t>(i * T::MH + r) * w + x0 * T::MW) * 3,
              st + r * T::SP, 3 * tw, tid & 31);
}

// The gray tile: kGrayTile blocks of one block row in groups of four, 16
// jobs (position quads) each, one a thread.
struct GrayTile {
  static constexpr int G = kGrayTile / 4;
  static constexpr int THREADS = 16 * G;
  static_assert(kGrayTile * 8 % THREADS == 0, "the loader's trip count");
  static constexpr int SP = kGrayTile * 8 + 4;
  static constexpr int XS = 64 * 64 * 4;
  static constexpr int MB = XS + G * kGroupFloats * 4;
  static constexpr int BYTES = MB + G * 32;
  static_assert(8 * SP <= G * kGroupFloats * 4, "the stage aliases xs");
};

__global__ void __launch_bounds__(GrayTile::THREADS)
recon_gray_kernel(const int16_t* __restrict__ x, const float* __restrict__ q,
                  const float* __restrict__ kidct, uint8_t* __restrict__ out,
                  int my, int mx, int h, int w) {
  using T = GrayTile;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* ks = reinterpret_cast<float*>(smem);
  float* xs = reinterpret_cast<float*>(smem + T::XS);
  uint8_t* mb = smem + T::MB;

  const int tid = threadIdx.x;
  const int b = blockIdx.z, i = blockIdx.y;
  const int x0 = blockIdx.x * kGrayTile;
  const int n_valid = min(kGrayTile, mx - x0);
  const int16_t* xrow =
      x + ((static_cast<size_t>(b) * my + i) * mx + x0) * 64;
  const float* qb = q + static_cast<size_t>(b) * 64;

  constexpr int ITERS = kGrayTile * 8 / T::THREADS;
  int4 raw[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int u = tid + it * T::THREADS, s = u >> 3;
    raw[it] = s < n_valid ? __ldg(reinterpret_cast<const int4*>(xrow + 8 * u))
                          : make_int4(0, 0, 0, 0);
  }
  OperatorLoad<T::THREADS> op;
  op.fetch(kidct, tid);
  op.store(ks, tid);
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int u = tid + it * T::THREADS, c = u & 7, s = u >> 3;
    stage_chunk(raw[it], s < n_valid ? qb : nullptr,
                xs + (s >> 2) * kGroupFloats + (s & 3), mb + s * 8 + c, c);
  }
  __syncthreads();

  const int g = tid >> 4, quad = tid & 15;
  uint8_t px[4][4];
  group_product(ks, xs + g * kGroupFloats, quad, group_mask(mb, g), true, px);
  __syncthreads();                               // the stage replaces xs

  const int rh = min(8, h - i * 8);
  const int tw = min(n_valid * 8, w - x0 * 8);
  uint8_t* ob = out + static_cast<size_t>(b) * h * w;
  uint8_t* st = smem + T::XS;
  const int row = quad >> 1;
  if (row < rh) {
    const uint8_t* row0 = ob + static_cast<size_t>(i * 8 + row) * w + x0 * 8;
    uint8_t* o = st + row * T::SP +
                 static_cast<int>(reinterpret_cast<uintptr_t>(row0) & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (4 * g + j) * 8 + (quad & 1) * 4 + e;
        if (c < tw) o[c] = px[j][e];
      }
  }
  __syncthreads();
  for (int r = tid >> 5; r < rh; r += T::THREADS / 32)
    store_row(ob + static_cast<size_t>(i * 8 + r) * w + x0 * 8,
              st + r * T::SP, tw, tid & 31);
}

template <int HS, int VS>
cudaError_t launch(const void* x, const void* q, const void* kidct, void* out,
                   int B, int my, int mx, int h, int w, cudaStream_t stream) {
  using T = Tile<HS, VS>;
  const cudaError_t err = cudaFuncSetAttribute(
      recon_kernel<HS, VS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((mx + kTile - 1) / kTile, my, B);
  recon_kernel<HS, VS><<<grid, T::THREADS, T::BYTES, stream>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(q),
      static_cast<const float*>(kidct), static_cast<uint8_t*>(out), my, mx, h,
      w);
  return cudaGetLastError();
}

bool bad_operands(const void* x, const void* q, const void* kidct, int B,
                  int my, int mx, int h, int w, int mh, int mw) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(kidct);
  return a % 16 != 0 || B < 1 || B > 65535 || my < 1 || my > 65535 ||
         mx < 1 || h < 1 || w < 1 || h > my * mh || w > mx * mw;
}

}  // namespace

// x [B, my, mx, (nb+2)*64] i16 (MCU-major, zigzag); q [B, (nb+2)*64] f32
// (zigzag order: luma tiled nb times, Cb, Cr); kidct [64, 64] f32; out
// [B, h, w, 3] u8. x, q and kidct 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int recon_launch(const void* x, const void* q, const void* kidct,
                            void* out, int B, int my, int mx, int h, int w,
                            int hs, int vs, void* stream) {
  if (bad_operands(x, q, kidct, B, my, mx, h, w, 8 * vs, 8 * hs))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hs == 2 && vs == 2)
    err = launch<2, 2>(x, q, kidct, out, B, my, mx, h, w, st);
  else if (hs == 2 && vs == 1)
    err = launch<2, 1>(x, q, kidct, out, B, my, mx, h, w, st);
  else if (hs == 1 && vs == 1)
    err = launch<1, 1>(x, q, kidct, out, B, my, mx, h, w, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// x [B, my, mx, 64] i16; q [B, 64] f32 (zigzag order); kidct [64, 64] f32;
// out [B, h, w] u8. x, q and kidct 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int recon_gray_launch(const void* x, const void* q,
                                 const void* kidct, void* out, int B, int my,
                                 int mx, int h, int w, void* stream) {
  if (bad_operands(x, q, kidct, B, my, mx, h, w, 8, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      recon_gray_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GrayTile::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((mx + kGrayTile - 1) / kGrayTile, my, B);
  recon_gray_kernel<<<grid, GrayTile::THREADS, GrayTile::BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(q),
      static_cast<const float*>(kidct), static_cast<uint8_t*>(out), my, mx, h,
      w);
  return static_cast<int>(cudaGetLastError());
}
