// K1: pixels -> quantized zigzag coefficients (int16) in scan order, the
// first pass of the split encode path (two-pass optimized Huffman).
//
// Four kernels, one per Pallas kernel of jpgenc_tpu/ops/pallas/k1_dct.py. The
// Python wrapper and the plain versions are in ops/cuda/k1_dct.py.
//
//  * k1_kernel replaces ::_dense_dma_kernel: the dense operator over MCUs read
//    from the image in its natural layout, tiles of kTile MCUs of one image.
//  * k1_repack_kernel replaces ::_dense_kernel: the same operator over the
//    MCU-contiguous repack (mcu_pack_words; here k1_dct.mcu_bytes, whose bytes
//    in memory order are the operator's 'natural' basis), in flat tiles of
//    kTile MCUs that ignore image rows and images. The reference takes it for
//    frames whose MCU row is past its row kernel's VMEM budget; on this card
//    nothing forces the choice. Each MCU is 3*mh*mw contiguous bytes, loaded
//    as 16-byte vectors.
//  * k1_color_kernel replaces ::_color_kernel: the separable formulation.
//    BT.601 per pixel (level shift folded in), then per luma block one 64x64
//    product with KDCT_ZZ (the block-diagonal bd_y without its zeros) and per
//    chroma plane one [nb*64] x [nb*64, 64] product with sc = S_sub @ KDCT_ZZ
//    (box-mean subsampling folded in): (nb*64 + 2*nb*64) * 64 FMAs per MCU,
//    49 152 in 4:2:0 against the dense operator's 294 912.
//  * k1_gray_kernel replaces ::_gray_kernel.
//
// The dense kernels are the transform halves of the fused kernels
// (k1a_fused.cu, k1a_gray.cu) with an int16 store: the arithmetic is
// common.cuh's tile_arithmetic / gray_tile_transform, the same function the
// fused kernels call, because an image can be coded by either path and both
// must hold the same coefficients bit for bit (k1a_fused.py:29, :368-373).
// The two dense kernels differ in their loader only. The separable kernel
// rounds differently (its sums associate differently), so it agrees with the
// dense ones except at knife edges (k1_dct.py:18-24); one process uses one
// formulation for all its files (the module switch K1_DENSE). K1 has no DPCM,
// so no predecessor is recomputed: every slot of a tile is stored.
//
// [n_mcu, (nb+2)*64] IS the interleaved scan order (T.81 A.2.3), so the
// output needs no gather; thread tid stores coefficient tid of each MCU, a
// coalesced 2-byte store. Each image owns n_slots >= n_mcu * (nb+2) output
// blocks (whole restart segments); the wrapper zeroes the pad blocks.
//
// What bounds them on the H100: the dense kernels, as K1A, the operator's
// 384*768 FMAs per 4:2:0 MCU on the CUDA cores; the separable kernel, its
// chroma threads (nb*64 FMAs each against 64 for a luma thread, two shared
// loads or one L1 load per FMA) and the 3-byte pixel reads; gray, device
// memory (1 byte in, 2 bytes out per pixel).
#include "common.cuh"

namespace {

using namespace jpgenc;

constexpr int kTile = 8;           // MCUs per thread block (colour)
constexpr int kGrayTile = 32;      // 8x8 blocks per thread block (gray)

template <int HS, int VS>
__global__ void __launch_bounds__((HS * VS + 2) * 64)
k1_kernel(const uint8_t* __restrict__ img, int H, int W, int mx, int n_mcus,
          int n_slots, const float* __restrict__ m,
          const float* __restrict__ bias, const float* __restrict__ q,
          int16_t* __restrict__ zz_out) {
  constexpr int L = (HS * VS + 2) * 64;
  constexpr int K = 8 * VS * 3 * 8 * HS;
  __shared__ __align__(16) float xs[kTile * K];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int g0 = blockIdx.x * kTile;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W * 3;
  const int* zq = tile_transform<HS, VS, kTile>(im, H, W, mx, n_mcus, g0, m,
                                                bias, q, xs, tid);
  int16_t* out = zz_out + static_cast<size_t>(n) * n_slots * 64;
  for (int s = 0; s < kTile && g0 + s < n_mcus; ++s)
    out[static_cast<size_t>(g0 + s) * L + tid] =
        static_cast<int16_t>(zq[s * L + tid]);
}

template <int HS, int VS>
__global__ void __launch_bounds__((HS * VS + 2) * 64)
k1_repack_kernel(const uint8_t* __restrict__ mcus, long long total,
                 int n_mcus, int n_slots, const float* __restrict__ m,
                 const float* __restrict__ bias, const float* __restrict__ q,
                 int16_t* __restrict__ zz_out) {
  constexpr int L = (HS * VS + 2) * 64;
  constexpr int K = 8 * VS * 3 * 8 * HS;
  __shared__ __align__(16) float xs[kTile * K];

  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = total - t0;
  const int n_valid = left < kTile ? static_cast<int>(left) : kTile;
  load_tile_packed<K, kTile>(mcus + t0 * K, n_valid, xs, tid, L);
  const int* zq = tile_arithmetic<HS, VS, kTile>(m, bias, q, xs, tid);
  for (int s = 0; s < n_valid; ++s) {
    const long long t = t0 + s;
    const long long n = t / n_mcus, g = t - n * n_mcus;
    zz_out[(n * n_slots) * 64 + g * L + tid] =
        static_cast<int16_t>(zq[s * L + tid]);
  }
}

// sep [(1 + NB) * 64, 64] f32: rows 0..63 KDCT_ZZ (pixel -> zigzag
// coefficient), rows 64.. the chroma operator sc.
template <int HS, int VS>
__global__ void __launch_bounds__((HS * VS + 2) * 64)
k1_color_kernel(const uint8_t* __restrict__ img, int H, int W, int mx,
                int n_mcus, int n_slots, const float* __restrict__ sep,
                const float* __restrict__ q, int16_t* __restrict__ zz_out) {
  constexpr int NB = HS * VS;
  constexpr int L = (NB + 2) * 64;
  constexpr int P = NB * 64;                     // pixels per MCU
  constexpr int MH = 8 * VS, MW = 8 * HS;
  // planes y, cb, cr of every slot in Y-block order (block, row, column):
  // the layout of the reference's mcu_pack, which sc's rows assume
  __shared__ float ycc[kTile][3][P];
  __shared__ float ks[64 * 64];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int g0 = blockIdx.x * kTile;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W * 3;

  for (int i = tid; i < 64 * 64; i += L) ks[i] = sep[i];
  for (int i = tid; i < kTile * P; i += L) {
    const int s = i / P, e = i - s * P;
    const int g = g0 + s;
    float yv = 0.f, cb = 0.f, cr = 0.f;
    if (g < n_mcus) {
      const int my_i = g / mx, mx_i = g - my_i * mx;
      const int blk = e >> 6, py = (e >> 3) & 7, px = e & 7;
      const int y = min(my_i * MH + (blk / HS) * 8 + py, H - 1);
      const int x = min(mx_i * MW + (blk % HS) * 8 + px, W - 1);
      const uint8_t* p = im + (static_cast<size_t>(y) * W + x) * 3;
      const float r = static_cast<float>(p[0]);
      const float gg = static_cast<float>(p[1]);
      const float b = static_cast<float>(p[2]);
      // BT.601 full range with the level shift folded in (k1_dct.py:212-214),
      // every product and sum rounded on its own, left to right
      yv = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(0.299f, r),
                                         __fmul_rn(0.587f, gg)),
                               __fmul_rn(0.114f, b)), 128.0f);
      cb = __fadd_rn(__fadd_rn(__fmul_rn(-0.168735892f, r),
                               __fmul_rn(-0.331264108f, gg)),
                     __fmul_rn(0.5f, b));
      cr = __fadd_rn(__fadd_rn(__fmul_rn(0.5f, r),
                               __fmul_rn(-0.418687589f, gg)),
                     __fmul_rn(-0.081312411f, b));
    }
    ycc[s][0][e] = yv;
    ycc[s][1][e] = cb;
    ycc[s][2][e] = cr;
  }
  __syncthreads();

  const int blk = tid >> 6, c = tid & 63;        // warp-uniform blk
  float acc[kTile];
#pragma unroll
  for (int s = 0; s < kTile; ++s) acc[s] = 0.f;
  if (blk < NB) {                                // luma: this block's 64 terms
    for (int k = 0; k < 64; ++k) {
      const float w = ks[k * 64 + c];
#pragma unroll
      for (int s = 0; s < kTile; ++s)
        acc[s] = __fmaf_rn(ycc[s][0][blk * 64 + k], w, acc[s]);
    }
  } else {                                       // chroma: all P pixels
    const int plane = 1 + blk - NB;
    const float* sc = sep + 64 * 64;
    for (int k = 0; k < P; ++k) {
      const float w = __ldg(sc + k * 64 + c);
#pragma unroll
      for (int s = 0; s < kTile; ++s)
        acc[s] = __fmaf_rn(ycc[s][plane][k], w, acc[s]);
    }
  }
  const float qc = q[tid];
  int16_t* out = zz_out + static_cast<size_t>(n) * n_slots * 64;
  for (int s = 0; s < kTile && g0 + s < n_mcus; ++s)
    out[static_cast<size_t>(g0 + s) * L + tid] =
        static_cast<int16_t>(round_div(acc[s], qc));
}

__global__ void __launch_bounds__(kGrayThreads)
k1_gray_kernel(const uint8_t* __restrict__ img, int H, int W, int mx,
               int n_mcus, int n_slots, const float* __restrict__ kdct,
               const float* __restrict__ q, int16_t* __restrict__ zz_out) {
  __shared__ __align__(16) float xs[kGrayTile * 64];
  __shared__ __align__(16) float ks[64 * 64];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int g0 = blockIdx.x * kGrayTile;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W;
  const int* zq = gray_tile_transform<kGrayTile>(im, H, W, mx, n_mcus, g0,
                                                 kdct, q, xs, ks, tid);
  for (int i = tid; i < kGrayTile * 64; i += kGrayThreads) {
    const int g = g0 + (i >> 6);
    if (g < n_mcus)
      zz_out[(static_cast<size_t>(n) * n_slots + g) * 64 + (i & 63)] =
          static_cast<int16_t>(zq[i]);
  }
}

enum Variant { kRows = 0, kRepack = 1, kSeparable = 2 };

// src is the image [B,H,W,3] (rows, separable) or the repack [B*n_mcu, K]
// (repack); op is the dense operator m (rows, repack) or sep (separable).
template <int HS, int VS>
cudaError_t launch(int variant, const void* src, int B, int H, int W,
                   int n_slots, const void* op, const void* bias,
                   const void* q, void* zz_out, cudaStream_t stream) {
  constexpr int L = (HS * VS + 2) * 64;
  const int my = (H + 8 * VS - 1) / (8 * VS);
  const int mx = (W + 8 * HS - 1) / (8 * HS);
  const int n_mcus = my * mx;
  if (n_slots < n_mcus * (HS * VS + 2)) return cudaErrorInvalidValue;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const float* o = static_cast<const float*>(op);
  const float* qf = static_cast<const float*>(q);
  int16_t* out = static_cast<int16_t*>(zz_out);
  const dim3 grid((n_mcus + kTile - 1) / kTile, B);
  if (variant == kRows) {
    k1_kernel<HS, VS><<<grid, L, 0, stream>>>(
        s, H, W, mx, n_mcus, n_slots, o, static_cast<const float*>(bias), qf,
        out);
  } else if (variant == kRepack) {
    const long long total = static_cast<long long>(B) * n_mcus;
    const long long blocks = (total + kTile - 1) / kTile;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    k1_repack_kernel<HS, VS><<<static_cast<unsigned>(blocks), L, 0, stream>>>(
        s, total, n_mcus, n_slots, o, static_cast<const float*>(bias), qf,
        out);
  } else if (variant == kSeparable) {
    k1_color_kernel<HS, VS><<<grid, L, 0, stream>>>(s, H, W, mx, n_mcus,
                                                    n_slots, o, qf, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// variant 0 (rows): src = img [B,H,W,3] u8, op = m [3*64*nb, (nb+2)*64] f32
// (natural basis), bias [(nb+2)*64] f32. variant 1 (repack): src = the MCU
// repack [B, n_mcu, 3*64*nb] u8 (16-byte aligned), op and bias as rows.
// variant 2 (separable): src = img, op = sep [(1+nb)*64, 64] f32, bias
// unused. q [(nb+2)*64] f32; zz_out [B, n_slots, 64] i16 with n_slots >=
// n_mcu*(nb+2) (the blocks past it are not written). Returns
// cudaGetLastError().
extern "C" int k1_dct_launch(int variant, const void* src, int B, int H,
                             int W, int hs, int vs, int n_slots,
                             const void* op, const void* bias, const void* q,
                             void* zz_out, void* stream) {
  if (B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hs == 2 && vs == 2)
    err = launch<2, 2>(variant, src, B, H, W, n_slots, op, bias, q, zz_out, st);
  else if (hs == 2 && vs == 1)
    err = launch<2, 1>(variant, src, B, H, W, n_slots, op, bias, q, zz_out, st);
  else if (hs == 1 && vs == 1)
    err = launch<1, 1>(variant, src, B, H, W, n_slots, op, bias, q, zz_out, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// img [B,H,W] u8; kdct [64,64] f32; q [64] f32 (zigzag order); zz_out
// [B, n_slots, 64] i16 with n_slots >= n_blocks. Returns cudaGetLastError().
extern "C" int k1_gray_launch(const void* img, int B, int H, int W,
                              int n_slots, const void* kdct, const void* q,
                              void* zz_out, void* stream) {
  if (B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int mx = (W + 7) / 8;
  const int n_mcus = ((H + 7) / 8) * mx;
  if (n_slots < n_mcus) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_mcus + kGrayTile - 1) / kGrayTile, B);
  k1_gray_kernel<<<grid, kGrayThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, mx, n_mcus, n_slots,
      static_cast<const float*>(kdct), static_cast<const float*>(q),
      static_cast<int16_t*>(zz_out));
  return static_cast<int>(cudaGetLastError());
}
