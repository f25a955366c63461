// K1A: raw RGB pixels -> quantized zigzag -> DC DPCM -> Huffman -> per-block
// packed words, in one kernel.
//
// Replaces jpgenc_tpu/ops/pallas/k1a_fused.py::_k1a_kernel (with
// _pair_entropy and block_pack._ac_analysis/_dc_piece/_pack_slots). The
// Python wrapper and the plain version are in ops/cuda/k1a_fused.py.
//
// Work layout. One thread block takes kTile consecutive MCUs (raster order)
// of one image and has one thread per output coefficient, (nb+2)*64 of them.
//  1-2. The transform is common.cuh's tile_transform, shared with the K1
//     kernel (k1_dct.cu) so both hold the same coefficients bit for bit.
//  3. DC DPCM. Blocks run in no order, so the TPU kernel's carry across rows
//     (k1a_fused.py:93-124) cannot be used. Instead the MCU before the tile
//     is recomputed as slot 0 of the same transform: its coefficients equal
//     the neighbour block's own bit for bit. The predictor resets at every
//     segment start, g % mps == 0 with mps = restart_interval or n_mcus
//     (k1a_fused.py:110-114); a tile boundary inside a segment still needs
//     the recomputed slot. Each image owns n_slots >= n_mcus * (nb+2) output
//     slots (whole segments); the wrapper zeroes the pad slots.
//  4. Entropy: one warp per 8x8 block (common.cuh's code_block, shared with
//     kernel A in block_pack.cu).
//
// What bounds it on the H100: the dense operator spends 384*768 FMAs per
// 4:2:0 MCU (most of them on zeros of the luma blocks) on the CUDA cores,
// and every tile streams the 1.2 MB operator from L2. kTile MCUs share each
// operator load; no tensor cores, TMA or wgmma yet (later work).
#include "common.cuh"

namespace {

using namespace jpgenc;

constexpr int kTile = 8;           // MCUs per thread block

template <int HS, int VS>
__global__ void __launch_bounds__((HS * VS + 2) * 64)
k1a_kernel(const uint8_t* __restrict__ img, int H, int W, int mx, int n_mcus,
           int mps, int n_slots, const float* __restrict__ m, const float* __restrict__ bias,
           const float* __restrict__ q, const int* __restrict__ ac_rows,
           const int* __restrict__ dc_rows, const int* __restrict__ misc,
           int w_blk, uint32_t* __restrict__ buf, int* __restrict__ bits,
           int16_t* __restrict__ zz_out) {
  constexpr int NB = HS * VS;
  constexpr int NB2 = NB + 2;
  constexpr int L = NB2 * 64;                    // outputs per MCU = threads
  constexpr int K = 8 * VS * 3 * 8 * HS;         // input bytes per MCU
  constexpr int NWARPS = L / 32;
  constexpr int SLOTS = kTile + 1;               // slot 0: the MCU before

  __shared__ __align__(16) float xs[SLOTS * K];
  __shared__ uint32_t ws[NWARPS][kWordScratch];
  __shared__ Tables tabs;

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int g0 = blockIdx.x * kTile;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W * 3;

  load_tables(tabs, ac_rows, dc_rows, misc, tid, L);
  const int* zq = tile_transform<HS, VS, SLOTS>(im, H, W, mx, n_mcus, g0 - 1,
                                                m, bias, q, xs, tid);
  if (zz_out != nullptr) {
    for (int s = 1; s < SLOTS && g0 + s - 1 < n_mcus; ++s)
      zz_out[(static_cast<size_t>(n) * n_mcus + g0 + s - 1) * L + tid] =
          static_cast<int16_t>(zq[s * L + tid]);
  }

  const int warp = tid >> 5, lane = tid & 31;
  for (int job = warp; job < kTile * NB2; job += NWARPS) {
    const int s = 1 + job / NB2;
    const int blk = job - (s - 1) * NB2;
    const int g = g0 + s - 1;
    if (g >= n_mcus) break;                      // warp-uniform, g rises
    const int* z = zq + s * L;
    const int* zprev = zq + (s - 1) * L;
    const bool reset = g % mps == 0;             // segment start
    int pred;
    if (blk == 0) pred = reset ? 0 : zprev[(NB - 1) * 64];
    else if (blk < NB) pred = z[(blk - 1) * 64];
    else pred = reset ? 0 : zprev[blk * 64];
    const size_t slot = static_cast<size_t>(n) * n_slots + g * NB2 + blk;
    const int tab = blk < NB ? 0 : 1;
    code_block(z[blk * 64 + lane], z[blk * 64 + lane + 32],
               z[blk * 64] - pred, tab, tab, tabs, ws[warp], w_blk,
               buf + slot * w_blk, bits + slot, lane);
  }
}

template <int HS, int VS>
cudaError_t launch(const void* img, int B, int H, int W, int mps,
                   int n_slots, const void* m,
                   const void* bias, const void* q, const void* ac_rows,
                   const void* dc_rows, const void* misc, int w_blk,
                   void* buf, void* bits, void* zz_out, cudaStream_t stream) {
  const int my = (H + 8 * VS - 1) / (8 * VS);
  const int mx = (W + 8 * HS - 1) / (8 * HS);
  const int n_mcus = my * mx;
  if (mps < 1 || n_slots < n_mcus * (HS * VS + 2)) return cudaErrorInvalidValue;
  const dim3 grid((n_mcus + kTile - 1) / kTile, B);
  k1a_kernel<HS, VS><<<grid, (HS * VS + 2) * 64, 0, stream>>>(
      static_cast<const uint8_t*>(img), H, W, mx, n_mcus, mps, n_slots,
      static_cast<const float*>(m), static_cast<const float*>(bias),
      static_cast<const float*>(q), static_cast<const int*>(ac_rows),
      static_cast<const int*>(dc_rows), static_cast<const int*>(misc), w_blk,
      static_cast<uint32_t*>(buf), static_cast<int*>(bits),
      static_cast<int16_t*>(zz_out));
  return cudaGetLastError();
}

}  // namespace

// img [B,H,W,3] u8; m [3*64*nb, (nb+2)*64] f32 (natural basis); bias, q
// [(nb+2)*64] f32; ac_rows [4,128], dc_rows [2,128], misc [4] i32;
// mps MCUs per restart segment; buf [B, n_slots, w_blk] u32 and bits
// [B, n_slots] i32 with n_slots >= n_mcu*(nb+2) (the slots past it are not
// written); zz_out [B, n_mcu, (nb+2)*64] i16 or null. Returns
// cudaGetLastError().
extern "C" int k1a_fused_launch(const void* img, int B, int H, int W, int hs,
                                int vs, int mps, int n_slots, const void* m, const void* bias,
                                const void* q, const void* ac_rows,
                                const void* dc_rows, const void* misc,
                                int w_blk, void* buf, void* bits,
                                void* zz_out, void* stream) {
  if (B < 1 || H < 1 || W < 1 || w_blk < 1 || w_blk > kWordScratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hs == 2 && vs == 2)
    err = launch<2, 2>(img, B, H, W, mps, n_slots, m, bias, q, ac_rows, dc_rows, misc, w_blk, buf, bits, zz_out, st);
  else if (hs == 2 && vs == 1)
    err = launch<2, 1>(img, B, H, W, mps, n_slots, m, bias, q, ac_rows, dc_rows, misc, w_blk, buf, bits, zz_out, st);
  else if (hs == 1 && vs == 1)
    err = launch<1, 1>(img, B, H, W, mps, n_slots, m, bias, q, ac_rows, dc_rows, misc, w_blk, buf, bits, zz_out, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
