// Gray K1A: gray pixels -> quantized zigzag -> DC DPCM -> Huffman -> per-block
// packed words, in one kernel (one 8x8 block per MCU, luma tables only).
//
// Replaces jpgenc_tpu/ops/pallas/k1a_fused.py::_k1a_gray_kernel. The Python
// wrapper and the plain version are in ops/cuda/k1a_fused.py.
//
// Work layout. One thread block of 256 threads takes kTile consecutive 8x8
// blocks (raster order) of one image.
//  1. The transform is common.cuh's gray_tile_transform, shared with the gray
//     K1 kernel (k1_dct.cu): the capacity ladder can switch between the fused
//     and the split path, so both must hold the same coefficients
//     (k1a_fused.py:368-373).
//  2. DC DPCM against the previous block in raster order, reset at every
//     segment start (g % mps == 0, mps = restart_interval or n_blocks). Each
//     image owns n_slots >= n_blocks output slots (whole segments); the
//     wrapper zeroes the pad slots. The TPU kernel carries the DC across MCU rows in VMEM over a
//     sequential grid (k1a_fused.py:386-397); CUDA blocks run in no order, so
//     the block before the tile is recomputed as slot 0 of the same
//     transform: 1/kTile more transform work, and its DC equals its owner's
//     bit for bit.
//  3. Entropy: one warp per 8x8 block with table 0 (common.cuh's code_block).
//
// What bounds it on the H100: device memory (1 byte in, about half a byte
// out per pixel at w_blk 8) if the 64 FMAs per coefficient on the CUDA cores
// keep up; the 16 KB operator sits in shared memory.
#include "common.cuh"

namespace {

using namespace jpgenc;

constexpr int kTile = 32;          // 8x8 blocks per thread block
constexpr int kWarps = kGrayThreads / 32;

__global__ void __launch_bounds__(kGrayThreads)
k1a_gray_kernel(const uint8_t* __restrict__ img, int H, int W, int mx,
                int n_mcus, int mps, int n_slots,
                const float* __restrict__ kdct, const float* __restrict__ q,
                const int* __restrict__ ac_rows,
                const int* __restrict__ dc_rows, const int* __restrict__ misc,
                int w_blk, uint32_t* __restrict__ buf, int* __restrict__ bits,
                int16_t* __restrict__ zz_out) {
  constexpr int SLOTS = kTile + 1;               // slot 0: the block before
  __shared__ __align__(16) float xs[SLOTS * 64];
  __shared__ __align__(16) float ks[64 * 64];
  __shared__ uint32_t ws[kWarps][kWordScratch];
  __shared__ Tables tabs;

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int g0 = blockIdx.x * kTile;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W;

  load_tables(tabs, ac_rows, dc_rows, misc, tid, kGrayThreads);
  const int* zq = gray_tile_transform<SLOTS>(im, H, W, mx, n_mcus, g0 - 1,
                                             kdct, q, xs, ks, tid);
  if (zz_out != nullptr) {
    for (int i = tid; i < kTile * 64; i += kGrayThreads) {
      const int g = g0 + (i >> 6);
      if (g < n_mcus)
        zz_out[(static_cast<size_t>(n) * n_mcus + g) * 64 + (i & 63)] =
            static_cast<int16_t>(zq[64 + i]);
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  for (int job = warp; job < kTile; job += kWarps) {
    const int g = g0 + job;
    if (g >= n_mcus) break;                      // warp-uniform, g rises
    const int* z = zq + (job + 1) * 64;
    const int pred = g % mps == 0 ? 0 : z[-64];
    const size_t slot = static_cast<size_t>(n) * n_slots + g;
    code_block(z[lane], z[lane + 32], z[0] - pred, 0, 0, tabs, ws[warp],
               w_blk, buf + slot * w_blk, bits + slot, lane);
  }
}

}  // namespace

// img [B,H,W] u8; kdct [64,64] f32 (pixel -> zigzag coefficient); q [64] f32
// (zigzag order); ac_rows [4,128], dc_rows [2,128], misc [4] i32;
// mps blocks per restart segment; buf [B, n_slots, w_blk] u32 and bits
// [B, n_slots] i32 with n_slots >= n_blocks (the slots past it are not
// written); zz_out [B, n_blocks, 64] i16 or null. Returns cudaGetLastError().
extern "C" int k1a_gray_launch(const void* img, int B, int H, int W, int mps,
                               int n_slots, const void* kdct, const void* q,
                               const void* ac_rows, const void* dc_rows,
                               const void* misc, int w_blk, void* buf,
                               void* bits, void* zz_out, void* stream) {
  if (B < 1 || H < 1 || W < 1 || w_blk < 1 || w_blk > kWordScratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mx = (W + 7) / 8;
  const int n_mcus = ((H + 7) / 8) * mx;
  if (mps < 1 || n_slots < n_mcus) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_mcus + kTile - 1) / kTile, B);
  k1a_gray_kernel<<<grid, kGrayThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, mx, n_mcus, mps, n_slots,
      static_cast<const float*>(kdct), static_cast<const float*>(q),
      static_cast<const int*>(ac_rows), static_cast<const int*>(dc_rows),
      static_cast<const int*>(misc), w_blk, static_cast<uint32_t*>(buf),
      static_cast<int*>(bits), static_cast<int16_t*>(zz_out));
  return static_cast<int>(cudaGetLastError());
}
