// Gray K1A: gray pixels -> quantized zigzag -> DC DPCM -> Huffman -> per-block
// packed words, in one kernel (one 8x8 block per MCU, luma tables only).
//
// Replaces jpgenc_tpu/ops/pallas/k1a_fused.py::_k1a_gray_kernel. The Python
// wrapper and the plain version are in ops/cuda/k1a_fused.py.
//
// Work layout. One thread block of kGrayThreads = 256 threads takes a tile of
// kGrayTile consecutive 8x8 blocks inside one block row of one image: grid
// (tiles per row, block rows, images), so each of the tile's 8 pixel rows is
// one contiguous run of bytes.
//  1. The transform is common.cuh's gray loader and gray_tile_product,
//     shared with the gray K1 kernel (k1_dct.cu): the capacity ladder can
//     switch between the fused and the split path, so both must hold the same
//     coefficients (k1a_fused.py:368-373).
//  2. DC DPCM against the previous block in raster order, reset at every
//     segment start (g % mps == 0, mps = restart_interval or n_blocks). The
//     TPU kernel carries the DC across MCU rows in VMEM over a sequential
//     grid (k1a_fused.py:386-397); CUDA blocks run in no order, so the block
//     before the tile (the last block of the row above for a tile that starts
//     a row) is loaded beside the tile and one thread runs the products'
//     chain for coefficient 0 only (dc_of_block, 64 FMAs): its DC equals its
//     owner's bit for bit. A tile that starts a segment loads no
//     predecessor. Each image owns n_slots >= n_blocks output slots (whole
//     segments); the wrapper zeroes the pad slots.
//  3. Entropy: one warp per 8x8 block with table 0 (common.cuh's code_block).
//
// What bounds it on the H100: instruction throughput, in two halves. 16 x
// 1080p gray Q75 at w_blk 8 take 0.339-0.3408 ms (NVIDIA H100 80GB HBM3 at
// 700 W, kernels/gray_sweep.py) where gray K1, the same transform with a
// plain store, takes 0.153-0.1543: the other half is the entropy coder
// (code_block: ballots, a shuffle scan and shared-memory atomics per block,
// then w_blk words per block to device memory), unchanged. The bytes bound
// is 0.0155 ms; PERF.md section 6 holds the numbers. The tile: of 64, 96,
// 128 and 160 blocks 128 was the fastest at 16 x 1080p (240 blocks a row:
// 128 + 112; by 7-15 % here, 19-43 % in gray K1) and at 2 x 2048 x 16384
// (2048 blocks a row; by 2-20 %); 160 pads a 1080p row to 320 slots and
// spills 8 bytes in gray K1 at the 80 registers that three thread blocks an
// SM leave.
#include "common.cuh"

namespace {

using namespace jpgenc;

constexpr int kWarps = kGrayThreads / 32;

struct Smem {                                    // offsets in 4-byte words
  static constexpr int XS = 64 * 64;             // after ks
  static constexpr int PRED = XS + kGrayTile * kGrayStride;
  static constexpr int WS = PRED + 64;
  static constexpr int TABS = WS + kWarps * kWordScratch;
  static constexpr int DC = TABS + sizeof(Tables) / 4;
  static constexpr size_t BYTES = 4 * (DC + 4);
};

__global__ void __launch_bounds__(kGrayThreads, 3)
k1a_gray_kernel(const uint8_t* __restrict__ img, int H, int W, int vec,
                int mx, int n_mcus, int mps, int n_slots,
                const float* __restrict__ kdct, const float* __restrict__ q,
                const int* __restrict__ ac_rows,
                const int* __restrict__ dc_rows, const int* __restrict__ misc,
                int w_blk, uint32_t* __restrict__ buf, int* __restrict__ bits,
                int16_t* __restrict__ zz_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;
  float* xs = smem + Smem::XS;
  float* xpred = smem + Smem::PRED;              // the block before the tile
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + Smem::WS);
  Tables& tabs = *reinterpret_cast<Tables*>(smem + Smem::TABS);
  int* pred_dc = reinterpret_cast<int*>(smem + Smem::DC);

  const int tid = threadIdx.x;
  const int mx0 = blockIdx.x * kGrayTile, by = blockIdx.y, n = blockIdx.z;
  const int g0 = by * mx + mx0;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W;
  const bool need_pred = g0 % mps != 0;          // not a segment start

  load_tables(tabs, ac_rows, dc_rows, misc, tid, kGrayThreads);
  load_operator(kdct, ks, tid, kGrayThreads);
  load_gray_tile(im, H, W, vec, mx, by, mx0, xs, tid);
  if (need_pred)                                 // by the last threads
    load_gray_block(im, H, W, (g0 - 1) % mx, (g0 - 1) / mx, xpred,
                    kGrayThreads - 1 - tid);
  __syncthreads();
  if (need_pred && tid == 0) *pred_dc = dc_of_block(xpred, ks, q[0]);
  // synchronises before it returns, so pred_dc is seen below
  const int16_t* zq = gray_tile_product(xs, ks, q, tid);

  const int n_valid = min(kGrayTile, mx - mx0);
  if (zz_out != nullptr)
    copy_zz(zq, n_valid * 64,
            zz_out + (static_cast<size_t>(n) * n_mcus + g0) * 64, tid,
            kGrayThreads);

  const int warp = tid >> 5, lane = tid & 31;
  for (int job = warp; job < n_valid; job += kWarps) {
    const int g = g0 + job;
    const int16_t* z = zq + job * 64;
    const int pred = g % mps == 0 ? 0 : job ? z[-64] : *pred_dc;
    const size_t slot = static_cast<size_t>(n) * n_slots + g;
    code_block(z[lane], z[lane + 32], z[0] - pred, 0, 0, tabs,
               ws + warp * kWordScratch, w_blk, buf + slot * w_blk,
               bits + slot, lane);
  }
}

}  // namespace

// img [B,H,W] u8; kdct [64,64] f32 (pixel -> zigzag coefficient) and q [64]
// f32 (zigzag order), both 16-byte aligned; ac_rows [4,128], dc_rows
// [2,128], misc [4] i32; mps blocks per restart segment; buf [B, n_slots,
// w_blk] u32 and bits [B, n_slots] i32 with n_slots >= n_blocks (the slots
// past it are not written); zz_out [B, n_blocks, 64] i16 (16-byte aligned) or
// null. Returns cudaGetLastError().
extern "C" int k1a_gray_launch(const void* img, int B, int H, int W, int mps,
                               int n_slots, const void* kdct, const void* q,
                               const void* ac_rows, const void* dc_rows,
                               const void* misc, int w_blk, void* buf,
                               void* bits, void* zz_out, void* stream) {
  if (B < 1 || H < 1 || W < 1 || w_blk < 1 || w_blk > kWordScratch ||
      !aligned16(kdct) || !aligned16(q) || !aligned16(zz_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mx = (W + 7) / 8, my = (H + 7) / 8;
  const int n_mcus = my * mx;
  if (mps < 1 || n_slots < n_mcus || my > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      k1a_gray_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((mx + kGrayTile - 1) / kGrayTile, my, B);
  k1a_gray_kernel<<<grid, kGrayThreads, Smem::BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, load_alignment(img, W), mx,
      n_mcus, mps, n_slots, static_cast<const float*>(kdct),
      static_cast<const float*>(q), static_cast<const int*>(ac_rows),
      static_cast<const int*>(dc_rows), static_cast<const int*>(misc), w_blk,
      static_cast<uint32_t*>(buf), static_cast<int*>(bits),
      static_cast<int16_t*>(zz_out));
  return static_cast<int>(cudaGetLastError());
}
