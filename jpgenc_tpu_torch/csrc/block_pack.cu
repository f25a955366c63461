// Kernel A: scan-ordered quantized zigzag blocks -> per-block Huffman-packed
// words, the entropy pass of the split encode path.
//
// Replaces jpgenc_tpu/ops/pallas/block_pack.py::_kernel (with _ac_analysis,
// _dc_piece and _pack_slots). The Python wrapper, the slot_metadata prologue
// and the plain version are in ops/cuda/block_pack.py.
//
// One warp codes one 8x8 block with common.cuh's code_block, the entropy half
// of the K1A kernel, so kernel A on K1's coefficients equals K1A bit for bit.
// A thread block of 8 warps takes kSlots consecutive slots of ONE image, so
// the image's own Huffman tables (optimized per image; the reference vmaps
// the kernel over a batch of LUTs, parallel/mesh.py:293-296) are loaded into
// shared memory once per thread block: grid = (slot tiles, images), tables
// indexed by blockIdx.y. The per-slot DC difference, table ids and the valid
// flag come from the torch prologue. A slot with valid == 0 (segment padding)
// writes zero words and zero bits. A block over 32*w_blk bits keeps its first
// w_blk words and its true bit count (block_pack.py:218-229).
//
// What bounds it on the H100: device memory: 128 bytes of int16 in and
// 4*w_blk + 4 bytes out per block.
#include "common.cuh"

namespace {

using namespace jpgenc;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 64;         // slots per thread block

__global__ void __launch_bounds__(kThreads)
block_pack_kernel(const int16_t* __restrict__ zz,
                  const int* __restrict__ dcdiff,
                  const int* __restrict__ actab, const int* __restrict__ dctab,
                  const int* __restrict__ valid, int n_slots,
                  const int* __restrict__ ac_rows,
                  const int* __restrict__ dc_rows,
                  const int* __restrict__ misc, int n_tables, int w_blk,
                  uint32_t* __restrict__ buf, int* __restrict__ bits) {
  __shared__ uint32_t ws[kWarps][kWordScratch];
  __shared__ Tables tabs;

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int t = n_tables == 1 ? 0 : n;
  load_tables(tabs, ac_rows + t * 512, dc_rows + t * 256, misc + t * 4, tid,
              kThreads);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int s0 = blockIdx.x * kSlots;
  for (int j = warp; j < kSlots; j += kWarps) {
    const int s = s0 + j;
    if (s >= n_slots) break;                     // warp-uniform, s rises
    const size_t slot = static_cast<size_t>(n) * n_slots + s;
    uint32_t* words = buf + slot * w_blk;
    if (valid[s] == 0) {
      for (int i = lane; i < w_blk; i += 32) words[i] = 0u;
      if (lane == 0) bits[slot] = 0;
      continue;
    }
    const int16_t* z = zz + slot * 64;
    code_block(z[lane], z[lane + 32], dcdiff[slot], dctab[s], actab[s], tabs,
               ws[warp], w_blk, words, bits + slot, lane);
  }
}

}  // namespace

// zz [B, n_slots, 64] i16; dcdiff [B, n_slots] i32; actab, dctab, valid
// [n_slots] i32 (the same for every image); ac_rows [n_tables,4,128], dc_rows
// [n_tables,2,128], misc [n_tables,4] i32 with n_tables == B (per-image
// tables) or 1 (shared); buf [B, n_slots, w_blk] u32; bits [B, n_slots] i32.
// Returns cudaGetLastError().
extern "C" int block_pack_launch(const void* zz, const void* dcdiff,
                                 const void* actab, const void* dctab,
                                 const void* valid, int B, int n_slots,
                                 const void* ac_rows, const void* dc_rows,
                                 const void* misc, int n_tables, int w_blk,
                                 void* buf, void* bits, void* stream) {
  if (B < 1 || n_slots < 1 || w_blk < 1 || w_blk > kWordScratch ||
      (n_tables != 1 && n_tables != B))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_slots + kSlots - 1) / kSlots, B);
  block_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(zz), static_cast<const int*>(dcdiff),
      static_cast<const int*>(actab), static_cast<const int*>(dctab),
      static_cast<const int*>(valid), n_slots,
      static_cast<const int*>(ac_rows), static_cast<const int*>(dc_rows),
      static_cast<const int*>(misc), n_tables, w_blk,
      static_cast<uint32_t*>(buf), static_cast<int*>(bits));
  return static_cast<int>(cudaGetLastError());
}
