// Kernel A: scan-ordered quantized zigzag blocks -> per-block Huffman-packed
// words, the entropy pass of the split encode path.
//
// Replaces jpgenc_tpu/ops/pallas/block_pack.py::_kernel (with _ac_analysis,
// _dc_piece and _pack_slots). The Python wrapper, the slot_metadata prologue
// and the plain version are in ops/cuda/block_pack.py.
//
// What bounds it on the H100: device memory at the bench's rates (128 bytes
// of int16 in and 4*w_blk + 4 bytes out per block, 0.04 ms for 16 x 1080p
// 4:2:0), the lanes' serial steps on dense blocks. Its predecessor ran one
// warp per block (code_block) and was bound by instruction issue: the same
// ballots, shuffle scan, 64 scratch words and shared atomics for every
// block, though at 0.18 bpp most blocks are DC + EOB or one AC symbol more,
// so nearly every lane analysed a zero. Here the work follows the nonzero
// coefficients:
//
//  1. A warp takes 32 consecutive slots of one image and copies their
//     coefficients (4 KB, contiguous) into shared memory with coalesced
//     16-byte loads, each block on a 144-byte row: a lane reading 16 bytes of
//     its own block then touches other banks than the 7 other lanes of its
//     quarter warp.
//  2. The warp zeroes its 32 word rows in shared memory (16-byte stores),
//     then lane b codes block b alone (common.cuh's code_block_serial): its
//     nonzero mask from 8 16-byte reads of its row, then the DC piece and one
//     step per nonzero AC coefficient (__ffsll), pieces collecting in a
//     64-bit register that leaves a 32-bit word at a time into the lane's
//     word row.
//  3. The warp stores its 32 * w_blk words (the rows are contiguous, as in
//     buf) with 16-byte stores, and its 32 bit counts, coalesced.
//
// Tried on the H100 and slower on the all-nonzero input at w_blk 56: rows of
// pitch w_blk | 1 (no bank conflicts between lanes writing word k) with a
// per-word copy-out, an odd pitch for the coefficient rows, and words stored
// by each lane straight to device memory (partial sectors: several times
// slower).
//
// A warp is as slow as its busiest lane: on an input where every
// coefficient is nonzero each lane runs 63 AC steps (chip_smoke.py times
// that case beside the bench input). A thread block of 8 warps takes kSlots
// consecutive slots of ONE image, so the image's own Huffman tables
// (optimized per image; the reference vmaps the kernel over a batch of LUTs,
// parallel/mesh.py:293-296) are loaded into shared memory once per thread
// block: grid = (slot tiles, images), tables indexed by blockIdx.y. The
// per-slot DC difference, table ids and the valid flag come from the torch
// prologue. A slot with valid == 0 (segment padding) writes zero words and
// zero bits. A block over 32*w_blk bits keeps its first w_blk words and its
// true bit count (block_pack.py:218-229).
#include "common.cuh"

namespace {

using namespace jpgenc;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 2;                       // 32-slot groups a warp
constexpr int kSlots = kWarps * 32 * kGroups;    // slots per thread block
constexpr int kZPitch = 72;                      // int16 a block row: 144 B

// Dynamic shared memory: per warp 32 coefficient rows, then 32 word rows of
// w_blk words.
int smem_bytes(int w_blk) {
  return kWarps * (32 * kZPitch * 2 + 32 * w_blk * 4);
}

__global__ void __launch_bounds__(kThreads)
block_pack_kernel(const int16_t* __restrict__ zz,
                  const int* __restrict__ dcdiff,
                  const int* __restrict__ actab, const int* __restrict__ dctab,
                  const int* __restrict__ valid, int n_slots,
                  const int* __restrict__ ac_rows,
                  const int* __restrict__ dc_rows,
                  const int* __restrict__ misc, int n_tables, int w_blk,
                  uint32_t* __restrict__ buf, int* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tables tabs;

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int t = n_tables == 1 ? 0 : n;
  load_tables(tabs, ac_rows + t * 512, dc_rows + t * 256, misc + t * 4, tid,
              kThreads);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  int16_t* zs = reinterpret_cast<int16_t*>(smem) + warp * 32 * kZPitch;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + kWarps * 32 * kZPitch * 2)
                 + warp * 32 * w_blk;
  for (int g = 0; g < kGroups; ++g) {
    const int s0 = blockIdx.x * kSlots + (g * kWarps + warp) * 32;
    if (s0 >= n_slots) break;                    // warp-uniform
    const int nb = min(32, n_slots - s0);
    const size_t slot0 = static_cast<size_t>(n) * n_slots + s0;

    const uint4* src = reinterpret_cast<const uint4*>(zz + slot0 * 64);
    for (int i = lane; i < nb * 8; i += 32)
      *reinterpret_cast<uint4*>(zs + (i >> 3) * kZPitch + (i & 7) * 8) =
          __ldg(src + i);
    for (int i = lane; i < 8 * w_blk; i += 32)
      reinterpret_cast<uint4*>(ws)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();

    if (lane < nb) {
      const int s = s0 + lane;
      uint32_t* row = ws + lane * w_blk;
      int nbits = 0;
      if (valid[s] != 0) {
        const int16_t* z = zs + lane * kZPitch;
        uint64_t mask = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const uint4 v = *reinterpret_cast<const uint4*>(z + 8 * q);
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            if (w[h] & 0xffffu) mask |= 1ull << (8 * q + 2 * h);
            if (w[h] >> 16) mask |= 1ull << (8 * q + 2 * h + 1);
          }
        }
        nbits = code_block_serial(z, mask & ~1ull, dcdiff[slot0 + lane],
                                  dctab[s], actab[s], tabs, row, w_blk);
      }
      bits[slot0 + lane] = nbits;
    }
    __syncwarp();

    uint32_t* dst = buf + slot0 * w_blk;
    const int n_words = nb * w_blk;
    if ((n_words & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      for (int i = lane; i < n_words >> 2; i += 32)
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(ws)[i];
    } else {
      for (int i = lane; i < n_words; i += 32) dst[i] = ws[i];
    }
    __syncwarp();                                // rows free for reuse
  }
}

}  // namespace

// zz [B, n_slots, 64] i16, 16-byte aligned; dcdiff [B, n_slots] i32; actab,
// dctab, valid [n_slots] i32 (the same for every image); ac_rows
// [n_tables,4,128], dc_rows [n_tables,2,128], misc [n_tables,4] i32 with
// n_tables == B (per-image tables) or 1 (shared); buf [B, n_slots, w_blk]
// u32; bits [B, n_slots] i32. Returns cudaGetLastError().
extern "C" int block_pack_launch(const void* zz, const void* dcdiff,
                                 const void* actab, const void* dctab,
                                 const void* valid, int B, int n_slots,
                                 const void* ac_rows, const void* dc_rows,
                                 const void* misc, int n_tables, int w_blk,
                                 void* buf, void* bits, void* stream) {
  if (B < 1 || n_slots < 1 || w_blk < 1 || w_blk > 56 ||
      (n_tables != 1 && n_tables != B) ||
      reinterpret_cast<uintptr_t>(zz) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(w_blk);
  cudaError_t err = cudaFuncSetAttribute(
      block_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_slots + kSlots - 1) / kSlots, B);
  block_pack_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(zz), static_cast<const int*>(dcdiff),
      static_cast<const int*>(actab), static_cast<const int*>(dctab),
      static_cast<const int*>(valid), n_slots,
      static_cast<const int*>(ac_rows), static_cast<const int*>(dc_rows),
      static_cast<const int*>(misc), n_tables, w_blk,
      static_cast<uint32_t*>(buf), static_cast<int*>(bits));
  return static_cast<int>(cudaGetLastError());
}
