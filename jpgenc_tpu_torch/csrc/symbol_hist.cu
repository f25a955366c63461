// The symbol histogram of the optimize mode's pass 1: scan-ordered quantized
// zigzag blocks and their DC differences -> per image, per table, the count
// of every DC and AC Huffman symbol (T.81 F.1.2, K.2), from which the host
// builds each image's own tables.
//
// Replaces no Pallas kernel: jpgenc_tpu/ops/entropy.py::symbol_histogram is
// XLA tensor code (a compare-reduce over 160 bins). Its plain PyTorch form,
// ops/cuda/symbol_hist.py::histogram_plain (a log-step running max, a
// boolean-mask gather and two bincounts, about 20 launches and a hidden
// device sync), stays as the CPU path and the tests' oracle; the wrapper is
// ops/cuda/symbol_hist.py::fused_symbol_histogram.
//
// What bounds it on the H100: device memory. A block is 128 bytes of int16
// and 4 of DC difference read once; the count is a few integer steps per
// nonzero coefficient, so 16 x 4K 4:2:0 (3.1 M blocks, 413 MB) has a bytes
// bound of 0.12 ms. The design keeps the counting off device memory, keeps
// loads in flight and spreads a block's nonzero coefficients over lanes:
//
//  1. A warp takes 32 consecutive slots of one image. Each of its loads
//     covers 4 slots (512 contiguous bytes, 16 bytes a lane: lanes 8g..8g+7
//     hold slot g's coefficients 0..63), and all 8 loads of the 32 slots
//     are issued before any is used.
//  2. A lane turns its 8 coefficients into an 8-bit nonzero mask; three
//     shuffles inside the 8 lanes of a slot give every one of them the
//     slot's 64-bit mask, bit 0 (DC) cleared. The 4 slots go to a 512-byte
//     staging row of the warp in shared memory.
//  3. Lane k of a slot counts the nonzero AC positions p = k mod 8: a
//     block's nonzero coefficients crowd its first zigzag positions, so
//     this spreads them over the 8 lanes, where contiguous eighths left
//     lane 0 with most of them (0.365 against 0.252 ms for 16 x 4K, timed
//     in one run on an H100 80GB HBM3 at 700 W; warp-aggregated adds by
//     __match_any_sync were slower in both designs). For each position it
//     reads the value from the staging row, finds the zero run before it
//     from the mask (p - 1 - the highest set bit below p, by __clzll),
//     SSSS by __clz, and adds one to the symbol ((run & 15) << 4) | SSSS in
//     the thread block's shared [2][2][256] histogram (4 KB), plus run >> 4
//     ZRLs. ZRLs (bin 0xF0) and EOBs (bin 0x00, a block whose position 63
//     is zero) go to per-lane registers, one per table, so the hottest bin
//     is no shared atomic; they are summed over the warp once at the end.
//  4. Per 32 slots, lane l adds slot l's DC SSSS to its DC table. A slot
//     with valid == 0 (segment padding) counts nothing.
//  5. At the end each thread block adds its nonzero bins to the output
//     [B][2 (dc, ac)][2 (table)][256] with global atomics (the wrapper
//     zeroes it): integer adds commute, so the counts are exact and the
//     same on every run.
//
// grid = (slot tiles, images); a tile is kSlots slots of one image.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 1024;                      // slots a thread block
constexpr int kChunks = kSlots / (kWarps * 32);   // 32-slot chunks a warp
constexpr int kBins = 256;                        // symbols a table
constexpr int kTables = 2;                        // table ids a kind
constexpr int kHist = 2 * kTables * kBins;        // [dc, ac][table][symbol]
static_assert(kSlots == kChunks * kWarps * 32, "whole chunks a warp");

// SSSS (T.81 Table F.1): the bit length of |v|.
__device__ __forceinline__ int ssss(int v) {
  const unsigned a = v < 0 ? 0u - static_cast<unsigned>(v)
                           : static_cast<unsigned>(v);
  return 32 - __clz(static_cast<int>(a));
}

__global__ void __launch_bounds__(kThreads)
symbol_hist_kernel(const int16_t* __restrict__ zz,
                   const int* __restrict__ dcdiff,
                   const int* __restrict__ actab,
                   const int* __restrict__ dctab,
                   const int* __restrict__ valid, int n_slots,
                   int* __restrict__ out) {
  __shared__ unsigned hist[kHist];
  __shared__ uint4 stage_all[kWarps][32];   // a warp's 4 slots in turn
  for (int i = threadIdx.x; i < kHist; i += kThreads) hist[i] = 0u;
  __syncthreads();

  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 3;   // which of a load's 4 slots
  const int k = lane & 7;    // which 8 coefficients of it
  uint4* stage = stage_all[warp];
  const size_t img0 = static_cast<size_t>(n) * n_slots;
  unsigned zrl0 = 0u, zrl1 = 0u, eob0 = 0u, eob1 = 0u;   // per table

  for (int c = 0; c < kChunks; ++c) {
    const int s0 = blockIdx.x * kSlots + (c * kWarps + warp) * 32;
    if (s0 >= n_slots) break;                          // warp-uniform
    const uint4* src = reinterpret_cast<const uint4*>(zz + (img0 + s0) * 64);
    uint4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = s0 + 4 * j + g < n_slots ? __ldg(src + (4 * j + g) * 8 + k)
                                      : make_uint4(0u, 0u, 0u, 0u);

    // one slot a lane: its plan and its DC symbol
    int ok = 0, tab = 0;
    if (s0 + lane < n_slots) {
      const int s = s0 + lane;
      ok = __ldg(valid + s) != 0;
      tab = __ldg(actab + s) & 1;
      if (ok)
        atomicAdd(&hist[((__ldg(dctab + s) & 1) << 8)
                        + ssss(__ldg(dcdiff + img0 + s))], 1u);
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int slot_ok = __shfl_sync(kFull, ok, 4 * j + g);
      const int t = __shfl_sync(kFull, tab, 4 * j + g);
      const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      unsigned bits = 0u;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (w[h] & 0xffffu) bits |= 1u << (2 * h);
        if (w[h] >> 16) bits |= 1u << (2 * h + 1);
      }
      if (!slot_ok) bits = 0u;
      // EOB: position 63 (this lane's bit 7 when k == 7) is zero
      if (k == 7 && slot_ok && !(bits >> 7)) (t ? eob1 : eob0) += 1u;
      if (k == 0) bits &= ~1u;                         // position 0 is DC
      unsigned x = bits << (8 * (k & 3));
      x |= __shfl_xor_sync(kFull, x, 1);
      x |= __shfl_xor_sync(kFull, x, 2);
      const unsigned y = __shfl_xor_sync(kFull, x, 4);
      const uint64_t mask = k < 4
          ? (static_cast<uint64_t>(y) << 32) | x
          : (static_cast<uint64_t>(x) << 32) | y;
      __syncwarp();
      stage[lane] = v[j];
      __syncwarp();
      const int16_t* zs = reinterpret_cast<const int16_t*>(stage) + g * 64;
      unsigned* ac = hist + (kTables + t) * kBins;
      uint64_t mine = mask & (0x0101010101010101ull << k);   // p = k mod 8
      while (mine) {
        const int p = __ffsll(static_cast<long long>(mine)) - 1;
        mine &= mine - 1;
        const uint64_t below = mask & ((1ull << p) - 1);
        const int prev = below ? 63 - __clzll(below) : 0;
        const int run = p - 1 - prev;
        const int sym = ((run & 15) << 4) | ssss(zs[p]);
        atomicAdd(&ac[sym], 1u);
        (t ? zrl1 : zrl0) += run >> 4;
      }
    }
  }

  // the registers' ZRLs and EOBs, a warp's sum each
#pragma unroll
  for (int t = 0; t < kTables; ++t) {
    const unsigned z = __reduce_add_sync(kFull, t ? zrl1 : zrl0);
    const unsigned e = __reduce_add_sync(kFull, t ? eob1 : eob0);
    if (lane == 0) {
      if (z) atomicAdd(&hist[(kTables + t) * kBins + 0xF0], z);
      if (e) atomicAdd(&hist[(kTables + t) * kBins], e);
    }
  }
  __syncthreads();
  int* dst = out + static_cast<size_t>(n) * kHist;
  for (int i = threadIdx.x; i < kHist; i += kThreads)
    if (hist[i]) atomicAdd(dst + i, static_cast<int>(hist[i]));
}

}  // namespace

// zz [B, n_slots, 64] int16 (16-byte aligned), dcdiff [B, n_slots] int32,
// actab, dctab, valid [n_slots] int32 -> out [B, 2, 2, 256] int32, which
// the caller zeroes first.
extern "C" int symbol_hist_launch(const void* zz, const void* dcdiff,
                                  const void* actab, const void* dctab,
                                  const void* valid, int B, int n_slots,
                                  void* out, void* stream) {
  if (B < 1 || B > 65535 || n_slots < 1 ||
      reinterpret_cast<uintptr_t>(zz) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_slots + kSlots - 1) / kSlots, B);
  symbol_hist_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(zz), static_cast<const int*>(dcdiff),
      static_cast<const int*>(actab), static_cast<const int*>(dctab),
      static_cast<const int*>(valid), n_slots, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
