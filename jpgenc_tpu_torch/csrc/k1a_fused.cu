// K1A: raw RGB pixels -> quantized zigzag -> DC DPCM -> Huffman -> per-block
// packed words, in one kernel.
//
// Replaces jpgenc_tpu/ops/pallas/k1a_fused.py::_k1a_kernel (with
// _pair_entropy and block_pack._ac_analysis/_dc_piece/_pack_slots). The
// Python wrapper and the plain version are in ops/cuda/k1a_fused.py.
//
// The TPU kernel multiplies every MCU's bytes by one dense operator on the
// matrix unit. Here the transform is common.cuh's per-block formulation
// (BT.601 -> box subsample -> each 8x8 block times KDCT_ZZ held in shared
// memory), shared with the K1 kernels (k1_dct.cu) so all of them hold the
// same coefficients bit for bit.
//
// Work layout. One thread block of (nb+2)*64 threads takes a tile of T =
// kTileMcus consecutive MCUs inside one MCU row of one image: grid (tiles per
// row, MCU rows, images), so each of the tile's pixel rows is one contiguous
// stretch of bytes.
//  1. load_tile_image and tile_product (common.cuh) leave the tile's
//     quantized coefficients in shared memory, in scan order.
//  2. DC DPCM. Thread blocks run in no order, so the TPU kernel's carry
//     across grid steps (k1a_fused.py:93-124) cannot be used. The tile needs
//     three values of the MCU before it (the DC of its last Y block, of Cb
//     and of Cr; the last MCU of the row above for a tile that starts a
//     row): one more MCU is loaded beside the tile and three threads run
//     tile_product's chain for coefficient 0 only (dc_of_block), so the
//     values are the owning tile's bit for bit at 3 * 64 FMAs instead of a
//     whole MCU's products. The predictor resets at every segment start,
//     g % mps == 0 with mps = restart_interval or n_mcus
//     (k1a_fused.py:110-114); a tile that starts a segment loads no
//     predecessor. Each image owns n_slots >= n_mcus * (nb+2) output slots
//     (whole segments); the wrapper zeroes the pad slots.
//  3. Entropy: one warp per 8x8 block (common.cuh's code_block; kernel A in
//     block_pack.cu codes the same pieces with code_block_serial).
//
// What bounds it on the H100: instruction throughput, in two halves of about
// equal time. 16 x 1080p 4:2:0 Q75 at w_blk 8 take 0.57 ms (H100 at 700 W)
// where the K1 kernel, the same transform with a plain store, takes 0.28:
// the other half is the entropy coder (code_block: ballots, a shuffle scan
// and shared-memory atomics per block, then w_blk words per block to device
// memory), which this design leaves as it was. The bytes bound is 0.04 ms;
// PERF.md section 6 holds the numbers. The tile: 40 MCUs keep 10 blocks x
// 4 coefficients of accumulators per thread (11 FMAs per shared load) in
// about 85 KB of shared memory, two thread blocks an SM, so one tile's loads
// overlap another's products. Of the tiles measured (16, 24, 32, 40 MCUs;
// kernels/tile_sweep.py) 40 was the fastest on an H100 both at 16 x 1080p
// (120 MCUs a row: three tiles, none cut short) and at 2 x 2048 x 16384
// (1024 MCUs a row), by 1 to 10 % over 24 and 32 and 12 to 30 % over 16:
// fewer loads of the operator per MCU and more FMAs a shared-memory load.
// No tensor cores: the samples are float32 and the chain's rounding is part
// of the contract between K1A, K1 and the plain version.
#include "common.cuh"

namespace {

using namespace jpgenc;

// %tid.x and %ctaid.* read from the special registers at the point of use.
// k1a_kernel takes its indices a second time after tile_product: a value
// computed before the products and used after them holds a register across
// the 4 * kBpt accumulators, and the compiler keeps threadIdx / blockIdx in
// one when they are read the plain way. Measured on an H100 (kernels/
// tile_sweep.py, 16 x 1080p 4:2:0, 80 registers a thread for two blocks an
// SM): at kBpt = 10 the plain reads (-DJPGENC_PLAIN_IDX) spill 8 bytes and
// take 0.59 ms where these take 0.57; at kBpt = 8 neither spills (0.63 and
// 0.61 ms). Should another compiler spill here all the same, -DJPGENC_BPT=8
// is the build to fall back to.
#define JPGENC_SREG(fn, reg)                                   \
  __device__ __forceinline__ int fn() {                        \
    unsigned v;                                                \
    asm volatile("mov.u32 %0, %%" reg ";" : "=r"(v));          \
    return static_cast<int>(v);                                \
  }
#ifdef JPGENC_PLAIN_IDX
__device__ __forceinline__ int tid_x() { return threadIdx.x; }
__device__ __forceinline__ int ctaid_x() { return blockIdx.x; }
__device__ __forceinline__ int ctaid_y() { return blockIdx.y; }
__device__ __forceinline__ int ctaid_z() { return blockIdx.z; }
#else
JPGENC_SREG(tid_x, "tid.x")
JPGENC_SREG(ctaid_x, "ctaid.x")
JPGENC_SREG(ctaid_y, "ctaid.y")
JPGENC_SREG(ctaid_z, "ctaid.z")
#endif

template <int HS, int VS>
struct Smem {                                    // offsets in 4-byte words
  using G = Geo<HS, VS>;
  static constexpr int T = kTileMcus;
  static constexpr int NWARPS = G::L / 32;
  static constexpr int XS = 64 * 64;             // after ks
  static constexpr int WS = XS + (T + 1) * G::STRIDE;
  static constexpr int TABS = WS + NWARPS * kWordScratch;
  static constexpr int PRED = TABS + sizeof(Tables) / 4;
  static constexpr size_t BYTES = 4 * (PRED + 4);
};

template <int HS, int VS>
__global__ void __launch_bounds__((HS * VS + 2) * 64, 2)
k1a_kernel(const uint8_t* __restrict__ img, int H, int W, int vec, int mx,
           int n_mcus, int mps, int n_slots, const float* __restrict__ kdct,
           const float* __restrict__ q, const int* __restrict__ ac_rows,
           const int* __restrict__ dc_rows, const int* __restrict__ misc,
           int w_blk, uint32_t* __restrict__ buf, int* __restrict__ bits,
           int16_t* __restrict__ zz_out) {
  using G = Geo<HS, VS>;
  using S = Smem<HS, VS>;
  constexpr int T = S::T, NB = G::NB, NB2 = G::NB2, L = G::L;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;
  float* xs = smem + S::XS;
  float* xpred = xs + T * G::STRIDE;             // the MCU before the tile
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + S::WS);
  Tables& tabs = *reinterpret_cast<Tables*>(smem + S::TABS);
  int* pred_dc = reinterpret_cast<int*>(smem + S::PRED);

  {  // the transform; its indices end with this scope
    const int tid = threadIdx.x;
    const int mx0 = blockIdx.x * T, my_i = blockIdx.y;
    const int g0 = my_i * mx + mx0;
    const uint8_t* im = img + static_cast<size_t>(blockIdx.z) * H * W * 3;
    const bool need_pred = g0 % mps != 0;        // not a segment start

    load_tables(tabs, ac_rows, dc_rows, misc, tid, L);
    load_operator(kdct, ks, tid, L);
    load_tile_image<HS, VS>(im, H, W, vec, mx, my_i, mx0, xs, tid);
    if (need_pred)                               // by the last threads
      load_mcu_image<HS, VS>(im, H, W, vec, (g0 - 1) % mx, (g0 - 1) / mx,
                             xpred, L - 1 - tid);
    __syncthreads();
    if (need_pred && tid < 3) {
      const int blk = NB - 1 + tid;
      pred_dc[tid] = dc_of_block(xpred + blk * 64, ks, q[blk * 64]);
    }
  }
  const int16_t* zq = tile_product<HS, VS>(xs, ks, q, threadIdx.x);

  // the indices again, not carried over the products (see JPGENC_SREG)
  const int tid = tid_x();
  const int mx0 = ctaid_x() * T;
  const int g0 = ctaid_y() * mx + mx0;
  const int n = ctaid_z();

  const int n_valid = min(T, mx - mx0);
  if (zz_out != nullptr)
    copy_zz(zq, n_valid * L,
            zz_out + (static_cast<size_t>(n) * n_mcus + g0) * L, tid, L);

  const int warp = tid >> 5, lane = tid & 31;
  for (int job = warp; job < n_valid * NB2; job += S::NWARPS) {
    const int s = job / NB2, blk = job - s * NB2;
    const int g = g0 + s;
    const int16_t* z = zq + s * L;
    const bool reset = g % mps == 0;             // segment start
    int pred;
    if (blk > 0 && blk < NB) pred = z[(blk - 1) * 64];
    else if (reset) pred = 0;
    else if (blk == 0) pred = s ? z[(NB - 1) * 64 - L] : pred_dc[0];
    else pred = s ? z[blk * 64 - L] : pred_dc[blk - NB + 1];
    const size_t slot = static_cast<size_t>(n) * n_slots + g * NB2 + blk;
    const int tab = blk < NB ? 0 : 1;
    code_block(z[blk * 64 + lane], z[blk * 64 + lane + 32],
               z[blk * 64] - pred, tab, tab, tabs, ws + warp * kWordScratch,
               w_blk, buf + slot * w_blk, bits + slot, lane);
  }
}

struct Args {
  const void *img, *kdct, *q, *ac_rows, *dc_rows, *misc;
  void *buf, *bits, *zz_out;
  int B, H, W, mps, n_slots, w_blk;
  cudaStream_t stream;
};

template <int HS, int VS>
cudaError_t launch(const Args& a) {
  using S = Smem<HS, VS>;
  const int my = (a.H + 8 * VS - 1) / (8 * VS);
  const int mx = (a.W + 8 * HS - 1) / (8 * HS);
  const int n_mcus = my * mx;
  if (a.mps < 1 || a.n_slots < n_mcus * (HS * VS + 2) || my > 65535 ||
      a.B > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      k1a_kernel<HS, VS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid((mx + S::T - 1) / S::T, my, a.B);
  k1a_kernel<HS, VS><<<grid, (HS * VS + 2) * 64, S::BYTES, a.stream>>>(
      static_cast<const uint8_t*>(a.img), a.H, a.W,
      load_alignment(a.img, 3 * a.W), mx, n_mcus, a.mps, a.n_slots,
      static_cast<const float*>(a.kdct), static_cast<const float*>(a.q),
      static_cast<const int*>(a.ac_rows), static_cast<const int*>(a.dc_rows),
      static_cast<const int*>(a.misc), a.w_blk, static_cast<uint32_t*>(a.buf),
      static_cast<int*>(a.bits), static_cast<int16_t*>(a.zz_out));
  return cudaGetLastError();
}

}  // namespace

// img [B,H,W,3] u8; kdct [64,64] f32 (KDCT_ZZ) and q [(nb+2)*64] f32, both
// 16-byte aligned; ac_rows [4,128], dc_rows [2,128], misc [4] i32; mps MCUs
// per restart segment; buf [B, n_slots, w_blk] u32 and bits [B, n_slots] i32
// with n_slots >= n_mcu*(nb+2) (the slots past it are not written); zz_out
// [B, n_mcu, (nb+2)*64] i16 (16-byte aligned) or null. Returns
// cudaGetLastError().
extern "C" int k1a_fused_launch(const void* img, int B, int H, int W, int hs,
                                int vs, int mps, int n_slots,
                                const void* kdct, const void* q,
                                const void* ac_rows, const void* dc_rows,
                                const void* misc, int w_blk, void* buf,
                                void* bits, void* zz_out, void* stream) {
  if (B < 1 || H < 1 || W < 1 || w_blk < 1 || w_blk > kWordScratch ||
      !aligned16(kdct) || !aligned16(q) || !aligned16(zz_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{img, kdct, q, ac_rows, dc_rows, misc, buf, bits, zz_out,
               B, H, W, mps, n_slots, w_blk,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (hs == 2 && vs == 2) err = launch<2, 2>(a);
  else if (hs == 2 && vs == 1) err = launch<2, 1>(a);
  else if (hs == 1 && vs == 1) err = launch<1, 1>(a);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
