// K1: pixels -> quantized zigzag coefficients (int16) in scan order, the
// first pass of the split encode path (two-pass optimized Huffman).
//
// Four kernels, one per Pallas kernel of jpgenc_tpu/ops/pallas/k1_dct.py. The
// Python wrapper and the plain versions are in ops/cuda/k1_dct.py.
//
//  * k1_kernel replaces ::_dense_dma_kernel: MCUs read from the image in its
//    natural layout, tiles of kTileMcus MCUs inside one MCU row of one image
//    (grid: tiles per row, MCU rows, images), so each pixel row of a tile is
//    one contiguous stretch of bytes.
//  * k1_repack_kernel replaces ::_dense_kernel: the same transform over the
//    MCU-contiguous repack (mcu_pack_words; here k1_dct.mcu_bytes, each MCU's
//    bytes in memory order), in flat tiles of MCUs that ignore image rows and
//    images. The reference takes it for frames whose MCU row is past its row
//    kernel's VMEM budget; on this card nothing forces the choice. Each MCU
//    is 3*mh*mw contiguous bytes, loaded as 16-byte vectors.
//  * k1_color_kernel replaces ::_color_kernel: the separable formulation.
//    BT.601 per pixel (level shift folded in), then per luma block one 64x64
//    product with KDCT_ZZ (the block-diagonal bd_y without its zeros) and per
//    chroma plane one [nb*64] x [nb*64, 64] product with sc = S_sub @ KDCT_ZZ
//    (box-mean subsampling folded in): (nb*64 + 2*nb*64) * 64 FMAs per MCU,
//    49 152 in 4:2:0, twice the shared transform's. Tiles of MCUs inside one
//    MCU row as k1_kernel's, common.cuh's separable loader and register
//    tiles (load_sep_tile, block_products, plane_products), balanced so that
//    every thread runs the same FMAs.
//  * k1_gray_kernel replaces ::_gray_kernel.
//
// The TPU's two dense kernels multiply an MCU's bytes by one [768, 384]
// operator on the matrix unit. k1_kernel and k1_repack_kernel instead run
// common.cuh's per-block formulation (BT.601 -> box subsample -> each 8x8
// block times KDCT_ZZ in shared memory, 24 576 FMAs per 4:2:0 MCU): they are
// the transform half of K1A (k1a_fused.cu) with an int16 store and call the
// same device functions, because an image can be coded by either path and
// both must hold the same coefficients bit for bit (k1a_fused.py:29,
// :368-373). The two differ in their loader only. The separable kernel
// rounds differently (it subsamples after the products, so its sums
// associate differently) and agrees with them except at knife edges
// (k1_dct.py:18-24); one process uses one formulation for all its files (the
// module switch K1_DENSE). K1 has no DPCM, so no predecessor is loaded.
//
// [n_mcu, (nb+2)*64] IS the interleaved scan order (T.81 A.2.3), so the
// output needs no gather: a tile's coefficients leave shared memory as one
// contiguous run of 16-byte stores. Each image owns n_slots >= n_mcu * (nb+2)
// output blocks (whole restart segments); the wrapper zeroes the pad blocks.
//
// What bounds them on the H100: k1_kernel and k1_repack_kernel, the block
// product's shared-memory loads and FMAs and the quantizer's true divisions
// (the measured times beside the bytes bound are in PERF.md section 6); the
// repack wrapper, its torch prologue; the separable kernel, its own FMAs
// (0.19 ms of them for 16 x 1080p 4:2:0 at the float32 peak against a bytes
// bound of 0.06) and their shared-memory loads; gray, the products' FMA
// issue, the quantizer's true divisions and the loader (0.153-0.1554 ms for
// 16 x 1080p gray against 0.0634 for its FMAs at the float32 peak and a bytes
// bound of 0.0297, NVIDIA H100 80GB HBM3 at 700 W; common.cuh's header).
#include "common.cuh"

namespace {

using namespace jpgenc;

template <int HS, int VS>
constexpr size_t smem_bytes() {                  // ks, then xs
  return 4 * (64 * 64 + kTileMcus * Geo<HS, VS>::STRIDE);
}

template <int HS, int VS>
__global__ void __launch_bounds__((HS * VS + 2) * 64, 2)
k1_kernel(const uint8_t* __restrict__ img, int H, int W, int vec, int mx,
          int n_slots, const float* __restrict__ kdct,
          const float* __restrict__ q, int16_t* __restrict__ zz_out) {
  using G = Geo<HS, VS>;
  constexpr int T = kTileMcus;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* xs = ks + 64 * 64;

  const int tid = threadIdx.x;
  const int mx0 = blockIdx.x * T, my_i = blockIdx.y, n = blockIdx.z;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W * 3;
  load_operator(kdct, ks, tid, G::L);
  load_tile_image<HS, VS>(im, H, W, vec, mx, my_i, mx0, xs, tid);
  __syncthreads();
  const int16_t* zq = tile_product<HS, VS>(xs, ks, q, tid);
  copy_zz(zq, min(T, mx - mx0) * G::L,
          zz_out + static_cast<size_t>(n) * n_slots * 64 +
              static_cast<size_t>(my_i * mx + mx0) * G::L,
          tid, G::L);
}

template <int HS, int VS>
__global__ void __launch_bounds__((HS * VS + 2) * 64, 2)
k1_repack_kernel(const uint8_t* __restrict__ mcus, long long total,
                 int n_mcus, int n_slots, const float* __restrict__ kdct,
                 const float* __restrict__ q, int16_t* __restrict__ zz_out) {
  using G = Geo<HS, VS>;
  constexpr int T = kTileMcus;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* xs = ks + 64 * 64;

  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * T;
  const long long left = total - t0;
  const int n_valid = left < T ? static_cast<int>(left) : T;
  load_operator(kdct, ks, tid, G::L);
  load_tile_packed<HS, VS>(mcus + t0 * G::K, n_valid, xs, tid);
  __syncthreads();
  const int16_t* zq = tile_product<HS, VS>(xs, ks, q, tid);
  // a tile may straddle two images: each MCU finds its own place
  const uint4* src = reinterpret_cast<const uint4*>(zq);
  for (int i = tid; i < n_valid * (G::L / 8); i += G::L) {
    const int s = i / (G::L / 8), j = i - s * (G::L / 8);
    const long long t = t0 + s;
    const long long n = t / n_mcus, g = t - n * n_mcus;
    reinterpret_cast<uint4*>(zz_out + (n * n_slots) * 64 + g * G::L)[j] =
        src[i];
  }
}

// Step 2 and the quantizer of the separable tile on xs and ks as
// load_sep_tile and load_operator left them (the caller has synchronised):
// luma thread (blk, mg, cg) owns coefficients 4*cg..4*cg+3 of block blk of
// the NL MCUs mg, mg + GL, ...; chroma thread (plane, mg, cg) those of the
// plane of the NC MCUs mg, mg + GC, .... Where there are two MCU groups or
// more (all but 4:2:0's luma at the default tile), the two halves of a warp
// take neighbouring groups, so their sample reads fall into different bank
// groups. The quantized values replace xs as int16 zq [T][L], the MCUs'
// coefficients in scan order: they are held in registers across the
// barrier that frees xs. Every thread of the block must call it.
template <int HS, int VS>
__device__ __forceinline__ const int16_t* sep_tile_product(
    float* xs, const float* ks, const float* __restrict__ q, int tid) {
  using G = SepGeo<HS, VS>;
  const int cg = tid & 15;
  const bool luma = tid < G::LUMA;               // warp-uniform
  const int bg = (luma ? tid : tid - G::LUMA) >> 4;
  const int groups = luma ? G::GL : G::GC;
  const int mg = bg % groups, blk = luma ? bg / groups : G::NB + bg / groups;
  uint2 zv[G::NL];                               // chroma: the first NC
  if (luma) {
    float acc[G::NL][4];
    block_products<G::NL, G::GL * G::SLOT>(xs + mg * G::SLOT + blk * 64,
                                           ks + 4 * cg, acc);
    const float4 qv =
        __ldg(reinterpret_cast<const float4*>(q + blk * 64) + cg);
#pragma unroll
    for (int j = 0; j < G::NL; ++j) zv[j] = quantize4(acc[j], qv);
  } else {
    float acc[G::NC][4];
    const float* xb = xs + mg * G::SLOT + (blk - G::NB + 1) * G::P;
    if constexpr (HS == 1)
      block_products<G::NC, G::GC * G::SLOT>(xb, ks + 4 * cg, acc);
    else
      plane_products<G::NC, G::GC * G::SLOT, VS>(xb, ks + 4 * cg, acc);
    const float4 qv =
        __ldg(reinterpret_cast<const float4*>(q + blk * 64) + cg);
#pragma unroll
    for (int j = 0; j < G::NC; ++j) zv[j] = quantize4(acc[j], qv);
  }
  __syncthreads();                               // xs becomes zq below
  int16_t* zq = reinterpret_cast<int16_t*>(xs);
  int16_t* d = zq + (mg * (G::NB + 2) + blk) * 64 + 4 * cg;
  if (luma) {
#pragma unroll
    for (int j = 0; j < G::NL; ++j)
      *reinterpret_cast<uint2*>(d + j * G::GL * G::L) = zv[j];
  } else {
#pragma unroll
    for (int j = 0; j < G::NC; ++j)
      *reinterpret_cast<uint2*>(d + j * G::GC * G::L) = zv[j];
  }
  __syncthreads();
  return zq;
}

// sep [(1 + NB) * 64, 64] f32: rows 0..63 KDCT_ZZ, rows 64.. the chroma
// operator sc = S_sub @ KDCT_ZZ, which the kernel does not read (common.cuh:
// the scaled samples times KDCT_ZZ give its products exactly).
template <int HS, int VS>
__global__ void __launch_bounds__(SepGeo<HS, VS>::THREADS,
                                  SepGeo<HS, VS>::MIN_BLOCKS)
k1_color_kernel(const uint8_t* __restrict__ img, int H, int W, int vec,
                int mx, int n_slots, const float* __restrict__ sep,
                const float* __restrict__ q, int16_t* __restrict__ zz_out) {
  using G = SepGeo<HS, VS>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* xs = ks + 64 * 64;

  const int tid = threadIdx.x;
  const int mx0 = blockIdx.x * G::T, my_i = blockIdx.y, n = blockIdx.z;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W * 3;
  load_operator(sep, ks, tid, G::THREADS);
  load_sep_tile<HS, VS>(im, H, W, vec, mx, my_i, mx0, xs, tid);
  __syncthreads();
  const int16_t* zq = sep_tile_product<HS, VS>(xs, ks, q, tid);
  copy_zz(zq, min(G::T, mx - mx0) * G::L,
          zz_out + static_cast<size_t>(n) * n_slots * 64 +
              static_cast<size_t>(my_i * mx + mx0) * G::L,
          tid, G::THREADS);
}

// Gray: the transform half of gray K1A (k1a_gray.cu) with a plain store;
// both run common.cuh's gray loader and gray_tile_product. A tile's blocks
// are consecutive in [B, n_slots, 64], so they leave shared memory as one
// run of 16-byte stores.
constexpr size_t kGraySmemBytes = 4 * (64 * 64 + kGrayTile * kGrayStride);

__global__ void __launch_bounds__(kGrayThreads, 3)
k1_gray_kernel(const uint8_t* __restrict__ img, int H, int W, int vec, int mx,
               int n_slots, const float* __restrict__ kdct,
               const float* __restrict__ q, int16_t* __restrict__ zz_out) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* xs = ks + 64 * 64;

  const int tid = threadIdx.x;
  const int mx0 = blockIdx.x * kGrayTile, by = blockIdx.y, n = blockIdx.z;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W;
  load_operator(kdct, ks, tid, kGrayThreads);
  load_gray_tile(im, H, W, vec, mx, by, mx0, xs, tid);
  __syncthreads();
  const int16_t* zq = gray_tile_product(xs, ks, q, tid);
  copy_zz(zq, min(kGrayTile, mx - mx0) * 64,
          zz_out + (static_cast<size_t>(n) * n_slots + by * mx + mx0) * 64,
          tid, kGrayThreads);
}

enum Variant { kRows = 0, kRepack = 1, kSeparable = 2 };

struct Args {
  const void *src, *op, *q;
  void* zz_out;
  int B, H, W, n_slots;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HS, int VS>
cudaError_t launch_rows(const Args& a, int my, int mx) {
  constexpr int L = (HS * VS + 2) * 64;
  constexpr size_t kBytes = smem_bytes<HS, VS>();
  if (my > 65535 || a.B > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(k1_kernel<HS, VS>, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((mx + kTileMcus - 1) / kTileMcus, my, a.B);
  k1_kernel<HS, VS><<<grid, L, kBytes, a.stream>>>(
      static_cast<const uint8_t*>(a.src), a.H, a.W,
      load_alignment(a.src, 3 * a.W), mx, a.n_slots,
      static_cast<const float*>(a.op), static_cast<const float*>(a.q),
      static_cast<int16_t*>(a.zz_out));
  return cudaGetLastError();
}

// src is the image [B,H,W,3] (rows, separable) or the repack [B*n_mcu, K]
// (repack); op is KDCT_ZZ (rows, repack) or sep (separable).
template <int HS, int VS>
cudaError_t launch(int variant, const Args& a) {
  constexpr int L = (HS * VS + 2) * 64;
  const int my = (a.H + 8 * VS - 1) / (8 * VS);
  const int mx = (a.W + 8 * HS - 1) / (8 * HS);
  const int n_mcus = my * mx;
  if (a.n_slots < n_mcus * (HS * VS + 2)) return cudaErrorInvalidValue;
  const float* o = static_cast<const float*>(a.op);
  const float* qf = static_cast<const float*>(a.q);
  int16_t* out = static_cast<int16_t*>(a.zz_out);
  if (variant == kRows) {
    return launch_rows<HS, VS>(a, my, mx);
  } else if (variant == kRepack) {
    constexpr int T = kTileMcus;
    constexpr size_t kBytes = smem_bytes<HS, VS>();
    const long long total = static_cast<long long>(a.B) * n_mcus;
    const long long blocks = (total + T - 1) / T;
    if (blocks > 0x7fffffffLL || !aligned16(a.src))
      return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(k1_repack_kernel<HS, VS>, kBytes);
    if (err != cudaSuccess) return err;
    k1_repack_kernel<HS, VS>
        <<<static_cast<unsigned>(blocks), L, kBytes, a.stream>>>(
            static_cast<const uint8_t*>(a.src), total, n_mcus, a.n_slots, o,
            qf, out);
  } else if (variant == kSeparable) {
    using G = SepGeo<HS, VS>;
    if (my > 65535 || a.B > 65535) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(k1_color_kernel<HS, VS>, G::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((mx + G::T - 1) / G::T, my, a.B);
    k1_color_kernel<HS, VS><<<grid, G::THREADS, G::SMEM, a.stream>>>(
        static_cast<const uint8_t*>(a.src), a.H, a.W,
        load_alignment(a.src, 3 * a.W), mx, a.n_slots, o, qf, out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// variant 0 (rows): src = img [B,H,W,3] u8, op = KDCT_ZZ [64,64] f32. variant
// 1 (repack): src = the MCU repack [B, n_mcu, 3*64*nb] u8 (16-byte aligned),
// op as rows. variant 2 (separable): src = img, op = sep
// [(1+nb)*64, 64] f32. q [(nb+2)*64] f32; op, q and zz_out 16-byte aligned;
// zz_out [B, n_slots, 64] i16 with n_slots >= n_mcu*(nb+2) (the blocks past
// it are not written). Returns cudaGetLastError().
extern "C" int k1_dct_launch(int variant, const void* src, int B, int H,
                             int W, int hs, int vs, int n_slots,
                             const void* op, const void* q, void* zz_out,
                             void* stream) {
  if (B < 1 || H < 1 || W < 1 || !aligned16(op) || !aligned16(q) ||
      !aligned16(zz_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{src, op, q, zz_out, B, H, W, n_slots,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (hs == 2 && vs == 2) err = launch<2, 2>(variant, a);
  else if (hs == 2 && vs == 1) err = launch<2, 1>(variant, a);
  else if (hs == 1 && vs == 1) err = launch<1, 1>(variant, a);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// img [B,H,W] u8; kdct [64,64] f32; q [64] f32 (zigzag order); zz_out
// [B, n_slots, 64] i16 with n_slots >= n_blocks; kdct, q and zz_out 16-byte
// aligned. Returns cudaGetLastError().
extern "C" int k1_gray_launch(const void* img, int B, int H, int W,
                              int n_slots, const void* kdct, const void* q,
                              void* zz_out, void* stream) {
  if (B < 1 || H < 1 || W < 1 || !aligned16(kdct) || !aligned16(q) ||
      !aligned16(zz_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mx = (W + 7) / 8, my = (H + 7) / 8;
  if (n_slots < my * mx || my > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(k1_gray_kernel, kGraySmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((mx + kGrayTile - 1) / kGrayTile, my, B);
  k1_gray_kernel<<<grid, kGrayThreads, kGraySmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, load_alignment(img, W), mx,
      n_slots, static_cast<const float*>(kdct), static_cast<const float*>(q),
      static_cast<int16_t*>(zz_out));
  return static_cast<int>(cudaGetLastError());
}
