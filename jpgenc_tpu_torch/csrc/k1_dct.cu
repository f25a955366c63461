// K1: pixels -> quantized zigzag coefficients (int16) in scan order, the
// first pass of the split encode path (two-pass optimized Huffman).
//
// Replaces jpgenc_tpu/ops/pallas/k1_dct.py::_dense_dma_kernel (colour) and
// ::_gray_kernel (gray). The Python wrapper and the plain versions are in
// ops/cuda/k1_dct.py.
//
// Both kernels are the transform halves of the fused kernels (k1a_fused.cu,
// k1a_gray.cu) with an int16 store: the transform itself is common.cuh's
// tile_transform / gray_tile_transform, the same function the fused kernels
// call, because an image can be coded by either path and both must hold the
// same coefficients bit for bit (k1a_fused.py:29, :368-373). K1 has no DPCM,
// so no predecessor is recomputed: every slot of a tile is stored.
//
// [n_mcu, (nb+2)*64] IS the interleaved scan order (T.81 A.2.3), so the
// output needs no gather; thread tid stores coefficient tid of each MCU, a
// coalesced 2-byte store.
//
// What bounds it on the H100: as K1A, the dense operator's 384*768 FMAs per
// 4:2:0 MCU on the CUDA cores (colour); for gray, device memory (1 byte in,
// 2 bytes out per pixel).
#include "common.cuh"

namespace {

using namespace jpgenc;

constexpr int kTile = 8;           // MCUs per thread block (colour)
constexpr int kGrayTile = 32;      // 8x8 blocks per thread block (gray)

template <int HS, int VS>
__global__ void __launch_bounds__((HS * VS + 2) * 64)
k1_kernel(const uint8_t* __restrict__ img, int H, int W, int mx, int n_mcus,
          const float* __restrict__ m, const float* __restrict__ bias,
          const float* __restrict__ q, int16_t* __restrict__ zz_out) {
  constexpr int L = (HS * VS + 2) * 64;
  constexpr int K = 8 * VS * 3 * 8 * HS;
  __shared__ __align__(16) float xs[kTile * K];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int g0 = blockIdx.x * kTile;
  const uint8_t* im = img + static_cast<size_t>(n) * H * W * 3;
  const int* zq = tile_transform<HS, VS, kTile>(im, H, W, mx, n_mcus, g0, m,
                                                bias, q, xs, tid);
  for (int s = 0; s < kTile && g0 + s < n_mcus; ++s)
    zz_out[(static_cast<size_t>(n) * n_mcus + g0 + s) * L + tid] =
        static_cast<int16_t>(zq[s * L + tid]);
}

__global__ void __launch_bounds__(kGrayThreads)
k1_gray_kernel(const uint8_t* __restrict__ img, int H, int W, int mx,
               int n_mcus, const float* __restrict__ kdct,
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
      zz_out[(static_cast<size_t>(n) * n_mcus + g) * 64 + (i & 63)] =
          static_cast<int16_t>(zq[i]);
  }
}

template <int HS, int VS>
cudaError_t launch(const void* img, int B, int H, int W, const void* m,
                   const void* bias, const void* q, void* zz_out,
                   cudaStream_t stream) {
  const int my = (H + 8 * VS - 1) / (8 * VS);
  const int mx = (W + 8 * HS - 1) / (8 * HS);
  const int n_mcus = my * mx;
  const dim3 grid((n_mcus + kTile - 1) / kTile, B);
  k1_kernel<HS, VS><<<grid, (HS * VS + 2) * 64, 0, stream>>>(
      static_cast<const uint8_t*>(img), H, W, mx, n_mcus,
      static_cast<const float*>(m), static_cast<const float*>(bias),
      static_cast<const float*>(q), static_cast<int16_t*>(zz_out));
  return cudaGetLastError();
}

}  // namespace

// img [B,H,W,3] u8; m [3*64*nb, (nb+2)*64] f32 (natural basis); bias, q
// [(nb+2)*64] f32; zz_out [B, n_mcu, (nb+2)*64] i16. Returns
// cudaGetLastError().
extern "C" int k1_dct_launch(const void* img, int B, int H, int W, int hs,
                             int vs, const void* m, const void* bias,
                             const void* q, void* zz_out, void* stream) {
  if (B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hs == 2 && vs == 2)
    err = launch<2, 2>(img, B, H, W, m, bias, q, zz_out, st);
  else if (hs == 2 && vs == 1)
    err = launch<2, 1>(img, B, H, W, m, bias, q, zz_out, st);
  else if (hs == 1 && vs == 1)
    err = launch<1, 1>(img, B, H, W, m, bias, q, zz_out, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// img [B,H,W] u8; kdct [64,64] f32; q [64] f32 (zigzag order); zz_out
// [B, n_blocks, 64] i16. Returns cudaGetLastError().
extern "C" int k1_gray_launch(const void* img, int B, int H, int W,
                              const void* kdct, const void* q, void* zz_out,
                              void* stream) {
  if (B < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int mx = (W + 7) / 8;
  const int n_mcus = ((H + 7) / 8) * mx;
  const dim3 grid((n_mcus + kGrayTile - 1) / kGrayTile, B);
  k1_gray_kernel<<<grid, kGrayThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), H, W, mx, n_mcus,
      static_cast<const float*>(kdct), static_cast<const float*>(q),
      static_cast<int16_t*>(zz_out));
  return static_cast<int>(cudaGetLastError());
}
