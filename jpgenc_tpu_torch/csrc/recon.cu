// Decoder reconstruction: quantized zigzag coefficients (int16, MCU-major) ->
// uint8 pixels, in one pass with every intermediate on chip.
//
// Replaces jpgenc_tpu/ops/pallas/recon.py: the inner `kernel` of
// `_make_kernel` (colour, 4:4:4 / 4:2:2 / 4:2:0) and `_gray_kernel`. The
// Python wrapper and the plain version are in ops/cuda/recon.py.
//
// The function, per component sample and per pixel:
//   1. xf = float(coefficient) * quant, zigzag order;
//   2. sample = clamp(rint(xf . KIDCT_ZZ[:, pos] + 128), 0, 255): the T.81
//      range limit on every component's samples, chroma too;
//   3. chroma to luma resolution with the centered 3:1 triangle, vertically
//      first, then horizontally, over the CLAMPED samples, plane edges
//      replicated;
//   4. BT.601 full range, rint, clamp, uint8;
//   5. rows >= h and columns >= w are not written.
//
// Design. A thread block reconstructs a tile of kTile consecutive MCUs of one
// MCU row. The triangle filter of a tile's border pixels needs chroma samples
// of the neighbouring MCUs (the column left and right of the tile, the row
// above and below it, four corners). Thread blocks run in no order, so no
// block reads another's output: the tile keeps its chroma samples in an
// extended plane [10][8*kTile + 2] in shared memory, whose halo entries are
// recomputed from the neighbour's coefficients with idct_sample, the same
// device function that computes the owner's samples, with the same operands in
// the same order. Both sides of an MCU boundary therefore see the same clamped
// sample bit for bit. The halo's coordinates are clamped to the padded chroma
// plane, which is the edge replication. For a full 4:2:0 tile the halo is
// 2 * (2 * (8*kTile + 2) + 16) = 296 samples beside 3072 owned ones (9.6 %
// more dot products); 4:2:2 has only the two columns, 4:4:4 no halo.
//
// Sums are written with __fmaf_rn in k order and the colour stage with
// separate _rn multiplies and adds in the order of ops/color.py, so the result
// does not depend on nvcc's contraction. The upsample is exact in float32
// (samples are integers <= 255, the weights are 3/4 and 1/4), so the only
// place where the kernel and the plain version (a cuBLAS/CPU matmul) can
// differ is the order of the 64-term sum of step 2, on a knife edge of rint.
//
// What bounds it on the H100: device memory by the function's bytes (2 bytes
// per coefficient in, 1 byte per sample out). This first version spends 64
// FMAs per sample from shared memory (the dense 64x64 operator per block),
// not a separable IDCT, and does not skip zero coefficients: it is bound by
// shared-memory loads and the CUDA cores. Its time is in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;        // MCUs per thread block (colour)
constexpr int kGrayTile = 32;   // 8x8 blocks per thread block (gray)

// One reconstructed, range-limited component sample: position p (row-major in
// the 8x8 block) of the block whose dequantized zigzag coefficients xf(k)
// yields. ks is KIDCT_ZZ [64][64] (row k = basis image of coefficient k).
template <class Coef>
__device__ __forceinline__ float idct_sample(Coef xf, const float* ks, int p) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < 64; ++k) acc = __fmaf_rn(xf(k), ks[k * 64 + p], acc);
  return fminf(fmaxf(rintf(__fadd_rn(acc, 128.f)), 0.f), 255.f);
}

// Dequantized coefficients already in shared memory.
struct SharedCoef {
  const float* xf;
  __device__ __forceinline__ float operator()(int k) const { return xf[k]; }
};

// Dequantized on the fly from device memory: the same product as the one that
// filled the shared copy.
struct GlobalCoef {
  const int16_t* x;
  const float* q;
  __device__ __forceinline__ float operator()(int k) const {
    return __fmul_rn(static_cast<float>(x[k]), q[k]);
  }
};

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.f), 255.f));
}

// 0.75 a + 0.25 b as ops/color._upsample2_axis writes it.
__device__ __forceinline__ float tri(float a, float b) {
  return __fadd_rn(__fmul_rn(0.75f, a), __fmul_rn(0.25f, b));
}

template <int HS, int VS>
__global__ void __launch_bounds__(kThreads)
recon_kernel(const int16_t* __restrict__ x, const float* __restrict__ q,
             const float* __restrict__ kidct, uint8_t* __restrict__ out,
             int my, int mx, int h, int w) {
  constexpr int NB = HS * VS;
  constexpr int L = (NB + 2) * 64;
  constexpr int MH = 8 * VS, MW = 8 * HS;
  constexpr int CW = 8 * kTile + 2;          // extended chroma plane width
  __shared__ __align__(16) float ks[64 * 64];
  __shared__ __align__(16) float xs[kTile * L];        // dequantized coefs
  __shared__ float ys[kTile * NB * 64];                // luma samples
  __shared__ float cs[2][10][CW];                      // chroma + halo
  __shared__ float qs[L];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, i = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int n_valid = min(kTile, mx - x0);
  const float* qb = q + static_cast<size_t>(b) * L;
  const int16_t* xb = x + static_cast<size_t>(b) * my * mx * L;
  const int16_t* xrow = xb + (static_cast<size_t>(i) * mx + x0) * L;

  for (int t = tid; t < 64 * 64; t += kThreads) ks[t] = kidct[t];
  for (int t = tid; t < L; t += kThreads) qs[t] = qb[t];
  __syncthreads();
  for (int t = tid; t < n_valid * L; t += kThreads)
    xs[t] = __fmul_rn(static_cast<float>(xrow[t]), qs[t % L]);
  __syncthreads();

  // the tile's own samples: luma to ys, chroma into the extended plane
  for (int t = tid; t < n_valid * L; t += kThreads) {
    const int s = t / L, lane = t - s * L;
    const int g = lane >> 6, p = lane & 63;
    const float v = idct_sample(SharedCoef{xs + s * L + g * 64}, ks, p);
    if (g < NB)
      ys[(s * NB + g) * 64 + p] = v;
    else
      cs[g - NB][(p >> 3) + 1][s * 8 + (p & 7) + 1] = v;
  }

  // the halo: chroma samples of neighbouring MCUs, recomputed from their
  // coefficients; coordinates clamped to the padded chroma plane
  if constexpr (HS == 2 || VS == 2) {
    const int n_cols = n_valid * 8 + 2;
    const int n_rowh = (VS == 2) ? 2 * n_cols : 0;     // rows 0 and 9
    const int n_colh = (HS == 2) ? 2 * 8 : 0;          // cols 0 and last
    const int n_halo = 2 * (n_rowh + n_colh);
    for (int t = tid; t < n_halo; t += kThreads) {
      const int c = t / (n_rowh + n_colh);
      int e = t - c * (n_rowh + n_colh);
      int er, ec;                       // extended-plane row and column
      if (e < n_rowh) {
        er = (e < n_cols) ? 0 : 9;
        ec = (e < n_cols) ? e : e - n_cols;
      } else {
        e -= n_rowh;
        er = (e & 7) + 1;
        ec = (e < 8) ? 0 : n_cols - 1;
      }
      const int cy = min(max(i * 8 + er - 1, 0), my * 8 - 1);
      const int cx = min(max(x0 * 8 + ec - 1, 0), mx * 8 - 1);
      const int16_t* blk =
          xb + (static_cast<size_t>(cy >> 3) * mx + (cx >> 3)) * L +
          (NB + c) * 64;
      cs[c][er][ec] = idct_sample(GlobalCoef{blk, qs + (NB + c) * 64}, ks,
                                  (cy & 7) * 8 + (cx & 7));
    }
  }
  __syncthreads();

  // pixels: upsample (vertical, then horizontal), BT.601, round, clamp
  const int tw = n_valid * MW;
  uint8_t* ob = out + static_cast<size_t>(b) * h * w * 3;
  for (int t = tid; t < MH * tw; t += kThreads) {
    const int r = t / tw, c = t - r * tw;
    const int gy = i * MH + r, gx = x0 * MW + c;
    if (gy >= h || gx >= w) continue;
    const int s = c / MW, px = c - s * MW;
    const float y =
        ys[(s * NB + (r >> 3) * HS + (px >> 3)) * 64 + (r & 7) * 8 + (px & 7)];
    // chroma taps in the extended plane: the sample's own row/column and,
    // for a factor of 2, the nearer neighbour (above for even rows, below
    // for odd ones; likewise left and right)
    const int r0 = (VS == 2 ? (r >> 1) : r) + 1;
    const int r1 = (VS == 2) ? ((r & 1) ? r0 + 1 : r0 - 1) : r0;
    const int c0 = (HS == 2 ? (c >> 1) : c) + 1;
    const int c1 = (HS == 2) ? ((c & 1) ? c0 + 1 : c0 - 1) : c0;
    float cc[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float a = cs[k][r0][c0], bb = cs[k][r0][c1];
      if (VS == 2) {
        a = tri(a, cs[k][r1][c0]);
        bb = tri(bb, cs[k][r1][c1]);
      }
      cc[k] = (HS == 2) ? tri(a, bb) : a;
    }
    const float cb = __fsub_rn(cc[0], 128.f), cr = __fsub_rn(cc[1], 128.f);
    const float rr = __fadd_rn(y, __fmul_rn(1.402f, cr));
    const float gg = __fsub_rn(__fsub_rn(y, __fmul_rn(0.344136286f, cb)),
                               __fmul_rn(0.714136286f, cr));
    const float bl = __fadd_rn(y, __fmul_rn(1.772f, cb));
    uint8_t* o = ob + (static_cast<size_t>(gy) * w + gx) * 3;
    o[0] = to_u8(rr);
    o[1] = to_u8(gg);
    o[2] = to_u8(bl);
  }
}

__global__ void __launch_bounds__(kThreads)
recon_gray_kernel(const int16_t* __restrict__ x, const float* __restrict__ q,
                  const float* __restrict__ kidct, uint8_t* __restrict__ out,
                  int my, int mx, int h, int w) {
  __shared__ __align__(16) float ks[64 * 64];
  __shared__ __align__(16) float xs[kGrayTile * 64];
  __shared__ float qs[64];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, i = blockIdx.y;
  const int x0 = blockIdx.x * kGrayTile;
  const int n_valid = min(kGrayTile, mx - x0);
  const int16_t* xrow =
      x + ((static_cast<size_t>(b) * my + i) * mx + x0) * 64;

  for (int t = tid; t < 64 * 64; t += kThreads) ks[t] = kidct[t];
  if (tid < 64) qs[tid] = q[static_cast<size_t>(b) * 64 + tid];
  __syncthreads();
  for (int t = tid; t < n_valid * 64; t += kThreads)
    xs[t] = __fmul_rn(static_cast<float>(xrow[t]), qs[t & 63]);
  __syncthreads();

  const int tw = n_valid * 8;
  uint8_t* ob = out + static_cast<size_t>(b) * h * w;
  for (int t = tid; t < 8 * tw; t += kThreads) {
    const int r = t / tw, c = t - r * tw;
    const int gy = i * 8 + r, gx = x0 * 8 + c;
    if (gy >= h || gx >= w) continue;
    const float v =
        idct_sample(SharedCoef{xs + (c >> 3) * 64}, ks, r * 8 + (c & 7));
    ob[static_cast<size_t>(gy) * w + gx] = static_cast<uint8_t>(v);
  }
}

template <int HS, int VS>
cudaError_t launch(const void* x, const void* q, const void* kidct, void* out,
                   int B, int my, int mx, int h, int w, cudaStream_t stream) {
  const dim3 grid((mx + kTile - 1) / kTile, my, B);
  recon_kernel<HS, VS><<<grid, kThreads, 0, stream>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(q),
      static_cast<const float*>(kidct), static_cast<uint8_t*>(out), my, mx, h,
      w);
  return cudaGetLastError();
}

bool bad_geometry(int B, int my, int mx, int h, int w, int mh, int mw) {
  return B < 1 || B > 65535 || my < 1 || my > 65535 || mx < 1 || h < 1 ||
         w < 1 || h > my * mh || w > mx * mw;
}

}  // namespace

// x [B, my, mx, (nb+2)*64] i16 (MCU-major, zigzag); q [B, (nb+2)*64] f32
// (zigzag order: luma tiled nb times, Cb, Cr); kidct [64, 64] f32; out
// [B, h, w, 3] u8. Returns cudaGetLastError().
extern "C" int recon_launch(const void* x, const void* q, const void* kidct,
                            void* out, int B, int my, int mx, int h, int w,
                            int hs, int vs, void* stream) {
  if (bad_geometry(B, my, mx, h, w, 8 * vs, 8 * hs))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hs == 2 && vs == 2)
    err = launch<2, 2>(x, q, kidct, out, B, my, mx, h, w, st);
  else if (hs == 2 && vs == 1)
    err = launch<2, 1>(x, q, kidct, out, B, my, mx, h, w, st);
  else if (hs == 1 && vs == 1)
    err = launch<1, 1>(x, q, kidct, out, B, my, mx, h, w, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

// x [B, my, mx, 64] i16; q [B, 64] f32 (zigzag order); kidct [64, 64] f32;
// out [B, h, w] u8. Returns cudaGetLastError().
extern "C" int recon_gray_launch(const void* x, const void* q,
                                 const void* kidct, void* out, int B, int my,
                                 int mx, int h, int w, void* stream) {
  if (bad_geometry(B, my, mx, h, w, 8, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((mx + kGrayTile - 1) / kGrayTile, my, B);
  recon_gray_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), static_cast<const float*>(q),
      static_cast<const float*>(kidct), static_cast<uint8_t*>(out), my, mx, h,
      w);
  return static_cast<int>(cudaGetLastError());
}
