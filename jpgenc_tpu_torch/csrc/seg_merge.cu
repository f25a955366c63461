// Kernel B and the word compaction as one merge tail: per-block packed words
// -> the compact word stream of each image, its per-segment bit counts and
// its overflow flag.
//
// Replaces jpgenc_tpu/ops/pallas/seg_merge.py::_kernel together with the
// XLA compaction after it (jpgenc_tpu/ops/pack.py:195 wcompact_unstuffed,
// composed in jpgenc_tpu/parallel/mesh.py:216-227) and the overflow flag.
// The Python wrapper and the plain version (seg_merge_plain ->
// wcompact_unstuffed -> amax) are in ops/cuda/seg_merge.py.
//
// What bounds it on the H100: device memory, and at the bench's rates a
// stream of about one word a block. Its predecessor read every block's
// w_blk + 1 words with a global atomic each into zeroed [n_seg, W] segment
// rows, behind a torch prologue (cumsum, shifts, casts) and before a torch
// compaction that read the rows back to write the stream a second time: some
// 15-25 launches, host-bound. Here three launches, no torch op between
// them, and each output word is written once:
//
//  1. merge_tiles: tiles of consecutive blocks of one image (kTile, one
//     thread a block). A segment longer than a tile is cut into tiles
//     (chunk mode); otherwise a tile holds whole segments (kTile / spb of
//     them). Each tile sums its clamped bit counts (min(bits, 32*w_blk), as
//     the reference clamps, seg_merge.py:157) and flags a block past its
//     tier; a tile of whole segments writes their nbits itself.
//  2. merge_scan, one thread block per image: the tiles' exclusive prefix
//     (chunk mode; in 64 bits) gives each tile's bit offset inside its
//     segment and each segment's nbits; the exclusive prefix of the
//     segments' walign-aligned word counts (ops/pack.py
//     seg_nwords_aligned) gives each segment's first word in the stream; the
//     tiles' flags give ovf. It zeroes the one word two tiles of a segment
//     share, where a tile boundary falls inside a word.
//  3. merge_write: a tile rescans its bit counts, so every block has its
//     bit position in the stream, and assembles its word range in shared
//     memory (a window of kWin words at a time): a block ORs in only the
//     ceil(((pos & 31) + bits) / 32) words it covers, funnel-shifted from
//     its packed words. The range of a tile reaches from its first bit to
//     its last or, where it ends a segment, to the segment's aligned end, so
//     the ranges tile the stream prefix and the zero words of the alignment
//     are written too. Words are byte-swapped (the stream's little-endian
//     memory image is the byte stream) and stored with plain stores; only
//     the shared word at a tile boundary inside a segment takes a global
//     atomicOr.
//
// Every word of an image's prefix, seg_nwords_aligned(nbits, walign).sum()
// words, equals the plain version bit for bit; the kernel leaves the words
// past the prefix as they were (the wrapper allocates the stream
// uninitialised; no consumer reads them). A word at or past cap_w is
// dropped, never written out of bounds; the caller's capacity check
// discards such an image. Atomics only OR disjoint bit ranges, so the
// result is exact and deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;     // blocks a tile, one thread each
constexpr int kWin = 2048;     // words assembled in shared memory at a time
constexpr int kScan = 1024;    // threads of merge_scan
constexpr long long kOvfFlag = 1ll << 40;   // in a tile's sum

struct Geometry {
  int S, n_seg, spb;
  int tps;       // chunk mode (spb > kTile): tiles a segment, else 0
  int spt;       // whole mode: segments a tile
  int tpi;       // tiles an image
};

Geometry geometry(int n_seg, int spb) {
  Geometry g;
  g.S = n_seg * spb;
  g.n_seg = n_seg;
  g.spb = spb;
  if (spb > kTile) {
    g.tps = (spb + kTile - 1) / kTile;
    g.spt = 0;
    g.tpi = n_seg * g.tps;
  } else {
    g.tps = 0;
    g.spt = kTile / spb;
    g.tpi = (n_seg + g.spt - 1) / g.spt;
  }
  return g;
}

struct Tile {
  int first, count;      // blocks of the image
  int seg0, nsegs;       // segments it touches
  bool seg_first, seg_last;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, int t) {
  Tile r;
  if (g.tps) {
    const int c = t % g.tps;
    r.seg0 = t / g.tps;
    r.nsegs = 1;
    r.first = r.seg0 * g.spb + c * kTile;
    r.count = min(kTile, g.spb - c * kTile);
    r.seg_first = c == 0;
    r.seg_last = c == g.tps - 1;
  } else {
    r.seg0 = t * g.spt;
    r.nsegs = min(g.spt, g.n_seg - r.seg0);
    r.first = r.seg0 * g.spb;
    r.count = r.nsegs * g.spb;
    r.seg_first = r.seg_last = true;
  }
  return r;
}

__device__ __forceinline__ long long aligned_words(long long nbits,
                                                   int walign) {
  const long long nw = (nbits + 31) >> 5;
  return (nw + walign - 1) & ~static_cast<long long>(walign - 1);
}

// Exclusive block-wide scan of v (every thread of the block calls it);
// *total gets the block's sum. sh: 32 elements of shared memory.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T* sh, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  T incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T s = lane < n_warps ? sh[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    sh[lane] = s;
  }
  __syncthreads();
  const T excl = incl - v + (warp ? sh[warp - 1] : T(0));
  *total = sh[n_warps - 1];
  __syncthreads();                               // sh free for reuse
  return excl;
}

__global__ void __launch_bounds__(kTile)
merge_tiles(const int* __restrict__ bits, Geometry g, int w_blk,
            long long* __restrict__ tile_sum, int* __restrict__ nbits) {
  __shared__ int sh[32];
  __shared__ int E[kTile + 1];
  const int n = blockIdx.y, t = blockIdx.x, i = threadIdx.x;
  const Tile tl = tile_of(g, t);
  int b = 0, over = 0;
  if (i < tl.count) {
    const int raw = bits[static_cast<size_t>(n) * g.S + tl.first + i];
    b = min(raw, 32 * w_blk);
    over = raw > 32 * w_blk;
  }
  int tot;
  const int e = block_scan(b, sh, &tot);
  const int any = __syncthreads_or(over);
  if (i == 0) tile_sum[static_cast<size_t>(n) * g.tpi + t] =
      tot + (any ? kOvfFlag : 0);
  if (g.tps) return;
  E[i] = e;                          // past the tile's blocks e == tot
  if (i == 0) E[kTile] = tot;
  __syncthreads();
  if (i < tl.nsegs)
    nbits[static_cast<size_t>(n) * g.n_seg + tl.seg0 + i] =
        E[(i + 1) * g.spb] - E[i * g.spb];
}

__global__ void __launch_bounds__(kScan)
merge_scan(const long long* __restrict__ tile_sum, Geometry g, int cap_w,
           int walign, long long* __restrict__ tile_off,
           long long* __restrict__ seg_word, int* __restrict__ nbits,
           bool* __restrict__ ovf, uint32_t* __restrict__ out) {
  __shared__ long long sh[32];
  const int n = blockIdx.x, tid = threadIdx.x;
  const long long* ts = tile_sum + static_cast<size_t>(n) * g.tpi;
  long long* toff = tile_off + static_cast<size_t>(n) * g.tpi;
  long long* sw = seg_word + static_cast<size_t>(n) * g.n_seg;
  int* nb = nbits + static_cast<size_t>(n) * g.n_seg;

  long long carry = 0, tot;
  int any = 0;
  for (int base = 0; base < g.tpi; base += kScan) {
    const int i = base + tid;
    const long long v = i < g.tpi ? ts[i] : 0;
    any |= v >= kOvfFlag;
    const long long e = block_scan(v & (kOvfFlag - 1), sh, &tot);
    if (g.tps && i < g.tpi) toff[i] = carry + e;
    carry += tot;
  }
  any = __syncthreads_or(any);
  if (tid == 0) ovf[n] = any != 0;
  if (g.tps) {                       // nbits of cut segments
    for (int s = tid; s < g.n_seg; s += kScan) {
      const long long end = s + 1 < g.n_seg ? toff[(s + 1) * g.tps] : carry;
      nb[s] = static_cast<int>(end - toff[s * g.tps]);
    }
    __syncthreads();
  }
  carry = 0;
  for (int base = 0; base < g.n_seg; base += kScan) {
    const int s = base + tid;
    const long long v = s < g.n_seg ? aligned_words(nb[s], walign) : 0;
    const long long e = block_scan(v, sh, &tot);
    if (s < g.n_seg) sw[s] = carry + e;
    carry += tot;
  }
  if (!g.tps) return;
  __syncthreads();
  uint32_t* o = out + static_cast<size_t>(n) * cap_w;
  for (int t = tid; t < g.tpi; t += kScan) {
    if (t % g.tps == 0) continue;
    const int s = t / g.tps;
    const long long pos = 32 * sw[s] + toff[t] - toff[s * g.tps];
    if ((pos & 31) && (pos >> 5) < cap_w) o[pos >> 5] = 0u;
  }
}

__global__ void __launch_bounds__(kTile)
merge_write(const uint32_t* __restrict__ buf, const int* __restrict__ bits,
            Geometry g, int w_blk, int cap_w, int walign,
            const long long* __restrict__ tile_off,
            const long long* __restrict__ seg_word,
            const int* __restrict__ nbits, uint32_t* __restrict__ out) {
  __shared__ int sh[32];
  __shared__ int E[kTile + 1];
  __shared__ uint32_t win[kWin];
  const int n = blockIdx.y, t = blockIdx.x, i = threadIdx.x;
  const Tile tl = tile_of(g, t);
  const size_t g0 = static_cast<size_t>(n) * g.S + tl.first;
  const long long* sw = seg_word + static_cast<size_t>(n) * g.n_seg;
  const int b = i < tl.count ? min(bits[g0 + i], 32 * w_blk) : 0;
  int tot;
  const int e = block_scan(b, sh, &tot);
  E[i] = e;
  if (i == 0) E[kTile] = tot;
  __syncthreads();

  // the tile's word range [wb, we) and each block's bit position
  long long pos, wb, we;
  bool left = false, right = false;
  const int last = tl.seg0 + tl.nsegs - 1;
  const long long seg_end =
      sw[last] + aligned_words(nbits[static_cast<size_t>(n) * g.n_seg + last],
                               walign);
  if (g.tps) {
    const long long* toff = tile_off + static_cast<size_t>(n) * g.tpi;
    const long long p0 = 32 * sw[tl.seg0] + toff[t] -
                         toff[tl.seg0 * g.tps];
    pos = p0 + e;
    wb = p0 >> 5;
    we = tl.seg_last ? seg_end : (p0 + tot + 31) >> 5;
    left = !tl.seg_first && (p0 & 31);
    right = !tl.seg_last && ((p0 + tot) & 31);
  } else {
    const int j = min(i, tl.count - 1) / g.spb;
    pos = 32 * sw[tl.seg0 + j] + e - E[j * g.spb];
    wb = sw[tl.seg0];
    we = seg_end;
  }

  const uint32_t* src = buf + (g0 + i) * w_blk;
  const long long wfirst = pos >> 5;
  const int r = static_cast<int>(pos & 31);
  const int nw = b ? (r + b + 31) >> 5 : 0;
  const int nsrc = (b + 31) >> 5;
  uint32_t* o = out + static_cast<size_t>(n) * cap_w;
  for (long long w0 = wb; w0 < we; w0 += kWin) {
    const int span = static_cast<int>(min(static_cast<long long>(kWin),
                                          we - w0));
    for (int k = i; k < span; k += kTile) win[k] = 0u;
    __syncthreads();
    const long long m0 = max(0ll, w0 - wfirst);
    const long long m1 = min(static_cast<long long>(nw), w0 + span - wfirst);
    uint32_t hi = m0 > 0 && m0 <= nsrc ? src[m0 - 1] : 0u;
    for (long long m = m0; m < m1; ++m) {
      const uint32_t lo = m < nsrc ? src[m] : 0u;
      // (hi:lo) >> r, low word: lo >> r | hi << (32 - r), and lo when r == 0
      const uint32_t v = __funnelshift_r(lo, hi, r);
      if (v) atomicOr(&win[wfirst + m - w0], v);
      hi = lo;
    }
    __syncthreads();
    for (int k = i; k < span; k += kTile) {
      const long long j = w0 + k;
      if (j >= cap_w) break;
      const uint32_t v = __byte_perm(win[k], 0u, 0x0123);
      if ((left && j == wb) || (right && j == we - 1)) {
        if (v) atomicOr(o + j, v);
      } else {
        o[j] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// int64 words of scratch the merge tail needs for B images.
extern "C" long long seg_merge_scratch(int B, int n_seg, int spb) {
  if (B < 1 || n_seg < 1 || spb < 1) return -1;
  const Geometry g = geometry(n_seg, spb);
  return static_cast<long long>(B) * (2ll * g.tpi + n_seg);
}

// buf [B, n_seg * spb, w_blk] u32 and bits [B, n_seg * spb] i32 (scan order,
// segment-major); scratch: seg_merge_scratch(B, n_seg, spb) int64 words;
// out: wstream [B, cap_w] u32 (need not be zeroed), nbits [B, n_seg] i32,
// ovf [B] bool. walign: a power of two. Returns cudaGetLastError().
extern "C" int seg_merge_launch(const void* buf, const void* bits, int B,
                                int n_seg, int spb, int w_blk, int cap_w,
                                int walign, void* scratch, void* wstream,
                                void* nbits, void* ovf, void* stream) {
  if (B < 1 || B > 65535 || n_seg < 1 || spb < 1 || w_blk < 1 ||
      w_blk > 56 || cap_w < 1 || walign < 1 || (walign & (walign - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(n_seg, spb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* tile_sum = static_cast<long long*>(scratch);
  long long* tile_off = tile_sum + static_cast<size_t>(B) * g.tpi;
  long long* seg_word = tile_off + static_cast<size_t>(B) * g.tpi;
  const dim3 tiles(g.tpi, B);
  merge_tiles<<<tiles, kTile, 0, s>>>(static_cast<const int*>(bits), g, w_blk,
                                      tile_sum, static_cast<int*>(nbits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_scan<<<B, kScan, 0, s>>>(tile_sum, g, cap_w, walign, tile_off,
                                 seg_word, static_cast<int*>(nbits),
                                 static_cast<bool*>(ovf),
                                 static_cast<uint32_t*>(wstream));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_write<<<tiles, kTile, 0, s>>>(
      static_cast<const uint32_t*>(buf), static_cast<const int*>(bits), g,
      w_blk, cap_w, walign, tile_off, seg_word,
      static_cast<const int*>(nbits), static_cast<uint32_t*>(wstream));
  return static_cast<int>(cudaGetLastError());
}
