// K4: the host16c codec's decoder, sealed u32 buffer -> i16 work signal.
//
// Replaces: noaa_apt_tpu/ops/pack.py:unpack_sealed_device (a 126-step
// lax.scan over every block at once; not Pallas, but no single torch op
// expresses the recurrence).  Computes exactly what it computes:
//   - residual j of block b is the w_lo-bit field at bit j*w_lo of the
//     block's bw-word stride (g*w_lo == 32*u makes the unit layout the
//     plain bit stream), sign-extended as v - (sign << w_lo);
//   - x[0], x[1] are the block's anchors; for j in [0, 126)
//       x[j+2] = ((C * x[j+1]) >> 14) - x[j] + r[j]
//     in int32 with wraparound and an arithmetic shift; out = (int16) x;
//   - escape row e overwrites block idx = (int32) esc_idx[e], where an
//     index in [-nb, 0) counts from the end (JAX's .at[] normalization)
//     and one outside [-nb, nb) is dropped (the padding holds nb); where
//     several rows name one block, the last of them wins, as JAX's
//     scatter does on the CPU (ops/pack.py:unpack_sealed_plain).
// Layout: [nb anchors][n_esc_pad esc idx][n_esc_pad * 64 esc rows][nb * bw base].
//
// Bound on an H100: bytes.  A 10-minute 48 kHz pass (nb = 61,440) reads
// 11 MB of sealed words (w_lo 9) and writes 15.7 MB of i16: about
// 0.008 ms at 3.35 TB/s.  The recurrence is 126 dependent integer steps
// per block, and a pass has only nb threads (about 15 warps an SM, one
// wave), so the card is latency-bound unless each step is short and the
// loads are all in flight at once.
// Design: one launch, one thread per 128-sample block, kWarps warps of 32
// consecutive blocks a CTA, one CTA per SM.
//   - w_lo is a template parameter (4..16), so every residual's word and
//     shift are compile-time values: the 126 steps unroll, a unit's words
//     come from shared memory one unit ahead, and the chain of a step is
//     IMUL -> SHR -> IADD3.
//   - A warp stages its 32 blocks' base words into shared memory with
//     cp.async (coalesced, all in flight, rows of an odd stride so the
//     lanes' reads of their own rows hit 32 banks).
//   - Meanwhile the CTA scans the escape indices once (coalesced, from
//     L2) and keeps, per block it owns, the last row that names it (a
//     shared atomicMax of row numbers: the same rule whatever the order).
//   - Each lane packs two samples a word into a 32-word half tile (rows of
//     33 words: conflict-free); after each half the warp writes 32 rows
//     of 128 bytes, each a full line, taking an escaped block's words from
//     its escape row instead.  Escapes need no second launch and no second
//     write.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;             // warps per CTA: 512 blocks
constexpr int kThreads = 32 * kWarps;
constexpr int kRes = 126;              // residuals per block
constexpr int kOutWords = 64;          // 128 i16 samples per block
constexpr int kHalf = 32;              // output words a tile holds
constexpr int kTileStride = kHalf + 1;

constexpr int gcd32(int w) { return w % 16 == 0 ? 16 : w % 8 == 0 ? 8 : w % 4 == 0 ? 4 : w % 2 == 0 ? 2 : 1; }

// The unit geometry of ops/pack.py:unit_geometry for w_lo = W.
template <int W>
struct Geometry {
  static constexpr int g = 32 / gcd32(W);        // residuals per unit
  static constexpr int u = W / gcd32(W);         // words per unit
  static constexpr int units = (kRes + g - 1) / g;
  static constexpr int bw = units * u;           // words per block
  static constexpr int stride = bw | 1;          // odd shared row stride
  static constexpr size_t smem =                 // map + per warp words and tile
      sizeof(int) * ((size_t)kThreads + (size_t)kWarps * (32 * stride + 32 * kTileStride));
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// The warp's 32 rows of the half tile ``h`` go to their blocks' output
// words [32h, 32h + 32): lane = word, one 128-byte line per row; an
// escaped block takes its last escape row's words.
__device__ __forceinline__ void flush_half(int h, const uint32_t* tile, const int* map, int nblk,
                                          const uint32_t* __restrict__ esc_rows, int lane,
                                          uint32_t* __restrict__ go) {
  __syncwarp();
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    if (r < nblk) {
      const int e = map[r];  // the same in every lane
      const uint32_t v = e >= 0 ? __ldg(esc_rows + (long long)e * kOutWords + kHalf * h + lane)
                                : tile[r * kTileStride + lane];
      go[r * kOutWords + kHalf * h + lane] = v;
    }
  }
  __syncwarp();
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
unpack_kernel(const uint32_t* __restrict__ buf, long long nb, int n_esc_pad, int coeff,
              uint32_t* __restrict__ out) {
  using Geo = Geometry<W>;
  constexpr int kG = Geo::g, kU = Geo::u, kUnits = Geo::units, kBw = Geo::bw, kS = Geo::stride;
  extern __shared__ int smem[];
  int* map = smem;  // per block of the CTA: its last escape row, or -1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + kThreads) + warp * (32 * kS + 32 * kTileStride);
  uint32_t* tile = words + 32 * kS;
  const long long cta_b0 = (long long)blockIdx.x * kThreads;
  const long long b0 = cta_b0 + warp * 32;
  const int nblk = b0 >= nb ? 0 : (nb - b0 < 32 ? (int)(nb - b0) : 32);

  map[threadIdx.x] = -1;
  // The warp's base words, all in flight: no register holds them.
  const uint32_t* gw = buf + nb + (long long)n_esc_pad * (1 + kOutWords) + b0 * kBw;
  for (int i = lane; i < nblk * kBw; i += 32) {
    const int r = i / kBw;
    cp_async4(words + r * kS + (i - r * kBw), gw + i);
  }
  const uint32_t anchor = lane < nblk ? __ldg(buf + b0 + lane) : 0u;
  __syncthreads();  // the map is -1 everywhere before any row claims a block

  // The escape rows that name this CTA's blocks: the last one wins.
  const uint32_t* esc_idx = buf + nb;
#pragma unroll 4
  for (int e = threadIdx.x; e < n_esc_pad; e += kThreads) {
    long long idx = (int)__ldg(esc_idx + e);
    if (idx < 0) idx += nb;
    const long long rel = idx - cta_b0;
    if (idx >= 0 && idx < nb && rel >= 0 && rel < kThreads) atomicMax(map + rel, e);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the map and every warp's words are in place
  if (nblk == 0) return;

  const uint32_t* esc_rows = buf + nb + n_esc_pad;
  uint32_t* go = out + b0 * kOutWords;
  const int* wmap = map + warp * 32;
  // Every lane runs the recurrence (lanes past nblk on rows nobody reads),
  // so the warp stays converged through the flushes.
  const uint32_t* w = words + lane * kS;
  uint32_t* t = tile + lane * kTileStride;
  t[0] = anchor;  // samples 0 and 1, as they were packed
  int x0 = (int)(int16_t)(anchor & 0xFFFFu);
  int x1 = (int)(int16_t)(anchor >> 16);
  uint32_t cur[kU], nxt[kU];
#pragma unroll
  for (int q = 0; q < kU; ++q) cur[q] = w[q];
  unsigned low = 0;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    if (k + 1 < kUnits) {
#pragma unroll
      for (int q = 0; q < kU; ++q) nxt[q] = w[(k + 1) * kU + q];
    }
#pragma unroll
    for (int jj = 0; jj < kG; ++jj) {
      const int j = k * kG + jj;
      if (j < kRes) {
        const int bit = jj * W, wi = bit >> 5, sh = bit & 31;
        unsigned v = cur[wi] >> sh;
        if (sh + W > 32) v |= cur[wi + 1] << (32 - sh);
        v &= (1u << W) - 1u;
        const int r = (int)v - (int)(((v >> (W - 1)) & 1u) << W);
        const int prod = (int)((unsigned)coeff * (unsigned)x1);  // int32 wraparound
        const int xn = (int)((unsigned)(prod >> 14) - (unsigned)x0 + (unsigned)r);
        x0 = x1;
        x1 = xn;
        const unsigned hs = (unsigned)xn & 0xFFFFu;  // (int16) xn
        if (j & 1) {
          const int word = 1 + (j >> 1);
          t[word % kHalf] = low | (hs << 16);
          if (word == kHalf - 1) flush_half(0, tile, wmap, nblk, esc_rows, lane, go);
        } else {
          low = hs;
        }
      }
    }
    if (k + 1 < kUnits) {
#pragma unroll
      for (int q = 0; q < kU; ++q) cur[q] = nxt[q];
    }
  }
  flush_half(1, tile, wmap, nblk, esc_rows, lane, go);
}

template <int W>
cudaError_t launch(const uint32_t* buf, long long nb, int n_esc_pad, int coeff, uint32_t* out,
                   cudaStream_t stream) {
  auto kern = unpack_kernel<W>;
  constexpr size_t smem = Geometry<W>::smem;
  static bool opted_in[64] = {};  // per device: the shared memory opt-in is set once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted_in[dev] = true;
  }
  const long long grid = (nb + kThreads - 1) / kThreads;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(buf, nb, n_esc_pad, coeff, out);
  return cudaGetLastError();
}

}  // namespace

// buf: the sealed words; out: nb * 128 int16 (4-byte aligned); bw must be
// the block stride of w_lo (ops/pack.py:unit_geometry).  Launches once on
// `stream`, which belongs to the current device.
extern "C" int unpack_sealed(const void* buf, long long nb, int w_lo, int bw, int n_esc_pad, int coeff,
                             void* out, void* stream) {
  if (nb <= 0) return 0;
  if (n_esc_pad < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = static_cast<const uint32_t*>(buf);
  uint32_t* o = static_cast<uint32_t*>(out);
#define K4_CASE(W) \
  case W:          \
    return bw != Geometry<W>::bw ? (int)cudaErrorInvalidValue : (int)launch<W>(b, nb, n_esc_pad, coeff, o, s);
  switch (w_lo) {
    K4_CASE(4) K4_CASE(5) K4_CASE(6) K4_CASE(7) K4_CASE(8) K4_CASE(9) K4_CASE(10)
    K4_CASE(11) K4_CASE(12) K4_CASE(13) K4_CASE(14) K4_CASE(15) K4_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K4_CASE
}
