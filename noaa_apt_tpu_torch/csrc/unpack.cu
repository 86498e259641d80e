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
//     and one outside [-nb, nb) is dropped (the padding holds nb).
// Layout: [nb anchors][n_esc_pad esc idx][n_esc_pad * 64 esc rows][nb * bw base].
//
// Bound on an H100: bytes.  A 10-minute 48 kHz pass (nb = 61,440) reads
// at most 14 MB of sealed words (w_lo 14) and writes 15.7 MB of i16:
// about 0.009 ms at 3.35 TB/s.  The recurrence is 126 dependent integer
// steps per block: latency, not throughput.
// Design: one thread per 128-sample block, so the recurrence stays in
// registers.  A warp owns 32 consecutive blocks: it copies their base
// words into shared memory with coalesced loads (rows of an odd stride,
// so the lanes' reads of their own rows hit 32 banks), each lane runs
// its block's recurrence and packs two samples per word into a shared
// tile (rows of 65 words: conflict-free), and the warp writes the tile
// (32 blocks = 8 KB, contiguous in the output) back coalesced.  A second
// launch writes the escape rows, a thread per (row, word of two samples),
// after the blocks on the same stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;              // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kRes = 126;              // residuals per block
constexpr int kOutWords = 64;          // 128 i16 samples per block
constexpr int kTileStride = kOutWords + 1;

__global__ void __launch_bounds__(kThreads)
unpack_blocks_kernel(const uint32_t* __restrict__ buf, long long nb, int w_lo, int bw,
                     long long base_off, int coeff, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int stride = bw | 1;  // odd row stride of the words
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* words = smem + warp * (32 * stride + 32 * kTileStride);
  uint32_t* tile = words + 32 * stride;
  const long long b0 = ((long long)blockIdx.x * kWarps + warp) * 32;
  if (b0 >= nb) return;  // the whole warp
  const int nblk = nb - b0 < 32 ? (int)(nb - b0) : 32;

  const uint32_t* gw = buf + base_off + b0 * bw;
  for (int i = lane; i < nblk * bw; i += 32) {
    const int r = i / bw;
    words[r * stride + (i - r * bw)] = __ldg(gw + i);
  }
  const uint32_t anchor = lane < nblk ? __ldg(buf + b0 + lane) : 0u;
  __syncwarp();

  if (lane < nblk) {
    const uint32_t* w = words + lane * stride;
    uint32_t* t = tile + lane * kTileStride;
    t[0] = anchor;  // samples 0 and 1, as they were packed
    int x0 = (int)(int16_t)(anchor & 0xFFFFu);
    int x1 = (int)(int16_t)(anchor >> 16);
    const unsigned mask = (1u << w_lo) - 1u;
    unsigned low = 0;
    for (int j = 0; j < kRes; ++j) {
      const int bit = j * w_lo, wi = bit >> 5, sh = bit & 31;
      unsigned v = w[wi] >> sh;
      if (sh + w_lo > 32) v |= w[wi + 1] << (32 - sh);
      v &= mask;
      const int r = (int)v - (int)(((v >> (w_lo - 1)) & 1u) << w_lo);
      const int prod = (int)((unsigned)coeff * (unsigned)x1);  // int32 wraparound
      const int xn = (int)((unsigned)(prod >> 14) - (unsigned)x0 + (unsigned)r);
      x0 = x1;
      x1 = xn;
      const unsigned h = (unsigned)xn & 0xFFFFu;  // (int16) xn
      if (j & 1) {
        t[1 + (j >> 1)] = low | (h << 16);
      } else {
        low = h;
      }
    }
  }
  __syncwarp();

  uint32_t* go = out + b0 * kOutWords;
  for (int i = lane; i < nblk * kOutWords; i += 32) go[i] = tile[(i >> 6) * kTileStride + (i & 63)];
}

__global__ void unpack_escapes_kernel(const uint32_t* __restrict__ buf, long long nb, int n_esc_pad,
                                      uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_esc_pad * kOutWords) return;
  const long long row = i / kOutWords, word = i % kOutWords;
  long long idx = (int)buf[nb + row];
  if (idx < 0) idx += nb;
  if (idx < 0 || idx >= nb) return;
  out[idx * kOutWords + word] = buf[nb + n_esc_pad + row * kOutWords + word];
}

}  // namespace

// buf: the sealed words; out: nb * 128 int16 (4-byte aligned).  Launches
// on `stream`, which belongs to the current device.
extern "C" int unpack_sealed(const void* buf, long long nb, int w_lo, int bw, int n_esc_pad, int coeff,
                             void* out, void* stream) {
  if (nb <= 0) return 0;
  if (w_lo < 1 || w_lo > 16 || bw < 1 || bw > 63 || n_esc_pad < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* b = static_cast<const uint32_t*>(buf);
  uint32_t* o = static_cast<uint32_t*>(out);
  const size_t smem = (size_t)kWarps * (32 * (bw | 1) + 32 * kTileStride) * sizeof(uint32_t);
  const long long warps = (nb + 31) / 32;
  const long long grid = (warps + kWarps - 1) / kWarps;
  const long long base_off = nb + (long long)n_esc_pad * (1 + kOutWords);
  unpack_blocks_kernel<<<(unsigned)grid, kThreads, smem, s>>>(b, nb, w_lo, bw, base_off, coeff, o);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_esc_pad == 0) return (int)e;
  const long long n = (long long)n_esc_pad * kOutWords;
  unpack_escapes_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(b, nb, n_esc_pad, o);
  return (int)cudaGetLastError();
}
