// K1: polyphase L/M resample (the port's ingest kernel), three variants.
//
// Replaces: noaa_apt_tpu/ops/resample.py:_blocked_dot, the Pallas
// per-block dot under _fast_resample_matmul and
// _fast_resample_matmul_packed, and the gather-dot regime that the JAX
// package runs outside Pallas (_fast_resample_gather, 11025/22050/44100 Hz).
//
// All compute, for j in [0, out_len) and k = k0 + j = i*l + c (c < l):
//     y[j] = sum_{t<T} bank[p_c[c], t] * x[s_c[c] + i*m + t]
// with x read as 0 at or past n.  x is int16 (converted in-register or
// while staging, so the f32 copy of the recording never exists) or
// float32.
//
// Rounding: one rounding per multiply and per add (__fmul_rn/__fadd_rn,
// built with --fmad=false), taps summed in ascending t from +0.  That is
// the plain twin's order (ops/resample.py:polyphase_resample_plain), so
// every variant is bit-equal to it, and each output depends on k alone,
// so chunked evaluation (any k0/out_len split) is bit-identical to one
// launch.
//
// Dispatch (ops/resample.py:_k1_variant, a pure function of the shape, the
// sample size and the card's opt-in shared memory): "block" for l <= 32
// (the 48 kHz-class rates: 8000 slow, 24000, 32000, 48000, 96000, 192000,
// and the l == 1 path) and "class" for l > 32 (the gather regime
// l = 208..3328 at 11025/22050/37500/44100 Hz and 11011 Hz, l = 39 or 52
// at 8000 Hz, the resample tool's l > 32 shapes), each where its shared
// memory fits the opt-in limit; "phase" for a shape that fits neither
// (float32 x at 192 kHz standard, 250 kHz standard) and for the float32
// shapes where it measured faster on an H100: a block-major CTA that
// leaves at most two an SM with T <= 2m (48000/96000 Hz fast and
// standard, 192000 Hz fast), and l > 32 with m > 4l and the bank in
// shared memory (the tool's 48000 -> 11025 Hz, 88200 Hz).
//
// "phase": one thread per output.  Persistent CTAs walk the outputs with
// a grid stride, so the tap bank (l*T floats) and the phase tables are
// staged into dynamic shared memory once per CTA; a bank too large for
// shared memory is read from global memory (L2-resident) instead.  Each
// multiply-add costs a shared load of the tap, a global load of x and a
// conversion, so the load pipe, not the arithmetic, bounds it.
//
// "block": a thread owns a block i, i.e. the l outputs k = i*l + c, in
// 4G f32 registers (G = 4 for l <= 16, 8 for l <= 32).  It walks the
// relative input position r = 0 .. R-1 (R = max(s_c) + T), loads
// x[i*m + r] once and multiplies it into every output whose window holds
// r, with the tap W[r, c] = bank[p_c[c], r - s_c[c]] (0 outside the
// window).  W does not depend on i, so a warp reads the same W row: a
// broadcast 16-byte shared load gives four columns.  live[r] has bit g set
// when any of W[r, 4g..4g+3] is nonzero; dead groups are skipped by a
// warp-uniform branch.  The extra products by a zero tap leave each sum
// unchanged while x is finite, so w*x is +-0; an accumulator that starts
// at +0 never becomes -0 under round-to-nearest, so acc + (+-0) is acc
// exactly, before a window opens and after it closes.  A CTA owns 256
// consecutive blocks, NB per thread (blocks_per_thread): it stages its
// input span x[I0*m, (I0+255)*m + R) into shared memory in 16-byte loads
// (zero at or past n; int16 stays int16, 8 samples a load, float32 4),
// the W table and the live mask, and after the r loop writes the sums to
// a y tile over the span, which it stores contiguously.  No per-output
// divide; 64-bit only for the span.  With float32 x, 0*x is NaN for an
// inf or a NaN: staging ORs a non-finite test over the span into the
// barrier (__syncthreads_or), and a CTA whose span holds one sums each
// output's own T taps, W[s_c[c] + t, c] in ascending t, as the twin does
// (the zero taps inside the window included).  Only such CTAs take that
// path, so a finite recording never pays for it.
// For l <= 8 (the l == 1 path of the rates that are a multiple of the work
// rate, and l = 2..8) the wrapper folds b <= 16/l blocks into one of b*l
// outputs at stride b*m (ops/resample.py:k1_block_fold), so that a thread's
// 16 accumulators hold live outputs; the kernel sees an ordinary l and m.
// b is the one whose stride spreads a warp's span reads over the most
// banks for the sample size (k1_fold_blocks): at l == 1, m == 2, b = 16
// puts all lanes on one bank with float32 (16-way with int16), b = 15 on
// 16 banks (all 32 with int16).
//
// "class": a thread owns one output class c and walks blocks i; its taps
// bank[p_c[c], .] are the same in every block.  A CTA is 128 consecutive
// classes [c0, c0+128) (blockIdx.y) by 32 consecutive blocks (blockIdx.x),
// not persistent.  Shared memory holds only x, as f32 (int16 converted
// once while staging, float32 copied): per block, the segment
// x[i*m + s_c[c0] + q] for q < seg
// (0 at or past n), in a row of S >= seg floats (K1_CLASS_STRIDES), so
// 4*32*S bytes (class_smem; 16 KB at 11025 Hz slow, 74 KB at most,
// 44100 Hz standard).  seg = max over 128-class tiles of
// (s_c[last] - s_c[first]) + T, from the host.  A thread stages sample q
// of 8 segments at once, so 8 loads are in flight, not one per block.
// s_c[c] = ceil(c*m/l) is nondecreasing, so lane c reads seg[off_c + t]
// with off_c = s_c[c] - s_c[c0]: a warp's 32 reads are nearly
// consecutive words (conflict-free for m < l; up to 2-way at 22050 Hz,
// 4-way at 37500/44100 Hz).  The taps come from the class-major table
// wc[t*l + c] (ops/resample.py:k1_class_table) in global memory: one
// coalesced 128-byte row per warp and tap.  Each thread holds the sums
// of all 32 blocks in registers (kClassGroup), so one tap load serves 32
// multiply-adds, and each multiply-add is one shared load (at a
// compile-time offset from one base register), one multiply and one add:
// no divide, 64-bit only for the segment base.  Each thread multiplies
// exactly the twin's products (bank[p_c[c], t] * x for every t < T,
// trailing zero taps included, in ascending t), so it is bit-equal for
// any float32 input, inf and NaN too.  Threads with c >= l stage
// but compute nothing (they pass the one barrier).  Holding 8 or 16 sums
// and reloading the taps per group, staging one load at a time, and
// staging the taps in shared memory or holding them in registers, and a
// runtime row stride all ran slower on an H100
// (tools/kernel_ab.py).
//
// Bound on an H100 (chip_smoke.py computes it per run): at 48 kHz
// standard, bytes are 57.6 MB in and 30 MB out (0.026 ms at 3.35 TB/s),
// operations 2 per live multiply-add, 1.1 G (0.033 ms at 33.5 T op/s,
// since --fmad=false issues the multiply and the add apart).  The block
// variant also multiplies the zero taps of its live groups (10.9 of 16
// slots per r at 48 kHz standard) and issues about 30 instructions per r
// per block, of which about 22 are the multiplies and adds: instruction
// issue and shared-memory loads bound it, not HBM.  At 11025 Hz slow the
// class variant does 624 M multiply-adds (the bank's trailing zero taps
// included, as the twin sums them); its operation bound (live taps) is
// 0.037 ms, and its shared loads (one per multiply-add, at one warp load
// per clock per SM) put it near 0.084 ms: shared-load issue bounds it.
// At 11025 Hz fast (T = 6) the staging and the launch, not the
// multiply-adds, take most of its time.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T, bool kSmem>
__global__ void __launch_bounds__(kThreads)
polyphase_kernel(const T* __restrict__ x, long long n,
                 const float* __restrict__ bank, const int* __restrict__ p_c,
                 const int* __restrict__ s_c, int l, int taps, long long m,
                 long long k0, long long out_len, float* __restrict__ y) {
  extern __shared__ float smem[];
  const float* b = bank;
  const int* pc = p_c;
  const int* sc = s_c;
  if (kSmem) {
    float* sb = smem;
    int* spc = reinterpret_cast<int*>(smem + (long long)l * taps);
    int* ssc = spc + l;
    for (int i = threadIdx.x; i < l * taps; i += blockDim.x) sb[i] = bank[i];
    for (int i = threadIdx.x; i < l; i += blockDim.x) {
      spc[i] = p_c[i];
      ssc[i] = s_c[i];
    }
    __syncthreads();
    b = sb;
    pc = spc;
    sc = ssc;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < out_len; j += stride) {
    const long long k = k0 + j;
    const int c = static_cast<int>(k % l);
    const long long x0 = sc[c] + (k / l) * m;
    const float* row = b + (long long)pc[c] * taps;
    float acc = 0.f;
    if (x0 + taps <= n) {
      for (int t = 0; t < taps; ++t) acc = __fadd_rn(acc, __fmul_rn(row[t], to_f32(x[x0 + t])));
    } else {
      for (int t = 0; t < taps; ++t) {
        const long long q = x0 + t;
        const float xv = q < n ? to_f32(x[q]) : 0.f;
        acc = __fadd_rn(acc, __fmul_rn(row[t], xv));
      }
    }
    y[j] = acc;
  }
}

template <typename T, bool kSmem>
cudaError_t launch(const void* x, long long n, const float* bank, const int* p_c,
                   const int* s_c, int l, int taps, long long m, long long k0,
                   long long out_len, float* y, size_t smem, cudaStream_t stream) {
  auto kern = polyphase_kernel<T, kSmem>;
  cudaError_t e;
  if (kSmem && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, kSmem ? smem : 0);
  if (e != cudaSuccess) return e;
  const long long need = (out_len + kThreads - 1) / kThreads;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > need) grid = need;
  kern<<<(unsigned)grid, kThreads, kSmem ? smem : 0, stream>>>(
      static_cast<const T*>(x), n, bank, p_c, s_c, l, taps, m, k0, out_len, y);
  return cudaGetLastError();
}

// ---- block-major variant ----------------------------------------------

constexpr int kCtaBlocks = 256;  // blocks of l outputs a CTA owns

constexpr size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

// The samples a CTA stages: thread 255 reads up to (255*m + R - 1).
constexpr long long block_span(long long m, int R) { return (kCtaBlocks - 1) * m + R; }

// The span of xb-byte samples, staged from the 16-byte boundary at or
// below its first sample (up to 16/xb - 1 samples more), then (after the
// r loop) the y tile of kCtaBlocks*l floats.
constexpr size_t block_tile_bytes(int l, long long m, int R, int xb) {
  return align16(xb * (size_t)(block_span(m, R) + 16 / xb - 1) > 4 * (size_t)kCtaBlocks * l
                     ? xb * (size_t)(block_span(m, R) + 16 / xb - 1) : 4 * (size_t)kCtaBlocks * l);
}

// Dynamic shared memory: W [R][G] float4, the span/y tile, live [R] bytes.
// Mirrored by ops/resample.py:k1_block_smem.
constexpr size_t block_smem(int l, long long m, int R, int G, int xb) {
  return 16 * (size_t)R * G + block_tile_bytes(l, m, R, xb) + (size_t)R;
}

// True for inf and NaN: the exponent field is all ones.
__device__ __forceinline__ bool non_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// Blocks per thread, NB: a thread owns blocks t, t + 256/NB, ... of its
// CTA, so one W load and one live test serve NB blocks.  NB = 2 for G = 4
// (55 registers); G = 8 keeps NB = 1, since NB = 2 takes 80 registers and
// ran slower at 48 kHz fast (tools/kernel_ab.py on an H100).
constexpr int blocks_per_thread(int G) { return G == 4 ? 2 : 1; }

template <typename T, int G, int NB>
__global__ void __launch_bounds__(kCtaBlocks / NB)
block_kernel(const T* __restrict__ x, long long n, const float4* __restrict__ w,
             const uint8_t* __restrict__ live, const int* __restrict__ s_f, int taps, int R, int l,
             int m, long long i_first, long long k0, long long out_len, int span, int tile_bytes,
             float* __restrict__ y) {
  constexpr int kT = kCtaBlocks / NB;  // threads in the CTA
  constexpr int kPer = 16 / sizeof(T);  // samples per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* s_w = reinterpret_cast<float4*>(smem_raw);
  T* s_x = reinterpret_cast<T*>(smem_raw + 16 * R * G);
  float* s_y = reinterpret_cast<float*>(s_x);
  uint8_t* s_live = smem_raw + 16 * R * G + tile_bytes;

  const long long i0 = i_first + (long long)blockIdx.x * kCtaBlocks;
  const long long base = i0 * m;
  for (int q = threadIdx.x; q < R * G; q += kT) s_w[q] = __ldg(w + q);
  for (int q = threadIdx.x; q < R; q += kT) s_live[q] = __ldg(live + q);
  // The span in 16-byte loads from the boundary at or below x + base: a
  // chunk wholly inside x[0, n) is one load, any other goes sample by
  // sample, with 0 outside x (so x reads as 0 at or past n).  Float input
  // also notes whether the CTA staged an inf or a NaN.
  const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
  const uintptr_t x_hi = reinterpret_cast<uintptr_t>(x + n);
  const uintptr_t first = x_lo + sizeof(T) * (uintptr_t)base;
  const uintptr_t start = first & ~uintptr_t(15);
  const int shift = static_cast<int>(first - start) / (int)sizeof(T);  // samples, 0..kPer-1
  const int chunks = (shift + span + kPer - 1) / kPer;
  uint4* s_x4 = reinterpret_cast<uint4*>(s_x);
  bool bad = false;
#pragma unroll 4
  for (int q = threadIdx.x; q < chunks; q += kT) {
    const uintptr_t a = start + 16 * (uintptr_t)q;
    if (a >= x_lo && a + 16 <= x_hi) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a));
      s_x4[q] = v;
      if constexpr (sizeof(T) == 4) {
        bad |= non_finite(__uint_as_float(v.x)) | non_finite(__uint_as_float(v.y)) |
               non_finite(__uint_as_float(v.z)) | non_finite(__uint_as_float(v.w));
      }
    } else {
      T* dst = reinterpret_cast<T*>(s_x4 + q);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const uintptr_t aj = a + sizeof(T) * j;
        const T v = aj >= x_lo && aj < x_hi ? *reinterpret_cast<const T*>(aj) : T(0);
        dst[j] = v;
        if constexpr (sizeof(T) == 4) bad |= non_finite(v);
      }
    }
  }
  const bool exact = __syncthreads_or(bad);  // the same in every thread of the CTA

  float acc[NB][4 * G];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[b][c] = 0.f;
  const T* xr = s_x + shift + threadIdx.x * m;
  if (!exact) {
    // Every product by a zero tap outside a window is +-0 (x is finite)
    // and leaves its sum unchanged.
    for (int r = 0; r < R; ++r) {
      float xv[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) xv[b] = to_f32(xr[b * kT * m + r]);
      const unsigned lv = s_live[r];
      const float4* wr = s_w + r * G;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (lv & (1u << g)) {  // the same bit in every lane: no divergence
          const float4 wv = wr[g];
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            acc[b][4 * g + 0] = __fadd_rn(acc[b][4 * g + 0], __fmul_rn(wv.x, xv[b]));
            acc[b][4 * g + 1] = __fadd_rn(acc[b][4 * g + 1], __fmul_rn(wv.y, xv[b]));
            acc[b][4 * g + 2] = __fadd_rn(acc[b][4 * g + 2], __fmul_rn(wv.z, xv[b]));
            acc[b][4 * g + 3] = __fadd_rn(acc[b][4 * g + 3], __fmul_rn(wv.w, xv[b]));
          }
        }
      }
    }
  } else if constexpr (sizeof(T) == 4) {
    // An inf or a NaN in the span: 0 * x would not vanish, so each output
    // sums exactly its own T taps, W[s_f[c] + t, c] = bank[p_c[c], t], in
    // ascending t, as the plain twin does (trailing zero taps included).
    const float* s_wf = reinterpret_cast<const float*>(s_w);
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) {
      if (c < l) {
        const int sc = __ldg(s_f + c);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float* xs = xr + b * kT * m + sc;
          float a = 0.f;
          for (int t = 0; t < taps; ++t) a = __fadd_rn(a, __fmul_rn(s_wf[(sc + t) * 4 * G + c], xs[t]));
          acc[b][c] = a;
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the span: the y tile goes over it
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c)
      if (c < l) s_y[(threadIdx.x + b * kT) * l + c] = acc[b][c];
  __syncthreads();

  // This CTA's outputs: k in [i0*l, (i0+256)*l) within [k0, k0 + out_len).
  const long long kb = i0 * l;
  const long long lo = kb > k0 ? kb : k0;
  const long long end = k0 + out_len;
  const long long hi = kb + (long long)kCtaBlocks * l < end ? kb + (long long)kCtaBlocks * l : end;
  for (long long k = lo + threadIdx.x; k < hi; k += kT) y[k - k0] = s_y[k - kb];
}

template <typename T, int G>
cudaError_t launch_block(const T* x, long long n, const float4* w, const uint8_t* live, const int* s_f,
                         int taps, int R, int l, long long m, long long k0, long long out_len, float* y,
                         cudaStream_t stream) {
  constexpr int NB = blocks_per_thread(G);
  auto kern = block_kernel<T, G, NB>;
  const size_t smem = block_smem(l, m, R, G, sizeof(T));
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long i_first = k0 / l;
  const long long blocks = (k0 + out_len - 1) / l + 1 - i_first;
  const long long grid = (blocks + kCtaBlocks - 1) / kCtaBlocks;
  kern<<<(unsigned)grid, kCtaBlocks / NB, smem, stream>>>(
      x, n, w, live, s_f, taps, R, l, (int)m, i_first, k0, out_len, (int)block_span(m, R),
      (int)block_tile_bytes(l, m, R, sizeof(T)), y);
  return cudaGetLastError();
}

// ---- class-major variant ------------------------------------------------

constexpr int kClassThreads = 128;  // classes a CTA owns, one per thread
constexpr int kClassBlocks = 32;    // blocks a CTA owns
constexpr int kClassGroup = 32;     // blocks whose sums a thread holds at once

// The row strides of the staged segments, one kernel per stride: a shape
// takes the least stride S >= seg, so that the 32 shared loads of one tap
// are one base register plus compile-time offsets b*S (a runtime stride
// costs an address add per load: 10-15% slower on an H100,
// tools/kernel_ab.py).  1816 = the opt-in limit / (4*32).  Mirrored by
// ops/resample.py:K1_CLASS_STRIDES.
#define K1_CLASS_STRIDES(X) X(32) X(64) X(96) X(128) X(160) X(192) X(256) X(320) X(384) \
  X(448) X(512) X(576) X(640) X(768) X(1024) X(1280) X(1816)

// Dynamic shared memory: one f32 row of S floats per block.  Mirrored by
// ops/resample.py:k1_class_smem.
constexpr size_t class_smem(int stride) { return sizeof(float) * kClassBlocks * (size_t)stride; }

template <typename T, int kStride>
__global__ void __launch_bounds__(kClassThreads)
class_kernel(const T* __restrict__ x, long long n, const float* __restrict__ wc,
             const int* __restrict__ s_c, int l, int taps, long long m, int seg,
             long long i_first, long long k0, long long out_len, float* __restrict__ y) {
  extern __shared__ float s_x[];
  const int c0 = blockIdx.y * kClassThreads;
  const int c = c0 + threadIdx.x;
  const long long i0 = i_first + (long long)blockIdx.x * kClassBlocks;
  // Stage sample q of the 32 segments 8 at a time: 8 independent loads in
  // flight per thread, not one latency per block.
  const long long base = i0 * m + __ldg(s_c + c0);
  for (int q = threadIdx.x; q < seg; q += kClassThreads) {
#pragma unroll 1
    for (int b0 = 0; b0 < kClassBlocks; b0 += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long p = base + (b0 + j) * m + q;
        v[j] = p < n ? to_f32(__ldg(x + p)) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s_x[(b0 + j) * kStride + q] = v[j];
    }
  }
  __syncthreads();  // the only barrier: threads with c >= l leave after it
  if (c >= l) return;

  // The sums of kClassGroup blocks in registers: per tap, one tap load
  // serves kClassGroup multiply-adds, each one shared load, one multiply
  // and one add.
  const int off = __ldg(s_c + c) - __ldg(s_c + c0);
  const long long k_end = k0 + out_len;
  for (int g = 0; g < kClassBlocks; g += kClassGroup) {
    if ((i0 + g) * l >= k_end) break;  // the same in every lane
    float acc[kClassGroup];
#pragma unroll
    for (int b = 0; b < kClassGroup; ++b) acc[b] = 0.f;
    const float* xs = s_x + g * kStride + off;
    const float* wp = wc + c;
#pragma unroll 4
    for (int t = 0; t < taps; ++t) {
      const float w = __ldg(wp + (long long)t * l);
#pragma unroll
      for (int b = 0; b < kClassGroup; ++b) acc[b] = __fadd_rn(acc[b], __fmul_rn(w, xs[b * kStride + t]));
    }
#pragma unroll
    for (int b = 0; b < kClassGroup; ++b) {
      const long long k = (i0 + g + b) * l + c;
      if (k >= k0 && k < k_end) y[k - k0] = acc[b];
    }
  }
}

template <typename T, int kStride>
cudaError_t launch_class(const T* x, long long n, const float* wc, const int* s_c, int l,
                         int taps, long long m, int seg, long long k0, long long out_len, float* y,
                         cudaStream_t stream) {
  auto kern = class_kernel<T, kStride>;
  const size_t smem = class_smem(kStride);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long i_first = k0 / l;
  const long long blocks = (k0 + out_len - 1) / l + 1 - i_first;
  const dim3 grid((unsigned)((blocks + kClassBlocks - 1) / kClassBlocks),
                  (unsigned)((l + kClassThreads - 1) / kClassThreads));
  kern<<<grid, kClassThreads, smem, stream>>>(x, n, wc, s_c, l, taps, m, seg, i_first, k0, out_len, y);
  return cudaGetLastError();
}

}  // namespace

// The largest dynamic shared memory a block of the current device may opt
// in to (bytes), for the wrapper's dispatch.
extern "C" int resample_smem_optin(int* bytes) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Launches on `stream`, which belongs to the current device (the
// wrapper makes x's device current).
extern "C" int polyphase_resample(const void* x, int x_is_i16, long long n,
                                  const void* bank, const void* p_c, const void* s_c,
                                  int l, int taps, long long m, long long k0,
                                  long long out_len, void* y, void* stream) {
  if (out_len <= 0) return 0;
  int device = 0, max_optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)l * taps * sizeof(float) + 2 * (size_t)l * sizeof(int);
  const bool in_smem = smem <= (size_t)max_optin;
  const float* b = static_cast<const float*>(bank);
  const int* pc = static_cast<const int*>(p_c);
  const int* sc = static_cast<const int*>(s_c);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_i16) {
    e = in_smem ? launch<int16_t, true>(x, n, b, pc, sc, l, taps, m, k0, out_len, out, smem, st)
                : launch<int16_t, false>(x, n, b, pc, sc, l, taps, m, k0, out_len, out, 0, st);
  } else {
    e = in_smem ? launch<float, true>(x, n, b, pc, sc, l, taps, m, k0, out_len, out, smem, st)
                : launch<float, false>(x, n, b, pc, sc, l, taps, m, k0, out_len, out, 0, st);
  }
  return (int)e;
}

// The block-major variant: int16 or float32 x, the W table w[R][4G] and
// live[R] of ops/resample.py:k1_block_table, G = 4 (l <= 16) or 8
// (l <= 32), and the launch's first input offsets s_f[l] (after
// ops/resample.py:k1_block_fold) with the taps T of each output, which a
// CTA whose float span holds an inf or a NaN sums exactly.  Returns
// cudaErrorInvalidValue for any other G or l.
extern "C" int polyphase_resample_block(const void* x, int x_is_i16, long long n, const void* w,
                                        const void* live, const void* s_f, int taps, int G, int R,
                                        int l, long long m, long long k0, long long out_len, void* y,
                                        void* stream) {
  if (out_len <= 0) return 0;
  if (l < 1 || l > 4 * G || R < 1 || taps < 1) return (int)cudaErrorInvalidValue;
  const float4* ws = static_cast<const float4*>(w);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  const int* sf = static_cast<const int*>(s_f);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_BLOCK(T, GG) \
  return (int)launch_block<T, GG>(static_cast<const T*>(x), n, ws, lv, sf, taps, R, l, m, k0, out_len, out, st)
  if (G == 4) {
    if (x_is_i16) K1_BLOCK(int16_t, 4);
    K1_BLOCK(float, 4);
  }
  if (G == 8) {
    if (x_is_i16) K1_BLOCK(int16_t, 8);
    K1_BLOCK(float, 8);
  }
#undef K1_BLOCK
  return (int)cudaErrorInvalidValue;
}

// The class-major variant: int16 or float32 x, the tap table wc[T][l] of
// ops/resample.py:k1_class_table and its segment length seg.
extern "C" int polyphase_resample_class(const void* x, int x_is_i16, long long n, const void* wc,
                                        const void* s_c, int l, int taps, long long m, int seg,
                                        long long k0, long long out_len, void* y, void* stream) {
  if (out_len <= 0) return 0;
  if (l < 1 || taps < 1 || seg < taps) return (int)cudaErrorInvalidValue;
  const float* w = static_cast<const float*>(wc);
  const int* sc = static_cast<const int*>(s_c);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_LAUNCH(S)                                                                                  \
  if (seg <= S) {                                                                                   \
    if (x_is_i16)                                                                                   \
      return (int)launch_class<int16_t, S>(static_cast<const int16_t*>(x), n, w, sc, l, taps, m, seg, \
                                           k0, out_len, out, st);                                    \
    return (int)launch_class<float, S>(static_cast<const float*>(x), n, w, sc, l, taps, m, seg, k0,   \
                                       out_len, out, st);                                            \
  }
  K1_CLASS_STRIDES(K1_LAUNCH)
#undef K1_LAUNCH
  return (int)cudaErrorInvalidValue;  // seg past the largest stride
}
