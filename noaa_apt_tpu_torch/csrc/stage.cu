// K2: fused AM demodulation -> causal post-demod FIR -> +-1 sync correlation.
//
// Replaces: noaa_apt_tpu/ops/pallas_stage.py:make_demod_fir_corr (the
// Pallas kernel over a haloed [rows, 128] tile).
//
// Computes, over a work-rate signal y[0, n):
//     dem[t]  = det_sqrt(max(p*p + c*c - (p*c)*cosphi2, 0)) * inv_sinphi,
//               p = y[t-1], c = y[t];  dem[0] = 0, dem[t < 0] = 0
//     filt[t] = sum_{j<k} taps[j] * dem[t-j]                   (t < n)
//     corr[u] = sum_{j<g} tmpl[j] * filt[u+j],  filt[t >= n] = 0
// The demod follows noaa_apt_tpu/ops/demod.py:demod_body (the CPU path
// that minted the goldens), not the Pallas body's sqrt(...)/sinphi:
// det_sqrt is the 0x5F3759DF seed plus three Newton steps, and the
// division is a multiply by the host-rounded reciprocal.
//
// Bound on an H100: issue.  4 B in and 8 B out per sample (~90 MB, about
// 27 us, for a 10-minute pass at 12480 Hz), against ~21 + 2k - 1 + g - 1
// multiplies and adds per sample, each issued on its own (--fmad=false):
// ~207 for the standard profile, ~46 us at 33.5 T op/s.
// Design: tiles of kTile = kThreads * kR outputs.  For a tile, a CTA
// stages y over [start-k, start+kTile+g-1) in shared memory (cp.async,
// all copies in flight together), computes dem and then filt there (both
// stay on-chip: the two intermediates never touch device memory), then
// correlates from shared memory and writes filt and corr back coalesced
// through shared memory.  The halo recompute costs (k+g)/kTile (<= 11% at
// the slow profile).  The CTAs are persistent, as many as fit on the
// card, and double-buffer y: a tile's copy overlaps the previous tile's
// arithmetic (with one CTA per tile the load and compute phases of the
// card's CTAs did not overlap).
// Register blocking: a thread computes kR consecutive outputs of the FIR
// and of the correlation, kU taps per step.  Per step it loads the
// kR + kU - 1 values those outputs need into registers, the kU taps (or
// +-1.0 template signs) as one broadcast float4, and does kR * kU
// products: ~0.33 shared loads per tap and output instead of 2.  kR is
// odd, so the lanes' strided window loads hit 32 different banks.
// The +-1 correlation term is __fmaf_rn(+-1.0f, f, acc): the product is
// exact, so it rounds once, exactly as acc + f or acc - f.
//
// Rounding: every multiply/add/sub rounds once (__fmul_rn/__fadd_rn/
// __fsub_rn, --fmad=false), FIR taps summed in ascending j starting from
// taps[0]*dem[t], correlation in ascending j starting from +-filt[u]:
// the order of the plain twin (ops/stage.py:demod_fir_corr_plain), so
// the two are bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 9;                 // outputs per thread (odd: no bank conflicts)
constexpr int kU = 4;                 // taps per register step (one float4)
constexpr int kTile = kThreads * kR;  // 2304 outputs per CTA
constexpr int kWin = kR + kU - 1;     // register window of one step

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// noaa_apt_tpu/ops/demod.py:_det_sqrt, bit for bit (x >= 0).
__device__ __forceinline__ float det_sqrt(float x) {
  const int i = __float_as_int(x);
  float y = __int_as_float(0x5F3759DF - (i >> 1));
  const float hx = __fmul_rn(0.5f, x);
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const float v = __fmul_rn(__fmul_rn(hx, y), y);
    y = __fmul_rn(y, __fsub_rn(1.5f, v));
  }
  return __fmul_rn(x, y);
}

__device__ __forceinline__ float lane_of(const float4& q, int u) {
  return u == 0 ? q.x : u == 1 ? q.y : u == 2 ? q.z : q.w;
}

// Copy y over [base_d - 1, base_d + dlen) of a tile into `ys`, every
// copy in flight at once; positions outside [0, n) are zero-filled, not
// read.  One cp.async group.
__device__ __forceinline__ void load_tile(float* ys, const float* __restrict__ y, long long n,
                                          long long base_d, int dlen) {
  for (int i = threadIdx.x; i <= dlen; i += kThreads) {
    const long long t = base_d - 1 + i;
    const bool in = t >= 0 && t < n;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(ys + i)),
                 "l"(y + (in ? t : 0)), "r"(in ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ...; the next tile's y
// is in flight (the other half of a double buffer) while this one is
// computed, so loads overlap compute.
__global__ void __launch_bounds__(kThreads)
demod_fir_corr_kernel(const float* __restrict__ y, long long n, long long n_tiles,
                      const float* __restrict__ taps, int k,
                      const signed char* __restrict__ tmpl, int g,
                      float cosphi2, float inv_sinphi,
                      float* __restrict__ filt, float* __restrict__ corr) {
  extern __shared__ float4 smem4[];
  const int dlen = kTile + g + k - 2;  // dem over [base_d, base_d + dlen)
  const int flen = kTile + g - 1;      // filt over [start, start + flen)
  float* tq = reinterpret_cast<float*>(smem4);  // taps[1..k), zero-padded to 4
  float* sq = tq + round4(k - 1);      // +-1.0 of tmpl[1..g), zero-padded to 4
  float* ybuf = sq + round4(g - 1);   // two y tiles of dlen + 1, double-buffered
  float* ds = ybuf + 2 * (dlen + 1);   // dem over the tile
  float* fs = ds + dlen;               // filt over the tile
  float* cs = ds;                      // corr of the tile (dem is dead by then)
  const int tid = threadIdx.x;

  for (int i = tid; i < round4(k - 1); i += kThreads) tq[i] = i + 1 < k ? taps[i + 1] : 0.f;
  for (int i = tid; i < round4(g - 1); i += kThreads)
    sq[i] = i + 1 < g ? (tmpl[i + 1] > 0 ? 1.f : -1.f) : 0.f;
  const float tap0 = taps[0];
  const bool pos0 = tmpl[0] > 0;

  long long tile = blockIdx.x;
  if (tile < n_tiles) load_tile(ybuf, y, n, tile * kTile - (k - 1), dlen);
  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long start = tile * kTile;
    const long long base_d = start - (k - 1);
    const float* ys = ybuf + buf * (dlen + 1);
    const long long next = tile + gridDim.x;
    if (next < n_tiles) {
      load_tile(ybuf + (buf ^ 1) * (dlen + 1), y, n, next * kTile - (k - 1), dlen);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    for (int i = tid; i < dlen; i += kThreads) {
      const long long t = base_d + i;
      float d = 0.f;
      if (t > 0 && t < n) {
        const float p = ys[i], c = ys[i + 1];
        const float p2 = __fmul_rn(p, p), c2 = __fmul_rn(c, c), pc = __fmul_rn(p, c);
        const float body = __fsub_rn(__fadd_rn(p2, c2), __fmul_rn(pc, cosphi2));
        d = __fmul_rn(det_sqrt(body > 0.f ? body : 0.f), inv_sinphi);
      }
      ds[i] = d;
    }
    __syncthreads();

    // FIR: outputs [i0, i0 + kR) of filt; dp[r - j] = dem[start + i0 + r - j].
    for (int i0 = tid * kR; i0 < flen; i0 += kThreads * kR) {
      const float* dp = ds + i0 + (k - 1);
      float acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = __fmul_rn(tap0, dp[r]);
      int j = 1;
      for (; j + kU <= k; j += kU) {  // taps j .. j + kU - 1
        const float4 t4 = *reinterpret_cast<const float4*>(tq + j - 1);
        float e[kWin];  // e[m] = dp[m - j - (kU - 1)]
#pragma unroll
        for (int m = 0; m < kWin; ++m) e[m] = dp[m - j - (kU - 1)];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float tu = lane_of(t4, u);
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(tu, e[r - u + kU - 1]));
        }
      }
      for (; j < k; ++j) {
        const float tj = tq[j - 1];
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(tj, dp[r - j]));
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (i0 + r < flen) fs[i0 + r] = start + i0 + r < n ? acc[r] : 0.f;
    }
    __syncthreads();

    // Correlation: outputs [i0, i0 + kR) of the tile; fp[r + j] = filt[start + i0 + r + j].
    {
      const int i0 = tid * kR;
      const float* fp = fs + i0;
      float acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = pos0 ? fp[r] : -fp[r];
      int j = 1;
      for (; j + kU <= g; j += kU) {
        const float4 s4 = *reinterpret_cast<const float4*>(sq + j - 1);
        float e[kWin];  // e[m] = fp[j + m]
#pragma unroll
        for (int m = 0; m < kWin; ++m) e[m] = fp[j + m];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float su = lane_of(s4, u);
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r] = __fmaf_rn(su, e[r + u], acc[r]);
        }
      }
      for (; j < g; ++j) {
        const float sj = sq[j - 1];
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[r] = __fmaf_rn(sj, fp[r + j], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) cs[i0 + r] = acc[r];
    }
    __syncthreads();

    for (int i = tid; i < kTile; i += kThreads) {
      const long long t = start + i;
      if (t >= n) break;
      __stcs(filt + t, fs[i]);  // evict-first: K3 reads corr next, filt much later
      corr[t] = cs[i];
    }
    __syncthreads();  // fs and cs are rewritten by the next tile
  }
}

}  // namespace

// Launches on `stream`, which belongs to the current device (the
// wrapper makes y's device current).
extern "C" int demod_fir_corr(const void* y, long long n, const void* taps, int k,
                              const void* tmpl, int g, float cosphi2, float inv_sinphi,
                              void* filt, void* corr, void* stream) {
  if (n <= 0) return 0;
  const int dlen = kTile + g + k - 2;
  const size_t smem =
      (size_t)(round4(k - 1) + round4(g - 1) + 3 * dlen + 2 + (kTile + g - 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        demod_fir_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // As many CTAs as fit on the card at once, each looping over tiles.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, demod_fir_corr_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long grid = n_tiles < (long long)sms * per_sm ? n_tiles : (long long)sms * per_sm;
  demod_fir_corr_kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), n, n_tiles, static_cast<const float*>(taps), k,
      static_cast<const signed char*>(tmpl), g, cosphi2, inv_sinphi,
      static_cast<float*>(filt), static_cast<float*>(corr));
  return (int)cudaGetLastError();
}
