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
// Bound on an H100: bytes.  4 B in and 8 B out per sample (~90 MB for a
// 10-minute pass at 12480 Hz) against ~20 + 2k + g flops per sample.
// Design: one CTA per tile of TILE outputs.  The CTA stages y over
// [start-k, start+TILE+g-1) in shared memory, computes dem and then filt
// there (both stay on-chip: the two intermediates never touch device
// memory), writes filt, then correlates from shared memory.  The halo
// recompute costs (k+g)/TILE (<= 12% at the slow profile).  The +-1
// template is a per-j add or subtract, uniform across the CTA (no
// divergence).
//
// Rounding: every multiply/add/sub rounds once (__fmul_rn/__fadd_rn/
// __fsub_rn, --fmad=false), FIR taps summed in ascending j starting from
// taps[0]*dem[t], correlation in ascending j starting from +-filt[u]:
// the order of the plain twin (ops/stage.py:demod_fir_corr_plain), so
// the two are bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
demod_fir_corr_kernel(const float* __restrict__ y, long long n,
                      const float* __restrict__ taps, int k,
                      const signed char* __restrict__ tmpl, int g,
                      float cosphi2, float inv_sinphi,
                      float* __restrict__ filt, float* __restrict__ corr) {
  extern __shared__ float smem[];
  const int dlen = kTile + g + k - 2;  // dem over [base_d, base_d + dlen)
  const int flen = kTile + g - 1;      // filt over [start, start + flen)
  float* ys = smem;                    // y over [base_d - 1, base_d + dlen)
  float* ds = ys + dlen + 1;
  float* fs = ds + dlen;
  float* ts = fs + flen;
  signed char* ss = reinterpret_cast<signed char*>(ts + k);

  const long long start = (long long)blockIdx.x * kTile;
  const long long base_d = start - (k - 1);
  const int tid = threadIdx.x;

  for (int i = tid; i < k; i += blockDim.x) ts[i] = taps[i];
  for (int i = tid; i < g; i += blockDim.x) ss[i] = tmpl[i];
  for (int i = tid; i <= dlen; i += blockDim.x) {
    const long long t = base_d - 1 + i;
    ys[i] = (t >= 0 && t < n) ? y[t] : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < dlen; i += blockDim.x) {
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

  for (int i = tid; i < flen; i += blockDim.x) {
    const long long t = start + i;
    float acc = 0.f;
    if (t < n) {
      const float* dp = ds + i + (k - 1);  // dp[-j] = dem[t - j]
      acc = __fmul_rn(ts[0], dp[0]);
      for (int j = 1; j < k; ++j) acc = __fadd_rn(acc, __fmul_rn(ts[j], dp[-j]));
      if (i < kTile) filt[t] = acc;
    }
    fs[i] = acc;
  }
  __syncthreads();

  for (int i = tid; i < kTile; i += blockDim.x) {
    const long long u = start + i;
    if (u >= n) break;
    const float* fp = fs + i;
    float acc = ss[0] > 0 ? fp[0] : -fp[0];
    for (int j = 1; j < g; ++j) acc = ss[j] > 0 ? __fadd_rn(acc, fp[j]) : __fsub_rn(acc, fp[j]);
    corr[u] = acc;
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
  const size_t smem = (size_t)(2 * dlen + 1 + (kTile + g - 1) + k) * sizeof(float) + (size_t)g;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        demod_fir_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (n + kTile - 1) / kTile;
  demod_fir_corr_kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), n, static_cast<const float*>(taps), k,
      static_cast<const signed char*>(tmpl), g, cosphi2, inv_sinphi,
      static_cast<float*>(filt), static_cast<float*>(corr));
  return (int)cudaGetLastError();
}
