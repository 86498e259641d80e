// K1: direct polyphase L/M resample (the port's ingest kernel).
//
// Replaces: noaa_apt_tpu/ops/resample.py:_blocked_dot, the Pallas
// per-block dot under _fast_resample_matmul and
// _fast_resample_matmul_packed, and the gather-dot regime that the JAX
// package runs outside Pallas (_fast_resample_gather, 11025/22050/44100 Hz).
//
// Computes, for j in [0, out_len) and k = k0 + j:
//     y[j] = sum_{t<T} bank[p_k, t] * x[x0_k + t]
//     p_k = p_c[k mod l],  x0_k = s_c[k mod l] + (k div l) * m
// with x read as 0 at or past n.  x is int16 (converted in-register, so
// the f32 copy of the recording never exists) or float32.
//
// Bound on an H100: bytes.  Each output reads T inputs, but neighbouring
// outputs share them (x0 advances m/l samples per output), so the work
// must move the input once and the output once: for a 10-minute 48 kHz
// i16 pass 57.6 MB in and 30 MB out, against ~1.1 GFLOP of multiply-adds.
// The packed TPU dot spent ~99% of its MACs on zeros; this kernel does
// only the T taps of each output's phase.
//
// Design: one thread per output.  Persistent CTAs walk the outputs with a
// grid stride, so the tap bank (l*T floats, <= 166 KB for every
// supported rate/profile pair) and the phase tables are staged into
// dynamic shared memory once per CTA; a bank too large for shared memory
// is read from global memory (L2-resident) instead.  A warp's 32 outputs
// read overlapping input windows, which L1 serves.
//
// Rounding: one rounding per multiply and per add (__fmul_rn/__fadd_rn,
// built with --fmad=false), taps summed in ascending t from +0.  That is
// the plain twin's order (ops/resample.py:polyphase_resample_plain), so
// the two are bit-equal, and each output depends on k alone, so chunked
// evaluation (any k0/out_len split) is bit-identical to one launch.

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

}  // namespace

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
