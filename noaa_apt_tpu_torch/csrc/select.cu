// K3: greedy sync-peak selector (reference decode.rs:236-254).
//
// Replaces: noaa_apt_tpu/ops/pallas_select.py:make_select_peaks, in both
// its unbatched (grid over corr chunks) and batched ((element, chunk)
// grid) forms.
//
// Computes, per batch element b over corr[b, :n_valid[b]]:
//   seed (p, v) = (0, max(corr[0], 0)), k = 1, peaks[0] = 0;
//   repeat: take the first-occurrence argmax q of corr(p, p+md]; if it
//   beats v strictly, (p, v) = (q, corr[q]) and peaks[k-1] = q;
//   otherwise force-append i0 = max(p+md+1, spr*(k+1)) exactly
//   i0/spr - k times and continue from (i0, corr[i0]); stop once
//   i0 >= n_valid.  Positions at or past n_valid are never read.
//
// Bound on an H100: latency.  The bytes are tiny (the correlation once,
// ~30 MB for a 10-minute pass), but the ~2 jumps per image row (~2,400
// per pass) are inherently sequential: each jump's window depends on the
// previous jump's result.
// Design: one CTA of 1024 threads per batch element walks the jumps (so
// the batch dimension is free: elements run on separate SMs).  Each
// jump's window max is a block reduction over (value, index) pairs with
// the smaller index winning ties (jnp.argmax's first occurrence): a
// strided per-thread scan, a warp shuffle tree, then one warp over the
// per-warp winners.  Every thread holds the same (p, v, k), so the
// control flow stays uniform.  The TPU kernel's chunk/pending
// bookkeeping existed only because its grid ran sequentially over VMEM
// chunks; here the whole correlation is addressable, so it is gone.
// If k would pass max_peaks the kernel stops and raises a flag that the
// wrapper turns into an error.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void keep_better(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
select_peaks_kernel(const float* __restrict__ corr, long long ld,
                    const int* __restrict__ n_valid, int spr, int md, int max_peaks,
                    int* __restrict__ peaks, int* __restrict__ k_out,
                    int* __restrict__ overflow) {
  __shared__ float warp_v[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  __shared__ float best_v;
  __shared__ int best_i;

  const int b = blockIdx.x;
  const float* c = corr + (long long)b * ld;
  int* pk = peaks + (long long)b * max_peaks;
  const int n = n_valid[b];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  int p = 0, k = 1;
  float v = n > 0 ? fmaxf(c[0], 0.f) : 0.f;
  if (tid == 0) pk[0] = 0;
  int ovf = 0;

  while (true) {
    // Replacement chain: first argmax of corr(p, p+md], masked at n.
    const int lo = p + 1;
    const int hi = min(p + md + 1, n);
    if (lo < hi) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int q = lo + tid; q < hi; q += blockDim.x) {
        const float x = c[q];
        if (x > bv) {
          bv = x;
          bi = q;
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        keep_better(bv, bi, __shfl_down_sync(kFull, bv, off), __shfl_down_sync(kFull, bi, off));
      if (lane == 0) {
        warp_v[warp] = bv;
        warp_i[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bv = lane < n_warps ? warp_v[lane] : -INFINITY;
        bi = lane < n_warps ? warp_i[lane] : INT_MAX;
        for (int off = 16; off > 0; off >>= 1)
          keep_better(bv, bi, __shfl_down_sync(kFull, bv, off), __shfl_down_sync(kFull, bi, off));
        if (lane == 0) {
          best_v = bv;
          best_i = bi;
        }
      }
      __syncthreads();
      const float m = best_v;
      const int q = best_i;
      if (m > v) {
        p = q;
        v = m;
        if (tid == 0) pk[k - 1] = p;
        continue;
      }
    }
    // Forced append (possibly several copies on a long dropout).
    const long long i0 = max((long long)p + md + 1, (long long)spr * (k + 1));
    if (i0 >= n) break;
    const int app = static_cast<int>(i0 / spr) - k;
    if (k + app > max_peaks) {
      ovf = 1;
      break;
    }
    if (tid == 0)
      for (int j = k; j < k + app; ++j) pk[j] = static_cast<int>(i0);
    k += app;
    p = static_cast<int>(i0);
    v = c[i0];
  }
  if (tid == 0) {
    k_out[b] = k;
    overflow[b] = ovf;
  }
}

}  // namespace

// Launches on `stream`, which belongs to the current device (the
// wrapper makes corr's device current).
extern "C" int select_peaks(const void* corr, long long ld, int batch,
                            const void* n_valid, int spr, int md, int max_peaks, void* peaks,
                            void* k, void* overflow, void* stream) {
  if (batch <= 0) return 0;
  select_peaks_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(corr), ld, static_cast<const int*>(n_valid), spr, md, max_peaks,
      static_cast<int*>(peaks), static_cast<int*>(k), static_cast<int*>(overflow));
  return (int)cudaGetLastError();
}
