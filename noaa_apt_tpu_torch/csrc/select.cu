// K3: greedy sync-peak selector (reference decode.rs:236-254).
//
// Replaces: noaa_apt_tpu/ops/pallas_select.py:make_select_peaks, in both
// its unbatched (grid over corr chunks) and batched ((element, chunk)
// grid) forms.
//
// Computes, per batch row b over corr[b, :n_valid[b]]:
//   seed (p, v) = (0, max(corr[0], 0)), k = 1, peaks[0] = 0;
//   repeat: take the first-occurrence argmax q of corr(p, p+md]; if it
//   beats v strictly, (p, v) = (q, corr[q]) and peaks[k-1] = q;
//   otherwise force-append i0 = max(p+md+1, spr*(k+1)) exactly
//   i0/spr - k times and continue from (i0, corr[i0]); stop once
//   i0 >= n_valid.  Values at or past n_valid may be staged (the raw
//   copies start from the 16-byte granule below the row and round up
//   past n_valid) but never take part.
//
// Bound on an H100: latency.  The bytes are few (the correlation once,
// ~30 MB for a 10-minute pass), but the ~2 windows per image row (~2,400
// per pass) are inherently sequential: each window depends on the
// previous one's result.  So the work is split in two kernels:
//
// (a) select_summary_kernel, bytes-bound, over the whole grid: for every
//     aligned block of kS = 32 positions of each row, the max and the
//     first index of the max over the part of the block below n_valid
//     (an empty block gives (-inf, -1)), stored as one 8-byte pair (the
//     max's float bits, the index).  A warp takes 4 blocks per step: 4
//     independent coalesced 128-byte loads and 4 shuffle argmaxes.
//
// (b) select_walk_kernel, one CTA per row (rows run on separate SMs):
//   - Warp 0 walks.  A window is a left partial block, whole blocks and a
//     right partial block: each lane reads at most one raw value of each
//     partial block and kLaneBlocks summary pairs from shared memory, all
//     loads issued together, as ints that order like the floats, and the
//     warp reduces with two redux.sync (max key, then the smallest index
//     holding it).  No __syncthreads, no device-memory round trip per
//     window.  A lone warp pays every instruction's latency, so a step is
//     short: 32-bit index arithmetic, no data-dependent loop, a template
//     per window width.
//   - After a replacement at q1, the reference's next window (q1, q1+md]
//     can only beat corr[q1] in its part past the old window, so the same
//     step decides it from [p+md+1, q1+md+1): about one step per row.
//   - Warp 1 streams the row's raw values and summaries ahead of p into a
//     shared-memory ring of kChunk-position chunks.  It keeps every slot
//     the walker has released filled, in chunk order, one lane per chunk,
//     each chunk one TMA bulk copy of raw values and one of summary pairs
//     completing on the slot's mbarrier.  A row that starts off a 16-byte
//     boundary is staged from the granule below its start, which never
//     leaves the row's page.  The walker publishes its lowest chunk; the
//     producer publishes how far the copies have landed (release/acquire
//     in shared memory), so a step whose windows have landed checks one
//     integer.  The ring's fill rate, one SM's share of L2 bandwidth for
//     every raw value of the row, is what the walk waits on.  Its
//     lookahead also hides HBM latency once the row has left L2 (after
//     K2's other output, or a summary pass over a batch): a walk that
//     read each step's operands straight from L2 measured slower there.
//
// Ties: (value, index) pairs compare by value, then the smaller index
// wins, at every level (lane, warp, between blocks): the first-occurrence
// argmax of jnp.argmax / torch.argmax.  -0 and +0 tie, as they compare
// equal.  NaN is outside the contract.
// If k would pass max_peaks the walk stops and raises a flag that the
// wrapper turns into an error.  The walk also reports its step count.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kS = 32;                  // positions per summary block
constexpr int kChunkShift = 11;
constexpr int kChunk = 1 << kChunkShift;      // positions per ring chunk
constexpr int kBlocksPerChunk = kChunk / kS;  // 64
constexpr int kSlots = 16;              // ring chunks (139 KB of shared memory)
constexpr int kMaxLaneBlocks = 11;      // summary pairs per lane and window, at most
constexpr int kDone = 0x7fffffff;       // walker_first once the walk has ended
constexpr int kRowsPerLaunch = 64;      // row lengths travel as kernel arguments
constexpr int kSumUnroll = 4;           // summary blocks per warp and step
constexpr int kResHead = 3;             // [k, overflow, steps] before each row's peaks
constexpr unsigned kFull = 0xffffffffu;

struct Lens {
  int n[kRowsPerLaunch];
};

__device__ __forceinline__ void keep_better(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    keep_better(bv, bi, __shfl_xor_sync(kFull, bv, off), __shfl_xor_sync(kFull, bi, off));
}

__global__ void __launch_bounds__(256)
select_summary_kernel(const float* __restrict__ corr, long long ld, Lens lens, int row0,
                      int2* __restrict__ summ, long long sld, int nb) {
  const int r = blockIdx.y;
  const long long b = row0 + r;
  const int n = lens.n[r];
  const float* c = corr + b * ld;
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int warps = gridDim.x * (blockDim.x >> 5);
  // kSumUnroll consecutive blocks per warp and step: independent loads.
  for (int j0 = warp * kSumUnroll; j0 < nb; j0 += warps * kSumUnroll) {
    float bv[kSumUnroll];
    int bi[kSumUnroll];
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) {
      const long long q = (long long)(j0 + u) * kS + lane;
      bv[u] = -INFINITY;
      bi[u] = INT_MAX;
      if (q < n) {
        bv[u] = c[q];
        bi[u] = (int)q;
      }
    }
#pragma unroll
    for (int u = 0; u < kSumUnroll; ++u) warp_argmax(bv[u], bi[u]);
    if (lane < kSumUnroll) {
      // Lane u stores block j0 + u (its pair sits in every lane).
      float v = bv[0];
      int i = bi[0];
#pragma unroll
      for (int u = 1; u < kSumUnroll; ++u)
        if (lane == u) {
          v = bv[u];
          i = bi[u];
        }
      if (j0 + lane < nb)
        summ[b * sld + j0 + lane] =
            i == INT_MAX ? make_int2(__float_as_int(-INFINITY), -1) : make_int2(__float_as_int(v), i);
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ bool mbar_test_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

// One TMA bulk copy global -> shared (16-byte aligned, a multiple of 16
// bytes), completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// A float as an int that orders like the float (finite and infinite
// values; -0 counts as +0, as float comparison does).
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(__fadd_rn(x, 0.f));
  return i ^ ((i >> 31) & 0x7fffffff);
}

// The slot of summary block j in the ring.
__device__ __forceinline__ int block_slot(int j, int mask) {
  const unsigned u = (unsigned)j;
  return (int)(((u / kBlocksPerChunk) & (unsigned)mask) * kBlocksPerChunk + (u & (kBlocksPerChunk - 1)));
}

// The warp's max key over every lane's candidates and the smallest index
// holding it; a lane's candidates come in ascending position order and
// INT_MIN marks none.
template <int kC>
__device__ __forceinline__ int warp_first_argmax(const int (&key)[kC], const int (&idx)[kC], int* q) {
  int mk = key[0];
#pragma unroll
  for (int u = 1; u < kC; ++u) mk = max(mk, key[u]);
  const int m = __reduce_max_sync(kFull, mk);
  unsigned first = 0xffffffffu;
#pragma unroll
  for (int u = kC - 1; u >= 0; --u)
    if (key[u] == m) first = (unsigned)idx[u];
  *q = (int)__reduce_min_sync(kFull, first);
  return m;
}

template <int kLaneBlocks>  // summary pairs per lane and jump: md < 32 * 32 * kLaneBlocks
__global__ void __launch_bounds__(64)
select_walk_kernel(const float* __restrict__ corr, long long ld, Lens lens, int row0,
                   const int2* __restrict__ summ, long long sld, int spr, int md, int max_peaks,
                   int ns, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);                 // ns chunks of corr
  int2* sp = reinterpret_cast<int2*>(raw + ns * kChunk);        // ns chunks of summary pairs
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(sp + ns * kBlocksPerChunk);  // one per slot
  int* tag = reinterpret_cast<int*>(bars + ns);  // 2 * chunk + parity, per slot (producer's)
  int* walker_first = tag + ns;           // the walker's lowest chunk; kDone at its end
  int* landed = tag + ns + 1;             // chunks in [walker's first, landed) have landed

  const int r = blockIdx.x;
  const long long b = row0 + r;
  const int n = lens.n[r];
  const int lane = threadIdx.x & 31;
  const float* c = corr + b * ld;
  const int mask = ns - 1;

  // Raw chunk j holds positions [j*kChunk - sh, (j+1)*kChunk - sh), so
  // that its source address is 16-byte aligned; summary chunk j holds
  // blocks [j*kBlocksPerChunk, (j+1)*kBlocksPerChunk).  Slot j & mask
  // holds both.
  const int sh = (int)((reinterpret_cast<uintptr_t>(c) >> 2) & 3);
  const int n_chunks = n > 0 ? ((n - 1 + sh) >> kChunkShift) + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(smem_addr(bars + s));
      tag[s] = -1;
    }
    *walker_first = 0;
    *landed = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // Producer: warp 1 keeps every slot the walker does not need filled,
    // in chunk order from the walker's lowest chunk, one lane per chunk
    // (one TMA bulk copy of raw values and one of summary pairs each), and
    // publishes how far the copies have landed.
    const float* c_al = c - sh;
    const int2* bsum = summ + b * sld;
    unsigned phase = 0, armed = 0;  // per slot: parity of the next fill; a fill in flight
    int c1 = 0, ready = 0;          // next chunk to issue; chunks below `ready` landed
    while (true) {
      // Acquire: the walker's reads of the chunks below f are done before
      // a bulk copy overwrites their slots.
      const int f = ld_acquire(walker_first);
      if (f == kDone) break;
      c1 = max(c1, f);
      const int target = min(f + ns, n_chunks);
      if (lane < target - c1) {
        const int j = c1 + lane, s = j & mask;
        const unsigned bar = smem_addr(bars + s);
        const unsigned par = (phase >> s) & 1u;
        if ((armed >> s) & 1u)
          while (!mbar_try_wait(bar, par ^ 1u)) {  // the slot's last fill has landed
          }
        const int pos0 = j * kChunk - sh;
        const unsigned raw_bytes = (unsigned)((min(kChunk, n - pos0) + 3) & ~3) * 4u;
        const long long sb = (long long)j * kBlocksPerChunk;
        const bool summ_in = sb + kBlocksPerChunk <= sld;
        mbar_expect_tx(bar, raw_bytes + (summ_in ? kBlocksPerChunk * 8u : 0u));
        bulk_copy(raw + s * kChunk, c_al + (long long)j * kChunk, raw_bytes, bar);
        if (summ_in) bulk_copy(sp + s * kBlocksPerChunk, bsum + sb, kBlocksPerChunk * 8u, bar);
        tag[s] = 2 * j + (int)par;
      }
      for (; c1 < target; ++c1) {
        phase ^= 1u << (c1 & mask);
        armed |= 1u << (c1 & mask);
      }
      __syncwarp();
      // Chunks [ready, ready + 32) that have landed, in order.
      ready = max(ready, f);
      const int jr = ready + lane;
      const bool ok = jr < c1 && mbar_test_wait(smem_addr(bars + (jr & mask)), (unsigned)tag[jr & mask] & 1u);
      const unsigned missing = __ballot_sync(kFull, !ok);
      const int adv = missing ? __ffs(missing) - 1 : 32;
      if (adv > 0) {
        ready += adv;
        if (lane == 0) st_release(landed, ready);
      }
    }
    if (lane < ns && ((armed >> lane) & 1u))  // no copy may outlive the block
      while (!mbar_try_wait(smem_addr(bars + lane), ((phase >> lane) & 1u) ^ 1u)) {
      }
    return;
  }

  // Walker: warp 0.
  int* res = out + b * (kResHead + (long long)max_peaks);  // [k, overflow, steps, peaks...]
  int* pk = res + kResHead;
  // Any position maps into the ring; only resident ones are meaningful.
  auto raw_at = [&](int q) -> float {
    const int x = q + sh;
    return raw[((x >> kChunkShift) & mask) * kChunk + (x & (kChunk - 1))];
  };

  int ready = 0, published = 0;  // the last `landed` read; the last `walker_first` written
  int p = 0, k = 1, ovf = 0, steps = 0;
  int vkey = order_key(n > 0 ? fmaxf(c[0], 0.f) : 0.f);
  bool v_pending = false;  // v = corr[p] still to be read (after an append)
  if (lane == 0) pk[0] = 0;

  while (true) {
    const int lo = p + 1;
    const int hi = min(p + md + 1, n);
    if (lo < hi) {
      ++steps;
      // Residency of [p, p + 2 md + 1): release the chunks below p's
      // (after this warp's reads of them), wait for the two windows' own.
      const int first = p >> kChunkShift;
      if (first != published) {
        published = first;
        __syncwarp();
        if (lane == 0) st_release(walker_first, first);
      }
      const int need = (min(p + 2 * md + 1, n) - 1 + sh) >> kChunkShift;  // W1 and W2
      while (ready <= need) ready = ld_acquire(landed);
      if (v_pending) {
        vkey = order_key(raw_at(p));
        v_pending = false;
      }

      // W1 = [lo, hi), and W2 = [hiu, min(q1 + md + 1, n)) after a
      // replacement at q1: everything in (q1, hiu) is <= corr[q1] (q1 is
      // W1's first argmax), so the reference's next window (q1, q1 + md]
      // can only beat it in W2, and W2 decides that next jump here.
      // Lane candidates in ascending position order: a partial block raw,
      // whole blocks from their summaries, a partial block raw; the block
      // at hi closes W1 and opens W2.  Every load is issued
      // unconditionally (the ring index is always in range) and masked
      // afterwards.  A window's warp reduction takes the max key, then
      // the smallest index holding it.
      const int hiu = p + md + 1;
      const int wb0 = (lo + kS - 1) >> 5, wb1 = hi >> 5, w2b0 = (hiu + kS - 1) >> 5;
      const int ql = (lo & ~(kS - 1)) + lane;
      const int qm = (wb1 << 5) + lane;
      const float xl = raw_at(ql), xm = raw_at(qm);
      int2 e1[kLaneBlocks], e2[kLaneBlocks];
#pragma unroll
      for (int u = 0; u < kLaneBlocks; ++u) {
        e1[u] = sp[block_slot(wb0 + lane + 32 * u, mask)];
        e2[u] = sp[block_slot(w2b0 + lane + 32 * u, mask)];
      }
      constexpr int kC = kLaneBlocks + 2;
      int key[kC], idx[kC];
      key[0] = ql >= lo && ql < hi && ql < (wb0 << 5) ? order_key(xl) : INT_MIN;
      idx[0] = ql;
#pragma unroll
      for (int u = 0; u < kLaneBlocks; ++u) {
        key[u + 1] = wb0 + lane + 32 * u < wb1 ? order_key(__int_as_float(e1[u].x)) : INT_MIN;
        idx[u + 1] = e1[u].y;
      }
      key[kC - 1] = qm >= lo && qm < hi && qm >= (wb0 << 5) ? order_key(xm) : INT_MIN;
      idx[kC - 1] = qm;
      int q1;
      const int m1 = warp_first_argmax<kC>(key, idx, &q1);
      if (m1 > vkey) {
        const int hi2 = min(q1 + md + 1, n);
        int m2 = INT_MIN, q2 = 0;
        if (hiu < hi2) {
          const int w2b1 = hi2 >> 5;
          const int qr = (w2b1 << 5) + lane;
          const float xr = raw_at(qr);
          key[0] = qm >= hiu && qm < hi2 && qm < (w2b0 << 5) ? order_key(xm) : INT_MIN;
          idx[0] = qm;
#pragma unroll
          for (int u = 0; u < kLaneBlocks; ++u) {
            key[u + 1] = w2b0 + lane + 32 * u < w2b1 ? order_key(__int_as_float(e2[u].x)) : INT_MIN;
            idx[u + 1] = e2[u].y;
          }
          key[kC - 1] = qr >= hiu && qr < hi2 && qr >= (w2b0 << 5) ? order_key(xr) : INT_MIN;
          idx[kC - 1] = qr;
          m2 = warp_first_argmax<kC>(key, idx, &q2);
        }
        const bool again = m2 > m1;  // W2 replaces q1 too
        p = again ? q2 : q1;
        vkey = again ? m2 : m1;
        if (lane == 0) pk[k - 1] = p;
        if (again) continue;
        // Otherwise the next window cannot beat corr[q1]: append from q1.
      }
    }
    // Forced append (possibly several copies on a long dropout).  The
    // wrapper keeps every position below 2^31 - 2 * (md + spr).
    const int next = spr * (k + 1);
    const int i0 = max(p + md + 1, next);
    if (i0 >= n) break;
    const int app = i0 < next + spr ? 1 : (int)((unsigned)i0 / (unsigned)spr) - k;
    if (k + app > max_peaks) {
      ovf = 1;
      break;
    }
    for (int j = k + lane; j < k + app; j += 32) pk[j] = i0;
    k += app;
    p = i0;
    v_pending = true;  // read once the window's chunks are resident
  }
  __syncwarp();
  if (lane == 0) st_release(walker_first, kDone);
  for (int j = k + lane; j < max_peaks; j += 32) pk[j] = 0;
  if (lane == 0) {
    res[0] = k;
    res[1] = ovf;
    res[2] = steps;
  }
}

// Whether the ring holds the two windows [p, p + 2 md + 1) (at most
// span chunks) and two chunks ahead of them.
bool ring_fits(int md) { return (2 * md + 4) / kChunk + 2 + 2 <= kSlots; }

template <int kLaneBlocks>
cudaError_t launch_walk(int rows, size_t smem, cudaStream_t stream, const float* corr,
                        long long ld, const Lens& lens, int row0, const int2* summ, long long sld,
                        int spr, int md, int max_peaks, int ns, int* out) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_walk_kernel<kLaneBlocks>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  select_walk_kernel<kLaneBlocks><<<rows, 64, smem, stream>>>(
      corr, ld, lens, row0, summ, sld, spr, md, max_peaks, ns, out);
  return cudaGetLastError();
}

// The walk instantiated for the fewest summary pairs per lane that
// cover md: kLaneBlocks = md / 1024 + 1, up to kMaxLaneBlocks.
template <int K>
cudaError_t launch_walk_for(int lane_blocks, int rows, size_t smem, cudaStream_t stream,
                            const float* corr, long long ld, const Lens& lens, int row0,
                            const int2* summ, long long sld, int spr, int md, int max_peaks,
                            int ns, int* out) {
  if (lane_blocks == K)
    return launch_walk<K>(rows, smem, stream, corr, ld, lens, row0, summ, sld, spr, md, max_peaks,
                          ns, out);
  if constexpr (K < kMaxLaneBlocks)
    return launch_walk_for<K + 1>(lane_blocks, rows, smem, stream, corr, ld, lens, row0, summ, sld,
                                  spr, md, max_peaks, ns, out);
  return cudaErrorInvalidValue;
}

}  // namespace

// The largest md the walk takes, plus one.
extern "C" int select_walk_md_limit() { return 32 * kS * kMaxLaneBlocks; }

// Both launchers take the row lengths as a host array and pass them to
// the kernels by value, kRowsPerLaunch rows per launch.  They launch on
// `stream`, which belongs to the current device (the wrapper makes
// corr's device current).

// summ: int32 [batch, sld, 2] (float bits of the max, first index), sld
// a multiple of kBlocksPerChunk (ops/select.py:CHUNK_BLOCKS); nb =
// ceil(L / 32).
extern "C" int select_summary(const void* corr, long long ld, int batch, const int* n_valid,
                              void* summ, long long sld, int nb, void* stream) {
  if (batch <= 0 || nb <= 0) return 0;
  const int blocks_per_cta = 256 / 32 * kSumUnroll;
  const int grid_x = min((nb + blocks_per_cta - 1) / blocks_per_cta, 2048);
  for (int row0 = 0; row0 < batch; row0 += kRowsPerLaunch) {
    Lens lens = {};
    const int rows = min(kRowsPerLaunch, batch - row0);
    for (int i = 0; i < rows; ++i) lens.n[i] = n_valid[row0 + i];
    select_summary_kernel<<<dim3(grid_x, rows), 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(corr), ld, lens, row0, static_cast<int2*>(summ), sld, nb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// out: int32 [batch, 3 + max_peaks] = (k, overflow, walk steps, peaks
// zero past k).  Returns cudaErrorInvalidValue for md >=
// select_walk_md_limit().
extern "C" int select_walk(const void* corr, long long ld, int batch, const int* n_valid,
                           const void* summ, long long sld, int spr, int md, int max_peaks,
                           void* out, void* stream) {
  if (batch <= 0) return 0;
  const int ns = kSlots;
  const int lane_blocks = md / (32 * kS) + 1;
  if (!ring_fits(md) || lane_blocks > kMaxLaneBlocks) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ns * (kChunk * sizeof(float) + kBlocksPerChunk * sizeof(int2) +
                                    sizeof(unsigned long long) + sizeof(int)) + 2 * sizeof(int);
  for (int row0 = 0; row0 < batch; row0 += kRowsPerLaunch) {
    Lens lens = {};
    const int rows = min(kRowsPerLaunch, batch - row0);
    for (int i = 0; i < rows; ++i) lens.n[i] = n_valid[row0 + i];
    const cudaError_t e = launch_walk_for<1>(
        lane_blocks, rows, smem, static_cast<cudaStream_t>(stream), static_cast<const float*>(corr),
        ld, lens, row0, static_cast<const int2*>(summ), sld, spr, md, max_peaks, ns,
        static_cast<int*>(out));
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
