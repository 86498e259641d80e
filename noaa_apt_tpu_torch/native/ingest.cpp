// Host ingest of the port's payload modes (--ingest host|host16|host16c|host8).
//
// A copy of noaa_apt_tpu/native/peak_finder.cpp:43-454 with every
// function body unchanged: the polyphase resample (exact and fast-math
// dot products), the fused resample -> i16/i8 quantize ingest and the
// host16c residual packer.  The sync-peak scan and the telemetry
// best-row scan of that file are not needed here and are left out.
// The port builds this file with the JAX package's exact g++ command
// (noaa_apt_tpu_torch/native/__init__.py): dot_fast's vectorized sum
// order follows the compiler flags, and the same command gives
// byte-identical payloads.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Host-side polyphase resampler (reference dsp.rs:186-289 semantics).
// Used as an ingest stage when the host->accelerator link is the
// bottleneck: rate-converting 48 kHz audio to the 12.48 kHz work rate
// on the host cuts uploaded bytes ~4x.  Threaded over output ranges.
//
// The taps congruent to each output phase are packed into a contiguous
// L1-resident bank (l rows of ~k/l floats), so the per-output kernel
// is a unit-stride dot product instead of a strided walk over the full
// coefficient array with a bounds check per tap.  Two variants:
//  - exact:  strictly sequential accumulation, bit-identical to the
//    reference's scalar loop (the bank preserves tap order).
//  - fast:   same taps, fast-math so the compiler vectorizes the
//    reduction (different f32 summation order, ~1e-7 relative noise —
//    far below the i16 quantization of the "host16" serving mode that
//    uses it).
struct PhaseBank {
    std::vector<float> taps;   // [l, tmax], zero-padded rows
    std::vector<int64_t> tcount;
    int64_t tmax;
};

static PhaseBank build_bank(const float* coeff, int64_t k, int64_t l) {
    PhaseBank b;
    const int64_t offset = (k - 1) / 2;
    const int64_t jmax = 2 * offset;  // == k-1 (odd-length designs)
    b.tmax = jmax / l + 1;
    b.taps.assign(l * b.tmax, 0.0f);
    b.tcount.assign(l, 0);
    for (int64_t p = 0; p < l; ++p) {
        const int64_t t_n = p <= jmax ? (jmax - p) / l + 1 : 0;
        b.tcount[p] = t_n;
        for (int64_t t = 0; t < t_n; ++t) b.taps[p * b.tmax + t] = coeff[p + t * l];
    }
    return b;
}

#if defined(__GNUC__) && !defined(__clang__)
__attribute__((optimize("-O3", "-ffast-math", "-funroll-loops")))
#endif
static float dot_fast(const float* a, const float* b, int64_t t_n) {
    float sum = 0.0f;
    for (int64_t t = 0; t < t_n; ++t) sum += a[t] * b[t];
    return sum;
}

static float dot_exact(const float* a, const float* b, int64_t t_n) {
    float sum = 0.0f;
    for (int64_t t = 0; t < t_n; ++t) sum += a[t] * b[t];
    return sum;
}

static void resample_range(const float* x, int64_t n, int64_t l, int64_t m,
                           const PhaseBank* bank, float* out,
                           int64_t k0, int64_t k1, int64_t fast) {
    for (int64_t ki = k0; ki < k1; ++ki) {
        const int64_t km = ki * m;
        const int64_t p = (l - (km % l)) % l;
        const int64_t xi0 = (km + p) / l;
        const int64_t t_n = bank->tcount[p];
        const float* tp = bank->taps.data() + p * bank->tmax;
        float sum;
        if (xi0 + t_n <= n) {
            sum = fast ? dot_fast(tp, x + xi0, t_n)
                       : dot_exact(tp, x + xi0, t_n);
        } else {
            // Tail windows: out-of-range samples contribute nothing
            // (dsp.rs:256-263 treats them as absent).
            const int64_t t_in = xi0 < n ? n - xi0 : 0;
            sum = dot_exact(tp, x + xi0, t_in);
        }
        out[ki] = sum;
    }
}

int64_t apt_fast_resample(const float* x, int64_t n, int64_t l, int64_t m,
                          const float* coeff, int64_t k, float* out,
                          int64_t out_len, int64_t threads, int64_t fast) {
    const PhaseBank bank = build_bank(coeff, k, l);
    if (threads <= 1) {
        resample_range(x, n, l, m, &bank, out, 0, out_len, fast);
        return out_len;
    }
    std::vector<std::thread> pool;
    const int64_t chunk = (out_len + threads - 1) / threads;
    for (int64_t t = 0; t < threads; ++t) {
        const int64_t k0 = t * chunk;
        const int64_t k1 = std::min(out_len, k0 + chunk);
        if (k0 >= k1) break;
        pool.emplace_back(resample_range, x, n, l, m, &bank, out, k0, k1, fast);
    }
    for (auto& th : pool) th.join();
    return out_len;
}

// Fused serving ingest (the "host16" mode of serve.py / decode.py):
// raw int16 PCM -> polyphase resample to the work rate -> peak-scan ->
// i16 quantize, in one call.  Replaces a numpy pipeline that cost a
// 115 MB i16->f32 materialization plus three more full passes
// (max/scale/round) per 10-minute recording — on a 2-core serving
// host those passes were the fleet pipeline's bottleneck stage.
//
// The conversion is streamed: each worker converts only the input
// window its current output block needs into a small reusable scratch
// (cache-resident), so no full-length f32 copy of the recording ever
// exists.  Numerics match the numpy path exactly: i16->f32 is exact,
// the dot is the same dot_fast the host16 mode already used, and the
// quantizer is nearbyintf (round-half-even, numpy's np.round) on
// f32 products.
static void ingest_range(const int16_t* x, int64_t n, int64_t l, int64_t m,
                         const PhaseBank* bank, float* work,
                         int64_t k0, int64_t k1) {
    const int64_t t_n_max = bank->tmax;
    const int64_t kblock = 1 << 16;  // outputs per block (~256 KB f32 scratch)
    std::vector<float> scratch;
    for (int64_t kb = k0; kb < k1; kb += kblock) {
        const int64_t ke = std::min(k1, kb + kblock);
        // Input span this block touches: xi0(kb) .. xi0(ke-1)+t_n.
        const int64_t xa = (kb * m) / l;
        const int64_t xb = std::min(n, ((ke - 1) * m + l - 1) / l + 1 + t_n_max);
        const int64_t span = xb > xa ? xb - xa : 0;
        scratch.resize(span);
        for (int64_t i = 0; i < span; ++i) scratch[i] = (float)x[xa + i];
        const float* xs = scratch.data() - xa;  // index with absolute xi
        for (int64_t ki = kb; ki < ke; ++ki) {
            const int64_t km = ki * m;
            const int64_t p = (l - (km % l)) % l;
            const int64_t xi0 = (km + p) / l;
            const int64_t t_n = bank->tcount[p];
            const float* tp = bank->taps.data() + p * bank->tmax;
            float sum;
            if (xi0 + t_n <= n) {
                sum = dot_fast(tp, xs + xi0, t_n);
            } else {
                const int64_t t_in = xi0 < n ? n - xi0 : 0;
                sum = dot_exact(tp, xs + xi0, t_in);
            }
            work[ki] = sum;
        }
    }
}

static void max_abs_range(const float* w, int64_t k0, int64_t k1, float* out) {
    float mx = 0.0f;
    for (int64_t i = k0; i < k1; ++i) {
        const float a = w[i] < 0 ? -w[i] : w[i];
        if (a > mx) mx = a;
    }
    *out = mx;
}

static void quantize_range(const float* w, int16_t* out, float scale,
                           int64_t k0, int64_t k1) {
    for (int64_t i = k0; i < k1; ++i) {
        out[i] = (int16_t)__builtin_nearbyintf(w[i] * scale);
    }
}

static void quantize_range_i8(const float* w, int8_t* out, float scale,
                              int64_t k0, int64_t k1) {
    for (int64_t i = k0; i < k1; ++i) {
        out[i] = (int8_t)__builtin_nearbyintf(w[i] * scale);
    }
}

// Shared front half of the fused ingest: resample x into work
// (out_true samples, threaded) and return the peak |work| (threaded
// reduction; 1.0 if the signal is all-zero).
static float ingest_work_and_peak(const int16_t* x, int64_t n, int64_t l,
                                  int64_t m, const float* coeff, int64_t k,
                                  float* work, int64_t out_true,
                                  int64_t threads, int64_t chunk) {
    const PhaseBank bank = build_bank(coeff, k, l);
    {
        std::vector<std::thread> pool;
        for (int64_t t = 1; t < threads; ++t) {
            const int64_t k0 = t * chunk, k1 = std::min(out_true, k0 + chunk);
            if (k0 >= k1) break;
            pool.emplace_back(ingest_range, x, n, l, m, &bank, work, k0, k1);
        }
        ingest_range(x, n, l, m, &bank, work, 0, std::min(out_true, chunk));
        for (auto& th : pool) th.join();
    }

    std::vector<float> maxes(threads, 0.0f);
    {
        std::vector<std::thread> pool;
        for (int64_t t = 1; t < threads; ++t) {
            const int64_t k0 = t * chunk, k1 = std::min(out_true, k0 + chunk);
            if (k0 >= k1) break;
            pool.emplace_back(max_abs_range, work, k0, k1, &maxes[t]);
        }
        max_abs_range(work, 0, std::min(out_true, chunk), &maxes[0]);
        for (auto& th : pool) th.join();
    }
    float peak = 0.0f;
    for (float v : maxes) peak = std::max(peak, v);
    return peak == 0.0f ? 1.0f : peak;
}

// x: raw int16 PCM (n samples).  out: int16 buffer of out_pad samples;
// [0, out_true) gets the quantized work signal, [out_true, out_pad)
// is zeroed (the decoder's padded upload bucket).  *inv_scale gets the
// f32 multiplier restoring real values.  Returns out_true, or -1 on
// bad arguments.
int64_t apt_ingest_i16(const int16_t* x, int64_t n, int64_t l, int64_t m,
                       const float* coeff, int64_t k,
                       int16_t* out, int64_t out_true, int64_t out_pad,
                       float* inv_scale, int64_t threads) {
    if (l < 1 || m < 1 || out_true < 0 || out_pad < out_true) return -1;
    if (threads < 1) threads = 1;
    const int64_t chunk = (out_true + threads - 1) / threads;
    std::vector<float> work(out_true);
    const float peak =
        ingest_work_and_peak(x, n, l, m, coeff, k, work.data(), out_true, threads, chunk);
    // Divide in double then round once to f32 — numpy's
    // np.float32(32767.0 / peak); a single-rounding f32 division can
    // land 1 ulp away and shift round-half-even quantization cells.
    const float scale = (float)(32767.0 / (double)peak);
    *inv_scale = 1.0f / scale;

    {
        std::vector<std::thread> pool;
        for (int64_t t = 1; t < threads; ++t) {
            const int64_t k0 = t * chunk, k1 = std::min(out_true, k0 + chunk);
            if (k0 >= k1) break;
            pool.emplace_back(quantize_range, work.data(), out, scale, k0, k1);
        }
        quantize_range(work.data(), out, scale, 0, std::min(out_true, chunk));
        for (auto& th : pool) th.join();
    }
    for (int64_t i = out_true; i < out_pad; ++i) out[i] = 0;
    return out_true;
}

// Same fused ingest quantized to i8 (the lossy "host8" serving mode:
// a quarter of the f32 upload bytes, ~42 dB SNR).  Numerics match the
// numpy i8 pipeline exactly: same dot kernel, np.float32(127.0/peak)
// scale, round-half-even quantizer.
int64_t apt_ingest_i8(const int16_t* x, int64_t n, int64_t l, int64_t m,
                      const float* coeff, int64_t k,
                      int8_t* out, int64_t out_true, int64_t out_pad,
                      float* inv_scale, int64_t threads) {
    if (l < 1 || m < 1 || out_true < 0 || out_pad < out_true) return -1;
    if (threads < 1) threads = 1;
    const int64_t chunk = (out_true + threads - 1) / threads;
    std::vector<float> work(out_true);
    const float peak =
        ingest_work_and_peak(x, n, l, m, coeff, k, work.data(), out_true, threads, chunk);
    const float scale = (float)(127.0 / (double)peak);
    *inv_scale = 1.0f / scale;

    {
        std::vector<std::thread> pool;
        for (int64_t t = 1; t < threads; ++t) {
            const int64_t k0 = t * chunk, k1 = std::min(out_true, k0 + chunk);
            if (k0 >= k1) break;
            pool.emplace_back(quantize_range_i8, work.data(), out, scale, k0, k1);
        }
        quantize_range_i8(work.data(), out, scale, 0, std::min(out_true, chunk));
        for (auto& th : pool) th.join();
    }
    for (int64_t i = out_true; i < out_pad; ++i) out[i] = 0;
    return out_true;
}

// Lossless fixed-width residual packer for the i16 work signal
// (ops/pack.py: the host16c serving mode).  Bit-identical to the
// NumPy reference encoder: resonant 2-tap predictor
//   pred[n] = (coeff * x[n-1]) >> 14 - x[n-2]   (arithmetic shift)
// residuals packed at ONE pass-level width w_lo (chosen by exact
// byte-cost argmin over the per-block width histogram) at a fixed
// per-block stride, unit-aligned so the device decoder needs no
// gathers; blocks wider than w_lo ship raw as escape rows.
static int block_width(const int16_t* x, int64_t n, int64_t b, int32_t coeff) {
    const int64_t base = b * 128;
    int32_t x0 = (base < n) ? x[base] : 0;
    int32_t x1 = (base + 1 < n) ? x[base + 1] : 0;
    int64_t mn = 0, mx = 0;
    for (int64_t j = 0; j < 126; ++j) {
        const int32_t x2 = (base + j + 2 < n) ? x[base + j + 2] : 0;
        const int64_t pred =
            ((static_cast<int64_t>(coeff) * x1) >> 14) - x0;
        const int64_t rj = x2 - pred;
        mn = std::min(mn, rj);
        mx = std::max(mx, rj);
        x0 = x1;
        x1 = x2;
    }
    int w = 1;
    while (mn < -(int64_t(1) << (w - 1)) || mx > (int64_t(1) << (w - 1)) - 1) {
        ++w;
    }
    return w;
}

static int64_t gcd64(int64_t a, int64_t b) {
    while (b) { int64_t t = a % b; a = b; b = t; }
    return a;
}

static void block_words_geom(int w_lo, int64_t* g, int64_t* u, int64_t* bw) {
    const int64_t d = gcd64(w_lo, 32);
    *g = 32 / d;
    *u = w_lo / d;
    const int64_t n_units = (126 + *g - 1) / *g;
    *bw = n_units * (*u);
}

static void pack_base_range(
    const int16_t* x, int64_t n, int32_t coeff, int w_lo, int64_t bw,
    uint32_t* base_out, int16_t* anchors, int64_t b0, int64_t b1) {
    const uint64_t mask = (uint64_t(1) << w_lo) - 1;
    for (int64_t b = b0; b < b1; ++b) {
        const int64_t base = b * 128;
        int32_t xb[128];
        for (int64_t j = 0; j < 128; ++j) {
            const int64_t i = base + j;
            xb[j] = (i < n) ? x[i] : 0;
        }
        anchors[2 * b] = static_cast<int16_t>(xb[0]);
        anchors[2 * b + 1] = static_cast<int16_t>(xb[1]);
        uint32_t* wp = base_out + b * bw;
        for (int64_t k = 0; k < bw; ++k) wp[k] = 0;
        uint64_t acc = 0;
        int accbits = 0;
        int64_t wk = 0;
        for (int64_t j = 0; j < 126; ++j) {
            const int64_t pred =
                ((static_cast<int64_t>(coeff) * xb[j + 1]) >> 14) - xb[j];
            const uint64_t field =
                static_cast<uint64_t>(xb[j + 2] - pred) & mask;
            acc |= field << accbits;
            accbits += w_lo;
            while (accbits >= 32) {
                wp[wk++] = static_cast<uint32_t>(acc & 0xFFFFFFFFu);
                acc >>= 32;
                accbits -= 32;
            }
        }
        if (accbits > 0) wp[wk++] = static_cast<uint32_t>(acc);
    }
}

// Returns the chosen w_lo (>0) and writes *out_n_esc; -1 on bad
// arguments, -2 when more than esc_cap blocks would escape (the
// signal is effectively incompressible; callers fall back to the
// plain i16 payload).  nb = ceil(n/128); base_out must hold nb*63
// words (the worst-case stride), anchors nb*2.
int64_t apt_pack_work_i16(
    const int16_t* x, int64_t n, int32_t coeff,
    uint32_t* base_out, int64_t base_cap,
    int16_t* anchors,
    int32_t* esc_idx, int16_t* esc_rows, int64_t esc_cap,
    int64_t nb, int64_t threads, int64_t* out_n_esc) {
    if (n <= 0 || nb <= 0 || nb * 128 < n) return -1;
    // Pass 1: per-block widths -> exact cost argmin for w_lo.
    std::vector<int8_t> wb(nb);
    std::vector<int> hist(40, 0);
    for (int64_t b = 0; b < nb; ++b) {
        wb[b] = static_cast<int8_t>(block_width(x, n, b, coeff));
        ++hist[wb[b]];
    }
    int best_w = 16;
    int64_t best_cost = -1;
    for (int w = 4; w <= 16; ++w) {
        int64_t g, u, bw;
        block_words_geom(w, &g, &u, &bw);
        int64_t n_esc = 0;
        for (size_t k = w + 1; k < hist.size(); ++k) n_esc += hist[k];
        const int64_t cost = nb * bw * 4 + n_esc * (1 + 64) * 4;
        if (best_cost < 0 || cost < best_cost) {
            best_w = w;
            best_cost = cost;
        }
    }
    int64_t g, u, bw;
    block_words_geom(best_w, &g, &u, &bw);
    if (nb * bw > base_cap) return -1;
    int64_t n_esc_total = 0;
    for (size_t k = best_w + 1; k < hist.size(); ++k) n_esc_total += hist[k];
    if (n_esc_total > esc_cap) return -2;

    // Pass 2: fixed-stride base packing, threaded.
    const int64_t nthreads = std::max<int64_t>(1, std::min<int64_t>(threads, 16));
    const int64_t chunk = (nb + nthreads - 1) / nthreads;
    {
        std::vector<std::thread> pool;
        for (int64_t t = 1; t < nthreads; ++t) {
            const int64_t b0 = t * chunk, b1 = std::min(nb, b0 + chunk);
            if (b0 >= b1) break;
            pool.emplace_back(pack_base_range, x, n, coeff, best_w, bw,
                              base_out, anchors, b0, b1);
        }
        pack_base_range(x, n, coeff, best_w, bw, base_out, anchors,
                        0, std::min(nb, chunk));
        for (auto& th : pool) th.join();
    }
    // Escape rows (few): raw 128-sample blocks, serial collect.
    int64_t ne = 0;
    for (int64_t b = 0; b < nb && ne < n_esc_total; ++b) {
        if (wb[b] > best_w) {
            esc_idx[ne] = static_cast<int32_t>(b);
            for (int64_t j = 0; j < 128; ++j) {
                const int64_t i = b * 128 + j;
                esc_rows[ne * 128 + j] = (i < n) ? x[i] : 0;
            }
            ++ne;
        }
    }
    *out_n_esc = ne;
    return best_w;
}

}  // extern "C"
