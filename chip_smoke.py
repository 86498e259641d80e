#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``noaa_apt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (``{"phase": ...}``):

1. ``device``  — the card (``nvidia-smi``), torch and CUDA versions;
2. ``build``   — the nvcc build of every kernel (one nvcc per source,
   all at once) and each kernel's ptxas report;
3. ``kernel``  — each kernel at the main path's shapes for a 10-minute
   48 kHz standard pass (K1/K2 also at 11025 Hz and on the fast and slow
   profiles at both rates; K1 also on seeded 10-minute int16 passes at
   22050 Hz standard and 44100 Hz standard and slow, on 11011 Hz slow
   (l = 1600, its tap table in global memory) and on 250 kHz standard
   ("phase", its 241 KB bank in global memory), and in three ``k0``
   chunks at 48 kHz standard and 11025 Hz slow, each K1 record naming
   the variant that ran, "block", "class" or "phase"; K1 with float32
   input (the same int16 values: the int16 run's variant but "phase" at
   48 kHz fast, and its outputs bit for bit) at 48 kHz and 11025 Hz on
   every profile, 22050 and 44100 Hz, 11011 Hz slow and the 24960 Hz
   l == 1 pass;
   ``kernel_non_finite``, K1 on
   float32 passes at 48 kHz ("block") and 11025 Hz ("class") holding
   NaN, +-inf, -0.0, subnormals and +-3e38, bit for bit its twin; K1
   as the l == 1 causal FIR decimated by m (``"path": "l1"``) on seeded
   10-minute int16 passes at 24960 Hz standard (m = 2), 12480 Hz standard
   (m = 1) and 41600 Hz slow (m = 2), with the cost of its zero prefix; K3
   also at batch 4 and on tie-heavy
   small-integer rows at batch 1 and 4, with its block summaries and its
   walk's result (k, overflow flag, step count, peaks) held against
   their plain versions), held bit-equal (``torch.equal``) to its plain PyTorch
   twin on the same inputs, timed with CUDA events beside its twin, a
   PyTorch library yardstick where one call computes the same function,
   and the least time the card could take (bytes at 3.35 TB/s; fp32
   multiplies and adds at 33.5 T op/s, since the kernels are built with
   ``--fmad=false`` and issue each one on its own: the H100 SXM data
   sheet's 67 TFLOP/s counts an FMA as two);
4. ``reference`` — the three golden combos of the JAX package's tests
   decoded on the card: sync positions equal ``tests/golden/*.sync.txt``
   and the u8 image agrees with the port's CPU decode;
   ``reference_telemetry`` — the same three configurations at 230 rows
   (a telemetry frame needs 200) with telemetry contrast: the card's
   wedge levels within 1e-4 of the port's CPU levels, the channel names
   and sync lists equal, the u8 image within +-1 on 0.1%;
5. ``main_path`` — the port's CLI (``noaa_apt_tpu_torch.cli.main``) on a
   synthesized 10-minute 48 kHz pass with each contrast and colour
   choice (``98_percent``, ``-c telemetry``, ``-c histogram``, ``-F``),
   ``--no-sync``, ``--raw-out`` and then the ``.npy`` re-processed, then
   on 11025 Hz and 24960 Hz (l == 1) passes and a 44100 Hz pass with
   ``-p slow`` (K1 "class" at l 208, m 441, the report's ``k1_variant``
   "class"), then on the 48 kHz pass as
   a 32-bit float WAV and as a stereo one (K1 "block" on float32) and the
   11025 Hz pass as a 24-bit PCM WAV (K1 "class"), each PNG byte-equal to
   its int16 run's, with the kernels' launch
   counters set to 0 just before each run and read just after (one
   launch of each kernel per decode; none of K3 without sync, none at
   all for the ``.npy``); the telemetry run checks the channel names
   that the synthesizer encodes ("2" and "4"); ``upload_ring``: the
   stereo float and the mono int16 48 kHz WAVs staged twice each
   through the decoder's pinned ring (``graph/upload.py``), each
   ``torch.equal`` to the host copy's upload, the second making no ring;
6. ``map_path`` — the CLI on the 48 kHz pass with the map overlay and
   ``-R auto`` (``-m yes -R auto -s noaa_19 -T <file> -t <time>``: a
   pinned TLE and a NOAA 19 pass over Bolivia and Argentina, the states
   layer skipped through its failure memo): one launch of each kernel,
   more than 1000 ink pixels in each channel's +-456 px window, the
   rotation equal to ``geo.orbit.south_to_north_pass``, and the finish
   stage's wall time, which holds the overlay;
7. ``resample_tool`` — the CLI's WAV -> WAV mode (``-r``): 48000 -> 11025
   on the 48 kHz pass, 11025 -> 48000 on the 11025 Hz pass and 24960 ->
   12480 (l == 1) on the 24960 Hz pass, with one launch of K1 per run on
   the tool's float32 samples ("phase": m > 4 l; "class"; "block"); K1
   at each run's tables
   ``torch.equal`` to its twin on the card and timed as in phase 3
   (beside ``F.conv1d``); the written WAV's length, rate and mtime;
8. ``select_stage`` — the decoder's select stage (K3 and its one fetch),
   median of five decodes of the 48 kHz pass, beside K3's own time;
9. ``unpack`` — kernel K4 (the host16c codec's decoder) ``torch.equal``
   to its plain twin on the 48 kHz pass's sealed buffer (built by the
   port's ``prepare_work``; its decode is also the host16 payload), on a
   pass-length stream that forces escape rows (a quiet carrier with
   full-scale noise bursts), on a corrupt buffer (random words, unique
   escape indices, negative and out of range) and on a duplicates buffer
   (indices that name blocks more than once: the last row wins); timed
   as in phase 3, with the card-only time, the bound (bytes), ``w_lo``,
   the escape count and the sealed bytes;
10. ``ingest_path`` — the CLI on the 48 kHz pass with ``--ingest device``,
   ``host``, ``host16``, ``host16c`` and ``host8``, and with ``host16c``
   on the 11025 Hz pass: per run the wall, load, ``ingest_s`` (the host
   C++ resample, quantize, pack and, for host16c, the upload),
   ``payload_bytes``, the upload's host-clock ms, ``stage_ms`` and the
   launches (counters set to 0 just before each run and read just
   after): K1 0 on every host mode, K4 1 on host16c; host16c's PNG and
   sync list equal host16's; the count of sync positions that differ
   from the device-ingest run is printed, not asserted;
11. ``batch_path`` — B = 4 48 kHz passes of three lengths in one bucket
   and a too-short one, through ``decode_render_batch`` over host16
   payloads, the same over host16c payloads, and
   ``decode_render_input_batch``: one K3 launch per batch, every live
   member byte-equal to its unbatched render, the short one an error
   entry; ms per pass beside the unbatched renders';
12. ``fleet`` — fleet serving: two copies each of the 48 kHz, 11025 Hz and
   24960 Hz passes and a header-only WAV in one directory, through the
   CLI's directory mode (``--ingest device``) and through
   ``serve.decode_fleet(ingest="host16c", fleet_batch=4)``, the launch
   counters set to 0 just before each run and read just after: exactly the
   header-only WAV fails (the CLI exits 1), each grey PNG equals the R
   channel of the single-file run of the same WAV and ingest, and the
   launches match the passes (device: K1, K2, K3 once a pass; host16c: K4
   and K2 once a packed pass, K3 once a group, the 24960 Hz copies on
   K1, K2, K3 alone).  One line per run: wall, realtime factor,
   ``stage_totals``, ``link`` and the launches;
13. ``profile_trace`` — the default CLI on the 48 kHz pass with
   ``--profile-trace``: from its Chrome trace, the K1/K2/K3 kernel events
   by their ``csrc`` names (each must be there), the card's busy ms (the
   union of its kernel, copy and memset intervals), the traced window
   (first event to last) and the idle share;
14. ``steps`` — ``--wav-steps --raw-out`` on a 60-s 48 kHz pass and
   ``--wav-steps --export-resample-filtered --raw-out`` on a 60-s
   24960 Hz pass (l == 1: the grid stays): the PNG byte-equal to the
   offline ``--raw-out`` run's and the raw signal equal to its, the step
   WAVs those of the context's table, K1 twice, K2 and K3 once; then
   ``--export-resample-filtered`` on 60-s 48 kHz and 11025 Hz passes.
   ``twin_checks``: every K1 (the work-rate resample and the 1-tap
   NoFilter decimation to 4160 Hz, at m = 1 where its full-rate signal
   is written), K2 and K3 launch of these runs, recorded as the step
   decode made it, ``torch.equal`` to its twin on the same inputs.
   ``export_grid``: K1 at m = 1 ("block" at l 13, "class" at l 832, the
   grid's ``ef``) ``torch.equal`` to its twin over the whole grid and on
   three ``k0`` windows, timed as in phase 3 beside ``F.conv1d`` at
   stride 1;
15. ``stream`` — ``--stream --raw-out`` on the three 10-minute passes and
   the 11025 Hz pass as raw s16 on stdin (a pipe) with ``--stream-update
   100``: each PNG byte-equal to the offline ``--raw-out`` run's, the
   sync lists equal, K1 and K2 launched once a chunk and K3 never; per run
   the chunks, first-row latency, wall, realtime factor, the host greedy
   fold's seconds (``fold_s``) and the median chunk's ms.
   ``twin_checks``: the K1 and K2 launches of the first two chunks, of
   every 32nd and of the last (zero-padded) one, on the chunk-sized
   haloed windows as the stream made them, ``torch.equal`` to their
   twins; the first chunk's K2 runs on a view that starts past its
   buffer's first sample, and is also held to its twin on the whole
   buffer;
16. ``distributed`` — ``parallel.ShardedDecoder`` over ``["cuda:0"] * n``
   for n = 2, 4, 8 (and over every card where there are several) on the
   three 10-minute passes: the percent u8 and sync list byte-equal to
   ``Decoder.decode_render_input``'s and the no-sync rows ``torch.equal``
   to ``Decoder.decode``'s, K1 = K2 = n and K3 = 1 a decode (counts set
   to 0 just before, read just after), every shard's K1 and K2 launch held
   to its twin (``twin_checks``), stage ms and wall beside the one-device
   decode's; ``distributed_cli``: the CLI with ``--distributed 2``,
   ``--no-sync`` and ``--raw-out`` on the 48 kHz pass, each PNG (and the
   raw signal) equal to the one-device run's; ``distributed_multiprocess``:
   two processes of this script (``--dist-worker``) on the one card in a
   gloo process group run the CLI's ``--multihost`` over the ``fleet``
   directory (shares disjoint and complete, each PNG equal to the
   one-process fleet's, each process's launches those of its share), then
   one global batch through ``batch_decode`` (both processes get both
   rows, equal to the one-device decode);
17. ``gui`` — the GUI's logic layer (``gui.work``) headless on the card
   (in-memory widgets, inline ``idle_add``, ``GuiState(device=cuda)``),
   the launch counters set to 0 just before each action and read just
   after, no error in the info bar and each action's own final progress
   text: Decode of the 48 kHz pass (K1, K2, K3 once, each launch held to
   its twin by ``twin_checks``, the rows on the card); Process
   98_percent and Save, pixels equal to the CLI's ``--raw-out`` run's
   and within +-1 on 0.1% of the fused run's; Process minmax (no
   launch); Process with the overlay, ``auto`` rotation and the pinned
   TLE, equal to a CLI ``-m yes -R auto --raw-out`` run and within the
   rule of ``map_path``'s; an auto-update burst (no launch, the last
   knobs' image); Decode with "WAV steps" on the 60-s pass (K1 twice, K2
   and K3 once, held to their twins, the flat signal the ``--raw-out``
   run's); the Resample tool 48000 -> 11025 (K1 once, the CLI ``-r``
   run's WAV); a timestamp round trip.  One line: each action's wall
   seconds, launches, the differences and the card's name and power
   limit.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result.  It needs CUDA and the repository around
it; it imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, dense peak (data sheet)
# H100 SXM fp32 outside the tensor cores: 67 TFLOP/s counts an FMA as
# two; a separately issued multiply or add is one op at half that rate.
FP32_OPS_PER_S = 33.5e12
PASS_ROWS = 1200  # 10 minutes at 2 rows/s
# The pinned Jan-2020 TLE of the JAX package's tests (geo.rs:206-214), and
# the start of a NOAA 19 pass over Bolivia and Argentina.
MAP_TLE = """NOAA 15
1 25338U 98030A   20028.53684332  .00000010  00000-0  22730-4 0  9996
2 25338  98.7308  54.2052 0009655 316.5487  43.4931 14.25949056128892
NOAA 18
1 28654U 05018A   20028.55430359  .00000064  00000-0  59410-4 0  9998
2 28654  99.0657  83.5290 0013366 267.3059  92.6583 14.12484618757024
NOAA 19
1 33591U 09005A   20028.54874297  .00000001  00000-0  25623-4 0  9996
2 33591  99.1936  30.2411 0014855 109.6767 250.6008 14.12393428565240"""
MAP_START = "2020-01-26T09:23:20+00:00"
TEL_ROWS = 230  # the reference phase's telemetry decodes: a frame needs 200 rows
REPS = 20
DECODES = 5  # decodes behind the select-stage median


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def time_ms(torch, fn, reps: int = REPS, warmup: int = 2, batch: int = 10) -> float:
    """Milliseconds per call: the median over ``reps`` CUDA-event-timed
    runs of ``batch`` back-to-back calls, after ``warmup`` calls.  Back to
    back, a call's host work overlaps the card's work of the calls before
    it, unless the call waits for the card itself (K3's fetch does)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / batch)
    return statistics.median(ts)


def device_ms(torch, fn, calls: int = 20):
    """Milliseconds of card time per call of ``fn``: the kernels' own
    time that ``torch.profiler`` records over ``calls`` calls, without
    the host's share; None if the profiler recorded no card time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    return us / 1e3 / calls if us > 0 else None


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def synth_wav(path: Path, rate: int, rows: int) -> None:
    """A clean synthesized pass as a 16-bit mono WAV (port's synth)."""
    from noaa_apt_tpu_torch import synth
    from noaa_apt_tpu_torch.io import wav

    sig, _ = synth.synth_recording(n_rows=rows, sample_rate=rate, seed=0)
    wav.write_wav(path, sig, wav.WavSpec(1, rate, 16, "int"))


def write_wav_as(path: Path, pcm, rate: int, kind: str) -> None:
    """Mono ``pcm`` (int16 values, host) as a 32-bit IEEE-float WAV
    (``kind`` "float32": the values unscaled), as a stereo one whose
    channel 1 holds the values negated ("float32_stereo") or as a 24-bit
    PCM WAV ("int24": the same integers): each decodes to float32 samples
    equal to the int16 ones, so the decoder runs K1 on float32 input."""
    import struct

    import numpy as np

    v, ch = np.asarray(pcm, np.int32), 1
    if kind == "float32":
        data, fmt, bits = v.astype("<f4").tobytes(), 3, 32
    elif kind == "float32_stereo":
        data, fmt, bits, ch = np.stack([v, -v], axis=1).astype("<f4").tobytes(), 3, 32, 2
    else:
        data, fmt, bits = (v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]).tobytes(), 1, 24
    fmt_chunk = struct.pack("<HHIIHH", fmt, ch, rate, rate * ch * bits // 8, ch * bits // 8, bits)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(data)) + b"WAVE"
                     + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
                     + b"data" + struct.pack("<I", len(data)) + data)


def assert_bits_equal(torch, name: str, got, want) -> None:
    """Raise unless the float32 ``got`` and ``want`` are equal bit for bit
    (their int32 views: ``torch.equal`` fails on NaN)."""
    gi, wi = got.view(torch.int32), want.view(torch.int32)
    if not torch.equal(gi, wi):
        bad = (gi != wi).nonzero()[:, 0]
        raise AssertionError(f"{name}: kernel != plain twin in {bad.numel()} outputs' bits, first at "
                             f"{int(bad[0])}: {float(got[bad[0]])} vs {float(want[bad[0]])}")


def assert_equal(torch, name: str, got, want) -> float:
    """Raise unless ``got`` and ``want`` are equal; returns max |got - want|."""
    diff = (got.double() - want.double()).abs()
    if not torch.equal(got, want):
        raise AssertionError(
            f"{name}: kernel != plain twin; {int((diff > 0).sum())} elements differ, "
            f"max |diff| {float(diff.max())}, first at {int((diff > 0).nonzero()[0, 0])}"
        )
    return float(diff.max()) if diff.numel() else 0.0


def count_jumps(corr, n: int, spr: int, md: int) -> tuple[int, int]:
    """(jumps, window elements scanned) of the greedy selection over
    ``corr[:n]``: the windows the reference evaluates (host replay of
    ``ops/select.py:select_peaks_plain``)."""
    import numpy as np

    jumps = scanned = 0
    k, p = 1, 0
    v = max(float(corr[0]), 0.0) if n > 0 else 0.0
    while True:
        lo, hi = p + 1, min(p + md + 1, n)
        if lo < hi:
            jumps += 1
            scanned += hi - lo
            q = int(np.argmax(corr[lo:hi]))
            if corr[lo + q] > v:
                p, v = lo + q, float(corr[lo + q])
                continue
        i0 = max(p + md + 1, spr * (k + 1))
        if i0 >= n:
            return jumps, scanned
        k += i0 // spr - k
        p, v = i0, float(corr[i0])


def select_case(torch, rows, nvs: list, spr: int, md: int, max_peaks: int, label: str) -> dict:
    """K3 on ``rows[B, L]``: the whole wrapper, its summary intermediate
    and its walk kernel (k, overflow flag, step count and peaks), each
    against its plain version; returns the record of this case, with the
    walk's step count as the kernel reported it."""
    import numpy as np

    from noaa_apt_tpu_torch.ops import select as sel

    k3 = lambda: sel.select_peaks(rows, nvs, spr, md, max_peaks)  # noqa: E731
    k3p = lambda: sel.select_peaks_plain(rows, nvs, spr, md, max_peaks)  # noqa: E731
    pk, kk = k3()
    ppk, pkk = k3p()
    err = max(assert_equal(torch, f"select_peaks.k@{label}", kk, pkk),
              assert_equal(torch, f"select_peaks.peaks@{label}", pk, ppk))
    smax, sidx = sel.block_summary(rows, nvs)
    wmax, widx = sel.block_summary_plain(rows, nvs)
    assert_equal(torch, f"block_summary.max@{label}", smax, wmax)
    assert_equal(torch, f"block_summary.index@{label}", sidx, widx)

    nv = np.asarray(nvs, np.int32)
    summ, _ = sel._summary_launch(rows, nv)
    res = torch.empty((rows.shape[0], sel.RESULT_HEAD + max_peaks), dtype=torch.int32, device=rows.device)
    sel._walk_launch(rows, nv, summ, spr, md, max_peaks, res)
    wpk, wk, wsteps = sel.walk_summaries_plain(rows, wmax, widx, nvs, spr, md, max_peaks)
    want = torch.cat([wk[:, None], torch.zeros_like(wk)[:, None], wsteps[:, None], wpk], 1)
    assert_equal(torch, f"select_walk@{label}", res.cpu(), want)
    steps = res[:, 2].tolist()
    summary_ms = time_ms(torch, lambda: sel._summary_launch(rows, nv))
    walk_ms = time_ms(torch, lambda: sel._walk_launch(rows, nv, summ, spr, md, max_peaks, res))
    host = rows.cpu().numpy()
    walks = [count_jumps(host[b, : nvs[b]], nvs[b], spr, md) for b in range(len(nvs))]
    jumps = [j for j, _ in walks]
    b3, by3 = bound(sum(nvs) * 4 + len(nvs) * max_peaks * 4, sum(s for _, s in walks))
    one = len(nvs) == 1
    return dict(
        max_abs_err=err, ms=time_ms(torch, k3), plain_ms=time_ms(torch, k3p, reps=3, warmup=1, batch=1),
        bound_ms=b3, bound_by=by3, library_ms=None, summary_ms=summary_ms, walk_ms=walk_ms,
        jumps=jumps[0] if one else jumps, walk_steps=steps[0] if one else steps,
        ns_per_jump=walk_ms * 1e6 / max(jumps), peaks=kk.tolist(),
        shape=f"{label}: f32{list(rows.shape)}, n_valid={nvs}, spr={spr} md={md} max_peaks={max_peaks}",
    )


def stage_case(torch, dev, y, t, label: str):
    """K2 on the work-rate signal ``y`` with the tables ``t``, against its
    plain twin; returns (the record of this case, corr)."""
    import torch.nn.functional as F

    from noaa_apt_tpu_torch.ops import demod as dm
    from noaa_apt_tpu_torch.ops.stage import demod_fir_corr, demod_fir_corr_plain

    taps, tmpl = torch.from_numpy(t.taps).to(dev), torch.from_numpy(t.template).to(dev)
    inv = dm.inv_sinphi(t.sinphi)
    work = y.shape[0]
    k2 = lambda: demod_fir_corr(y, taps, tmpl, t.cosphi2, inv)  # noqa: E731
    k2p = lambda: demod_fir_corr_plain(y, taps, tmpl, t.cosphi2, inv)  # noqa: E731
    filt, corr = k2()
    pf, pc = k2p()
    err = max(assert_equal(torch, f"demod_fir_corr.filt@{label}", filt, pf),
              assert_equal(torch, f"demod_fir_corr.corr@{label}", corr, pc))
    del pf, pc
    k, g = taps.shape[0], tmpl.shape[0]
    # 21 demod ops, k multiplies + k - 1 adds, g - 1 adds per sample.
    b2, by2 = bound(work * 12 + k * 4 + g, work * (21 + 2 * k - 1 + g - 1))
    fir_w = taps.flip(0)[None, None, :]
    tmpl_w = tmpl.to(torch.float32)[None, None, :]
    dem = dm.demodulate(y, t.cosphi2, inv)
    lib = time_ms(torch, lambda: F.conv1d(dem[None, None, :], fir_w, padding=k - 1))
    lib += time_ms(torch, lambda: F.conv1d(filt[None, None, :], tmpl_w))
    rec = dict(
        max_abs_err=err, ms=time_ms(torch, k2), plain_ms=time_ms(torch, k2p, reps=3, warmup=1, batch=1),
        bound_ms=b2, bound_by=by2, library_ms=lib,
        shape=f"{label}: f32[{work}] -> 2 x f32[{work}], k={k} g={g}",
    )
    return rec, corr


def resample_case(torch, dev, x, t, label: str, work: int | None = None):
    """K1 on ``x`` with the tables ``t`` at the main path's length (or
    ``work`` outputs), against its plain twin; returns (the record of
    this case, y).  The record names the variant the wrapper launched."""
    import torch.nn.functional as F

    from noaa_apt_tpu_torch.ops.resample import polyphase_resample, polyphase_resample_plain

    n = x.shape[0]
    work = t.work_len(n) if work is None else work
    bank, p_c, s_c = (torch.from_numpy(a).to(dev) for a in (t.bank, t.p_c, t.s_c))
    k1 = lambda: polyphase_resample(x, bank, p_c, s_c, t.m, work)  # noqa: E731
    k1p = lambda: polyphase_resample_plain(x, bank, p_c, s_c, t.m, work)  # noqa: E731
    y = k1()
    variant = polyphase_resample.last_variant
    err = assert_equal(torch, f"polyphase_resample@{label}", y, k1p())
    live = (t.bank != 0).sum(axis=1)[t.p_c]  # live taps per output class
    macs = int(live.sum()) * (work // t.l) + int(live[: work % t.l].sum())
    b1, by1 = bound(n * x.element_size() + work * 4 + t.bank.nbytes + 8 * t.l, 2 * macs)
    w = int(t.s_c.max()) + t.bank.shape[1]
    rhs = torch.zeros((t.l, 1, w), dtype=torch.float32, device=dev)
    for c in range(t.l):
        rhs[c, 0, int(t.s_c[c]) : int(t.s_c[c]) + t.bank.shape[1]] = bank[int(t.p_c[c])]
    xf = x.to(torch.float32)[None, None, :]
    lib = time_ms(torch, lambda: F.conv1d(xf, rhs, stride=t.m))
    rec = dict(
        max_abs_err=err, ms=time_ms(torch, k1), plain_ms=time_ms(torch, k1p, reps=3, warmup=1, batch=1),
        bound_ms=b1, bound_by=by1, library_ms=lib, variant=variant, device_ms=device_ms(torch, k1),
        shape=f"{label}: {str(x.dtype)[6:]}[{n}] -> f32[{work}], l={t.l} m={t.m} T={t.bank.shape[1]}",
    )
    return rec, y


def float_case(torch, dev, x, t, label: str, rec16: dict, y16=None, work: int | None = None,
               variant: str | None = None) -> dict:
    """K1 on the int16 ``x`` converted to float32, against its twin
    (``resample_case``): it must run ``variant``, by default that of the
    int16 record ``rec16`` of the same shape, and, with ``y16``, give the
    int16 launch's outputs bit for bit (the conversion is exact and every
    variant sums the same products in the same order).  Emits and
    returns the record."""
    rec, y = resample_case(torch, dev, x.to(torch.float32), t, f"{label} f32", work)
    want = variant or rec16["variant"]
    if rec["variant"] != want:
        raise AssertionError(f"{label}: float32 input ran K1 {rec['variant']}, not {want}")
    if y16 is not None:
        assert_equal(torch, f"polyphase_resample@{label} f32 vs int16", y, y16)
    emit("kernel", name="polyphase_resample", bit_equal=True, input="float32", **rec)
    return rec


# Float32 samples that 0 * x does not cancel (inf, NaN) or that stress the
# rounding (-0.0, subnormals, near the largest finite value).
SPECIALS = (float("nan"), float("inf"), float("-inf"), -0.0, 1e-45, -3e-42, 3e38, -3e38)


def non_finite_phase(torch, dev, wav48: Path, wav11: Path) -> None:
    """K1 with float32 input seeded with ``SPECIALS`` at block-major CTA
    boundaries (the first sample of a CTA's span, which the CTA before
    also stages) and inside spans, on the 48 kHz ("block") and 11025 Hz
    ("class") standard passes: bit for bit its twin (int32 views)."""
    import numpy as np

    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph.decode import DecodeTables
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.ops.resample import K1_CTA_BLOCKS, polyphase_resample, polyphase_resample_plain

    for path, want in ((wav48, "block"), (wav11, "class")):
        signal, rate = wav.load_device_ready(path)
        t = DecodeTables.design(STANDARD, rate)
        x = np.array(signal).astype(np.float32)
        n, cta = x.shape[0], K1_CTA_BLOCKS * t.m
        # Eight CTAs spread over the pass: three specials each.
        ks = np.linspace(1, n // cta - 1, 8).astype(np.int64)
        at = np.concatenate([ks * cta, ks * cta + 1 + np.arange(8), ks * cta + cta // 2 + np.arange(8)])
        x[at] = np.resize(np.array(SPECIALS, np.float32), at.shape[0])
        xd = torch.from_numpy(x).to(dev)
        args = [torch.from_numpy(a).to(dev) for a in (t.bank, t.p_c, t.s_c)]
        work = t.work_len(n)
        got = polyphase_resample(xd, *args, t.m, work)
        variant = polyphase_resample.last_variant
        if variant != want:
            raise AssertionError(f"{rate.hz} Hz non-finite float32: K1 ran {variant}, not {want}")
        ref = polyphase_resample_plain(xd, *args, t.m, work)
        assert_bits_equal(torch, f"polyphase_resample@{rate.hz}/standard non-finite f32", got, ref)
        emit("kernel_non_finite", name="polyphase_resample", variant=variant, bits_equal=True,
             specials=len(at), nan_outputs=int(torch.isnan(ref).sum()),
             inf_outputs=int(torch.isinf(ref).sum()),
             shape=f"{rate.hz}/standard: f32[{n}] -> f32[{work}], l={t.l} m={t.m} T={t.bank.shape[1]}")


def seeded_pcm(rate: int, seconds: int = 600):
    """A seeded full-range int16 recording of ``seconds`` at ``rate``."""
    import numpy as np

    return np.random.default_rng(rate).integers(-32768, 32768, rate * seconds, dtype=np.int16)


def k0_split_check(torch, dev, x, t, label: str) -> None:
    """K1 evaluated in three chunks (k0 off a block and off a CTA of the
    variant's blocks: 256 block-major, 32 class-major) is ``torch.equal``
    to one launch."""
    from noaa_apt_tpu_torch.ops.resample import K1_CLASS_BLOCKS, K1_CTA_BLOCKS, polyphase_resample

    work = t.work_len(x.shape[0])
    args = [torch.from_numpy(a).to(dev) for a in (t.bank, t.p_c, t.s_c)]
    full = polyphase_resample(x, *args, t.m, work)
    variant = polyphase_resample.last_variant
    cta = (K1_CTA_BLOCKS if variant == "block" else K1_CLASS_BLOCKS) * t.l
    cuts = [0, work // 3 // cta * cta + 5, 2 * work // 3 + 3, work]
    parts = [polyphase_resample(x, *args, t.m, b - a, k0=a) for a, b in zip(cuts, cuts[1:])]
    if polyphase_resample.last_variant != variant:
        raise AssertionError(f"{label}: chunks ran {polyphase_resample.last_variant}, one launch {variant}")
    assert_equal(torch, f"polyphase_resample@{label} k0 split {cuts}", torch.cat(parts), full)
    emit("kernel_k0_split", name="polyphase_resample", variant=variant, cuts=cuts, bit_equal=True,
         shape=label)


def stage_profile_phase(torch, dev, wav_path: Path, profile, label: str, k0_split: bool = False) -> None:
    """K1 and K2 on another profile's tables."""
    import numpy as np

    from noaa_apt_tpu_torch.graph.decode import DecodeTables
    from noaa_apt_tpu_torch.io import wav

    signal, rate = wav.load_device_ready(wav_path)
    t = DecodeTables.design(profile, rate)
    x = torch.from_numpy(np.array(signal)).to(dev)
    rec1, y = resample_case(torch, dev, x, t, label)
    emit("kernel", name="polyphase_resample", bit_equal=True, **rec1)
    # At 48 kHz fast a float32 block-major CTA would leave two an SM: "phase".
    float_case(torch, dev, x, t, label, rec1, y, variant="phase" if label == "48000/fast" else None)
    if k0_split:
        k0_split_check(torch, dev, x, t, label)
    rec, _ = stage_case(torch, dev, y, t, label)
    emit("kernel", name="demod_fir_corr", bit_equal=True, **rec)


def resample_rates_phase(torch, dev) -> None:
    """K1 alone on seeded 10-minute int16 passes at the gather regime's
    other rates, 22050 Hz standard, 44100 Hz standard and slow, and on
    the same samples as float32."""
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import SLOW, STANDARD
    from noaa_apt_tpu_torch.graph.decode import DecodeTables

    for rate, profile in ((22050, STANDARD), (44100, STANDARD), (44100, SLOW)):
        x = torch.from_numpy(seeded_pcm(rate)).to(dev)
        t = DecodeTables.design(profile, Rate(rate))
        rec, y = resample_case(torch, dev, x, t, f"{rate}/{profile.name} seeded")
        emit("kernel", name="polyphase_resample", bit_equal=True, **rec)
        float_case(torch, dev, x, t, f"{rate}/{profile.name} seeded", rec, y)


def l1_phase(torch, dev) -> None:
    """K1 as the l == 1 path's causal FIR decimated by m, on seeded
    10-minute int16 passes over ``causal_input`` (K zeros, then x[1:]),
    with the time of that zero prefix (a ``torch.cat`` on the card)."""
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import SLOW, STANDARD
    from noaa_apt_tpu_torch.graph.decode import DecodeTables
    from noaa_apt_tpu_torch.ops.resample import causal_input

    for rate, profile in ((24960, STANDARD), (12480, STANDARD), (41600, SLOW)):
        t = DecodeTables.design(profile, Rate(rate))
        if t.l != 1:
            raise AssertionError(f"{rate}/{profile.name}: l = {t.l}, not the l == 1 path")
        pcm = torch.from_numpy(seeded_pcm(rate)).to(dev)
        k = t.bank.shape[1]
        rec, _ = resample_case(torch, dev, causal_input(pcm, k), t, f"{rate}/{profile.name} seeded, l = 1",
                               work=t.work_len(pcm.shape[0]))
        if rec["variant"] != "block":
            raise AssertionError(f"{rate}/{profile.name}: K1 ran {rec['variant']} at l = 1, not block")
        rec["prefix_ms"] = time_ms(torch, lambda: causal_input(pcm, k))
        emit("kernel", name="polyphase_resample", bit_equal=True, path="l1", **rec)
        if rate == 24960:
            float_case(torch, dev, causal_input(pcm, k), t, f"{rate}/{profile.name} seeded, l = 1", rec,
                       work=t.work_len(pcm.shape[0]))


def kernel_phase(torch, dev, wav_path: Path, profile, label: str, batch4: bool) -> dict:
    """K1, K2, K3 on the main path's inputs for ``wav_path``; returns the
    per-kernel records of this shape."""
    import numpy as np

    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.graph.decode import DecodeTables
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.ops.sync import selector_params

    signal, rate = wav.load_device_ready(wav_path)
    t = DecodeTables.design(profile, rate)
    x = torch.from_numpy(np.array(signal)).to(dev)
    work = t.work_len(x.shape[0])
    out = {}

    # K1: polyphase resample.
    out["polyphase_resample"], y = resample_case(torch, dev, x, t, label)
    out["polyphase_resample"]["float32"] = float_case(torch, dev, x, t, label, out["polyphase_resample"], y)
    if batch4:  # the 48 kHz standard pass
        k0_split_check(torch, dev, x, t, label)

    # K2: demod -> FIR -> sync correlation.
    out["demod_fir_corr"], corr = stage_case(torch, dev, y, t, label)
    g = t.template.shape[0]

    # K3: greedy sync selection over corr[:work - g].
    spr, md, max_peaks = selector_params(work, Rate(profile.work_rate))
    nv = max(0, work - g)
    c2 = corr[None, :]
    out["select_peaks"] = select_case(torch, c2, [nv], spr, md, max_peaks, label)
    if batch4:
        # Four rows of different length; row 1 carries a long dropout
        # (forced appends), row 2 a large corr[0] (the seed replacement).
        rows = corr[None, :].repeat(4, 1)
        rows[1, 4 * spr : 40 * spr] = -1e6
        rows[2, 0] = 1e9
        nvb = [nv, nv - 777, nv // 2, 12 * spr + 99]
        emit("kernel", name="select_peaks", bit_equal=True,
             **select_case(torch, rows, nvb, spr, md, max_peaks, f"{label} B=4"))
        # Tie-heavy rows: small integers, so equal maxima straddle summary
        # blocks and window edges; B = 1 and B = 4 (dropout row, seed row).
        ties = np.random.default_rng(0).integers(0, 4, (4, work), dtype=np.int8).astype(np.float32)
        ties[1, 4 * spr : 40 * spr] = -1.0
        ties[2, 0] = 9.0
        ties = torch.from_numpy(ties).to(dev)
        emit("kernel", name="select_peaks", bit_equal=True,
             **select_case(torch, ties[:1], [nv - 5], spr, md, max_peaks, f"{label} ties B=1"))
        emit("kernel", name="select_peaks", bit_equal=True,
             **select_case(torch, ties, [nv, nv - 777, nv // 2 + 3, 12 * spr + 99], spr, md,
                           max_peaks, f"{label} ties B=4"))
    for name, rec in out.items():
        emit("kernel", name=name, bit_equal=True, **rec)
    return out


def global_bank_phase(torch, dev) -> None:
    """K1 with a tap bank too large for shared memory, int16 and float32
    input: on the slow profile at 11011 Hz (l = 1600, a 320 KB bank) the
    class-major variant, which reads its tap table from global memory;
    on the standard profile at 250 kHz (l 156, m 3125, T 384: no
    class-major CTA fits, and the bank and phase tables take 240,864
    bytes) "phase", which then reads its bank from global memory."""
    import numpy as np

    from noaa_apt_tpu_torch import synth
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import SLOW, STANDARD
    from noaa_apt_tpu_torch.graph.decode import DecodeTables
    from noaa_apt_tpu_torch.ops.resample import k1_phase_smem, polyphase_resample, polyphase_resample_plain

    for profile, rate, want in ((SLOW, 11011, "class"), (STANDARD, 250000, "phase")):
        t = DecodeTables.design(profile, Rate(rate))
        sig, _ = synth.synth_recording(n_rows=4, sample_rate=rate, seed=0)
        x16 = torch.from_numpy(np.round(sig / np.abs(sig).max() * 30000).astype(np.int16)).to(dev)
        args = [torch.from_numpy(a).to(dev) for a in (t.bank, t.p_c, t.s_c)]
        work = t.work_len(x16.shape[0])
        label = f"{rate}/{profile.name}"
        where = f"bank {t.bank.nbytes} B, with the phase tables {k1_phase_smem(t.l, t.bank.shape[1])} B"
        for x in (x16.to(torch.float32), x16):
            got = polyphase_resample(x, *args, t.m, work)
            if polyphase_resample.last_variant != want:
                raise AssertionError(f"{label} {x.dtype} ran K1's {polyphase_resample.last_variant} "
                                     f"variant, not {want}")
            err = assert_equal(torch, f"polyphase_resample@{label} {x.dtype}", got,
                               polyphase_resample_plain(x, *args, t.m, work))
            emit("kernel", name="polyphase_resample", bit_equal=True, max_abs_err=err, variant=want,
                 shape=f"{label}: {str(x.dtype)[6:]}[{x.shape[0]}] -> f32[{work}], l={t.l} m={t.m} "
                       f"T={t.bank.shape[1]}, {where}, in global memory")


def reference_phase(torch) -> None:
    """The golden combos of tests/test_decode_e2e.py on the card."""
    import numpy as np

    from noaa_apt_tpu_torch import synth
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import FAST, SLOW, STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder

    for name, profile, rate in (
        ("decode_11025_standard", STANDARD, 11025),
        ("decode_48000_fast", FAST, 48000),
        ("decode_48000_slow", SLOW, 48000),
    ):
        sig, _ = synth.synth_recording(n_rows=24, sample_rate=rate)
        gpu, sync = Decoder(profile).decode_render_input(sig, len(sig), Rate(rate))
        cpu, sync_cpu = Decoder(profile, device="cpu").decode_render_input(sig, len(sig), Rate(rate))
        golden = [int(v) for v in (ROOT / "tests" / "golden" / f"{name}.sync.txt").read_text().split()]
        if sync != golden or sync_cpu != golden:
            raise AssertionError(f"{name}: sync positions differ from the golden list")
        if gpu.shape != cpu.shape:
            raise AssertionError(f"{name}: image shape {gpu.shape} vs CPU {cpu.shape}")
        d = np.abs(gpu.astype(np.int16) - cpu.astype(np.int16))
        if d.max(initial=0) > 1 or (d > 0).mean() > 1e-3:
            raise AssertionError(f"{name}: u8 differs from the CPU decode beyond +-1 on 0.1%")
        emit("reference", combo=name, rows=int(gpu.shape[0]), sync_equal_golden=True,
             u8_pixels_differing_from_cpu=int((d > 0).sum()))
        telemetry_reference(profile, rate, name)


def telemetry_reference(profile, rate: int, combo: str) -> None:
    """Telemetry contrast of a golden combo's configuration at ``TEL_ROWS``
    rows: the card's fused render and wedge levels against the CPU's."""
    import numpy as np

    from noaa_apt_tpu_torch import synth
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.graph.decode import Decoder
    from noaa_apt_tpu_torch.post.telemetry import telemetry_from_stats

    sig, _ = synth.synth_recording(n_rows=TEL_ROWS, sample_rate=rate)
    gdec, cdec = Decoder(profile), Decoder(profile, device="cpu")
    gpu, sync = gdec.decode_render_input(sig, len(sig), Rate(rate), "telemetry")
    stage_ms = gdec.last_stage_ms["telemetry"]
    levels, names = [], []
    for dec in (gdec, cdec):
        res = dec.decode(sig, Rate(rate))
        tel = telemetry_from_stats(*dec.telemetry_stats(res))
        levels.append((tel.get_wedge_value(9, None), tel.get_wedge_value(8, None)))
        names.append((tel.get_channel_name("a"), tel.get_channel_name("b")))
    cpu = cdec.render_u8_levels(res, *levels[1])
    if sync != res.sync_positions:
        raise AssertionError(f"{combo} telemetry: sync positions differ from the CPU decode")
    rel = max(abs(g - c) / abs(c) for g, c in zip(*levels))
    if rel > 1e-4 or names[0] != names[1]:
        raise AssertionError(f"{combo} telemetry: card levels {levels[0]} names {names[0]} vs CPU "
                             f"{levels[1]} {names[1]}")
    d = np.abs(gpu.astype(np.int16) - cpu.astype(np.int16))
    if gpu.shape != cpu.shape or d.max(initial=0) > 1 or (d > 0).mean() > 1e-3:
        raise AssertionError(f"{combo} telemetry: u8 differs from the CPU render beyond +-1 on 0.1%")
    emit("reference_telemetry", combo=combo, rows=int(gpu.shape[0]), levels=levels[0],
         cpu_levels=levels[1], max_rel_level_diff=rel, channels=names[0],
         u8_pixels_differing_from_cpu=int((d > 0).sum()), telemetry_stage_ms=stage_ms)


class _Messages(logging.Handler):
    """A logging handler that keeps the messages it is given."""

    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


ALL_ONCE = {"polyphase_resample": 1, "demod_fir_corr": 1, "select_peaks": 1, "unpack_sealed": 0}


def main_path_phase(torch, wav_path: Path, out_png: Path, rate: int, spr: int, k1_variant: str | None,
                    flags: tuple = (), expect: dict = ALL_ONCE, label: str = "98_percent",
                    phase: str = "main_path", pass_rows: int | None = None) -> dict:
    """One CLI run, with the launch counters set to 0 just before and read
    just after; raises unless each kernel launched ``expect`` times, K1 in
    ``k1_variant``, and the PNG holds the pass's rows.  Emits a ``phase``
    line and returns the CLI's report with the launches and the telemetry
    channel names it logged."""
    import numpy as np

    from noaa_apt_tpu_torch import cli, ops
    from noaa_apt_tpu_torch.io import png
    from noaa_apt_tpu_torch.ops.resample import polyphase_resample

    report: dict = {}
    names = _Messages()
    tel_log = logging.getLogger("noaa_apt_tpu_torch.post.telemetry")
    tel_log.addHandler(names)
    try:
        ops.reset_launch_counts()
        rc = cli.main([str(wav_path), "-o", str(out_png), *flags], report=report)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        tel_log.removeHandler(names)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc} at {rate} Hz ({label})")
    if launches != expect:
        raise AssertionError(f"launches on the {rate} Hz {label} run: {launches}, expected {expect}")
    if k1_variant is not None and polyphase_resample.last_variant != k1_variant:
        raise AssertionError(f"K1 ran {polyphase_resample.last_variant} at {rate} Hz, not {k1_variant}")
    rows, pass_rows = report["rows"], pass_rows or PASS_ROWS
    if abs(rows - pass_rows) > 2:
        raise AssertionError(f"{rows} rows decoded at {rate} Hz ({label}), synthesized {pass_rows}")
    spacing = None
    if report["sync_positions"] is not None:
        gaps = np.diff(np.asarray(report["sync_positions"][1:-1]))
        if gaps.size == 0 or np.abs(gaps - spr).max() > 1:
            raise AssertionError(f"interior sync spacing off spr={spr}: {sorted(set(gaps.tolist()))[:8]}")
        spacing = sorted(set(gaps.tolist()))
    width, height = png.png_size(out_png)
    if width != 2080 or height != rows:
        raise AssertionError(f"PNG is {width}x{height}, expected 2080x{rows}")
    channels = [m for m in names.messages if m.startswith("Channel A:")]
    emit(phase, rate=rate, run=label, flags=list(flags), rows=rows, launches=launches,
         k1_variant=report["k1_variant"] if k1_variant else None,
         wall_s=report["wall_s"], load_s=report["load_s"], decode_s=report["decode_s"],
         finish_s=report["finish_s"], save_s=report["save_s"], ingest_s=report["ingest_s"],
         payload_bytes=report["payload_bytes"],
         stage_ms=report["stage_ms"], telemetry_ms=report["telemetry_ms"], channels=channels,
         sync_spacing=spacing)
    return {**report, "launches": launches, "channels": channels}


def main_path_runs(torch, tmp: Path, wav48: Path, wav11: Path, wav25: Path, spr: int) -> dict:
    """Every contrast and colour choice of the CLI on the 48 kHz pass, the
    unfused paths (--no-sync, --raw-out, the .npy re-process), then the
    11025 Hz and 24960 Hz passes and a 44100 Hz pass on the slow profile
    (K1 "class", which the report's ``k1_variant`` names); then the 48 kHz pass as a 32-bit float
    WAV (K1 "block" on float32) and the 11025 Hz pass as a 24-bit PCM WAV
    (K1 "class" on float32), each PNG byte-equal to its int16 run's.
    Returns the default run's launches."""
    import numpy as np

    from noaa_apt_tpu_torch.core.profiles import SLOW
    from noaa_apt_tpu_torch.io import png, wav

    def run(wav_path, name, rate, variant, *flags, **kw):
        return main_path_phase(torch, wav_path, tmp / f"{name}_{rate}.png", rate, spr, variant, ("-q", *flags),
                               label=name, **kw)

    launches = run(wav48, "98_percent", 48000, "block")["launches"]
    tel = main_path_phase(torch, wav48, tmp / "telemetry.png", 48000, spr, "block",
                          ("-c", "telemetry"), label="telemetry")
    if tel["channels"] != ["Channel A: 2, Channel B: 4"] or tel["telemetry_ms"] is None:
        raise AssertionError(f"telemetry run: channels {tel['channels']}, stage {tel['telemetry_ms']}")
    run(wav48, "histogram", 48000, "block", "-c", "histogram")
    run(wav48, "false_color", 48000, "block", "-F")
    run(wav48, "no_sync", 48000, "block", "--no-sync",
        expect={**ALL_ONCE, "select_peaks": 0})
    raw = tmp / "raw.npy"
    run(wav48, "raw_out", 48000, "block", "--raw-out", str(raw))
    run(raw, "npy", 48000, None, expect={k: 0 for k in ALL_ONCE})
    d = np.abs(png.read_png(tmp / "npy_48000.png").astype(np.int16) - png.read_png(tmp / "raw_out_48000.png"))
    if d.max(initial=0) > 1 or (d > 0).mean() > 1e-3:
        raise AssertionError("the .npy re-process differs from its --raw-out run beyond +-1 on 0.1%")
    emit("npy_vs_raw_out", pixels_differing=int((d > 0).sum()))
    run(wav11, "98_percent", 11025, "class")
    run(wav25, "98_percent", 24960, "block")
    # A sound card's 44.1 kHz at the slow profile: K1 "class" at m > l (l 208, m 441, T 197).
    wav44 = tmp / "pass_44100.wav"
    synth_wav(wav44, 44100, PASS_ROWS)
    main_path_phase(torch, wav44, tmp / "slow_44100.png", 44100, SLOW.work_rate * 2080 // 4160, "class",
                    ("-q", "-p", "slow", "-c", "98_percent"), label="slow")
    for src, rate, kind, variant in ((wav48, 48000, "float32", "block"), (wav48, 48000, "float32_stereo", "block"),
                                     (wav11, 11025, "int24", "class")):
        path = tmp / f"pass_{rate}_{kind}.wav"
        write_wav_as(path, wav.load_device_ready(src)[0], rate, kind)
        rep = run(path, f"98_percent_{kind}_wav", rate, variant)
        same = (tmp / f"98_percent_{kind}_wav_{rate}.png").read_bytes() == (tmp / f"98_percent_{rate}.png").read_bytes()
        if not same:
            raise AssertionError(f"the {kind} WAV's PNG differs from the int16 WAV's at {rate} Hz")
        emit("float_wav_vs_int16", rate=rate, wav=kind, k1_variant=variant, png_byte_equal=True,
             upload_chunks=rep["upload_chunks"])
    upload_ring_phase(torch, tmp / "pass_48000_float32_stereo.wav", wav48)
    return launches


def upload_ring_phase(torch, stereo_f32: Path, mono_i16: Path) -> None:
    """The decoder's pinned ring on the 10-minute 48 kHz pass as a stereo
    float WAV and as the mono int16 WAV, each loaded twice as the CLI
    loads it: the staged upload ``torch.equal`` (float32: bit for bit) to
    the host copy's, ``torch.from_numpy(np.array(view)).to(device)``, and
    the second upload of each makes no ring: no pinned allocation.  One
    line a file: both uploads' ms (each ending in a synchronise) beside
    the host copy's, the slots filled and the bytes shipped."""
    from unittest import mock

    import numpy as np

    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph import upload
    from noaa_apt_tpu_torch.graph.decode import Decoder
    from noaa_apt_tpu_torch.io import wav

    dec = Decoder(STANDARD, device="cuda")
    made = []
    init = upload.UploadRing.__init__

    def counted(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    for name, path in (("stereo_f32", stereo_f32), ("mono_i16", mono_i16)):
        calls = []
        for _ in range(2):
            view = wav.load_device_ready(path)[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = torch.from_numpy(np.array(view)).to(dec.device)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            made.clear()
            with mock.patch.object(upload.UploadRing, "__init__", counted):
                t0 = time.perf_counter()
                got = dec._upload(view, len(view))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            if got.dtype != want.dtype:
                raise AssertionError(f"{name}: staged upload is {got.dtype}, the host copy's {want.dtype}")
            if got.dtype == torch.float32:
                assert_bits_equal(torch, f"{name} staged upload", got, want)
            elif not torch.equal(got, want):
                raise AssertionError(f"{name}: staged upload != the host copy's")
            calls.append({"ms": ms, "host_copy_ms": host_ms, "chunks": dec.last_upload.get("chunks"),
                          "bytes": dec.last_upload["bytes"], "rings_made": len(made)})
        ring = upload.upload_ring(dec.device)
        second = calls[1]
        if second["rings_made"]:
            raise AssertionError(f"{name}: the second staged upload allocated: {second}")
        if not all(s.is_pinned() for s in ring.slots) or not all(c["chunks"] for c in calls):
            raise AssertionError(f"{name}: the ring's slots are not pinned or the ring did not engage: {calls}")
        emit("upload_ring", wav=name, samples=len(view), slots=len(ring.slots), slot_bytes=ring.slot_bytes,
             calls=calls)


def ink(img, center: int) -> int:
    """Overlay pixels in the +-456 px window around ``center``: the grey
    image has R == B, the map's colours do not."""
    import numpy as np

    win = img[:, center - 456 : center + 456].astype(np.int16)
    return int((np.abs(win[..., 0] - win[..., 2]) > 10).sum())


def map_path_phase(torch, tmp: Path, wav_path: Path, rate: int, spr: int, k1_variant: str | None) -> None:
    """The CLI with the map overlay and ``-R auto`` on ``wav_path``: one
    launch of each kernel, overlay ink in both channels, the rotation
    that the pass direction asks for (the CLI's status lines say whether
    it rotated), and the finish stage's wall time."""
    from datetime import datetime

    from noaa_apt_tpu_torch.geo import states
    from noaa_apt_tpu_torch.geo.orbit import south_to_north_pass
    from noaa_apt_tpu_torch.io import png
    from noaa_apt_tpu_torch.types import OrbitSettings, RefTime, SatName

    states._download_failed[0] = True  # no network here: skip the states layer at once
    tle = tmp / "weather.txt"
    tle.write_text(MAP_TLE)
    messages = _Messages()
    cli_log = logging.getLogger("noaa_apt_tpu_torch")
    cli_log.addHandler(messages)
    try:
        report = main_path_phase(torch, wav_path, tmp / "map.png", rate, spr, k1_variant,
                                 ("-m", "yes", "-R", "auto", "-s", "noaa_19", "-T", str(tle), "-t",
                                  MAP_START), label="map_auto_rotate")
    finally:
        cli_log.removeHandler(messages)
    turn = south_to_north_pass(OrbitSettings(SatName.NOAA_19,
                                             RefTime.start(datetime.fromisoformat(MAP_START)), MAP_TLE))
    rotated = "Rotating output image" in messages.messages
    if rotated != turn or "Drawing map" not in messages.messages:
        raise AssertionError(f"map run: rotated {rotated}, south_to_north_pass {turn}, map drawn "
                             f"{'Drawing map' in messages.messages}")
    img = png.read_png(tmp / "map.png")
    ink_a, ink_b = ink(img, 539), ink(img, 1579)
    if min(ink_a, ink_b) <= 1000:
        raise AssertionError(f"map run: {ink_a} and {ink_b} ink pixels in the channel windows")
    emit("map_path", rate=rate, rotated=rotated, south_to_north_pass=turn, ink_a=ink_a, ink_b=ink_b,
         finish_s=report["finish_s"], wall_s=report["wall_s"], launches=report["launches"])


def tool_k1_inputs(torch, dev, src: Path, rin: int, rout: int):
    """K1's inputs for the CLI's ``-r rout`` on the WAV ``src`` at ``rin``
    Hz, as the tool builds them (``graph/debug.k1_inputs`` over the WAV's
    float32 samples, the settings file's filter): -> (x, tables, work)
    with ``tables`` what ``resample_case`` takes."""
    from types import SimpleNamespace

    from noaa_apt_tpu_torch.core.frequency import Freq, Rate
    from noaa_apt_tpu_torch.graph.debug import k1_inputs, resample_lowpass
    from noaa_apt_tpu_torch.graph.decode import _plan_resample_with_filter
    from noaa_apt_tpu_torch.io import config as cfg
    from noaa_apt_tpu_torch.io import wav

    settings = cfg.build_settings(cfg.load_de_settings())
    x_host, _ = wav.load_wav(src)
    filt = resample_lowpass(Rate(rin), Rate(rout), settings.wav_resample_atten,
                            Freq.from_pi_rad(settings.wav_resample_delta_freq))
    l, m, coeff = _plan_resample_with_filter(Rate(rin), Rate(rout), filt)
    x, bank, p_c, s_c, _, work = k1_inputs(torch.from_numpy(x_host).to(dev), l, m, coeff)
    tables = SimpleNamespace(bank=bank.cpu().numpy(), p_c=p_c.cpu().numpy(), s_c=s_c.cpu().numpy(), l=l, m=m)
    return x, tables, work


def resample_tool_phase(torch, dev, tmp: Path, runs) -> list[dict]:
    """The CLI's ``-r`` on each ``(wav, input rate, output rate, K1
    variant)`` of ``runs``: one K1 launch per run (counts set to 0 just
    before, read just after), in that variant; then K1 at that run's
    tables against its twin and timed (``resample_case``); the written
    WAV's length, rate and mtime.  Returns the K1 records."""
    from noaa_apt_tpu_torch import cli, ops
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.ops import resample as rs

    records = []
    for src, rin, rout, k1_variant in runs:
        out = tmp / f"resampled_{rin}_{rout}.wav"
        report: dict = {}
        ops.reset_launch_counts()
        rc = cli.main([str(src), "-r", str(rout), "-o", str(out), "-q"], report=report)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        variant = rs.polyphase_resample.last_variant
        if rc != 0:
            raise AssertionError(f"-r {rout} on the {rin} Hz pass returned {rc}")
        if launches != {"polyphase_resample": 1, "demod_fir_corr": 0, "select_peaks": 0, "unpack_sealed": 0}:
            raise AssertionError(f"launches of -r {rout} on the {rin} Hz pass: {launches}")
        if variant != k1_variant:
            raise AssertionError(f"-r {rout} on the {rin} Hz pass ran K1 {variant}, not {k1_variant}")
        x, tables, work = tool_k1_inputs(torch, dev, src, rin, rout)
        l, m = tables.l, tables.m
        rec, _ = resample_case(torch, dev, x, tables, f"-r {rin} -> {rout}", work=work)
        if rec["variant"] != k1_variant:
            raise AssertionError(f"K1 at the tables of -r {rout}: {rec['variant']}, not {k1_variant}")
        got, spec = wav.load_wav(out)
        if spec.sample_rate != rout or got.shape[0] != work:
            raise AssertionError(f"-r {rout}: wrote {got.shape[0]} samples at {spec.sample_rate} Hz, "
                                 f"expected {work} at {rout}")
        if int(out.stat().st_mtime) != int(src.stat().st_mtime):
            raise AssertionError(f"-r {rout}: the input's mtime was not copied")
        rec.update(launches=launches["polyphase_resample"], tool_wall_s=report["wall_s"],
                   rates=[rin, rout], l=l, m=m)
        emit("resample_tool", name="polyphase_resample", bit_equal=True, **rec)
        records.append(rec)
    return records


def select_stage_phase(wav_path: Path, k3_ms: float) -> None:
    """The decoder's select stage (K3 and its one fetch) beside K3's own
    wrapper time: the median over ``DECODES`` decodes of the pass."""
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder
    from noaa_apt_tpu_torch.io import wav

    signal, rate = wav.load_device_ready(wav_path)
    decoder, ms = Decoder(STANDARD), []
    for _ in range(DECODES):
        decoder.decode_render_input(signal, len(signal), rate)
        ms.append(decoder.last_stage_ms["select"])
    stage = statistics.median(ms)
    emit("select_stage", rate=rate.hz, decodes=DECODES, stage_ms=stage, k3_ms=k3_ms,
         over_k3_ms=stage - k3_ms)


INT32_OPS_PER_S = 16.7e12  # H100 SXM: 64 INT32 lanes an SM (half the FP32 lanes) x 132 SMs x 1.98 GHz


def unpack_case(torch, dev, buf, nb: int, w_lo: int, n_esc_pad: int, coeff: int, label: str,
                want_prefix=None) -> dict:
    """K4 on the sealed words ``buf`` (int32, host) against its plain twin
    on the card, timed; with ``want_prefix`` (int16, host) also the
    decode's first samples against it.  Returns the record of this case."""
    import numpy as np

    from noaa_apt_tpu_torch.ops.pack import unpack_sealed, unpack_sealed_plain

    b = torch.from_numpy(buf).to(dev)
    k4 = lambda: unpack_sealed(b, nb, w_lo, n_esc_pad, coeff)  # noqa: E731
    k4p = lambda: unpack_sealed_plain(b, nb, w_lo, n_esc_pad, coeff)  # noqa: E731
    got = k4()
    err = assert_equal(torch, f"unpack_sealed@{label}", got, k4p())
    if want_prefix is not None and not np.array_equal(got[: len(want_prefix)].cpu().numpy(), want_prefix):
        raise AssertionError(f"unpack_sealed@{label}: the decode is not the encoder's input")
    # Each sealed word read once, each sample written once; 4 int32 ops a
    # sample (multiply, shift, subtract, add) for the recurrence.
    n_out = nb * 128
    bnd, by = bound(buf.nbytes + n_out * 2, 0)
    t_ops = 4 * n_out / INT32_OPS_PER_S * 1e3
    if t_ops > bnd:
        bnd, by = t_ops, "operations"
    return dict(max_abs_err=err, ms=time_ms(torch, k4), device_ms=device_ms(torch, k4),
                plain_ms=time_ms(torch, k4p, reps=3, warmup=1, batch=1), bound_ms=bnd, bound_by=by,
                library_ms=None, w_lo=w_lo, n_esc_pad=n_esc_pad, sealed_bytes=int(buf.nbytes),
                shape=f"{label}: i32[{buf.shape[0]}] -> i16[{n_out}], nb={nb} w_lo={w_lo} n_esc_pad={n_esc_pad}")


def unpack_phase(torch, dev, wav48: Path) -> dict:
    """K4 on the 48 kHz pass's sealed buffer (the port's ``prepare_work``),
    on a pass-length stream with escape rows, and on a corrupt buffer;
    returns the pass's record."""
    import numpy as np

    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder, PackedWorkPayload, pad_bucket
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.native import pack_work_i16_native
    from noaa_apt_tpu_torch.ops import pack as pk

    signal, rate = wav.load_device_ready(wav48)
    dec16 = Decoder(STANDARD, device="cpu", ingest="host16")
    plain = dec16.prepare_work(signal, rate, to_device=True)
    decc = Decoder(STANDARD, ingest="host16c")
    t0 = time.perf_counter()
    payload = decc.prepare_work(signal, rate, to_device=True)
    prepare_s = time.perf_counter() - t0
    if not isinstance(payload, PackedWorkPayload):
        raise AssertionError("host16c shipped the plain i16 payload for the 48 kHz pass")
    rec = unpack_case(torch, dev, payload.buf.cpu().numpy(), payload.nb, payload.w_lo, payload.n_esc_pad,
                      payload.coeff, "48000/standard pass", want_prefix=plain.data.numpy())
    n_esc = int((payload.buf[payload.nb : payload.nb + payload.n_esc_pad] < payload.nb).sum())
    emit("unpack", name="unpack_sealed", bit_equal=True, n_esc=n_esc, work_true=payload.work_true,
         prepare_s=prepare_s,
         plain_i16_bytes=int(plain.data.numel() * 2), **rec)

    # Escapes: a quiet carrier with full-scale noise bursts, at pass length.
    n = payload.work_true
    rng = np.random.default_rng(7)
    x = (300 * np.sin(2 * np.pi * 2400 / STANDARD.work_rate * np.arange(n))).astype(np.int16)
    for start in range(40_000, n - 1024, 97_000):
        x[start : start + 600] = rng.integers(-32768, 32768, 600)
    x[-500:] = 0
    pw = pack_work_i16_native(x, STANDARD.work_rate)
    n_esc_pad = pad_bucket(max(4, len(pw.esc_idx)))
    sealed = pk.seal_packed(pw, n_esc_pad).view(np.int32)
    esc = unpack_case(torch, dev, sealed, pw.nb, pw.w_lo, n_esc_pad, pw.coeff, "escape bursts", want_prefix=x)
    emit("unpack", name="unpack_sealed", bit_equal=True, n_esc=len(pw.esc_idx), **esc)

    # Corrupt: random words; unique escape indices, negative and out of range.
    nb, w_lo, n_esc_pad = payload.nb, 13, 64
    words = rng.integers(0, 2**32, pk.sealed_len(nb, w_lo, n_esc_pad), dtype=np.uint32)
    idx = rng.choice(np.arange(-2 * nb, 2 * nb), n_esc_pad, replace=False).astype(np.int32)
    words[nb : nb + n_esc_pad] = idx.view(np.uint32)
    bad = unpack_case(torch, dev, words.view(np.int32), nb, w_lo, n_esc_pad, payload.coeff, "corrupt")
    emit("unpack", name="unpack_sealed", bit_equal=True, negative_indices=int((idx < 0).sum()),
         dropped_indices=int(((idx < -nb) | (idx >= nb)).sum()), **bad)

    # Duplicates: indices that name blocks more than once (a corrupt
    # stream's, since the encoder never writes them): repeats, -k beside
    # nb - k, one block named by 64 rows; the last row naming a block wins.
    w_lo, n_esc_pad = payload.w_lo, payload.n_esc_pad
    words = rng.integers(0, 2**32, pk.sealed_len(nb, w_lo, n_esc_pad), dtype=np.uint32)
    idx = rng.integers(-nb, nb, n_esc_pad).astype(np.int32)
    idx[:64] = 511
    idx[64:512:2] = -rng.integers(1, nb, 224)
    idx[65:512:2] = idx[64:512:2] + nb
    words[nb : nb + n_esc_pad] = idx.view(np.uint32)
    dup = unpack_case(torch, dev, words.view(np.int32), nb, w_lo, n_esc_pad, payload.coeff, "duplicates")
    norm = np.where(idx < 0, idx.astype(np.int64) + nb, idx)
    emit("unpack", name="unpack_sealed", bit_equal=True, named_blocks=int(np.unique(norm).size),
         rows_over_named_blocks=int(n_esc_pad - np.unique(norm).size), **dup)
    return rec


INGEST_MODES = ("host", "host16", "host16c", "host8")


def ingest_path_phase(torch, tmp: Path, wav48: Path, wav11: Path, spr: int) -> dict:
    """The CLI with each ``--ingest`` mode on the 48 kHz pass (and the
    device ingest beside them), host16c also on the 11025 Hz pass; returns
    the launches of the 48 kHz host16c run."""
    from noaa_apt_tpu_torch.io import png

    reports = {}
    for mode in ("device", *INGEST_MODES):
        expect = dict(ALL_ONCE) if mode == "device" else {
            **ALL_ONCE, "polyphase_resample": 0, "unpack_sealed": int(mode == "host16c")}
        reports[mode] = main_path_phase(torch, wav48, tmp / f"ingest_{mode}.png", 48000, spr,
                                        "block" if mode == "device" else None,
                                        ("-q", "--ingest", mode), expect=expect, label=f"ingest {mode}",
                                        phase="ingest_path")
    main_path_phase(torch, wav11, tmp / "ingest_host16c_11025.png", 11025, spr, None,
                    ("-q", "--ingest", "host16c"),
                    expect={**ALL_ONCE, "polyphase_resample": 0, "unpack_sealed": 1},
                    label="ingest host16c", phase="ingest_path")
    if reports["host16c"]["sync_positions"] != reports["host16"]["sync_positions"]:
        raise AssertionError("host16c's sync list differs from host16's")
    if not (png.read_png(tmp / "ingest_host16c.png") == png.read_png(tmp / "ingest_host16.png")).all():
        raise AssertionError("host16c's PNG differs from host16's")
    ref = reports["device"]["sync_positions"]
    diff = {}
    for mode in INGEST_MODES:
        got = reports[mode]["sync_positions"]
        diff[mode] = sum(a != b for a, b in zip(got, ref)) + abs(len(got) - len(ref))
    emit("ingest_sync_vs_device", host16c_equals_host16=True, differing_sync_positions=diff)
    return reports["host16c"]["launches"]


def batch_path_phase(torch, wav48: Path) -> dict:
    """B = 4 48 kHz passes (three lengths in one bucket, one too short)
    through both batched renders; returns the K3 launches per batch."""
    import numpy as np

    from noaa_apt_tpu_torch import err, ops
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder
    from noaa_apt_tpu_torch.io import wav

    signal, rate = wav.load_device_ready(wav48)
    signal = np.array(signal)
    # Members 0, 1, 3 share one work bucket; member 2 (8 rows) is under the 10-row guard.
    sigs = [signal, signal[:-4800], signal[: 48000 * 4], signal[:-9600]]
    k3 = {}
    for name, mode in (("render_batch host16", "host16"), ("render_batch host16c", "host16c"),
                       ("render_input_batch", "device")):
        dec = Decoder(STANDARD, ingest=mode)
        if mode == "device":
            run = lambda: dec.decode_render_input_batch(sigs, [len(s) for s in sigs], rate)  # noqa: E731
            singles = [lambda s=s: dec.decode_render_input(s, len(s), rate) for s in sigs]
            ingest_s = 0.0
        else:
            t0 = time.perf_counter()
            payloads = [dec.prepare_work(s, rate, to_device=(mode == "host16c")) for s in sigs]
            ingest_s = time.perf_counter() - t0
            run = lambda: dec.decode_render_batch(payloads)  # noqa: E731
            singles = [lambda p=p: dec.decode_render(p) for p in payloads]
        ops.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        stage_ms = dict(dec.last_stage_ms)
        if launches["select_peaks"] != 1:
            raise AssertionError(f"{name}: K3 launched {launches['select_peaks']} times for one batch")
        if not isinstance(got[2], err.InternalError) or "too short" not in str(got[2]):
            raise AssertionError(f"{name}: the short member gave {got[2]!r}, not the too-short error")
        for b in (0, 1, 3):
            gray, sync_pos = singles[b]()
            if got[b][1] != sync_pos or not np.array_equal(got[b][0], gray):
                raise AssertionError(f"{name}: member {b} differs from its unbatched render")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        singles_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            for b in (0, 1, 3):
                singles[b]()
            singles_s.append(time.perf_counter() - t0)
        emit("batch_path", run=name, batch=len(sigs), live=3, launches=launches, stage_ms=stage_ms,
             members_equal_unbatched=True, short_member_error=str(got[2]), ingest_s=ingest_s,
             ms_per_pass=statistics.median(walls) * 1e3 / 3,
             unbatched_ms_per_pass=statistics.median(singles_s) * 1e3 / 3)
        k3[name] = launches["select_peaks"]
    return k3


FLEET_RATES = (48000, 11025, 24960)


def fleet_phase(torch, tmp: Path, wav48: Path, wav11: Path, wav25: Path, spr: int) -> dict:
    """Fleet serving on six copies of the three passes and a header-only WAV:
    the CLI's directory mode with device ingest, then ``decode_fleet`` with
    host16c; returns each run's launches and the host16c run's batches."""
    import shutil

    import numpy as np

    from noaa_apt_tpu_torch import cli, ops
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder
    from noaa_apt_tpu_torch.io import png
    from noaa_apt_tpu_torch.serve import decode_fleet

    # The single-file PNGs of the same WAVs: main_path_runs' and ingest_path_phase's,
    # and host16c at 24960 Hz (l == 1: the device path, K4 not launched).
    main_path_phase(torch, wav25, tmp / "ingest_host16c_24960.png", 24960, spr, None,
                    ("-q", "--ingest", "host16c"), label="ingest host16c", phase="ingest_path")
    singles = {"device": {r: tmp / f"98_percent_{r}.png" for r in FLEET_RATES},
               "host16c": {48000: tmp / "ingest_host16c.png", 11025: tmp / "ingest_host16c_11025.png",
                           24960: tmp / "ingest_host16c_24960.png"}}
    d = tmp / "fleet_in"
    d.mkdir()
    rates = {}
    for src, rate in zip((wav48, wav11, wav25), FLEET_RATES):
        for k in (1, 2):
            shutil.copyfile(src, d / f"pass_{rate}_{k}.wav")
            rates[f"pass_{rate}_{k}.wav"] = rate
    with open(wav48, "rb") as f:
        (d / "truncated.wav").write_bytes(f.read(44))  # a header that promises 57.6 MB
    n = len(rates)

    def check(label: str, rep, wall: float, launches: dict, expect: dict, mode: str, **extra):
        if [r.input_path.name for r in rep.failed] != ["truncated.wav"] or len(rep.ok) != n:
            raise AssertionError(f"fleet {label}: failed "
                                 f"{[(r.input_path.name, r.error) for r in rep.failed]}, {len(rep.ok)} ok")
        if launches != expect:
            raise AssertionError(f"fleet {label}: launches {launches}, expected {expect}")
        for r in rep.ok:
            got = png.read_png(r.output_path)
            want = png.read_png(singles[mode][rates[r.input_path.name]])[..., 0]
            if got.shape[2] != 1 or not np.array_equal(got[..., 0], want):
                raise AssertionError(f"fleet {label}: {r.output_path.name} differs from its single-file PNG")
        emit("fleet", run=label, passes=n, ok=len(rep.ok), failed=[r.input_path.name for r in rep.failed],
             rows=sum(r.n_rows for r in rep.ok), wall_s=rep.wall_seconds, call_wall_s=wall,
             realtime_factor=rep.realtime_factor, stage_totals=rep.stage_totals(), link=rep.link,
             compile_variants=rep.compile_variants, launches=launches, pngs_equal_single_file=True, **extra)

    report: dict = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main([str(d), "-o", str(tmp / "fleet_cli"), "-q", "--ingest", "device"], report=report)
    torch.cuda.synchronize()
    device_launches = ops.launch_counts()
    if rc != 1:
        raise AssertionError(f"the fleet CLI returned {rc}, not 1 (one pass fails)")
    check("cli --ingest device", report["fleet"], time.perf_counter() - t0, device_launches,
          {"polyphase_resample": n, "demod_fir_corr": n, "select_peaks": n, "unpack_sealed": 0}, "device")

    batches = []
    real = Decoder.decode_render_batch

    def counted(self, payloads, *a, **kw):
        batches.append(len(payloads))
        return real(self, payloads, *a, **kw)

    Decoder.decode_render_batch = counted
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = decode_fleet(sorted(d.glob("*.wav")), tmp / "fleet_host16c", profile=STANDARD,
                           ingest="host16c", fleet_batch=4)
        torch.cuda.synchronize()
        host16c_launches = ops.launch_counts()
    finally:
        Decoder.decode_render_batch = real
    n_l1 = sum(r == 24960 for r in rates.values())  # l == 1: no payload, the device path
    check("decode_fleet host16c", rep, time.perf_counter() - t0, host16c_launches,
          {"polyphase_resample": n_l1, "demod_fir_corr": n, "select_peaks": n_l1 + len(batches),
           "unpack_sealed": n - n_l1}, "host16c", batches=batches)
    return {"device": device_launches, "host16c": host16c_launches, "batches": len(batches)}


# The kernels' names in a trace (csrc/*.cu), by wrapper.
TRACE_KERNELS = {"polyphase_resample": ("polyphase_kernel", "block_kernel", "class_kernel"),
                 "demod_fir_corr": ("demod_fir_corr_kernel",),
                 "select_peaks": ("select_summary_kernel", "select_walk_kernel")}
GPU_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals) -> float:
    """Microseconds covered by the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_trace_phase(torch, tmp: Path, wav48: Path, spr: int) -> dict:
    """The default CLI on the 48 kHz pass with ``--profile-trace``: the
    Chrome trace's K1/K2/K3 kernel events (each must be there), the card's
    busy time (the union of its kernel, copy and memset intervals), the
    traced window (first to last event) and the idle share.  Returns the
    kernel event counts."""
    report = main_path_phase(torch, wav48, tmp / "trace.png", 48000, spr, "block",
                             ("-q", "--profile-trace", str(tmp / "trace")), label="profile_trace",
                             phase="profile_trace_run")
    events = [e for e in json.loads(Path(report["trace"]).read_text())["traceEvents"]
              if "ts" in e and "dur" in e]
    gpu = [e for e in events if e.get("cat") in GPU_EVENTS]
    kernels = {}
    for name, subs in TRACE_KERNELS.items():
        hits = [(e, k) for e in gpu if e["cat"] == "kernel" for k in subs if k in e["name"]]
        if not hits:
            raise AssertionError(f"the trace holds no {name} kernel event ({subs})")
        names = set()
        for e, k in hits:  # the kernel's name and template arguments, without its parameters
            j = e["name"].find(k)
            names.add(e["name"][j : e["name"].find("(", j)])
        kernels[name] = {"events": len(hits), "ms": sum(float(e["dur"]) for e, _ in hits) / 1e3,
                         "names": sorted(names)}
    busy = union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in gpu) / 1e3
    t0 = min(float(e["ts"]) for e in events)
    window = (max(float(e["ts"]) + float(e["dur"]) for e in events) - t0) / 1e3
    by_cat = {c: sum(float(e["dur"]) for e in gpu if e["cat"] == c) / 1e3 for c in GPU_EVENTS}
    emit("profile_trace", rate=48000, trace=Path(report["trace"]).name, events=len(events),
         gpu_events=len(gpu), kernels=kernels, gpu_ms_by_category=by_cat, gpu_busy_ms=busy,
         window_ms=window, idle_share=1.0 - busy / window, cli_wall_s=report["wall_s"],
         launches=report["launches"])
    return {name: k["events"] for name, k in kernels.items()}


class Recorder:
    """Stands in for a kernel's wrapper during a main-path run: passes
    every call through to ``fn`` and keeps the arguments and result of
    the first two calls, of every ``every``-th and of the last, for
    :func:`twin_checks`.  The wrapper still counts its own launches, so
    the stand-in moves no count."""

    def __init__(self, fn, every: int = 32):
        self.fn, self.every, self.calls, self.kept, self.last = fn, every, 0, {}, None

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.last = (self.calls, args, kw, out)
        if self.calls < 2 or self.calls % self.every == 0:
            self.kept[self.calls] = (args, kw, out)
        self.calls += 1
        return out

    def recorded(self) -> dict:
        """Call index -> (args, kwargs, result), the last call included."""
        if self.last is None:
            return {}
        i, args, kw, out = self.last
        return {**self.kept, i: (args, kw, out)}


def twin_checks(torch, label: str, k1: Recorder | None = None, k2: Recorder | None = None,
                k3: Recorder | None = None) -> dict:
    """Each recorded launch of K1, K2 and K3 held ``torch.equal`` to its
    plain twin on the same inputs, and to a second launch of its wrapper
    (which names K1's variant); K2 on a window that starts past its
    buffer's first sample (a view of K1's output, as the stream's first
    chunk passes it) is also launched on the whole buffer and held to the
    twin there.  These launches come after the run's counts were read.
    Emits and returns the shapes checked per kernel."""
    from noaa_apt_tpu_torch.ops import resample as rs
    from noaa_apt_tpu_torch.ops import select as sel
    from noaa_apt_tpu_torch.ops import stage as st

    out = {}
    for i, (args, kw, y) in sorted((k1.recorded() if k1 else {}).items()):
        x, bank, _, _, m, n_out = args
        name = f"polyphase_resample@{label} call {i}"
        assert_equal(torch, name, y, rs.polyphase_resample_plain(*args, **kw))
        assert_equal(torch, f"{name} relaunched", rs.polyphase_resample(*args, **kw), y)
        out.setdefault("polyphase_resample", []).append(
            f"call {i}: {str(x.dtype)[6:]}[{x.shape[0]}] -> f32[{n_out}], l={bank.shape[0]} m={m} "
            f"T={bank.shape[1]} k0={kw.get('k0', 0)}, {rs.polyphase_resample.last_variant}")
    for i, (args, kw, (filt, corr)) in sorted((k2.recorded() if k2 else {}).items()):
        y, rest = args[0], args[1:]
        name = f"demod_fir_corr@{label} call {i}"
        pf, pc = st.demod_fir_corr_plain(*args, **kw)
        assert_equal(torch, f"{name}.filt", filt, pf)
        assert_equal(torch, f"{name}.corr", corr, pc)
        shape = f"call {i}: f32[{y.shape[0]}] at offset {y.storage_offset()}"
        if y.storage_offset() > 0:
            whole = y._base if y._base is not None else y
            f_all, c_all = st.demod_fir_corr(whole, *rest, **kw)
            pf, pc = st.demod_fir_corr_plain(whole, *rest, **kw)
            assert_equal(torch, f"{name} whole buffer .filt", f_all, pf)
            assert_equal(torch, f"{name} whole buffer .corr", c_all, pc)
            shape += f", and its whole buffer f32[{whole.shape[0]}]"
        out.setdefault("demod_fir_corr", []).append(shape)
    for i, (args, kw, _) in sorted((k3.recorded() if k3 else {}).items()):
        corr, n_valid, spr, md, max_peaks = args
        name = f"select_peaks@{label} call {i}"
        pk, kk = sel.select_peaks(corr, n_valid, spr, md, max_peaks)
        ppk, pkk = sel.select_peaks_plain(corr, n_valid, spr, md, max_peaks)
        assert_equal(torch, f"{name}.k", kk, pkk)
        assert_equal(torch, f"{name}.peaks", pk, ppk)
        out.setdefault("select_peaks", []).append(
            f"call {i}: f32{list(corr.shape)}, n_valid={list(n_valid)}, spr={spr} md={md} "
            f"max_peaks={max_peaks}")
    emit("twin_checks", run=label, bit_equal=True, shapes=out)
    return out


@contextlib.contextmanager
def step_recorders():
    """K1, K2 and K3 recorded (``Recorder``) where the step decode
    (``graph/debug.py``) calls them, for :func:`twin_checks`: K1 at the
    work rate and the 1-tap NoFilter K1 of the 4160 Hz step (at m = 1
    where ``--wav-steps`` and ``--export-resample-filtered`` write its
    full-rate signal), K2 and K3.  The export grid's K1
    (``expanded_filtered``) is not recorded: ``export_grid_case`` holds
    it.  Yields ``(k1, k2, k3)``."""
    from types import SimpleNamespace
    from unittest import mock

    from noaa_apt_tpu_torch.graph import debug

    rs = SimpleNamespace(**{k: getattr(debug.rs, k) for k in dir(debug.rs) if not k.startswith("__")})
    k1 = rs.polyphase_resample = Recorder(debug.rs.polyphase_resample)
    k2, k3 = Recorder(debug.demod_fir_corr), Recorder(debug.select_peaks)
    with mock.patch.object(debug, "rs", rs), mock.patch.object(debug, "demod_fir_corr", k2), \
            mock.patch.object(debug, "select_peaks", k3):
        yield k1, k2, k3


def recorded_steps_run(torch, *a, **kw) -> dict:
    """``main_path_phase(*a, **kw)`` under :func:`step_recorders`, then
    :func:`twin_checks` on every launch recorded.  Returns the run's
    report."""
    with step_recorders() as (k1, k2, k3):
        report = main_path_phase(torch, *a, **kw)
    twin_checks(torch, f"{kw.get('label')} {Path(a[0]).name}", k1, k2, k3)
    return report


STEPS_LAUNCHES = {"polyphase_resample": 2, "demod_fir_corr": 1, "select_peaks": 1, "unpack_sealed": 0}
STEPS_ROWS = 120  # 60 s of a pass


def export_grid_case(torch, dev, wav_path: Path, variant: str) -> dict:
    """K1 at m = 1 (``ops/resample.expanded_filtered``, the export grid's
    ``ef``) on the float32 samples of ``wav_path``, as the step path runs
    it: ``torch.equal`` to its twin over the whole grid and in three ``k0``
    windows (start, middle, end), timed as in phase 3 beside ``F.conv1d``
    at stride 1.  Emits and returns the record."""
    from types import SimpleNamespace

    import numpy as np

    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph.decode import _ingest_filter, _plan_resample_with_filter
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.ops import resample as rs

    signal, rate = wav.load_device_ready(wav_path)
    x = torch.from_numpy(np.asarray(signal, np.float32)).to(dev)
    l, _, coeff = _plan_resample_with_filter(rate, Rate(STANDARD.work_rate), _ingest_filter(STANDARD, rate))
    plan = rs.resample_plan(x.shape[0], l, 1, coeff)
    p_c, s_c, bank, _, _ = rs.phase_tables(plan)
    t = SimpleNamespace(bank=bank, p_c=p_c.astype(np.int32), s_c=s_c.astype(np.int32), l=l, m=1)
    label = f"{rate.hz}/standard export grid, m = 1"
    rec, y = resample_case(torch, dev, x, t, label, work=plan.out_len)
    if rec["variant"] != variant:
        raise AssertionError(f"{label}: K1 ran {rec['variant']}, not {variant}")
    if not torch.equal(y, rs.expanded_filtered(x, l, coeff)):
        raise AssertionError(f"{label}: expanded_filtered differs from the case's launch")
    args = [torch.from_numpy(a).to(dev) for a in (t.bank, t.p_c, t.s_c)]
    n, w = plan.out_len, 1 << 20
    windows = [(5, w), (n // 2 - 7, w), (n - w + 3, w - 3)]
    for k0, size in windows:
        got = rs.polyphase_resample(x, *args, 1, size, k0=k0)
        assert_equal(torch, f"{label} k0={k0}", got, rs.polyphase_resample_plain(x, *args, 1, size, k0=k0))
        assert_equal(torch, f"{label} k0={k0} vs one launch", got, y[k0 : k0 + size])
    rec.update(k0_windows=windows, outputs=n, rate=rate.hz)
    emit("export_grid", name="polyphase_resample", bit_equal=True, **rec)
    return rec


def steps_phase(torch, dev, tmp: Path, spr: int) -> dict:
    """``--wav-steps`` on a 60-s 48 kHz pass, and ``--wav-steps
    --export-resample-filtered`` on a 60-s 24960 Hz pass (l == 1: the grid
    stays, and the full-rate causal FIRs are written, K1 at m = 1 with 41
    taps and with NoFilter's one): each run's PNG byte-equal to the
    offline ``--raw-out`` run's and its raw signal equal to that run's,
    its step WAVs the context table's, K1 twice, K2 and K3 once.  Then
    ``--export-resample-filtered`` alone on 60-s 48 kHz and 11025 Hz
    passes (the same launches), and K1 at m = 1 at both rates
    (``export_grid_case``).  Every K1, K2 and K3 launch of these runs is
    held to its twin (``recorded_steps_run``).  Returns the launches of
    each run and the K1 records."""
    import numpy as np

    from noaa_apt_tpu_torch import FINAL_RATE
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.io.context import Context

    paths = {rate: tmp / f"pass_{rate}_60s.wav" for rate in (48000, 11025, 24960)}
    for rate, path in paths.items():
        synth_wav(path, rate, STEPS_ROWS)
    table = Context.decode(work_rate=Rate(STANDARD.work_rate), final_rate=Rate(FINAL_RATE)).steps_metadata
    launches = {}
    for rate, flags in ((48000, ("--wav-steps",)), (24960, ("--wav-steps", "--export-resample-filtered"))):
        tag = f"{rate}_{'_'.join(f.strip('-').replace('-', '_') for f in flags)}"
        main_path_phase(torch, paths[rate], tmp / f"steps_off_{rate}.png", rate, spr, None,
                        ("-q", "--raw-out", str(tmp / f"steps_off_{rate}.npy")), label="60 s --raw-out",
                        phase="steps", pass_rows=STEPS_ROWS)
        out = tmp / f"steps_{tag}"
        out.mkdir()
        cwd = Path.cwd()
        os.chdir(out)  # the step WAVs go to the working directory, as in the reference
        try:
            report = recorded_steps_run(torch, paths[rate], out / "steps.png", rate, spr, None,
                                        ("-q", *flags, "--raw-out", str(tmp / f"steps_{tag}.npy")),
                                        expect=STEPS_LAUNCHES, label=f"60 s {' '.join(flags)}", phase="steps",
                                        pass_rows=STEPS_ROWS)
        finally:
            os.chdir(cwd)
        want = sorted(f"{m.filename}.wav" for m in table if not m.id.startswith("telemetry")
                      and (m.id != "resample_filtered" or "--export-resample-filtered" in flags))
        got = sorted(p.name for p in out.glob("*.wav"))
        if got != want:
            raise AssertionError(f"{flags} at {rate} Hz wrote {got}, the table names {want}")
        if (out / "steps.png").read_bytes() != (tmp / f"steps_off_{rate}.png").read_bytes():
            raise AssertionError(f"the {flags} PNG at {rate} Hz differs from the --raw-out run's")
        if not np.array_equal(np.load(tmp / f"steps_{tag}.npy"), np.load(tmp / f"steps_off_{rate}.npy")):
            raise AssertionError(f"the {flags} raw signal at {rate} Hz differs from the --raw-out run's")
        emit("steps_files", rate=rate, flags=list(flags), files=got,
             bytes=sum((out / g).stat().st_size for g in got), png_byte_equal=True, raw_equal=True,
             launches=report["launches"])
        launches[tag] = report["launches"]
    for rate in (48000, 11025):
        r = recorded_steps_run(torch, paths[rate], tmp / f"export_{rate}.png", rate, spr, "block",
                               ("-q", "--export-resample-filtered"), expect=STEPS_LAUNCHES,
                               label="60 s --export-resample-filtered", phase="steps", pass_rows=STEPS_ROWS)
        launches[f"export_{rate}"] = r["launches"]
    records = [export_grid_case(torch, dev, paths[48000], "block"),
               export_grid_case(torch, dev, paths[11025], "class")]
    return {"launches": launches, "records": records}


def stdin_pipe(data: bytes):
    """A pipe whose read end stands in for ``sys.stdin``, fed with ``data``
    by a thread in 64 KB writes: -> (stdin stand-in, the writer thread)."""
    import threading
    import types

    r, w = os.pipe()

    def feed():
        with os.fdopen(w, "wb") as f:
            for i in range(0, len(data), 1 << 16):
                f.write(data[i : i + (1 << 16)])

    thread = threading.Thread(target=feed, daemon=True)
    thread.start()
    return types.SimpleNamespace(buffer=os.fdopen(r, "rb", buffering=0)), thread


def stream_phase(torch, tmp: Path, wav48: Path, wav11: Path, wav25: Path, spr: int) -> dict:
    """``--stream --raw-out`` on the three 10-minute passes (from the file)
    and on the 11025 Hz pass as raw s16 on stdin (a pipe) with
    ``--stream-update 100``: each PNG byte-equal to the offline
    ``--raw-out`` run's and its sync list equal, K1 and K2 launched once a
    chunk and K3 never (counts set to 0 just before each run, read just
    after).  One line a run: chunks, first-row latency, wall, realtime
    factor, the greedy fold's host seconds, the median chunk's ms.
    Returns the launches of each run."""
    from unittest import mock

    import numpy as np

    from noaa_apt_tpu_torch import cli, ops
    from noaa_apt_tpu_torch.graph import window
    from noaa_apt_tpu_torch.io import wav

    offline = {}
    for path, rate in ((wav48, 48000), (wav11, 11025), (wav25, 24960)):
        offline[rate] = main_path_phase(torch, path, tmp / f"stream_offline_{rate}.png", rate, spr, None,
                                        ("-q", "--raw-out", str(tmp / f"stream_offline_{rate}.npy")),
                                        label="--raw-out", phase="stream_offline")
    pcm = np.asarray(wav.load_device_ready(wav11)[0], "<i2").tobytes()
    runs = [(str(path), rate, "file", ("--raw-out", str(tmp / f"stream_{rate}.npy")))
            for path, rate in ((wav48, 48000), (wav11, 11025), (wav25, 24960))]
    runs.append(("-", 11025, "stdin s16", ("--stream-rate", "11025", "--stream-update", "100")))
    launches = {}
    for src, rate, how, flags in runs:
        out = tmp / f"stream_{rate}_{how.split()[0]}.png"
        report: dict = {}
        stdin, thread = sys.stdin, None
        if src == "-":
            sys.stdin, thread = stdin_pipe(pcm)
        k1 = Recorder(window.polyphase_resample)
        k2 = Recorder(window.demod_fir_corr)
        try:
            with mock.patch.object(window, "polyphase_resample", k1), \
                    mock.patch.object(window, "demod_fir_corr", k2):
                ops.reset_launch_counts()
                rc = cli.main([src, "--stream", "-o", str(out), "-q", *flags], report=report)
                torch.cuda.synchronize()
                got = ops.launch_counts()
        finally:
            if thread is not None:
                sys.stdin.buffer.close()
                thread.join()
            sys.stdin = stdin
        if rc != 0:
            raise AssertionError(f"--stream on the {rate} Hz pass ({how}) returned {rc}")
        st = report["stream"]
        if got != {"polyphase_resample": st["chunks"], "demod_fir_corr": st["chunks"], "select_peaks": 0,
                   "unpack_sealed": 0}:
            raise AssertionError(f"--stream at {rate} Hz ({how}): launches {got}, {st['chunks']} chunks")
        if out.read_bytes() != (tmp / f"stream_offline_{rate}.png").read_bytes():
            raise AssertionError(f"--stream at {rate} Hz ({how}): the PNG differs from the --raw-out run's")
        if report["sync_positions"] != offline[rate]["sync_positions"]:
            raise AssertionError(f"--stream at {rate} Hz ({how}): sync positions differ from the offline run")
        if how == "file" and not np.array_equal(np.load(tmp / f"stream_{rate}.npy"),
                                                np.load(tmp / f"stream_offline_{rate}.npy")):
            raise AssertionError(f"--stream at {rate} Hz: the raw signal differs from the offline run's")
        launches[f"{rate} {how}"] = got
        twins = twin_checks(torch, f"--stream {rate} Hz {how}", k1, k2)
        emit("stream", rate=rate, source=how, flags=list(flags), rows=report["rows"], chunks=st["chunks"],
             launches=got, first_row_s=st["first_row_s"], wall_s=report["wall_s"], audio_s=st["audio_s"],
             realtime_factor=st["audio_s"] / report["wall_s"], fold_s=st["fold_s"],
             chunk_ms_median=statistics.median(st["chunk_ms"]), chunk_ms_max=max(st["chunk_ms"]),
             png_byte_equal=True, sync_equal=True,
             chunks_held_to_twin={k: len(v) for k, v in twins.items()})
    return launches


SHARD_COUNTS = (2, 4, 8)
DIST_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
DIST_WORKER_TIMEOUT_S = 300
BATCH_SHIFT = 4800  # the global batch's second row starts 0.1 s into the 48 kHz pass


def sharded_decodes(torch, wav48: Path, wav11: Path, wav25: Path) -> dict:
    """``ShardedDecoder`` over ``["cuda:0"] * n`` for each of
    ``SHARD_COUNTS`` (and over every card where there are several) on the
    three 10-minute passes: the percent u8 and sync list byte-equal to
    ``Decoder.decode_render_input``'s, the no-sync rows ``torch.equal`` to
    ``Decoder.decode``'s, K1 = K2 = n and K3 = 1 a decode (counts set to 0
    just before the recorded decode, read just after), every shard's K1 and
    K2 launch held to its twin.  One line a mesh and pass: stage ms and
    wall beside the one-device decode's.  Returns the launches of each."""
    from unittest import mock

    import numpy as np

    from noaa_apt_tpu_torch import ops
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph import window
    from noaa_apt_tpu_torch.graph.decode import Decoder
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.parallel import Mesh, ShardedDecoder

    meshes = [(f"cuda:0 x {n}", ["cuda:0"] * n) for n in SHARD_COUNTS]
    if torch.cuda.device_count() > 1:
        meshes.append((f"every card ({torch.cuda.device_count()})",
                       [f"cuda:{i}" for i in range(torch.cuda.device_count())]))

    def timed(dec, signal, rate, reps: int = 3) -> tuple[float, dict]:
        """Median wall ms of ``reps`` warm renders, and the last one's stages."""
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            dec.decode_render_input(signal, len(signal), rate)
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls), dict(dec.last_stage_ms)

    out = {}
    for path, rate_hz in ((wav48, 48000), (wav11, 11025), (wav25, 24960)):
        signal, rate = wav.load_device_ready(path)
        signal = np.array(signal)  # in RAM once, as both decoders read it
        single = Decoder(STANDARD)
        u8_1, sync_1 = single.decode_render_input(signal, len(signal), rate)
        rows_1 = single.decode(signal, rate, sync=False)
        single_wall, single_ms = timed(single, signal, rate)
        for label, devices in meshes:
            n = len(devices)
            sdec = ShardedDecoder(STANDARD, Mesh(devices, ("seq",)))
            sdec.decode_render_input(signal, len(signal), rate)  # every device's tables
            k1, k2 = Recorder(window.polyphase_resample, every=1), Recorder(window.demod_fir_corr, every=1)
            with mock.patch.object(window, "polyphase_resample", k1), \
                    mock.patch.object(window, "demod_fir_corr", k2):
                ops.reset_launch_counts()
                u8_s, sync_s = sdec.decode_render_input(signal, len(signal), rate)
                torch.cuda.synchronize()
                got = ops.launch_counts()
            expect = {"polyphase_resample": n, "demod_fir_corr": n, "select_peaks": 1, "unpack_sealed": 0}
            if got != expect:
                raise AssertionError(f"sharded {rate_hz} Hz on {label}: launches {got}, expected {expect}")
            if sync_s != sync_1 or not np.array_equal(u8_s, u8_1):
                raise AssertionError(f"sharded {rate_hz} Hz on {label}: the render differs from one device's")
            ops.reset_launch_counts()
            rows_s = sdec.decode(signal, rate, sync=False)
            torch.cuda.synchronize()
            no_sync = ops.launch_counts()
            if no_sync != {**expect, "select_peaks": 0} or not torch.equal(rows_s.image, rows_1.image):
                raise AssertionError(f"sharded {rate_hz} Hz on {label}, no sync: launches {no_sync} or rows differ")
            twins = twin_checks(torch, f"sharded {rate_hz} Hz {label}", k1, k2)
            wall, stage_ms = timed(sdec, signal, rate)
            plan = sdec.plan(len(signal), rate)
            g = plan.geom
            emit("distributed", rate=rate_hz, mesh=label, shards=n, launches=got, no_sync_launches=no_sync,
                 w=g.w, ci=g.ci, l_in=g.l_in, r_in=g.r_in, n_pad=plan.n_pad, rows=rows_s.n_rows,
                 wall_ms=wall, stage_ms=stage_ms, device_ms=sum(stage_ms.values()),
                 single_wall_ms=single_wall, single_stage_ms=single_ms,
                 single_device_ms=sum(single_ms.values()), u8_byte_equal=True, sync_equal=True,
                 no_sync_rows_equal=True, launches_held_to_twin={k: len(v) for k, v in twins.items()})
            out[f"{rate_hz} {label}"] = got
    return out


def distributed_cli_runs(torch, tmp: Path, wav48: Path, spr: int) -> dict:
    """The CLI with ``--distributed 2`` on the 48 kHz pass, fused, with
    ``--no-sync`` and with ``--raw-out``: each PNG byte-equal to the
    one-device run's (``main_path_runs``), the raw signal equal to its.
    On one card ``--distributed 2`` takes the one card (the first
    ``min(N, cards)``, as ``jax.devices()[:N]``)."""
    import numpy as np

    n = min(2, torch.cuda.device_count())
    out = {}
    for name, flags in (("98_percent", ()), ("no_sync", ("--no-sync",)),
                        ("raw_out", ("--raw-out", str(tmp / "raw_distributed.npy")))):
        expect = {"polyphase_resample": n, "demod_fir_corr": n,
                  "select_peaks": 0 if name == "no_sync" else 1, "unpack_sealed": 0}
        rep = main_path_phase(torch, wav48, tmp / f"distributed_{name}_48000.png", 48000, spr, "block",
                              ("-q", "--distributed", "2", *flags), expect=expect,
                              label=f"--distributed 2 {name}", phase="distributed_cli")
        if (tmp / f"distributed_{name}_48000.png").read_bytes() != (tmp / f"{name}_48000.png").read_bytes():
            raise AssertionError(f"--distributed 2 {name}: the PNG differs from the one-device run's")
        if "gather" not in rep["stage_ms"]:
            raise AssertionError(f"--distributed 2 {name} did not take the sharded decoder: {rep['stage_ms']}")
        out[f"--distributed 2 {name}"] = rep["launches"]
    if not np.array_equal(np.load(tmp / "raw_distributed.npy"), np.load(tmp / "raw.npy")):
        raise AssertionError("--distributed 2 --raw-out: the raw signal differs from the one-device run's")
    emit("distributed_cli_vs_single", shards=n, png_byte_equal=True, raw_equal=True)
    return out


def dist_worker(tmp: Path, wav48: Path) -> int:
    """One process of :func:`multiprocess_phase` (``chip_smoke.py
    --dist-worker TMP WAV48``, coordinated by ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``): the CLI's ``--multihost``
    over the fleet directory, its launches counted, then one global batch
    of two 48 kHz rows (this process's: the pass from ``pid * BATCH_SHIFT``
    on) through ``batch_decode``, every result held to the one-device
    decode.  Prints one JSON line."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from noaa_apt_tpu_torch import cli, ops
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.parallel import batch_decode, global_batch, topology_mesh
    from noaa_apt_tpu_torch.parallel.dist import rank, world_size

    pid = int(os.environ["JAX_PROCESS_ID"])
    report: dict = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main([str(tmp / "fleet_in"), "-o", str(tmp / f"multihost_{pid}"), "-q", "--multihost"],
                  report=report)
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    fleet = report["fleet"]
    signal, rate = wav.load_device_ready(wav48)
    signal = np.array(signal)
    n = len(signal) - BATCH_SHIFT
    rows = [signal[p * BATCH_SHIFT : p * BATCH_SHIFT + n] for p in range(2)]
    mesh = topology_mesh()
    dec = Decoder(STANDARD)
    t0 = time.perf_counter()
    results = batch_decode(dec, global_batch(mesh, np.stack([rows[pid]])), rate, mesh, axis="data")
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    singles = [dec.decode(x, rate) for x in rows]
    equal = len(results) == 2 and all(r.sync_positions == s.sync_positions and torch.equal(r.image, s.image)
                                      for r, s in zip(results, singles))
    print(json.dumps({"pid": pid, "rank": rank(), "world": world_size(), "rc": rc,
                      "ok": [r.input_path.name for r in fleet.ok],
                      "failed": [r.input_path.name for r in fleet.failed], "launches": launches,
                      "fleet_wall_s": fleet_wall, "mesh": mesh.shape, "batch_results": len(results),
                      "batch_rows": [r.n_rows for r in results], "batch_equal_single": equal,
                      "batch_wall_s": batch_wall}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def multiprocess_phase(torch, tmp: Path, wav48: Path) -> dict:
    """Two port processes on the one card, joined in a gloo process group
    (``JAX_COORDINATOR_ADDRESS`` on 127.0.0.1): the CLI's ``--multihost``
    over the ``fleet`` phase's directory (shares disjoint and complete, each
    PNG byte-equal to the one-process fleet's, each process's launches
    those of its share), then a two-process global batch (both processes
    get both results, equal to the one-device decode).  Returns each
    process's fleet launches."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker", str(tmp), str(wav48)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**env, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                                   "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid)})
             for pid in range(2)]
    t0 = time.perf_counter()
    results = []
    try:
        for p in procs:
            out, errs = p.communicate(timeout=DIST_WORKER_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"dist worker exited {p.returncode}: {errs[-3000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    names = sorted(p.name for p in (tmp / "fleet_in").glob("*.wav"))
    shares = [sorted(r["ok"] + r["failed"]) for r in results]
    if sorted(shares[0] + shares[1]) != names or set(shares[0]) & set(shares[1]):
        raise AssertionError(f"multihost shares {shares} do not partition {names}")
    out = {}
    for r in results:
        if (r["rank"], r["world"]) != (r["pid"], 2) or r["failed"] not in ([], ["truncated.wav"]):
            raise AssertionError(f"multihost process {r['pid']}: {r}")
        if r["rc"] != (1 if r["failed"] else 0):
            raise AssertionError(f"multihost process {r['pid']} returned {r['rc']} with failures {r['failed']}")
        k = len(r["ok"])
        if r["launches"] != {"polyphase_resample": k, "demod_fir_corr": k, "select_peaks": k,
                             "unpack_sealed": 0}:
            raise AssertionError(f"multihost process {r['pid']}: launches {r['launches']} for {k} passes")
        for name in r["ok"]:
            png_name = name[: -len(".wav")] + ".png"
            got = (tmp / f"multihost_{r['pid']}" / png_name).read_bytes()
            if got != (tmp / "fleet_cli" / png_name).read_bytes():
                raise AssertionError(f"multihost process {r['pid']}: {png_name} differs from the one-process fleet's")
        if r["batch_results"] != 2 or not r["batch_equal_single"] or r["mesh"] != {"data": 2, "seq": 1}:
            raise AssertionError(f"global batch in process {r['pid']}: {r}")
        out[f"multihost process {r['pid']}"] = r["launches"]
    emit("distributed_multiprocess", processes=2, backend="gloo", wall_s=wall, shares=shares,
         pngs_equal_single_process=True, global_batch_equal_single=True, workers=results)
    return out


def distributed_phase(torch, tmp: Path, wav48: Path, wav11: Path, wav25: Path, spr: int) -> dict:
    """Phase 16: the sharded decodes, the ``--distributed`` CLI runs and
    the two-process runs; returns every run's launches."""
    return {**sharded_decodes(torch, wav48, wav11, wav25), **distributed_cli_runs(torch, tmp, wav48, spr),
            **multiprocess_phase(torch, tmp, wav48)}


NO_LAUNCHES = {k: 0 for k in ALL_ONCE}


def u8_diff(got, want, what: str, exact: bool) -> dict:
    """Max |difference| and differing pixels of two u8 images; raises
    unless they are equal (``exact``) or within the port's rule, +-1 on
    at most 0.1% of values."""
    import numpy as np

    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape}, expected {want.shape}")
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    out = {"max_abs": int(d.max(initial=0)), "pixels": int((d > 0).any(axis=-1).sum()),
           "values": int((d > 0).sum())}
    if out["max_abs"] > (0 if exact else 1) or out["values"] > 1e-3 * d.size:
        raise AssertionError(f"{what}: {out} of {d.size} values")
    return out


def gui_phase(torch, dev, tmp: Path, wav48: Path, spr: int) -> dict:
    """Phase 17: the GUI's logic layer (``noaa_apt_tpu_torch.gui.work``)
    headless on the card: in-memory ``Widgets``, inline ``idle_add``,
    ``GuiState(device=dev)`` (``cuda``), the launch counts set to 0 just before
    each action and read just after; no action may end with an error in
    the info bar, and each must end on its own progress text.  Decode
    (K1, K2, K3 once, each launch held to its twin, the rows on the
    card); Process 98_percent ``-R no`` and Save, the pixels equal to the
    CLI's ``--raw-out`` run's (the same unfused path) and within the u8
    rule of the default fused run's; Process minmax (no launch);
    Process with the overlay, ``auto`` rotation and the pinned TLE, equal
    to the CLI's ``-m yes -R auto --raw-out`` run's and within the rule of
    ``map_path``'s; an auto-update burst (three knob changes while one
    Process is in flight: two Process runs, no launch, the image of the
    last knobs); Decode with "WAV steps" on the 60-s pass (K1 twice, K2,
    K3 once, held to their twins; the flat signal the ``--raw-out``
    run's); the Resample tool 48000 -> 11025 (K1 once, the CLI ``-r``
    run's WAV); a timestamp write and read.  Returns each action's
    launches."""
    import threading
    from datetime import datetime
    from unittest import mock

    import numpy as np

    from noaa_apt_tpu_torch import ops
    from noaa_apt_tpu_torch.graph import decode as gdecode
    from noaa_apt_tpu_torch.gui import state as gstate
    from noaa_apt_tpu_torch.gui import work
    from noaa_apt_tpu_torch.io import config as cfg
    from noaa_apt_tpu_torch.io import png, wav

    w = gstate.Widgets()
    state = gstate.GuiState(settings=cfg.build_settings(cfg.load_de_settings()), device=dev)
    gstate.set_widgets(w)
    gstate.set_state(state)
    gstate.wire_auto_update(w, work.process_if_auto_update_enabled)  # as the Tk shell wires it
    work._auto_update_pending = False
    launches, walls = {}, {}

    def settle(before: set) -> None:
        """Join every thread started since ``before``: the action's worker
        and the reruns an auto-update burst spawns from a finishing one."""
        while True:
            new = [t for t in threading.enumerate() if t not in before and t.is_alive()]
            if not new:
                return
            for t in new:
                t.join(timeout=600)
                if t.is_alive():
                    raise AssertionError(f"a GUI worker is still running after 600 s: {t.name}")

    def act(name: str, fn, done: str, expect: dict) -> None:
        before = set(threading.enumerate())
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fn()
        settle(before)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = ops.launch_counts()
        if w.info.revealed and w.info.kind == "error":
            raise AssertionError(f"GUI {name}: error in the info bar: {w.info.text}")
        if w.progress.description != done:
            raise AssertionError(f"GUI {name}: progress ends on {w.progress.description!r}, not {done!r}")
        if launches[name] != expect:
            raise AssertionError(f"GUI {name}: launches {launches[name]}, expected {expect}")

    # Decode, with every kernel launch recorded for twin_checks.
    w.dec_input_chooser.set(str(wav48))
    k1, k2, k3 = (Recorder(getattr(gdecode, n)) for n in ("polyphase_resample", "demod_fir_corr", "select_peaks"))
    with mock.patch.object(gdecode, "polyphase_resample", k1), mock.patch.object(gdecode, "demod_fir_corr", k2), \
            mock.patch.object(gdecode, "select_peaks", k3):
        act("decode", work.decode, "Decoded", ALL_ONCE)
    result = state.decoded_signal
    if result.image.device.type != dev.type or state.decoder.device.type != dev.type:
        raise AssertionError(f"GUI decode: rows on {result.image.device}, decoder on {state.decoder.device}")
    rows = int(result.image.shape[0])
    if abs(rows - PASS_ROWS) > 2:
        raise AssertionError(f"GUI decode: {rows} rows, synthesized {PASS_ROWS}")
    twin_checks(torch, "gui decode", k1, k2, k3)

    # Process 98_percent, no rotation, and Save: the CLI's pixels.
    w.p_contrast_combo.set("98_percent")
    w.p_rotate_combo.set("no")
    act("process_98_percent", work.process, "Processed", NO_LAUNCHES)
    w.sav_output_entry.set(str(tmp / "gui_98_percent.png"))
    act("save", work.save, "Saved", NO_LAUNCHES)
    saved = png.read_png(tmp / "gui_98_percent.png")
    diffs = {"save_vs_processed": u8_diff(saved, state.processed_image, "GUI save", True),
             "98_percent_vs_cli_raw_out": u8_diff(saved, png.read_png(tmp / "raw_out_48000.png"),
                                                  "GUI 98_percent against the CLI's --raw-out run", True),
             "98_percent_vs_cli_fused": u8_diff(saved, png.read_png(tmp / "98_percent_48000.png"),
                                                "GUI 98_percent against the CLI's fused run", False)}

    # The host preview that every Process ends with (gui/misc.update_image).
    from noaa_apt_tpu_torch.gui import misc as gmisc

    t0 = time.perf_counter()
    preview = gmisc.scale_preview(saved, w.image.viewport_size(), False)
    walls["preview_only"] = time.perf_counter() - t0
    if not np.array_equal(preview, w.image.preview):
        raise AssertionError("GUI preview: scale_preview differs from the preview the Process set")

    # Process again with minmax: the cached rows, no kernel.
    w.p_contrast_combo.set("minmax")
    act("process_minmax", work.process, "Processed", NO_LAUNCHES)
    minmax = state.processed_image

    # The overlay with auto rotation and the pinned TLE.
    tle = tmp / "gui_tle.txt"
    tle.write_text(MAP_TLE)
    local = datetime.fromisoformat(MAP_START).astimezone()
    for name, value in (("p_contrast_combo", "98_percent"), ("p_rotate_combo", "auto"),
                        ("p_overlay_check", True), ("p_satellite_combo", "noaa_19"),
                        ("p_custom_tle_check", True), ("p_custom_tle_chooser", str(tle)),
                        ("p_ref_time_combo", "start"), ("p_calendar", (local.year, local.month, local.day)),
                        ("p_hs_spinner", local.hour), ("p_min_spinner", local.minute),
                        ("p_sec_spinner", local.second)):
        getattr(w, name).set(value)
    act("process_map_auto", work.process, "Processed", NO_LAUNCHES)
    gui_map = state.processed_image
    map_flags = ("-q", "-m", "yes", "-R", "auto", "-s", "noaa_19", "-T", str(tle), "-t", MAP_START,
                 "--raw-out", str(tmp / "gui_map.npy"))
    main_path_phase(torch, wav48, tmp / "gui_cli_map.png", 48000, spr, "block", map_flags,
                    label="map_auto_rotate --raw-out", phase="gui_cli")
    diffs["map_vs_cli_raw_out"] = u8_diff(gui_map, png.read_png(tmp / "gui_cli_map.png"),
                                          "GUI map against the CLI's -m yes -R auto --raw-out run", True)
    diffs["map_vs_cli_fused"] = u8_diff(gui_map, png.read_png(tmp / "map.png"),
                                        "GUI map against map_path's fused run", False)
    ink_a, ink_b = ink(gui_map, 539), ink(gui_map, 1579)
    if min(ink_a, ink_b) <= 1000:
        raise AssertionError(f"GUI map: {ink_a} and {ink_b} ink pixels in the channel windows")

    # Auto-update burst: three knob changes while the first Process runs.
    w.p_overlay_check.set(False)
    w.p_rotate_combo.set("no")
    w.p_auto_update_check.set(True)
    runs = []
    real_process = work.process

    def counted():
        runs.append(1)
        return real_process()

    def burst():
        w.p_contrast_combo.set("histogram")
        w.p_contrast_combo.set("minmax")
        w.p_contrast_combo.set("98_percent")

    with mock.patch.object(work, "process", counted):
        act("auto_update_burst", burst, "Processed", NO_LAUNCHES)
    w.p_auto_update_check.set(False)
    if work._auto_update_pending or not 1 <= len(runs) <= 3:
        raise AssertionError(f"GUI burst: {len(runs)} Process runs, pending {work._auto_update_pending}")
    if not np.array_equal(state.processed_image, saved):
        raise AssertionError("GUI burst: the last image is not the 98_percent image of its last knobs")
    if np.array_equal(minmax, saved):
        raise AssertionError("GUI: the minmax image equals the 98_percent one")

    # Decode with "WAV steps" on the 60-s pass, every launch recorded.
    steps_wav = tmp / "pass_48000_60s.wav"
    out = tmp / "gui_steps"
    out.mkdir()
    w.dec_input_chooser.set(str(steps_wav))
    w.dec_wav_steps_check.set(True)
    cwd = Path.cwd()
    os.chdir(out)  # the step WAVs go to the working directory, as in the reference
    try:
        with step_recorders() as (s1, s2, s3):
            act("decode_wav_steps", work.decode, "Decoded", STEPS_LAUNCHES)
    finally:
        os.chdir(cwd)
    w.dec_wav_steps_check.set(False)
    flat, raw = state.decoded_signal, np.load(tmp / "steps_off_48000.npy")
    if flat.shape != raw.shape or not np.array_equal(flat, raw):
        raise AssertionError("GUI WAV steps: the flat signal differs from the --raw-out run's")
    diffs["wav_steps_flat_vs_raw_out"] = {"max_abs": float(np.abs(flat - raw).max(initial=0.0))}
    step_files = sorted(p.name for p in out.glob("*.wav"))
    if step_files != sorted(p.name for p in (tmp / "steps_48000_wav_steps").glob("*.wav")):
        raise AssertionError(f"GUI WAV steps wrote {step_files}")
    twin_checks(torch, "gui decode_wav_steps", s1, s2, s3)

    # The Resample tool, 48000 -> 11025: the CLI -r run's WAV.
    w.res_input_chooser.set(str(wav48))
    w.res_output_entry.set(str(tmp / "gui_resampled.wav"))
    w.res_rate_spinner.set(11025)
    act("resample", work.resample, "Finished", {**NO_LAUNCHES, "polyphase_resample": 1})
    got, spec = wav.load_wav(tmp / "gui_resampled.wav")
    want, want_spec = wav.load_wav(tmp / "resampled_48000_11025.wav")
    if spec != want_spec or not np.array_equal(got, want):
        raise AssertionError("GUI resample: the WAV differs from the CLI's -r 11025 run's")
    diffs["resample_vs_cli"] = {"max_abs": float(np.abs(got - want).max(initial=0.0))}

    # Timestamp write and read.
    stamp = tmp / "gui_stamp.wav"
    stamp.write_bytes(b"RIFF")
    w.ts_write_chooser.set(str(stamp))
    w.ts_calendar.set((2020, 1, 26))
    w.ts_hs_spinner.set(1)
    w.ts_min_spinner.set(33)
    w.ts_sec_spinner.set(20)
    t0 = time.perf_counter()
    work.write_timestamp()
    w.ts_calendar.set((1999, 1, 1))
    w.ts_read_chooser.set(str(stamp))
    work.read_timestamp()
    walls["timestamp_round_trip"] = time.perf_counter() - t0
    if w.info.text != "Loaded timestamp from file" or w.ts_calendar.get() != (2020, 1, 26) or \
            (w.ts_hs_spinner.get(), w.ts_min_spinner.get(), w.ts_sec_spinner.get()) != (1, 33, 20):
        raise AssertionError(f"GUI timestamp round trip: {w.info.text}, {w.ts_calendar.get()}")

    emit("gui", device=str(state.device), rows=rows, wall_s=walls, launches=launches,
         process_runs_in_burst=len(runs), diffs=diffs, ink_a=ink_a, ink_b=ink_b,
         step_files=len(step_files), nvidia_smi=nvidia_smi())
    return launches


def main() -> int:
    import torch

    if len(sys.argv) == 4 and sys.argv[1] == "--dist-worker":
        return dist_worker(Path(sys.argv[2]), Path(sys.argv[3]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from noaa_apt_tpu_torch.core.profiles import FAST, SLOW, STANDARD
        from noaa_apt_tpu_torch.device import resolve_device
        from noaa_apt_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}", file=sys.stderr)
        return 2

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    build_s = _build.build_all()
    ptxas = {}
    for name in _build.SOURCES:
        log = _build.lib_path(name).with_suffix(".log")
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text(errors="replace").splitlines()
                           if "registers" in ln or "spill" in ln]
    # Spill and stack bytes per source, summed over its kernels (want 0).
    spill = {name: sum(int(w.split()[0]) for ln in lines if "spill stores" in ln
                       for w in ln.split(",") if "spill" in w or "stack frame" in w)
             for name, lines in ptxas.items()}
    emit("build", seconds=build_s, wall_s=time.perf_counter() - t0, ptxas=ptxas,
         spill_and_stack_bytes=spill)
    if spill.get("resample", 0) != 0:
        raise AssertionError(f"K1 spills or keeps a stack frame: {ptxas['resample']}")

    spr = STANDARD.work_rate * 2080 // 4160
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        os.environ["XDG_CONFIG_HOME"] = str(tmp / "cfg")  # the CLI's settings file
        wav48, wav11, wav25 = (tmp / f"pass_{r}.wav" for r in (48000, 11025, 24960))
        t0 = time.perf_counter()
        for path, rate in ((wav48, 48000), (wav11, 11025), (wav25, 24960)):
            synth_wav(path, rate, PASS_ROWS)
        emit("synth", rows=PASS_ROWS, seconds=time.perf_counter() - t0)

        rec = kernel_phase(torch, dev, wav48, STANDARD, "48000/standard", batch4=True)
        kernel_phase(torch, dev, wav11, STANDARD, "11025/standard", batch4=False)
        for profile in (FAST, SLOW):
            for path, rate in ((wav48, 48000), (wav11, 11025)):
                stage_profile_phase(torch, dev, path, profile, f"{rate}/{profile.name}",
                                    k0_split=(profile, rate) == (SLOW, 11025))
        resample_rates_phase(torch, dev)
        l1_phase(torch, dev)
        global_bank_phase(torch, dev)
        non_finite_phase(torch, dev, wav48, wav11)
        reference_phase(torch)
        launches = main_path_runs(torch, tmp, wav48, wav11, wav25, spr)
        map_path_phase(torch, tmp, wav48, 48000, spr, "block")
        tool = resample_tool_phase(torch, dev, tmp, ((wav48, 48000, 11025, "phase"),
                                                     (wav11, 11025, 48000, "class"),
                                                     (wav25, 24960, 12480, "block")))
        select_stage_phase(wav48, rec["select_peaks"]["ms"])
        rec["unpack_sealed"] = unpack_phase(torch, dev, wav48)
        ingest_launches = ingest_path_phase(torch, tmp, wav48, wav11, spr)
        batch_k3 = batch_path_phase(torch, wav48)
        fleet = fleet_phase(torch, tmp, wav48, wav11, wav25, spr)
        trace = profile_trace_phase(torch, tmp, wav48, spr)
        steps = steps_phase(torch, dev, tmp, spr)
        stream = stream_phase(torch, tmp, wav48, wav11, wav25, spr)
        sharded = distributed_phase(torch, tmp, wav48, wav11, wav25, spr)
        gui = gui_phase(torch, dev, tmp, wav48, spr)

    sources = {
        "polyphase_resample": ("noaa_apt_tpu_torch/csrc/resample.cu", "noaa_apt_tpu/ops/resample.py:186"),
        "demod_fir_corr": ("noaa_apt_tpu_torch/csrc/stage.cu", "noaa_apt_tpu/ops/pallas_stage.py:161"),
        "select_peaks": ("noaa_apt_tpu_torch/csrc/select.cu", "noaa_apt_tpu/ops/pallas_select.py:214"),
        "unpack_sealed": ("noaa_apt_tpu_torch/csrc/unpack.cu", "noaa_apt_tpu/ops/pack.py:246"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = rec[name]
        # K4's path is the host16c ingest run; the others', the default CLI run.
        path_launches = ingest_launches if name == "unpack_sealed" else launches
        entry = {"name": name, "ok": True, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": path_launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"],
                 "fleet_launches": {"cli_device": fleet["device"][name], "host16c": fleet["host16c"][name]},
                 "steps_launches": {run: n[name] for run, n in steps["launches"].items()},
                 "stream_launches": {run: n[name] for run, n in stream.items()},
                 "sharded_launches": {run: n[name] for run, n in sharded.items()},
                 "gui_launches": {action: n[name] for action, n in gui.items()},
                 "trace_events": trace.get(name)}
        if name == "polyphase_resample":
            entry["variant"] = r["variant"]
            entry["float32"] = {key: r["float32"][key] for key in (
                "shape", "variant", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
            entry["resample_tool"] = [
                {key: t[key] for key in ("shape", "variant", "launches", "max_abs_err", "ms", "device_ms",
                                         "plain_ms", "bound_ms", "bound_by", "library_ms", "tool_wall_s")}
                for t in tool]
            entry["export_grid"] = [
                {key: t[key] for key in ("shape", "variant", "max_abs_err", "ms", "device_ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms", "k0_windows")}
                for t in steps["records"]]
        if name == "select_peaks":
            entry.update({key: r[key] for key in ("summary_ms", "walk_ms", "jumps", "walk_steps",
                                                  "ns_per_jump")})
            entry["batch_launches"] = batch_k3  # pallas_select.py:237's path: one per batch
            entry["fleet_batches"] = fleet["batches"]  # of the host16c fleet's K3 launches
        if name == "unpack_sealed":
            entry.update({key: r[key] for key in ("device_ms", "w_lo", "n_esc_pad", "sealed_bytes")})
        kernels.append(entry)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
