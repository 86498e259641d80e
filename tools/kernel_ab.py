#!/usr/bin/env python3
"""Time the kernels of several trees of this repository on one GPU.

    python3 tools/kernel_ab.py ROOT [ROOT ...]

Each ROOT is a tree of the repository, for example a ``git archive`` of
another commit unpacked into a git-ignored directory.  Each ROOT runs in
a process of its own, one after the other in the order given, so that
``A B B A`` compares two trees on one card within one call.

A process builds ROOT's kernels, synthesizes the 10-minute 48 kHz pass
of ``chip_smoke.py``, and runs ROOT's K1, K2 and K3 wrappers on it at
the main path's shapes (standard profile, B = 1; K3 also on four copies
of the row with different lengths, B = 4; K1 also on the fast and slow
profiles at 48 kHz, on the synthesized 11025 Hz pass on all three
profiles, and on seeded 10-minute int16 passes at 22050 Hz standard,
44100 Hz standard and slow, and, where ROOT's tables have the l == 1
path (``ops/resample.causal_input``), at 24960 and 12480 Hz standard and
41600 Hz slow over ``causal_input``, and at 24960 Hz fast (l = 2) and
41600 Hz standard (l = 3), at 11011 Hz slow and at the shapes of
``VERSUS``, with the variant it ran where ROOT's wrapper records one;
K1 with float32 input, the same samples, at each of these shapes, at 48
kHz standard and at the resample tool's three shapes, ``-r 11025`` on the
48 kHz pass, ``-r 48000`` on the 11025 Hz pass and ``-r 12480`` on a
24960 Hz pass; where ROOT's wrapper runs "block" and "class" for float32
input, K1 at the ``VERSUS`` shapes and at ``-r 11025`` also in the two
variants named there, whatever its dispatch picks; and, where ROOT has
it, K4 on the 48 kHz pass's host16c
sealed buffer).  It holds each result
``torch.equal`` to ROOT's plain twin, and times each call with
``time_ms`` of this tree's ``chip_smoke.py``, so that every tree is
timed the same way.  Where ROOT's K3 has a separate summary and walk
kernel, each of those is timed too.  Then ROOT's decoder runs the whole
pass ``DECODES`` times, and the median of each stage's CUDA-event time
is reported.

Prints the ``nvidia-smi`` line of the card, then one JSON object per
ROOT.  Needs CUDA.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
DECODES = 10
# (profile, rate) of the decoder shapes at which K1 also runs in two
# variants whatever its dispatch picks: "class" and "phase" where l > 32 and
# m > 4 l (m/l 4.0 to 14.1), "block" and "phase" where l <= 32 (every
# such shape of the standard, fast and slow profiles at these rates but
# 192 kHz standard, where a float32 block-major CTA does not fit).
VERSUS = (("standard", 50000), ("standard", 62500), ("standard", 88200), ("standard", 100000),
          ("standard", 176400), ("fast", 88200), ("fast", 100000), ("fast", 176400), ("slow", 88200),
          ("slow", 176400), ("slow", 250000),
          ("standard", 24000), ("standard", 96000), ("fast", 16000), ("fast", 32000), ("fast", 64000),
          ("fast", 96000), ("fast", 192000), ("slow", 8000), ("slow", 16000), ("slow", 24000),
          ("slow", 32000), ("slow", 64000), ("slow", 96000), ("slow", 100000), ("slow", 192000),
          ("fast", 48000), ("slow", 48000))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(root: Path) -> dict:
    """ROOT's kernels and decoder on the 48 kHz standard pass: -> their
    times in ms."""
    sys.path.insert(0, str(root))
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        os.environ["XDG_CONFIG_HOME"] = str(Path(tmp) / "cfg")  # the resample tool's settings file
        return _run_one(root, Path(tmp) / "pass_48000.wav")


def _run_one(root: Path, path: Path) -> dict:
    import numpy as np
    import torch

    import noaa_apt_tpu_torch
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import FAST, PROFILES, SLOW, STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder, DecodeTables
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.ops import _build
    from noaa_apt_tpu_torch.ops import demod as dm
    from noaa_apt_tpu_torch.ops import resample as rs
    from noaa_apt_tpu_torch.ops import select as sel
    from noaa_apt_tpu_torch.ops.resample import polyphase_resample, polyphase_resample_plain
    from noaa_apt_tpu_torch.ops.stage import demod_fir_corr, demod_fir_corr_plain
    from noaa_apt_tpu_torch.ops.sync import selector_params

    if not Path(noaa_apt_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {noaa_apt_tpu_torch.__file__}, not the package under {root}")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    build_s = _build.build_all()
    cs.synth_wav(path, 48000, cs.PASS_ROWS)
    signal, rate = wav.load_device_ready(path)
    t = DecodeTables.design(STANDARD, rate)
    x = torch.from_numpy(np.array(signal)).to(dev)
    work = t.work_len(x.shape[0])
    bank, p_c, s_c = (torch.from_numpy(a).to(dev) for a in (t.bank, t.p_c, t.s_c))
    taps, tmpl = torch.from_numpy(t.taps).to(dev), torch.from_numpy(t.template).to(dev)
    inv = dm.inv_sinphi(t.sinphi)
    spr, md, max_peaks = selector_params(work, Rate(STANDARD.work_rate))

    k1 = lambda: polyphase_resample(x, bank, p_c, s_c, t.m, work)  # noqa: E731
    y = k1()
    y_plain = polyphase_resample_plain(x, bank, p_c, s_c, t.m, work)
    cs.assert_equal(torch, "polyphase_resample", y, y_plain)
    k2 = lambda: demod_fir_corr(y, taps, tmpl, t.cosphi2, inv)  # noqa: E731
    filt, corr = k2()
    pf, pc = demod_fir_corr_plain(y, taps, tmpl, t.cosphi2, inv)
    cs.assert_equal(torch, "demod_fir_corr.filt", filt, pf)
    cs.assert_equal(torch, "demod_fir_corr.corr", corr, pc)
    rows, nvs = corr[None, :], [max(0, work - t.template.shape[0])]
    k3 = lambda: sel.select_peaks(rows, nvs, spr, md, max_peaks)  # noqa: E731
    pk, kk = k3()
    ppk, pkk = sel.select_peaks_plain(rows, nvs, spr, md, max_peaks)
    cs.assert_equal(torch, "select_peaks.k", kk, pkk)
    cs.assert_equal(torch, "select_peaks.peaks", pk, ppk)
    rows4 = corr[None, :].repeat(4, 1)
    nvs4 = [nvs[0], nvs[0] - 777, nvs[0] // 2, 12 * spr + 99]
    k3_b4 = lambda: sel.select_peaks(rows4, nvs4, spr, md, max_peaks)  # noqa: E731
    pk4, kk4 = k3_b4()
    ppk4, pkk4 = sel.select_peaks_plain(rows4, nvs4, spr, md, max_peaks)
    cs.assert_equal(torch, "select_peaks.k@B=4", kk4, pkk4)
    cs.assert_equal(torch, "select_peaks.peaks@B=4", pk4, ppk4)

    rec = {"root": str(root), "build_s": build_s, "k1_ms": cs.time_ms(torch, k1),
           "k1_device_ms": cs.device_ms(torch, k1),
           "k1_variant": getattr(polyphase_resample, "last_variant", None),
           "k2_ms": cs.time_ms(torch, k2), "k3_ms": cs.time_ms(torch, k3),
           "k3_b4_ms": cs.time_ms(torch, k3_b4), "k3_peaks": int(kk[0])}
    if hasattr(sel, "_walk_launch"):
        nv = np.asarray(nvs, np.int32)
        summ, _ = sel._summary_launch(rows, nv)
        res = torch.zeros((1, 3 + max_peaks), dtype=torch.int32, device=dev)  # room for either head
        rec["summary_ms"] = cs.time_ms(torch, lambda: sel._summary_launch(rows, nv))
        walk = lambda: sel._walk_launch(rows, nv, summ, spr, md, max_peaks, res)  # noqa: E731
        rec["walk_ms"] = cs.time_ms(torch, walk)
    # K1 on the other shapes, with int16 input and with the same samples
    # as float32: 48 kHz fast and slow, 11025 Hz on every profile, 22050
    # Hz standard, 44100 Hz standard and slow, 11011 Hz slow (a 320 KB
    # bank), the shapes of VERSUS; the l <= 3 rates where ROOT has the
    # l == 1 path.
    path11 = path.with_name("pass_11025.wav")
    cs.synth_wav(path11, 11025, cs.PASS_ROWS)
    pcm11 = np.array(wav.load_device_ready(path11)[0])
    shapes = [("48000_fast", FAST, 48000, np.array(signal)), ("48000_slow", SLOW, 48000, np.array(signal)),
              ("11025_standard", STANDARD, 11025, pcm11), ("11025_fast", FAST, 11025, pcm11),
              ("11025_slow", SLOW, 11025, pcm11), ("22050_standard", STANDARD, 22050, None),
              ("44100_standard", STANDARD, 44100, None), ("44100_slow", SLOW, 44100, None),
              ("11011_slow", SLOW, 11011, None)]
    shapes += [(f"{r}_{p}", PROFILES[p], r, None) for p, r in VERSUS if r != 48000]
    if hasattr(rs, "causal_input"):
        shapes += [("24960_standard", STANDARD, 24960, None), ("12480_standard", STANDARD, 12480, None),
                   ("41600_slow", SLOW, 41600, None), ("24960_fast", FAST, 24960, None),
                   ("41600_standard", STANDARD, 41600, None)]
    # Where ROOT's wrapper runs "block" and "class" for float32 input, K1
    # at the VERSUS shapes and the tool's 48000 -> 11025 Hz is also timed
    # in two variants (its variant rule replaced for those calls only).
    both = hasattr(rs, "k1_bank_ways")

    def k1_case(key, xk, tk, wk, variant=None):
        argk = [torch.from_numpy(a).to(dev) for a in (tk.bank, tk.p_c, tk.s_c)]
        k1k = lambda: polyphase_resample(xk, *argk, tk.m, wk)  # noqa: E731
        rule = rs._k1_variant
        if variant is not None:
            rs._k1_variant = lambda *_: variant
        try:
            cs.assert_equal(torch, f"polyphase_resample@{key}", k1k(),
                            polyphase_resample_plain(xk, *argk, tk.m, wk))
            rec[f"k1_{key}_variant"] = getattr(polyphase_resample, "last_variant", None)
            rec[f"k1_{key}_ms"] = cs.time_ms(torch, k1k)
            rec[f"k1_{key}_device_ms"] = cs.device_ms(torch, k1k)
        finally:
            rs._k1_variant = rule

    for key, profile, rate_k, pcm in shapes:
        tk = DecodeTables.design(profile, Rate(rate_k))
        x16 = torch.from_numpy(pcm if pcm is not None else cs.seeded_pcm(rate_k)).to(dev)
        wk = tk.work_len(x16.shape[0])
        for suffix, xk in (("", x16), ("_f32", x16.to(torch.float32))):
            if tk.l == 1:
                xk = rs.causal_input(xk, tk.bank.shape[1])
            k1_case(key + suffix, xk, tk, wk)
            if both and (profile.name, rate_k) in VERSUS:
                for variant in ("class" if tk.l > 32 else "block", "phase"):
                    k1_case(f"{key}{suffix}_as_{variant}", xk, tk, wk, variant)
    k1_case("48000_standard_f32", x.to(torch.float32), t, work)
    # The resample tool's shapes over the WAVs' float32 samples, as the
    # tool builds them.
    path25 = path.with_name("pass_24960.wav")
    cs.synth_wav(path25, 24960, cs.PASS_ROWS)
    for src, rin, rout in ((path, 48000, 11025), (path11, 11025, 48000), (path25, 24960, 12480)):
        xk, tk, wk = cs.tool_k1_inputs(torch, dev, src, rin, rout)
        k1_case(f"tool_{rin}_{rout}_f32", xk, tk, wk)
        if both and rin == 48000:
            for variant in ("class", "phase"):
                k1_case(f"tool_{rin}_{rout}_f32_as_{variant}", xk, tk, wk, variant)
    # K4 on the pass's host16c sealed buffer.
    if hasattr(Decoder, "prepare_work"):
        from noaa_apt_tpu_torch.ops import pack as pk

        payload = Decoder(STANDARD, ingest="host16c").prepare_work(signal, rate, to_device=True)
        args4 = (payload.buf, payload.nb, payload.w_lo, payload.n_esc_pad, payload.coeff)
        k4 = lambda: pk.unpack_sealed(*args4)  # noqa: E731
        cs.assert_equal(torch, "unpack_sealed", k4(), pk.unpack_sealed_plain(*args4))
        rec.update(k4_w_lo=payload.w_lo, k4_n_esc_pad=payload.n_esc_pad, k4_ms=cs.time_ms(torch, k4),
                   k4_device_ms=cs.device_ms(torch, k4))
    decoder, stages = Decoder(STANDARD), []
    for _ in range(DECODES):
        decoder.decode_render_input(signal, len(signal), rate)
        stages.append(decoder.last_stage_ms)
    rec["stage_ms"] = {name: statistics.median(st[name] for st in stages) for name in stages[0]}
    return rec


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(_chip_smoke().nvidia_smi(), flush=True)
    for root in argv:
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
