"""Command line of the port: WAV (or a raw ``.npy``) -> PNG.

Behavioral contract: the single-file decode branch of
``noaa_apt_tpu/cli.py:129-565`` for the ported options: every contrast
(``-c``), false colour (``-F``, ``-P``), ``-R yes|no``, ``--no-sync``,
``--raw-out`` and a ``.npy`` input, ``-p``, ``-v``, ``-d``, ``-q``.  The
decode runs on the card unless ``--device cpu`` is given; without CUDA
and without that flag it raises.  With sync on and no ``--raw-out`` it
takes the fused path (:meth:`Decoder.decode_render_input` ->
:func:`finish_image`), else :meth:`Decoder.decode` -> :func:`process`.
The options that need ``geo/`` (``-m``, ``-R auto``, ``-s``, ``-t``,
``-T``) and the other modes (``-r``, ``--wav-steps``,
``--export-resample-filtered``, a directory, ``--stream``,
``--distributed``, ``--ingest`` other than ``device``, no input: the
GUI) exit 1 with "not ported yet" and write no file.

    python -m noaa_apt_tpu_torch in.wav -o out.png [-c telemetry] [-F] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

from . import FINAL_RATE, __version__, err
from .core.frequency import Rate
from .core.profiles import PROFILES
from .device import resolve_device
from .graph.decode import Decoder
from .graph.process import finish_image, process
from .io import config as cfg
from .io import png, wav
from .io.context import Context
from .types import ColorSettings, Contrast, ContrastKind, Rotate

log = logging.getLogger("noaa_apt_tpu_torch")

# ``-c`` and ``-R`` as the reference spells them (``noaa_apt_tpu/cli.py:201-220``),
# plus the port's own ``percent`` and ``minmax``.  ``-R auto`` is refused
# with "not ported yet".
CONTRASTS = {
    "98_percent": Contrast.from_percent(0.98),
    "telemetry": Contrast.telemetry(),
    "disable": Contrast.minmax(),
    "histogram": Contrast.histogram(),
    "percent": Contrast.from_percent(0.98),
    "minmax": Contrast.minmax(),
}
ROTATES = {"auto": Rotate.ORBIT, "yes": Rotate.YES, "no": Rotate.NO}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="noaa-apt-tpu-torch",
        description="Decode NOAA APT images from WAV files (PyTorch/CUDA engine).",
    )
    p.add_argument("input_filename", nargs="?", help=(
        "Input WAV file, or a .npy written by --raw-out to re-process."))
    p.add_argument("-o", "--output", metavar="FILENAME", default="./output.png",
                   help="Output PNG path. Default: ./output.png")
    p.add_argument("-v", "--version", action="store_true", help="Show version and quit.")
    p.add_argument("-d", "--debug", action="store_true", help="Print debugging messages.")
    p.add_argument("-q", "--quiet", action="store_true", help="Don't print info messages.")
    p.add_argument("-r", "--resample", metavar="SAMPLE_RATE", type=int,
                   help="Resample WAV file to a given sample rate (not ported yet).")
    p.add_argument("--no-sync", dest="sync", action="store_false",
                   help="Disable syncing, useful when the sync frames are noisy.")
    p.add_argument("-c", "--contrast", choices=list(CONTRASTS), default="98_percent",
                   help='Contrast: "98_percent" (default), "telemetry", "histogram" or '
                        '"disable" (min/max).')
    p.add_argument("-s", "--sat", metavar="SATELLITE", help="Satellite name (not ported yet).")
    p.add_argument("-m", "--map", metavar="MAP_MODE", help='Map overlay: "no"; "yes" is not ported yet.')
    p.add_argument("-R", "--rotate", choices=list(ROTATES), default="no",
                   help='Rotate the image 180 degrees: "yes" or "no" (default); "auto" is not '
                        "ported yet.")
    p.add_argument("-F", "--false-color", action="store_true",
                   help="Attempt to produce a colored image.")
    p.add_argument("-P", "--palette", metavar="PALETTE", help="256x256 palette PNG for false color.")
    p.add_argument("-t", "--start-time", metavar="TIME",
                   help="Recording start time, RFC 3339 format (not ported yet).")
    p.add_argument("-T", "--tle", metavar="FILE", help="Load TLE from path (not ported yet).")
    p.add_argument("-p", "--profile", choices=sorted(PROFILES),
                   help="DSP profile. Default: the settings file's (standard).")
    p.add_argument("--wav-steps", action="store_true",
                   help="Export a WAV for every decoding step (not ported yet).")
    p.add_argument("--export-resample-filtered", action="store_true",
                   help="Export the expanded+filtered resampling step (not ported yet).")
    p.add_argument("--rotate-image", action="store_true", help="Deprecated. Use --rotate instead.")
    p.add_argument("--distributed", metavar="N_CHIPS", type=int, default=0,
                   help="Sequence-shard the decode over N cards (not ported yet).")
    p.add_argument("--ingest", choices=["device", "host", "host16", "host16c", "host8"],
                   default="device", help="Where the first resample runs: 'device' (default); "
                                          "the host modes are not ported yet.")
    p.add_argument("--raw-out", metavar="FILE.npy", help=(
        "Also save the raw decoded signal (one float per pixel at 4160 Hz) as .npy; feed it "
        "back as the input to re-process without decoding."))
    p.add_argument("--stream", action="store_true", help="Live decode (not ported yet).")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where to decode: the card (default) or the plain PyTorch path on the CPU.")
    return p


def _unported(args) -> str | None:
    """The first option of ``args`` that the port does not have yet."""
    if args.input_filename is None:
        return "the GUI (no input file)"
    for flag, name in (
        (args.resample is not None, "-r"),
        (args.wav_steps, "--wav-steps"),
        (args.export_resample_filtered, "--export-resample-filtered"),
        (args.stream, "--stream"),
        (args.distributed, "--distributed"),
        (args.ingest != "device", f"--ingest {args.ingest}"),
        (args.map not in (None, "no"), f"-m {args.map}"),
        (args.rotate == "auto" and not args.rotate_image, "-R auto"),
        (args.sat is not None, "-s"),
        (args.start_time is not None, "-t"),
        (args.tle is not None, "-T"),
        (Path(args.input_filename).is_dir(), "a directory input"),
    ):
        if flag:
            return name
    return None


def main(argv=None, report: dict | None = None) -> int:
    """Decode one WAV (or re-process one ``.npy``) to a PNG; returns the
    exit code.  ``report``, if given, receives the wall seconds of each
    step, the decoder's per-stage milliseconds and its ``telemetry``
    stage (None where the fused telemetry path did not run)."""
    args = build_parser().parse_args(argv)
    level = logging.DEBUG if args.debug else (logging.WARNING if args.quiet else logging.INFO)
    logging.basicConfig(level=level, format="%(levelname)s %(name)s: %(message)s")
    log.setLevel(level)  # where the root logger was set up before (basicConfig does nothing)
    if args.version:
        print(f"noaa-apt-tpu-torch image decoder version {__version__}")
        return 0
    missing = _unported(args)
    if missing is not None:
        log.error("%s is not ported yet", missing)
        return 1
    device = resolve_device(args.device)  # raises without CUDA, before any work
    log.info("noaa-apt-tpu-torch image decoder version %s on %s", __version__, device)
    settings = cfg.build_settings(cfg.load_de_settings(), args.profile)

    contrast = CONTRASTS[args.contrast]
    rotate = Rotate.YES if args.rotate_image else ROTATES[args.rotate]
    if not args.sync and contrast.kind in (ContrastKind.TELEMETRY, ContrastKind.HISTOGRAM):
        log.warning("Adjusting contrast without syncing, expect horrible results!")
    context = Context.decode(lambda p_, d_: log.info("%s", d_), Rate(settings.work_rate),
                             Rate(FINAL_RATE))

    t = [time.perf_counter()]
    decoder, sync_pos = None, None
    try:
        color = None
        if args.false_color:
            pf = Path(args.palette) if args.palette else Path(settings.default_palette_filename)
            if args.palette is None and not pf.exists():
                from .post.palette import ensure_default_palette

                pf = ensure_default_palette(pf)
            color = ColorSettings(palette_filename=pf)

        if str(args.input_filename).endswith(".npy"):
            # Re-process a previously decoded raw signal (see --raw-out).
            raw = np.load(args.input_filename).astype(np.float32)
            t.append(time.perf_counter())
            t.append(t[-1])
            img = process(raw, contrast, rotate, color, None, context)
        else:
            signal, rate = wav.load_device_ready(args.input_filename)
            t.append(time.perf_counter())
            decoder = Decoder(settings.profile(), device=device)
            if args.sync and not args.raw_out:
                # Fused path: the same levels table as noaa_apt_tpu/cli.py:489-496.
                if contrast.kind == ContrastKind.PERCENT:
                    levels = ("percent", contrast.percent)
                elif contrast.kind == ContrastKind.HISTOGRAM and color is not None:
                    levels = ("percent", 0.98)
                elif contrast.kind == ContrastKind.TELEMETRY:
                    levels = ("telemetry", 0.98)
                else:
                    levels = ("minmax", 0.98)
                context.status(0.1, "Decoding (fused, device ingest)")
                gray, sync_pos = decoder.decode_render_input(signal, len(signal), rate, *levels)
                t.append(time.perf_counter())
                context.status(0.5, "Generating image")
                img = finish_image(gray, contrast.kind, rotate, color, None, context)
            else:
                raw = decoder.decode(signal, rate, args.sync, context)
                sync_pos = raw.sync_positions
                if args.raw_out:
                    np.save(args.raw_out, raw.signal())
                    log.info("Saved raw decoded signal to %s", args.raw_out)
                t.append(time.perf_counter())
                img = process(raw, contrast, rotate, color, None, context)
        t.append(time.perf_counter())
        png.write_png(args.output, img)
        t.append(time.perf_counter())
    except err.AptError as e:
        log.error("%s", e)
        return 1
    log.info("Saved %s", args.output)
    if report is not None:
        stage_ms = dict(decoder.last_stage_ms) if decoder is not None else {}
        report.update({
            "load_s": t[1] - t[0], "decode_s": t[2] - t[1], "finish_s": t[3] - t[2],
            "save_s": t[4] - t[3], "wall_s": t[4] - t[0], "rows": int(img.shape[0]),
            "sync_positions": sync_pos, "stage_ms": stage_ms,
            "telemetry_ms": stage_ms.get("telemetry"),
        })
    return 0
