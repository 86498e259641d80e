"""Command line of the ported slice: WAV -> percent (or min/max) PNG.

Behavioral contract: the decode branch of ``noaa_apt_tpu/cli.py:451-519``
for the slice's options: load -> :meth:`Decoder.decode_render_input` ->
:func:`finish_image` -> PNG.  The decode runs on the card unless
``--device cpu`` is given; without CUDA and without that flag it raises.

    python -m noaa_apt_tpu_torch in.wav -o out.png [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import time

from . import __version__, err
from .core.profiles import PROFILES
from .device import resolve_device
from .graph.decode import Decoder
from .graph.process import finish_image
from .io import png, wav
from .types import Contrast, ContrastKind, Rotate

log = logging.getLogger("noaa_apt_tpu_torch")

# ``-c`` and ``-R`` as the reference spells them (``noaa_apt_tpu/cli.py:201-220``),
# plus the port's own ``percent`` and ``minmax``.  The kinds and the rotation
# outside PORTED are refused with "not ported yet".
CONTRASTS = {
    "98_percent": Contrast.from_percent(0.98),
    "telemetry": Contrast.telemetry(),
    "disable": Contrast.minmax(),
    "histogram": Contrast.histogram(),
    "percent": Contrast.from_percent(0.98),
    "minmax": Contrast.minmax(),
}
ROTATES = {"auto": Rotate.ORBIT, "yes": Rotate.YES, "no": Rotate.NO}
PORTED = {ContrastKind.PERCENT, ContrastKind.MINMAX, Rotate.YES, Rotate.NO}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="noaa-apt-tpu-torch",
        description="Decode NOAA APT images from WAV files (PyTorch/CUDA engine).",
    )
    p.add_argument("input_filename", help="Input WAV file.")
    p.add_argument("-o", "--output", metavar="FILENAME", default="./output.png",
                   help="Output PNG path. Default: ./output.png")
    p.add_argument("-p", "--profile", choices=sorted(PROFILES), default="standard",
                   help="DSP profile. Default: standard.")
    p.add_argument("-c", "--contrast", choices=list(CONTRASTS), default="98_percent",
                   help='Contrast: "98_percent" (default) or "disable" (min/max); "telemetry" '
                        'and "histogram" are not ported yet.')
    p.add_argument("-R", "--rotate", choices=list(ROTATES), default="no",
                   help='Rotate the image 180 degrees: "yes" or "no" (default); "auto" is not '
                        "ported yet.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where to decode: the card (default) or the plain PyTorch path on the CPU.")
    p.add_argument("-q", "--quiet", action="store_true", help="Don't print info messages.")
    return p


def main(argv=None, report: dict | None = None) -> int:
    """Decode one WAV to a PNG; returns the exit code.  ``report``, if
    given, receives the wall seconds of each step and the decoder's
    per-stage milliseconds."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING if args.quiet else logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    contrast, rotate = CONTRASTS[args.contrast], ROTATES[args.rotate]
    for option, name, value in (("-c", args.contrast, contrast.kind), ("-R", args.rotate, rotate)):
        if value not in PORTED:
            log.error("%s %s is not ported yet", option, name)
            return 1
    device = resolve_device(args.device)  # raises without CUDA, before any work
    log.info("noaa-apt-tpu-torch image decoder version %s on %s", __version__, device)

    t = [time.perf_counter()]
    try:
        signal, rate = wav.load_device_ready(args.input_filename)
        t.append(time.perf_counter())
        decoder = Decoder(PROFILES[args.profile], device=device)
        kind = "percent" if contrast.kind == ContrastKind.PERCENT else "minmax"
        gray, sync_pos = decoder.decode_render_input(signal, len(signal), rate, kind, contrast.percent)
        t.append(time.perf_counter())
        img = finish_image(gray, contrast.kind, rotate)
        t.append(time.perf_counter())
        png.write_png(args.output, img)
        t.append(time.perf_counter())
    except err.AptError as e:
        log.error("%s", e)
        return 1
    log.info("Saved %s", args.output)
    if report is not None:
        report.update({
            "load_s": t[1] - t[0], "decode_s": t[2] - t[1], "finish_s": t[3] - t[2],
            "save_s": t[4] - t[3], "wall_s": t[4] - t[0], "rows": int(gray.shape[0]),
            "sync_positions": sync_pos, "stage_ms": dict(decoder.last_stage_ms),
        })
    return 0
