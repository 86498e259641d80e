"""Command line of the port: WAV (or a raw ``.npy``) -> PNG, a directory of
WAVs -> PNGs (fleet mode), a live PCM stream -> PNG, and WAV -> WAV.

Behavioral contract: the single-file decode branch and the resample
branch of ``noaa_apt_tpu/cli.py:129-565`` for the ported options: every
contrast (``-c``), false colour (``-F``, ``-P``), ``-R yes|no|auto``, the
map overlay (``-m``, ``--map-yaw``, ``--map-hscale``, ``--map-vscale``),
the orbit options (``-s``, ``-t``, ``-T``; else time and satellite from
the filename or the file's mtime), ``--no-sync``, ``--raw-out`` and a
``.npy`` input, ``-p``, ``-v``, ``-d``, ``-q``, ``--ingest`` (``device``,
or the host modes ``host``, ``host16``, ``host16c``, ``host8``:
``noaa_apt_tpu/cli.py:497-511``) and ``-r RATE`` (the WAV -> WAV
resample tool).  The decode and the resample run on the card unless
``--device cpu`` is given; without CUDA and without that flag they
raise.  A directory input decodes every WAV in it through
:func:`serve.decode_fleet` (``noaa_apt_tpu/cli.py:327-435``): one PNG per
good WAV and ``fleet_report.json`` in ``-o`` (``./fleet_out``), exit 1 if
a pass failed; ``--fleet-png rgba`` keeps the single-file RGBA format.
With sync on and no ``--raw-out`` the decode takes the fused path
(:meth:`Decoder.decode_render_input`, or with a host ingest
:meth:`Decoder.prepare_work` -> :meth:`Decoder.decode_render`, then
:func:`finish_image`), else :meth:`Decoder.decode` -> :func:`process`.
A bad ``-m``, ``-s``, ``-t`` or ``-T`` prints the JAX CLI's message and
returns 0, as that CLI does.  ``--wav-steps`` and
``--export-resample-filtered`` take the step-exporting decode
(:func:`graph.debug.decode_with_steps`, ``noaa_apt_tpu/cli.py:521-529``;
with ``-r`` the tool's steps).  One departure from the JAX CLI, on
purpose: ``--export-resample-filtered`` alone (sync on, no ``--raw-out``)
takes the step decode too, on the reference's export grid, as that CLI's
own comment intends (``noaa_apt_tpu/cli.py:521-526``), while the JAX CLI
takes its fused path there and ignores the flag, so the two PNGs differ.  ``--stream`` decodes a WAV byte stream or
raw PCM (``--stream-rate``, ``--stream-format``) from stdin (``-``), a
pipe or a file as it arrives (:class:`stream.StreamingDecoder`), with a
preview every ``--stream-update`` rows.  ``--profile-trace DIR`` records
a ``torch.profiler`` trace of the whole run.  ``--distributed N`` (N > 1)
sequence-shards a single-file decode over the first N cards
(:class:`parallel.ShardedDecoder`; with ``--device cpu``, N CPU shards),
byte-equal to the one-device decode (``noaa_apt_tpu/cli.py:455-539``): the
fused path with device ingest, else ``ShardedDecoder.decode`` with
``--ingest`` ignored.  ``--multihost`` in fleet mode starts the process
group (:func:`parallel.init_distributed`) and decodes this process's share
of the directory (:func:`parallel.fleet_shard`,
``noaa_apt_tpu/cli.py:347-363``); every process writes
``fleet_report.json`` to the same path, so the last one to finish wins, as
in the JAX CLI.  No input opens the GUI (:func:`gui.main`,
``noaa_apt_tpu/cli.py:166-171``) on the card, or on the CPU with
``--device cpu``; ``-v`` prints the version and, where the settings file
asks for it, the update check's message (``noaa_apt_tpu/cli.py:149-159``).

    python -m noaa_apt_tpu_torch [--device cpu]
    python -m noaa_apt_tpu_torch in.wav -o out.png [-c telemetry] [-F] [-m yes -R auto] [--ingest host16c] [--device cpu]
    python -m noaa_apt_tpu_torch passes/ -o out_dir/ [--ingest host16c] [--fleet-png rgba] [--device cpu]
    python -m noaa_apt_tpu_torch in.wav -r 11025 -o out.wav [--device cpu]
    python -m noaa_apt_tpu_torch in.wav -o out.png --wav-steps [--export-resample-filtered]
    sdr_pipe | python -m noaa_apt_tpu_torch - --stream --stream-rate 11025 -o out.png [--stream-update 50]
    python -m noaa_apt_tpu_torch in.wav -o out.png --profile-trace traces/
    python -m noaa_apt_tpu_torch in.wav -o out.png --distributed 4 [--device cpu]
    JAX_COORDINATOR_ADDRESS=host:port JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \
        python -m noaa_apt_tpu_torch passes/ -o out_dir/ --multihost
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import sys
import time
from datetime import datetime
from functools import partial
from pathlib import Path

import numpy as np
import torch

from . import FINAL_RATE, PX_PER_ROW, __version__, err, ops
from .core.frequency import Rate
from .core.profiles import PROFILES
from .device import resolve_device
from .geo.states import prefetch_states_async
from .graph import resample_tool
from .graph.debug import decode_with_steps
from .graph.decode import Decoder, DecodeResult
from .graph.process import finish_image, process
from .io import config as cfg
from .io import misc, png, wav
from .io.context import Context
from .parallel import Mesh, ShardedDecoder, fleet_shard, init_distributed
from .parallel.dist import rank, world_size
from .post import contrast as ct
from .serve import decode_fleet
from .spans import span
from .stream import StreamingDecoder
from .types import (SAT_IDS, ColorSettings, Contrast, ContrastKind, MapSettings, OrbitSettings,
                    RefTime, Rotate)

log = logging.getLogger("noaa_apt_tpu_torch")

# ``-c`` and ``-R`` as the reference spells them (``noaa_apt_tpu/cli.py:201-220``),
# plus the port's own ``percent`` and ``minmax``.
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
        "Input WAV file, a directory of WAV files (fleet mode), or a .npy written by "
        "--raw-out to re-process."))
    p.add_argument("-o", "--output", metavar="FILENAME", help=(
        "Output path. When decoding images the default is './output.png', when resampling "
        "the default is './output.wav'. When the input is a directory (fleet mode) this is "
        "the output directory, './fleet_out' by default."))
    p.add_argument("-v", "--version", action="store_true", help="Show version and quit.")
    p.add_argument("-d", "--debug", action="store_true", help="Print debugging messages.")
    p.add_argument("-q", "--quiet", action="store_true", help="Don't print info messages.")
    p.add_argument("-r", "--resample", metavar="SAMPLE_RATE", type=int, help=(
        "Resample WAV file to a given sample rate, no APT image will be decoded."))
    p.add_argument("--no-sync", dest="sync", action="store_false",
                   help="Disable syncing, useful when the sync frames are noisy.")
    p.add_argument("-c", "--contrast", choices=list(CONTRASTS), default="98_percent",
                   help='Contrast: "98_percent" (default), "telemetry", "histogram" or '
                        '"disable" (min/max).')
    p.add_argument("-s", "--sat", metavar="SATELLITE", help=(
        'Satellite name: "noaa_15", "noaa_18" or "noaa_19". Default: guessed from the '
        "filename, else NOAA 19."))
    p.add_argument("-m", "--map", metavar="MAP_MODE", help='Enable map overlay: "yes" or "no".')
    p.add_argument("--map-yaw", metavar="YAW", type=float,
                   help="Map yaw correction in degrees. Default: 0.")
    p.add_argument("--map-hscale", metavar="HSCALE", type=float,
                   help="Horizontal map scale correction. Default: 1.")
    p.add_argument("--map-vscale", metavar="VSCALE", type=float,
                   help="Vertical map scale correction. Default: 1.")
    p.add_argument("-R", "--rotate", choices=list(ROTATES), default="no", help=(
        'Rotate image: "auto", "yes", "no" (default). "auto" uses orbit calculations.'))
    p.add_argument("-F", "--false-color", action="store_true",
                   help="Attempt to produce a colored image.")
    p.add_argument("-P", "--palette", metavar="PALETTE", help="256x256 palette PNG for false color.")
    p.add_argument("-t", "--start-time", metavar="TIME", help="Recording start time, RFC 3339 format.")
    p.add_argument("-T", "--tle", metavar="FILE", help="Load TLE from path.")
    p.add_argument("-p", "--profile", choices=sorted(PROFILES),
                   help="DSP profile. Default: the settings file's (standard).")
    p.add_argument("--wav-steps", action="store_true",
                   help="Export a WAV for every decoding step (debug).")
    p.add_argument("--export-resample-filtered", action="store_true", help=(
        "Export the expanded+filtered resampling step (very expensive). It also moves the "
        "first resample's outputs to the reference's export grid."))
    p.add_argument("--rotate-image", action="store_true", help="Deprecated. Use --rotate instead.")
    p.add_argument("--distributed", metavar="N_CHIPS", type=int, default=0,
                   help="Sequence-shard the decode of one file over N cards (the first N; "
                        "with --device cpu, N CPU shards), with a ring halo exchange.")
    p.add_argument("--ingest", choices=["device", "host", "host16", "host16c", "host8"],
                   default="device", help="Where the first resample runs: 'device' (default) uploads "
                                          "the raw recording; 'host' resamples on the host and uploads "
                                          "f32, 'host16' i16, 'host8' i8 (lossy), 'host16c' the "
                                          "lossless packed i16.")
    p.add_argument("--raw-out", metavar="FILE.npy", help=(
        "Also save the raw decoded signal (one float per pixel at 4160 Hz) as .npy; feed it "
        "back as the input to re-process without decoding."))
    p.add_argument("--multihost", action="store_true",
                   help="Fleet (directory) mode across processes or hosts: start the "
                        "torch.distributed process group (gloo; the coordinator from "
                        "JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID or "
                        "torchrun's variables) and decode only this process's share of the "
                        "recordings.")
    p.add_argument("--fleet-png", choices=["auto", "rgba"], default="auto", help=(
        "Fleet (directory) mode output format: 'auto' (default) writes single-channel "
        "grayscale PNGs when the image carries no colour information (the same pixels); "
        "'rgba' keeps 4-channel files byte-equal to single-file mode."))
    p.add_argument("--stream", action="store_true", help=(
        "Live decode. Read the input as a stream (a WAV byte stream or headerless raw PCM) "
        "from stdin (input '-'), a pipe or a file, emitting image rows as they finalize and "
        "the PNG at the end of the stream. Rows are bit-identical to the offline decode of "
        "the same samples."))
    p.add_argument("--stream-rate", metavar="HZ", type=int, help=(
        "Sample rate of a headerless raw PCM stream (ignored for WAV streams, whose header "
        "carries it)."))
    p.add_argument("--stream-format", choices=["s16", "f32"], default="s16", help=(
        "Sample format of a headerless raw PCM stream: s16 (little-endian int16) or f32. "
        "Default: s16."))
    p.add_argument("--stream-update", metavar="N_ROWS", type=int, default=0, help=(
        "Rewrite the output PNG every N newly finalized rows during the stream (a live "
        "preview with 98%% contrast); 0 writes only the final image. Default: 0."))
    p.add_argument("--profile-trace", metavar="DIR", help=(
        "Record a torch.profiler trace of the whole run (host ops, the card's kernels and "
        "copies) into DIR as <host>.<pid>.trace.json, viewable in Perfetto or "
        "chrome://tracing."))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help=(
        "Where to decode or resample: the card (default) or the plain PyTorch path on the CPU."))
    return p


def _sharded_decoder(profile, n: int, device) -> ShardedDecoder:
    """``--distributed n``'s decoder: a mesh of the first ``n`` cards
    (fewer where the machine has fewer, as ``jax.devices()[:n]``), or of
    ``n`` CPU shards (``noaa_apt_tpu/cli.py:478-486``)."""
    if device.type == "cuda":
        devices = [f"cuda:{i}" for i in range(min(n, torch.cuda.device_count()))]
    else:
        devices = [device] * n
    return ShardedDecoder(profile, Mesh(devices, ("seq",)))


def _stream_refusal(args) -> str | None:
    """The JAX CLI's message for an option that stream mode does not take
    (``noaa_apt_tpu/cli.py:314-323``), or None."""
    for flag, name in ((args.wav_steps, "--wav-steps"),
                       (args.export_resample_filtered, "--export-resample-filtered"),
                       (args.distributed, "--distributed")):
        if flag:
            return f"{name} is not supported in stream mode"
    return None


def _orbit_settings(args, settings, rotate: Rotate) -> tuple[OrbitSettings | None, str | None]:
    """``(orbit settings or None, None)`` of a decode, built as
    ``noaa_apt_tpu/cli.py:231-298`` builds them: time and satellite from
    the filename (else the file's mtime and NOAA 19), overridden by
    ``-s`` and ``-t``; ``-T``'s TLE; ``-m``'s map settings with the
    settings file's colours.  ``(None, message)`` where that CLI prints
    ``message`` and stops with 0: a bad ``-s``, ``-T``, ``-t`` or ``-m``,
    or ``-R auto`` or ``-m yes`` without a time and satellite."""
    sat_name, ref_time = None, None
    try:
        ref_time, sat_name = misc.infer_time_sat(settings, args.input_filename)
    except err.AptError as e:
        print(f"Unable to determine satellite name and recording time from filename: {e}")
    if args.sat is not None:
        if args.sat not in SAT_IDS:
            return None, "Invalid provided satellite name"
        sat_name = SAT_IDS[args.sat]
    custom_tle = None
    if args.tle is not None:
        try:
            custom_tle = Path(args.tle).read_text()
        except OSError as e:
            return None, f"Could not open custom TLE file: {e}"
    if args.start_time is not None:
        try:
            t = datetime.fromisoformat(args.start_time)
            if t.tzinfo is None:
                # RFC 3339 requires an offset; the reference's
                # parse_from_rfc3339 rejects naive datetimes too.
                raise ValueError("missing UTC offset (use e.g. 2020-01-26T01:33:20+00:00)")
        except ValueError as e:
            return None, f"Could not parse date and time given: {e}"
        ref_time = RefTime.start(t)
    draw_map = None
    if args.map == "yes":
        draw_map = MapSettings(
            # `or` would replace an explicit 0 with the default
            yaw=args.map_yaw if args.map_yaw is not None else 0.0,
            hscale=args.map_hscale if args.map_hscale is not None else 1.0,
            vscale=args.map_vscale if args.map_vscale is not None else 1.0,
            countries_color=settings.default_countries_color,
            states_color=settings.default_states_color,
            lakes_color=settings.default_lakes_color,
        )
        # The one-time states.shp download overlaps the decode (geo/states.py).
        prefetch_states_async()
    elif args.map not in (None, "no"):
        return None, "Invalid map argument"
    if sat_name is None or ref_time is None:
        if rotate == Rotate.ORBIT:
            return None, "Can't rotate automatically if no satellite and time is provided"
        if draw_map is not None:
            return None, "Can't draw map if no satellite and time is provided"
        return None, None
    return OrbitSettings(sat_name=sat_name, ref_time=ref_time, custom_tle=custom_tle,
                         draw_map=draw_map), None


def _color_settings(args, settings) -> ColorSettings | None:
    """``-F``'s palette (``-P``, else the settings file's default, written
    on first use), or None without ``-F``."""
    if not args.false_color:
        return None
    pf = Path(args.palette) if args.palette else Path(settings.default_palette_filename)
    if args.palette is None and not pf.exists():
        from .post.palette import ensure_default_palette

        pf = ensure_default_palette(pf)
    return ColorSettings(palette_filename=pf)


def _fleet(args, settings, contrast: Contrast, rotate: Rotate, orbit: OrbitSettings | None,
           device, report: dict | None) -> int:
    """Fleet mode (``noaa_apt_tpu/cli.py:327-435``): every WAV of the
    input directory through :func:`decode_fleet`, each with its own time
    and satellite where the map or ``-R auto`` needs them (``-s`` and
    ``-t`` override), then ``fleet_report.json`` beside the PNGs.  Returns
    1 if a pass failed."""
    for flag, name in ((args.wav_steps, "--wav-steps"), (args.distributed, "--distributed"),
                       (args.raw_out, "--raw-out")):
        if flag:
            print(f"{name} is not supported in fleet (directory) mode")
            return 1
    wavs = sorted(p for p in Path(args.input_filename).iterdir() if p.suffix.lower() == ".wav")
    if not wavs:
        print(f"No WAV files found in {args.input_filename}")
        return 1
    if args.multihost:
        # Recordings are independent, so processes never exchange signal
        # data: each decodes its deterministic share (parallel/dist.py).
        init_distributed()
        wavs = fleet_shard(wavs)
        log.info("multihost fleet: process %d/%d decoding %d of the recordings", rank(), world_size(),
                 len(wavs))
        if not wavs:
            print("No recordings assigned to this process")
            return 0

    orbit_for = None
    if orbit is not None and (orbit.draw_map is not None or rotate == Rotate.ORBIT):
        def orbit_for(p):
            s_name, r_time = None, None
            try:
                r_time, s_name = misc.infer_time_sat(settings, p)
            except err.AptError as e:
                log.warning("No time/satellite for %s: %s", p, e)
            if args.sat is not None:
                s_name = orbit.sat_name
            if args.start_time is not None:
                r_time = orbit.ref_time
            if s_name is None or r_time is None:
                return None
            return OrbitSettings(sat_name=s_name, ref_time=r_time, custom_tle=orbit.custom_tle,
                                 draw_map=orbit.draw_map)

    out_dir = Path(args.output or "./fleet_out")
    try:
        color = _color_settings(args, settings)
    except err.AptError as e:
        log.error("%s", e)
        return 1
    rep = decode_fleet(wavs, out_dir, profile=settings.profile(), contrast=contrast, rotate=rotate,
                       color=color, orbit_for=orbit_for, sync=args.sync, ingest=args.ingest,
                       gray_png="auto" if args.fleet_png == "auto" else "never", device=device)
    print(f"fleet: {len(rep.ok)} decoded, {len(rep.failed)} failed, "
          f"{rep.wall_seconds:.1f}s wall ({rep.realtime_factor:.0f}x realtime)")
    report_path = out_dir / "fleet_report.json"
    try:
        report_path.write_text(json.dumps({
            "ok": len(rep.ok),
            "failed": [{"input": str(r.input_path), "error": r.error} for r in rep.failed],
            "wall_seconds": round(rep.wall_seconds, 3),
            "realtime_factor": round(rep.realtime_factor, 1),
            "rows": sum(r.n_rows for r in rep.ok),
            "stage_seconds": rep.stage_totals(),
            "wait_seconds": {k: round(v, 3) for k, v in rep.waits.items()},
            "compile_variants": rep.compile_variants,
            "passes": [
                {
                    "input": str(r.input_path),
                    "output": str(r.output_path),
                    "rows": r.n_rows,
                    "load_s": round(r.load_s, 3),
                    "ingest_s": round(r.ingest_s, 3),
                    "device_s": round(r.device_s, 3),
                    "fetch_s": round(r.fetch_s, 3),
                    "encode_s": round(r.encode_s, 3),
                }
                for r in rep.ok
            ],
        }, indent=1))
    except OSError as e:
        log.warning("could not write %s: %s", report_path, e)
    if report is not None:
        report["fleet"] = rep
    return 0 if not rep.failed else 1


def main(argv=None, report: dict | None = None) -> int:
    """Decode one WAV (or re-process one ``.npy``) to a PNG, decode a
    directory of WAVs (fleet mode), decode a stream (``--stream``), or
    resample one WAV (``-r``); returns the exit code.  With
    ``--profile-trace DIR`` the whole run is traced (:func:`_traced`).

    ``report``, if given, receives in fleet mode the
    :class:`serve.FleetReport` under ``"fleet"``; in stream mode the rows,
    the sync positions, the wall seconds and, under ``"stream"``, the
    chunks, the first row's and the audio's seconds, the greedy fold's
    host seconds and each chunk's milliseconds.  Otherwise it receives
    the wall seconds of each step (of the whole run for ``-r``), the
    decoder's per-stage milliseconds and its ``telemetry`` stage (None
    where the fused telemetry path did not run), the host ingest's seconds
    (``ingest_s``, None for ``--ingest device``) and the bytes of the
    signal or payload copied to the device (``payload_bytes``).  A traced
    run adds the trace's path (``trace``).  Each step's seconds are those of
    its span (``apt.load``, ``apt.decode``, ``apt.finish``, ``apt.save``;
    :mod:`spans`)."""
    args = build_parser().parse_args(argv)
    level = logging.DEBUG if args.debug else (logging.WARNING if args.quiet else logging.INFO)
    logging.basicConfig(level=level, format="%(levelname)s %(name)s: %(message)s")
    log.setLevel(level)  # where the root logger was set up before (basicConfig does nothing)
    if args.profile_trace:
        return _traced(args, report)
    return _run(args, report)


def _traced(args, report: dict | None) -> int:
    """:func:`_run` under ``torch.profiler`` (``noaa_apt_tpu/cli.py:135-142``
    wraps the JAX run in ``jax.profiler.trace``): host activity, plus the
    card's when the run is on CUDA, exported as the Chrome trace
    ``DIR/<host>.<pid>.trace.json``.  The ``apt.*`` spans of every thread
    are recorded (the fleet's loaders and encoders too) where the installed
    torch has ``profile_all_threads``.  A run that launched a kernel on the
    card but whose profile holds no CUDA event (the profiler could not
    record the card) fails (exit 1) and writes no trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    cuda = args.device == "cuda" and not args.version
    if cuda:
        resolve_device("cuda")  # raises without CUDA, before the run
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:  # a torch without the option records the calling thread only
        extra = {}
    before = ops.launch_counts()
    with profile(activities=activities, **extra) as prof:
        rc = _run(args, report)
        if cuda:
            torch.cuda.synchronize()
    if (cuda and ops.launch_counts() != before
            and not any(e.device_type == DeviceType.CUDA for e in prof.events())):
        log.error("the profiler recorded no CUDA activity on a run that launched kernels; "
                  "no trace written")
        return 1
    out_dir = Path(args.profile_trace)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{socket.gethostname()}.{os.getpid()}.trace.json"
    prof.export_chrome_trace(str(path))
    log.info("Saved profiler trace to %s", path)
    if report is not None:
        report["trace"] = str(path)
    return rc


def _run(args, report: dict | None) -> int:
    """The run of :func:`main` after the argument parse."""
    de = cfg.load_de_settings()
    if args.version:
        print(f"noaa-apt-tpu-torch image decoder version {__version__}")
        if de.get("check_updates", False):
            result = misc.check_updates(__version__)
            if result is None:
                print("Could not retrieve latest version available")
            elif result[0]:
                print(f'Version "{result[1]}" available for download!')
            else:
                print("You have the latest version available")
        return 0
    device = resolve_device(args.device)  # raises without CUDA, before any work
    log.info("noaa-apt-tpu-torch image decoder version %s on %s", __version__, device)
    settings = cfg.build_settings(de, args.profile, args.wav_steps, args.export_resample_filtered)

    if args.input_filename is None:
        # GUI mode (main.rs:64-71): no input file opens the window.
        from . import gui

        gui.main(bool(de.get("check_updates", False)), settings, device)
        return 0

    if args.resample is not None:
        t0 = time.perf_counter()
        context = Context.resample(lambda p_, d_: log.info("%s", d_), settings.export_wav,
                                   settings.export_resample_filtered)
        try:
            resample_tool.resample(context, settings, args.input_filename,
                                   args.output or "./output.wav", args.resample, device)
        except err.AptError as e:
            log.error("%s", e)
            return 1
        if report is not None:
            report["wall_s"] = time.perf_counter() - t0
        return 0

    out = args.output or "./output.png"
    contrast = CONTRASTS[args.contrast]
    rotate = Rotate.YES if args.rotate_image else ROTATES[args.rotate]
    orbit, stop = _orbit_settings(args, settings, rotate)
    if stop is not None:
        print(stop)
        return 0
    if not args.sync and contrast.kind in (ContrastKind.TELEMETRY, ContrastKind.HISTOGRAM):
        log.warning("Adjusting contrast without syncing, expect horrible results!")
    context = Context.decode(lambda p_, d_: log.info("%s", d_), Rate(settings.work_rate),
                             Rate(FINAL_RATE), settings.export_wav, settings.export_resample_filtered)
    if args.stream:
        refusal = _stream_refusal(args)
        if refusal is not None:
            print(refusal)
            return 1
        return _stream_decode(args, settings, contrast, rotate, orbit, context, device, out, report)
    if Path(args.input_filename).is_dir():
        return _fleet(args, settings, contrast, rotate, orbit, device, report)

    sync_pos = None
    npy = str(args.input_filename).endswith(".npy")
    try:
        with span("apt.load") as load:
            color = _color_settings(args, settings)
            if npy:
                # Re-process a previously decoded raw signal (see --raw-out).
                raw = np.load(args.input_filename).astype(np.float32)
            else:
                signal, rate = wav.load_device_ready(args.input_filename)
        # Each branch decodes, and leaves the finish stage's call in ``finish``.
        with span("apt.decode") as decode:
            steps = settings.export_wav or settings.export_resample_filtered
            distributed = args.distributed > 1
            if npy or steps:
                decoder = None
            elif distributed:
                decoder = _sharded_decoder(settings.profile(), args.distributed, device)
            else:
                decoder = Decoder(settings.profile(), device=device, ingest=args.ingest)
            if npy:
                finish = partial(process, raw, contrast, rotate, color, orbit, context)
            elif steps:
                # The step-exporting decode (noaa_apt_tpu/cli.py:521-529).
                # --export-resample-filtered alone routes here too: it moves
                # the first resample to the reference's export grid.
                flat, sync_pos = decode_with_steps(context, settings.profile(), signal, rate, args.sync,
                                                   device)
                if args.raw_out:
                    np.save(args.raw_out, flat)
                    log.info("Saved raw decoded signal to %s", args.raw_out)

                def finish():
                    # Contrast on the card, as for Decoder.decode's rows.
                    rows = torch.from_numpy(flat.reshape(-1, PX_PER_ROW)).to(device)
                    return process(DecodeResult(rows, rows.shape[0], sync_pos), contrast, rotate, color,
                                   orbit, context)
            elif args.sync and not args.raw_out and not (distributed and args.ingest != "device"):
                # Fused path: the same levels table as noaa_apt_tpu/cli.py:489-496.
                if contrast.kind == ContrastKind.PERCENT:
                    levels = ("percent", contrast.percent)
                elif contrast.kind == ContrastKind.HISTOGRAM and color is not None:
                    levels = ("percent", 0.98)
                elif contrast.kind == ContrastKind.TELEMETRY:
                    levels = ("telemetry", 0.98)
                else:
                    levels = ("minmax", 0.98)
                context.status(0.1, f"Decoding (fused, {args.ingest} ingest)")
                payload = None
                if args.ingest != "device":
                    # host16c ships the packed payload, uploaded here; the
                    # other host modes upload in decode_render.
                    payload = decoder.prepare_work(signal, rate, to_device=(args.ingest == "host16c"),
                                                   context=context)
                if payload is not None:
                    gray, sync_pos = decoder.decode_render(payload, *levels)
                else:  # device ingest, or an l == 1 rate pair
                    gray, sync_pos = decoder.decode_render_input(signal, len(signal), rate, *levels)

                def finish():
                    context.status(0.5, "Generating image")
                    return finish_image(gray, contrast.kind, rotate, color, orbit, context)
            else:  # the sharded decoder ignores --ingest, as in the JAX CLI
                raw = decoder.decode(signal, rate, args.sync, context)
                sync_pos = raw.sync_positions
                if args.raw_out:
                    np.save(args.raw_out, raw.signal())
                    log.info("Saved raw decoded signal to %s", args.raw_out)
                finish = partial(process, raw, contrast, rotate, color, orbit, context)
        with span("apt.finish") as finished:
            img = finish()
        with span("apt.save") as save:
            png.write_png(out, img)
    except err.AptError as e:
        log.error("%s", e)
        return 1
    log.info("Saved %s", out)
    if report is not None:
        stage_ms = dict(decoder.last_stage_ms) if decoder is not None else {}
        upload = decoder.last_upload if decoder is not None and decoder.last_upload else {}
        report.update({
            "ingest_s": decoder.last_ingest_s if decoder is not None else None,
            "payload_bytes": upload.get("bytes"),
            "load_s": load.seconds, "decode_s": decode.seconds,
            "finish_s": finished.seconds, "save_s": save.seconds, "wall_s": save.end - load.start,
            "rows": int(img.shape[0]), "sync_positions": sync_pos, "stage_ms": stage_ms,
            "telemetry_ms": stage_ms.get("telemetry"),
        })
    return 0


def _stream_decode(args, settings, contrast: Contrast, rotate: Rotate, orbit: OrbitSettings | None,
                   context: Context, device, out: str, report: dict | None) -> int:
    """Live decode (``--stream``, ``noaa_apt_tpu/cli.py:568-641``): pull
    about 1 s of PCM at a time from stdin (input ``-``), a pipe or a file
    through :class:`stream.StreamingDecoder`, log rows as they finalize,
    rewrite a preview every ``--stream-update`` rows, and at the end of
    the stream save the PNG through :func:`process`.  The rows are the
    offline decode's bit for bit, and their contrast runs on the card as
    for :meth:`Decoder.decode`'s, so the PNG is the ``--raw-out`` run's
    byte for byte."""
    if args.input_filename == "-":
        f, close = sys.stdin.buffer, False
    else:
        try:
            f, close = open(args.input_filename, "rb"), True
        except OSError as e:
            print(f"Could not open stream input: {e}")
            return 1
    rows: list = []
    t0 = time.perf_counter()
    first_row_s, since_update, n_in = None, 0, 0
    try:
        color = _color_settings(args, settings)
        reader = wav.PcmStreamReader(f, rate=args.stream_rate, fmt="auto", raw_fmt=args.stream_format)
        log.info("stream: %d Hz, %s samples", reader.sample_rate, reader.spec.sample_format)
        sd = StreamingDecoder(settings.profile(), Rate(reader.sample_rate), sync=args.sync, device=device)
        while True:
            chunk = reader.read(reader.sample_rate)  # about 1 s of audio per pull
            done = chunk is None
            if not done:
                n_in += chunk.shape[0]
            new = sd.finish() if done else sd.push(chunk)
            if new.shape[0]:
                if first_row_s is None:
                    first_row_s = time.perf_counter() - t0
                    log.info("stream: first row after %.2f s", first_row_s)
                rows.append(new)
                since_update += new.shape[0]
                context.status(0.1, f"Streaming: {sd.n_rows} rows ({sd.n_rows / 2:.0f} s of pass)")
            if args.stream_update and since_update >= args.stream_update and rows:
                _write_stream_preview(rows, out)
                since_update = 0
            if done:
                break
        if not rows:
            print("Stream ended before any image rows were decoded")
            return 1
        image = np.concatenate(rows)
        if args.raw_out:
            np.save(args.raw_out, image.reshape(-1))
            log.info("Saved raw decoded signal to %s", args.raw_out)
        result = DecodeResult(torch.from_numpy(image).to(device), image.shape[0], sd.sync_positions)
        png.write_png(out, process(result, contrast, rotate, color, orbit, context))
    except err.AptError as e:
        log.error("%s", e)
        return 1
    finally:
        if close:
            f.close()
    wall = time.perf_counter() - t0
    log.info("Saved %s (%d rows; first row at %.2f s, stream done in %.2f s)", out, image.shape[0],
             first_row_s, wall)
    if report is not None:
        report.update({
            "rows": int(image.shape[0]), "sync_positions": sd.sync_positions, "wall_s": wall,
            "stream": {"rate": reader.sample_rate, "chunks": sd.chunks, "first_row_s": first_row_s,
                       "audio_s": n_in / reader.sample_rate, "fold_s": sd.fold_s,
                       "chunk_ms": list(sd.chunk_ms)},
        })
    return 0


def _write_stream_preview(rows: list, out: str) -> None:
    """Rewrite ``out`` with a 98%-stretch grayscale of the rows so far
    (``--stream-update``, ``noaa_apt_tpu/cli.py:644-657``): a cheap live
    preview on the host; the final write goes through :func:`process`."""
    flat = np.concatenate(rows).reshape(-1)
    low, high = ct.percent(flat, 0.98)
    png.write_png(out, ct.map_signal_u8(flat, low, high).reshape(-1, PX_PER_ROW))
