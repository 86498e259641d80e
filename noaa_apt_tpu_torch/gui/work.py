"""GUI actions: decode, process, save, resample, timestamp tools.

Behavioral contract: reference ``src/gui/work.rs`` — each button
spawns a worker thread, marshals results back onto the GUI thread via
``idle_add`` (the glib::idle_add analog), mirrors the reference's
widget->Settings marshalling including its error messages, and caches
the decode result so processing never re-runs DSP (work.rs:481).

Every long-running entry point returns the worker ``Thread`` (the
reference returns nothing; the handle lets the headless tests join).

A copy of ``noaa_apt_tpu/gui/work.py`` on the port: the decode, the
step-exporting decode and the resample tool run on ``GuiState.device``
(the card unless the GUI was opened with ``--device cpu``; without CUDA
they fail into the info bar, never onto the CPU), the cached decoder is
reused only on its own profile and device, processing needs no decoder
(the cached ``DecodeResult``'s levels and u8 map run on the device its
rows lie on), and Save writes with the port's PNG writer.
"""

from __future__ import annotations

import logging
import threading
from datetime import datetime
from pathlib import Path

from .. import FINAL_RATE, err
from ..core.frequency import Rate
from ..device import resolve_device
from ..io import misc as io_misc
from ..io import png, wav
from ..io.context import Context
from ..types import (
    ColorSettings,
    Contrast,
    MapSettings,
    OrbitSettings,
    RefTime,
    Rotate,
    SatName,
)
from . import misc
from .state import borrow_state, borrow_widgets

log = logging.getLogger(__name__)

from ..types import SAT_IDS as _SAT_IDS
from ..types import SAT_TO_ID as _SAT_TO_ID


def _progress_marshal():
    """A Context progress callback that hops onto the GUI thread."""
    widgets = borrow_widgets()

    def progress_callback(progress, description):
        widgets.idle_add(lambda: misc.set_progress(progress, description))

    return progress_callback


def _set_datetime_widgets(widgets, calendar, hs, mins, secs, time: datetime) -> None:
    local = time.astimezone()
    calendar.set((local.year, local.month, local.day))
    hs.set(local.hour)
    mins.set(local.minute)
    secs.set(local.second)


def _read_datetime_widgets(calendar, hs, mins, secs) -> datetime:
    """Local calendar + spinners -> aware UTC datetime (work.rs:398-421).

    Everything is inside the try: Tk variables raise TclError (not
    ValueError) when a spinbox holds non-numeric text, and buttons were
    already set insensitive by the caller — an escaping exception would
    strand them disabled.
    """
    try:
        year, month, day = calendar.get()
        local = datetime(
            int(year), int(month), int(day),
            int(hs.get()), int(mins.get()), int(secs.get()),
        )
    except Exception:  # noqa: BLE001 — any unparsable widget state
        raise err.InternalError("Invalid date or time")
    return local.astimezone()  # aware, local tz; orbit code compares in UTC


def decode() -> threading.Thread | None:
    """Read widgets, decode on a worker thread, update widgets
    (work.rs:29-199)."""
    widgets = borrow_widgets()
    state = borrow_state()

    def callback(result, decoder=None):
        def apply():
            widgets.dec_decode_button.set_sensitive(True)
            if isinstance(result, Exception):
                misc.set_progress(1.0, "Error")
                misc.show_info("error", str(result))
                log.error("%s", result)
                state.decoded_signal = None
                state.processed_image = None
                # state.decoder is kept: its filter tables stay valid.
                misc.update_image()
                return

            misc.set_progress(1.0, "Decoded")
            widgets.p_process_button.set_sensitive(True)
            state.decoded_signal = result
            state.processed_image = None
            if decoder is not None:  # wav-steps decodes keep the cache
                state.decoder = decoder
            misc.update_image()

            # Infer recording time and satellite from the filename and
            # prefill the Process tab (work.rs:46-126).  Uses the
            # filename captured when the decode started — the user may
            # have edited the chooser while the worker ran.
            try:
                ref_time, sat_name = io_misc.infer_time_sat(state.settings, input_filename)
            except err.AptError as e:
                misc.show_info(
                    "info",
                    f"Could not infer recording time and satellite. Set them manually: {e}",
                )
                return
            widgets.p_ref_time_combo.set(ref_time.kind)
            _set_datetime_widgets(
                widgets, widgets.p_calendar, widgets.p_hs_spinner,
                widgets.p_min_spinner, widgets.p_sec_spinner, ref_time.time,
            )
            widgets.p_satellite_combo.set(_SAT_TO_ID[sat_name])

        widgets.idle_add(apply)

    misc.set_progress(0.0, "Decoding")
    widgets.info.hide()
    widgets.dec_decode_button.set_sensitive(False)
    widgets.sav_save_button.set_sensitive(False)
    widgets.p_process_button.set_sensitive(False)

    input_filename = widgets.dec_input_chooser.get()
    if not input_filename:
        callback(err.InternalError("Select input file"))
        return None

    sync = bool(widgets.dec_sync_check.get())
    wav_steps = bool(widgets.dec_wav_steps_check.get())
    resample_step = bool(widgets.dec_resample_step_check.get())
    settings = state.settings
    progress_callback = _progress_marshal()

    def worker():
        try:
            device = resolve_device(state.device)  # raises without CUDA
            signal, rate = wav.load_device_ready(input_filename)
            context = Context.decode(
                progress_callback, Rate(settings.work_rate), Rate(FINAL_RATE),
                wav_steps, resample_step,
            )
            if wav_steps or resample_step:
                # Step-export runs the eager stage-by-stage pipeline;
                # the result is the flat FINAL_RATE signal.  The
                # resample_step flag alone also routes here: in the
                # reference it changes the resampler's decimation grid
                # (dsp.rs:265-276) even without step WAVs.
                from ..graph.debug import decode_with_steps

                raw, _ = decode_with_steps(context, settings.profile(), signal, rate, sync, device)
                callback(raw)
            else:
                from ..graph.decode import Decoder

                decoder = state.decoder
                if (decoder is None or decoder.profile != settings.profile()
                        or decoder.device != device):
                    decoder = Decoder(settings.profile(), device=device)
                result = decoder.decode(signal, rate, sync, context)
                callback(result, decoder)
        except Exception as e:  # noqa: BLE001 — one GUI error surface
            callback(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    return t


_auto_update_pending = False


def process_if_auto_update_enabled() -> threading.Thread | None:
    """Run process() on any Process-tab change when auto-update is on
    (work.rs:205-213).

    Gated on the Process button's sensitivity so a burst of changes
    (e.g. the decode callback prefilling eight widgets) can't spawn
    concurrent process() workers over half-updated state; the trailing
    change re-runs once when the in-flight process finishes.
    """
    global _auto_update_pending
    widgets = borrow_widgets()
    if not widgets.p_auto_update_check.get():
        return None
    if not widgets.p_process_button.sensitive:
        _auto_update_pending = True
        return None
    return process()


def _rerun_if_auto_update_pending() -> None:
    global _auto_update_pending
    if _auto_update_pending:
        _auto_update_pending = False
        process_if_auto_update_enabled()


def process() -> threading.Thread | None:
    """Marshal ~25 widgets into Contrast/Rotate/Color/Orbit settings and
    process the cached decode on a worker thread (work.rs:218-507)."""
    widgets = borrow_widgets()
    state = borrow_state()

    def callback(result):
        def apply():
            widgets.dec_decode_button.set_sensitive(True)
            widgets.p_process_button.set_sensitive(True)
            if isinstance(result, Exception):
                misc.set_progress(1.0, "Error")
                misc.show_info("error", str(result))
                log.error("%s", result)
                state.processed_image = None
                misc.update_image()
            else:
                misc.set_progress(1.0, "Processed")
                widgets.sav_save_button.set_sensitive(True)
                state.processed_image = result
                misc.update_image()
            _rerun_if_auto_update_pending()

        widgets.idle_add(apply)

    misc.set_progress(0.0, "Processing")
    widgets.info.hide()
    widgets.dec_decode_button.set_sensitive(False)
    widgets.sav_save_button.set_sensitive(False)
    widgets.p_process_button.set_sensitive(False)

    # --- widget -> settings marshalling (error strings match work.rs) ---
    contrast_id = widgets.p_contrast_combo.get()
    contrast = {
        "98_percent": Contrast.from_percent(0.98),
        "telemetry": Contrast.telemetry(),
        "histogram": Contrast.histogram(),
        "minmax": Contrast.minmax(),
    }.get(contrast_id)
    if contrast is None:
        callback(err.InternalError(
            "Select contrast adjustment" if contrast_id is None
            else f'Unknown contrast adjustment "{contrast_id}"'
        ))
        return None

    rotate_id = widgets.p_rotate_combo.get()
    rotate = {"auto": Rotate.ORBIT, "no": Rotate.NO, "yes": Rotate.YES}.get(rotate_id)
    if rotate is None:
        callback(err.InternalError(
            "Select rotation option" if rotate_id is None
            else f'Unknown rotation "{rotate_id}"'
        ))
        return None

    color = None
    if widgets.p_false_color_check.get():
        palette_filename = widgets.p_palette_chooser.get()
        if not palette_filename:
            callback(err.InternalError("Select palette file"))
            return None
        try:
            color = ColorSettings(
                palette_filename=Path(palette_filename),
                ch_a_tune_start=float(widgets.p_channel_a_start_scale.get()),
                ch_a_tune_end=float(widgets.p_channel_a_end_scale.get()),
                ch_b_tune_start=float(widgets.p_channel_b_start_scale.get()),
                ch_b_tune_end=float(widgets.p_channel_b_end_scale.get()),
            )
        except Exception:  # noqa: BLE001 — any unparsable widget state
            callback(err.InternalError("Invalid false color setting"))
            return None

    sat_id = widgets.p_satellite_combo.get()
    sat_name = _SAT_IDS.get(sat_id)
    if sat_name is None:
        callback(err.InternalError(
            "Select satellite option" if sat_id is None
            else f'Unknown satellite "{sat_id}"'
        ))
        return None

    custom_tle = None
    if widgets.p_custom_tle_check.get():
        tle_path = widgets.p_custom_tle_chooser.get()
        if not tle_path:
            callback(err.InternalError("Select custom TLE input file"))
            return None
        try:
            custom_tle = Path(tle_path).read_text()
        except OSError as e:
            callback(err.InternalError(f"Could not open custom TLE file: {e}"))
            return None

    try:
        time = _read_datetime_widgets(
            widgets.p_calendar, widgets.p_hs_spinner,
            widgets.p_min_spinner, widgets.p_sec_spinner,
        )
    except err.InternalError as e:
        callback(e)
        return None

    ref_id = widgets.p_ref_time_combo.get()
    if ref_id == "start":
        ref_time = RefTime.start(time)
    elif ref_id == "end":
        ref_time = RefTime.end(time)
    else:
        callback(err.InternalError("Select if provided time is recording start or end"))
        return None

    draw_map = None
    if widgets.p_overlay_check.get():
        import math

        try:
            # Inside the try: Tk spinbox variables raise TclError on
            # transient non-numeric text (e.g. a lone "-" mid-edit),
            # and the buttons are already insensitive — an escaping
            # exception would strand them disabled.
            draw_map = MapSettings(
                yaw=float(widgets.p_yaw_spinner.get()) * math.pi / 180.0,
                hscale=float(widgets.p_hscale_spinner.get()) / 100.0,
                vscale=float(widgets.p_vscale_spinner.get()) / 100.0,
                countries_color=tuple(widgets.p_countries_color.get()),
                states_color=tuple(widgets.p_states_color.get()),
                lakes_color=tuple(widgets.p_lakes_color.get()),
            )
        except Exception:  # noqa: BLE001 — any unparsable widget state
            callback(err.InternalError("Invalid map overlay setting"))
            return None

    orbit = OrbitSettings(
        sat_name=sat_name, custom_tle=custom_tle,
        ref_time=ref_time, draw_map=draw_map,
    )

    settings = state.settings
    signal = state.decoded_signal
    if signal is None:
        callback(err.InternalError("No decoded image?"))
        return None
    wav_steps = bool(widgets.dec_wav_steps_check.get())
    resample_step = bool(widgets.dec_resample_step_check.get())
    progress_callback = _progress_marshal()

    def worker():
        try:
            from ..graph.process import process as run_process

            context = Context.decode(
                progress_callback, Rate(settings.work_rate), Rate(FINAL_RATE),
                wav_steps, resample_step,
            )
            img = run_process(signal, contrast, rotate, color, orbit, context)
            callback(img)
        except Exception as e:  # noqa: BLE001
            callback(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    return t


def save() -> None:
    """Save the processed image (work.rs:512-546)."""
    widgets = borrow_widgets()
    state = borrow_state()

    widgets.info.hide()
    misc.set_progress(0.0, "Saving")

    output_filename = widgets.sav_output_entry.get()
    if not output_filename:
        misc.set_progress(1.0, "Error")
        misc.show_info("error", "Select output filename")
        log.error("Select output filename")
        return

    processed_image = state.processed_image
    if processed_image is None:
        misc.show_info("info", "No processed image to save?")
        log.error("No processed image to save?")
        return

    try:
        png.write_png(output_filename, processed_image)
    except Exception as e:  # noqa: BLE001
        misc.set_progress(1.0, "Error")
        # Quirk kept: the reference shows save failures with Info
        # severity, not Error (work.rs:535-541).
        misc.show_info("info", f"Error saving image: {e}")
        log.error("Error saving image: %s", e)
        return
    misc.set_progress(1.0, "Saved")


def resample() -> threading.Thread | None:
    """WAV resample tool (work.rs:548-612)."""
    widgets = borrow_widgets()
    state = borrow_state()

    def callback(result):
        def apply():
            widgets.res_resample_button.set_sensitive(True)
            if isinstance(result, Exception):
                misc.set_progress(1.0, "Error")
                misc.show_info("error", str(result))
                log.error("%s", result)
            else:
                misc.set_progress(1.0, "Finished")

        widgets.idle_add(apply)

    misc.set_progress(0.0, "Resampling")
    widgets.info.hide()
    widgets.res_resample_button.set_sensitive(False)

    input_filename = widgets.res_input_chooser.get()
    if not input_filename:
        callback(err.InternalError("Select input file"))
        return None
    output_filename = widgets.res_output_entry.get()
    if not output_filename:
        # The reference lets this fail deep in the WAV writer; failing
        # fast saves a full resample run before the inevitable error.
        callback(err.InternalError("Select output filename"))
        return None
    wav_steps = bool(widgets.res_wav_steps_check.get())
    resample_step = bool(widgets.res_resample_step_check.get())
    try:
        output_rate = int(widgets.res_rate_spinner.get())
    except Exception:  # noqa: BLE001 — Tk vars raise TclError on junk text
        callback(err.InternalError("Invalid sample rate"))
        return None
    settings = state.settings
    device = state.device
    progress_callback = _progress_marshal()

    def worker():
        try:
            from ..graph import resample_tool

            context = Context.resample(progress_callback, wav_steps, resample_step)
            resample_tool.resample(
                context, settings, input_filename, output_filename, output_rate, device
            )
            callback(None)
        except Exception as e:  # noqa: BLE001
            callback(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    return t


def write_timestamp() -> None:
    """Write the calendar+spinner time as the file's mtime
    (work.rs:615-665)."""
    widgets = borrow_widgets()

    def show_error(msg: str) -> None:
        misc.show_info("error", msg)
        log.error("%s", msg)

    filename = widgets.ts_write_chooser.get()
    if not filename:
        show_error("Select file to write")
        return
    try:
        local = _read_datetime_widgets(
            widgets.ts_calendar, widgets.ts_hs_spinner,
            widgets.ts_min_spinner, widgets.ts_sec_spinner,
        )
    except err.InternalError as e:
        show_error(str(e))
        return
    try:
        io_misc.write_timestamp(int(local.timestamp()), filename)
    except err.AptError as e:
        show_error(f"Error writing timestamp: {e}")
        return
    misc.show_info("info", "Timestamp written to file")


def read_timestamp() -> None:
    """Load the file's mtime into the calendar+spinners
    (work.rs:668-701)."""
    widgets = borrow_widgets()

    def show_error(msg: str) -> None:
        misc.show_info("error", msg)
        log.error("%s", msg)

    filename = widgets.ts_read_chooser.get()
    if not filename:
        show_error("Select file to read")
        return
    try:
        timestamp = io_misc.read_timestamp(filename)
    except err.AptError as e:
        show_error(f"Error reading timestamp: {e}")
        return
    local = datetime.fromtimestamp(timestamp).astimezone()
    _set_datetime_widgets(
        widgets, widgets.ts_calendar, widgets.ts_hs_spinner,
        widgets.ts_min_spinner, widgets.ts_sec_spinner, local,
    )
    misc.show_info("info", "Loaded timestamp from file")
