"""Tk widget shell.

Behavioral contract: reference ``src/gui/gui.rs`` + ``src/gui/main.glade``
(window layout, menu bar, mode switching, the ~25 auto-update
triggers) rebuilt on tkinter.  Everything toolkit-specific lives here;
the logic layer (``work.py``/``misc.py``) only sees the
:class:`~noaa_apt_tpu_torch.gui.state.Widgets` value interface.

Threading model (gui.rs:3-24): one GUI thread runs the Tk mainloop;
worker threads never touch widgets — they submit closures through
``Widgets.idle_add``, implemented as a queue drained by a recurring
``root.after`` pump (the glib::idle_add analog).

A copy of ``noaa_apt_tpu/gui/app.py`` on the port: the window opens on a
device, its warm-up thread builds the CUDA kernels where that device is
the card, and the About text and the icon are the port's own.
"""

from __future__ import annotations

import queue
import tkinter as tk
from tkinter import colorchooser, filedialog, messagebox, ttk

from .. import __version__
from ..ops import _build
from . import misc, work
from .state import GuiState, Widgets, borrow_state, set_state, set_widgets, wire_auto_update

_WEBSITE = "https://noaa-apt.mbernardi.com.ar"


def _device_label(device) -> str:
    """The card's name (``cuda:0, NVIDIA H100 80GB HBM3``), or ``cpu``."""
    if device is not None and device.type == "cuda":
        import torch

        return f"{device}, {torch.cuda.get_device_name(device)}"
    return str(device)


def warm_kernels(device) -> None:
    """Build (or load) every CUDA kernel library when ``device`` is the
    card; nothing on the CPU.  ``_build.library`` holds the build lock,
    so a decode started meanwhile waits for this build instead of
    starting a second ``nvcc`` onto the same paths; a build error is
    raised here and again by that decode, into its info bar."""
    if device is not None and device.type == "cuda":
        for name in _build.SOURCES:
            _build.library(name)


def _bind_var(value, tkvar, from_tk=lambda v: v):
    """Proxy a state Value through a Tk variable; the variable's write
    trace fires the Value's change callbacks."""
    value.bind(lambda: from_tk(tkvar.get()), tkvar.set)
    tkvar.trace_add("write", lambda *_: value.fire())
    return tkvar


def _file_row(parent, value, save=False, title="Select file"):
    """Entry + browse button bound to a file-path Value."""
    frame = ttk.Frame(parent)
    var = tk.StringVar(master=parent)
    _bind_var(value, var, from_tk=lambda s: s or None)
    entry = ttk.Entry(frame, textvariable=var, width=36)
    entry.pack(side="left", fill="x", expand=True)

    def browse():
        pick = filedialog.asksaveasfilename if save else filedialog.askopenfilename
        path = pick(title=title)
        if path:
            var.set(path)

    ttk.Button(frame, text="…", width=3, command=browse).pack(side="left")
    return frame


def _spin_row(parent, value, lo, hi, convert=int, increment=1, width=6):
    var = tk.DoubleVar(master=parent, value=value.get())
    _bind_var(value, var, from_tk=convert)
    return ttk.Spinbox(
        parent, from_=lo, to=hi, textvariable=var, width=width, increment=increment
    )


def _check(parent, text, value):
    var = tk.BooleanVar(master=parent, value=bool(value.get()))
    _bind_var(value, var, from_tk=bool)
    return ttk.Checkbutton(parent, text=text, variable=var)


def _combo(parent, value, ids, labels):
    """Combobox storing an id (GTK active_id analog) behind labels."""
    id_of = dict(zip(labels, ids))
    label_of = dict(zip(ids, labels))
    var = tk.StringVar(master=parent, value=label_of.get(value.get(), labels[0]))
    value.bind(lambda: id_of.get(var.get()), lambda v: var.set(label_of[v]))
    var.trace_add("write", lambda *_: value.fire())
    return ttk.Combobox(parent, textvariable=var, values=labels, state="readonly", width=18)


def _tz_label_text() -> str:
    """"Local time\\n(UTC+hh:mm)" next to the time spinners
    (gui.rs:147-157: the entered time is local, the label says so)."""
    from datetime import datetime

    off = datetime.now().astimezone().utcoffset()
    total = int(off.total_seconds()) if off is not None else 0
    sign = "+" if total >= 0 else "-"
    total = abs(total)
    return f"Local time\n(UTC{sign}{total // 3600:02d}:{total % 3600 // 60:02d})"


def _calendar_row(parent, value):
    """Year/month/day spinboxes composing a (y, m, d) Value."""
    frame = ttk.Frame(parent)
    y0, m0, d0 = value.get()
    vy = tk.IntVar(master=parent, value=y0)
    vm = tk.IntVar(master=parent, value=m0)
    vd = tk.IntVar(master=parent, value=d0)

    def get():
        return (vy.get(), vm.get(), vd.get())

    def setv(ymd):
        y, m, d = ymd
        vy.set(int(y)), vm.set(int(m)), vd.set(int(d))

    value.bind(get, setv)
    for var in (vy, vm, vd):
        var.trace_add("write", lambda *_: value.fire())
    for var, lo, hi, w in ((vy, 1970, 2100, 6), (vm, 1, 12, 4), (vd, 1, 31, 4)):
        ttk.Spinbox(frame, from_=lo, to=hi, textvariable=var, width=w).pack(side="left")
    return frame


def _color_button(parent, value, text):
    """Swatch button opening the color chooser; alpha is preserved from
    the current value (Tk's chooser is RGB-only)."""

    def to_hex(rgba):
        return "#%02x%02x%02x" % tuple(rgba[:3])

    btn = tk.Button(parent, text=text, bg=to_hex(value.get()), width=10)

    def pick():
        rgb, _hex = colorchooser.askcolor(color=to_hex(value.get()), parent=parent)
        if rgb is not None:
            alpha = value.get()[3]
            value.set((int(rgb[0]), int(rgb[1]), int(rgb[2]), alpha))
            btn.configure(bg=to_hex(value.get()))

    btn.configure(command=pick)
    return btn


def _grid_rows(frame, rows):
    for r, (label, widget) in enumerate(rows):
        ttk.Label(frame, text=label).grid(row=r, column=0, sticky="w", padx=4, pady=2)
        widget.grid(row=r, column=1, sticky="ew", padx=4, pady=2)
    frame.columnconfigure(1, weight=1)


class App:
    """Window shell: builds widgets, wires actions, runs the mainloop."""

    def __init__(self, check_updates: bool, settings, device) -> None:
        # Decode-button UX: build the kernels (one nvcc per source, the
        # first time on a machine) in a daemon thread, so the window
        # appears without waiting for the build.
        import threading

        threading.Thread(target=warm_kernels, args=(device,), daemon=True,
                         name="gui-warmup").start()
        self.root = tk.Tk()
        self.root.title("noaa-apt")
        self.root.geometry("1000x640")
        try:
            # Window icon (gui.rs:65 sets the GTK default icon).
            from ..io.config import res_path

            icon = res_path("icon.png")
            if icon.exists():
                self._icon = tk.PhotoImage(file=str(icon))
                self.root.iconphoto(True, self._icon)
        except Exception:  # noqa: BLE001 — cosmetic, never fatal
            pass

        self.widgets = w = Widgets()
        set_widgets(w)
        set_state(GuiState(settings=settings, device=device))

        # idle_add: thread-safe queue drained on the GUI thread
        # (gui.rs:20-24's glib::idle_add analog).
        self._idle: queue.Queue = queue.Queue()
        w.idle_add = self._idle.put
        self._pump()

        self._build_menu()
        self._build_layout()
        self._wire()

        self._dec_ready()
        if check_updates:
            misc.check_updates_and_show(__version__)

    # -- plumbing ------------------------------------------------------
    def _pump(self) -> None:
        # Always reschedule, and never let one failing closure kill the
        # pump — that would strand every future worker callback.
        try:
            while True:
                fn = self._idle.get_nowait()
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    import logging

                    logging.getLogger(__name__).exception("idle callback failed")
        except queue.Empty:
            pass
        finally:
            self.root.after(30, self._pump)

    # -- menu (gui.rs:485-593) ------------------------------------------
    def _build_menu(self) -> None:
        menubar = tk.Menu(self.root)
        tools = tk.Menu(menubar, tearoff=0)
        tools.add_command(label="Decode", command=self._dec_ready)
        tools.add_command(label="Resample WAV", command=self._res_ready)
        tools.add_command(label="Timestamp WAV", command=self._ts_ready)
        menubar.add_cascade(label="Tools", menu=tools)
        helpm = tk.Menu(menubar, tearoff=0)
        helpm.add_command(
            label="Usage", command=lambda: misc.open_in_browser(f"{_WEBSITE}/usage.html")
        )
        helpm.add_command(
            label="Guide", command=lambda: misc.open_in_browser(f"{_WEBSITE}/guide.html")
        )
        helpm.add_command(label="About", command=self._about)
        menubar.add_cascade(label="Help", menu=helpm)
        self.root.config(menu=menubar)

    def _about(self) -> None:
        messagebox.showinfo(
            "About noaa-apt",
            f"noaa-apt-tpu-torch {__version__}\n\n"
            "NOAA APT image decoder, PyTorch and CUDA engine for NVIDIA Hopper.\n"
            f"Decoding on {_device_label(borrow_state().device)}.\n"
            f"Based on noaa-apt by Martín Bernardi ({_WEBSITE}).\n"
            "License: GPL-3.0",
        )

    # -- layout -----------------------------------------------------------
    def _build_layout(self) -> None:
        w = self.widgets
        outer = ttk.Frame(self.root)
        outer.pack(fill="both", expand=True)

        paned = ttk.PanedWindow(outer, orient="horizontal")
        paned.pack(fill="both", expand=True)

        # Left: mode stack (decode/resample/timestamp), switched by menu.
        left = ttk.Frame(paned, width=420)
        paned.add(left, weight=0)
        self.mode_frames = {}
        for name in ("decode", "resample", "timestamp"):
            f = ttk.Frame(left)
            f.place(relx=0, rely=0, relwidth=1, relheight=1)
            self.mode_frames[name] = f
        self._build_decode_mode(self.mode_frames["decode"])
        self._build_resample_mode(self.mode_frames["resample"])
        self._build_timestamp_mode(self.mode_frames["timestamp"])

        # Right: image preview.
        right = ttk.Frame(paned)
        paned.add(right, weight=1)
        toggle = _check(right, "Normal size", w.img_size_toggle)
        toggle.pack(anchor="ne")
        self.preview_label = ttk.Label(right, anchor="center")
        self.preview_label.pack(fill="both", expand=True)
        self._photo = None  # keep a reference or Tk garbage-collects it

        def render_preview() -> None:
            arr = w.image.preview
            if arr is None:
                self.preview_label.configure(image="", text="noaa-apt")
                self._photo = None
                return
            # Tk reads PPM natively: header + raw RGB bytes, no deflate
            # and no base64 — at "Normal size" on a full pass the old
            # PNG round trip froze the mainloop for hundreds of ms per
            # auto-update.
            import numpy as np

            if arr.ndim == 2:
                rgb = np.repeat(arr[:, :, None], 3, axis=2)
            else:
                rgb = np.ascontiguousarray(arr[:, :, :3])
            h, width = rgb.shape[:2]
            ppm = b"P6 %d %d 255\n" % (width, h) + rgb.tobytes()
            self._photo = tk.PhotoImage(data=ppm)
            self.preview_label.configure(image=self._photo, text="")

        w.image.bind(
            render_preview,
            lambda: (
                max(self.preview_label.winfo_width(), 1),
                max(self.preview_label.winfo_height(), 1),
            ),
        )
        w.img_size_toggle.on_change(misc.update_image)

        # Bottom: progress bar + info bar.
        bottom = ttk.Frame(outer)
        bottom.pack(fill="x")
        self.progress_bar = ttk.Progressbar(bottom, maximum=1.0)
        self.progress_bar.pack(side="left", fill="x", expand=True, padx=4)
        self.progress_text = ttk.Label(bottom, text="Ready", width=24)
        self.progress_text.pack(side="left")

        def progress_hook(fraction: float, description: str) -> None:
            self.progress_bar["value"] = fraction
            self.progress_text.configure(text=description)

        w.progress.bind(progress_hook)

        self.info_frame = tk.Frame(outer, bd=1, relief="solid")
        self.info_label = tk.Label(self.info_frame, anchor="w")
        self.info_label.pack(side="left", fill="x", expand=True, padx=6)
        tk.Button(self.info_frame, text="✕", command=w.info.hide).pack(side="right")

        def info_hook() -> None:
            if not w.info.revealed:
                self.info_frame.pack_forget()
                return
            colors = {"info": "#d9edf7", "warning": "#fcf8e3", "error": "#f2dede"}
            prefix = {"info": "", "warning": "Warning: ", "error": "Error: "}
            self.info_frame.configure(bg=colors[w.info.kind])
            self.info_label.configure(
                bg=colors[w.info.kind], text=prefix[w.info.kind] + w.info.text
            )
            self.info_frame.pack(fill="x", before=bottom)

        w.info.bind(info_hook)

    def _build_decode_mode(self, parent) -> None:
        w = self.widgets
        nb = ttk.Notebook(parent)
        nb.pack(fill="both", expand=True)

        # Decode tab (glade: dec_*)
        dec = ttk.Frame(nb)
        nb.add(dec, text="Decode")
        self.btn_decode = ttk.Button(dec, text="Decode")
        _grid_rows(dec, [
            ("Input WAV", _file_row(dec, w.dec_input_chooser, title="Select input WAV")),
            ("", _check(dec, "Sync frames", w.dec_sync_check)),
            ("", _check(dec, "Export WAV steps (debug)", w.dec_wav_steps_check)),
            ("", _check(dec, "Export resample step", w.dec_resample_step_check)),
            ("", self.btn_decode),
        ])

        # Process tab (glade: p_*)
        p = ttk.Frame(nb)
        nb.add(p, text="Process")
        self.btn_process = ttk.Button(p, text="Process")
        tune = ttk.Frame(p)
        for i, (label, val) in enumerate([
            ("A start", w.p_channel_a_start_scale), ("A end", w.p_channel_a_end_scale),
            ("B start", w.p_channel_b_start_scale), ("B end", w.p_channel_b_end_scale),
        ]):
            ttk.Label(tune, text=label).grid(row=i, column=0, sticky="w")
            var = tk.DoubleVar(master=p, value=val.get())
            _bind_var(val, var, from_tk=float)
            ttk.Scale(tune, from_=-1.0, to=1.0, variable=var).grid(row=i, column=1, sticky="ew")
        tune.columnconfigure(1, weight=1)
        colors = ttk.Frame(p)
        _color_button(colors, w.p_countries_color, "Countries").pack(side="left")
        _color_button(colors, w.p_states_color, "States").pack(side="left")
        _color_button(colors, w.p_lakes_color, "Lakes").pack(side="left")
        timerow = ttk.Frame(p)
        _calendar_row(timerow, w.p_calendar).pack(side="left")
        _spin_row(timerow, w.p_hs_spinner, 0, 23).pack(side="left")
        _spin_row(timerow, w.p_min_spinner, 0, 59).pack(side="left")
        _spin_row(timerow, w.p_sec_spinner, 0, 59).pack(side="left")
        ttk.Label(timerow, text=_tz_label_text()).pack(side="left", padx=4)
        _grid_rows(p, [
            ("Contrast", _combo(p, w.p_contrast_combo,
                ["98_percent", "telemetry", "histogram", "minmax"],
                ["98 percent", "From telemetry", "Histogram equalization", "Min-Max"])),
            ("Rotate", _combo(p, w.p_rotate_combo,
                ["auto", "no", "yes"], ["Auto (orbit)", "No", "Yes"])),
            ("", _check(p, "False color", w.p_false_color_check)),
            ("Palette", _file_row(p, w.p_palette_chooser, title="Select palette PNG")),
            ("Tune", tune),
            ("Satellite", _combo(p, w.p_satellite_combo,
                ["noaa_15", "noaa_18", "noaa_19"], ["NOAA 15", "NOAA 18", "NOAA 19"])),
            ("", _check(p, "Custom TLE", w.p_custom_tle_check)),
            ("TLE file", _file_row(p, w.p_custom_tle_chooser, title="Select TLE")),
            ("Time is", _combo(p, w.p_ref_time_combo,
                ["start", "end"], ["Recording start", "Recording end"])),
            ("Date (local)", timerow),
            ("", _check(p, "Map overlay", w.p_overlay_check)),
            ("Map colors", colors),
            ("Yaw (deg)", _spin_row(p, w.p_yaw_spinner, -90.0, 90.0, float, 0.1)),
            ("H scale (%)", _spin_row(p, w.p_hscale_spinner, 10.0, 500.0, float, 1.0)),
            ("V scale (%)", _spin_row(p, w.p_vscale_spinner, 10.0, 500.0, float, 1.0)),
            ("", _check(p, "Auto update", w.p_auto_update_check)),
            ("", self.btn_process),
        ])

        # Save tab (glade: sav_*)
        sav = ttk.Frame(nb)
        nb.add(sav, text="Save")
        self.btn_save = ttk.Button(sav, text="Save")
        sav_tip = ttk.Label(sav, text="", wraplength=380)
        _grid_rows(sav, [
            ("Output PNG", _file_row(sav, w.sav_output_entry, save=True, title="Save image as")),
            ("", sav_tip),
            ("", self.btn_save),
        ])
        w.sav_output_entry.on_change(
            lambda: self._show_tips(sav_tip, w.sav_output_entry.get(), ".png")
        )

    def _build_resample_mode(self, parent) -> None:
        w = self.widgets
        f = ttk.LabelFrame(parent, text="Resample WAV")
        f.pack(fill="x", padx=8, pady=8)
        self.btn_resample = ttk.Button(f, text="Resample")
        res_tip = ttk.Label(f, text="", wraplength=380)
        _grid_rows(f, [
            ("Input WAV", _file_row(f, w.res_input_chooser, title="Select input WAV")),
            ("Output WAV", _file_row(f, w.res_output_entry, save=True, title="Save WAV as")),
            ("", res_tip),
            ("Rate (Hz)", _spin_row(f, w.res_rate_spinner, 1, 400000, int, 25, 8)),
            ("", _check(f, "Export WAV steps (debug)", w.res_wav_steps_check)),
            ("", _check(f, "Export resample step", w.res_resample_step_check)),
            ("", self.btn_resample),
        ])
        w.res_output_entry.on_change(
            lambda: self._show_tips(res_tip, w.res_output_entry.get(), ".wav")
        )

    def _build_timestamp_mode(self, parent) -> None:
        w = self.widgets
        f = ttk.LabelFrame(parent, text="Timestamp WAV")
        f.pack(fill="x", padx=8, pady=8)
        self.btn_ts_read = ttk.Button(f, text="Read")
        self.btn_ts_write = ttk.Button(f, text="Write")
        timerow = ttk.Frame(f)
        _calendar_row(timerow, w.ts_calendar).pack(side="left")
        _spin_row(timerow, w.ts_hs_spinner, 0, 23).pack(side="left")
        _spin_row(timerow, w.ts_min_spinner, 0, 59).pack(side="left")
        _spin_row(timerow, w.ts_sec_spinner, 0, 59).pack(side="left")
        ttk.Label(timerow, text=_tz_label_text()).pack(side="left", padx=4)
        _grid_rows(f, [
            ("Read from", _file_row(f, w.ts_read_chooser, title="Select file")),
            ("", self.btn_ts_read),
            ("Date (local)", timerow),
            ("Write to", _file_row(f, w.ts_write_chooser, title="Select file")),
            ("", self.btn_ts_write),
        ])

    def _show_tips(self, label, filename, extension) -> None:
        """Render output-path tips under a save entry (gui.rs:258-319)."""
        tips = misc.output_tips(filename, extension)
        lines = []
        if tips["folder"]:
            lines.append(f"Saving in {tips['folder']}")
        if tips["extension_warn"]:
            lines.append(f"Warning: Missing {extension} extension in filename")
        if tips["overwrite_warn"]:
            lines.append("Warning: File already exists, it will be overwritten")
        label.configure(text="\n".join(lines))

    # -- wiring (gui.rs:343-410) ---------------------------------------
    def _wire(self) -> None:
        w = self.widgets
        pairs = [
            (w.dec_decode_button, self.btn_decode, work.decode),
            (w.p_process_button, self.btn_process, work.process),
            (w.sav_save_button, self.btn_save, work.save),
            (w.res_resample_button, self.btn_resample, work.resample),
            (w.ts_read_button, self.btn_ts_read, work.read_timestamp),
            (w.ts_write_button, self.btn_ts_write, work.write_timestamp),
        ]
        for model, tkbtn, action in pairs:
            model.connect(action)
            tkbtn.configure(command=model.click)
            model.bind_sensitive(
                lambda s, b=tkbtn: b.configure(state="normal" if s else "disabled")
            )
        wire_auto_update(w, work.process_if_auto_update_enabled)

    # -- mode switching (gui.rs:404-482) ----------------------------------
    def _dec_ready(self) -> None:
        state = borrow_state()
        # The reference resets the working signal and image every time
        # the Decode mode is selected (gui.rs:417-421); only the
        # decoder cache survives (work.decode re-checks the profile and
        # the device before reuse).
        state.decoded_signal = None
        state.processed_image = None
        self.mode_frames["decode"].tkraise()
        self.widgets.dec_decode_button.set_sensitive(True)
        self.widgets.p_process_button.set_sensitive(False)
        self.widgets.sav_save_button.set_sensitive(False)
        misc.set_progress(0.0, "Ready")
        misc.update_image()

    def _res_ready(self) -> None:
        self.mode_frames["resample"].tkraise()
        misc.set_progress(0.0, "Ready")

    def _ts_ready(self) -> None:
        self.mode_frames["timestamp"].tkraise()
        misc.set_progress(0.0, "Ready")

    def run(self) -> None:
        self.root.mainloop()
