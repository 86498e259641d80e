"""GUI state and widget registry.

Behavioral contract: reference ``src/gui/state.rs`` — a global
``GuiState`` (settings + cached decode result + processed image, so
reprocessing never re-runs DSP, state.rs:118-122) and a global
``Widgets`` registry built once at startup (state.rs:137-324).

A copy of ``noaa_apt_tpu/gui/state.py``; :class:`GuiState` also holds
the device the decodes run on.

The logic layer separates the widget *values* from the toolkit: every
knob is a :class:`Value` (uniform get/set + change notification) and
every action a :class:`Button`.  ``work.py``/``misc.py`` only ever
touch this interface, so the whole GUI logic layer runs headless (the
test suite drives it without a display); the Tk shell in ``app.py``
binds each Value to a real widget.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Callable, Optional


class Value:
    """A widget-backed value: get/set plus change callbacks.

    The in-memory default is used directly by tests; the Tk layer
    injects ``getter``/``setter`` so reads and writes go through the
    real widget variable (whose trace fires :meth:`fire`).
    """

    def __init__(self, initial: Any = None):
        self._value = initial
        self._callbacks: list[Callable[[], None]] = []
        self._getter: Optional[Callable[[], Any]] = None
        self._setter: Optional[Callable[[Any], None]] = None

    def bind(self, getter: Callable[[], Any], setter: Callable[[Any], None]) -> None:
        """Attach a real widget; subsequent get/set proxy through it."""
        self._getter = getter
        self._setter = setter

    def get(self) -> Any:
        return self._getter() if self._getter is not None else self._value

    def set(self, value: Any) -> None:
        if self._setter is not None:
            # The widget's own change event calls fire(); avoid firing
            # twice for one programmatic set.
            self._setter(value)
        else:
            self._value = value
            self.fire()

    def on_change(self, callback: Callable[[], None]) -> None:
        self._callbacks.append(callback)

    def fire(self) -> None:
        for cb in list(self._callbacks):
            cb()


class Button:
    """An action widget: sensitivity plus a click hook."""

    def __init__(self) -> None:
        self.sensitive = True
        self._on_click: Optional[Callable[[], None]] = None
        self._on_sensitive: Optional[Callable[[bool], None]] = None

    def connect(self, on_click: Callable[[], None]) -> None:
        self._on_click = on_click

    def bind_sensitive(self, hook: Callable[[bool], None]) -> None:
        self._on_sensitive = hook

    def set_sensitive(self, sensitive: bool) -> None:
        self.sensitive = bool(sensitive)
        if self._on_sensitive is not None:
            self._on_sensitive(self.sensitive)

    def click(self) -> None:
        if self.sensitive and self._on_click is not None:
            self._on_click()


class ProgressView:
    """Progress bar model (gui/misc.rs:13-18)."""

    def __init__(self) -> None:
        self.fraction = 0.0
        self.description = ""
        self._hook: Optional[Callable[[float, str], None]] = None

    def bind(self, hook: Callable[[float, str], None]) -> None:
        self._hook = hook

    def set(self, fraction: float, description: str) -> None:
        self.fraction = float(fraction)
        self.description = description
        if self._hook is not None:
            self._hook(self.fraction, self.description)


class InfoView:
    """Info bar model (gui/misc.rs:21-37): one message + severity,
    revealed until closed or the next action starts."""

    def __init__(self) -> None:
        self.revealed = False
        self.kind = "info"
        self.text = ""
        self._hook: Optional[Callable[[], None]] = None

    def bind(self, hook: Callable[[], None]) -> None:
        self._hook = hook

    def show(self, kind: str, text: str) -> None:
        assert kind in ("info", "warning", "error")
        self.kind = kind
        self.text = text
        self.revealed = True
        if self._hook is not None:
            self._hook()

    def hide(self) -> None:
        self.revealed = False
        if self._hook is not None:
            self._hook()


class ImageView:
    """Right-pane preview (gui/misc.rs:122-169).

    ``set_preview`` receives the already-scaled RGBA uint8 array (or
    None for the placeholder); ``viewport_size`` reports the available
    area so ``misc.update_image`` can fit the image.
    """

    def __init__(self) -> None:
        self.preview = None
        self._viewport = (900, 600)
        self._hook: Optional[Callable[[], None]] = None

    def bind(self, hook: Callable[[], None], viewport: Callable[[], tuple]) -> None:
        self._hook = hook
        self._viewport_fn = viewport

    def viewport_size(self) -> tuple:
        fn = getattr(self, "_viewport_fn", None)
        return fn() if fn is not None else self._viewport

    def set_preview(self, rgba) -> None:
        self.preview = rgba
        if self._hook is not None:
            self._hook()


def _v(initial: Any) -> Any:
    return field(default_factory=lambda: Value(initial))


def _btn() -> Any:
    return field(default_factory=Button)


@dataclass
class Widgets:
    """Every named widget the logic layer touches (state.rs:137-324).

    Field names follow the reference's widget ids so work.py reads
    like work.rs.  ``idle_add`` marshals a callable onto the GUI
    thread (glib::idle_add analog); the default executes inline,
    which is what the headless tests want.
    """

    idle_add: Callable[[Callable[[], None]], None] = field(
        default_factory=lambda: (lambda fn: fn())
    )
    progress: ProgressView = field(default_factory=ProgressView)
    info: InfoView = field(default_factory=InfoView)
    image: ImageView = field(default_factory=ImageView)
    img_size_toggle: Value = _v(False)  # "Normal size" toggle

    # Decode tab
    dec_input_chooser: Value = _v(None)
    dec_sync_check: Value = _v(True)
    dec_wav_steps_check: Value = _v(False)
    dec_resample_step_check: Value = _v(False)
    dec_decode_button: Button = _btn()

    # Process tab
    p_process_button: Button = _btn()
    p_contrast_combo: Value = _v("98_percent")
    p_rotate_combo: Value = _v("auto")
    p_satellite_combo: Value = _v("noaa_19")
    p_ref_time_combo: Value = _v("start")
    p_false_color_check: Value = _v(False)
    p_palette_chooser: Value = _v(None)
    p_channel_a_start_scale: Value = _v(0.0)
    p_channel_a_end_scale: Value = _v(0.0)
    p_channel_b_start_scale: Value = _v(0.0)
    p_channel_b_end_scale: Value = _v(0.0)
    p_custom_tle_check: Value = _v(False)
    p_custom_tle_chooser: Value = _v(None)
    p_calendar: Value = _v((2020, 1, 1))  # (year, month 1-12, day)
    p_hs_spinner: Value = _v(0)
    p_min_spinner: Value = _v(0)
    p_sec_spinner: Value = _v(0)
    p_overlay_check: Value = _v(False)
    p_countries_color: Value = _v((255, 255, 0, 255))
    p_states_color: Value = _v((255, 255, 0, 150))
    p_lakes_color: Value = _v((50, 200, 200, 255))
    p_yaw_spinner: Value = _v(0.0)  # degrees
    p_hscale_spinner: Value = _v(100.0)  # percent
    p_vscale_spinner: Value = _v(100.0)  # percent
    p_auto_update_check: Value = _v(False)

    # Save tab
    sav_output_entry: Value = _v("")
    sav_save_button: Button = _btn()

    # Resample tool
    res_input_chooser: Value = _v(None)
    res_output_entry: Value = _v("")
    res_rate_spinner: Value = _v(11025)
    res_wav_steps_check: Value = _v(False)
    res_resample_step_check: Value = _v(False)
    res_resample_button: Button = _btn()

    # Timestamp tool
    ts_read_chooser: Value = _v(None)
    ts_write_chooser: Value = _v(None)
    ts_calendar: Value = _v((2020, 1, 1))
    ts_hs_spinner: Value = _v(0)
    ts_min_spinner: Value = _v(0)
    ts_sec_spinner: Value = _v(0)
    ts_read_button: Button = _btn()
    ts_write_button: Button = _btn()


# Every Process-tab knob that re-runs process() when auto-update is on
# (the ~25 connect_* calls in gui.rs:360-410).
AUTO_UPDATE_WIDGETS = (
    "p_contrast_combo",
    "p_rotate_combo",
    "p_false_color_check",
    "p_channel_a_start_scale",
    "p_channel_a_end_scale",
    "p_channel_b_start_scale",
    "p_channel_b_end_scale",
    "p_palette_chooser",
    "p_satellite_combo",
    "p_custom_tle_check",
    "p_custom_tle_chooser",
    "p_ref_time_combo",
    "p_hs_spinner",
    "p_min_spinner",
    "p_sec_spinner",
    "p_overlay_check",
    "p_countries_color",
    "p_states_color",
    "p_lakes_color",
    "p_yaw_spinner",
    "p_vscale_spinner",
    "p_hscale_spinner",
    "p_calendar",
)


def wire_auto_update(widgets: Widgets, trigger: Callable[[], None]) -> None:
    """Connect every Process-tab knob to ``trigger`` (gui.rs:360-410)."""
    for name in AUTO_UPDATE_WIDGETS:
        getattr(widgets, name).on_change(trigger)


@dataclass
class GuiState:
    """Changing state (state.rs:118-122) plus the live
    :class:`~noaa_apt_tpu_torch.graph.decode.Decoder`, reused across
    decodes, and the ``torch.device`` that every decode and resample runs
    on (None is the card: without CUDA the decode raises, it never falls
    back to the CPU).  The cached ``DecodeResult`` keeps its rows on that
    device, so reprocessing runs the levels and the u8 map there."""

    settings: Any
    decoded_signal: Any = None  # DecodeResult | np.ndarray | None
    processed_image: Any = None  # RGBA uint8 [H, 2080, 4] | None
    decoder: Any = None
    device: Any = None  # torch.device | None


_WIDGETS: Optional[Widgets] = None
_STATE: Optional[GuiState] = None


def set_widgets(widgets: Widgets) -> None:
    global _WIDGETS
    _WIDGETS = widgets


def set_state(state: GuiState) -> None:
    global _STATE
    _STATE = state


def borrow_widgets() -> Widgets:
    assert _WIDGETS is not None, "GUI widgets not initialized"
    return _WIDGETS


def borrow_state() -> GuiState:
    assert _STATE is not None, "GUI state not initialized"
    return _STATE


def widget_names() -> list[str]:
    return [f.name for f in fields(Widgets)]
