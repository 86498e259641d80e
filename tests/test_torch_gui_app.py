"""The port's Tk shell (``noaa_apt_tpu_torch.gui.app``), headless.

As ``tests/test_gui_app.py`` does for the JAX package's shell, these tests
inject a minimal fake ``tkinter`` and build the full ``App`` on the CPU
device, then drive the button/idle/progress/info machinery through it;
and they hold ``gui.main`` to the JAX package's refusals without a
display or without tkinter.
"""

import importlib
import io
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from test_gui_app import FakeWidget, _all_config_texts, _fake_tkinter

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _install_fake_tk(monkeypatch):
    mods = _fake_tkinter()
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return mods["tkinter"]


@pytest.fixture()
def app(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)
    _install_fake_tk(monkeypatch)
    sys.modules.pop("noaa_apt_tpu_torch.gui.app", None)
    app_mod = importlib.import_module("noaa_apt_tpu_torch.gui.app")

    from noaa_apt_tpu_torch.io import config as cfg

    settings = cfg.build_settings(cfg.load_de_settings())
    instance = app_mod.App(check_updates=False, settings=settings, device=CPU)
    yield instance
    # Leave a clean slate for other test modules importing the real app.
    sys.modules.pop("noaa_apt_tpu_torch.gui.app", None)


def test_app_constructs_and_registers_widgets(app):
    from noaa_apt_tpu_torch.gui.state import borrow_state, borrow_widgets

    w = borrow_widgets()
    assert borrow_state().settings is not None
    assert borrow_state().device == CPU
    # Values proxy through fake Tk variables: set via state, read back.
    w.p_contrast_combo.set("telemetry")
    assert w.p_contrast_combo.get() == "telemetry"
    w.p_calendar.set((2021, 7, 4))
    assert w.p_calendar.get() == (2021, 7, 4)
    w.p_countries_color.set((1, 2, 3, 77))
    assert w.p_countries_color.get() == (1, 2, 3, 77)
    # dec_ready initial state: decode enabled, process/save disabled.
    assert w.dec_decode_button.sensitive
    assert not w.p_process_button.sensitive
    assert not w.sav_save_button.sensitive
    assert w.progress.description == "Ready"


def test_app_button_and_info_wiring(app):
    from noaa_apt_tpu_torch.gui.state import borrow_widgets

    w = borrow_widgets()
    # Decode click with no input file -> error routed through idle
    # queue -> pumped -> info bar revealed on the fake label.
    w.dec_input_chooser.set(None)
    w.dec_decode_button.click()
    app._pump()
    assert w.info.revealed and w.info.kind == "error"
    assert "Select input file" in w.info.text
    assert "Select input file" in app.info_label.kwargs.get("text", "")
    assert w.dec_decode_button.sensitive  # callback re-enabled it

    # Progress hook drives the fake progressbar.
    w.progress.set(0.5, "Halfway")
    assert app.progress_bar.kwargs["value"] == 0.5
    assert app.progress_text.kwargs["text"] == "Halfway"


def test_app_auto_update_wiring(app, monkeypatch):
    from noaa_apt_tpu_torch.gui import work
    from noaa_apt_tpu_torch.gui.state import borrow_widgets

    w = borrow_widgets()
    calls = []
    monkeypatch.setattr(work, "process", lambda: calls.append(1))
    monkeypatch.setattr(work, "_auto_update_pending", False)
    w.p_auto_update_check.set(True)
    # Pre-decode the Process button is insensitive -> gated to pending.
    w.p_rotate_combo.set("yes")
    assert not calls and work._auto_update_pending
    # After a decode enables it, knob changes trigger process().
    work._auto_update_pending = False
    w.p_process_button.set_sensitive(True)
    w.p_rotate_combo.set("no")
    assert calls


def test_app_mode_switching_resets_state(app):
    from noaa_apt_tpu_torch.gui.state import borrow_state

    state = borrow_state()
    state.decoded_signal = object()
    state.processed_image = object()
    state.decoder = object()
    app._res_ready()
    app._ts_ready()
    app._dec_ready()
    # gui.rs:417-421: Tools>Decode wipes signal+image; decoder cache and device stay.
    assert state.decoded_signal is None
    assert state.processed_image is None
    assert state.decoder is not None and state.device == CPU


def test_app_output_tips_render(app, tmp_path, monkeypatch):
    from noaa_apt_tpu_torch.gui.state import borrow_widgets

    monkeypatch.chdir(tmp_path)
    w = borrow_widgets()
    w.sav_output_entry.set("picture.jpg")
    # The tip label under the Save tab received both warnings.
    texts = [c.get("text", "") for c in _all_config_texts(app.root)]
    assert any("Missing .png extension" in t for t in texts)
    assert any(str(tmp_path) in t for t in texts)
    w.res_output_entry.set("tone")
    texts = [c.get("text", "") for c in _all_config_texts(app.root)]
    assert any("Missing .wav extension" in t for t in texts)


def test_app_preview_renders_valid_ppm(app, monkeypatch):
    """The preview path hands Tk a raw PPM; the bytes decode back to the
    preview pixels, which are the JAX GUI's preview of the same image."""
    import tkinter as tk

    from noaa_apt_tpu.gui import misc as jmisc
    from noaa_apt_tpu_torch.gui import misc as gmisc
    from noaa_apt_tpu_torch.gui.state import borrow_state, borrow_widgets

    captured = {}

    class CapturingPhoto:
        def __init__(self, data=None):
            captured["data"] = data

    monkeypatch.setattr(tk, "PhotoImage", CapturingPhoto)

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 2080, 4), dtype=np.uint8)
    img[..., 3] = 255
    borrow_state().processed_image = img
    gmisc.update_image()

    data = captured["data"]
    assert isinstance(data, bytes) and data.startswith(b"P6")
    decoded = np.asarray(Image.open(io.BytesIO(data)))
    preview = borrow_widgets().image.preview
    np.testing.assert_array_equal(decoded, preview[..., :3])
    # The fake label is 800x600: the same fit as the JAX GUI's.
    np.testing.assert_array_equal(preview, jmisc.scale_preview(img, (800, 600), False))


def test_app_about_icon_and_warmup(tmp_path, monkeypatch):
    """The About text names the port and the device; the icon is the
    port's own ``res/icon.png``; the warm-up thread gets the device (and
    builds nothing on the CPU)."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)
    tk = _install_fake_tk(monkeypatch)
    icons, shown = [], []
    tk.PhotoImage = lambda data=None, file=None: icons.append(file) or FakeWidget()
    tk.messagebox.showinfo = lambda title, text: shown.append((title, text))
    sys.modules.pop("noaa_apt_tpu_torch.gui.app", None)
    app_mod = importlib.import_module("noaa_apt_tpu_torch.gui.app")
    warmed = []
    monkeypatch.setattr(app_mod, "warm_kernels", warmed.append)

    from noaa_apt_tpu_torch.io import config as cfg
    from noaa_apt_tpu_torch.io.config import res_path

    try:
        app = app_mod.App(check_updates=False, settings=cfg.build_settings(cfg.load_de_settings()),
                          device=CPU)
        for t in threading.enumerate():
            if t.name == "gui-warmup":
                t.join(timeout=10)
        assert warmed == [CPU]
        assert icons == [str(res_path("icon.png"))]
        assert res_path("icon.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        app._about()
        (title, text), = shown
        assert "noaa-apt-tpu-torch" in text and "Decoding on cpu." in text and "TPU" not in text
    finally:
        sys.modules.pop("noaa_apt_tpu_torch.gui.app", None)


def test_gui_main_refuses_without_display_or_tkinter(tmp_path, monkeypatch):
    """``gui.main`` raises ``FeatureNotAvailableError`` where Tk cannot
    open a display (``TclError``) and where tkinter is missing, as
    ``noaa_apt_tpu/gui/__init__.py:16-35`` does."""
    from noaa_apt_tpu_torch import err, gui
    from noaa_apt_tpu_torch.io import config as cfg

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    settings = cfg.build_settings(cfg.load_de_settings())
    tk = _install_fake_tk(monkeypatch)

    def no_display():
        raise tk.TclError("no display name and no $DISPLAY environment variable")

    tk.Tk = no_display
    sys.modules.pop("noaa_apt_tpu_torch.gui.app", None)
    try:
        with pytest.raises(err.FeatureNotAvailableError, match="Could not open a display"):
            gui.main(False, settings, CPU)
    finally:
        sys.modules.pop("noaa_apt_tpu_torch.gui.app", None)
    monkeypatch.setitem(sys.modules, "tkinter", None)  # import tkinter -> ImportError
    with pytest.raises(err.FeatureNotAvailableError, match="GUI not available"):
        gui.main(False, settings, CPU)


def test_app_runs_the_update_check_when_asked(tmp_path, monkeypatch):
    """``App(check_updates=True)`` starts the update check with the
    port's version; its result comes back through the idle pump."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    _install_fake_tk(monkeypatch)
    sys.modules.pop("noaa_apt_tpu_torch.gui.app", None)
    app_mod = importlib.import_module("noaa_apt_tpu_torch.gui.app")
    from noaa_apt_tpu_torch import __version__
    from noaa_apt_tpu_torch.io import config as cfg
    from noaa_apt_tpu_torch.io import misc as io_misc

    asked = []
    monkeypatch.setattr(io_misc, "check_updates", lambda v: asked.append(v) or (True, "9.9.9"))
    try:
        app = app_mod.App(check_updates=True, settings=cfg.build_settings(cfg.load_de_settings()),
                          device=CPU)
        for t in threading.enumerate():
            if t.daemon and t is not threading.current_thread():
                t.join(timeout=10)
        app._pump()
        from noaa_apt_tpu_torch.gui.state import borrow_widgets

        assert asked == [__version__]
        assert borrow_widgets().info.text == 'Version "9.9.9" available for download!'
    finally:
        sys.modules.pop("noaa_apt_tpu_torch.gui.app", None)

