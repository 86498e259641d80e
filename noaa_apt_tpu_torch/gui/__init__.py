"""Graphical interface (reference ``src/gui/``), rebuilt on tkinter.

Layering mirrors the reference: ``state`` (global GuiState + widget
registry, state.rs), ``work`` (threaded decode/process/resample/save
actions, work.rs), ``misc`` (progress/info-bar/update-check/preview
helpers, gui/misc.rs), ``app`` (the toolkit shell, gui.rs+main.glade).
The first three are toolkit-free and run headless — the test suite
drives the complete GUI logic without a display.

A copy of ``noaa_apt_tpu/gui/`` on the port: its decodes run the port's
kernels on the device that :func:`main` is given.
"""

from __future__ import annotations

from .. import err


def main(check_updates: bool, settings, device) -> None:
    """Start the GUI on ``device`` (a ``torch.device``: the card, or the
    CPU where the caller asked for it) (reference ``gui::main``,
    gui/mod.rs:6 + gui.rs:48-60)."""
    try:
        import tkinter
    except ImportError as e:  # tkinter missing entirely
        raise err.FeatureNotAvailableError(f"GUI not available: {e}")

    from .app import App

    try:
        app = App(check_updates, settings, device)
    except tkinter.TclError as e:
        # The no-display signal; real programming errors propagate
        # with their tracebacks instead of masquerading as this.
        raise err.FeatureNotAvailableError(
            f"Could not open a display for the GUI ({e}); pass an input "
            "file to decode headless, or run under a desktop session."
        )
    app.run()
