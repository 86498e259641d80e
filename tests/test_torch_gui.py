"""The port's GUI logic layer (``noaa_apt_tpu_torch.gui``) against the JAX
package's (``noaa_apt_tpu.gui``), headless, on the CPU.

Both GUIs are driven from the same widget values (in-memory ``Widgets``,
inline ``idle_add``) on the same seeded synthesized recording; the port's
``GuiState`` carries ``device="cpu"``.  Each action's outcome is compared:

- sync positions: equal;
- processed RGBA images and the saved PNG's pixels: u8 equal except +-1
  on at most 0.1% of values (the port's rule for u8 images);
- the step decode's flat signal: within 6.0e-7 of its peak;
- the resample tool's WAV: equal rate, length and mtime, int16 samples
  within one LSB (the tool's tolerance, ``tests/test_torch_resample_tool.py``);
- every error surface: the same ``info.kind`` and ``info.text``;
- ``scale_preview``: byte-equal to the JAX GUI's (Pillow's bilinear
  resize) on seeded RGBA, opaque and with varied alpha.
"""

import io
import threading
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from noaa_apt_tpu.geo import states as jstates
from noaa_apt_tpu.gui import misc as jmisc
from noaa_apt_tpu.gui import state as jstate
from noaa_apt_tpu.gui import work as jwork
from noaa_apt_tpu.io import config as jcfg
from noaa_apt_tpu.io import misc as jio_misc
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.synth import synth_recording

from noaa_apt_tpu_torch.geo import states
from noaa_apt_tpu_torch.graph.decode import DecodeResult
from noaa_apt_tpu_torch.gui import misc as pmisc
from noaa_apt_tpu_torch.gui import state as pstate
from noaa_apt_tpu_torch.gui import work as pwork
from noaa_apt_tpu_torch.io import config as pcfg
from noaa_apt_tpu_torch.io import misc as pio_misc
from noaa_apt_tpu_torch.io import png, wav
from noaa_apt_tpu_torch.ops import resample as rs
from noaa_apt_tpu_torch.ops import select as sel
from noaa_apt_tpu_torch.ops import stage as st

torch.set_num_threads(1)

# The pinned Jan-2020 TLE of the JAX package's tests (geo.rs:206-214) and
# a start time over Bolivia (tests/test_map.py's overlay ink test).
TEST_TLE = """NOAA 15
1 25338U 98030A   20028.53684332  .00000010  00000-0  22730-4 0  9996
2 25338  98.7308  54.2052 0009655 316.5487  43.4931 14.25949056128892
NOAA 18
1 28654U 05018A   20028.55430359  .00000064  00000-0  59410-4 0  9998
2 28654  99.0657  83.5290 0013366 267.3059  92.6583 14.12484618757024
NOAA 19
1 33591U 09005A   20028.54874297  .00000001  00000-0  25623-4 0  9996
2 33591  99.1936  30.2411 0014855 109.6767 250.6008 14.12393428565240"""
START = datetime(2020, 1, 26, 9, 23, 20, tzinfo=timezone.utc)
PALETTE = Path(__file__).resolve().parent.parent / "noaa_apt_tpu_torch" / "res" / "palettes" / "WXtoImg-class.png"


def _join(t):
    assert t is not None
    t.join(timeout=300)
    assert not t.is_alive()


def _u8_close(got: np.ndarray, want: np.ndarray) -> None:
    """+-1 on at most 0.1% of values."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1e-3 * d.size


class Side:
    """One package's GUI logic layer: its modules, widgets and state."""

    def __init__(self, work, misc, state_mod, settings, **state_kw):
        self.work, self.misc, self.state_mod = work, misc, state_mod
        self.widgets = state_mod.Widgets()
        self.state = state_mod.GuiState(settings=settings, **state_kw)
        self.progress: list = []
        self.widgets.progress.bind(lambda f, d: self.progress.append(d))

    def activate(self):
        """Point the package's registry at this side's widgets and state."""
        self.state_mod.set_widgets(self.widgets)
        self.state_mod.set_state(self.state)
        self.work._auto_update_pending = False
        return self


class Guis:
    """Both GUIs, driven from the same widget values."""

    def __init__(self, j: Side, p: Side):
        self.j, self.p = j, p

    def __iter__(self):
        return iter((self.j, self.p))

    def set(self, name: str, value) -> None:
        for side in self:
            getattr(side.widgets, name).set(value)

    def act(self, action: str):
        """Run ``work.<action>`` on both sides (joining worker threads)
        and return ``(jax_result, port_result)``."""
        out = []
        for side in self:
            side.activate()
            r = getattr(side.work, action)()
            if isinstance(r, threading.Thread):
                _join(r)
            out.append(r)
        return out

    def info(self):
        return [(s.widgets.info.revealed, s.widgets.info.kind, s.widgets.info.text) for s in self]

    def assert_same_info(self) -> None:
        j, p = self.info()
        assert j == p

    def set_time(self, t: datetime) -> None:
        local = t.astimezone()
        self.set("p_calendar", (local.year, local.month, local.day))
        self.set("p_hs_spinner", local.hour)
        self.set("p_min_spinner", local.minute)
        self.set("p_sec_spinner", local.second)


def _write_rec(path: Path, n_rows: int, rate: int, seed: int = 0) -> None:
    sig, _ = synth_recording(n_rows=n_rows, sample_rate=rate, noise_db=20.0, seed=seed)
    wav.write_wav(path, sig, wav.WavSpec(1, rate, 16, "int"))


@pytest.fixture()
def guis(tmp_path, monkeypatch):
    """Both headless GUIs: in-memory widgets, inline idle_add, default
    settings, the same small synthesized recording, and the states layer
    skipped in both packages without a download."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jstates, "_download_failed", [True])
    monkeypatch.setattr(states, "_download_failed", [True])
    _write_rec(tmp_path / "rec.wav", 20, 11025)
    j = Side(jwork, jmisc, jstate, jcfg.build_settings(jcfg.load_de_settings()))
    p = Side(pwork, pmisc, pstate, pcfg.build_settings(pcfg.load_de_settings()),
             device=torch.device("cpu"))
    g = Guis(j, p)
    g.set("dec_input_chooser", str(tmp_path / "rec.wav"))
    return g


@pytest.fixture()
def kernel_calls(monkeypatch):
    """Calls of K1, K2 and K3's plain twins (what each wrapper runs for a
    CPU tensor), counted by name."""
    calls = {"polyphase_resample": 0, "demod_fir_corr": 0, "select_peaks": 0}
    for mod, name in ((rs, "polyphase_resample"), (st, "demod_fir_corr"), (sel, "select_peaks")):
        plain = getattr(mod, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(mod, f"{name}_plain", counted)
    return calls


def _pin_tle(g: Guis, tmp: Path) -> None:
    (tmp / "tle.txt").write_text(TEST_TLE)
    g.set("p_custom_tle_check", True)
    g.set("p_custom_tle_chooser", str(tmp / "tle.txt"))


def test_decode_process_save_workflow(guis, tmp_path):
    """Decode -> Process (orbit rotation, pinned TLE) -> Save on both:
    equal sync positions, the same progress texts and prefill, images and
    saved pixels by the u8 rule."""
    g = guis
    _pin_tle(g, tmp_path)
    g.act("decode")
    j, p = g.j, g.p
    assert isinstance(p.state.decoded_signal, DecodeResult)
    assert p.state.decoded_signal.sync_positions == j.state.decoded_signal.sync_positions
    assert p.state.decoded_signal.image.device == torch.device("cpu")
    for side in g:
        assert side.widgets.progress.description == "Decoded"
        assert side.widgets.dec_decode_button.sensitive and side.widgets.p_process_button.sensitive
    assert p.progress == j.progress
    for name in ("p_satellite_combo", "p_ref_time_combo", "p_calendar", "p_hs_spinner",
                 "p_min_spinner", "p_sec_spinner"):
        assert getattr(p.widgets, name).get() == getattr(j.widgets, name).get(), name
    assert p.widgets.p_ref_time_combo.get() == "end"

    g.act("process")
    assert p.progress == j.progress
    _u8_close(p.state.processed_image, j.state.processed_image)
    assert p.widgets.progress.description == "Processed" and p.widgets.sav_save_button.sensitive
    np.testing.assert_array_equal(p.widgets.image.preview,
                                  jmisc.scale_preview(p.state.processed_image, (900, 600), False))
    assert p.widgets.image.preview.shape[1] <= 900

    g.j.widgets.sav_output_entry.set(str(tmp_path / "jax.png"))
    g.p.widgets.sav_output_entry.set(str(tmp_path / "port.png"))
    g.act("save")
    assert [s.widgets.progress.description for s in g] == ["Saved", "Saved"]
    got = png.read_png(tmp_path / "port.png")
    np.testing.assert_array_equal(got, p.state.processed_image)
    _u8_close(got, np.asarray(Image.open(tmp_path / "jax.png")))


CASES = {
    "98_percent": dict(p_contrast_combo="98_percent", p_rotate_combo="no"),
    "minmax_rotated": dict(p_contrast_combo="minmax", p_rotate_combo="yes"),
    "histogram": dict(p_contrast_combo="histogram", p_rotate_combo="no"),
    "false_color": dict(p_contrast_combo="98_percent", p_rotate_combo="no", p_false_color_check=True,
                        p_palette_chooser=str(PALETTE), p_channel_a_start_scale=0.1,
                        p_channel_b_end_scale=-0.2),
    "histogram_false_color": dict(p_contrast_combo="histogram", p_rotate_combo="no",
                                  p_false_color_check=True, p_palette_chooser=str(PALETTE)),
    "overlay_auto_rotate": dict(p_contrast_combo="98_percent", p_rotate_combo="auto",
                                p_overlay_check=True, p_satellite_combo="noaa_19",
                                p_ref_time_combo="start", p_yaw_spinner=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_options_match_jax(guis, tmp_path, case):
    """Each contrast, rotation, false colour and the map overlay with the
    pinned TLE: the processed RGBA images agree by the u8 rule, with the
    same progress texts."""
    g = guis
    _pin_tle(g, tmp_path)
    g.act("decode")
    for name, value in CASES[case].items():
        g.set(name, value)
    if case.startswith("overlay"):
        g.set_time(START)
    g.act("process")
    g.assert_same_info()
    assert [s.widgets.progress.description for s in g] == ["Processed", "Processed"]
    assert g.p.progress == g.j.progress
    _u8_close(g.p.state.processed_image, g.j.state.processed_image)
    if case.startswith("overlay"):
        img = g.p.state.processed_image
        assert (np.abs(img[..., 0].astype(np.int16) - img[..., 2]) > 10).sum() > 100  # map ink


def test_telemetry_contrast_matches_jax(tmp_path, monkeypatch):
    """Telemetry contrast on a 230-row recording (a frame needs 200 rows):
    equal sync positions, images by the u8 rule."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.chdir(tmp_path)
    _write_rec(tmp_path / "long.wav", 230, 11025, seed=9)
    g = Guis(Side(jwork, jmisc, jstate, jcfg.build_settings(jcfg.load_de_settings())),
             Side(pwork, pmisc, pstate, pcfg.build_settings(pcfg.load_de_settings()), device="cpu"))
    g.set("dec_input_chooser", str(tmp_path / "long.wav"))
    g.act("decode")
    assert g.p.state.decoded_signal.sync_positions == g.j.state.decoded_signal.sync_positions
    g.set("p_contrast_combo", "telemetry")
    g.set("p_rotate_combo", "no")
    g.act("process")
    g.assert_same_info()
    assert g.p.progress == g.j.progress
    _u8_close(g.p.state.processed_image, g.j.state.processed_image)


def test_decode_once_process_many(guis, kernel_calls):
    """The decode result is cached; process() re-runs without DSP
    (state.rs:118-122 design): no K1, K2 or K3 call per Process, and
    knob changes still change the image."""
    g = guis
    g.set("p_rotate_combo", "no")
    g.act("decode")
    assert kernel_calls == {"polyphase_resample": 1, "demod_fir_corr": 1, "select_peaks": 1}
    cached = g.p.state.decoded_signal
    g.act("process")
    first = g.p.state.processed_image
    g.set("p_contrast_combo", "minmax")
    g.act("process")
    assert kernel_calls == {"polyphase_resample": 1, "demod_fir_corr": 1, "select_peaks": 1}
    assert g.p.state.decoded_signal is cached
    assert not np.array_equal(g.p.state.processed_image, first)
    _u8_close(g.p.state.processed_image, g.j.state.processed_image)


def test_decoder_cache_survives_redecodes(guis):
    """The live Decoder is reused across decodes of its profile and
    device, kept through failed ones, and replaced for another profile."""
    g = guis
    g.act("decode")
    dec1 = g.p.state.decoder
    assert dec1 is not None and dec1.device == torch.device("cpu")
    g.act("decode")
    assert g.p.state.decoder is dec1
    g.set("dec_input_chooser", "missing.wav")
    g.act("decode")
    assert g.p.widgets.info.kind == "error"
    assert g.p.state.decoder is dec1
    g.p.state.settings = pcfg.build_settings(pcfg.load_de_settings(), "slow")
    g.p.widgets.dec_input_chooser.set("rec.wav")
    g.p.activate()
    _join(pwork.decode())
    assert g.p.state.decoder is not dec1
    assert g.p.state.decoder.profile == g.p.state.settings.profile() != dec1.profile


def test_decode_on_the_card_never_falls_back(guis):
    """A GUI opened on the card (``device`` None or ``cuda``) on a machine
    without CUDA fails its decode into the info bar; nothing decodes on
    the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA refusal cannot be shown here")
    for device in (None, torch.device("cuda")):
        g = guis
        g.p.state.device = device
        g.p.activate()
        _join(pwork.decode())
        assert g.p.widgets.info.kind == "error" and "CUDA is not available" in g.p.widgets.info.text
        assert g.p.state.decoded_signal is None and g.p.state.decoder is None


def test_decode_no_input_error(guis):
    g = guis
    g.set("dec_input_chooser", None)
    assert g.act("decode") == [None, None]
    g.assert_same_info()
    assert g.p.widgets.info.kind == "error" and "Select input file" in g.p.widgets.info.text
    assert g.p.widgets.dec_decode_button.sensitive  # re-enabled by callback


def test_process_without_decode_error(guis):
    g = guis
    assert g.act("process") == [None, None]
    g.assert_same_info()
    assert "No decoded image?" in g.p.widgets.info.text


def test_process_marshalling_errors(guis):
    """Each marshalling error of the Process tab, in the JAX GUI's words."""
    g = guis
    for side in g:
        side.state.decoded_signal = np.zeros(2080 * 12, np.float32)
    steps = [
        ("p_contrast_combo", "bogus", 'Unknown contrast adjustment "bogus"'),
        ("p_contrast_combo", None, "Select contrast adjustment"),
        ("p_contrast_combo", "98_percent", None),
        ("p_rotate_combo", "sideways", 'Unknown rotation "sideways"'),
        ("p_rotate_combo", "no", None),
        ("p_false_color_check", True, "Select palette file"),
        ("p_palette_chooser", str(PALETTE), None),
        ("p_channel_a_start_scale", "x", "Invalid false color setting"),
        ("p_false_color_check", False, None),
        ("p_satellite_combo", "noaa_7", 'Unknown satellite "noaa_7"'),
        ("p_satellite_combo", "noaa_19", None),
        ("p_custom_tle_check", True, "Select custom TLE input file"),
        ("p_custom_tle_chooser", "missing_tle.txt", "Could not open custom TLE file"),
        ("p_custom_tle_check", False, None),
        ("p_calendar", (2021, 2, 31), "Invalid date or time"),
        ("p_calendar", (2021, 2, 3), None),
        ("p_ref_time_combo", "middle", "Select if provided time is recording start or end"),
    ]
    for name, value, text in steps:
        g.set(name, value)
        if text is None:
            continue
        assert g.act("process") == [None, None], name
        g.assert_same_info()
        assert g.p.widgets.info.kind == "error" and text in g.p.widgets.info.text, name


def test_save_without_filename_or_image(guis, tmp_path):
    """Save's guards, and a failing write shown with Info severity (the
    reference's quirk) in both."""
    g = guis
    g.act("save")
    g.assert_same_info()
    assert "Select output filename" in g.p.widgets.info.text
    g.set("sav_output_entry", "x.png")
    g.act("save")
    g.assert_same_info()
    assert "No processed image to save?" in g.p.widgets.info.text
    for side in g:
        side.state.processed_image = np.zeros((3, 2080, 4), np.uint8)
    g.set("sav_output_entry", str(tmp_path / "no_such_dir" / "x.png"))
    g.act("save")
    kinds = [(s.widgets.info.kind, s.widgets.progress.description) for s in g]
    assert kinds == [("info", "Error"), ("info", "Error")]
    for side in g:
        assert side.widgets.info.text.startswith("Error saving image: ")
        assert "No such file or directory" in side.widgets.info.text


def test_auto_update_triggers_process(guis):
    """Every Process-tab knob re-runs process() when auto-update is on
    (gui.rs:360-410 + work.rs:205-213)."""
    g = guis
    assert pstate.AUTO_UPDATE_WIDGETS == jstate.AUTO_UPDATE_WIDGETS
    assert pstate.widget_names() == jstate.widget_names()
    counts = []
    for side in g:
        calls = []
        pstate.wire_auto_update(side.widgets, lambda c=calls: c.append(1))
        counts.append(calls)
    g.set("p_rotate_combo", "yes")
    g.set("p_yaw_spinner", 1.0)
    g.set("p_calendar", (2020, 5, 5))
    g.set("dec_sync_check", False)  # dec-tab widgets must NOT trigger
    assert [len(c) for c in counts] == [3, 3]

    assert g.act("process_if_auto_update_enabled") == [None, None]  # gated on the checkbox
    g.set("p_auto_update_check", True)
    assert g.act("process_if_auto_update_enabled") == [None, None]  # errors via info bar
    g.assert_same_info()
    assert "No decoded image?" in g.p.widgets.info.text


def test_auto_update_gates_on_inflight_process(guis, monkeypatch):
    """Changes during an in-flight process don't spawn concurrent
    workers; the trailing change re-runs once on completion, and the
    number of process runs equals the JAX GUI's."""
    g = guis
    runs = []
    for side in g:
        side.state.decoded_signal = np.zeros(2080 * 12, np.float32)
        side.widgets.p_rotate_combo.set("no")
        side.widgets.p_auto_update_check.set(True)
        side.activate()
        n = [0]
        real = side.work.process

        def counting(real=real, n=n):
            n[0] += 1
            return real()

        monkeypatch.setattr(side.work, "process", counting)
        side.widgets.p_process_button.set_sensitive(False)  # in-flight
        assert side.work.process_if_auto_update_enabled() is None
        assert side.work.process_if_auto_update_enabled() is None
        assert side.work._auto_update_pending
        side.widgets.p_process_button.set_sensitive(True)
        side.work._rerun_if_auto_update_pending()
        assert not side.work._auto_update_pending
        for t in threading.enumerate():
            if t.daemon and t is not threading.current_thread():
                t.join(timeout=60)
        assert side.state.processed_image is not None
        runs.append(n[0])
    assert runs == [1, 1]
    np.testing.assert_array_equal(g.p.state.processed_image, g.j.state.processed_image)


def test_resample_guards(guis, tmp_path):
    g = guis
    g.set("res_input_chooser", str(tmp_path / "rec.wav"))
    g.set("res_output_entry", "")
    assert g.act("resample") == [None, None]
    g.assert_same_info()
    assert "Select output filename" in g.p.widgets.info.text
    assert g.p.widgets.res_resample_button.sensitive
    g.set("res_output_entry", "out.wav")
    g.set("res_rate_spinner", "fast")
    assert g.act("resample") == [None, None]
    g.assert_same_info()
    assert "Invalid sample rate" in g.p.widgets.info.text


@pytest.mark.parametrize("rate", [22050, 4160])
def test_resample_tool(guis, tmp_path, rate):
    """The Resample tool on both: "Finished", equal rate, length and
    mtime, the int16 samples within one LSB (the tool's tolerance)."""
    g = guis
    g.set("res_input_chooser", str(tmp_path / "rec.wav"))
    g.j.widgets.res_output_entry.set(str(tmp_path / "j.wav"))
    g.p.widgets.res_output_entry.set(str(tmp_path / "p.wav"))
    g.set("res_rate_spinner", rate)
    g.act("resample")
    assert [s.widgets.progress.description for s in g] == ["Finished", "Finished"]
    assert [d.replace("p.wav", "j.wav") for d in g.p.progress] == g.j.progress
    got, spec = wav.load_wav(tmp_path / "p.wav")
    want, jspec = jwav.load_wav(tmp_path / "j.wav")
    assert spec.sample_rate == jspec.sample_rate == rate and got.shape == want.shape
    assert spec.bits_per_sample == jspec.bits_per_sample == 16  # the input's format
    assert np.abs(got.astype(np.float64) - want).max() <= 1.0  # one LSB of int16
    assert (tmp_path / "p.wav").stat().st_mtime == (tmp_path / "j.wav").stat().st_mtime

    g.set("res_input_chooser", None)
    assert g.act("resample") == [None, None]
    g.assert_same_info()
    assert "Select input file" in g.p.widgets.info.text


def test_timestamp_tool_roundtrip(guis, tmp_path):
    """Write then read the file's mtime through both GUIs: equal mtimes,
    the same widgets read back, the same messages."""
    g = guis
    for name in ("j", "p"):
        (tmp_path / f"stamp_{name}.wav").write_bytes(b"RIFF")
    g.j.widgets.ts_write_chooser.set(str(tmp_path / "stamp_j.wav"))
    g.p.widgets.ts_write_chooser.set(str(tmp_path / "stamp_p.wav"))
    g.set("ts_calendar", (2020, 1, 26))
    g.set("ts_hs_spinner", 1)
    g.set("ts_min_spinner", 33)
    g.set("ts_sec_spinner", 20)
    g.act("write_timestamp")
    g.assert_same_info()
    assert "Timestamp written to file" in g.p.widgets.info.text
    assert (tmp_path / "stamp_p.wav").stat().st_mtime == (tmp_path / "stamp_j.wav").stat().st_mtime

    g.set("ts_calendar", (1999, 1, 1))
    g.j.widgets.ts_read_chooser.set(str(tmp_path / "stamp_j.wav"))
    g.p.widgets.ts_read_chooser.set(str(tmp_path / "stamp_p.wav"))
    g.act("read_timestamp")
    g.assert_same_info()
    assert "Loaded timestamp from file" in g.p.widgets.info.text
    for side in g:
        assert side.widgets.ts_calendar.get() == (2020, 1, 26)
        assert (side.widgets.ts_hs_spinner.get(), side.widgets.ts_min_spinner.get(),
                side.widgets.ts_sec_spinner.get()) == (1, 33, 20)

    for name, value in (("ts_read_chooser", str(tmp_path / "missing.wav")), ("ts_read_chooser", None)):
        g.set(name, value)
        g.act("read_timestamp")
        g.assert_same_info()
    g.set("ts_write_chooser", str(tmp_path / "no_dir" / "x.wav"))
    g.act("write_timestamp")
    g.assert_same_info()
    assert "Error writing timestamp" in g.p.widgets.info.text
    g.set("ts_write_chooser", None)
    g.act("write_timestamp")
    g.assert_same_info()
    assert "Select file to write" in g.p.widgets.info.text


def test_decode_prefills_time_from_filename(guis, tmp_path):
    """A gqrx-style filename infers start time + satellite
    (work.rs:46-126 prefill path), as in the JAX GUI."""
    g = guis
    named = tmp_path / "gqrx_20200126_013320_137100000.wav"
    named.write_bytes((tmp_path / "rec.wav").read_bytes())
    g.set("dec_input_chooser", str(named))
    g.act("decode")
    w = g.p.widgets
    assert w.p_ref_time_combo.get() == "start"
    assert w.p_satellite_combo.get() == "noaa_19"  # 137.1 MHz
    y, m, d = w.p_calendar.get()
    got_local = datetime(y, m, d, int(w.p_hs_spinner.get()), int(w.p_min_spinner.get()),
                         int(w.p_sec_spinner.get())).astimezone()
    assert got_local == datetime(2020, 1, 26, 1, 33, 20, tzinfo=timezone.utc)
    for name in ("p_ref_time_combo", "p_satellite_combo", "p_calendar", "p_hs_spinner"):
        assert getattr(w, name).get() == getattr(g.j.widgets, name).get()


def test_decode_with_steps_matches_jax(guis, tmp_path):
    """"WAV steps" on a 48 kHz recording: the flat signal within 6.0e-7
    of its peak of the JAX GUI's, and the same step files."""
    g = guis
    _write_rec(tmp_path / "rec48.wav", 14, 48000, seed=5)
    g.set("dec_input_chooser", str(tmp_path / "rec48.wav"))
    g.set("dec_wav_steps_check", True)
    for side, name in ((g.j, "j"), (g.p, "p")):
        d = tmp_path / f"steps_{name}"
        d.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            side.activate()
            _join(side.work.decode())
    assert [s.widgets.progress.description for s in g] == ["Decoded", "Decoded"]
    got, want = g.p.state.decoded_signal, np.asarray(g.j.state.decoded_signal)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert np.abs(got - want).max() <= 6.0e-7 * np.abs(want).max()
    assert g.p.state.decoder is None  # a step decode keeps no decoder, as in the JAX GUI
    assert sorted(p.name for p in (tmp_path / "steps_p").iterdir()) == \
        sorted(p.name for p in (tmp_path / "steps_j").iterdir())
    g.set("p_rotate_combo", "no")
    g.act("process")
    _u8_close(g.p.state.processed_image, g.j.state.processed_image)


def test_idle_add_marshals_to_gui_thread(guis):
    """Worker-thread callbacks go through idle_add (the glib::idle_add
    analog) — nothing runs them inline on the worker."""
    g = guis
    pending = []
    g.p.widgets.idle_add = pending.append  # queue, like the Tk pump
    g.p.activate()
    t = pwork.decode()
    t.join(timeout=300)
    assert pending and g.p.state.decoded_signal is None  # callback queued, not executed
    for fn in pending:
        fn()
    assert g.p.state.decoded_signal is not None


class _Reply(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _fake_urlopen(answer, seen):
    def urlopen(url, timeout=None):
        seen.append((url, timeout))
        if answer is None:
            raise OSError("offline")
        return _Reply(answer)

    return urlopen


@pytest.mark.parametrize("answer,want", [
    (b"9.9.9\n", (True, "9.9.9")),
    (b"0.1.0\n", (False, "0.1.0")),
    (b"0.1.0-beta\n", (False, "0.1.0-beta")),
    (None, None),
])
def test_check_updates_matches_jax(monkeypatch, answer, want):
    """``io/misc.check_updates`` under a fake ``urlopen``: newer, same,
    a pre-release and offline, the same URL, timeout and result as the
    JAX package's."""
    seen = []
    monkeypatch.setattr(urllib.request, "urlopen", _fake_urlopen(answer, seen))
    assert pio_misc.check_updates("0.1.0") == jio_misc.check_updates("0.1.0") == want
    assert seen[0] == seen[1] == ("https://noaa-apt.mbernardi.com.ar/version_check?0.1.0", 10)
    for v in ("1.5.0-beta", "1.5.0", "1.5.0-beta.2+b7", "2.0.0-rc.1"):
        assert pio_misc.parse_version(v) == jio_misc.parse_version(v)
    with pytest.raises(ValueError):
        pio_misc.parse_version("1.5")


@pytest.mark.parametrize("answer", [b"9.9.9\n", b"0.1.0\n", None])
def test_update_check_shows_info(guis, monkeypatch, answer):
    """``check_updates_and_show`` under a fake ``urlopen``: the same info
    bar as the JAX GUI (nothing for the latest version)."""
    g = guis
    monkeypatch.setattr(urllib.request, "urlopen", _fake_urlopen(answer, []))
    for side in g:
        side.activate()
        side.misc.check_updates_and_show("0.1.0").join(timeout=10)
    g.assert_same_info()
    text = {b"9.9.9\n": 'Version "9.9.9" available for download!', b"0.1.0\n": "",
            None: "Error checking for updates, do you have an internet connection?"}[answer]
    assert g.p.widgets.info.text == text


def test_output_tips(tmp_path, monkeypatch):
    """Save-entry tips (gui.rs:258-319) equal the JAX GUI's."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "out.png").write_bytes(b"x")
    for name in (None, "", "out.jpg", "out.png", str(tmp_path / "out.png"), str(tmp_path / "new")):
        assert pmisc.output_tips(name, ".png") == jmisc.output_tips(name, ".png")
    tips = pmisc.output_tips("out.jpg", ".png")
    assert tips == {"folder": str(tmp_path), "extension_warn": True, "overwrite_warn": False}


PREVIEW_CASES = [
    ((40, 2080, 4), (900, 600), "opaque"),
    ((40, 2080, 4), (613, 401), "varied"),
    ((230, 2080, 4), (900, 600), "varied"),
    ((230, 2080, 4), (1040, 100), "opaque"),
    ((230, 2080, 4), (77, 3000), "edges"),
    ((37, 2080, 4), (1, 1), "varied"),
    ((60, 2080), (500, 500), None),
    ((60, 2080, 3), (700, 20), None),
]


@pytest.mark.parametrize("shape,viewport,alpha", PREVIEW_CASES)
def test_scale_preview_byte_equal(shape, viewport, alpha):
    """The port's numpy bilinear downscale is byte-equal to the JAX GUI's
    Pillow resize: RGBA opaque, with varied alpha (premultiplied, then
    divided back) and with only alpha 0, 1, 128, 254 and 255; grey and
    RGB; several viewports."""
    rng = np.random.default_rng(sum(shape) + viewport[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if alpha == "opaque":
        img[..., 3] = 255
    elif alpha == "edges":
        img[..., 3] = rng.choice(np.array([0, 1, 128, 254, 255], np.uint8), shape[:2])
    got = pmisc.scale_preview(img, viewport, False)
    want = jmisc.scale_preview(img, viewport, False)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_scale_preview():
    img = np.zeros((100, 2080, 4), np.uint8)
    # Fit: downscale to viewport width
    out = pmisc.scale_preview(img, (1040, 600), normal_size=False)
    assert out.shape[1] == 1040 and out.shape[0] == 50
    # Normal size: untouched
    assert pmisc.scale_preview(img, (10, 10), normal_size=True) is img
    # Never upscale
    small = np.zeros((10, 20, 4), np.uint8)
    assert pmisc.scale_preview(small, (1000, 1000), normal_size=False) is small


def test_app_module_importable_headless():
    """The Tk shell must import (syntax/deps) without a display; only
    App() needs one."""
    import noaa_apt_tpu_torch.gui.app as app

    assert hasattr(app, "App") and hasattr(app, "warm_kernels")


def test_warm_kernels_builds_nothing_on_the_cpu(monkeypatch):
    """The warm-up thread builds through ``_build.library`` (under the
    build lock) only for the card."""
    from noaa_apt_tpu_torch.gui import app
    from noaa_apt_tpu_torch.ops import _build

    built = []
    monkeypatch.setattr(_build, "library", built.append)
    app.warm_kernels(torch.device("cpu"))
    app.warm_kernels(None)
    assert built == []
    app.warm_kernels(torch.device("cuda"))
    assert built == list(_build.SOURCES)


def test_process_invalid_map_spinner_reenables_buttons(guis):
    """Transient junk in a map spinbox (e.g. '-' mid-edit) must surface
    as an error and re-enable the buttons, not strand them disabled."""
    g = guis
    for side in g:
        side.state.decoded_signal = np.zeros(2080 * 12, np.float32)
    g.set("p_overlay_check", True)
    g.set("p_yaw_spinner", "-")
    assert g.act("process") == [None, None]
    g.assert_same_info()
    assert "Invalid map overlay setting" in g.p.widgets.info.text
    assert g.p.widgets.p_process_button.sensitive and g.p.widgets.dec_decode_button.sensitive


def test_flat_signal_process_matches_jax(guis):
    """A flat float signal in the state (as the step decode leaves) is
    processed on the host in both: equal images."""
    g = guis
    rng = np.random.default_rng(3)
    flat = rng.normal(size=2080 * 12).astype(np.float32)
    for side in g:
        side.state.decoded_signal = flat
    g.set("p_rotate_combo", "no")
    g.act("process")
    np.testing.assert_array_equal(g.p.state.processed_image, g.j.state.processed_image)
    assert g.p.progress == g.j.progress
