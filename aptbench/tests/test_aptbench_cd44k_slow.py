"""The 44.1 kHz slow-profile cell, ``cd44k_slow.single``: the plain
reference holds at its shape (tables bit for bit the program's, a short
pass decoded as the program's CPU path decodes it, the bfloat16 control
far off), the table-build reader reads the program's spans and nothing
without them, and a whole run on the CPU comes out correct."""

import pytest
import torch

from aptbench import harness, spec, trace
from aptbench.gen import synth
from aptbench.reference import decode as ref_decode
from aptbench.reference import dsp
from aptbench.reference.judge import judge

ROOT = spec.HERE.parent
CELL = "cd44k_slow.single"
CONFIG = spec.Spec(ROOT).config("cd44k_slow")
RATE = CONFIG["sample_rate"]
PROFILE = CONFIG["profile"]
MS = 1_000_000  # ns


def port_slow():
    from noaa_apt_tpu_torch.core.profiles import SLOW

    return SLOW


def test_config_states_the_slow_profile_and_its_k1_shape():
    slow = port_slow()
    assert (RATE, CONFIG["channels"], CONFIG["sample_format"]) == (44100, 1, "int16")
    assert {k: PROFILE[k] for k in ("work_rate", "resample_atten", "resample_delta_freq", "resample_cutout",
                                    "demodulation_atten")} == {
        "work_rate": slow.work_rate, "resample_atten": slow.resample_atten,
        "resample_delta_freq": slow.resample_delta_freq, "resample_cutout": slow.resample_cutout,
        "demodulation_atten": slow.demodulation_atten}
    t = dsp.design(PROFILE, RATE)
    assert (t.l, t.m, t.bank()[2].shape[1]) == (CONFIG["k1"]["l"], CONFIG["k1"]["m"],
                                                 CONFIG["k1"]["taps_per_phase"])
    assert CONFIG["upload_bytes_per_10_min"] == 2 * RATE * 600


def test_tables_equal_the_ports_bit_for_bit():
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.graph.decode import DecodeTables

    t, p = dsp.design(PROFILE, RATE), DecodeTables.design(port_slow(), Rate(RATE))
    assert (t.l, t.m, t.offset) == (p.l, p.m, p.offset) == (208, 441, p.offset)
    p_c, s_c, bank = t.bank()
    for got, want in ((bank, p.bank), (t.taps, p.taps), (t.template, p.template)):  # the same bytes
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    assert (p_c == p.p_c).all() and (s_c == p.s_c).all() and p_c.shape == p.p_c.shape == (208,)
    assert (t.cosphi2, t.sinphi) == (p.cosphi2, p.sinphi)
    assert t.work_len(37_044_000) == p.work_len(37_044_000)


def test_reference_agrees_with_the_port_on_cpu():
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.graph.decode import Decoder

    x = synth.make_pass(2**33 + 441, 20.0, RATE, 10.0, 30.0, "cpu").numpy()
    gray, sync = Decoder(port_slow(), device="cpu").decode_render_input(x, len(x), Rate(RATE), "percent", 0.98)
    ref = ref_decode.decode(x, RATE, PROFILE, 0.98)
    assert sync == ref.peaks
    got = judge(gray, ref)
    assert got["px_gap"] <= 1 and got["rows_off"] == 0 and got["rows"] == gray.shape[0] > 30


def test_control_in_bfloat16_is_far_off():
    x = synth.make_pass(441, 20.0, RATE, 10.0, 30.0, "cpu").numpy()
    ref = ref_decode.decode(x, RATE, PROFILE, 0.98)
    low = ref_decode.decode(x, RATE, PROFILE, 0.98, dtype=torch.bfloat16)
    got = judge(low.u8.numpy(), ref)
    assert got["px_gap"] > 50 and got["rows_off"] > 0.5 * got["rows"]


def ctx_of(host, n_passes):
    return harness.Context([{"ok": True}] * n_passes, 0.1, 0.0, trace=trace.Trace(0, 100 * MS, host=host))


def test_tables_ms_sums_both_builds_per_pass():
    host = [("pass", 0, 10 * MS), ("pass", 10 * MS, 30 * MS), ("pass", 30 * MS, 40 * MS),
            ("apt.tables", 1 * MS, 2 * MS), ("apt.k1.table", 3 * MS, 6 * MS),  # pass 0: 4 ms
            ("apt.tables", 11 * MS, 12 * MS), ("apt.k1.table", 13 * MS, 14 * MS),  # pass 1: 2 ms
            ("apt.tables", 31 * MS, 32 * MS), ("apt.png.deflate", 33 * MS, 39 * MS),  # pass 2: 1 ms
            ("apt.k1.table", 50 * MS, 60 * MS)]  # after the last call: no call's
    assert spec.Spec.reader("tables_ms." + CELL).read(ctx_of(host, 3)) == pytest.approx(2.0)


def test_tables_ms_none_without_the_spans():
    """A program without the table spans (the parent) reads nothing, even
    where its other ``apt.*`` spans are there, and an untraced run too."""
    reader = spec.Spec.reader("tables_ms." + CELL)
    host = [("pass", 0, 10 * MS), ("apt.decode", 1 * MS, 9 * MS), ("apt.png.deflate", 2 * MS, 3 * MS)]
    assert reader.read(ctx_of(host, 1)) is None
    assert reader.read(harness.Context([{"ok": True}], 1.0, 0.0)) is None


@pytest.mark.parametrize("name", ["polyphase_resample_roofline.single", "kernels_roofline.single"])
def test_rooflines_none_without_a_device_trace(name):
    """The cell reads K1's roofline (whichever variant implements it, "class"
    here) and K1-K3's with the 48 kHz cell's readers, which take the
    geometry from the cell's configuration."""
    assert CELL in {m["name"]: m for m in spec.Spec(ROOT).bench["per_layer"]}[name]["workloads"]
    reader = spec.Spec.reader(name)
    assert reader.read(harness.Context([{"ok": True}], 1.0, 0.0)) is None
    assert reader.read(ctx_of([("pass", 0, 10 * MS)], 1)) is None


def test_geometry_counts_k1_class_at_its_shape():
    g = harness.geometry(CONFIG, RATE * 600, 1200)
    assert (g["l"], g["m"], g["in_bytes"]) == (208, 441, 2)
    assert 196 < g["taps_per_output"] < 197 and g["spr"] == 10400
    assert 20800 * 600 - 100 < g["n_work"] <= 20800 * 600  # less the filter's delay


def test_whole_run_on_cpu_is_correct(tiny_traffic, cli_home):
    result = harness.run_cell(ROOT, CELL, 2**32 + 4410, 1.0, True, device="cpu", min_calls=2)
    assert result["correct"], result["checks"]
    assert result["checks"]["px_gap"]["value"] <= 1 and result["checks"]["rows_off_pct"]["value"] == 0.0
    # The CPU path builds the decoder's tables once a call; K1's table is the card's alone.
    assert result["metrics"]["tables_ms." + CELL]["value"] > 0
    assert "polyphase_resample_roofline.single" not in result["metrics"]  # no device trace here
    # The 48 kHz single cell's program readers read this cell too: save, load, upload, decode, WAV spans.
    assert {"save_ms.single", "deflate_ms.single", "png_write_ms.single", "png_bytes_per_row.single",
            "load_ms.single", "wav_read_ms.single_wavfmt", "wav_convert_ms.single_wavfmt", "upload_ms.single",
            "upload_copy_ms.single", "upload_h2d_ms.single", "decode_rest_ms.single",
            "device_wait_ms.single"} <= set(result["metrics"])
