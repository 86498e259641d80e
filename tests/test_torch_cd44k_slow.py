"""The port at 44100 Hz on the slow profile (K1 "class", l 208, m 441, 197
taps a phase; K2 and K3 at 20800 Hz; rows decimated by 5), on the CPU.

The CLI with ``-p slow -c 98_percent`` gives the JAX package's sync
positions, rows and pixels.  Each CLI call builds its decoder's K1 and
K2 tables (span ``apt.tables``, once each) and, on the card, K1's class
table (span ``apt.k1.table``), all inside ``apt.decode``; a second decode
on the same decoder builds none.  The report names the K1 variant that the
decoder launched.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.graph import decode as jdecode
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.synth import synth_recording

from noaa_apt_tpu_torch import cli
from noaa_apt_tpu_torch.core.profiles import SLOW
from noaa_apt_tpu_torch.graph import decode
from noaa_apt_tpu_torch.graph.decode import Decoder
from noaa_apt_tpu_torch.io import png, wav
from noaa_apt_tpu_torch.ops import resample as rs

torch.set_num_threads(1)

RATE = 44100
ARGS = ["-q", "--device", "cpu", "-p", "slow", "-c", "98_percent"]
# The table builds of one decoder's first decode: K1's and K2's tables, K1's class table.
TABLES = ["apt.k1.table", "apt.tables", "apt.tables"]


@pytest.fixture(autouse=True)
def _own_settings_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def pass_wav(tmp_path_factory):
    """A 40-row pass at 44100 Hz as a 16-bit WAV."""
    signal, _ = synth_recording(n_rows=40, sample_rate=RATE, noise_db=20.0, seed=44)
    path = tmp_path_factory.mktemp("cd44k") / "20200126-0100-noaa-19.wav"
    wav.write_wav(path, signal, wav.WavSpec(1, RATE, 16, "int"))
    return path


@pytest.fixture
def card_table_lookup(monkeypatch):
    """The decoder's K1 call, preceded by the class-table lookup that the
    card's launch makes (``ops/resample._table``): the CPU's plain twin
    needs no table, so on the CPU this is the one way to reach it."""
    plain = decode.polyphase_resample

    def k1(x, bank, p_c, s_c, m, out_len, k0=0):
        assert bank.shape[0] > rs.K1_BLOCK_MAX_L  # the class variant's shape
        rs._table("class", bank, p_c, s_c)
        return plain(x, bank, p_c, s_c, m, out_len, k0)

    monkeypatch.setattr(decode, "polyphase_resample", k1)


def apt_events(prof) -> list:
    """``(name, start ns, end ns)`` of every ``apt.*`` host event, in start order."""
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("apt.")]
    return sorted(events, key=lambda e: e[1])


def test_cli_matches_jax_sync_rows_and_pixels(pass_wav):
    report: dict = {}
    assert cli.main([str(pass_wav), "-o", "slow.png", *ARGS], report=report) == 0
    jx, jrate = jwav.load_device_ready(pass_wav)
    jgray, jsync = jdecode.Decoder(JPROFILES["slow"]).decode_render_input(jx, len(jx), jrate)
    jgray = np.asarray(jgray)
    assert report["sync_positions"] == jsync
    assert report["rows"] == jgray.shape[0] > 30
    img = png.read_png("slow.png")
    assert img.shape == (*jgray.shape, 4) and (img[..., 3] == 255).all()
    assert (img[..., 1] == img[..., 0]).all() and (img[..., 2] == img[..., 0]).all()
    d = np.abs(img[..., 0].astype(np.int16) - jgray.astype(np.int16))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1e-3 * d.size


def test_report_names_the_k1_variant(pass_wav):
    report: dict = {}
    assert cli.main([str(pass_wav), "-o", "slow.png", "--raw-out", "raw.npy", *ARGS], report=report) == 0
    assert report["k1_variant"] == "plain"
    report = {}  # a .npy is re-processed with no decoder and no K1
    assert cli.main(["raw.npy", "-o", "npy.png", *ARGS], report=report) == 0
    assert report["k1_variant"] is None


@pytest.mark.parametrize("ingest, variant", [("device", "plain"), ("host16", None)])
def test_decoder_records_the_k1_variant_it_launched(pass_wav, ingest, variant):
    """Device ingest launches K1 (its plain twin on the CPU); host ingest
    resamples on the host and launches none."""
    report: dict = {}
    assert cli.main([str(pass_wav), "-o", "slow.png", "--ingest", ingest, *ARGS], report=report) == 0
    assert report["k1_variant"] == variant


def test_table_spans_on_every_call_inside_the_decode(pass_wav, card_table_lookup):
    for _ in range(2):  # each call makes a decoder of its own, so each builds anew
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert cli.main([str(pass_wav), "-o", "slow.png", *ARGS]) == 0
        events = apt_events(prof)
        (_, da, db), = [e for e in events if e[0] == "apt.decode"]
        tables = [e for e in events if e[0] in TABLES]
        assert sorted(name for name, _, _ in tables) == TABLES
        assert all(da <= a <= b <= db for _, a, b in tables)


def test_second_decode_on_the_same_decoder_builds_no_table(pass_wav, card_table_lookup):
    x, rate = wav.load_device_ready(pass_wav)
    dec = Decoder(SLOW, device="cpu")
    got = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got.append(dec.decode_render_input(x, len(x), rate, "percent", 0.98))
        got[-1] = (got[-1], [e[0] for e in apt_events(prof) if e[0] in TABLES])
    (first, built), (second, again) = got
    assert sorted(built) == TABLES and again == []
    assert np.array_equal(first[0], second[0]) and first[1] == second[1]
