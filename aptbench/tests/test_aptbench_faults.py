"""A whole run on the CPU (the harness's look for a card skipped, the
program on its plain PyTorch path), sound and with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can
have.  The cells run on one card, so no exchange between cards can be
left out."""

import numpy as np
import pytest
import torch

from aptbench import harness, spec

ROOT = spec.HERE.parent
SEED = 2**31 + 77


def run(cell: str) -> dict:
    return harness.run_cell(ROOT, cell, SEED, 1.0, False, device="cpu", min_calls=2)


def altered_pixel(monkeypatch):
    """An answer altered where it is produced: one pixel of the u8 map."""
    from noaa_apt_tpu_torch.graph import decode

    orig = decode._map_u8

    def bad(img, low, high):
        out = orig(img, low, high).clone()
        out[out.shape[0] // 2, 500] ^= 0x80  # 128 levels off
        return out

    monkeypatch.setattr(decode, "_map_u8", bad)


def levels_off(monkeypatch):
    """The u8 map off by 8 levels on every pixel: a fault of the levels or
    the map that a loose ``px_gap`` limit would let through."""
    from noaa_apt_tpu_torch.graph import decode

    orig = decode._map_u8
    monkeypatch.setattr(decode, "_map_u8", lambda img, low, high: (orig(img, low, high).int() + 8).clamp(0, 255)
                        .to(torch.uint8))


def rows_misplaced(monkeypatch):
    """The sync walk off on one row in twenty: each such row is cut a
    third of a row late, so ``rows_off_pct`` has to see it."""
    from noaa_apt_tpu_torch.graph import decode

    orig = decode.Decoder._image

    def bad(self, filt, pos):
        pos = pos.clone()
        pos[: max(0, len(pos) - 2) : 20] += self.samples_per_work_row // 3
        return orig(self, filt, pos)

    monkeypatch.setattr(decode.Decoder, "_image", bad)


def half_the_rows(monkeypatch):
    """Half of a pass's rows left out."""
    from noaa_apt_tpu_torch.graph import decode

    orig = decode.Decoder._image
    monkeypatch.setattr(decode.Decoder, "_image", lambda self, filt, pos: orig(self, filt, pos[: len(pos) // 2]))


def half_the_passes(monkeypatch):
    """Half of a directory's passes left out."""
    from noaa_apt_tpu_torch import cli

    orig = cli.decode_fleet
    monkeypatch.setattr(cli, "decode_fleet", lambda paths, *a, **k: orig(list(paths)[::2], *a, **k))


def stale_walk(monkeypatch):
    """A step that returns its state unchanged: the sync walk keeps the
    positions it starts from, one row apart, whatever the correlation."""
    from noaa_apt_tpu_torch.graph import decode

    def stale(corr, n_valid, spr, md, max_peaks, to_host=False):
        lists = [list(range(0, int(n) - 1, spr))[:max_peaks] for n in n_valid]
        peaks = torch.zeros((len(lists), max_peaks), dtype=torch.int32)
        for b, lst in enumerate(lists):
            peaks[b, : len(lst)] = torch.tensor(lst, dtype=torch.int32)
        return (peaks, lists) if to_host else (peaks, torch.tensor([len(x) for x in lists]))

    monkeypatch.setattr(decode, "select_peaks", stale)


@pytest.mark.parametrize("cell", ["sdr48k_std.single", "sdr48k_std.fleet"])
def test_sound_run_is_correct(cell, tiny_traffic, cli_home):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and r["checks"]["px_gap"]["value"] <= 1
    e2e = {m["name"] for m in spec.Spec(ROOT).metrics_for(cell, "end_to_end")}
    assert set(r["metrics"]) == e2e


@pytest.mark.parametrize("cell,fault", [
    ("sdr48k_std.single", altered_pixel), ("sdr48k_std.single", half_the_rows),
    ("sdr48k_std.single", stale_walk), ("sdr48k_std.single", levels_off),
    ("sdr48k_std.single", rows_misplaced), ("sdr48k_std.fleet", altered_pixel),
    ("sdr48k_std.fleet", half_the_passes), ("sdr48k_std.fleet", stale_walk),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(cell, fault, tiny_traffic, cli_home, monkeypatch):
    fault(monkeypatch)
    r = run(cell)
    assert not r["correct"]
    over = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert over, r["checks"]


def test_no_card_is_refused(monkeypatch, cli_home):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.Refused):
        harness.run_cell(ROOT, "sdr48k_std.single", SEED, 1.0, False, device="cuda")


def test_forbidden_import_is_refused(monkeypatch, tiny_traffic, cli_home):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.Refused, match="jax"):
        run("sdr48k_std.single")


def test_control_fails_the_limits(tiny_traffic, tmp_path):
    """The bfloat16 reference in the program's place, at a test's size."""
    from aptbench import control

    got = control.control(ROOT, "sdr48k_std.fleet", SEED, "cpu", tmp_path)
    assert got["correct"] is False
    checks = got["checks"]
    assert checks["px_gap"]["value"] > checks["px_gap"]["limit"]
    assert checks["rows_off_pct"]["value"] > checks["rows_off_pct"]["limit"]
    assert np.isfinite(checks["rows_off_pct"]["value"])
