"""The metric arithmetic: percentiles over all passes, the rate over the
window, unions and gaps of intervals, the roofline counts."""

import math
import statistics
from types import SimpleNamespace

import pytest

from aptbench import harness, spec, stats, trace


def test_percentile_nearest_rank_over_all_values():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile([1, 2, 3, float("inf")], 50) == 2
    assert math.isinf(stats.percentile([1, 2, 3, float("inf")], 90))


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.8)]
    assert stats.union_length(iv) == 4
    assert stats.merge(iv) == [(0, 3), (5, 6)]
    assert stats.gaps(iv, -1, 7) == [(-1, 0), (3, 5), (6, 7)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_pass_and_fleet_readers():
    passes = [{"ok": True, "wall_s": w / 1e3, "recorded_s": 600.0} for w in range(100, 200)]
    passes.append({"ok": False, "wall_s": 0.01, "recorded_s": 600.0})
    ctx = SimpleNamespace(passes=passes, window_s=20.0, setup_s=3.5)
    assert spec.Spec.reader("pass_ms_p50").read(ctx) == pytest.approx(150.0)
    assert spec.Spec.reader("pass_ms_p90").read(ctx) == pytest.approx(190.0)
    # the failed pass counts as over any limit, and gives no recorded seconds
    assert spec.Spec.reader("fleet_realtime_x").read(ctx) == pytest.approx(100 * 600.0 / 20.0)
    assert spec.Spec.reader("setup_s").read(ctx) == 3.5


@pytest.mark.parametrize("metric", ["png_bytes_per_row.single", "png_bytes_per_row.fleet"])
def test_png_bytes_per_row_reader(metric):
    passes = [{"ok": True, "png_bytes_per_row": b} for b in (900.0, 1000.0, 3000.0)]
    passes += [{"ok": False, "png_bytes_per_row": None}, {"ok": True, "png_bytes_per_row": None}]
    assert spec.Spec.reader(metric).read(harness.Context(passes, 1.0, 1.0)) == 1000.0
    assert spec.Spec.reader(metric).read(harness.Context([], 1.0, 1.0)) is None


def test_decide_holds_every_number_to_its_limit():
    limits = {"px_gap": 4, "rows_off_pct": 1.0, "passes_failed": 0}
    checks, correct = harness.decide({"px_gap": 4, "rows_off_pct": 1.0, "passes_failed": 0}, limits)
    assert correct and checks["px_gap"] == {"value": 4, "limit": 4}
    for over in ({"px_gap": 5}, {"rows_off_pct": 1.01}, {"passes_failed": 1}):
        got = {"px_gap": 1, "rows_off_pct": 0.0, "passes_failed": 0, **over}
        assert not harness.decide(got, limits)[1]


def test_roofline_counts_by_hand():
    r = spec.rooflines()
    g = {"n_in": 1000, "in_bytes": 2, "taps_per_output": 74.0, "n_work": 260, "fir_taps": 37,
         "sync_len": 114, "n_valid": 146, "max_peaks": 16}
    assert r["polyphase_resample"].count(g) == (2 * 74 * 260, 2 * 1000 + 4 * 260)
    assert r["demod_fir_corr"].count(g) == (260 * (8 + 74 + 114), 12 * 260)
    assert r["select_peaks"].count(g) == (146, 4 * 146 + 4 * 19)


def test_geometry_of_a_48k_pass():
    config = spec.Spec(spec.HERE.parent).config("sdr48k_std")
    g = harness.geometry(config, 28_800_000, 1199)
    assert (g["l"], g["m"], g["fir_taps"], g["sync_len"]) == (13, 50, 37, 114)
    assert g["n_work"] == 7_487_991  # ceil((28.8e6 * 13 - 479) / 50): the filter offset is 479
    assert g["taps_per_output"] == pytest.approx(959 / 13)


def test_roofline_share_against_the_peaks():
    t = trace.Trace(0, 10**9, device=[("void (anonymous namespace)::block_kernel<short, 4, 2>(x)", 0, 10**6)])
    g = {"n_in": 10**6, "in_bytes": 2, "taps_per_output": 10.0, "n_work": 10**6}
    ctx = harness.Context([], 1.0, 0.0, trace=t,
                          peaks={"fp32_flops_per_s": 1e12, "bytes_per_s": 1e12}, geometry=[g])
    # bound: max(2e7 flops / 1e12, 6e6 bytes / 1e12) = 20 us of 1 ms measured
    assert ctx.roofline(["polyphase_resample"]) == pytest.approx(2.0)
    assert ctx.roofline(["demod_fir_corr"]) is None  # no event: nothing to read


def test_trace_busy_names_and_gaps():
    t = trace.Trace(0, 1000_000, device=[("void k<int>(float const*, int)", 100_000, 200_000),
                                         ("Memcpy HtoD (Pageable -> Device)", 150_000, 300_000)],
                    host=[("cli.save", 300_000, 1000_000), ("aten::add", 300_000, 310_000)])
    assert t.busy_s == pytest.approx(200e-6)
    assert t.device_ops()[0][0] == "Memcpy HtoD (Pageable -> Device)"
    assert trace.kernel_name("void k<int>(float const*, int)") == "void k<int>"
    assert trace.kernel_name("(anonymous namespace)::f(int)") == "(anonymous namespace)::f"
    gaps = dict(t.idle_gaps())
    assert gaps["cli.save"] == pytest.approx(700e-6)
    assert gaps["harness"] == pytest.approx(100e-6)
