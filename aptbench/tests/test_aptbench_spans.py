"""The readers of the program's ``apt.*`` spans, on hand-made traces."""

import pytest

from aptbench import harness, spec, spans, trace

MS = 1_000_000  # ns


def ctx_of(host, n_passes):
    t = trace.Trace(0, 100 * MS, host=host)
    return harness.Context([{"ok": True}] * n_passes, 0.1, 0.0, trace=t)


def test_spans_go_to_the_call_that_holds_their_start():
    host = [("pass", 0, 10 * MS), ("pass", 10 * MS, 30 * MS), ("pass", 30 * MS, 40 * MS),
            ("apt.png.deflate", 1 * MS, 4 * MS), ("apt.png.deflate", 5 * MS, 6 * MS),  # call 0: 4 ms
            ("apt.png.deflate", 29 * MS, 31 * MS),  # starts in call 1, ends in call 2: call 1's
            ("apt.png.write", 12 * MS, 13 * MS),
            ("apt.png.deflate", 50 * MS, 60 * MS),  # after the last call: no call's
            ("cli.save", 0, 40 * MS), ("aten::add", 1 * MS, 2 * MS)]
    ctx = ctx_of(host, 3)
    assert spans.per_call_s(ctx, {"apt.png.deflate"}) == pytest.approx([0.004, 0.002, 0.0])
    assert spans.median_ms(ctx, {"apt.png.deflate"}) == pytest.approx(2.0)
    assert spans.median_ms(ctx, {"apt.png.deflate", "apt.png.write"}) == pytest.approx(3.0)
    assert spec.Spec.reader("deflate_ms.single").read(ctx) == pytest.approx(2.0)
    assert spec.Spec.reader("png_write_ms.single").read(ctx) == pytest.approx(0.0)


def test_fleet_waits_per_pass_and_drain_per_call():
    host = [("fleet_call", 0, 50 * MS), ("fleet_call", 50 * MS, 100 * MS),
            ("apt.fleet.wait_loader", 1 * MS, 9 * MS),  # call 0: 8 ms over 4 passes
            ("apt.fleet.wait_loader", 51 * MS, 55 * MS), ("apt.fleet.wait_loader", 60 * MS, 68 * MS),
            ("apt.fleet.drain", 40 * MS, 50 * MS), ("apt.fleet.drain", 80 * MS, 100 * MS)]
    ctx = ctx_of(host, 8)  # two calls of four passes each
    assert spec.Spec.reader("loader_wait_ms.fleet").read(ctx) == pytest.approx(2.5)  # median(8, 12) / 4
    assert spec.Spec.reader("drain_ms.fleet").read(ctx) == pytest.approx(15.0)
    assert spec.Spec.reader("encoder_wait_ms.fleet").read(ctx) == 0.0  # no wait in a traced window


@pytest.mark.parametrize("name", ["upload_copy_ms.single", "upload_h2d_ms.single", "device_wait_ms.single",
                                  "deflate_ms.single", "png_write_ms.single", "loader_wait_ms.fleet",
                                  "encoder_wait_ms.fleet", "drain_ms.fleet"])
def test_none_without_the_programs_spans(name):
    """A program with no ``apt.*`` span (an older commit) and an untraced
    run read nothing, and raise nothing."""
    reader = spec.Spec.reader(name)
    host = [("pass", 0, 10 * MS), ("fleet_call", 10 * MS, 20 * MS), ("cli.save", 1 * MS, 9 * MS)]
    assert reader.read(ctx_of(host, 2)) is None
    assert reader.read(harness.Context([{"ok": True}], 1.0, 0.0)) is None
