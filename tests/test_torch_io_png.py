"""The port's PNG writer (``noaa_apt_tpu_torch/io/png.py``) on the CPU.

A pass-sized image is deflated in row strips on a host thread pool and
written as one IDAT chunk a strip; the chunks join into one zlib stream.
Each PNG reads back to its pixels (the port's reader, ``zlib.decompress``
of the joined IDATs, which checks the adler32 trailer, and PIL), its bytes
do not depend on the pool's worker count, and an image under the strip
threshold keeps the single ``zlib.compress`` stream of the JAX writer.
"""

import struct
import sys
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

from noaa_apt_tpu.io import png as jpng
from noaa_apt_tpu_torch import cli
from noaa_apt_tpu_torch.io import png, wav
from noaa_apt_tpu_torch.synth import synth_recording

PASS_ROWS, WIDTH = 1200, 2080


def apt_like(rows: int, channels: int, seed: int = 0) -> np.ndarray:
    """A smooth field with noise on it, as a decoded pass looks to zlib;
    RGB and RGBA as the CLI writes them (grey in R, G and B; alpha 255)."""
    rng = np.random.default_rng(seed)
    y, x = np.arange(rows)[:, None], np.arange(WIDTH)[None, :]
    field = 128 + 60 * np.sin(x / 53.0 + y / 97.0) + 30 * np.sin(y / 17.0) + rng.normal(0, 8, (rows, WIDTH))
    gray = np.clip(field, 0, 255).astype(np.uint8)
    if channels == 1:
        return gray
    out = np.repeat(gray[..., None], channels, axis=2)
    if channels == 4:
        out[..., 3] = 255
    return out


def chunks(data: bytes) -> list:
    """``(tag, body)`` of each chunk, every CRC checked."""
    out, pos = [], 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        assert crc == zlib.crc32(tag + body), tag
        out.append((tag, body))
        pos += 12 + length
    return out


def filtered(img: np.ndarray) -> bytes:
    """The scanlines the writer deflates: filter byte 0, then the row."""
    rows = img.reshape(img.shape[0], int(np.prod(img.shape[1:])))
    return np.concatenate([np.zeros((rows.shape[0], 1), np.uint8), rows], axis=1).tobytes()


def one_stream_png(img: np.ndarray, level: int) -> bytes:
    """The writer as it was: one ``zlib.compress`` stream in one IDAT chunk."""
    ch = 1 if img.ndim == 2 else img.shape[2]

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(filtered(img), level))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("rows", [1, 9, PASS_ROWS])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trips(tmp_path, rows, channels):
    img = apt_like(rows, channels, seed=rows + channels)
    png.write_png(tmp_path / "a.png", img)
    data = (tmp_path / "a.png").read_bytes()
    idats = [body for tag, body in chunks(data) if tag == b"IDAT"]
    assert len(idats) == png.png_strips(img) == (1 if rows < PASS_ROWS else len(idats))
    if rows == PASS_ROWS:
        assert len(idats) > 1
    assert zlib.decompress(b"".join(idats)) == filtered(img)  # checks the adler32 trailer
    np.testing.assert_array_equal(png.read_png(tmp_path / "a.png"), img.reshape(rows, WIDTH, channels))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)
    assert png.png_size(tmp_path / "a.png") == (WIDTH, rows)


def test_pass_sized_gray_decodes_to_the_jax_writers_pixels():
    gray = apt_like(PASS_ROWS, 1, seed=5)
    ours, theirs = png.encode_png(gray), jpng.encode_gray_png(gray)
    assert png.png_strips(gray) > 1 and ours != theirs

    def pixels(data):
        return zlib.decompress(b"".join(body for tag, body in chunks(data) if tag == b"IDAT"))

    assert pixels(ours) == pixels(theirs)


@pytest.mark.parametrize("channels", [1, 4])
@pytest.mark.parametrize("level", [1, 6])
def test_pass_sized_bytes_do_not_depend_on_the_worker_count(monkeypatch, channels, level):
    img = apt_like(PASS_ROWS, channels, seed=7)
    outs = []
    for n in (1, 3, 8):
        monkeypatch.setattr(png, "_workers", lambda n=n: n)
        outs.append(png.encode_png(img, level))
        assert png._pool._max_workers == n
    assert outs[0] == outs[1] == outs[2]
    # Each strip's dictionary is the window before it: the strips cost
    # under 0.1 % over the single stream.
    assert len(outs[0]) <= 1.001 * len(one_stream_png(img, level))


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("shape", [(9, WIDTH), (7, WIDTH, 4), (5, 33), (31, WIDTH, 4), (251, WIDTH),
                                   (62, WIDTH, 4), (0, WIDTH)])
def test_small_images_keep_the_single_stream(shape, level):
    img = np.random.default_rng(len(shape) + shape[0]).integers(0, 256, shape, dtype=np.uint8)
    assert png.png_strips(img) == 1
    assert png.encode_png(img, level) == one_stream_png(img, level)


@pytest.mark.parametrize("rows, strips", [(62, 1), (64, 2), (95, 3), (PASS_ROWS, 16)])
def test_strip_plan_follows_the_filtered_bytes(rows, strips):
    row_bytes = 1 + WIDTH * 4
    plan = png.strip_rows(rows, row_bytes)
    assert len(plan) == strips and plan[0][0] == 0 and plan[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    sizes = [r1 - r0 for r0, r1 in plan]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) * row_bytes > 0.95 * png._STRIP_BYTES
    img = apt_like(rows, 4)
    assert png.png_strips(img) == strips
    assert zlib.decompress(b"".join(b for t, b in chunks(png.encode_png(img)) if t == b"IDAT")) == filtered(img)


@pytest.mark.parametrize("seed", range(6))
def test_adler32_combine(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    if seed % 2:
        data = b"\xff" * len(data)  # the sums' largest terms
    cuts = sorted(rng.integers(0, len(data), 4).tolist() + [0, 70_000, 70_000, len(data)])
    parts = [data[a:b] for a, b in zip(cuts, cuts[1:])]
    assert any(not p for p in parts) and any(len(p) > 65521 for p in parts)
    adler = 1
    for p in parts:
        adler = png.adler32_combine(adler, zlib.adler32(p), len(p))
    assert adler == zlib.adler32(data)
    assert png.adler32_combine(zlib.adler32(data), 1, 0) == zlib.adler32(data)


@pytest.mark.parametrize("rows, strips", [(40, 1), (90, 2)])
def test_cli_reports_the_png_strips(tmp_path, monkeypatch, rows, strips):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.chdir(tmp_path)
    signal, _ = synth_recording(n_rows=rows, sample_rate=11025, noise_db=20.0, seed=rows)
    wav.write_wav("p.wav", signal, wav.WavSpec(1, 11025, 16, "int"))
    report: dict = {}
    assert cli.main(["p.wav", "-o", "o.png", "-q", "--device", "cpu"], report=report) == 0
    img = png.read_png("o.png")
    assert report["png_strips"] == strips == png.png_strips(img)
    assert sum(tag == b"IDAT" for tag, _ in chunks((tmp_path / "o.png").read_bytes())) == strips


def test_concurrent_writers_share_the_pool(monkeypatch):
    """Six threads (more than the pool's four workers) encode six different
    pass-sized images at once, as the fleet's encoders do: each PNG is its
    own image's, byte for byte its serial encoding."""
    monkeypatch.setattr(png, "_workers", lambda: 4)
    imgs = [apt_like(PASS_ROWS // 2, 1 if k % 2 else 4, seed=100 + k) for k in range(6)]
    want = [png.encode_png(img) for img in imgs]
    got = [None] * len(imgs)

    def encode(k):
        got[k] = png.encode_png(imgs[k])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=encode, args=(k,)) for k in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == want and len(set(got)) == len(imgs)
