"""Seeded APT passes: the benchmark's traffic generator.

A frozen copy of the program's ``synth.py`` (itself a copy of the JAX
package's), extended so that a pass looks like a real one to the stages
that depend on the data: the line layout (sync A and B, the spaces, the
909-pixel images, the telemetry wedges of 128-line frames) is upstream
noaa-apt's (``src/decode.rs``, https://www.sigidwiki.com/wiki/APT), and
on top of it every pass draws from its seed

- smooth cloud and land fields per channel, with pixel texture, so that
  the PNG's deflate does the work a real image asks of it;
- an SNR that is low at the start and end of the pass and high at its
  middle, through the noise added to the 2400 Hz AM signal;
- a start offset into the first line.

The length of each pass is not drawn: a traffic mix gives the set of
lengths, and the seed only orders it, so that every seed asks the same
amount of work.  Everything runs in torch on the device it is given, from
one ``torch.Generator`` per pass, in a few large calls.
"""

from __future__ import annotations

import math

import torch

FINAL_RATE = 4160
CARRIER_FREQ = 2400
PX_SYNC_FRAME = 39
PX_SPACE_DATA = 47
PX_CHANNEL_IMAGE_DATA = 909
PX_PER_CHANNEL = 1040
PX_PER_ROW = 2080
LINES_PER_SECOND = 2

# Telemetry wedges 1-9 (the contrast staircase), 10-15 (sensor data, a
# fixed ramp here) and 16 (the channel id: "2" on A, "4" on B).
WEDGE_VALUES = [31.0, 63.0, 95.0, 127.0, 159.0, 191.0, 224.0, 255.0, 0.0,
                30.0, 60.0, 90.0, 120.0, 150.0, 180.0]
CHANNEL_A_ID, CHANNEL_B_ID = 63.0, 127.0
AMP_LOW, AMP_HIGH = 0.2, 1.0
PCM_GAIN = 16000.0  # int16 counts at carrier amplitude 1


def sync_a_pixels() -> list:
    """Channel A sync: seven 2-px pulses of a 1040 Hz square wave."""
    pat = [0.0] * 2 + ([0.0] * 2 + [255.0] * 2) * 7 + [0.0] * 8
    return pat + [0.0] * (PX_SYNC_FRAME - len(pat))


def sync_b_pixels() -> list:
    """Channel B sync: seven 3-px pulses at 832 Hz."""
    pat = [0.0] * 4 + ([255.0] * 3 + [0.0] * 2) * 7
    return pat + [0.0] * (PX_SYNC_FRAME - len(pat))


def telemetry_column(n_rows: int, channel_id: float, device) -> torch.Tensor:
    """Per-row telemetry value: 16 wedges of 8 rows per 128-row frame."""
    frame = torch.tensor(WEDGE_VALUES + [channel_id], dtype=torch.float32, device=device)
    return frame.repeat_interleave(8).repeat(-(-n_rows // 128))[:n_rows]


def _smooth(gen: torch.Generator, rows: int, cols: int, cell: int, device) -> torch.Tensor:
    """A smooth random field in about [-1, 1]: Gaussian noise on a grid
    of ``cell`` pixels, bilinearly upsampled."""
    gr, gc = rows // cell + 2, cols // cell + 2
    grid = torch.randn((1, 1, gr, gc), generator=gen, device=device)
    up = torch.nn.functional.interpolate(grid, size=(gr * cell, gc * cell), mode="bilinear",
                                         align_corners=False)
    return up[0, 0, :rows, :cols]


def scene(gen: torch.Generator, n_rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel A (visible) and B (infrared) images ``[n_rows, 909]``,
    0..255: land and sea, clouds bright in both, colder (brighter in B)
    at their tops, a few levels of pixel texture."""
    cols = PX_CHANNEL_IMAGE_DATA
    land = torch.sigmoid(6.0 * (_smooth(gen, n_rows, cols, 96, device)
                                + 0.5 * _smooth(gen, n_rows, cols, 24, device)))
    cloud = torch.sigmoid(5.0 * (_smooth(gen, n_rows, cols, 64, device)
                                 + 0.6 * _smooth(gen, n_rows, cols, 16, device)
                                 + 0.3 * _smooth(gen, n_rows, cols, 4, device) - 0.3))
    tops = _smooth(gen, n_rows, cols, 32, device)
    texture = torch.randn((2, n_rows, cols), generator=gen, device=device)
    a = 25.0 + 70.0 * land + 150.0 * cloud + 4.0 * texture[0]
    b = 90.0 + 25.0 * land + (110.0 + 30.0 * tops) * cloud + 4.0 * texture[1]
    return a.clamp(0.0, 255.0), b.clamp(0.0, 255.0)


def apt_pattern(gen: torch.Generator, n_rows: int, device) -> torch.Tensor:
    """A full ``[n_rows, 2080]`` luminance matrix, 0..255."""
    rows = torch.zeros((n_rows, PX_PER_ROW), dtype=torch.float32, device=device)
    x0 = PX_SYNC_FRAME + PX_SPACE_DATA
    a, b = scene(gen, n_rows, device)
    rows[:, :PX_SYNC_FRAME] = torch.tensor(sync_a_pixels(), device=device)
    rows[:, x0 : x0 + PX_CHANNEL_IMAGE_DATA] = a
    rows[:, x0 + PX_CHANNEL_IMAGE_DATA : PX_PER_CHANNEL] = telemetry_column(n_rows, CHANNEL_A_ID, device)[:, None]
    b0 = PX_PER_CHANNEL
    rows[:, b0 : b0 + PX_SYNC_FRAME] = torch.tensor(sync_b_pixels(), device=device)
    rows[:, b0 + PX_SYNC_FRAME : b0 + x0] = 255.0
    rows[:, b0 + x0 : b0 + x0 + PX_CHANNEL_IMAGE_DATA] = b
    rows[:, b0 + x0 + PX_CHANNEL_IMAGE_DATA :] = telemetry_column(n_rows, CHANNEL_B_ID, device)[:, None]
    return rows


def modulate(gen: torch.Generator, flat: torch.Tensor, sample_rate: int, snr_edge_db: float,
             snr_mid_db: float, chunk: int = 1 << 23) -> torch.Tensor:
    """AM-modulate a flat pixel stream onto the 2400 Hz carrier at
    ``sample_rate`` (luminance 0 -> amplitude 0.2, 255 -> 1.0, constant
    over each pixel), add white noise whose SNR rises from ``snr_edge_db``
    at the ends to ``snr_mid_db`` at the middle (a half sine), and
    quantize to int16.  Sample and carrier phase are exact integers."""
    dev = flat.device
    n_px = flat.shape[0]
    n = n_px * sample_rate // FINAL_RATE
    amp = AMP_LOW + (AMP_HIGH - AMP_LOW) * flat / 255.0
    # The signal's mean power: amp^2 / 2 for a carrier over whole cycles.
    p_sig = float((amp.double() ** 2).mean() / 2.0)
    out = torch.empty(n, dtype=torch.int16, device=dev)
    for a in range(0, n, chunk):
        i = torch.arange(a, min(n, a + chunk), dtype=torch.int64, device=dev)
        px = torch.clamp(i * FINAL_RATE // sample_rate, max=n_px - 1)
        phase = (i * CARRIER_FREQ % sample_rate).to(torch.float64) / sample_rate
        sig = amp[px].double() * torch.cos(2.0 * math.pi * phase)
        snr_db = snr_edge_db + (snr_mid_db - snr_edge_db) * torch.sin(math.pi * i.double() / n)
        sigma = torch.sqrt(p_sig / 10.0 ** (snr_db / 10.0))
        noise = torch.randn(i.shape[0], generator=gen, device=dev, dtype=torch.float64)
        pcm = torch.round((sig + sigma * noise) * PCM_GAIN).clamp(-32768, 32767)
        out[a : a + i.shape[0]] = pcm.to(torch.int16)
    return out


def make_pass(seed: int, seconds: float, sample_rate: int, snr_edge_db: float, snr_mid_db: float,
              device) -> torch.Tensor:
    """One seeded pass of ``seconds`` (whole lines) at ``sample_rate``:
    int16 samples on ``device``.  The start falls at a seeded pixel of
    the first line."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_rows = int(round(seconds * LINES_PER_SECOND)) + 1
    flat = apt_pattern(gen, n_rows, device).reshape(-1)
    start = int(torch.randint(0, PX_PER_ROW, (1,), generator=gen, device=device))
    flat = flat[start : start + (n_rows - 1) * PX_PER_ROW]
    return modulate(gen, flat, sample_rate, snr_edge_db, snr_mid_db)
