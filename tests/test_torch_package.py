"""Isolation and device rules of the PyTorch port (``noaa_apt_tpu_torch``).

- it imports neither ``jax`` nor any module of ``noaa_apt_tpu``, nor PIL
  (the card's machine has none), and reads its resources (the palettes,
  the GUI's icon) from its own ``res/``;
- its entry points run on the card and raise without CUDA unless the
  caller asks for the CPU;
- importing its kernel modules needs no ``nvcc`` (kernels build at the
  first launch on a CUDA tensor).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from noaa_apt_tpu_torch.core.profiles import STANDARD
from noaa_apt_tpu_torch.device import resolve_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "noaa_apt_tpu_torch"


def _run_py(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=240, env=env)


def _port_modules() -> list[str]:
    """Every module of the port, by its dotted name."""
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_port_never_loads_jax_or_the_jax_package():
    """Importing every module of the port (old and new, the GUI's Tk shell
    included) loads neither, nor PIL."""
    mods = _port_modules()
    assert {"noaa_apt_tpu_torch.io.config", "noaa_apt_tpu_torch.io.context",
            "noaa_apt_tpu_torch.post.telemetry", "noaa_apt_tpu_torch.post.imageext",
            "noaa_apt_tpu_torch.post.palette", "noaa_apt_tpu_torch.io.misc",
            "noaa_apt_tpu_torch.graph.debug", "noaa_apt_tpu_torch.graph.resample_tool",
            "noaa_apt_tpu_torch.ops.pack", "noaa_apt_tpu_torch.native", "noaa_apt_tpu_torch.serve",
            "noaa_apt_tpu_torch.stream", "noaa_apt_tpu_torch.gui",
            *(f"noaa_apt_tpu_torch.gui.{m}" for m in ("state", "misc", "work", "app")),
            *(f"noaa_apt_tpu_torch.geo.{m}" for m in ("geometry", "sgp4", "tle", "orbit",
                                                       "shapefile", "states", "map_overlay"))
            } <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for name in {mods!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'noaa_apt_tpu', 'PIL'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = _run_py(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|noaa_apt_tpu|PIL)(?:\.|\s|$)", re.M)


def test_source_scan_finds_no_jax_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert {PORT / "geo" / "map_overlay.py", PORT / "geo" / "sgp4.py", PORT / "io" / "misc.py",
            PORT / "graph" / "debug.py", PORT / "graph" / "resample_tool.py", PORT / "ops" / "pack.py",
            PORT / "native" / "__init__.py", PORT / "serve.py", PORT / "stream.py",
            *(PORT / "gui" / f"{m}.py" for m in ("__init__", "state", "misc", "work", "app"))} <= set(files)
    offenders = [str(p.relative_to(ROOT)) for p in files if _IMPORT.search(p.read_text())]
    assert offenders == []


def test_kernel_modules_import_without_nvcc(tmp_path):
    """No nvcc on PATH and none named: importing every kernel module
    still works and builds nothing."""
    env = {k: v for k, v in os.environ.items() if k not in ("NVCC", "CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)
    code = (
        "import noaa_apt_tpu_torch.ops.resample, noaa_apt_tpu_torch.ops.stage\n"
        "import noaa_apt_tpu_torch.ops.select, noaa_apt_tpu_torch.ops.pack\n"
        "import noaa_apt_tpu_torch.native as native\n"
        "from noaa_apt_tpu_torch.ops import _build, launch_counts\n"
        "assert _build._libs == {} and native._lib is None\n"
        "assert launch_counts() == {'polyphase_resample': 0, 'demod_fir_corr': 0, 'select_peaks': 0,\n"
        "                           'unpack_sealed': 0}\n"
    )
    proc = _run_py(code, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA refusal cannot be shown here")
    from noaa_apt_tpu_torch import cli
    from noaa_apt_tpu_torch.graph.decode import Decoder

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Decoder(STANDARD)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([str(tmp_path / "any.wav"), "-o", str(tmp_path / "out.png")])
    assert not (tmp_path / "out.png").exists()
    assert Decoder(STANDARD, device="cpu").device == torch.device("cpu")
    # The stream, the step export and a traced run refuse the same way.
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.graph.debug import decode_with_steps
    from noaa_apt_tpu_torch.io.context import Context
    from noaa_apt_tpu_torch.stream import StreamingDecoder

    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingDecoder(STANDARD, Rate(11025))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_with_steps(Context.decode(), STANDARD, np.zeros(10, np.float32), Rate(11025))
    for flags in (["--stream"], ["--wav-steps"], ["--profile-trace", str(tmp_path / "tr")]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main([str(tmp_path / "any.wav"), "-o", str(tmp_path / "out.png"), *flags])
    assert not (tmp_path / "tr").exists() and not (tmp_path / "out.png").exists()
    assert StreamingDecoder(STANDARD, Rate(11025), device="cpu").device == torch.device("cpu")


def test_wrappers_take_the_plain_twin_only_for_cpu_tensors():
    """A CPU tensor runs the twin and counts no launch."""
    from noaa_apt_tpu_torch.ops import launch_counts, reset_launch_counts
    from noaa_apt_tpu_torch.ops.select import select_peaks

    from noaa_apt_tpu_torch.ops.pack import sealed_len, unpack_sealed

    reset_launch_counts()
    select_peaks(torch.zeros((1, 100)), [100], 20, 16, 16)
    unpack_sealed(torch.zeros(sealed_len(2, 8, 4), dtype=torch.int32), 2, 8, 4, 11620)
    assert launch_counts() == {"polyphase_resample": 0, "demod_fir_corr": 0, "select_peaks": 0,
                               "unpack_sealed": 0}


def test_resolve_device_pins_fp32():
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_png_writer_round_trips(tmp_path):
    from PIL import Image

    from noaa_apt_tpu_torch.io import png

    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (7, 2080, 4), dtype=np.uint8)
    gray = rng.integers(0, 256, (5, 33), dtype=np.uint8)
    png.write_png(tmp_path / "a.png", rgba)
    png.write_png(tmp_path / "b.png", gray)
    png.write_png(tmp_path / "c.png", rgba[..., :3])
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "b.png")), gray)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "c.png")), rgba[..., :3])
    assert png.png_size(tmp_path / "a.png") == (2080, 7)
    with pytest.raises(ValueError):
        png.encode_png(rgba[..., :2])


def test_wav_loader_keeps_int16(tmp_path):
    from noaa_apt_tpu_torch.io import wav

    sig = np.sin(np.arange(5000) / 7.0).astype(np.float32)
    wav.write_wav(tmp_path / "a.wav", sig, wav.WavSpec(1, 11025, 16, "int"))
    x, rate = wav.load_device_ready(tmp_path / "a.wav")
    assert x.dtype == np.int16 and rate.get_hz() == 11025 and x.shape == (5000,)
    f, _ = wav.load(tmp_path / "a.wav")
    np.testing.assert_array_equal(f, x.astype(np.float32))


def test_finish_image_refuses_unported_features(caplog):
    """Histogram equalization and false colour finish the image, and so
    do the orbit branches: ``Rotate.ORBIT`` without orbit settings
    refuses to rotate, with the reference's warning, and orbit settings
    without a map draw nothing (tests/test_torch_geo.py holds the
    overlay and the orbit rotation against the JAX package)."""
    from datetime import datetime, timezone

    from noaa_apt_tpu_torch.graph.process import finish_image
    from noaa_apt_tpu_torch.io.config import res_path
    from noaa_apt_tpu_torch.types import (ColorSettings, ContrastKind, OrbitSettings, RefTime,
                                          Rotate, SatName)

    gray = np.tile(np.arange(2080, dtype=np.int64) % 251, (3, 1)).astype(np.uint8)
    assert finish_image(gray, ContrastKind.PERCENT, Rotate.NO).shape == (3, 2080, 4)
    color = ColorSettings(res_path("palettes", "noaa-apt-daylight.png"))
    eq = finish_image(gray, ContrastKind.HISTOGRAM, Rotate.NO)
    assert eq.shape == (3, 2080, 4) and not np.array_equal(eq[..., 0], gray)
    fc = finish_image(gray, ContrastKind.PERCENT, Rotate.NO, color)
    assert (fc[:, 86:995, 0] != fc[:, 86:995, 2]).any()  # channel A is coloured
    np.testing.assert_array_equal(fc[:, 1040:, 0], gray[:, 1040:])
    plain = finish_image(gray, ContrastKind.PERCENT, Rotate.NO)
    np.testing.assert_array_equal(finish_image(gray, ContrastKind.PERCENT, Rotate.ORBIT), plain)
    assert "Can't rotate automatically if no orbit information is provided" in caplog.text
    no_map = OrbitSettings(SatName.NOAA_19, RefTime.start(datetime(2020, 1, 26, tzinfo=timezone.utc)))
    np.testing.assert_array_equal(finish_image(gray, ContrastKind.PERCENT, Rotate.NO, orbit=no_map),
                                  plain)


def test_port_ships_its_own_resources(monkeypatch):
    """The palettes, shapefiles and the GUI's icon resolve inside the
    port's package (and are package data), not in ``noaa_apt_tpu/res``."""
    import tomllib

    from noaa_apt_tpu_torch.io.config import res_path

    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)
    assert res_path() == PORT / "res"
    assert len(list(res_path("palettes").glob("*.png"))) == 22
    assert sorted(p.name for p in res_path("shapefiles").glob("*.shp")) == ["countries.shp", "lakes.shp"]
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"]
    assert {"res/palettes/*.png", "res/shapefiles/*.shp", "res/icon.png"} <= set(data["noaa_apt_tpu_torch"])
    assert res_path("icon.png").read_bytes() == (ROOT / "noaa_apt_tpu" / "res" / "icon.png").read_bytes()


def test_host_library_is_the_ports_own_build():
    """The host ingest library that ``noaa_apt_tpu_torch.native`` loads is
    built from the port's ``native/ingest.cpp`` into the port's own
    ``_build/``, never ``noaa_apt_tpu/native/_libapt.so``."""
    from noaa_apt_tpu_torch import native

    lib = Path(native.get_lib()._name).resolve()
    assert lib.parent == PORT / "_build" and lib.name.startswith("libingest-")
    assert native.SOURCE == PORT / "native" / "ingest.cpp"
    assert lib in {native.lib_path(extra) for extra in native.GXX_VARIANTS}


def test_host_ingest_never_opens_the_jax_native_directory(tmp_path):
    """Every host mode (payload, render, packed codec, the CLI) in a fresh
    process, with an audit hook on file opens and library loads: nothing
    under ``noaa_apt_tpu/native/`` is touched, and neither JAX nor the JAX
    package is imported."""
    code = (
        "import sys\n"
        f"JAX_NATIVE = {str(ROOT / 'noaa_apt_tpu' / 'native')!r}\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'ctypes.dlopen', 'os.listdir', 'os.scandir') and args and args[0]:\n"
        "        p = str(args[0])\n"
        "        if p.startswith(JAX_NATIVE) or '_libapt' in p:\n"
        "            seen.append((event, p))\n"
        "sys.addaudithook(hook)\n"
        "import numpy as np\n"
        "from noaa_apt_tpu_torch import cli, synth\n"
        "from noaa_apt_tpu_torch.io import wav\n"
        "sig, _ = synth.synth_recording(n_rows=16, sample_rate=11025, noise_db=30.0, seed=1)\n"
        f"path = {str(tmp_path / 'p.wav')!r}\n"
        "wav.write_wav(path, sig, wav.WavSpec(1, 11025, 16, 'int'))\n"
        "for mode in ('host', 'host16', 'host16c', 'host8'):\n"
        f"    assert cli.main([path, '-o', {str(tmp_path / 'o.png')!r}, '--device', 'cpu', '-q',\n"
        "                     '--ingest', mode]) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'noaa_apt_tpu'))\n"
        "assert not seen and not bad, (seen, bad)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "XDG_CONFIG_HOME": str(tmp_path / "cfg")}
    proc = _run_py(code, env=env)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stdout + proc.stderr
