"""The port's PNG codec: every row filter decodes bit for bit, in C.

`read_png` undoes the row filters with csrc/png_unfilter.c, built with the
host C compiler at first use.  It must equal the plain per-byte version
(`_unfilter_python`) and the JAX package's pure-Python reader on u8 gray,
u8 RGB and u16 depth written with each filter type 0-4 and with mixed
per-row filters; the prefetcher must return the same arrays; a failed
build raises instead of falling back; and a 480x640 Paeth frame decodes in
well under the per-byte loop's time.  Also: a relative `--lfnet-ckpt` opens
against the working directory, as the JAX app's does.
"""

import os
import time
import zlib

import numpy as np
import pytest

from bundletrack_tpu.data.native_io import _read_png_python as jax_read_png_python
from bundletrack_tpu_torch.data import native_io
from bundletrack_tpu_torch.data.native_io import SequencePrefetcher, read_png, write_png
from bundletrack_tpu_torch.kernels import build

PAETH_480x640_MAX_S = 0.25  # the per-byte loop took ~1.7 s on this frame


def _images(h=37, w=29, seed=0):
    """Smooth images with noise (so every predictor is exercised), with the
    extremes 0 and the type's maximum present."""
    rng = np.random.RandomState(seed)
    ramp = np.add.outer(np.arange(h), np.arange(w)).astype(np.float64)
    gray = ((ramp * 5 + rng.randint(0, 40, (h, w))) % 256).astype(np.uint8)
    rgb = np.stack([gray, 255 - gray, rng.randint(0, 256, (h, w))], -1).astype(np.uint8)
    depth = (ramp * 1300 + rng.randint(0, 3000, (h, w))).astype(np.uint16)
    gray[0, 0], rgb[0, 0], depth[0, 0] = 255, 0, 65535
    return {"gray": gray, "rgb": rgb, "depth": depth}


FILTERS = [0, 1, 2, 3, 4, "mixed"]


def _filter_arg(ft, h):
    return np.random.RandomState(7).randint(0, 5, h) if ft == "mixed" else ft


@pytest.mark.parametrize("kind", ["gray", "rgb", "depth"])
@pytest.mark.parametrize("ft", FILTERS)
def test_round_trip_bit_identical(tmp_path, monkeypatch, kind, ft):
    img = _images()[kind]
    path = str(tmp_path / "x.png")
    write_png(path, img, filter_type=_filter_arg(ft, img.shape[0]))
    got = read_png(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jax_read_png_python(path))
    monkeypatch.setattr(native_io, "_unfilter_c", native_io._unfilter_python)
    np.testing.assert_array_equal(read_png(path), got)


@pytest.mark.parametrize("ft", FILTERS)
def test_writer_uses_the_filter(tmp_path, ft):
    img = _images()["rgb"]
    path = str(tmp_path / "x.png")
    want = _filter_arg(ft, img.shape[0])
    write_png(path, img, filter_type=want)
    data = open(path, "rb").read()
    idat = data.index(b"IDAT")
    n = int.from_bytes(data[idat - 4:idat], "big")
    rows = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]), np.uint8).reshape(img.shape[0], -1)
    np.testing.assert_array_equal(rows[:, 0], np.broadcast_to(want, img.shape[0]))


def test_filter_zero_output_is_unchanged(tmp_path):
    """The default writes what the writer wrote before it took filters: rows
    of a zero byte and the raw bytes, compressed by zlib's default."""
    for img in _images().values():
        path = str(tmp_path / "x.png")
        write_png(path, img)
        raw = img.astype(">u2").tobytes() if img.dtype == np.uint16 else img.tobytes()
        stride = len(raw) // img.shape[0]
        rows = b"".join(b"\x00" + raw[y * stride:(y + 1) * stride] for y in range(img.shape[0]))
        assert zlib.compress(rows) in open(path, "rb").read()


@pytest.mark.parametrize("kind", ["gray", "rgb", "depth"])
@pytest.mark.parametrize("ft", [1, 3, 4])
def test_c_unfilter_equals_the_plain_version_on_random_bytes(kind, ft):
    """Random filtered bytes (not from the writer): every wrap-around of the
    byte arithmetic, rows of one filter and of mixed filters."""
    bpp = {"gray": 1, "rgb": 3, "depth": 2}[kind]
    h, stride = 9, 7 * bpp
    rng = np.random.RandomState(ft)
    raw = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    raw[:, 0] = ft
    raw[5:, 0] = rng.randint(0, 5, h - 5)
    np.testing.assert_array_equal(native_io._unfilter_c(raw.ravel(), h, stride, bpp),
                                  native_io._unfilter_python(raw.ravel(), h, stride, bpp))


def test_bad_filter_type_and_short_data_raise():
    raw = np.zeros((3, 5), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="row 1 has filter type 5"):
        native_io._unfilter_c(raw.ravel(), 3, 4, 1)
    with pytest.raises(ValueError, match="row 1 has filter type 5"):
        native_io._unfilter_python(raw.ravel(), 3, 4, 1)
    with pytest.raises(ValueError, match="not 3 rows"):
        native_io._unfilter_c(raw.ravel()[:-1], 3, 4, 1)
    with pytest.raises(ValueError, match="filter types are 0-4"):
        write_png("/nonexistent/x.png", np.zeros((2, 2), np.uint8), filter_type=5)


def test_prefetcher_returns_the_same_arrays(tmp_path):
    paths, want = [], []
    for i in range(12):
        img = _images(seed=i)[("gray", "rgb", "depth")[i % 3]]
        path = str(tmp_path / f"{i:05d}.png")
        write_png(path, img, filter_type=i % 5)
        paths.append(path)
        want.append(img)
    with SequencePrefetcher(paths, threads=4, ahead=4) as pf:
        for i in range(len(paths)):
            np.testing.assert_array_equal(pf.get(i), want[i])


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that does not exist: the build raises, and read_png raises
    rather than falling back to the per-byte loop."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("CC", str(tmp_path / "no" / "cc"))
    with pytest.raises(RuntimeError, match="could not run"):
        build.build_host(native_io.UNFILTER_SOURCE)
    path = str(tmp_path / "x.png")
    write_png(path, _images()["gray"], filter_type=1)
    with pytest.raises(RuntimeError, match="could not run"):
        read_png(path)


def test_compiler_error_is_reported(tmp_path, monkeypatch):
    (tmp_path / "bad.c").write_text("int f( {\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="failed on bad.c") as e:
        build.build_host("bad.c")
    assert "error" in str(e.value)


def test_host_build_is_keyed_by_compiler(monkeypatch):
    before = build.library_path(native_io.UNFILTER_SOURCE, (build.host_compiler(), *build.HOST_FLAGS))
    monkeypatch.setenv("CC", "gcc-other")
    assert build.library_path(native_io.UNFILTER_SOURCE, (build.host_compiler(), *build.HOST_FLAGS)) != before


def test_paeth_frame_decodes_fast(tmp_path):
    img = np.stack([_images(480, 640, seed=s)["gray"] for s in range(3)], -1)
    path = str(tmp_path / "rgb.png")
    write_png(path, img, filter_type=4)
    read_png(path)  # builds the C function on first use
    t0 = time.perf_counter()
    got = read_png(path)
    dt = time.perf_counter() - t0
    np.testing.assert_array_equal(got, img)
    assert dt < PAETH_480x640_MAX_S, dt


# ---- --lfnet-ckpt opens relative to the working directory ----------------------


def _tiny_ycbineoat(root):
    import yaml

    from bundletrack_tpu_torch.data import render_synthetic_sequence
    from bundletrack_tpu_torch.data.export import export_ycbineoat_sequence

    seq = render_synthetic_sequence(num_frames=2, H=60, W=80)
    data = export_ycbineoat_sequence(seq, os.path.join(root, "seq"))
    cfg = os.path.join(root, "c.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"data_dir": data, "debug_dir": os.path.join(root, "out"),
                        "frontend": {"top_k": 64, "input_size": 32, "bf16": False},
                        "bundle": {"max_BA_frames": 3}, "keyframe": {"pool_size": 4},
                        "ransac": {"max_iter": 128}, "shapes": {"max_matches": 64}}, f)
    return cfg


def test_relative_lfnet_ckpt_opens_in_the_working_directory(tmp_path, monkeypatch):
    import shutil

    from bundletrack_tpu_torch.apps import run_tracking

    cfg = _tiny_ycbineoat(str(tmp_path))
    work = tmp_path / "work"
    (work / "weights").mkdir(parents=True)
    shutil.copy(run_tracking.LFNET_CKPT, work / "weights" / "lf.npz")
    monkeypatch.chdir(work)
    tracker = run_tracking.main([cfg, "--frontend", "lfnet", "--lfnet-ckpt", "weights/lf.npz", "--device", "cpu"])
    assert len(tracker.outputs) == 2
    assert sorted(os.listdir(tmp_path / "out" / "poses")) == ["00000.txt", "00001.txt"]


def test_relative_lfnet_ckpt_under_the_repo_root_only_raises(tmp_path, monkeypatch):
    """checkpoints/lfnet_params.npz exists under the repo root, not under the
    working directory: as in the JAX app, the relative path is not found."""
    from bundletrack_tpu_torch.apps import run_tracking

    cfg = _tiny_ycbineoat(str(tmp_path))
    rel = os.path.relpath(run_tracking.LFNET_CKPT, run_tracking.REPO_ROOT)
    assert os.path.isfile(os.path.join(run_tracking.REPO_ROOT, rel))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        run_tracking.main([cfg, "--frontend", "lfnet", "--lfnet-ckpt", rel, "--device", "cpu"])
    from bundletrack_tpu.apps import run_tracking as jax_run_tracking

    with pytest.raises(FileNotFoundError):
        jax_run_tracking.main([cfg, "--frontend", "lfnet", "--lfnet-ckpt", rel])
