"""libviso_torch.native, the binding to the native image runtime, and the
port's KITTI streams over it.

The oracle is PIL: grayscale PNGs decode byte-exact, RGB to luma within
+-1 (fixed-point rounding), JPEGs bit-identical (the same IJG decoder).
The prefetch stream delivers frames in path order however decode
completes across its threads.  The port's streams equal the JAX
package's on the same files, with the native path on and with it off.
Tests that need the built runtime skip only where this host cannot build
it.
"""

import subprocess

import numpy as np
import pytest
from PIL import Image

from libviso_torch import native
from libviso_torch.io import kitti as tkitti
from libviso_torch.native import build as nbuild
from libviso_tpu.io import kitti as jkitti


@pytest.fixture
def runtime():
    reason = native.unavailable_reason()
    if reason is not None:
        pytest.skip(f"native runtime unavailable here: {reason}")
    return native


def _save(tmp_path, name, arr, mode=None, **kw):
    p = str(tmp_path / name)
    Image.fromarray(arr, mode).save(p, **kw)
    return p


def _pil_gray(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def test_library_is_built_under_build_dir(runtime):
    so = nbuild.library_path()
    assert so.exists() and so.parent == nbuild.BUILD_DIR
    assert so.name.startswith("viso_native-")
    assert runtime.available() and runtime.unavailable_reason() is None


def test_decode_gray_exact(runtime, tmp_path, rng):
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    p = _save(tmp_path, "g.png", img, "L")
    assert np.array_equal(runtime.decode_png_gray(p), img)
    assert np.array_equal(runtime.decode_image_gray(p), img)
    assert runtime.png_dims(p) == (37, 53)


def test_decode_rgb_luma_matches_pil(runtime, tmp_path, rng):
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    p = _save(tmp_path, "c.png", img, "RGB")
    got = runtime.decode_png_gray(p).astype(int)
    assert np.abs(got - _pil_gray(p).astype(int)).max() <= 1


def test_decode_rgba_and_16bit(runtime, tmp_path, rng):
    rgba = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    p = _save(tmp_path, "a.png", rgba, "RGBA")
    got = runtime.decode_png_gray(p).astype(int)
    assert got.shape == (8, 8)
    # alpha dropped: the luma of the colour channels
    rgb = _save(tmp_path, "a_rgb.png", rgba[..., :3].copy(), "RGB")
    assert np.abs(got - _pil_gray(rgb).astype(int)).max() <= 1

    g16 = rng.integers(0, 65536, (8, 8), dtype=np.uint16)
    p16 = str(tmp_path / "g16.png")
    Image.fromarray(g16).save(p16)
    # 16-bit samples keep their high byte
    assert np.array_equal(runtime.decode_png_gray(p16),
                          (g16 >> 8).astype(np.uint8))


def test_decode_jpeg_matches_pil(runtime, tmp_path, rng):
    arr = rng.integers(0, 256, (48, 80), dtype=np.uint8)
    p = _save(tmp_path, "t.jpg", arr, quality=92)
    np.testing.assert_array_equal(runtime.decode_image_gray(p),
                                  _pil_gray(p))


def test_decode_png_is_not_capped(runtime, tmp_path, rng):
    img = rng.integers(0, 256, (40, 60), dtype=np.uint8)
    p = _save(tmp_path, "big.png", img, "L")
    assert np.array_equal(runtime.decode_image_gray(p, max_hw=(4, 4)), img)


@pytest.mark.parametrize("case,message", [
    ("missing", "cannot open file"),
    ("not an image", "unsupported image format"),
    ("truncated", "image decode error"),
    ("jpeg over its cap", "output buffer too small"),
])
def test_error_codes(runtime, tmp_path, rng, case, message):
    img = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    if case == "missing":
        p = str(tmp_path / "missing.png")
    elif case == "not an image":
        p = str(tmp_path / "bad.png")
        with open(p, "wb") as f:
            f.write(b"not a png at all")
    elif case == "truncated":
        good = _save(tmp_path, "good.png", img, "L")
        data = open(good, "rb").read()
        p = str(tmp_path / "cut.png")
        with open(p, "wb") as f:
            f.write(data[:60])
    else:
        p = _save(tmp_path, "t.jpg", img)
    with pytest.raises(IOError, match=message):
        if case == "jpeg over its cap":
            runtime.decode_image_gray(p, max_hw=(4, 4))
        elif case == "truncated":
            runtime.decode_png_gray(p)
        else:
            runtime.decode_image_gray(p)


@pytest.mark.parametrize("threads,depth", [(1, 1), (4, 3), (8, 16)])
def test_stream_in_order(runtime, tmp_path, rng, threads, depth):
    paths, imgs = [], []
    for i in range(30):
        img = rng.integers(0, 256, (10 + i, 20), dtype=np.uint8)
        ext = ".jpg" if i % 7 == 3 else ".png"
        paths.append(_save(tmp_path, f"s{i}{ext}", img, "L"))
        imgs.append(_pil_gray(paths[-1]) if ext == ".jpg" else img)
    with runtime.NativeImageStream(paths, threads=threads,
                                   depth=depth) as s:
        got = list(s)
    assert len(got) == 30
    for a, b in zip(got, imgs):
        assert np.array_equal(a, b)


def test_stream_error_propagates_and_stream_continues(runtime, tmp_path,
                                                      rng):
    imgs = [rng.integers(0, 256, (8, 12), dtype=np.uint8) for _ in range(5)]
    paths = [_save(tmp_path, f"s{i}.png", a, "L") for i, a in
             enumerate(imgs)]
    with open(paths[2], "wb") as f:
        f.write(b"garbage not a png")
    with runtime.NativeImageStream(paths, threads=2, depth=2) as s:
        assert np.array_equal(s.next(), imgs[0])
        assert np.array_equal(s.next(), imgs[1])
        with pytest.raises(IOError):
            s.next()
        assert np.array_equal(s.next(), imgs[3])
        assert np.array_equal(s.next(), imgs[4])
        assert s.next() is None


def test_stream_empty_and_close_idempotent(runtime):
    s = runtime.NativeImageStream([], threads=2, depth=2)
    assert s.next() is None
    s.close()
    s.close()
    assert s.next() is None


def test_vn_no_jpeg_build_keeps_png(runtime, tmp_path, rng):
    """The build without libjpeg (-DVN_NO_JPEG) still decodes PNG, and
    reports a JPEG as an unsupported format."""
    import ctypes

    so = tmp_path / "nojpeg.so"
    proc = nbuild.compile_library(so, jpeg=False)
    assert proc.returncode == 0, proc.stderr
    lib = native._bind(ctypes.CDLL(str(so)))
    img = rng.integers(0, 256, (20, 30), dtype=np.uint8)

    def decode(path):
        buf = np.empty(20 * 30, np.uint8)
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = lib.vn_decode_image_gray(
            path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size, ctypes.byref(h), ctypes.byref(w))
        return rc, buf.reshape(20, 30), (h.value, w.value)

    rc, buf, hw = decode(_save(tmp_path, "a.png", img, "L"))
    assert rc == 0 and hw == (20, 30) and np.array_equal(buf, img)
    assert decode(_save(tmp_path, "a.jpg", img, "L"))[0] == -2


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build that finds no library yet and writes under tmp_path."""
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nbuild, "library_path",
                        lambda: tmp_path / "viso_native-test.so")


def test_build_without_gxx_is_unavailable(fresh_build, monkeypatch):
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    with pytest.raises(nbuild.Unavailable, match="g\\+\\+"):
        nbuild.build()


def _failing(stderr):
    return lambda out, jpeg=True: subprocess.CompletedProcess(
        [], 1, "", stderr)


def test_build_without_png_h_is_unavailable(fresh_build, monkeypatch):
    monkeypatch.setattr(nbuild, "compile_library", _failing(
        "viso_native.cpp:31:10: fatal error: png.h: No such file or "
        "directory"))
    with pytest.raises(nbuild.Unavailable, match="png.h"):
        nbuild.build()


def test_build_error_with_toolchain_present_raises(fresh_build,
                                                   monkeypatch):
    monkeypatch.setattr(nbuild, "compile_library", _failing(
        "/usr/bin/ld: cannot find -lpng"))
    with pytest.raises(RuntimeError, match="cannot find -lpng") as e:
        nbuild.build()
    assert not isinstance(e.value, nbuild.Unavailable)


def test_build_retries_without_jpeg(fresh_build, tmp_path, monkeypatch):
    calls = []
    real = nbuild.compile_library

    def compile_library(out, jpeg=True):
        calls.append(jpeg)
        if jpeg:
            return subprocess.CompletedProcess(
                [], 1, "", "fatal error: jpeglib.h: No such file")
        return real(out, jpeg=jpeg)

    monkeypatch.setattr(nbuild, "compile_library", compile_library)
    so = nbuild.build()
    assert calls == [True, False]
    assert so == tmp_path / "viso_native-test.so" and so.exists()


def _write_pairs(tmp_path, rng, n, ext=".png"):
    for i in range(n):
        for side in "LR":
            img = rng.integers(0, 256, (12, 18), dtype=np.uint8)
            _save(tmp_path, f"{side}{i:06d}{ext}", img, "L")
    return (str(tmp_path / f"L%06d{ext}"), str(tmp_path / f"R%06d{ext}"))


@pytest.fixture(params=["native", "pil"])
def route(request, monkeypatch):
    """Both packages' streams on one decode route: the native runtime
    (counted) or PIL."""
    if request.param == "pil":
        monkeypatch.setattr(tkitti, "_native", lambda: None)
        monkeypatch.setattr(jkitti, "_native", lambda: None)
        return None
    reason = native.unavailable_reason()
    if reason is not None:
        pytest.skip(f"native runtime unavailable here: {reason}")
    opened = []

    class Counted(native.NativeImageStream):
        def __init__(self, paths, *a, **kw):
            opened.append(len(paths))
            super().__init__(paths, *a, **kw)

    monkeypatch.setattr(native, "NativeImageStream", Counted)
    return opened


@pytest.mark.parametrize("ext", [".png", ".jpg"])
@pytest.mark.parametrize("kw", [dict(), dict(begin=2, end=5),
                                dict(prefetch=0), dict(prefetch=1)])
def test_stereo_stream_equals_jax(route, tmp_path, rng, ext, kw):
    masks = _write_pairs(tmp_path, rng, 7, ext)
    got = list(tkitti.StereoImageStream(*masks, **kw))
    want = list(jkitti.StereoImageStream(*masks, **kw))
    assert len(got) == len(want) == (4 if "end" in kw else 7)
    for (gl, gr), (wl, wr) in zip(got, want):
        assert gl.dtype == np.uint8
        assert np.array_equal(gl, wl) and np.array_equal(gr, wr)
    if route is not None and kw.get("prefetch", 4) > 0:
        assert route == [2 * len(got)]


@pytest.mark.parametrize("ext", [".png", ".jpg"])
@pytest.mark.parametrize("kw", [dict(begin=1), dict(begin=2, end=3),
                                dict(begin=1, prefetch=0)])
def test_mono_stream_equals_jax(route, tmp_path, rng, ext, kw):
    for i in range(1, 5):
        a = rng.integers(0, 256, (24, 32), dtype=np.uint8)
        _save(tmp_path, f"img-{i:04d}{ext}", a)
    mask = str(tmp_path / f"img-%04d{ext}")
    got = list(tkitti.MonoImageStream(mask, **kw))
    want = list(jkitti.MonoImageStream(mask, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert len(list(tkitti.MonoImageStream(mask, **kw).skipped(1))) == \
        len(got) - 1
    if route is not None and kw.get("prefetch", 4) > 0:
        assert route[0] == len(got)


def test_stream_decode_error_reaches_consumer(route, tmp_path, rng):
    masks = _write_pairs(tmp_path, rng, 3)
    (tmp_path / "L000001.png").write_bytes(b"not a png at all")
    it = iter(tkitti.StereoImageStream(*masks))
    next(it)
    with pytest.raises(Exception):
        list(it)
