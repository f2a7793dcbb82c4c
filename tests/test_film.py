"""Film layer tests: EXR round-trip, BMP/PNG writing, color transfer,
metrics sanity."""
import os

import numpy as np
import pytest

from optixpathtracer_tpu.film import (color, metrics, read_exr, to_display,
                                      write_bmp, write_exr, write_png)


@pytest.fixture
def hdr_image():
    rng = np.random.default_rng(42)
    return (rng.random((24, 32, 3)) * 3.0).astype(np.float32)


def test_exr_roundtrip(tmp_path, hdr_image):
    p = str(tmp_path / "test.exr")
    write_exr(p, hdr_image)
    back = read_exr(p)
    np.testing.assert_array_equal(back, hdr_image)


def test_exr_nan_scrub(tmp_path, hdr_image):
    img = hdr_image.copy()
    img[3, 4, 1] = np.nan
    img[5, 6, 0] = np.inf
    p = str(tmp_path / "nan.exr")
    write_exr(p, img)  # reference scrubs NaN to 0 (`WriteImage.cpp:52-55`)
    back = read_exr(p)
    assert np.isfinite(back).all()
    assert back[3, 4, 1] == 0.0


def test_png_bmp_exist(tmp_path, hdr_image):
    png = str(tmp_path / "t.png")
    bmp = str(tmp_path / "t.bmp")
    write_png(png, hdr_image)
    write_bmp(bmp, hdr_image)
    assert os.path.getsize(png) > 100
    assert os.path.getsize(bmp) > 100
    # BMP is parseable by PIL and has the right size
    from PIL import Image
    im = Image.open(bmp)
    assert im.size == (32, 24)


def test_srgb_roundtrip():
    x = np.linspace(0, 1, 256)
    np.testing.assert_allclose(
        color.srgb_to_linear(color.linear_to_srgb(x)), x, atol=1e-5)


def test_display_clamps():
    img = np.array([[[2.0, -1.0, 0.5]]], np.float32)
    out = to_display(img)
    assert out[0, 0, 0] == 255
    assert out[0, 0, 1] == 0


def test_metrics_identical_zero(hdr_image):
    img = np.clip(hdr_image, 0, 1)
    assert metrics.mse(img, img) == 0.0
    assert metrics.flip(img, img) == 0.0
    assert metrics.ssim(img, img) == pytest.approx(1.0)


def test_metrics_monotonic(hdr_image):
    img = np.clip(hdr_image, 0, 1)
    small = np.clip(img + 0.01, 0, 1)
    big = np.clip(img + 0.2, 0, 1)
    assert metrics.mse(img, small) < metrics.mse(img, big)
    f_small = metrics.flip(img, small)
    f_big = metrics.flip(img, big)
    assert 0.0 < f_small < f_big <= 1.0
    assert metrics.ssim(img, small) > metrics.ssim(img, big)


def test_flip_black_white_near_one():
    black = np.zeros((32, 32, 3))
    white = np.ones((32, 32, 3))
    f = metrics.flip(black, white)
    assert f > 0.9


def test_png_encoder_decodes(tmp_path, hdr_image):
    """The standard-library PNG encoder writes what a PNG decoder reads
    back exactly (flipped top-down, like the display)."""
    from PIL import Image
    png = str(tmp_path / "t.png")
    write_png(png, hdr_image)
    back = np.asarray(Image.open(png).convert("RGB"))
    np.testing.assert_array_equal(back, to_display(hdr_image)[::-1])


@pytest.mark.parametrize("src,res", [((128, 128), 256), ((300, 200), 256),
                                     ((256, 256), 100)])
def test_texture_resize_matches_pil(src, res):
    """flatten's numpy resample reproduces PIL's BILINEAR filter (which it
    replaced), up- and downscaling."""
    from PIL import Image
    from optixpathtracer_tpu.scene.flatten import _resize_texture
    px = np.random.default_rng(0).random(src + (4,)).astype(np.float32)
    ref = np.stack([np.asarray(Image.fromarray(px[..., c], mode="F").resize(
        (res, res), Image.BILINEAR)) for c in range(4)], axis=-1)
    np.testing.assert_allclose(_resize_texture(px, res), ref, atol=1e-6)
