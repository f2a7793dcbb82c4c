"""Cross-engine image regression (SURVEY.md section 4 rung 3): the same
scene rendered through every intersection engine must produce
(near-)identical images, so engine changes cannot silently shift renders.
brute is the oracle; the BVH kernel runs in Pallas interpret mode on CPU.
The scene's BVH has real depth, so traversal is exercised."""
import numpy as np
import pytest

from optixpathtracer_tpu.camera import Camera
from optixpathtracer_tpu.integrate import render

from test_bvh_kernel import ENGINES, _make


@pytest.fixture(scope="module")
def scene_and_camera():
    scene, _, _ = _make()
    camera = Camera(position=np.array([5.0, 2.5, 0.2]),
                    rotation=np.array([-5.0, -90.0, 0.0]))
    return scene, camera


@pytest.fixture(scope="module")
def oracle_image(scene_and_camera):
    scene, camera = scene_and_camera
    return np.asarray(render(scene, camera, 32, 32, spp=1, max_bounces=2,
                             intersect_method="brute"))


@pytest.mark.parametrize("method", ENGINES)
def test_engine_renders_match_oracle(scene_and_camera, oracle_image,
                                     method):
    scene, camera = scene_and_camera
    img = np.asarray(render(scene, camera, 32, 32, spp=1,
                            max_bounces=2, intersect_method=method))
    # identical hit ids + identical RNG -> images should match to float
    # rounding; a handful of knife-edge pixels may flip between engines
    close = np.isclose(img, oracle_image, atol=1e-5, rtol=1e-4).all(axis=-1)
    assert close.mean() > 0.995, (
        f"{method}: only {close.mean():.4f} of pixels match the brute "
        "oracle render")
    np.testing.assert_allclose(img.mean(), oracle_image.mean(), rtol=1e-3)
