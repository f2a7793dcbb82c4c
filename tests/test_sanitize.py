"""Sanitizer test mode (SURVEY.md section 5.2): the JAX analog of the
reference's OptiX validation mode ALL + CUDA_CHECK-everywhere
(`OptixRenderer.cpp:81-85`, `optix7.h:16-63`).

Runs the integrator smoke under `jax_debug_nans` (any primitive producing a
NaN raises immediately, pinpointing the op) and a checkify pass over the
camera/film math for out-of-bounds and NaN checks. Every intermediate in the
wavefront must be NaN-free by construction - the double-where guards in
core/math.py exist exactly for this; this lane keeps them honest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optixpathtracer_tpu.integrate.path import render_sample
from optixpathtracer_tpu.scene import flatten_model
from optixpathtracer_tpu.scene.flatten import scene_active_lobes
from optixpathtracer_tpu.scene.procedural import PRESETS


@pytest.fixture()
def debug_nans():
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("preset", ["scene3_cornell", "dielectric",
                                    "layered"])
def test_smoke_under_debug_nans(debug_nans, preset):
    """A small multi-bounce render of every lobe family must not produce a
    single NaN in any primitive output (jax_debug_nans raises if one does).
    """
    model, camera, lights = PRESETS[preset]()
    scene = flatten_model(model, lights)
    pos, iv, ip = camera.raygen_params(16, 16)
    img = render_sample(scene, pos, iv, ip, 16, 16, jnp.uint32(0),
                        max_bounces=2,
                        active_lobes=scene_active_lobes(scene))
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert img.max() > 0.0


def test_gradient_under_debug_nans(debug_nans):
    """Reverse-mode must also be NaN-free primitive-by-primitive (the
    backward half of the sanitizer obligation)."""
    model, camera, lights = PRESETS["scene3_cornell"]()
    scene = flatten_model(model, lights)
    pos, iv, ip = camera.raygen_params(8, 8)

    def loss(albedo):
        img = render_sample(scene._replace(mat_albedo=albedo), pos, iv, ip,
                            8, 8, jnp.uint32(0), max_bounces=1)
        return jnp.mean(img)

    g = jax.grad(loss)(scene.mat_albedo)
    assert np.isfinite(np.asarray(g)).all()


def test_checkify_camera_film_bounds():
    """checkify over the camera raygen + sRGB encode path: index and NaN
    checks instrumented and asserted clean."""
    from jax.experimental import checkify

    from optixpathtracer_tpu.camera.camera import generate_rays

    model, camera, lights = PRESETS["scene3_cornell"]()
    pos, iv, ip = camera.raygen_params(16, 16)

    def fn():
        o, d = generate_rays(pos, iv, ip, 16, 16)
        img = jnp.abs(d).reshape(16, 16, 3)
        # jnp sRGB transfer (film.color.linear_to_srgb is the numpy
        # film-side variant and can't be traced)
        return jnp.where(img <= 0.0031308, img * 12.92,
                         1.055 * jnp.clip(img, 0.0, None) ** (1 / 2.4)
                         - 0.055)

    checked = checkify.checkify(
        jax.jit(fn), errors=checkify.index_checks | checkify.nan_checks)
    err, out = checked()
    err.throw()  # raises if any instrumented check fired
    assert np.isfinite(np.asarray(out)).all()
