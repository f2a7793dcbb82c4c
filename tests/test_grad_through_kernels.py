"""Gradients around the traversal engines.

`intersect_any` once detached o/d/scene but not tmin/tmax, and the NEE
shadow_tmax carries material-parameter tangents from bounce 1 on
(surf.position <- refined hit <- BSDF-sampled direction <- mat.roughness).
pallas_call has no JVP rule, so a nonzero tangent reaching the kernel stops
the trace. Two layers of defense here:

1. `test_jvp_tangent_on_tmax_*`: jax.jvp of the API entry points with a
   tangent planted on tmin/tmax. The API must absorb it (stop_gradient):
   the traced program holds the kernel call once, primal only. Tracing
   needs no GPU.
2. `test_grad_through_engine`: jax.grad through the real training step
   (dist.material_grad_step) with each BVH engine forced - the kernel in
   Pallas interpret mode - proving gradients still reach the material
   table.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optixpathtracer_tpu.camera import Camera
from optixpathtracer_tpu.dist import make_mesh, material_grad_step
from optixpathtracer_tpu.intersect import api

from test_bvh_kernel import ENGINES, _make


@pytest.fixture(scope="module")
def scene_and_rays():
    return _make()


def _check_primal_only(jaxpr, engine):
    text = str(jaxpr)
    if engine == "bvh_kernel":
        # one kernel call, with no JVP or transpose of it
        assert text.count("pallas_call") == 1, text.count("pallas_call")
    else:
        assert "while" in text


@pytest.mark.parametrize("engine", ENGINES)
def test_jvp_tangent_on_tmax_any(scene_and_rays, engine):
    scene, o, d = scene_and_rays
    o, d = o[:64], d[:64]

    def f(tmax):
        blocked = api.intersect_any(scene, o, d, 0.0, tmax, method=engine)
        return jnp.sum(blocked.astype(jnp.float32))

    tmax = jnp.full((64,), 50.0)
    jaxpr = jax.make_jaxpr(
        lambda x: jax.jvp(f, (x,), (jnp.ones_like(x),)))(tmax)
    _check_primal_only(jaxpr, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_jvp_tangent_on_tmax_closest(scene_and_rays, engine):
    scene, o, d = scene_and_rays
    o, d = o[:64], d[:64]

    def f(tmax):
        hit = api.intersect_closest(scene, o, d, 0.0, tmax, method=engine)
        return jnp.sum(hit.t)

    tmax = jnp.asarray(50.0)
    jaxpr = jax.make_jaxpr(
        lambda x: jax.jvp(f, (x,), (jnp.ones_like(x),)))(tmax)
    _check_primal_only(jaxpr, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_grad_through_engine(scene_and_rays, engine):
    """jax.grad through the full training step with a BVH engine forced."""
    scene = scene_and_rays[0]
    camera = Camera(position=np.array([5.0, 2.5, 0.2]),
                    rotation=np.array([-5.0, -90.0, 0.0]))
    w = h = 8
    mesh = make_mesh(1)
    cam_params = camera.raygen_params(w, h)
    target = jnp.zeros((h, w, 3), jnp.float32)
    new_scene, loss = material_grad_step(
        mesh, scene, cam_params, target, w, h, jnp.uint32(0),
        max_bounces=2, intersect_method=engine)
    assert jnp.isfinite(loss)
    assert float(loss) > 0.0
    assert bool(jnp.any(new_scene.mat_albedo != scene.mat_albedo)), \
        "no gradient reached the material table"
