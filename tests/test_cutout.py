"""Alpha-cutout tests: a textured quad with a transparent hole must let
radiance and shadow rays pass through the hole and block elsewhere
(reference anyhit semantics, `devicePrograms.cu:518-561`)."""
import jax.numpy as jnp
import numpy as np

from optixpathtracer_tpu.integrate.cutout import (intersect_any_cutout,
                                                  intersect_closest_cutout,
                                                  scene_uses_alpha_cutout)
from optixpathtracer_tpu.scene import (Material, Model, PointLight, Texture,
                                       flatten_model)
from optixpathtracer_tpu.scene.procedural import quad


def _cutout_scene():
    """A vertical quad at x=0 (filling y,z in [0,1]) whose texture alpha is
    0 in the center band v in [0.25, 0.75), plus an opaque floor."""
    tex = np.ones((64, 64, 4), np.float32)
    tex[16:48, :, 3] = 0.0  # transparent horizontal band (v axis = rows)
    wall_mat = Material(mat_type="diffuse", albedo_texture=0)
    wall = quad((0.0, 0.0, -1.0), (0.0, 0.0, 2.0), (0.0, 1.0, 0.0), wall_mat,
                "wall")
    floor = quad((-5.0, -0.5, -5.0), (0.0, 0.0, 10.0), (10.0, 0.0, 0.0),
                 Material(mat_type="diffuse"), "floor")
    model = Model(meshes=[wall, floor], textures=[Texture(pixels=tex)])
    return flatten_model(model, [PointLight(np.array([3.0, 0.5, 0.0]),
                                            np.ones(3))])


def test_scene_detects_cutout():
    scene = _cutout_scene()
    assert scene_uses_alpha_cutout(scene)


def test_radiance_ray_passes_through_hole():
    scene = _cutout_scene()
    # ray through the hole (v ~ 0.5 -> y ~ 0.5) continues to... nothing
    o = jnp.array([[2.0, 0.5, 0.0], [2.0, 0.1, 0.0]])
    d = jnp.array([[-1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    hit = intersect_closest_cutout(scene, o, d, 0.0, 100.0, method="brute")
    assert not bool(hit.hit[0])   # through the hole, nothing behind
    assert bool(hit.hit[1])       # opaque part of the wall blocks
    np.testing.assert_allclose(float(hit.t[1]), 2.0, atol=1e-4)


def test_shadow_ray_honors_cutout():
    scene = _cutout_scene()
    # light at +x; surface points at -x side of the wall
    light = np.array([3.0, 0.0, 0.0])
    o = jnp.array([[-1.0, 0.5, 0.0], [-1.0, 0.1, 0.0]])
    to_l = jnp.asarray(light) - o
    dist = jnp.linalg.norm(to_l, axis=-1)
    d = to_l / dist[:, None]
    blocked = intersect_any_cutout(scene, o, d, 0.0, dist, method="brute")
    assert not bool(blocked[0])   # sees the light through the hole
    assert bool(blocked[1])       # opaque band blocks


def test_plain_intersect_would_block():
    """Sanity: without cutout the wall blocks both rays."""
    from optixpathtracer_tpu.intersect import intersect_any
    scene = _cutout_scene()
    light = np.array([3.0, 0.0, 0.0])
    o = jnp.array([[-1.0, 0.5, 0.0]])
    to_l = jnp.asarray(light) - o
    dist = jnp.linalg.norm(to_l, axis=-1)
    d = to_l / dist[:, None]
    assert bool(intersect_any(scene, o, d, 0.0, dist, method="brute")[0])


def test_split_path_matches_legacy():
    """The flatten-time opaque/cutout split must reproduce the legacy
    full-scene chain exactly (this pins the property on the quad scene)."""
    scene = _cutout_scene()
    assert scene.opaque_scene is not None and scene.cutout_sub is not None
    legacy = scene._replace(opaque_scene=None, cutout_sub=None)
    o = jnp.array([[2.0, 0.5, 0.0], [2.0, 0.1, 0.0], [2.0, 0.9, 0.3]])
    d = jnp.array([[-1.0, 0.0, 0.0]] * 3)
    hs = intersect_closest_cutout(scene, o, d, 0.0, 100.0, method="brute")
    hl = intersect_closest_cutout(legacy, o, d, 0.0, 100.0, method="brute")
    np.testing.assert_array_equal(np.asarray(hs.hit), np.asarray(hl.hit))
    m = np.asarray(hl.hit)
    np.testing.assert_array_equal(np.asarray(hs.tri_id)[m],
                                  np.asarray(hl.tri_id)[m])
    np.testing.assert_allclose(np.asarray(hs.t)[m], np.asarray(hl.t)[m],
                               rtol=1e-6)
    bs = intersect_any_cutout(scene, o, d, 0.0, 100.0, method="brute")
    bl = intersect_any_cutout(legacy, o, d, 0.0, 100.0, method="brute")
    np.testing.assert_array_equal(np.asarray(bs), np.asarray(bl))
