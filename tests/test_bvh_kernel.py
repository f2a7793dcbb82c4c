"""The BVH traversal engines against the brute-force oracle.

`bvh` is the vmapped while-loop walk (intersect/bvh_traverse.py); `bvh_kernel`
is the Pallas kernel for the GPU (intersect/bvh_kernel.py), run here in
Pallas interpret mode. The `gpu` tests compile it for the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optixpathtracer_tpu.camera import Camera
from optixpathtracer_tpu.camera.camera import generate_rays
from optixpathtracer_tpu.intersect import api, brute, bvh_kernel
from optixpathtracer_tpu.scene import Material, Model, PointLight, flatten_model
from optixpathtracer_tpu.scene.procedural import quad, uv_sphere

ENGINES = ["bvh", "bvh_kernel"]


def _make(n_spheres_side=2, segs=6):
    """A grid of spheres over a floor (~n^3 * 2*segs^2 tris): a BVH with
    real depth, and rays that both hit and miss."""
    mat = Material(mat_type="diffuse")
    meshes = [quad((-6.0, 0.0, -6.0), (0.0, 0.0, 12.0), (12.0, 0.0, 0.0),
                   mat)]
    k = n_spheres_side
    for i in range(k):
        for j in range(k):
            for l in range(k):
                c = (np.array([i, j, l], np.float64) - (k - 1) / 2) * 1.2
                c[1] += 2.0
                meshes.append(uv_sphere(0.4, tuple(c), segs, 2 * segs, mat,
                                        name=f"s{i}{j}{l}"))
    scene = flatten_model(Model(meshes=meshes),
                          [PointLight(np.array([2.0, 5.0, 1.0]),
                                      np.ones(3))])
    cam = Camera(position=np.array([5.0, 2.5, 0.2]),
                 rotation=np.array([-5.0, -90.0, 0.0]))
    pos, iv, ip = cam.raygen_params(40, 24)
    o, d = generate_rays(pos, iv, ip, 40, 24)
    return scene, o.reshape(-1, 3), d.reshape(-1, 3)


@pytest.fixture(scope="module")
def scene_and_rays():
    return _make()


def _closest(engine, scene, o, d, tmin=0.0, tmax=100.0):
    return api._engine(engine).intersect_closest(scene, o, d, tmin, tmax)


def _any(engine, scene, o, d, tmin=0.0, tmax=100.0):
    return api._engine(engine).intersect_any(scene, o, d, tmin, tmax)


def test_scene_has_depth(scene_and_rays):
    scene, _, _ = scene_and_rays
    assert scene.bvh_min.shape[0] > 64
    assert int(np.asarray(scene.bvh_count).max()) > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_closest_matches_oracle(scene_and_rays, engine):
    scene, o, d = scene_and_rays
    expect = brute.intersect_closest(scene, o, d, 0.0, 100.0)
    got = _closest(engine, scene, o, d)
    m = np.asarray(expect.hit)
    assert m.any() and not m.all()
    np.testing.assert_array_equal(m, np.asarray(got.hit))
    np.testing.assert_array_equal(np.asarray(expect.tri_id)[m],
                                  np.asarray(got.tri_id)[m])
    np.testing.assert_allclose(np.asarray(expect.t)[m],
                               np.asarray(got.t)[m], rtol=1e-5)
    # a miss reports t = tmax and tri_id = -1
    np.testing.assert_array_equal(np.asarray(got.tri_id)[~m], -1)
    np.testing.assert_array_equal(np.asarray(got.t)[~m], 100.0)


@pytest.mark.parametrize("engine", ENGINES)
def test_any_matches_oracle(scene_and_rays, engine):
    scene, o, d = scene_and_rays
    expect = brute.intersect_any(scene, o, d, 0.0, 100.0)
    got = _any(engine, scene, o, d)
    np.testing.assert_array_equal(np.asarray(expect), np.asarray(got))


@pytest.mark.parametrize("engine", ENGINES)
def test_any_offset_rays(scene_and_rays, engine):
    """Shadow-style rays: origins on surfaces, random directions."""
    scene, o, d = scene_and_rays
    hit = brute.intersect_closest(scene, o, d, 0.0, 100.0)
    m = np.asarray(hit.hit)
    origins = np.asarray(o)[m] + np.asarray(hit.t[m, None] * d[m])
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=origins.shape).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = origins.astype(np.float32) + 1e-3 * dirs
    expect = brute.intersect_any(scene, origins, dirs, 0.0, 10.0)
    got = _any(engine, scene, jnp.asarray(origins), jnp.asarray(dirs),
               0.0, 10.0)
    np.testing.assert_array_equal(np.asarray(expect), np.asarray(got))


@pytest.mark.parametrize("engine", ENGINES)
def test_tmax_respected(scene_and_rays, engine):
    scene, o, d = scene_and_rays
    far = _closest(engine, scene, o, d, 0.0, 100.0)
    cut = float(np.median(np.asarray(far.t)[np.asarray(far.hit)]))
    near = _closest(engine, scene, o, d, 0.0, cut)
    assert (np.asarray(near.hit) <= np.asarray(far.hit)).all()
    assert 0 < np.asarray(near.hit).sum() < np.asarray(far.hit).sum()
    got_t = np.asarray(near.t)[np.asarray(near.hit)]
    assert (got_t < cut).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_tmin_respected(scene_and_rays, engine):
    """Per-ray tmin skips the first surface: the answer is the brute
    oracle's with the same bounds (the cutout re-entry pattern)."""
    scene, o, d = scene_and_rays
    first = brute.intersect_closest(scene, o, d, 0.0, 100.0)
    tmin = jnp.where(first.hit, first.t + 1e-3, 0.0)
    expect = brute.intersect_closest(scene, o, d, tmin, 100.0)
    got = _closest(engine, scene, o, d, tmin, 100.0)
    m = np.asarray(expect.hit)
    np.testing.assert_array_equal(m, np.asarray(got.hit))
    np.testing.assert_array_equal(np.asarray(expect.tri_id)[m],
                                  np.asarray(got.tri_id)[m])
    assert (np.asarray(got.t)[m] > np.asarray(tmin)[m]).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_dead_lanes_miss(scene_and_rays, engine):
    """tmax = -1 (integrate/path.py's dead lanes) never hits."""
    scene, o, d = scene_and_rays
    r = o.shape[0]
    tmax = jnp.where(jnp.arange(r) % 2 == 0, -1.0, 100.0)
    got = _closest(engine, scene, o, d, 0.0, tmax)
    blocked = _any(engine, scene, o, d, 0.0, tmax)
    dead = np.arange(r) % 2 == 0
    assert not np.asarray(got.hit)[dead].any()
    assert not np.asarray(blocked)[dead].any()
    assert np.asarray(got.hit)[~dead].any()


@pytest.mark.parametrize("engine", ENGINES)
def test_api_refines_barycentrics(scene_and_rays, engine):
    """The engine reports (t, tri_id); api._refine recomputes u, v and the
    back face from the id."""
    scene, o, d = scene_and_rays
    got = api.intersect_closest(scene, o, d, method=engine)
    expect = brute.intersect_closest(scene, o, d, 0.0, 100.0)
    m = np.asarray(expect.hit)
    np.testing.assert_array_equal(m, np.asarray(got.hit))
    np.testing.assert_allclose(np.asarray(expect.u)[m],
                               np.asarray(got.u)[m], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(expect.back_face)[m],
                                  np.asarray(got.back_face)[m])


@pytest.mark.parametrize("n_rays", [1, 37, 64])
def test_kernel_ray_count_padding(scene_and_rays, n_rays):
    """Ray counts that are not a whole number of BLOCKs are padded with
    dead rays and cut back."""
    scene, o, d = scene_and_rays
    o, d = o[:n_rays], d[:n_rays]
    got = bvh_kernel.intersect_closest(scene, o, d, 0.0, 100.0)
    expect = brute.intersect_closest(scene, o, d, 0.0, 100.0)
    assert got.t.shape == (n_rays,) and got.tri_id.shape == (n_rays,)
    assert got.t.dtype == jnp.float32 and got.tri_id.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(expect.tri_id),
                                  np.asarray(got.tri_id))


def test_pack_rays_layout():
    o = jnp.arange(3 * 37, dtype=jnp.float32).reshape(37, 3)
    d = -o
    rays = bvh_kernel.pack_rays(o, d, 0.5, jnp.full((37,), 7.0))
    assert rays.shape == (8, 64) and rays.dtype == jnp.float32
    np.testing.assert_array_equal(rays[0:3, :37], np.asarray(o).T)
    np.testing.assert_array_equal(rays[3:6, :37], np.asarray(d).T)
    np.testing.assert_array_equal(rays[6, :37], 0.5)
    np.testing.assert_array_equal(rays[7, :37], 7.0)
    np.testing.assert_array_equal(rays[7, 37:], -1.0)  # dead padding


def test_pack_scene_layout(scene_and_rays):
    scene, _, _ = scene_and_rays
    box, links, tris = bvh_kernel.pack_scene(scene)
    n, t = scene.bvh_min.shape[0], scene.tri_v0.shape[0]
    assert box.shape == (n * bvh_kernel.NODE_F,)
    assert links.shape == (n * bvh_kernel.NODE_I,)
    assert tris.shape == (t * bvh_kernel.TRI_F,)
    node = 5
    np.testing.assert_array_equal(
        box[node * 8:node * 8 + 6],
        np.concatenate([scene.bvh_min[node], scene.bvh_max[node]]))
    np.testing.assert_array_equal(
        links[node * 4:node * 4 + 3],
        [scene.bvh_skip[node], scene.bvh_first[node],
         scene.bvh_count[node]])
    # padding triangles carry zero edges, so they can never pass the test
    pad = np.flatnonzero(~np.asarray(scene.tri_valid))
    assert pad.size
    rows = np.asarray(tris).reshape(t, 9)[pad]
    np.testing.assert_array_equal(rows[:, 3:], 0.0)


def test_kernel_under_shard_map(scene_and_rays):
    """The kernel call runs per shard of a ray-sharded mesh."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from optixpathtracer_tpu.dist import make_mesh
    scene, o, d = scene_and_rays
    mesh = make_mesh(2)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("tiles"),
                                                  P("tiles")),
             out_specs=P("tiles"), check_vma=False)
    def ids(s, o, d):
        return bvh_kernel.intersect_closest(s, o, d, 0.0, 100.0).tri_id

    got = jax.jit(ids)(scene, o, d)
    expect = brute.intersect_closest(scene, o, d, 0.0, 100.0).tri_id
    np.testing.assert_array_equal(np.asarray(expect), np.asarray(got))


@pytest.mark.parametrize("backend,n_tris,expect", [
    ("cpu", 40, "brute"),
    ("cpu", 20000, "bvh"),
    ("gpu", 2048, "brute"),
    ("gpu", 20000, "bvh_kernel"),
])
def test_auto_route(monkeypatch, backend, n_tris, expect):
    class S:
        tri_v0 = np.zeros((n_tris, 3), np.float32)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert api._resolve("auto", S) == expect


def test_route_rejects_unknown_method():
    class S:
        tri_v0 = np.zeros((8, 3), np.float32)
    assert api._resolve("bvh", S) == "bvh"
    with pytest.raises(ValueError, match="unknown intersect method"):
        api._resolve("walk", S)


def test_kernel_refuses_other_backends(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bvh_kernel._interpret()


@pytest.mark.gpu
def test_kernel_on_gpu_matches_oracle(gpu_device, scene_and_rays):
    """Compiled through Triton for the card (no interpret mode)."""
    scene, o, d = scene_and_rays
    with jax.default_device(gpu_device):
        assert not bvh_kernel._interpret()
        got = jax.jit(bvh_kernel.intersect_closest)(scene, o, d, 0.0, 100.0)
        blocked = jax.jit(bvh_kernel.intersect_any)(scene, o, d, 0.0, 100.0)
    expect = brute.intersect_closest(scene, o, d, 0.0, 100.0)
    m = np.asarray(expect.hit)
    np.testing.assert_array_equal(m, np.asarray(got.hit))
    np.testing.assert_array_equal(np.asarray(expect.tri_id)[m],
                                  np.asarray(got.tri_id)[m])
    np.testing.assert_array_equal(
        np.asarray(brute.intersect_any(scene, o, d, 0.0, 100.0)),
        np.asarray(blocked))
