"""Float32 products that a GPU could run in TF32 (about 3 decimal digits)
are pinned to full precision: ray directions and the replayed vertex
offsets must not depend on the backend's default matmul precision."""
import jax
import numpy as np

from optixpathtracer_tpu.camera import Camera
from optixpathtracer_tpu.camera.camera import generate_rays


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                out += _dot_precisions(sub)
    return out


def _is_highest(p):
    return p is not None and all(
        x == jax.lax.Precision.HIGHEST for x in (p if isinstance(p, tuple)
                                                 else (p,)))


def test_raygen_products_pinned():
    pos, iv, ip = Camera(position=np.array([0.0, 1.0, 4.0])).raygen_params(
        8, 6)
    jaxpr = jax.make_jaxpr(
        lambda a, b, c: generate_rays(a, b, c, 8, 6))(pos, iv, ip).jaxpr
    precisions = _dot_precisions(jaxpr)
    assert len(precisions) == 2, precisions
    assert all(_is_highest(p) for p in precisions), precisions


def test_replay_jacobian_pinned():
    from optixpathtracer_tpu.diff.replay import MaterialTestReplay
    replay = MaterialTestReplay("diffuse", segments=(4, 8))
    params = replay.init_params()
    jaxpr = jax.make_jaxpr(lambda p: replay.scene_with(p).tri_v0)(
        params).jaxpr
    precisions = _dot_precisions(jaxpr)
    assert precisions and all(_is_highest(p) for p in precisions), \
        precisions
    # and the replay at the initial parameters reproduces the scene
    np.testing.assert_allclose(
        np.asarray(replay.scene_with(params).tri_v0)[
            np.asarray(replay.scene0.tri_valid)],
        np.asarray(replay.scene0.tri_v0)[np.asarray(replay.scene0.tri_valid)],
        atol=1e-5)
