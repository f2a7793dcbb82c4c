"""Core math helpers: safe elementwise ops and spherical geometry.

Vectorized re-design of the reference's math layer
(`source/Renderer/OptiX/glmCUDA.h:8-129` safe ops,
`source/Renderer/OptiX/PBRT/SphericalGeometry.h:8-35` spherical geometry).
Everything here operates on jnp arrays with a trailing component axis so the
same code runs scalar, per-ray, or per-wavefront under vmap/jit.

Conventions
-----------
* Vectors are arrays whose last axis has size 3 (or 2 for 2D points).
* The local shading frame has the surface normal at +z = (0, 0, 1), exactly
  as the reference's PBRT-derived BSDF layer assumes.
* All functions are pure and differentiable; divisions/sqrt are guarded so
  gradients don't produce NaNs at removable singularities.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

INV_PI = 0.31830988618379067154
PI = 3.14159265358979323846
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961


def sqr(x):
    """x^2 (reference `glmCUDA.h` Sqr)."""
    return x * x


def dot(a, b):
    """Vector dot product over the trailing axis."""
    return jnp.sum(a * b, axis=-1)


def abs_dot(a, b):
    """|a . b| (reference `glmCUDA.h` AbsDot)."""
    return jnp.abs(dot(a, b))


def length_sqr(v):
    """Squared vector length (reference `glmCUDA.h` LengthSqr)."""
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_sqr(v))


def safe_sqrt(x):
    """sqrt clamped to 0 below, with ZERO gradient at x <= 0.

    A bare sqrt(max(x, 0)) still has d/dx = inf at exactly 0, and masked
    lanes then poison reverse-mode with 0 * inf = NaN (the standard
    where-trap); guarding the input on both sides kills that path."""
    ok = x > 0.0
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, x, 1.0)), 0.0)


def safe_div(num, den, eps: float = 0.0):
    """num/den with 0 where den == 0 (and NaN-free gradients).

    The `where` on both sides of the division keeps the backward pass from
    producing inf * 0 = NaN at masked-out lanes - the standard JAX
    double-where trick.
    """
    den_ok = den != 0.0 if eps == 0.0 else jnp.abs(den) > eps
    safe_den = jnp.where(den_ok, den, 1.0)
    return jnp.where(den_ok, num / safe_den, 0.0)


def normalize(v, eps: float = 1e-20):
    """v / |v|, returning 0 for zero-length vectors (gradient-safe)."""
    len2 = length_sqr(v)
    ok = len2 > eps
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, len2, 1.0)), 0.0)
    return v * inv[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def face_forward(v, ref):
    """Flip v so it lies in the same hemisphere as ref."""
    s = jnp.sign(dot(v, ref))
    s = jnp.where(s == 0.0, 1.0, s)
    return v * s[..., None]


def reflect(wo, n):
    """PBRT-style reflect: both wo and result point away from the surface
    (reference `Conductor.h:154-156`)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def vec3(x, y, z):
    """Stack components into a trailing-axis-3 vector."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def splat3(s):
    """Broadcast a scalar array to a 3-vector."""
    s = jnp.asarray(s, jnp.float32)
    return jnp.broadcast_to(s[..., None], s.shape + (3,))


# ---------------------------------------------------------------------------
# Spherical geometry in the local shading frame (normal = +z).
# Mirrors reference `PBRT/SphericalGeometry.h`.
# ---------------------------------------------------------------------------

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return sqr(w[..., 2])


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def sin_theta(w):
    # safe_sqrt, not sqrt: at w == (0,0,1) (every smooth-sampled microfacet
    # normal) sin2 == 0 exactly and d sqrt/dx = inf there, which poisons
    # reverse-mode through masked consumers (sin_phi/cos_phi) as 0 * inf.
    return safe_sqrt(sin2_theta(w))


def tan_theta(w):
    return safe_div(sin_theta(w), cos_theta(w))


def tan2_theta(w):
    """sin^2/cos^2; yields +inf where cos == 0 like the reference does.

    The reference checks `isinf(tan2Theta)` (`Microfacet.h:13`); we reproduce
    the inf so downstream code can mask identically, but guard the gradient.
    """
    c2 = cos2_theta(w)
    s2 = sin2_theta(w)
    safe = jnp.where(c2 > 0.0, c2, 1.0)
    return jnp.where(c2 > 0.0, s2 / safe, jnp.inf)


def cos_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 1.0, jnp.clip(safe_div(w[..., 0], st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 0.0, jnp.clip(safe_div(w[..., 1], st), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def spherical_direction(sin_t, cos_t, phi):
    """(sinT cosPhi, sinT sinPhi, cosT) (reference `SphericalGeometry.h`)."""
    return vec3(sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t)


# ---------------------------------------------------------------------------
# Orthonormal frames.
# ---------------------------------------------------------------------------

def coordinate_system(v1):
    """Branchless orthonormal basis from one unit vector (Duff et al. 2017).

    Mirrors reference `GlossyDiffuse.h:32-38` CoordinateSystem.
    Returns (v2, v3) with [v2, v3, v1] right-handed orthonormal.
    """
    z = v1[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = v1[..., 0] * v1[..., 1] * a
    v2 = vec3(1.0 + sign * sqr(v1[..., 0]) * a, sign * b, -sign * v1[..., 0])
    v3 = vec3(b, sign + sqr(v1[..., 1]) * a, -v1[..., 1])
    return v2, v3


def build_tangent_space(n):
    """The reference's tangent-frame construction (`devicePrograms.cu:168-184`
    BuildTangentSpace): pick the longer of n x (0,0,1) and n x (0,1,0) as the
    tangent, bitangent = tangent x n.

    Returns (tangent, bitangent). Reproduced exactly (not the branchless
    version above) because the frame orientation affects anisotropic-free but
    RNG-correlated sampling parity with reference renders.
    """
    c1 = cross(n, jnp.array([0.0, 0.0, 1.0], jnp.float32))
    c2 = cross(n, jnp.array([0.0, 1.0, 0.0], jnp.float32))
    use_c1 = (length_sqr(c1) > length_sqr(c2))[..., None]
    t = normalize(jnp.where(use_c1, c1, c2))
    b = cross(t, n)
    return t, b


def to_local(t, b, n, v_world):
    """World -> shading space (rows are the frame axes: transpose of TBN)."""
    return vec3(dot(v_world, t), dot(v_world, b), dot(v_world, n))


def to_world(t, b, n, v_local):
    """Shading -> world space (TBN columns)."""
    return (v_local[..., 0:1] * t + v_local[..., 1:2] * b
            + v_local[..., 2:3] * n)


def from_z_frame(z_axis, v_local):
    """Transform v_local out of a frame whose +z is z_axis
    (reference `GlossyDiffuse.h:40-44` FromZ + FromLocal)."""
    x_axis, y_axis = coordinate_system(z_axis)
    return (v_local[..., 0:1] * x_axis + v_local[..., 1:2] * y_axis
            + v_local[..., 2:3] * z_axis)
