"""Trowbridge-Reitz (GGX) microfacet distribution: NDF, Smith masking,
visible-NDF sampling.

JAX equivalent of reference `PBRT/Microfacet.h`. Fully vectorized and
mask-based: where the reference early-returns 0 on degenerate inputs
(`Microfacet.h:13-17`), we compute the same value with `where` selects so the
whole wavefront stays dense and differentiable.

Only the isotropic path is exercised by the reference renderer, but the
anisotropic forms are implemented (as in the reference) and the isotropic
entry points delegate to them with alpha = (a, a).
"""
from __future__ import annotations

import jax.numpy as jnp

from . import rng
from .math import (PI, abs_dot, abs_cos_theta, cos_phi, cos2_theta, cross,
                   length_sqr, normalize, sin_phi, sqr, tan2_theta, vec3)


def d_anisotropic(wm, alpha):
    """GGX NDF D(wm) (reference `Microfacet.h:9-20`). alpha: [..., 2].

    Numerical safety (all for lanes the callers mask out, which still leak
    NaN into reverse-mode if left unguarded - 0-cotangent times a NaN/inf
    partial is NaN):
      * alpha clamped to >= 1e-4: alpha == 0 (effectively-smooth lanes,
        cutoff 1e-3 per `Surface.h:22-24` - always masked by callers) makes
        the raw expression 0 * inf = NaN, and values below ~1e-6 overflow
        float32 in the tangents at grazing wm;
      * t2 masked where inf (the deliberate grazing-angle inf from
        tan2_theta) and clamped to <= 1e6 (theta_m ~ 89.94 deg, where D is
        ~0 for any real alpha) so d t2/d wm ~ 1/cos^4 cannot overflow the
        chain rule.
    """
    a0 = jnp.maximum(alpha[..., 0], 1e-4)
    a1 = jnp.maximum(alpha[..., 1], 1e-4)
    t2 = tan2_theta(wm)
    t2_ok = jnp.isfinite(t2)
    t2s = jnp.minimum(jnp.where(t2_ok, t2, 0.0), 1e6)
    cos4 = sqr(cos2_theta(wm))
    e = t2s * (sqr(cos_phi(wm) / a0) + sqr(sin_phi(wm) / a1))
    denom = PI * a0 * a1 * cos4 * sqr(1.0 + e)
    ok = t2_ok & (cos4 >= 1e-16) & jnp.isfinite(e)
    # inf*0 guards: only divide on valid lanes
    return jnp.where(ok, 1.0 / jnp.where(ok, denom, 1.0), 0.0)


def d(wm, alpha):
    """Isotropic NDF (reference `Microfacet.h:22-24`)."""
    a = jnp.broadcast_to(jnp.asarray(alpha, jnp.float32)[..., None],
                         wm.shape[:-1] + (2,))
    return d_anisotropic(wm, a)


def lambda_anisotropic(w, alpha):
    """Smith Lambda (reference `Microfacet.h:46-52`)."""
    t2 = tan2_theta(w)
    a2 = sqr(cos_phi(w) * alpha[..., 0]) + sqr(sin_phi(w) * alpha[..., 1])
    ok = jnp.isfinite(t2)
    val = (jnp.sqrt(1.0 + a2 * jnp.where(ok, t2, 0.0)) - 1.0) / 2.0
    return jnp.where(ok, val, 0.0)


def _iso_alpha2(w, alpha):
    a = jnp.broadcast_to(jnp.asarray(alpha, jnp.float32)[..., None],
                         w.shape[:-1] + (2,))
    return a


def smith_g(wo, wi, alpha):
    """Bidirectional Smith masking-shadowing G (reference `Microfacet.h:62-68`)."""
    a = _iso_alpha2(wo, alpha)
    return 1.0 / (1.0 + lambda_anisotropic(wo, a) + lambda_anisotropic(wi, a))


def smith_g1(w, alpha):
    """Unidirectional Smith G1 (reference `Microfacet.h:71-77`)."""
    a = _iso_alpha2(w, alpha)
    return 1.0 / (1.0 + lambda_anisotropic(w, a))


def d_visible(w, wm, alpha):
    """Visible-normal distribution D_w(wm) = G1(w)/|cos w| D(wm) |w.wm|
    (reference `Microfacet.h:81-84`)."""
    ct = abs_cos_theta(w)
    return (smith_g1(w, alpha) * d(wm, alpha) * abs_dot(w, wm)
            / jnp.where(ct == 0.0, 1.0, ct))


def pdf(w, wm, alpha):
    """VNDF sampling pdf == D_visible (reference `Microfacet.h:86-88`)."""
    return d_visible(w, wm, alpha)


def sample_wm(seed, w, alpha):
    """Sample a visible microfacet normal (VNDF, hemispherical warp)
    (reference `Microfacet.h:90-119`). Returns (seed, wm).

    alpha is DETACHED here (stop_gradient): this is the detached-sampling
    estimator (SURVEY.md section 7 stage 6) - sample locations don't carry
    parameter gradients; the BSDF value and pdf evaluated at the sampled wm
    keep their live alpha dependence, which yields unbiased material
    gradients without differentiating through the sampling warp.
    """
    import jax
    alpha = jax.lax.stop_gradient(alpha)
    a = jnp.broadcast_to(jnp.asarray(alpha, jnp.float32)[..., None],
                         w.shape[:-1] + (2,))
    # Transform w to hemispherical configuration
    wh = normalize(vec3(a[..., 0] * w[..., 0], a[..., 1] * w[..., 1], w[..., 2]))
    wh = jnp.where((wh[..., 2] < 0.0)[..., None], -wh, wh)

    # Orthonormal basis around wh
    z_axis = jnp.zeros_like(wh).at[..., 2].set(1.0)
    t1_general = normalize(cross(z_axis, wh))
    x_axis = jnp.zeros_like(wh).at[..., 0].set(1.0)
    t1 = jnp.where((wh[..., 2] < 0.99999)[..., None], t1_general, x_axis)
    t2 = cross(wh, t1)

    # Uniform disk point, warped for the visible hemisphere
    seed, p = rng.sample_uniform_disk_polar(seed)
    h = jnp.sqrt(jnp.maximum(0.0, 1.0 - sqr(p[..., 0])))
    lerp_t = (1.0 + wh[..., 2]) / 2.0
    py = (1.0 - lerp_t) * h + lerp_t * p[..., 1]
    p = jnp.stack([p[..., 0], py], axis=-1)

    pz = jnp.sqrt(jnp.maximum(0.0, 1.0 - length_sqr(p)))
    nh = (p[..., 0:1] * t1 + p[..., 1:2] * t2 + pz[..., None] * wh)
    wm = normalize(vec3(a[..., 0] * nh[..., 0], a[..., 1] * nh[..., 1],
                        jnp.maximum(1e-6, nh[..., 2])))
    return seed, wm
