"""Fresnel terms: exact complex-IOR conductor Fresnel and real dielectric
Fresnel with TIR, plus refraction.

JAX equivalents of reference `PBRT/Complex.h`, `PBRT/Conductor.h:42-92`
and `PBRT/Dielectric.h:20-92`. Complex arithmetic is expressed on (re, im)
pairs of jnp arrays - fully vectorized, differentiable, no Python branching.
"""
from __future__ import annotations

import jax.numpy as jnp

from .math import safe_sqrt, sqr, vec3


# ---------------------------------------------------------------------------
# Minimal complex arithmetic on (re, im) float pairs (reference Complex.h).
# jnp has native complex64; explicit pairs keep the vjp rules
# straightforward.
# ---------------------------------------------------------------------------

def _c_mul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _c_div(ar, ai, br, bi):
    scale = 1.0 / (br * br + bi * bi)
    return (ar * br + ai * bi) * scale, (ai * br - ar * bi) * scale


def _c_sqrt(ar, ai):
    """Principal complex sqrt (reference `Complex.h` sqrt)."""
    n = jnp.sqrt(ar * ar + ai * ai)
    t1 = jnp.sqrt(0.5 * (n + jnp.abs(ar)))
    t2 = 0.5 * ai / jnp.where(t1 == 0.0, 1.0, t1)
    re = jnp.where(ar >= 0.0, t1, jnp.abs(t2))
    im = jnp.where(ar >= 0.0, t2, jnp.where(ai >= 0.0, t1, -t1))
    # sqrt(0) == 0 (the n==0 lanes already give t1 = t2 = 0)
    return re, im


def _c_norm(ar, ai):
    return ar * ar + ai * ai


def fr_complex(cos_theta_i, eta_re, eta_im):
    """Exact Fresnel reflectance for complex IOR eta - i*k
    (reference `Conductor.h:42-52` FrComplex)."""
    ci = jnp.clip(cos_theta_i, 0.0, 1.0)
    sin2_i = 1.0 - sqr(ci)
    # sin2Theta_t = sin2Theta_i / eta^2
    e2r, e2i = _c_mul(eta_re, eta_im, eta_re, eta_im)
    s2t_r, s2t_i = _c_div(sin2_i, jnp.zeros_like(sin2_i), e2r, e2i)
    # cosTheta_t = sqrt(1 - sin2Theta_t)
    ct_r, ct_i = _c_sqrt(1.0 - s2t_r, -s2t_i)

    # r_parl = (eta*ci - ct) / (eta*ci + ct)
    eci_r, eci_i = eta_re * ci, eta_im * ci
    parl_r, parl_i = _c_div(eci_r - ct_r, eci_i - ct_i, eci_r + ct_r, eci_i + ct_i)
    # r_perp = (ci - eta*ct) / (ci + eta*ct)
    ect_r, ect_i = _c_mul(eta_re, eta_im, ct_r, ct_i)
    perp_r, perp_i = _c_div(ci - ect_r, -ect_i, ci + ect_r, ect_i)
    return 0.5 * (_c_norm(parl_r, parl_i) + _c_norm(perp_r, perp_i))


def conductor_eta_k(reflectance):
    """Reference's reflectance->complex-IOR mapping: eta = 1,
    k = 2 sqrt(r) / sqrt(1 - r) with r clamped to [0, 0.9999]
    (reference `Conductor.h:54-70`)."""
    r = jnp.clip(reflectance, 0.0, 0.9999)
    k = 2.0 * safe_sqrt(r) / safe_sqrt(jnp.maximum(1.0 - r, 0.0) + 1e-12)
    return jnp.ones_like(r), k


def fresnel_conductor(cos_theta_i, reflectance):
    """RGB conductor Fresnel from a reflectance color
    (reference `Conductor.h:54-92` FresnelComplex)."""
    eta, k = conductor_eta_k(reflectance)
    ci = cos_theta_i[..., None] if reflectance.ndim > cos_theta_i.ndim else cos_theta_i
    return fr_complex(ci, eta, k)


def fresnel_schlick(f0, mu):
    """Schlick approximation (reference `Conductor.h:13-15`)."""
    return f0 + (1.0 - f0) * (1.0 - mu) ** 5


def fresnel_82(specular_color, f0, abs_cos_theta):
    """OpenPBR F82 conductor tint (reference `Conductor.h:26-40`)."""
    mu = abs_cos_theta
    mu_bar = 1.0 / 7.0
    f_mu = fresnel_schlick(f0, mu)
    f_mu_bar = fresnel_schlick(f0, mu_bar)
    middle = mu * (1.0 - mu) ** 6 / (mu_bar * (1.0 - mu_bar) ** 6)
    return f_mu - middle * (f_mu_bar - specular_color * f_mu_bar)


def fresnel_dielectric(cos_theta_i, ior=1.5):
    """Real dielectric Fresnel with orientation flip and TIR -> 1
    (reference `Dielectric.h:20-42`)."""
    ci = jnp.clip(cos_theta_i, -1.0, 1.0)
    ior = jnp.asarray(ior, jnp.float32)
    # Flip interface orientation when hitting from inside.
    eta = jnp.where(ci < 0.0, 1.0 / ior, ior)
    ci = jnp.abs(ci)

    sin2_i = 1.0 - sqr(ci)
    sin2_t = sin2_i / sqr(eta)
    tir = sin2_t >= 1.0
    ct = safe_sqrt(1.0 - jnp.minimum(sin2_t, 1.0))

    # Guarded divisions: at grazing incidence with TIR both terms of a
    # denominator can be 0; the forward value is masked by `tir` below but
    # an unguarded 0/0 would still NaN the backward pass.
    den_parl = eta * ci + ct
    den_perp = ci + eta * ct
    r_parl = (eta * ci - ct) / jnp.where(den_parl == 0.0, 1.0, den_parl)
    r_perp = (ci - eta * ct) / jnp.where(den_perp == 0.0, 1.0, den_perp)
    fr = 0.5 * (sqr(r_parl) + sqr(r_perp))
    return jnp.where(tir, 1.0, fr)


def refract(wi, n, eta):
    """Snell refraction with orientation flip (reference `Dielectric.h:68-92`).

    Returns (valid, etap, wt): valid=False marks total internal reflection;
    etap is the relative IOR along the ray; wt the refracted direction.
    All lanes compute; invalid lanes return wt = 0.
    """
    eta = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), wi.shape[:-1])
    ci = jnp.sum(n * wi, axis=-1)
    flip = ci < 0.0
    eta_eff = jnp.where(flip, 1.0 / eta, eta)
    ci = jnp.abs(ci)
    n_eff = jnp.where(flip[..., None], -n, n)

    sin2_i = jnp.maximum(0.0, 1.0 - sqr(ci))
    sin2_t = sin2_i / sqr(eta_eff)
    valid = sin2_t < 1.0
    ct = safe_sqrt(1.0 - jnp.minimum(sin2_t, 1.0))

    wt = (-wi / eta_eff[..., None]
          + (ci / eta_eff - ct)[..., None] * n_eff)
    wt = jnp.where(valid[..., None], wt, 0.0)
    return valid, eta_eff, wt
