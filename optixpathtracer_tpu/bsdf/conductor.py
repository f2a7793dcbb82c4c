"""Rough/smooth conductor BRDF: Torrance-Sparrow with exact complex Fresnel.

JAX equivalent of reference `PBRT/Conductor.h:97-190`. The complex IOR
is derived from the (clamped) reflectance color: eta = 1, k = 2 sqrt(r)/
sqrt(1-r) (`Conductor.h:54-92`). Smooth surfaces (alpha < 1e-3) reduce to a
perfect mirror delta lobe.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import microfacet
from ..core.fresnel import fresnel_conductor
from ..core.math import (abs_cos_theta, abs_dot, length_sqr, normalize,
                         reflect, same_hemisphere, vec3)
from .base import (BSDFSample, is_effectively_smooth, roughness_to_alpha,
                   where_sample)


def f(reflectance, roughness, wo, wi):
    """Microfacet conductor BRDF D*F*G/(4 cos_i cos_o)
    (reference `Conductor.h:97-120`). Zero for smooth (delta) surfaces."""
    alpha = roughness_to_alpha(roughness)
    ct_o = abs_cos_theta(wo)
    ct_i = abs_cos_theta(wi)
    wm_raw = wi + wo
    degenerate = (length_sqr(wm_raw) == 0.0) | (ct_i == 0.0) | (ct_o == 0.0)
    wm = normalize(wm_raw)

    fr = fresnel_conductor(abs_dot(wo, wm), reflectance)
    denom = 4.0 * ct_i * ct_o
    scale = (microfacet.d(wm, alpha) * microfacet.smith_g(wo, wi, alpha)
             / jnp.where(denom == 0.0, 1.0, denom))
    val = scale[..., None] * fr

    ok = (same_hemisphere(wo, wi)
          & ~is_effectively_smooth(alpha)
          & ~degenerate)
    return jnp.where(ok[..., None], val, 0.0)


def sample(seed, reflectance, roughness, wo):
    """Sample the conductor BRDF (reference `Conductor.h:122-190`):
    perfect mirror when smooth; VNDF half-vector + reflect when rough."""
    shape = wo.shape[:-1]
    alpha = jnp.broadcast_to(roughness_to_alpha(roughness), shape)
    smooth = is_effectively_smooth(alpha)

    # --- smooth: delta mirror lobe (`Conductor.h:126-142`)
    wi_s = vec3(-wo[..., 0], -wo[..., 1], wo[..., 2])
    ct = abs_cos_theta(wi_s)
    f_s = fresnel_conductor(ct, reflectance) / jnp.where(ct == 0.0, 1.0, ct)[..., None]
    smooth_sample = BSDFSample(
        color=f_s, direction=wi_s, pdf=jnp.ones(shape, jnp.float32),
        valid=jnp.ones(shape, bool) & (ct > 0.0),
        reflection=jnp.ones(shape, bool), transmission=jnp.zeros(shape, bool),
        specular=jnp.ones(shape, bool), glossy=jnp.zeros(shape, bool))

    # --- rough: VNDF sample (`Conductor.h:145-189`)
    seed, wm = microfacet.sample_wm(seed, wo, alpha)
    wi_r = reflect(wo, wm)
    awm = abs_dot(wo, wm)
    pdf_r = microfacet.pdf(wo, wm, alpha) / jnp.where(awm == 0.0, 1.0, 4.0 * awm)
    ct_o = abs_cos_theta(wo)
    ct_i = abs_cos_theta(wi_r)
    fr = fresnel_conductor(awm, reflectance)
    denom = 4.0 * ct_i * ct_o
    f_r = (microfacet.d(wm, alpha) * microfacet.smith_g(wo, wi_r, alpha)
           / jnp.where(denom == 0.0, 1.0, denom))[..., None] * fr
    rough_valid = ((wo[..., 2] != 0.0) & same_hemisphere(wo, wi_r)
                   & (ct_i != 0.0) & (ct_o != 0.0) & (awm != 0.0))
    rough_sample = BSDFSample(
        color=f_r, direction=wi_r, pdf=pdf_r, valid=rough_valid,
        reflection=jnp.ones(shape, bool), transmission=jnp.zeros(shape, bool),
        specular=jnp.zeros(shape, bool), glossy=jnp.ones(shape, bool))

    return seed, where_sample(smooth, smooth_sample, rough_sample)


def pdf(roughness, wo, wi):
    """VNDF pdf for the rough lobe; 0 for smooth/invalid. (The reference has
    no standalone Conductor::PDF - this mirrors the pdf in Sample_f, needed
    by our MIS/chi-squared tests.)"""
    alpha = roughness_to_alpha(roughness)
    wm_raw = wo + wi
    ok = (same_hemisphere(wo, wi) & ~is_effectively_smooth(alpha)
          & (length_sqr(wm_raw) > 0.0))
    wm = normalize(wm_raw)
    awm = abs_dot(wo, wm)
    val = microfacet.pdf(wo, wm, alpha) / jnp.where(awm == 0.0, 1.0, 4.0 * awm)
    return jnp.where(ok, val, 0.0)
