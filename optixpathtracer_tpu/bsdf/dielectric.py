"""Smooth + rough dielectric BSDF (reflection and transmission).

JAX equivalent of reference `PBRT/Dielectric.h`. The reference
hard-codes IOR 1.5 (`Dielectric.h:97,147,291`); here eta is a traced
parameter defaulting to 1.5 so gradients flow to it (BASELINE.md target),
with the same default behavior.

Transport mode: 'radiance' divides transmitted throughput by eta_rel^2
(`Dielectric.h:134-135,198-199,271-273`); 'importance' does not. We pass it
as a boolean `radiance_mode` so it stays trace-friendly.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import microfacet, rng
from ..core.fresnel import fresnel_dielectric, refract
from ..core.math import (abs_cos_theta, abs_dot, cos_theta, dot, length_sqr,
                         normalize, same_hemisphere, splat3, sqr, vec3)
from .base import (BSDFSample, is_effectively_smooth, roughness_to_alpha,
                   where_sample)

DEFAULT_IOR = 1.5


def _generalized_half_vector(wo, wi, eta):
    """wm = wi*etap + wo face-forwarded to +z, with validity mask
    (reference `Dielectric.h:104-122`)."""
    ct_o = cos_theta(wo)
    ct_i = cos_theta(wi)
    is_reflect = ct_i * ct_o > 0.0
    etap = jnp.where(is_reflect, 1.0,
                     jnp.where(ct_o > 0.0, eta, 1.0 / eta))
    wm_raw = wi * etap[..., None] + wo
    degenerate = (ct_i == 0.0) | (ct_o == 0.0) | (length_sqr(wm_raw) == 0.0)
    wm = normalize(wm_raw)
    wm = jnp.where((wm[..., 2] < 0.0)[..., None], -wm, wm)
    backfacing = (dot(wm, wi) * ct_i < 0.0) | (dot(wm, wo) * ct_o < 0.0)
    valid = ~degenerate & ~backfacing
    return wm, etap, is_reflect, valid


def f(roughness, wo, wi, eta=DEFAULT_IOR, radiance_mode=True):
    """Rough dielectric BSDF eval (reference `Dielectric.h:96-139`).
    Returns 0 for smooth surfaces (delta lobes)."""
    eta = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), wo.shape[:-1])
    alpha = roughness_to_alpha(roughness)
    wm, etap, is_reflect, valid = _generalized_half_vector(wo, wi, eta)
    ct_o = cos_theta(wo)
    ct_i = cos_theta(wi)

    fr = fresnel_dielectric(dot(wo, wm), eta)
    d_val = microfacet.d(wm, alpha)
    g_val = microfacet.smith_g(wo, wi, alpha)

    # reflection branch
    denom_r = jnp.abs(4.0 * ct_i * ct_o)
    f_reflect = d_val * g_val * fr / jnp.where(denom_r == 0.0, 1.0, denom_r)

    # transmission branch
    denom_t = sqr(dot(wi, wm) + dot(wo, wm) / etap) * ct_i * ct_o
    ft = (d_val * (1.0 - fr) * g_val
          * jnp.abs(dot(wi, wm) * dot(wo, wm)
                    / jnp.where(denom_t == 0.0, 1.0, denom_t)))
    ft = jnp.where(jnp.asarray(radiance_mode), ft / sqr(etap), ft)

    val = jnp.where(is_reflect, f_reflect, ft)
    ok = valid & ~is_effectively_smooth(alpha) & (eta != 1.0) & (denom_t != 0.0)
    return splat3(jnp.where(ok, val, 0.0))


def sample(seed, roughness, wo, eta=DEFAULT_IOR, radiance_mode=True,
           reflection=True, transmission=True):
    """Sample the dielectric BSDF (reference `Dielectric.h:146-288`)."""
    shape = wo.shape[:-1]
    eta = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), shape)
    alpha = jnp.broadcast_to(roughness_to_alpha(roughness), shape)
    smooth = is_effectively_smooth(alpha) | (eta == 1.0)
    radiance_mode = jnp.asarray(radiance_mode)
    refl_on = jnp.broadcast_to(jnp.asarray(reflection), shape)
    trans_on = jnp.broadcast_to(jnp.asarray(transmission), shape)

    seed, uc = rng.rnd(seed)

    true_ = jnp.ones(shape, bool)
    false_ = jnp.zeros(shape, bool)

    # ------------------------------------------------------------------
    # Smooth (delta) case (`Dielectric.h:151-214`)
    # ------------------------------------------------------------------
    r_s = fresnel_dielectric(cos_theta(wo), eta)
    t_s = 1.0 - r_s
    pr_s = jnp.where(refl_on, r_s, 0.0)
    pt_s = jnp.where(trans_on, t_s, 0.0)
    psum_s = pr_s + pt_s
    any_s = psum_s > 0.0
    choose_r_s = uc < pr_s / jnp.where(any_s, psum_s, 1.0)

    wi_sr = vec3(-wo[..., 0], -wo[..., 1], wo[..., 2])
    ct_sr = abs_cos_theta(wi_sr)
    fr_sr = r_s / jnp.where(ct_sr == 0.0, 1.0, ct_sr)
    samp_sr = BSDFSample(
        color=splat3(fr_sr), direction=wi_sr,
        pdf=pr_s / jnp.where(any_s, psum_s, 1.0),
        valid=any_s, reflection=true_, transmission=false_,
        specular=true_, glossy=false_)

    z_up = jnp.zeros_like(wo).at[..., 2].set(1.0)
    valid_t, etap_s, wi_st = refract(wo, z_up, eta)
    ct_st = abs_cos_theta(wi_st)
    ft_s = t_s / jnp.where(ct_st == 0.0, 1.0, ct_st)
    ft_s = jnp.where(radiance_mode, ft_s / sqr(etap_s), ft_s)
    samp_st = BSDFSample(
        color=splat3(ft_s), direction=wi_st,
        pdf=pt_s / jnp.where(any_s, psum_s, 1.0),
        valid=any_s & valid_t, reflection=false_, transmission=true_,
        specular=true_, glossy=false_)
    smooth_sample = where_sample(choose_r_s, samp_sr, samp_st)

    # ------------------------------------------------------------------
    # Rough case (`Dielectric.h:215-287`)
    # ------------------------------------------------------------------
    seed, wm = microfacet.sample_wm(seed, wo, alpha)
    r_r = fresnel_dielectric(dot(wo, wm), eta)
    t_r = 1.0 - r_r
    pr_r = jnp.where(refl_on, r_r, 0.0)
    pt_r = jnp.where(trans_on, t_r, 0.0)
    psum_r = pr_r + pt_r
    any_r = psum_r > 0.0
    choose_r_r = uc < pr_r / jnp.where(any_r, psum_r, 1.0)

    d_val = microfacet.d(wm, alpha)
    vndf = microfacet.pdf(wo, wm, alpha)

    # rough reflection
    wi_rr = -wo + 2.0 * dot(wo, wm)[..., None] * wm
    awm = abs_dot(wo, wm)
    pdf_rr = (vndf / jnp.where(awm == 0.0, 1.0, 4.0 * awm)
              * pr_r / jnp.where(any_r, psum_r, 1.0))
    denom_rr = 4.0 * cos_theta(wi_rr) * cos_theta(wo)
    f_rr = (d_val * microfacet.smith_g(wo, wi_rr, alpha) * r_r
            / jnp.where(denom_rr == 0.0, 1.0, denom_rr))
    samp_rr = BSDFSample(
        color=splat3(f_rr), direction=wi_rr, pdf=pdf_rr,
        valid=any_r & same_hemisphere(wo, wi_rr) & (awm != 0.0),
        reflection=true_, transmission=false_, specular=false_, glossy=true_)

    # rough transmission
    valid_rt, etap_r, wi_rt = refract(wo, wm, eta)
    tir = ~valid_rt
    denom_gt = sqr(dot(wi_rt, wm) + dot(wo, wm) / etap_r)
    dwm_dwi = abs_dot(wi_rt, wm) / jnp.where(denom_gt == 0.0, 1.0, denom_gt)
    pdf_rt = vndf * dwm_dwi * pt_r / jnp.where(any_r, psum_r, 1.0)
    denom_ft = (cos_theta(wi_rt) * cos_theta(wo) * denom_gt)
    ft_r = (t_r * d_val * microfacet.smith_g(wo, wi_rt, alpha)
            * jnp.abs(dot(wi_rt, wm) * dot(wo, wm)
                      / jnp.where(denom_ft == 0.0, 1.0, denom_ft)))
    ft_r = jnp.where(radiance_mode, ft_r / sqr(etap_r), ft_r)
    samp_rt = BSDFSample(
        color=splat3(ft_r), direction=wi_rt, pdf=pdf_rt,
        valid=(any_r & ~tir & ~same_hemisphere(wo, wi_rt)
               & (wi_rt[..., 2] != 0.0)),
        reflection=false_, transmission=true_, specular=false_, glossy=true_)
    rough_sample = where_sample(choose_r_r, samp_rr, samp_rt)

    return seed, where_sample(smooth, smooth_sample, rough_sample)


def pdf(roughness, wo, wi, eta=DEFAULT_IOR, reflection=True, transmission=True):
    """Sampling pdf of the rough dielectric (reference `Dielectric.h:290-343`).
    0 for smooth surfaces."""
    shape = wo.shape[:-1]
    eta = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), shape)
    alpha = roughness_to_alpha(roughness)
    wm, etap, is_reflect, valid = _generalized_half_vector(wo, wi, eta)

    r = fresnel_dielectric(dot(wo, wm), eta)
    t = 1.0 - r
    pr = jnp.where(jnp.broadcast_to(jnp.asarray(reflection), shape), r, 0.0)
    pt = jnp.where(jnp.broadcast_to(jnp.asarray(transmission), shape), t, 0.0)
    psum = pr + pt
    any_p = psum > 0.0

    vndf = microfacet.pdf(wo, wm, alpha)
    awm = abs_dot(wo, wm)
    pdf_r = vndf / jnp.where(awm == 0.0, 1.0, 4.0 * awm) * pr / jnp.where(any_p, psum, 1.0)

    denom = sqr(dot(wi, wm) + dot(wo, wm) / etap)
    dwm_dwi = abs_dot(wi, wm) / jnp.where(denom == 0.0, 1.0, denom)
    pdf_t = vndf * dwm_dwi * pt / jnp.where(any_p, psum, 1.0)

    val = jnp.where(is_reflect, pdf_r, pdf_t)
    ok = valid & any_p & ~is_effectively_smooth(alpha) & (eta != 1.0)
    return jnp.where(ok, val, 0.0)
