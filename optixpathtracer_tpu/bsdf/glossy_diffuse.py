"""Layered glossy-diffuse BSDF: dielectric coat over a Lambertian base.

Vectorized re-design of reference `PBRT/GlossyDiffuse.h` (PBRT-v4 LayeredBxDF
specialized to top = dielectric, bottom = diffuse, two-sided, no interlayer
medium; constants thickness=0.01, maxDepth=10, nSamples=5, g=0, mediaAlbedo=0
per `GlossyDiffuse.h:144-152,375-381`).

Key structural simplification (proved from the reference's configuration, not
an approximation):

* `mediaAlbedo == 0` means the walk always advances to the *other* interface
  each step (`GlossyDiffuse.h:263-267,473-477`), so the interface sequence is
  deterministic: entering through the top, depth 0 hits the bottom, depth 1
  the top, alternating. We therefore walk in (bottom, top) pairs, one
  lax.fori_loop trip per pair, with *static* interface parity inside the
  trip instead of a traced interface flag - every step evaluates only one
  interface's lobes, which XLA fuses far better than a per-lane dynamic
  switch, and the compiled program holds one pair, not maxDepth steps.
* Two-sidedness flips wo (and wi for f()) into the +z hemisphere up front
  (`GlossyDiffuse.h:162-165,388-392`).
* For f(): the exit interface is the bottom only when wo,wi are in opposite
  hemispheres - but then `wis` must be a *transmission* sample of the
  Lambertian bottom, which always fails (`LambertDiffuse.h:110-113` returns
  false for !reflection), so every estimator sample `continue`s and f == 0.
  Hence f() is nonzero only for same-hemisphere pairs, with exit = top,
  exitZ = thickness, nonExit = bottom (never specular).

The reference's early `continue`/`break` become per-lane `alive` masks.

RNG: the reference threads the caller's stream through interface sampling and
a decorrelated TEA-reseeded stream through Russian roulette
(`GlossyDiffuse.h:215-222,417-422`). We reproduce the two-stream structure
(statistically, not bit-for-bit - the estimator's correctness only needs
decorrelation) and additionally decorrelate the nSamples estimator axis by
TEA-folding the sample index so all 5 samples evaluate as one vectorized
leading axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.math import abs_cos_theta, same_hemisphere, sqr
from . import dielectric as _dielectric
from . import diffuse as _diffuse
from .base import (BSDFSample, is_effectively_smooth, roughness_to_alpha,
                   where_sample)

THICKNESS = 0.01
MAX_DEPTH = 10
N_SAMPLES = 5
DEFAULT_IOR = 1.5


def power_heuristic(f_pdf, g_pdf):
    """Balance-squared MIS weight, nf = ng = 1 (`GlossyDiffuse.h:91-95`)."""
    f2 = sqr(f_pdf)
    g2 = sqr(g_pdf)
    denom = f2 + g2
    return jnp.where(denom > 0.0, f2 / jnp.where(denom > 0.0, denom, 1.0), 0.0)


def transmittance(dz, w):
    """exp(-|dz / w.z|), 1 at dz ~ 0 (`GlossyDiffuse.h:97-105`).

    Guarded at wz > 1e-8 rather than wz != 0: for tiny nonzero wz the
    forward value underflows to 0 harmlessly, but the backward is
    exp(-huge) * dz/wz^2 = 0 * inf = NaN once wz^2 overflows. Below the
    cutoff the transmittance is exactly 0 (exp(-1e6) == 0 in f32) so the
    clamp changes no forward value."""
    wz = jnp.abs(w[..., 2])
    ok = wz > 1e-8
    tr = jnp.exp(-jnp.abs(dz) / jnp.where(ok, wz, 1.0))
    tr = jnp.where(ok, tr, 0.0)
    return jnp.where(jnp.abs(dz) <= jnp.finfo(jnp.float32).tiny, 1.0, tr)


def _nonzero3(c):
    return jnp.any(c != 0.0, axis=-1)


def _pair_walk(bottom, top, carry, max_depth: int):
    """Run depth = 0 .. max_depth-1 of a layer walk: bottom(depth, carry)
    at even depths, top(depth, carry) at odd ones, as one lax.fori_loop over
    (bottom, top) pairs (plus a last bottom step when max_depth is odd)."""
    def pair(i, c):
        return top(2 * i + 1, bottom(2 * i, c))

    carry = jax.lax.fori_loop(0, max_depth // 2, pair, carry)
    if max_depth % 2:
        carry = bottom(max_depth - 1, carry)
    return carry


def f(seed, albedo, roughness, wo, wi, eta=DEFAULT_IOR, n_samples=N_SAMPLES,
      max_depth=MAX_DEPTH, thickness=THICKNESS):
    """Stochastic estimate of the layered BSDF value
    (reference `GlossyDiffuse.h:141-367`). Returns (seed, rgb).

    The estimate is E over n_samples random walks; like the reference's
    f(), it is *noisy* - callers average it over many invocations.
    """
    batch = wo.shape[:-1]
    alpha = jnp.broadcast_to(roughness_to_alpha(roughness), batch)
    exit_specular = is_effectively_smooth(alpha)

    # Two-sided: evaluate in the +z hemisphere (`GlossyDiffuse.h:162-165`).
    flip = (wo[..., 2] < 0.0)[..., None]
    wo = jnp.where(flip, -wo, wo)
    wi = jnp.where(flip, -wi, wi)

    same_hemi = same_hemisphere(wo, wi)

    # Entrance reflection off the coat, counted n_samples times then divided
    # (`GlossyDiffuse.h:206-207`).
    f_acc = jnp.where(
        same_hemi[..., None],
        float(n_samples) * _dielectric.f(roughness, wo, wi, eta=eta,
                                         radiance_mode=True),
        0.0)

    # Vectorize the n_samples estimator axis; decorrelate its streams.
    s_idx = jnp.arange(n_samples, dtype=jnp.uint32)
    s_idx = s_idx.reshape((n_samples,) + (1,) * len(batch))
    seed_outer = rng.tea(jnp.broadcast_to(seed, (n_samples,) + batch), s_idx)
    # Decorrelated RR stream (reference `GlossyDiffuse.h:215-222`).
    seed_rr = rng.float_hash_seed(wo[..., 0], wo[..., 1], wi[..., 0],
                                  wi[..., 1], seed)
    seed_rr = rng.tea(jnp.broadcast_to(seed_rr, (n_samples,) + batch),
                      s_idx + jnp.uint32(0x9E37))

    wo_b = jnp.broadcast_to(wo, (n_samples,) + batch + (3,))
    wi_b = jnp.broadcast_to(wi, (n_samples,) + batch + (3,))
    alb_b = jnp.broadcast_to(albedo, (n_samples,) + batch + (3,))
    rough_b = jnp.broadcast_to(jnp.asarray(roughness, jnp.float32),
                               (n_samples,) + batch)
    exit_spec_b = jnp.broadcast_to(exit_specular, (n_samples,) + batch)

    # Entrance transmission sample through the coat (wos) and the virtual
    # light's transmission sample (wis) (`GlossyDiffuse.h:229-240`).
    seed_outer, wos = _dielectric.sample(
        seed_outer, rough_b, wo_b, eta=eta, radiance_mode=True,
        reflection=False, transmission=True)
    seed_outer, wis = _dielectric.sample(
        seed_outer, rough_b, wi_b, eta=eta, radiance_mode=False,
        reflection=False, transmission=True)

    wos_ok = (wos.valid & _nonzero3(wos.color) & (wos.pdf != 0.0)
              & (wos.direction[..., 2] != 0.0))
    wis_ok = (wis.valid & _nonzero3(wis.color) & (wis.pdf != 0.0)
              & (wis.direction[..., 2] != 0.0))

    alive = jnp.broadcast_to(same_hemi, (n_samples,) + batch) & wos_ok & wis_ok
    beta = (wos.color * abs_cos_theta(wos.direction)[..., None]
            / jnp.where(wos.pdf == 0.0, 1.0, wos.pdf)[..., None])
    w = wos.direction
    walk_f = jnp.zeros_like(beta)

    tr_thick_wis = transmittance(thickness, wis.direction)
    wis_weight = (abs_cos_theta(wis.direction)[..., None] * tr_thick_wis[..., None]
                  * wis.color / jnp.where(wis.pdf == 0.0, 1.0, wis.pdf)[..., None])

    # The walk alternates interfaces: even depth -> bottom (Lambert), odd
    # -> top (dielectric reflection); see the module docstring. One
    # lax.fori_loop trip runs a (bottom, top) pair, so interface parity
    # stays static inside the body and the compiled program holds one
    # copy of each step instead of max_depth.
    def roulette(depth, seed_rr, beta, alive):
        """Russian roulette from the decorrelated stream, from depth 4 on
        (`GlossyDiffuse.h:253-260`); a no-op (stream not advanced) before."""
        on = depth > 3
        beta_max = jnp.max(beta, axis=-1)
        rr_on = on & alive & (beta_max < 0.25)
        q = jnp.maximum(0.0, 1.0 - beta_max)
        seed_next, u_rr = rng.rnd(seed_rr)
        die = rr_on & (u_rr < q)
        boost = jnp.where(rr_on & ~die,
                          1.0 / jnp.where(q < 1.0, 1.0 - q, 1.0), 1.0)
        return (jnp.where(on, seed_next, seed_rr), beta * boost[..., None],
                alive & ~die)

    def bottom(depth, c):
        seed_outer, seed_rr, beta, alive, w, walk_f = c
        seed_rr, beta, alive = roulette(depth, seed_rr, beta, alive)
        # Advance through the layer (`GlossyDiffuse.h:263-267`).
        beta = beta * transmittance(thickness, w)[..., None]
        # NEE toward the presampled wis direction
        # (`GlossyDiffuse.h:328-337`).
        ph_w = power_heuristic(
            wis.pdf, _diffuse.pdf(-w, -wis.direction))
        wt1 = jnp.where(exit_spec_b, 1.0, ph_w)
        nee1 = (beta * _diffuse.f(alb_b, -w, -wis.direction)
                * wt1[..., None] * wis_weight)
        walk_f = walk_f + jnp.where(alive[..., None], nee1, 0.0)

        # Sample the Lambert base (`GlossyDiffuse.h:342-347`).
        seed_outer, bs = _diffuse.sample(seed_outer, alb_b, -w)
        bs_ok = (bs.valid & _nonzero3(bs.color) & (bs.pdf != 0.0)
                 & (bs.direction[..., 2] != 0.0))
        new_beta = (beta * bs.color
                    * abs_cos_theta(bs.direction)[..., None]
                    / jnp.where(bs.pdf == 0.0, 1.0, bs.pdf)[..., None])

        # NEE through the (rough) exit coat along the new direction
        # (`GlossyDiffuse.h:349-361`).
        f_exit = _dielectric.f(rough_b, -bs.direction, wi_b, eta=eta,
                               radiance_mode=True)
        exit_pdf = _dielectric.pdf(rough_b, -bs.direction, wi_b, eta=eta,
                                   reflection=False, transmission=True)
        wt2 = power_heuristic(bs.pdf, exit_pdf)
        nee2 = (new_beta * transmittance(thickness, bs.direction)[..., None]
                * f_exit * wt2[..., None])
        contrib2_on = alive & bs_ok & ~exit_spec_b & _nonzero3(f_exit)
        walk_f = walk_f + jnp.where(contrib2_on[..., None], nee2, 0.0)

        alive = alive & bs_ok
        beta = jnp.where(alive[..., None], new_beta, beta)
        w = jnp.where(alive[..., None], bs.direction, w)
        return seed_outer, seed_rr, beta, alive, w, walk_f

    def top(depth, c):
        seed_outer, seed_rr, beta, alive, w, walk_f = c
        seed_rr, beta, alive = roulette(depth, seed_rr, beta, alive)
        beta = beta * transmittance(thickness, w)[..., None]
        # Reflection back down off the exit interface
        # (`GlossyDiffuse.h:315-325`).
        seed_outer, bs = _dielectric.sample(
            seed_outer, rough_b, -w, eta=eta, radiance_mode=True,
            reflection=True, transmission=False)
        bs_ok = (bs.valid & _nonzero3(bs.color) & (bs.pdf != 0.0)
                 & (bs.direction[..., 2] != 0.0))
        new_beta = (beta * bs.color
                    * abs_cos_theta(bs.direction)[..., None]
                    / jnp.where(bs.pdf == 0.0, 1.0, bs.pdf)[..., None])
        alive = alive & bs_ok
        beta = jnp.where(alive[..., None], new_beta, beta)
        w = jnp.where(alive[..., None], bs.direction, w)
        return seed_outer, seed_rr, beta, alive, w, walk_f

    carry = (seed_outer, seed_rr, beta, alive, w, walk_f)
    carry = _pair_walk(bottom, top, carry, max_depth)
    walk_f = carry[5]

    total = f_acc + jnp.sum(walk_f, axis=0)
    return seed, total / float(n_samples)


def sample(seed, albedo, roughness, wo, eta=DEFAULT_IOR,
           max_depth=MAX_DEPTH, thickness=THICKNESS):
    """Sample the layered BSDF via one random walk
    (reference `GlossyDiffuse.h:372-524`). Returns (seed, BSDFSample) with a
    *proportional* pdf (product of walk pdfs, as in the reference)."""
    batch = wo.shape[:-1]
    rough_b = jnp.broadcast_to(jnp.asarray(roughness, jnp.float32), batch)

    # Two-sided flip (`GlossyDiffuse.h:388-392`).
    flip = (wo[..., 2] < 0.0)
    wo_up = jnp.where(flip[..., None], -wo, wo)

    # Entrance event at the top interface (`GlossyDiffuse.h:394-409`).
    seed, bs0 = _dielectric.sample(seed, rough_b, wo_up, eta=eta,
                                   radiance_mode=True,
                                   reflection=True, transmission=True)
    bs0_ok = (bs0.valid & _nonzero3(bs0.color) & (bs0.pdf != 0.0)
              & (bs0.direction[..., 2] != 0.0))

    # Immediate exit: reflection off the coat.
    refl_dir = jnp.where(flip[..., None], -bs0.direction, bs0.direction)
    refl_sample = BSDFSample(
        color=bs0.color, direction=refl_dir, pdf=bs0.pdf,
        valid=bs0_ok & bs0.reflection,
        reflection=jnp.ones(batch, bool),
        transmission=jnp.zeros(batch, bool),
        specular=bs0.specular, glossy=~bs0.specular)

    # Otherwise we transmitted into the layer: start the walk
    # (`GlossyDiffuse.h:408-427`).
    walking = bs0_ok & bs0.transmission
    w = bs0.direction
    f_val = bs0.color * abs_cos_theta(bs0.direction)[..., None]
    pdf_val = bs0.pdf
    specular_path = bs0.specular

    # Decorrelated RR stream (`GlossyDiffuse.h:417-422`).
    seed_rr = rng.float_hash_seed(wo_up[..., 0], wo_up[..., 1], seed)

    # Exit record, filled by the first transmission event through the top.
    done = jnp.zeros(batch, bool)
    out_color = jnp.zeros(batch + (3,), jnp.float32)
    out_dir = jnp.zeros(batch + (3,), jnp.float32)
    out_pdf = jnp.zeros(batch, jnp.float32)
    out_specular = jnp.zeros(batch, bool)

    alb_b = jnp.broadcast_to(albedo, batch + (3,))

    def step(depth, c, at_top: bool):
        """One interface event of the walk; at_top is static."""
        (seed, seed_rr, walking, w, f_val, pdf_val, specular_path, done,
         out_color, out_dir, out_pdf, out_specular) = c
        # Russian roulette from depth 4 on (`GlossyDiffuse.h:432-439`).
        # pdf products can underflow to denormals; f/denormal = inf and
        # the masked backward of the ratio then NaNs (0 * -f/pdf^2).
        # A stand-in of 1.0 keeps the same behavior (rr_beta >= 0.25
        # means no roulette) with finite partials.
        on = depth > 3
        pdf_ok = pdf_val > 1e-20
        rr_beta = jnp.where(
            pdf_ok,
            jnp.max(f_val, axis=-1) / jnp.where(pdf_ok, pdf_val, 1.0),
            1.0)
        rr_on = on & walking & (rr_beta < 0.25)
        q = jnp.maximum(0.0, 1.0 - rr_beta)
        seed_next, u_rr = rng.rnd(seed_rr)
        seed_rr = jnp.where(on, seed_next, seed_rr)
        die = rr_on & (u_rr < q)
        pdf_val = jnp.where(rr_on & ~die, pdf_val * (1.0 - q), pdf_val)
        walking = walking & ~die
        walking = walking & (w[..., 2] != 0.0)

        # Advance to the other interface (`GlossyDiffuse.h:473-477`).
        f_val = jnp.where(walking[..., None],
                          f_val * transmittance(thickness, w)[..., None],
                          f_val)

        if not at_top:
            # bottom: Lambert reflection (never transmits)
            seed, bs = _diffuse.sample(seed, alb_b, -w)
            bs_transmission = jnp.zeros(batch, bool)
        else:
            # top: dielectric, may reflect back down or transmit out
            seed, bs = _dielectric.sample(seed, rough_b, -w, eta=eta,
                                          radiance_mode=True,
                                          reflection=True, transmission=True)
            bs_transmission = bs.transmission

        bs_ok = (bs.valid & _nonzero3(bs.color) & (bs.pdf != 0.0)
                 & (bs.direction[..., 2] != 0.0))
        walking = walking & bs_ok
        f_val = jnp.where(walking[..., None], f_val * bs.color, f_val)
        pdf_val = jnp.where(walking, pdf_val * bs.pdf, pdf_val)
        specular_path = specular_path & jnp.where(walking, bs.specular, True)
        w = jnp.where(walking[..., None], bs.direction, w)

        # Exit through the top (`GlossyDiffuse.h:500-518`).
        exiting = walking & bs_transmission
        out_color = jnp.where((exiting & ~done)[..., None], f_val, out_color)
        out_dir = jnp.where((exiting & ~done)[..., None], w, out_dir)
        out_pdf = jnp.where(exiting & ~done, pdf_val, out_pdf)
        out_specular = jnp.where(exiting & ~done, specular_path, out_specular)
        done = done | exiting
        walking = walking & ~exiting

        # Cosine scale after an in-layer scattering event
        # (`GlossyDiffuse.h:520-521`).
        f_val = jnp.where(walking[..., None],
                          f_val * abs_cos_theta(bs.direction)[..., None],
                          f_val)
        return (seed, seed_rr, walking, w, f_val, pdf_val, specular_path,
                done, out_color, out_dir, out_pdf, out_specular)

    carry = (seed, seed_rr, walking, w, f_val, pdf_val, specular_path, done,
             out_color, out_dir, out_pdf, out_specular)
    carry = _pair_walk(lambda d, c: step(d, c, False),
                       lambda d, c: step(d, c, True), carry, max_depth)
    (seed, _, _, _, _, _, _, done, out_color, out_dir, out_pdf,
     out_specular) = carry

    out_dir_flipped = jnp.where(flip[..., None], -out_dir, out_dir)
    walk_reflection = same_hemisphere(wo_up, out_dir)
    walk_sample = BSDFSample(
        color=out_color, direction=out_dir_flipped, pdf=out_pdf,
        valid=done,
        reflection=walk_reflection,
        transmission=~walk_reflection,
        specular=out_specular, glossy=~out_specular)

    result = where_sample(bs0_ok & bs0.reflection, refl_sample, walk_sample)
    return seed, result
