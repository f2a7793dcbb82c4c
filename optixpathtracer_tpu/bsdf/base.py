"""BSDF sample record and shared conventions.

JAX equivalent of reference `PBRT/BSDFSample.h:5-15` plus the
alpha-mapping/smoothness rules from `source/Renderer/OptiX/Surface.h:22-30`.

Every BSDF in this package exposes the triple
    f(params, wo, wi)            -> rgb [..., 3]
    sample(seed, params, wo)     -> (seed, BSDFSample)
    pdf(params, wo, wi)          -> scalar [...]
operating in the local shading frame (normal = +z), batched over arbitrary
leading wavefront axes. Invalid samples are flagged, never early-returned:
lanes stay dense for jit/vmap, with `valid=False` playing the role of the
reference's `return false`.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class BSDFSample(NamedTuple):
    """A sampled BSDF direction with its throughput and pdf
    (reference `BSDFSample.h`), plus a validity mask."""
    color: jnp.ndarray        # [..., 3] BSDF value f
    direction: jnp.ndarray    # [..., 3] sampled wi (shading space)
    pdf: jnp.ndarray          # [...]
    valid: jnp.ndarray        # [...] bool - reference's Sample_f return value
    reflection: jnp.ndarray   # [...] bool
    transmission: jnp.ndarray  # [...] bool
    specular: jnp.ndarray     # [...] bool
    glossy: jnp.ndarray       # [...] bool

    @staticmethod
    def invalid(shape):
        z3 = jnp.zeros(shape + (3,), jnp.float32)
        z = jnp.zeros(shape, jnp.float32)
        false = jnp.zeros(shape, bool)
        return BSDFSample(z3, z3, z, false, false, false, false, false)


def where_sample(mask, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    """Lane-select between two samples; mask has the wavefront shape."""
    m1 = mask[..., None]
    return BSDFSample(
        color=jnp.where(m1, a.color, b.color),
        direction=jnp.where(m1, a.direction, b.direction),
        pdf=jnp.where(mask, a.pdf, b.pdf),
        valid=jnp.where(mask, a.valid, b.valid),
        reflection=jnp.where(mask, a.reflection, b.reflection),
        transmission=jnp.where(mask, a.transmission, b.transmission),
        specular=jnp.where(mask, a.specular, b.specular),
        glossy=jnp.where(mask, a.glossy, b.glossy),
    )


def roughness_to_alpha(roughness):
    """alpha = roughness^2 (reference `Surface.h:26-30` GetAlpha)."""
    return roughness * roughness


def is_effectively_smooth(alpha):
    """alpha < 1e-3 -> treat as perfect specular (reference `Surface.h:22-24`)."""
    return alpha < 1e-3
