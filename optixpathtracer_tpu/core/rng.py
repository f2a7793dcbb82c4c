"""Counter-free, stream-per-ray RNG matching the reference's TEA/LCG design.

The reference seeds one 32-bit LCG stream per (pixel, frame) with a TEA hash
(`source/Renderer/OptiX/random.h:33-69`, seeding at `devicePrograms.cu:631`)
and threads the mutable seed through every sampling decision. We reproduce the
same generators as pure uint32 jnp ops so that:

* each ray carries its seed as one lane of a uint32 array (SoA wavefront),
* every draw is `seed, u = rnd(seed)` - functional, jit/vmap-friendly,
* runs are bit-replayable (failure recovery = re-render tile from its seed),
* the sampling *structure* (which decision consumes which draw) can match the
  reference exactly, which matters for variance parity on the test scenes.

All ops are elementwise integer math; no host RNG anywhere.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_U32 = jnp.uint32


def _u32(x):
    return jnp.asarray(x).astype(_U32)


def tea(val0, val1, rounds: int = 16):
    """TEA hash of two u32 words (reference `random.h:33-48` tea<N>).

    Used for per-(pixel, frame) stream seeding and for the layered BSDF's
    decorrelated inner reseeding (`GlossyDiffuse.h:215-222`).
    """
    v0 = _u32(val0)
    v1 = _u32(val1)
    s0 = _U32(0)
    for _ in range(rounds):
        s0 = s0 + _U32(0x9E3779B9)
        v0 = v0 + ((lax.shift_left(v1, _U32(4)) + _U32(0xA341316C))
                   ^ (v1 + s0)
                   ^ (lax.shift_right_logical(v1, _U32(5)) + _U32(0xC8013EA4)))
        v1 = v1 + ((lax.shift_left(v0, _U32(4)) + _U32(0xAD90777D))
                   ^ (v0 + s0)
                   ^ (lax.shift_right_logical(v0, _U32(5)) + _U32(0x7E95761E)))
    return v0


def lcg(seed):
    """One LCG step; returns (new_seed, 24-bit random u32)
    (reference `random.h:51-57`)."""
    new = _U32(1664525) * _u32(seed) + _U32(1013904223)
    return new, new & _U32(0x00FFFFFF)


def rnd(seed):
    """Uniform float32 in [0, 1); returns (new_seed, u)
    (reference `random.h:66-69`)."""
    new, bits = lcg(seed)
    return new, bits.astype(jnp.float32) * jnp.float32(1.0 / 0x01000000)


def rnd2(seed):
    """Two uniforms; returns (new_seed, u2[..., 2])."""
    seed, u0 = rnd(seed)
    seed, u1 = rnd(seed)
    return seed, jnp.stack([u0, u1], axis=-1)


def pixel_seed(width, x, y, frame_id):
    """Per-(pixel, frame) stream seed: tea<16>(w*y + x, frame)
    (reference `devicePrograms.cu:631`)."""
    return tea(_u32(width) * _u32(y) + _u32(x), _u32(frame_id), rounds=16)


def float_hash_seed(*floats_and_seeds):
    """Chained TEA reseed from float-derived keys, as the layered BSDF does:
    tea(x*1000, y*1000) chained (`GlossyDiffuse.h:215-218, 417-418`).

    Floats are keyed via int32 truncation of 1000*x like the reference's
    implicit float->uint conversion.
    """
    vals = []
    for v in floats_and_seeds:
        v = jnp.asarray(v)
        if jnp.issubdtype(v.dtype, jnp.floating):
            # C++ float->unsigned conversion truncates toward zero; negative
            # values are UB in C++ but wrap modulo 2^32 on every GPU that
            # matters, which int32->uint32 bitcast reproduces.
            vals.append((v * 1000.0).astype(jnp.int32).astype(_U32))
        else:
            vals.append(_u32(v))
    s = tea(vals[0], vals[1], rounds=16)
    for v in vals[2:]:
        s = tea(s, v, rounds=16)
    return s


def sample_uniform_disk_polar(seed):
    """r = sqrt(u0), theta = 2 pi u1 (reference `random.h:76-84`).
    Returns (seed, p[..., 2])."""
    seed, u = rnd2(seed)
    r = jnp.sqrt(u[..., 0])
    theta = jnp.float32(2.0 * 3.14159265359) * u[..., 1]
    return seed, jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def sample_uniform_disk_concentric(seed):
    """Concentric disk map (reference `LambertDiffuse.h:35-55`).
    Returns (seed, p[..., 2])."""
    pi_over_4 = jnp.float32(0.78539816339744830961)
    pi_over_2 = jnp.float32(1.57079632679489661923)
    seed, u = rnd2(seed)
    uo = 2.0 * u - 1.0
    ux, uy = uo[..., 0], uo[..., 1]
    degenerate = (ux == 0.0) & (uy == 0.0)
    use_x = jnp.abs(ux) > jnp.abs(uy)
    r = jnp.where(use_x, ux, uy)
    # Guard the divisions (reference divides unguarded; degenerate case is
    # excluded by the early-return which we fold into the final where).
    safe_ux = jnp.where(ux == 0.0, 1.0, ux)
    safe_uy = jnp.where(uy == 0.0, 1.0, uy)
    theta = jnp.where(use_x, pi_over_4 * (uy / safe_ux),
                      pi_over_2 - pi_over_4 * (ux / safe_uy))
    p = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
    return seed, jnp.where(degenerate[..., None], 0.0, p)


def sample_cosine_hemisphere(seed):
    """Cosine-weighted hemisphere via concentric disk
    (reference `LambertDiffuse.h:57-61`). Returns (seed, w[..., 3])."""
    seed, d = sample_uniform_disk_concentric(seed)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return seed, jnp.stack([d[..., 0], d[..., 1], z], axis=-1)
