"""Core math, RNG, Fresnel, and microfacet layers (pure JAX, CPU-testable).

JAX equivalent of the reference's L1 math/sampling utilities
(SURVEY.md section 1: `glmCUDA.h`, `random.h`, `PBRT/{SphericalGeometry,
Complex,Microfacet}.h`). Like the reference's `__device__ __host__` headers,
the same code runs on CPU (tests) and GPU (render) unchanged.
"""
from . import fresnel, math, microfacet, rng  # noqa: F401
