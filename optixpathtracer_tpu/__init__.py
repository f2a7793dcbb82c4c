"""optixpathtracer_tpu: a differentiable wavefront path tracer in JAX/Pallas.

A from-scratch re-design (not a port) of the capability set of the reference
OptiX/CUDA renderer Damo12320/OptixPathtracer: PBRT-v4-derived BSDFs (diffuse,
conductor, dielectric, layered glossy-diffuse), glTF scene loading, NEE'd
Monte Carlo path tracing with progressive accumulation, EXR/PNG output -
re-architected as a wavefront, array-of-rays pipeline that is pure,
differentiable, and sharded across device meshes.

Layers (bottom-up, mirroring SURVEY.md section 1's map):
  core/       math, RNG, Fresnel, microfacet (reference L1)
  bsdf/       material lobes f/sample/pdf (reference L2)
  scene/      glTF + procedural scenes, SoA flattening, BVH build (ref. L3)
  intersect/  JAX + GPU-kernel ray-scene intersection (replaces RT cores,
              ref. L4)
  integrate/  wavefront path integrator, NEE, film (reference L4-L6)
  camera/     matrix camera + raygen (reference Camera.*)
  film/       color transfer, EXR/PNG/BMP IO, metrics (reference L7/L9)
  dist/       device-mesh sharding + collectives (new; ref. has none)
  diff/       gradient utilities and checks (new)
"""

__version__ = "0.1.0"
