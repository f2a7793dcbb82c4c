"""Euler-angle fly camera with Blender-pose import and inverse-matrix raygen.

JAX equivalent of reference `source/Renderer/Camera.{h,cpp}` and
`source/GlmHelperMethods.cpp`. Matrices are built host-side in numpy (float64
then cast) exactly like glm's lookAt/perspective; the device ray generator
consumes only (position, inverse_view, inverse_projection), mirroring
`LaunchParams.h:12-18` / `devicePrograms.cu:601-623`.

Deliberate reproduced quirk (SURVEY.md section 7): the reference names its FOV
"horizontal" (`Camera.h:14`) but feeds it to glm::perspective which treats it
as the *vertical* fovy (`Camera.cpp:68-70`). We reproduce that - `fov_degrees`
is applied vertically - so renders line up with the reference goldens.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.math import normalize, vec3

RAYGEN_PRECISION = jax.lax.Precision.HIGHEST


def blender_to_engine_position(p):
    """(x, y, z)_blender -> (x, z, -y)_engine (`GlmHelperMethods.cpp:4-6`)."""
    x, y, z = p
    return np.array([x, z, -y], np.float64)


def blender_to_engine_rotation(r):
    """(rx, ry, rz)_blender -> (90-rx, 180+rz, ry) (`GlmHelperMethods.cpp:8-10`)."""
    x, y, z = r
    return np.array([90.0 - x, 180.0 + z, y], np.float64)


def look_at(eye, center, up):
    """glm::lookAt (right-handed)."""
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_radians, aspect, near=0.1, far=100.0):
    """glm::perspective (right-handed, [-1,1] clip depth), row-major."""
    t = np.tan(fovy_radians / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class Camera:
    """Fly camera; world up (0,1,0), default FOV 40 degrees
    (reference `Camera.h:6`, `Camera.cpp:7`)."""
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))  # degrees: (pitch, yaw, roll)
    fov_degrees: float = 40.0
    near: float = 0.1
    far: float = 100.0
    world_up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))

    @classmethod
    def from_blender(cls, position, rotation_degrees, fov_degrees=40.0):
        """Build from a Blender-convention pose as the scene presets do
        (`main.cpp:10-11` etc.)."""
        return cls(position=blender_to_engine_position(position),
                   rotation=blender_to_engine_rotation(rotation_degrees),
                   fov_degrees=fov_degrees)

    def forward(self):
        """Pitch/yaw -> forward (reference `Camera.cpp:37-49`)."""
        r = np.radians(self.rotation)
        x = np.sin(r[1]) * np.cos(r[0])
        y = -np.sin(r[0])
        z = np.cos(r[0]) * np.cos(r[1])
        v = np.array([x, y, z])
        return v / np.linalg.norm(v)

    def view_matrix(self):
        return look_at(self.position, self.position + self.forward(),
                       self.world_up)

    def projection_matrix(self, aspect):
        return perspective(np.radians(self.fov_degrees), aspect,
                           self.near, self.far)

    def raygen_params(self, width, height):
        """The device-side uniform block: (position, inv_view, inv_proj)
        as float32 jnp arrays (analog of `LaunchParams.h:12-18`)."""
        inv_view = np.linalg.inv(self.view_matrix())
        inv_proj = np.linalg.inv(self.projection_matrix(width / height))
        return (jnp.asarray(self.position, jnp.float32),
                jnp.asarray(inv_view, jnp.float32),
                jnp.asarray(inv_proj, jnp.float32))


def generate_rays(position, inv_view, inv_proj, width, height,
                  pixel_x=None, pixel_y=None):
    """Reconstruct world-space primary rays from the inverse matrices
    (reference `devicePrograms.cu:601-623`). Returns (origins, directions)
    with shape [..., 3]; origins are broadcast of the camera position.

    pixel_x/pixel_y default to the full image grid (y=0 at the bottom, GL
    convention like the reference framebuffer).
    """
    if pixel_x is None or pixel_y is None:
        ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                              jnp.arange(width, dtype=jnp.float32),
                              indexing="ij")
        pixel_x, pixel_y = xs, ys
    x_ndc = (pixel_x + 0.5) / width * 2.0 - 1.0
    y_ndc = (pixel_y + 0.5) / height * 2.0 - 1.0

    ndc = jnp.stack([x_ndc, y_ndc, jnp.ones_like(x_ndc),
                     jnp.ones_like(x_ndc)], axis=-1)
    # HIGHEST: a GPU may run float32 products in TF32 (about 3 decimal
    # digits), which would move ray directions off the CPU's
    p_view = jnp.matmul(ndc, inv_proj.T, precision=RAYGEN_PRECISION)
    p_view = p_view.at[..., 3].set(0.0)  # direction, drop w
    p_world = jnp.matmul(p_view, inv_view.T, precision=RAYGEN_PRECISION)
    d = normalize(p_world[..., :3])
    o = jnp.broadcast_to(position, d.shape)
    return o, d


def jittered_rays(seed, position, inv_view, inv_proj, width, height):
    """Primary rays with per-sample sub-pixel jitter for antialiased
    accumulation. The reference shoots through pixel centers every frame
    (no AA jitter, `devicePrograms.cu:607-608`); jitter is our progressive
    improvement, disabled when matching goldens. Returns (seed, o, d)."""
    from ..core import rng as _rng
    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32),
                          indexing="ij")
    seed, u = _rng.rnd2(seed)
    px = xs + u[..., 0] - 0.5
    py = ys + u[..., 1] - 0.5
    o, d = generate_rays(position, inv_view, inv_proj, width, height, px, py)
    return seed, o, d
