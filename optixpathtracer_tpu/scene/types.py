"""Host-side scene data model: Mesh / Material / Texture / Model.

JAX equivalent of reference `source/ModelLoading/{Mesh.h,Model.h,
Texture.h}`: SoA vertex arrays + TRS transform + pbrMetallicRoughness
material, held in numpy on the host until `flatten.py` bakes everything into
device-resident SoA buffers (the analog of BuildAccel/BuildSBT uploads,
`OptixRenderer.cpp:306-374,486-560`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Material:
    """pbrMetallicRoughness material (reference `Mesh.h:23-37` scalars +
    texture indices), extended with the first-class `mat_type` enum
    (SURVEY.md section 2.3) and a differentiable IOR."""
    base_color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    metallic: float = 0.0
    roughness: float = 1.0
    ior: float = 1.5
    mat_type: str = "metallic_mix"  # reference runtime default
    albedo_texture: int = -1        # index into Model.textures, -1 = none
    metal_rough_texture: int = -1
    normal_texture: int = -1


@dataclasses.dataclass
class Texture:
    """RGBA image, float32 in [0,1], *raw* (pre-decode) values like the
    reference's non-sRGB CUDA texture objects (`OptixRenderer.cpp:604`);
    the sRGB->linear decode happens after filtering, in the shader analog."""
    pixels: np.ndarray  # [H, W, 4] float32
    name: str = ""


@dataclasses.dataclass
class Mesh:
    """One primitive with one material (reference "one material per Mesh",
    `ModelLoader.cpp:100-102`)."""
    positions: np.ndarray                 # [V, 3] float32, object space
    indices: np.ndarray                   # [F, 3] int32
    normals: Optional[np.ndarray] = None  # [V, 3]
    uvs: Optional[np.ndarray] = None      # [V, 2]
    material: Material = dataclasses.field(default_factory=Material)
    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation_quat: np.ndarray = dataclasses.field(  # (w, x, y, z)
        default_factory=lambda: np.array([1.0, 0, 0, 0], np.float32))
    scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    name: str = ""

    def model_matrix(self) -> np.ndarray:
        """T * R * S (reference `Mesh.cpp:6-23`)."""
        w, x, y, z = self.rotation_quat
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ], np.float64)
        m = np.eye(4)
        m[:3, :3] = r @ np.diag(self.scale.astype(np.float64))
        m[:3, 3] = self.translation
        return m


@dataclasses.dataclass
class PointLight:
    """Reference `LightsStruct.h:6-10`."""
    position: np.ndarray
    color: np.ndarray


@dataclasses.dataclass
class Model:
    """A loaded scene: meshes + shared textures (reference `Model.h:5-9`)."""
    meshes: List[Mesh] = dataclasses.field(default_factory=list)
    textures: List[Texture] = dataclasses.field(default_factory=list)
