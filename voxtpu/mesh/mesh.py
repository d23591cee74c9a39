"""Host-side triangle mesh container (SoA of NumPy arrays).

Equivalent surface to the reference's ``Mesh`` struct
(`vplib/src/mesh/mesh.h:133-170`): vertex coordinates, normals, per-vertex
RGBA colors, and per-face index triples for coordinates and normals.

Design notes (a redesign, not a port):
- Arrays are NumPy on the host; compute paths move the needed views to
  device explicitly (the `CudaPtr` H2D copies of the reference, C1 in
  SURVEY.md, are `jax.device_put` here).
- Faces are stored as ``(F, 3) int32`` — one row per triangle. The
  reference keeps a flat ``std::vector<uint32_t>`` with a quirky
  ``FacesSize() = len/6`` convention (`mesh.h:168`, compensated by
  ``numTriangles = FacesSize()*2`` at `vox/naive.cu:108`); we use the
  obvious representation instead.
- Colors are ``(V, 4) uint8`` RGBA (the reference packs RGBA in a
  ``uint32``, `mesh.h:10-40`).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    name: str = "mesh_default"
    coords: np.ndarray = None          # (V, 3) float32
    normals: np.ndarray = None         # (Vn, 3) float32
    colors: np.ndarray = None          # (V, 4) uint8 RGBA
    faces: np.ndarray = None           # (F, 3) int32  (vertex indices)
    faces_normals: np.ndarray = None   # (F, 3) int32  (normal indices)

    def __post_init__(self):
        if self.coords is None:
            self.coords = np.zeros((0, 3), np.float32)
        if self.normals is None:
            self.normals = np.zeros((0, 3), np.float32)
        if self.colors is None:
            self.colors = np.zeros((0, 4), np.uint8)
        if self.faces is None:
            self.faces = np.zeros((0, 3), np.int32)
        if self.faces_normals is None:
            self.faces_normals = np.zeros((0, 3), np.int32)
        self.coords = np.asarray(self.coords, np.float32).reshape(-1, 3)
        self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        self.colors = np.asarray(self.colors, np.uint8).reshape(-1, 4)
        self.faces = np.asarray(self.faces, np.int32).reshape(-1, 3)
        self.faces_normals = np.asarray(self.faces_normals, np.int32).reshape(-1, 3)

    @property
    def num_vertices(self) -> int:
        return int(self.coords.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def triangle_vertices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Gathered (V0, V1, V2) arrays, each (F, 3) float32."""
        tri = self.coords[self.faces]          # (F, 3, 3)
        return tri[:, 0, :], tri[:, 1, :], tri[:, 2, :]

    def validate(self) -> None:
        if self.num_faces:
            if self.faces.min() < 0 or self.faces.max() >= self.num_vertices:
                raise ValueError("face indices out of range")
            # faces_normals is NOT bounds-checked: the importer defaults
            # ni = vi for faces without vn references (a mixed-form OBJ
            # then legitimately carries indices past len(normals));
            # consumers of real normals must check against their own
            # normal table.


def face_normals(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Unnormalized face normals ``cross(V1-V0, V2-V1)``.

    Matches `CalculateFaceNormal` (`vplib/src/vox/vox.h:30-32`): note the
    second argument is V2-V1, not V2-V0 — same direction, different length.
    Only the sign of the X component is consumed downstream.
    """
    return np.cross(v1 - v0, v2 - v1).astype(np.float32)
