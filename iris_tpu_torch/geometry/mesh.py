"""Triangle mesh container (counterpart of the Mesh class in
iris_tpu/geometry/mesh.py; the OBJ/PLY loaders wait for the data slice).
Host-side numpy: positions + faces."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray     # (F, 3) int32

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    def triangles(self) -> np.ndarray:
        """(F, 3, 3) triangle vertex positions."""
        return self.vertices[self.faces]
