"""Boundary condition flag containers.

Parity counterpart of reference ``params/bc.py:68,222``: face-wise
Dirichlet/Neumann/Robin markers for scalar and vectorial problems. Faces not
explicitly assigned get Neumann. Conditions may only be set on boundary
faces (including fracture-internal boundaries, which are flagged
``is_internal``).

TPU note: these are host-side setup objects; discretizations consume them as
boolean/int masks folded into static index maps.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

__all__ = ["BoundaryCondition", "BoundaryConditionVectorial"]


class AbstractBoundaryCondition:
    is_neu: np.ndarray
    is_dir: np.ndarray
    is_rob: np.ndarray
    is_per: np.ndarray

    def copy(self):
        new = self.__class__.__new__(self.__class__)
        for attr in (
            "num_faces",
            "dim",
            "bc_type",
        ):
            if hasattr(self, attr):
                setattr(new, attr, getattr(self, attr))
        for attr in (
            "is_neu",
            "is_dir",
            "is_rob",
            "is_per",
            "is_internal",
            "bf",
            "basis",
            "robin_weight",
        ):
            if hasattr(self, attr):
                setattr(new, attr, getattr(self, attr).copy())
        return new

    def internal_to_dirichlet(self, sd) -> None:
        """Switch all fracture (internal-boundary) faces to Dirichlet."""
        frac = sd.tags["fracture_faces"]
        if self.is_neu.ndim == 2:
            self.is_neu[:, frac] = False
            self.is_dir[:, frac] = True
        else:
            self.is_neu[frac] = False
            self.is_dir[frac] = True


def _resolve_faces(sd, faces: Optional[np.ndarray]) -> np.ndarray:
    if faces is None:
        return np.zeros(0, dtype=int)
    faces = np.asarray(faces)
    if faces.dtype == bool:
        if faces.size != sd.num_faces:
            raise ValueError("Boolean face mask has wrong size")
        faces = np.where(faces)[0]
    return faces.astype(int)


class BoundaryCondition(AbstractBoundaryCondition):
    """Scalar boundary conditions: per-face dir/neu/rob flags."""

    def __init__(
        self,
        sd,
        faces: Optional[np.ndarray] = None,
        cond: Optional[Union[list[str], str]] = None,
    ) -> None:
        self.num_faces: int = sd.num_faces
        self.dim: int = sd.dim - 1
        self.bc_type: str = "scalar"

        self.bf: np.ndarray = sd.get_all_boundary_faces()
        bnd_mask = np.zeros(self.num_faces, dtype=bool)
        bnd_mask[self.bf] = True
        self.is_internal: np.ndarray = sd.tags["fracture_faces"].copy()

        # Default: Neumann on all boundary faces.
        self.is_neu = np.zeros(self.num_faces, dtype=bool)
        self.is_dir = np.zeros(self.num_faces, dtype=bool)
        self.is_rob = np.zeros(self.num_faces, dtype=bool)
        self.is_per = np.zeros(self.num_faces, dtype=bool)
        self.is_neu[self.bf] = True

        # Robin weight (alpha in  flux + alpha * p = g).
        self.robin_weight = np.ones(self.num_faces)

        # Basis for (future) oblique conditions; identity for scalar.
        self.basis = np.ones(self.num_faces)

        faces = _resolve_faces(sd, faces)
        if faces.size == 0:
            return
        if not np.all(bnd_mask[faces]):
            raise ValueError("Boundary conditions only on boundary faces")
        if cond is None:
            raise ValueError("Need conditions for assigned faces")
        if isinstance(cond, str):
            cond = [cond] * faces.size
        if len(cond) != faces.size:
            raise ValueError("One BC type per face required")

        for f, c in zip(faces, cond):
            if c == "neu":
                pass  # default
            elif c == "dir":
                self.is_dir[f] = True
                self.is_neu[f] = False
            elif c == "rob":
                self.is_rob[f] = True
                self.is_neu[f] = False
            elif c == "per":
                self.is_per[f] = True
                self.is_neu[f] = False
            else:
                raise ValueError(f"Unknown boundary condition {c}")

    def __repr__(self) -> str:
        return (
            f"BoundaryCondition(dir={int(self.is_dir.sum())}, "
            f"neu={int(self.is_neu.sum())}, rob={int(self.is_rob.sum())})"
        )


class BoundaryConditionVectorial(AbstractBoundaryCondition):
    """Vector boundary conditions: per-(component, face) dir/neu/rob flags
    with an optional per-face nd x nd basis for oblique conditions."""

    def __init__(
        self,
        sd,
        faces: Optional[np.ndarray] = None,
        cond: Optional[Union[list[str], str]] = None,
    ) -> None:
        self.num_faces: int = sd.num_faces
        self.dim: int = sd.dim
        self.nd: int = sd.dim
        self.bc_type: str = "vectorial"

        self.bf = sd.get_all_boundary_faces()
        self.is_internal = sd.tags["fracture_faces"].copy()

        nd = self.nd
        self.is_neu = np.zeros((nd, self.num_faces), dtype=bool)
        self.is_dir = np.zeros((nd, self.num_faces), dtype=bool)
        self.is_rob = np.zeros((nd, self.num_faces), dtype=bool)
        self.is_per = np.zeros((nd, self.num_faces), dtype=bool)
        self.is_neu[:, self.bf] = True

        self.robin_weight = np.tile(np.eye(nd)[:, :, None], (1, 1, self.num_faces))
        self.basis = np.tile(np.eye(nd)[:, :, None], (1, 1, self.num_faces))

        faces = _resolve_faces(sd, faces)
        if faces.size == 0:
            return
        bnd_mask = np.zeros(self.num_faces, dtype=bool)
        bnd_mask[self.bf] = True
        if not np.all(bnd_mask[faces]):
            raise ValueError("Boundary conditions only on boundary faces")
        if cond is None:
            raise ValueError("Need conditions for assigned faces")
        if isinstance(cond, str):
            cond = [cond] * faces.size
        if len(cond) != faces.size:
            raise ValueError("One BC type per face required")

        for f, c in zip(faces, cond):
            # Component-resolved conditions: "dir_x" etc.
            base, _, comp = c.partition("_")
            comps = range(nd) if comp == "" else [{"x": 0, "y": 1, "z": 2}[comp]]
            for i in comps:
                self.is_dir[i, f] = base == "dir"
                self.is_rob[i, f] = base == "rob"
                self.is_neu[i, f] = base == "neu"
            if base not in ("dir", "neu", "rob"):
                raise ValueError(f"Unknown boundary condition {c}")

    def set_bc(self, faces: np.ndarray, cond: Union[str, list[str]]) -> None:
        """Assign conditions after construction (same semantics as init)."""
        if isinstance(cond, str):
            cond = [cond] * np.asarray(faces).size
        for f, c in zip(np.asarray(faces), cond):
            base, _, comp = c.partition("_")
            comps = range(self.nd) if comp == "" else [{"x": 0, "y": 1, "z": 2}[comp]]
            for i in comps:
                self.is_dir[i, f] = base == "dir"
                self.is_rob[i, f] = base == "rob"
                self.is_neu[i, f] = base == "neu"

    def __repr__(self) -> str:
        return (
            f"BoundaryConditionVectorial(nd={self.nd}, "
            f"dir={int(self.is_dir.any(axis=0).sum())}, "
            f"neu={int(self.is_neu.all(axis=0).sum())})"
        )


def face_on_side(sd, side, tol: float = 1e-8) -> list:
    """Global indices of faces on named sides of a box-shaped grid:
    ``west/xmin, east/xmax, south/ymin, north/ymax, bottom/zmin, top/zmax``
    (reference ``params/bc.py:423``). One array per requested side."""
    if isinstance(side, str):
        side = [side]
    axis_lo = {"west": 0, "xmin": 0, "south": 1, "ymin": 1,
               "bottom": 2, "bot": 2, "zmin": 2}
    axis_hi = {"east": 0, "xmax": 0, "north": 1, "ymax": 1,
               "top": 2, "zmax": 2}
    out = []
    for s in side:
        s = s.lower().strip()
        if s in axis_lo:
            ax, ext = axis_lo[s], sd.nodes[axis_lo[s]].min()
        elif s in axis_hi:
            ax, ext = axis_hi[s], sd.nodes[axis_hi[s]].max()
        else:
            raise ValueError(f"Unknown face side {s!r}")
        out.append(
            np.squeeze(np.where(np.abs(sd.face_centers[ax] - ext) < tol))
        )
    return out
