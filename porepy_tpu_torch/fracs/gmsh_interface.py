"""Gmsh interface: tag scheme and a native ``.geo`` writer.

Counterpart of reference ``fracs/gmsh_interface.py``. The reference's
``GmshWriter`` drives the gmsh Python API in-process; gmsh is not
installable in this build, so :class:`GmshWriter` here emits a standalone
``.geo`` script (points with characteristic lengths, fracture lines
embedded in the domain surface, physical groups using
:class:`PhysicalNames`) that gmsh meshes offline —
``gmsh -2 file.geo -o file.msh`` — after which
:func:`porepy_tpu.fracs.simplex.triangle_grid_from_gmsh` reads the ``.msh``
back without gmsh or meshio installed.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

import numpy as np

__all__ = ["Tags", "PhysicalNames", "GmshInterfaceTags", "GmshWriter"]


class Tags(Enum):
    NEUTRAL = 0
    DOMAIN_BOUNDARY_POINT = 1
    DOMAIN_BOUNDARY_LINE = 2
    DOMAIN_BOUNDARY_SURFACE = 3
    FRACTURE = 10
    AUXILIARY_LINE = 11
    AUXILIARY_PLANE = 12
    FRACTURE_TIP = 20
    FRACTURE_INTERSECTION_LINE = 21
    FRACTURE_BOUNDARY_LINE = 22
    FRACTURE_INTERSECTION_POINT = 30
    FRACTURE_CONSTRAINT_INTERSECTION_POINT = 31
    FRACTURE_BOUNDARY_POINT = 32


# The reference exposes the same enum under this name in parts of the code.
GmshInterfaceTags = Tags


class PhysicalNames(Enum):
    DOMAIN = "DOMAIN"
    DOMAIN_BOUNDARY_POINT = "DOMAIN_BOUNDARY_POINT_"
    DOMAIN_BOUNDARY_SURFACE = "DOMAIN_BOUNDARY_SURFACE_"
    DOMAIN_BOUNDARY_LINE = "DOMAIN_BOUNDARY_LINE_"
    FRACTURE = "FRACTURE_"
    AUXILIARY_LINE = "AUXILIARY_LINE_"
    AUXILIARY_PLANE = "AUXILIARY_PLANE_"
    FRACTURE_TIP = "FRACTURE_TIP_"
    FRACTURE_INTERSECTION_LINE = "FRACTURE_INTERSECTION_LINE_"
    FRACTURE_BOUNDARY_LINE = "FRACTURE_BOUNDARY_LINE_"
    FRACTURE_INTERSECTION_POINT = "FRACTURE_INTERSECTION_POINT_"
    FRACTURE_CONSTRAINT_INTERSECTION_POINT = (
        "FRACTURE_CONSTRAINT_INTERSECTION_POINT_"
    )
    FRACTURE_BOUNDARY_POINT = "FRACTURE_BOUNDARY_POINT_"


class GmshWriter:
    """Write a 2d fractured-box geometry as a gmsh ``.geo`` script.

    Parameters:
        domain_box: ``{"xmin", "xmax", "ymin", "ymax"}``.
        frac_pts: ``(2, np)`` fracture segment endpoints/intersections
            (pre-split so crossings are shared points; see
            ``FractureNetwork2d.prepare_for_gmsh``).
        frac_edges: ``(>=2, ne)`` segment node indices; optional third row
            carries the originating fracture index for physical naming.
        mesh_size_frac / mesh_size_bound: characteristic lengths at
            fracture and boundary points.
    """

    def __init__(
        self,
        domain_box: dict,
        frac_pts: np.ndarray,
        frac_edges: np.ndarray,
        mesh_size_frac: float,
        mesh_size_bound: Optional[float] = None,
    ) -> None:
        self.box = dict(domain_box)
        self.pts = np.asarray(frac_pts, dtype=float)
        self.edges = np.asarray(frac_edges, dtype=int)
        self.h_frac = float(mesh_size_frac)
        self.h_bound = float(mesh_size_bound or mesh_size_frac)

    def generate(self, file_name: str) -> str:
        """Write the ``.geo`` script; returns the file name."""
        lines: list[str] = [
            "// Generated by porepy_tpu GmshWriter (native .geo emitter)",
            'SetFactory("Built-in");',
        ]
        np_frac = self.pts.shape[1]
        for i in range(np_frac):
            x, y = float(self.pts[0, i]), float(self.pts[1, i])
            lines.append(
                f"Point({i + 1}) = {{{x!r}, {y!r}, 0.0, {self.h_frac!r}}};"
            )
        b = self.box
        corners = [
            (float(b["xmin"]), float(b["ymin"])),
            (float(b["xmax"]), float(b["ymin"])),
            (float(b["xmax"]), float(b["ymax"])),
            (float(b["xmin"]), float(b["ymax"])),
        ]
        corner_ids = []
        for k, (x, y) in enumerate(corners):
            pid = np_frac + k + 1
            corner_ids.append(pid)
            lines.append(
                f"Point({pid}) = {{{x!r}, {y!r}, 0.0, {self.h_bound!r}}};"
            )
        # Boundary lines + surface.
        bline_ids = []
        for k in range(4):
            lid = k + 1
            bline_ids.append(lid)
            a, c = corner_ids[k], corner_ids[(k + 1) % 4]
            lines.append(f"Line({lid}) = {{{a}, {c}}};")
            lines.append(
                f'Physical Line("{PhysicalNames.DOMAIN_BOUNDARY_LINE.value}{k}")'
                f" = {{{lid}}};"
            )
        lines.append(
            f"Curve Loop(1) = {{{', '.join(str(i) for i in bline_ids)}}};"
        )
        lines.append("Plane Surface(1) = {1};")
        lines.append(f'Physical Surface("{PhysicalNames.DOMAIN.value}") = {{1}};')

        # Fracture lines, embedded in the surface, grouped per fracture.
        frac_of_edge = (
            self.edges[2]
            if self.edges.shape[0] > 2
            else np.arange(self.edges.shape[1])
        )
        per_frac: dict[int, list[int]] = {}
        for e in range(self.edges.shape[1]):
            lid = 4 + e + 1
            a, c = self.edges[0, e] + 1, self.edges[1, e] + 1
            lines.append(f"Line({lid}) = {{{a}, {c}}};")
            lines.append(f"Curve{{{lid}}} In Surface{{1}};")
            per_frac.setdefault(int(frac_of_edge[e]), []).append(lid)
        for fi, lids in sorted(per_frac.items()):
            lines.append(
                f'Physical Line("{PhysicalNames.FRACTURE.value}{fi}") = '
                f"{{{', '.join(str(i) for i in lids)}}};"
            )

        # Points shared by several fractures are intersection points.
        counts = np.zeros(np_frac, dtype=int)
        for e in range(self.edges.shape[1]):
            counts[self.edges[0, e]] += 1
            counts[self.edges[1, e]] += 1
        isect = 0
        for i in np.flatnonzero(counts > 2):
            lines.append(f"Point{{{i + 1}}} In Surface{{1}};")
            lines.append(
                f'Physical Point("{PhysicalNames.FRACTURE_INTERSECTION_POINT.value}'
                f'{isect}") = {{{i + 1}}};'
            )
            isect += 1

        text = "\n".join(lines) + "\n"
        with open(file_name, "w") as f:
            f.write(text)
        return file_name


class GmshWriter3d:
    """Write a 3d fractured-box geometry as a standalone gmsh ``.geo``
    script (structural counterpart of the reference's gmsh-API writer,
    ``fracs/gmsh_interface.py:305``, and of the checked-in benchmark
    geometry files, e.g.
    ``applications/md_grids/gmsh_file_library/benchmark_3d_case_2``).

    Consumes a :class:`FractureNetwork3d` decomposition (points, split
    edges, per-fracture boundary polygons, embedded intersection lines):
    each fracture becomes a plane surface embedded in the box volume,
    intersection lines are embedded in their surfaces and tagged with
    porepy physical names so the native MSH parser
    (:func:`porepy_tpu.fracs.msh_2_grid.create_grids_from_msh`) recovers
    the mixed-dimensional structure.

    Restriction: fracture polygons must lie strictly inside the domain box
    (clip with ``impose_external_boundary`` margins first); embedding
    fracture edges in the box boundary surfaces is not supported.
    """

    def __init__(
        self,
        domain_box: dict,
        decomposition: dict,
        mesh_size_frac: float,
        mesh_size_bound: Optional[float] = None,
        tol: float = 1e-8,
    ) -> None:
        self.box = dict(domain_box)
        self.dec = decomposition
        self.h_frac = float(mesh_size_frac)
        self.h_bound = float(mesh_size_bound or mesh_size_frac)
        self.tol = tol

    def generate(self, file_name: str) -> str:
        dec = self.dec
        pts = np.asarray(dec["points"], dtype=float)
        edges = np.asarray(dec["edges"], dtype=int)
        e2f = dec["edges_2_frac"]
        polygons = dec["polygons"]
        line_in_frac = dec["line_in_frac"]
        b = self.box
        lo = np.array([b["xmin"], b["ymin"], b["zmin"]], dtype=float)
        hi = np.array([b["xmax"], b["ymax"], b["zmax"]], dtype=float)
        on_bound = (
            (np.abs(pts - lo[:, None]) < self.tol)
            | (np.abs(pts - hi[:, None]) < self.tol)
        ).any(axis=0)
        if on_bound.any():
            raise NotImplementedError(
                "GmshWriter3d needs fracture points strictly inside the "
                "domain box"
            )

        out: list[str] = [
            "// Generated by porepy_tpu GmshWriter3d (native .geo emitter)",
            'SetFactory("Built-in");',
            "Geometry.Tolerance = 1e-10;",
        ]
        # Fracture/intersection points.
        for i in range(pts.shape[1]):
            x, y, z = (float(v) for v in pts[:, i])
            out.append(
                f"Point({i + 1}) = {{{x!r}, {y!r}, {z!r}, {self.h_frac!r}}};"
            )
        np_frac = pts.shape[1]

        # Box: corners, edges, boundary surfaces, volume.
        corners = [
            (lo[0], lo[1], lo[2]), (hi[0], lo[1], lo[2]),
            (hi[0], hi[1], lo[2]), (lo[0], hi[1], lo[2]),
            (lo[0], lo[1], hi[2]), (hi[0], lo[1], hi[2]),
            (hi[0], hi[1], hi[2]), (lo[0], hi[1], hi[2]),
        ]
        for k, (x, y, z) in enumerate(corners):
            out.append(
                f"Point({np_frac + k + 1}) = "
                f"{{{float(x)!r}, {float(y)!r}, {float(z)!r}, {self.h_bound!r}}};"
            )
        ne = edges.shape[1]
        box_edges = [
            (0, 1), (1, 2), (2, 3), (3, 0),
            (4, 5), (5, 6), (6, 7), (7, 4),
            (0, 4), (1, 5), (2, 6), (3, 7),
        ]
        for k, (a, c) in enumerate(box_edges):
            out.append(
                f"Line({ne + k + 1}) = {{{np_frac + a + 1}, {np_frac + c + 1}}};"
            )
        # Box faces as (edge index, sign) loops.
        box_faces = [
            [(1, 1), (2, 1), (3, 1), (4, 1)],        # bottom z=lo
            [(5, 1), (6, 1), (7, 1), (8, 1)],        # top z=hi
            [(1, 1), (10, 1), (-5, 1), (-9, 1)],     # y=lo
            [(3, 1), (12, 1), (-7, 1), (-11, 1)],    # y=hi
            [(4, 1), (9, 1), (-8, 1), (-12, 1)],     # x=lo
            [(2, 1), (11, 1), (-6, 1), (-10, 1)],    # x=hi
        ]
        surf = 0
        for k, loop in enumerate(box_faces):
            surf += 1
            ids = ", ".join(
                str(int(np.sign(e) * (ne + abs(e)))) for e, _s in loop
            )
            out.append(f"Curve Loop({surf}) = {{{ids}}};")
            out.append(f"Plane Surface({surf}) = {{{surf}}};")
            out.append(
                f'Physical Surface("{PhysicalNames.DOMAIN_BOUNDARY_SURFACE.value}{k}")'
                f" = {{{surf}}};"
            )
        out.append(
            "Surface Loop(1) = {"
            + ", ".join(str(s + 1) for s in range(6))
            + "};"
        )
        out.append("Volume(1) = {1};")
        out.append(f'Physical Volume("{PhysicalNames.DOMAIN.value}") = {{1}};')

        # Fracture edges (decomposition lines).
        edge_of = {}
        for e in range(ne):
            a, c = int(edges[0, e]), int(edges[1, e])
            out.append(f"Line({e + 1}) = {{{a + 1}, {c + 1}}};")
            edge_of[(min(a, c), max(a, c))] = e

        # Fracture surfaces.
        for fi, chain in enumerate(polygons):
            chain = np.asarray(chain, dtype=int)
            loop_ids = []
            # ``polygons`` stores sorted point-pair chains (2, n) with
            # column j = (start, end) of segment j.
            for j in range(chain.shape[1]):
                a, c = int(chain[0, j]), int(chain[1, j])
                e = edge_of[(min(a, c), max(a, c))]
                sign = 1 if (int(edges[0, e]), int(edges[1, e])) == (a, c) else -1
                loop_ids.append(sign * (e + 1))
            surf += 1
            out.append(
                f"Curve Loop({surf}) = "
                f"{{{', '.join(str(i) for i in loop_ids)}}};"
            )
            out.append(f"Plane Surface({surf}) = {{{surf}}};")
            out.append(f"Surface{{{surf}}} In Volume{{1}};")
            for e in line_in_frac[fi]:
                out.append(f"Curve{{{int(e) + 1}}} In Surface{{{surf}}};")
            out.append(
                f'Physical Surface("{PhysicalNames.FRACTURE.value}{fi}") = '
                f"{{{surf}}};"
            )

        # Intersection lines (edges shared by two or more fractures).
        n_isect = 0
        point_line_count: dict[int, int] = {}
        for e in range(ne):
            fracs = np.atleast_1d(np.asarray(e2f[e])).ravel()
            if np.unique(fracs).size < 2:
                continue
            out.append(
                f'Physical Curve("{PhysicalNames.FRACTURE_INTERSECTION_LINE.value}'
                f'{n_isect}") = {{{e + 1}}};'
            )
            n_isect += 1
            for p in (int(edges[0, e]), int(edges[1, e])):
                point_line_count[p] = point_line_count.get(p, 0) + 1
        # Crossing points of intersection lines.
        n_ip = 0
        for p, cnt in sorted(point_line_count.items()):
            if cnt < 2:
                continue
            out.append(
                f'Physical Point("{PhysicalNames.FRACTURE_INTERSECTION_POINT.value}'
                f'{n_ip}") = {{{p + 1}}};'
            )
            n_ip += 1

        with open(file_name, "w") as fh:
            fh.write("\n".join(out) + "\n")
        return file_name
