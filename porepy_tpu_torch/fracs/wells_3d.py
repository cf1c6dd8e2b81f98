"""Wells as polylines embedded in 3d domains.

Behavioral counterpart of reference ``fracs/wells_3d.py``: a :class:`Well`
is a polyline, a :class:`WellNetwork3d` collects wells and meshes them into
an existing mixed-dimensional grid (reference ``wells_3d.py:325``). Module
functions compute well-fracture (reference ``wells_3d.py:508``) and
well-matrix (reference ``wells_3d.py:567``, codim-2 coupling through an
ADTree search) intersections.

The construction here is organized differently from the reference's
stateful single pass: meshing first *splits* each polyline into sub-lines
at fracture-intersection points (pure classification, :func:`_split_well`),
then *builds* grids and interfaces from those descriptors — 0d intersection
grids are created once per intersection point and wired to both neighboring
sub-lines, instead of being recovered by position in the mdg's subdomain
list. All of this is host-side mesh construction: plain numpy/scipy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import scipy.sparse as sps

from porepy_tpu_torch.geometry import distances
from porepy_tpu_torch.geometry import intersections as isect_mod
from porepy_tpu_torch.grids.mortar_grid import MortarGrid, MortarSides
from porepy_tpu_torch.grids.point_grid import PointGrid
from porepy_tpu_torch.grids.structured import TensorGrid
from porepy_tpu_torch.utils import adtree, tags as tag_utils
from porepy_tpu_torch.utils.array_operations import expand_index_pointers

__all__ = [
    "Well",
    "WellNetwork3d",
    "compute_well_fracture_intersections",
    "compute_well_rock_matrix_intersections",
]


class Well:
    """A single well: a polyline in 3d given by its points (3, num_points)."""

    dim = 1

    def __init__(self, points, index=None, tags=None) -> None:
        self.pts = np.asarray(points, dtype=float)
        self.orig_pts = self.pts.copy()
        self.tags: dict = dict(tags or {})
        self._index: int = -1 if index is None else int(index)

    @property
    def index(self) -> int:
        return self._index

    @index.setter
    def index(self, i: Optional[int] = None) -> None:
        self._index = -1 if i is None else i

    def num_points(self) -> int:
        return self.pts.shape[1]

    def num_segments(self) -> int:
        return self.num_points() - 1

    def segments(self) -> Iterator[tuple[tuple[int, int], np.ndarray]]:
        """Yield ((start index, end index), endpoint coordinates) per segment."""
        for i in range(self.num_segments()):
            yield (i, i + 1), self.pts[:, (i, i + 1)]

    def add_point(self, point: np.ndarray, ind: Optional[int] = None) -> None:
        if ind is None:
            self.pts = np.hstack((self.pts, point))
        else:
            self.pts = np.hstack((self.pts[:, :ind], point, self.pts[:, ind:]))

    def _mesh_size(self, segment_ind=None) -> Optional[float]:
        """Per-well/segment mesh size override; None defers to the network."""
        return None

    def copy(self) -> "Well":
        return Well(np.copy(self.pts), tags=self.tags.copy())

    def __repr__(self) -> str:
        return f"Well(index={self.index}, segments={self.num_segments()})"


@dataclass
class _SubLine:
    """A run of consecutive polyline points between split events (fracture
    intersections or well ends), plus the classification of its two ends."""

    point_ids: list[int]
    # Per end (start, end): "fracture" | "boundary" | "tip".
    kind: list[str] = field(default_factory=lambda: ["tip", "tip"])


class WellNetwork3d:
    """Collection of wells with meshing functionality."""

    def __init__(
        self,
        domain,
        wells: Optional[list[Well]] = None,
        tol: float = 1e-8,
        parameters: Optional[dict] = None,
    ) -> None:
        self.domain = domain
        self.well_dim: int = 1
        self.wells: list[Well] = wells if wells is not None else []
        for i, w in enumerate(self.wells):
            w.index = i
        self.parameters: dict = parameters if parameters is not None else {}
        self.tol = tol
        self.tags: dict = {}

    def add(self, well: Well) -> None:
        inds = [w.index for w in self.wells]
        well.index = (max(inds) + 1) if inds else 0
        self.wells.append(well)

    def _mesh_size(self, well: Well, segment_ind=None) -> float:
        size = well._mesh_size(segment_ind)
        if size is None:
            size = self.parameters["mesh_size"]
        return size

    # -- meshing ---------------------------------------------------------------

    def _on_domain_boundary(self, point: np.ndarray) -> bool:
        for plane in self.domain.polytope_from_bounding_box():
            dist, _, _ = distances.points_polygon(
                point.reshape((3, 1)), plane
            )
            if np.isclose(np.asarray(dist).ravel()[0], 0):
                return True
        return False

    def _split_well(self, w: Well) -> tuple[list[_SubLine], list[np.ndarray]]:
        """Classify the polyline: sub-lines break at points tagged with a
        fracture intersection; untagged interior kinks are absorbed. End
        points without a fracture are 'boundary' if they lie on the domain
        boundary, else internal 'tip's."""
        tags_w = w.tags.get(
            "intersecting_fractures", [np.empty(0)] * w.num_points()
        )
        if any(t.size > 1 for t in tags_w):
            raise NotImplementedError(
                "Wells meeting several fractures in one point are not "
                "supported"
            )

        def end_kind(i: int) -> str:
            if tags_w[i].size > 0:
                return "fracture"
            return "boundary" if self._on_domain_boundary(w.pts[:, i]) else "tip"

        last = w.num_points() - 1
        sublines: list[_SubLine] = []
        current = _SubLine([0], [end_kind(0), ""])
        for i in range(1, w.num_points()):
            current.point_ids.append(i)
            if i == last or tags_w[i].size > 0:
                current.kind[1] = end_kind(i)
                sublines.append(current)
                current = _SubLine([i], ["fracture", ""])
        return sublines, tags_w

    def _build_subline_grid(self, w: Well, sub: _SubLine) -> TensorGrid:
        """1d piecewise-linear grid along the sub-line, one linspace per
        polyline segment at the (well/segment) mesh size, shared segment
        endpoints deduplicated."""
        pieces = []
        for a, b in zip(sub.point_ids[:-1], sub.point_ids[1:]):
            s, e = w.pts[:, a], w.pts[:, b]
            num = max(int(np.linalg.norm(e - s) / self._mesh_size(w, (a, b))), 2)
            piece = np.linspace(s, e, num).T
            pieces.append(piece if not pieces else piece[:, 1:])
        nodes = np.hstack(pieces)
        sd = TensorGrid(np.arange(nodes.shape[1], dtype=float))
        sd.nodes = nodes
        sd.compute_geometry()
        return sd

    def mesh(self, mdg) -> None:
        """Grid the wells and add them (plus 0d intersection grids and the
        connecting interfaces) to an existing md-grid.

        Requires ``tags['intersecting_fractures']`` on each well, as set by
        :func:`compute_well_fracture_intersections`.
        """
        well_num = 0
        for w in self.wells:
            sublines, tags_w = self._split_well(w)

            # One 0d grid per fracture-intersection point, shared by the
            # sub-lines meeting there; coupled to its fracture up front.
            isec_grids: dict[int, PointGrid] = {}
            for sub in sublines:
                for end in (0, 1):
                    pid = sub.point_ids[0] if end == 0 else sub.point_ids[-1]
                    if sub.kind[end] == "fracture" and pid not in isec_grids:
                        sd_isec = PointGrid(w.pts[:, pid])
                        sd_isec.history.append(
                            "Well-fracture intersection grid"
                        )
                        sd_isec.compute_geometry()
                        mdg.add_subdomains(sd_isec)
                        sd_isec.tags["parent_well_index"] = w.index
                        _couple_fracture_to_intersection(
                            sd_isec, tags_w[pid], mdg
                        )
                        isec_grids[pid] = sd_isec

            for sub in sublines:
                sd_w = self._build_subline_grid(w, sub)
                mdg.add_subdomains(sd_w)
                sd_w.well_num = well_num
                sd_w.name += " well " + str(well_num)
                sd_w.tags["parent_well_index"] = w.index
                well_num += 1

                for end, face, pid in (
                    (0, 0, sub.point_ids[0]),
                    (1, -1, sub.point_ids[-1]),
                ):
                    kind = sub.kind[end]
                    sd_w.tags["fracture_faces"][face] = kind == "fracture"
                    sd_w.tags["tip_faces"][face] = kind == "tip"
                    sd_w.tags["domain_boundary_faces"][face] = (
                        kind == "boundary"
                    )
                    if kind == "fracture":
                        _couple_well_to_intersection(
                            sd_w, isec_grids[pid], mdg
                        )

                bg_w = mdg.subdomain_to_boundary_grid(sd_w)
                if bg_w is not None:
                    # The boundary grid predates the face tags just set;
                    # rebuild its cell count and projections.
                    bg_w.num_cells = int(
                        np.sum(sd_w.tags["domain_boundary_faces"])
                    )
                    bg_w.set_projections()
                    bg_w.compute_geometry()

        for t in ("domain_boundary", "tip", "fracture"):
            tag_utils.add_node_tags_from_face_tags(mdg, t)

    def __repr__(self) -> str:
        return f"WellNetwork3d({len(self.wells)} wells)"


def compute_well_fracture_intersections(
    well_network: WellNetwork3d, fracture_network
) -> None:
    """Insert well-fracture intersection points into each well's polyline and
    tag every well point with the indices of the fractures meeting it
    (``tags['intersecting_fractures']``)."""
    boundary_tags = fracture_network.tags.get(
        "boundary", [False] * len(fracture_network.fractures)
    )
    interior_fracs = [
        f
        for f, on_boundary in zip(fracture_network.fractures, boundary_tags)
        if not on_boundary
    ]
    tol = well_network.tol if hasattr(well_network, "tol") else 1e-8
    for well in well_network.wells:
        pts_out: list[np.ndarray] = []
        tags_out: list[np.ndarray] = []
        last_seg = well.num_segments() - 1
        for (ia, ib), seg in well.segments():
            s, e = seg[:, 0], seg[:, 1]
            is_last = ia == last_seg
            # Candidate points on this segment: the two polyline endpoints
            # plus one hit per intersecting fracture; hits landing on an
            # existing candidate merge their fracture index into its tag.
            cand = [s, e]
            cand_tags: list[list[int]] = [[], []]
            for frac in interior_fracs:
                dist, hit = distances.segments_polygon(s, e, frac.pts)
                if dist > tol:
                    continue
                hit = np.asarray(hit).ravel()
                sep = np.asarray(
                    distances.point_pointset(hit.reshape((3, 1)), np.column_stack(cand))
                ).ravel()
                close = np.isclose(sep, 0)
                if close.any():
                    at = int(np.argmax(close))
                    if not (at == 1 and not is_last) and frac.index is not None:
                        # End-of-segment hits are handled by the NEXT
                        # segment (where they are its start), except on the
                        # last segment.
                        cand_tags[at].append(frac.index)
                else:
                    cand.append(hit)
                    cand_tags.append([frac.index])
            # Order interior hits by their parameter along the segment.
            t = [float(np.dot(p - s, e - s)) for p in cand[2:]]
            order = [0] + [2 + int(i) for i in np.argsort(t, kind="stable")]
            if is_last:
                order.append(1)
            for i in order:
                pts_out.append(cand[i])
                tags_out.append(np.asarray(cand_tags[i], dtype=float).ravel())
        well.pts = np.column_stack(pts_out)
        well.tags["intersecting_fractures"] = tags_out


def compute_well_rock_matrix_intersections(
    mdg,
    cells: Optional[np.ndarray] = None,
    min_length: float = 1e-10,
    tol: float = 1e-5,
) -> None:
    """Couple every well grid directly to the rock matrix (codim 2): for each
    well segment, find the matrix cells it crosses (ADTree box search +
    segment/polyhedron clipping) and add a mortar interface whose
    primary-to-mortar map carries the in-cell length fractions."""
    dim_max = mdg.dim_max()
    sd_max = mdg.subdomains(dim=dim_max)[0]
    tree = adtree.ADTree(2 * sd_max.dim, sd_max.dim)
    tree.from_grid(sd_max, cells)

    cf = sd_max.cell_faces.tocsc()
    fn = sd_max.face_nodes.tocsc()

    def cell_polyhedron(c: int) -> np.ndarray:
        faces = cf.indices[cf.indptr[c] : cf.indptr[c + 1]]
        return np.array(
            [
                sd_max.nodes[:, fn.indices[fn.indptr[f] : fn.indptr[f + 1]]]
                for f in faces
            ]
        )

    for sd_w in mdg.subdomains(dim=dim_max - 2):
        if not hasattr(sd_w, "well_num"):
            continue
        # Segment endpoints: node pair per 1d cell.
        cn = sd_w.cell_nodes()
        pairs = cn.indices[
            expand_index_pointers(cn.indptr[:-1], cn.indptr[1:])
        ].reshape((-1, 2))
        entries: list[tuple[int, int, float]] = []
        for seg_id, (na, nb) in enumerate(pairs):
            s, e = sd_w.nodes[:, na], sd_w.nodes[:, nb]
            box = np.sort(np.vstack((s, e)), axis=0).ravel()
            for hit in tree.search(adtree.ADTNode("query", box)):
                c = tree.nodes[hit].key
                _, _, _, ratio = isect_mod.segments_polyhedron(
                    s, e, cell_polyhedron(c), tol
                )
                ratio = float(np.asarray(ratio).ravel()[0])
                if ratio > min_length:
                    entries.append((seg_id, c, ratio))

        rows, cols, vals = (
            zip(*entries) if entries else ((), (), ())
        )
        primary_secondary_map = sps.csc_matrix(
            (vals, (rows, cols)), shape=(sd_w.num_cells, sd_max.num_cells)
        )

        side_g = {MortarSides.LEFT_SIDE: sd_w.copy()}
        mg = MortarGrid(sd_w.dim, side_g, codim=sd_max.dim - sd_w.dim)
        mg._primary_to_mortar_int = primary_secondary_map
        mg._primary_to_mortar_avg = primary_secondary_map.copy()
        eye = sps.diags(np.ones(sd_w.num_cells), format="csc")
        mg._secondary_to_mortar_int = eye
        mg._secondary_to_mortar_avg = eye.copy()
        mg._set_projections()
        mg.compute_geometry()
        mdg.add_interface(mg, (sd_max, sd_w), primary_secondary_map)


# -- helpers -------------------------------------------------------------------


def _couple_fracture_to_intersection(sd_secondary, frac_num, mdg) -> None:
    """Codim-2 interface between the fracture ``frac_num`` and a 0d
    intersection grid (cell-to-cell map)."""
    sd_primary = next(
        sd for sd in mdg.subdomains() if sd.frac_num == frac_num
    )
    cell_primary = sd_primary.closest_cell(sd_secondary.cell_centers)
    cell_cell_map = sps.coo_matrix(
        (np.ones(1, dtype=bool), (np.array([0]), cell_primary)),
        shape=(sd_secondary.num_cells, sd_primary.num_cells),
    )
    _add_well_interface(sd_primary, sd_secondary, mdg, cell_cell_map)


def _couple_well_to_intersection(sd_primary, sd_secondary, mdg) -> None:
    """Codim-1 interface between a well grid and a 0d intersection grid
    (face-to-cell map on the well face nearest the point)."""
    vec = sd_primary.face_centers - sd_secondary.cell_centers
    face_h = np.array([np.argmin(np.sum(vec**2, axis=0))], dtype=int)
    face_cell_map = sps.coo_matrix(
        (np.ones(1, dtype=bool), (np.array([0]), face_h)),
        shape=(sd_secondary.num_cells, sd_primary.num_faces),
    )
    _add_well_interface(sd_primary, sd_secondary, mdg, face_cell_map)


def _add_well_interface(sd_primary, sd_secondary, mdg, primary_secondary_map) -> None:
    codim = sd_primary.dim - sd_secondary.dim
    side_g = {MortarSides.LEFT_SIDE: sd_secondary.copy()}
    mg = MortarGrid(0, side_g, primary_secondary_map, codim=codim)
    mg.compute_geometry()
    mdg.add_interface(mg, (sd_primary, sd_secondary), primary_secondary_map)
