"""Fracture-conforming tetrahedral meshing of ARBITRARY planar fracture
networks — no gmsh required.

This is the in-image general-3d mesher (the reference meshes such networks
exclusively through gmsh, reference ``fracs/fracture_network_3d.py:202``):
it covers inclined, mutually intersecting rectangles such as the Berre et
al. (2021) benchmark case 3, which the lattice mesher
(:mod:`porepy_tpu.fracs.structured_simplex`) cannot.

Method: *sequential conforming plane cuts* of a structured Kuhn-tet
background lattice.

1. Start from a :class:`StructuredTetrahedralGrid` (six tets per cube).
2. For every distinct fracture plane (and, with ``exact_boundary``, the
   four side planes through each rectangle edge, normal to the fracture),
   split every tetrahedron crossed by the plane. The split is the classic
   marching-tetrahedra case analysis; wedges and pyramids are
   tetrahedralized with the smallest-global-index diagonal rules of
   Dompierre et al., "How to Subdivide Pyramids, Prisms and Hexahedra into
   Tetrahedra" (1999). Because every quadrilateral is split along the
   diagonal through its smallest global vertex index, the two cells on
   either side of any shared quad triangulate it identically — the mesh
   stays conforming with NO hanging nodes, by construction, through any
   number of successive cuts.
3. Nodes within a snap tolerance of the plane are projected onto it first
   (and locked, so later cuts cannot move them off an earlier fracture),
   which bounds the sliver angles the cuts can create.
4. Fracture subdomains are the triangle faces whose nodes lie on the
   fracture plane inside the (convex) fracture polygon; 1d intersection
   grids are the collinear chains of nodes shared by two fracture node
   sets, and 0d grids their crossing points — the general-geometry
   analogue of ``structured.lattice_intersection_grids``.

The result feeds the standard ``meshing.subdomains_to_mdg`` pipeline
(tagging, face splitting, mortar construction), exactly like the lattice
meshers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.fracs import meshing, msh_2_grid
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.grids.point_grid import PointGrid
from porepy_tpu_torch.grids.simplex import (
    StructuredTetrahedralGrid,
    TetrahedralGrid,
    TriangleGrid,
)

__all__ = ["cut_tet_grid", "cut_tet_subdomain_lists"]


# -- plane cutting ----------------------------------------------------------------


def _prism_tets(v):
    """Tetrahedralize the prism with triangles (v0,v1,v2) / (v3,v4,v5) and
    quads (0,1,4,3), (1,2,5,4), (2,0,3,5), using Dompierre's
    smallest-index rotation + diagonal rule (every quad is split along the
    diagonal through its smallest global vertex index)."""
    rots = (
        (0, 1, 2, 3, 4, 5),
        (1, 2, 0, 4, 5, 3),
        (2, 0, 1, 5, 3, 4),
        (3, 5, 4, 0, 2, 1),
        (4, 3, 5, 1, 0, 2),
        (5, 4, 3, 2, 1, 0),
    )
    pos = min(range(6), key=lambda i: v[i])
    for r in rots:
        if r[0] == pos:
            w = [v[i] for i in r]
            break
    if min(w[1], w[5]) < min(w[2], w[4]):
        return [
            (w[0], w[1], w[2], w[5]),
            (w[0], w[1], w[5], w[4]),
            (w[0], w[4], w[5], w[3]),
        ]
    return [
        (w[0], w[1], w[2], w[4]),
        (w[0], w[4], w[2], w[5]),
        (w[0], w[4], w[5], w[3]),
    ]


def _pyramid_tets(base, apex):
    """Tetrahedralize the pyramid with quad base cycle ``base`` and apex:
    base split along the diagonal through its smallest global index."""
    b0, b1, b2, b3 = base
    if min(b0, b2) < min(b1, b3):
        return [(b0, b1, b2, apex), (b0, b2, b3, apex)]
    return [(b1, b2, b3, apex), (b1, b3, b0, apex)]


def _cut_by_plane(nodes, tets, normal, offset, snap_tol, on_planes):
    """Split every tet crossed by the plane ``normal . x = offset``.

    Parameters:
        nodes: ``(3, n)`` coordinates (mutated: near-plane nodes are
            snapped onto the plane — constrained to stay on every earlier
            plane they were snapped to, i.e. moved along the intersection).
        tets: ``(4, nc)`` connectivity.
        snap_tol: absolute distance under which a node is snapped.
        on_planes: dict ``node -> list of unit normals`` of the planes the
            node already lies on exactly (mutated).

    Returns ``(nodes, tets)`` with new cut nodes appended; cut nodes are
    registered in ``on_planes``.
    """
    s = normal @ nodes - offset
    abs_s = np.abs(s)
    geo_tol = 1e-11 * max(1.0, abs(offset))

    # Candidate snap moves: unconstrained nodes project along the normal;
    # nodes already on earlier planes move within those planes (along the
    # intersection); over-constrained / nearly parallel nodes are cut
    # normally instead.
    snap_moves: dict[int, np.ndarray] = {}
    for idx in np.flatnonzero(abs_s < snap_tol):
        prev = on_planes.get(idx)
        if abs_s[idx] <= geo_tol:
            snap_moves[int(idx)] = np.zeros(3)
            continue
        if not prev:
            snap_moves[int(idx)] = -normal * s[idx]
            continue
        q, _ = np.linalg.qr(np.asarray(prev).T)
        u = normal - q @ (q.T @ normal)
        denom = normal @ u
        # Bound the move to ~2x snap_tol; a nearly parallel or
        # over-constrained node is cut normally instead of snapped.
        if abs(denom) < 0.5:
            continue
        snap_moves[int(idx)] = -(s[idx] / denom) * u

    # Quality guard: snapping must not flatten or INVERT any incident tet
    # (an inverted tet keeps the mesh combinatorially conforming but
    # geometrically self-overlapping — total volume silently drifts).
    # Un-snap the farthest offending vertex per bad tet until every
    # affected tet keeps a comfortably positive volume.
    def signed_vols(coords, cells):
        a = coords[:, cells[0]]
        e1 = coords[:, cells[1]] - a
        e2 = coords[:, cells[2]] - a
        e3 = coords[:, cells[3]] - a
        return np.einsum("in,in->n", np.cross(e1.T, e2.T).T, e3) / 6.0

    while snap_moves:
        mask = np.zeros(nodes.shape[1], dtype=bool)
        mask[list(snap_moves)] = True
        affected = np.flatnonzero(mask[tets].any(axis=0))
        cells = tets[:, affected]
        before = signed_vols(nodes, cells)
        moved = nodes.copy()
        for idx, delta in snap_moves.items():
            moved[:, idx] += delta
        after = signed_vols(moved, cells)
        # A snapped tet must keep at least a small fraction of its volume
        # and must not flip orientation.
        bad = (np.sign(after) != np.sign(before)) | (
            np.abs(after) < 1e-6 * np.abs(before)
        )
        if not bad.any():
            break
        changed = False
        for ci in cells[:, bad].T:
            order = ci[np.argsort(-abs_s[ci])]
            for v in order:
                if int(v) in snap_moves and abs_s[v] > geo_tol:
                    del snap_moves[int(v)]
                    changed = True
                    break
        if not changed:  # pragma: no cover - pre-existing degenerate tet
            raise AssertionError("degenerate tetrahedron before cutting")

    for idx, delta in snap_moves.items():
        nodes[:, idx] += delta
        s[idx] = 0.0
        on_planes.setdefault(idx, []).append(normal)

    sign = np.sign(s).astype(np.int8)
    tsign = sign[tets]
    has_pos = (tsign > 0).any(axis=0)
    has_neg = (tsign < 0).any(axis=0)
    cut = np.flatnonzero(has_pos & has_neg)
    if cut.size == 0:
        return nodes, tets

    new_pts: list[np.ndarray] = []
    new_parents: list[list] = []
    edge_cut: dict[tuple[int, int], int] = {}
    n0 = nodes.shape[1]

    def cut_point(a, b):
        key = (a, b) if a < b else (b, a)
        idx = edge_cut.get(key)
        if idx is None:
            t = s[a] / (s[a] - s[b])
            new_pts.append(nodes[:, a] + t * (nodes[:, b] - nodes[:, a]))
            # The cut point lies on every plane containing BOTH endpoints
            # (matched by object identity: one normal object per plane) —
            # crucially including the domain box planes, so later snaps
            # cannot drag boundary cut points off the boundary.
            pa = on_planes.get(a, ())
            pb = on_planes.get(b, ())
            new_parents.append(
                [pl for pl in pa if any(pl is q for q in pb)]
            )
            idx = n0 + len(new_pts) - 1
            edge_cut[key] = idx
        return idx

    out: list[tuple[int, int, int, int]] = []
    for ci in cut:
        vs = tets[:, ci]
        sg = tsign[:, ci]
        plus = [int(v) for v, g in zip(vs, sg) if g > 0]
        minus = [int(v) for v, g in zip(vs, sg) if g < 0]
        zero = [int(v) for v, g in zip(vs, sg) if g == 0]
        p, m = len(plus), len(minus)
        if p == 1 and m == 3 or p == 3 and m == 1:
            apex = plus[0] if p == 1 else minus[0]
            base = minus if p == 1 else plus
            c = [cut_point(apex, b) for b in base]
            out.append((apex, c[0], c[1], c[2]))
            out.extend(
                _prism_tets([c[0], c[1], c[2], base[0], base[1], base[2]])
            )
        elif p == 2 and m == 2:
            a1, a2 = plus
            b1, b2 = minus
            c11 = cut_point(a1, b1)
            c12 = cut_point(a1, b2)
            c21 = cut_point(a2, b1)
            c22 = cut_point(a2, b2)
            out.extend(_prism_tets([a1, c11, c12, a2, c21, c22]))
            out.extend(_prism_tets([b1, c11, c21, b2, c12, c22]))
        elif p == 1 and m == 1 and len(zero) == 2:
            a, b = plus[0], minus[0]
            c = cut_point(a, b)
            out.append((a, zero[0], zero[1], c))
            out.append((b, zero[0], zero[1], c))
        elif (p == 2 and m == 1) or (p == 1 and m == 2):
            (a1, a2), (b,) = (plus, minus) if p == 2 else (minus, plus)
            z = zero[0]
            c1 = cut_point(a1, b)
            c2 = cut_point(a2, b)
            out.append((b, c1, c2, z))
            out.extend(_pyramid_tets((a1, c1, c2, a2), z))
        else:  # pragma: no cover - excluded by has_pos & has_neg
            raise AssertionError((p, m, len(zero)))

    keep = np.ones(tets.shape[1], dtype=bool)
    keep[cut] = False
    tets = np.concatenate(
        [tets[:, keep], np.asarray(out, dtype=tets.dtype).T], axis=1
    )
    if new_pts:
        nodes = np.concatenate([nodes, np.asarray(new_pts).T], axis=1)
        for k in range(len(new_pts)):
            on_planes[n0 + k] = new_parents[k] + [normal]
    return nodes, tets


# -- fracture planes and polygons --------------------------------------------------


def _plane_of(f: np.ndarray):
    """(unit normal, offset) of the plane through the planar polygon
    ``f (3, m)``; raises if the points are not coplanar."""
    c = f.mean(axis=1)
    q = f - c[:, None]
    # Normal from the two dominant principal directions (robust for any
    # planar polygon, not just rectangles).
    _u, sv, vt = np.linalg.svd(q.T, full_matrices=True)
    if f.shape[1] > 3 and sv[2] > 1e-9 * max(sv[0], 1.0):
        raise ValueError("Fracture polygon is not planar")
    n = vt[2]
    n = n / np.linalg.norm(n)
    return n, float(n @ c)


def _polygon_mask(nodes, f, normal, offset, tol):
    """Mask of nodes on the plane AND inside the convex polygon ``f``."""
    on = np.abs(normal @ nodes - offset) < tol
    # In-plane basis.
    t1 = f[:, 1] - f[:, 0]
    t1 = t1 / np.linalg.norm(t1)
    t2 = np.cross(normal, t1)
    p2 = np.vstack([t1 @ nodes, t2 @ nodes])
    poly = np.vstack([t1 @ f, t2 @ f])
    inside = np.ones(nodes.shape[1], dtype=bool)
    m = poly.shape[1]
    # Convex polygon: consistent orientation first.
    area2 = 0.0
    for k in range(m):
        x1, y1 = poly[:, k]
        x2, y2 = poly[:, (k + 1) % m]
        area2 += x1 * y2 - x2 * y1
    orient = 1.0 if area2 > 0 else -1.0
    for k in range(m):
        a = poly[:, k]
        b = poly[:, (k + 1) % m]
        e = b - a
        cr = orient * (
            e[0] * (p2[1] - a[1]) - e[1] * (p2[0] - a[0])
        )
        inside &= cr > -tol
    return on & inside


def _intersection_grids(nodes, frac_node_sets, frac_edge_counts):
    """1d intersection-chain grids and 0d crossing-point grids for general
    (possibly inclined) fracture node sets: pairwise common nodes that are
    collinear form the intersection lines, TRIMMED to the maximal runs
    whose consecutive segments are triangle edges of BOTH fracture grids
    (near a fracture's polygon boundary the other fracture may tile the
    line further than this one); lines are split at nodes shared by
    several lines (the general-geometry analogue of
    ``structured.lattice_intersection_grids``)."""
    g_1d: list = []
    g_0d: list = []
    raw_lines: list[np.ndarray] = []

    def add_line(line_nodes):
        if line_nodes.size >= 2 and not any(
            np.array_equal(line_nodes, prev) for prev in raw_lines
        ):
            raw_lines.append(line_nodes)

    for i in range(len(frac_node_sets)):
        for j in range(i + 1, len(frac_node_sets)):
            common = np.intersect1d(frac_node_sets[i], frac_node_sets[j])
            if common.size < 2:
                continue
            coords = nodes[:, common]
            c0 = coords.mean(axis=1, keepdims=True)
            q = coords - c0
            _u, sv, vt = np.linalg.svd(q.T, full_matrices=False)
            if sv.size > 1 and sv[1] > 1e-8 * max(sv[0], 1e-300):
                continue  # not collinear: planes coincide or noise
            d = vt[0]
            order = np.argsort(d @ q, kind="stable")
            line_nodes = common[order]
            # Keep only runs where every segment is an edge in BOTH grids,
            # AND the sidedness signature — interior edge (two incident
            # fracture triangles) vs boundary edge (one) in each grid — is
            # constant along the run: a mortar interface must be uniformly
            # one- or two-sided (T-intersections are one-sided on the
            # abutting fracture).
            ci, cj = frac_edge_counts[i], frac_edge_counts[j]
            run = [line_nodes[0]]
            run_sig = None
            for a, b in zip(line_nodes[:-1], line_nodes[1:]):
                key = (int(a), int(b)) if a < b else (int(b), int(a))
                sig = (
                    (min(ci[key], 2), min(cj[key], 2))
                    if key in ci and key in cj
                    else None
                )
                if sig is not None and (run_sig is None or sig == run_sig):
                    run.append(b)
                    run_sig = sig
                else:
                    add_line(np.asarray(run))
                    run = [b]
                    run_sig = sig
            add_line(np.asarray(run))

    node_line_count: dict[int, int] = {}
    for line_nodes in raw_lines:
        for n in line_nodes:
            node_line_count[int(n)] = node_line_count.get(int(n), 0) + 1
    crossing = {n for n, c in node_line_count.items() if c > 1}

    for line_nodes in raw_lines:
        interior_breaks = [
            k
            for k in range(1, line_nodes.size - 1)
            if int(line_nodes[k]) in crossing
        ]
        bounds = [0] + interior_breaks + [line_nodes.size - 1]
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = line_nodes[a : b + 1]
            if seg.size < 2:
                continue
            g = msh_2_grid.create_embedded_line_grid(nodes[:, seg], seg)
            g_1d.append(g)

    for global_node in sorted(crossing):
        g = PointGrid(nodes[:, global_node])
        g.global_point_ind = np.atleast_1d(np.asarray(global_node))
        g_0d.append(g)
    return g_1d, g_0d


# -- public API ---------------------------------------------------------------------


def cut_tet_subdomain_lists(
    fracs: list[np.ndarray],
    nx: np.ndarray,
    physdims: Optional[list] = None,
    exact_boundary: bool = True,
    snap_frac: float = 0.2,
) -> list[list]:
    """Pristine per-dimension subdomain lists for an arbitrary planar
    fracture network, via conforming plane cuts of a Kuhn-tet lattice.

    Parameters:
        fracs: planar convex polygons, each ``(3, m)`` with ``m >= 3``
            (any orientation — inclined planes are the point).
        nx: lattice cubes per axis of the background grid.
        physdims: box dimensions (default unit cube).
        exact_boundary: additionally cut along the four side planes of each
            polygon edge (plane through the edge, normal to the fracture),
            so triangle edges align exactly with the polygon boundary.
            Without it the fracture outline is approximated by whole
            triangles (an O(h) geometry perturbation, but ~5x fewer cuts).
        snap_frac: nodes closer than ``snap_frac * h_min`` to a cut plane
            are projected onto it (sliver control).
    """
    nx = np.asarray(nx, dtype=int)
    g_bg = StructuredTetrahedralGrid(nx, physdims=physdims)
    nodes = np.asarray(g_bg.nodes, dtype=float).copy()
    cn = g_bg.cell_nodes().tocsc()
    tets = cn.indices.reshape((4, g_bg.num_cells), order="F").copy()
    # StructuredTetrahedralGrid defaults physdims to nx (unit cubes).
    dims = (
        np.asarray(physdims, dtype=float)
        if physdims is not None
        else nx.astype(float)
    )
    h_min = float(np.min(dims / nx))
    snap_tol = snap_frac * h_min
    # Membership tests (on-plane, in-polygon) use a FLOATING-POINT
    # tolerance, not the snap tolerance: after snapping/cutting, fracture
    # nodes lie on their planes to rounding error.
    geo_tol = 1e-9 * max(float(dims.max()), 1.0)

    fracs = [np.asarray(f, dtype=float) for f in fracs]
    planes: list[tuple[np.ndarray, float]] = []

    def add_plane(n, d):
        for n2, d2 in planes:
            if (
                abs(abs(n @ n2) - 1.0) < 1e-12
                and abs(d * np.sign(n @ n2) - d2) < 1e-12
            ):
                return
        planes.append((n, d))

    frac_planes = []
    for f in fracs:
        n, d = _plane_of(f)
        frac_planes.append((n, d))
        add_plane(n, d)
        if exact_boundary:
            m = f.shape[1]
            for k in range(m):
                e = f[:, (k + 1) % m] - f[:, k]
                sn = np.cross(e, n)
                nrm = np.linalg.norm(sn)
                if nrm < 1e-14:
                    continue
                sn = sn / nrm
                add_plane(sn, float(sn @ f[:, k]))

    # Seed the plane constraints with the six box faces so snapping can
    # never move a boundary node off the domain boundary (it may still
    # slide within a face/edge; corners are fully locked).
    on_planes: dict[int, list] = {}
    for axis in range(3):
        for val in (0.0, float(dims[axis])):
            e = np.zeros(3)
            e[axis] = 1.0  # ONE object per box plane: identity = membership
            for idx in np.flatnonzero(
                np.abs(nodes[axis] - val) < 1e-12 * max(dims[axis], 1.0)
            ):
                on_planes.setdefault(int(idx), []).append(e)
    for n, d in planes:
        nodes, tets = _cut_by_plane(nodes, tets, n, d, snap_tol, on_planes)

    g_3d = TetrahedralGrid(nodes, tets)
    g_3d.global_point_ind = np.arange(g_3d.num_nodes)
    g_3d.compute_geometry()
    # TetrahedralGrid re-orders nothing node-wise, but guard anyway:
    nodes = np.asarray(g_3d.nodes)

    fn = g_3d.face_nodes.tocsc()
    face_nodes = fn.indices.reshape((3, g_3d.num_faces), order="F")

    g_2d: list = []
    frac_node_sets: list[np.ndarray] = []
    frac_edge_counts: list[dict] = []
    for fi, (f, (n, d)) in enumerate(zip(fracs, frac_planes)):
        mask = _polygon_mask(nodes, f, n, d, geo_tol)
        in_frac = np.flatnonzero(mask[face_nodes].all(axis=0))
        if in_frac.size == 0:
            raise ValueError(
                f"Fracture {fi} matches no mesh faces; refine nx"
            )
        tri_glob = face_nodes[:, in_frac]
        used = np.unique(tri_glob)
        local = np.full(g_3d.num_nodes, -1, dtype=int)
        local[used] = np.arange(used.size)
        tri = local[tri_glob]
        pts = nodes[:, used]

        # Counter-clockwise connectivity in the fracture plane.
        t1 = f[:, 1] - f[:, 0]
        t1 = t1 / np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        p2 = np.vstack([t1 @ pts, t2 @ pts])
        v1 = p2[:, tri[1]] - p2[:, tri[0]]
        v2 = p2[:, tri[2]] - p2[:, tri[0]]
        cw = v1[0] * v2[1] - v1[1] * v2[0] < 0
        tri[1:, cw] = tri[:0:-1, cw]

        g = TriangleGrid(pts, tri)
        g.global_point_ind = used
        g.frac_num = fi
        g.compute_geometry()
        g_2d.append(g)
        frac_node_sets.append(used)
        edges: dict = {}
        for a, b in ((0, 1), (1, 2), (2, 0)):
            for u, v in zip(tri_glob[a], tri_glob[b]):
                key = (int(u), int(v)) if u < v else (int(v), int(u))
                edges[key] = edges.get(key, 0) + 1
        frac_edge_counts.append(edges)

    g_1d, g_0d = _intersection_grids(
        nodes, frac_node_sets, frac_edge_counts
    )
    return [[g_3d], g_2d, g_1d, g_0d]


def cut_tet_grid(
    fracs: list[np.ndarray],
    nx: np.ndarray,
    physdims: Optional[list] = None,
    exact_boundary: bool = True,
    **kwargs,
) -> MixedDimensionalGrid:
    """Mixed-dimensional grid for an arbitrary planar fracture network on
    a cut Kuhn-tet mesh (see :func:`cut_tet_subdomain_lists`)."""
    return meshing.subdomains_to_mdg(
        cut_tet_subdomain_lists(
            fracs, nx, physdims, exact_boundary=exact_boundary
        ),
        **kwargs,
    )
