"""Grid construction from point clouds (reference ``fracs/msh_2_grid.py``).

Currently: embedded 1d line grids (used by structured fracture meshing and,
later, by the gmsh-output reader).
"""

from __future__ import annotations

import numpy as np

from porepy_tpu_torch.geometry import map_geometry
from porepy_tpu_torch.grids.structured import TensorGrid

__all__ = ["create_embedded_line_grid", "parse_msh", "create_grids_from_msh"]


def create_embedded_line_grid(
    loc_coord: np.ndarray, glob_id: np.ndarray, tol: float = 1e-4
):
    """1d grid through collinear points embedded in 3d, with global node
    indices recorded (reference ``msh_2_grid.py:454``)."""
    loc_coord = np.asarray(loc_coord, dtype=float)
    loc_center = loc_coord.mean(axis=1, keepdims=True)
    sorted_coord, rot, active_dim, sort_ind = map_geometry.project_points_to_line(
        loc_coord, tol
    )
    g = TensorGrid(sorted_coord)
    nodes = np.zeros(g.nodes.shape)
    nodes[active_dim] = g.nodes[0]
    g.nodes = rot.T @ nodes + loc_center
    g.global_point_ind = np.asarray(glob_id)[sort_ind]
    return g


# -- native MSH 4.1 reader -----------------------------------------------------


def parse_msh(file_name: str) -> dict:
    """Parse a gmsh MSH 4.1 ASCII file without gmsh/meshio.

    Returns ``{"nodes": (3, nn) coords, "node_tags": original tags,
    "elements": [(dim, physical_names, type, node_index_array), ...],
    "physical": {(dim, tag): name}}`` with node indices remapped to
    0-based contiguous.
    """
    with open(file_name) as f:
        lines = f.read().splitlines()
    sections: dict[str, list[str]] = {}
    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        if ln.startswith("$") and not ln.startswith("$End"):
            name = ln[1:]
            j = i + 1
            body = []
            while j < len(lines) and not lines[j].strip().startswith("$End"):
                body.append(lines[j])
                j += 1
            sections[name] = body
            i = j + 1
        else:
            i += 1

    if "MeshFormat" in sections:
        version = sections["MeshFormat"][0].split()[0]
        if not version.startswith("4"):
            raise ValueError(
                f"Only MSH format 4.x is supported, got {version}"
            )

    physical: dict[tuple[int, int], str] = {}
    for ln in sections.get("PhysicalNames", [])[1:]:
        parts = ln.split(None, 2)
        if len(parts) == 3:
            physical[(int(parts[0]), int(parts[1]))] = parts[2].strip().strip('"')

    # Entities: map (dim, entity_tag) -> physical tags.
    ent_phys: dict[tuple[int, int], list[int]] = {}
    ent = sections.get("Entities")
    if ent:
        counts = [int(x) for x in ent[0].split()]
        row = 1
        for dim, num in enumerate(counts):
            for _ in range(num):
                parts = ent[row].split()
                row += 1
                tag = int(parts[0])
                # Points: tag x y z numPhys ...; others: tag 6 bbox numPhys...
                off = 4 if dim == 0 else 7
                n_phys = int(parts[off])
                ent_phys[(dim, tag)] = [
                    int(p) for p in parts[off + 1 : off + 1 + n_phys]
                ]

    # Nodes.
    body = sections["Nodes"]
    header = body[0].split()
    row = 1
    tags: list[int] = []
    coords: list[list[float]] = []
    for _ in range(int(header[0])):  # entity blocks
        _dim, _etag, _param, n_in_block = (int(x) for x in body[row].split())
        row += 1
        block_tags = [int(body[row + k]) for k in range(n_in_block)]
        row += n_in_block
        for k in range(n_in_block):
            coords.append([float(x) for x in body[row + k].split()[:3]])
        row += n_in_block
        tags.extend(block_tags)
    node_tags = np.asarray(tags, dtype=np.int64)
    nodes = np.asarray(coords, dtype=float).T
    remap = {t: i for i, t in enumerate(tags)}

    # Elements.
    elements = []
    body = sections["Elements"]
    header = body[0].split()
    row = 1
    nodes_per_type = {15: 1, 1: 2, 2: 3, 3: 4, 4: 4}
    for _ in range(int(header[0])):
        dim, etag, etype, n_in_block = (int(x) for x in body[row].split())
        row += 1
        conn = np.array(
            [
                [remap[int(t)] for t in body[row + k].split()[1:]]
                for k in range(n_in_block)
            ],
            dtype=np.int64,
        ).reshape(n_in_block, nodes_per_type.get(etype, -1))
        row += n_in_block
        names = [
            physical.get((dim, p), "") for p in ent_phys.get((dim, etag), [])
        ]
        elements.append((dim, names, etype, conn))

    return {
        "nodes": nodes,
        "node_tags": node_tags,
        "elements": elements,
        "physical": physical,
    }


def create_grids_from_msh(file_name: str) -> list[list]:
    """Per-dimension grid lists from a gmsh ``.msh`` file: 2d
    (``[[g_2d], g_1d, g_0d]``) or 3d (``[[g_3d], g_2d, g_1d, g_0d]``)
    ``.msh`` file with porepy-style physical names (DOMAIN, FRACTURE_k,
    FRACTURE_INTERSECTION_POINT_k), for
    ``fracs.meshing.subdomains_to_mdg``. The reader is native — no gmsh or
    meshio dependency (reference ``fracs/msh_2_grid.py:71-375`` uses
    meshio)."""
    from porepy_tpu_torch.fracs.gmsh_interface import PhysicalNames
    from porepy_tpu_torch.grids.point_grid import PointGrid
    from porepy_tpu_torch.grids.simplex import TriangleGrid

    parsed = parse_msh(file_name)
    if any(etype == 4 for _d, _n, etype, _c in parsed["elements"]):
        return _create_3d_grids_from_parsed(parsed)
    p = parsed["nodes"]

    tris = [
        conn
        for dim, names, etype, conn in parsed["elements"]
        if etype == 2
        and (not names or any(n.startswith("DOMAIN") for n in names))
    ]
    if not tris:
        raise ValueError("No domain triangles found in the msh file")
    tri = np.vstack(tris).T
    # Enforce ccw orientation.
    v1 = p[:2, tri[1]] - p[:2, tri[0]]
    v2 = p[:2, tri[2]] - p[:2, tri[0]]
    cw = (v1[0] * v2[1] - v1[1] * v2[0]) < 0
    tri[1, cw], tri[2, cw] = tri[2, cw], tri[1, cw]
    g_2d = TriangleGrid(p[:2], tri)
    g_2d.global_point_ind = np.arange(g_2d.num_nodes)
    g_2d.compute_geometry()

    frac_prefix = PhysicalNames.FRACTURE.value
    frac_nodes: dict[int, set] = {}
    for dim, names, etype, conn in parsed["elements"]:
        if etype != 1:
            continue
        for n in names:
            if n.startswith(frac_prefix) and n[len(frac_prefix) :].isdigit():
                fi = int(n[len(frac_prefix) :])
                frac_nodes.setdefault(fi, set()).update(conn.ravel().tolist())
    g_1d = []
    node_use = np.zeros(p.shape[1], dtype=int)
    for fi in sorted(frac_nodes):
        nodes_i = np.array(sorted(frac_nodes[fi]), dtype=int)
        if nodes_i.size < 2:
            continue
        coords = np.vstack([p[:2, nodes_i], np.zeros(nodes_i.size)])
        g = create_embedded_line_grid(coords, nodes_i)
        g.frac_num = fi
        g_1d.append(g)
        node_use[nodes_i] += 1

    g_0d = []
    ip = PhysicalNames.FRACTURE_INTERSECTION_POINT.value
    tagged = set()
    for dim, names, etype, conn in parsed["elements"]:
        if etype == 15 and any(n.startswith(ip) for n in names):
            tagged.update(conn.ravel().tolist())
    isect_nodes = (
        np.array(sorted(tagged), dtype=int)
        if tagged
        else np.where(node_use > 1)[0]
    )
    for node in isect_nodes:
        pg = PointGrid(np.hstack([p[:2, node], 0.0]))
        pg.global_point_ind = np.atleast_1d(node)
        g_0d.append(pg)

    return [[g_2d], g_1d, g_0d]


def _create_3d_grids_from_parsed(parsed: dict) -> list[list]:
    """3d branch of :func:`create_grids_from_msh`: tetrahedral matrix,
    triangle fracture surfaces, line intersection grids, point grids."""
    from porepy_tpu_torch.fracs.gmsh_interface import PhysicalNames
    from porepy_tpu_torch.grids.point_grid import PointGrid
    from porepy_tpu_torch.grids.simplex import TetrahedralGrid, TriangleGrid

    p = parsed["nodes"]

    tets = [
        conn
        for dim, names, etype, conn in parsed["elements"]
        if etype == 4
        and (not names or any(n.startswith("DOMAIN") for n in names))
    ]
    if not tets:
        raise ValueError("No domain tetrahedra found in the msh file")
    g_3d = TetrahedralGrid(p, np.vstack(tets).T)
    g_3d.global_point_ind = np.arange(g_3d.num_nodes)
    g_3d.compute_geometry()

    def compress(conn):
        """Local point set + connectivity + global ids for a sub-grid."""
        glob = np.unique(conn.ravel())
        local = -np.ones(p.shape[1], dtype=int)
        local[glob] = np.arange(glob.size)
        return p[:, glob], local[conn], glob

    frac_prefix = PhysicalNames.FRACTURE.value
    frac_tris: dict[int, list] = {}
    for dim, names, etype, conn in parsed["elements"]:
        if etype != 2:
            continue
        for n in names:
            if n.startswith(frac_prefix) and n[len(frac_prefix) :].isdigit():
                frac_tris.setdefault(int(n[len(frac_prefix) :]), []).append(conn)
    g_2d = []
    for fi in sorted(frac_tris):
        conn = np.vstack(frac_tris[fi])
        pts_loc, tri_loc, glob = compress(conn)
        g = TriangleGrid(pts_loc, tri_loc.T)
        g.global_point_ind = glob
        g.frac_num = fi
        g.compute_geometry()
        g_2d.append(g)

    line_prefix = PhysicalNames.FRACTURE_INTERSECTION_LINE.value
    line_nodes: dict[int, set] = {}
    for dim, names, etype, conn in parsed["elements"]:
        if etype != 1:
            continue
        for n in names:
            if n.startswith(line_prefix):
                key = n[len(line_prefix) :]
                li = int(key) if key.isdigit() else len(line_nodes)
                line_nodes.setdefault(li, set()).update(conn.ravel().tolist())
    g_1d = []
    for li in sorted(line_nodes):
        nodes_i = np.array(sorted(line_nodes[li]), dtype=int)
        if nodes_i.size < 2:
            continue
        g = create_embedded_line_grid(p[:, nodes_i], nodes_i)
        g_1d.append(g)

    g_0d = []
    for dim, names, etype, conn in parsed["elements"]:
        if etype == 15 and any(
            n.startswith(PhysicalNames.FRACTURE_INTERSECTION_POINT.value)
            for n in names
        ):
            for node in conn.ravel():
                pg = PointGrid(p[:, node])
                pg.global_point_ind = np.atleast_1d(node)
                g_0d.append(pg)

    return [[g_3d], g_2d, g_1d, g_0d]
