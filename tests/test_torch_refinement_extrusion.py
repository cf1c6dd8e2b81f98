"""Grid refinement and extrusion through porepy_tpu_torch on the CPU
(``grids/refinement.py`` and ``grids/grid_extrusion.py``, copied from
porepy_tpu): ``tests/grids/test_refinement.py`` and ``test_extrusion.py``
on the port. Each test holds the port to the reference's golden that the
mirrored test reads (the same test name, so the same file in
``tests/goldens/``), with that test's tolerances, and to porepy_tpu's
result on the same input: nodes, face-node and cell-face maps, tags and
maps equal to the bit."""

import numpy as np
import scipy.sparse as sps

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu.grids import grid_extrusion as e_jax
from porepy_tpu.grids import refinement as r_jax
from porepy_tpu_torch.grids import grid_extrusion as my_e
from porepy_tpu_torch.grids import refinement as my_r
from tests.conftest import assert_sparse_equal

Z = np.array([0.0, 0.5, 1.0, 2.0])

_TAG_KEYS = ("fracture_faces", "tip_faces", "domain_boundary_faces")


def _equal(a, b, what=""):
    """Sparse or dense ``a`` and ``b`` equal entry for entry."""
    if sps.issparse(a) or sps.issparse(b):
        a, b = sps.csr_matrix(a), sps.csr_matrix(b)
        assert a.shape == b.shape and (a != b).nnz == 0, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _same_grid(g, g_jax):
    """The port's grid ``g`` is porepy_tpu's ``g_jax`` to the bit."""
    for attr in ("nodes", "face_nodes", "cell_faces"):
        _equal(getattr(g, attr), getattr(g_jax, attr), attr)
    if hasattr(g_jax, "cell_volumes"):
        for attr in ("cell_volumes", "face_areas", "cell_centers", "face_normals"):
            _equal(getattr(g, attr), getattr(g_jax, attr), attr)
    for key in _TAG_KEYS:
        if key in g_jax.tags:
            _equal(g.tags[key], g_jax.tags[key], key)


def _tensor_1d(mod):
    g = mod.TensorGrid(np.array([0, 0.3, 0.7, 1.0]))
    g.compute_geometry()
    return g


# -- tests/grids/test_refinement.py -----------------------------------------------


def test_refine_grid_1d(golden):
    hm = my_r.refine_grid_1d(_tensor_1d(pt), 3)
    _same_grid(hm, r_jax.refine_grid_1d(_tensor_1d(pt_jax), 3))

    def compute(ref_pp):
        import porepy.grids.refinement as rr

        gr = ref_pp.TensorGrid(np.array([0, 0.3, 0.7, 1.0]))
        gr.compute_geometry()
        hr = rr.refine_grid_1d(gr, 3)
        return {
            "num_cells": np.array([hr.num_cells]),
            "nodes_sorted": np.sort(hr.nodes[0]),
            "cell_centers": np.asarray(hr.cell_centers),
        }

    rec = golden(compute)
    assert hm.num_cells == int(rec["num_cells"][0])
    assert np.allclose(np.sort(hm.nodes[0]), rec["nodes_sorted"])
    assert np.allclose(hm.cell_centers, rec["cell_centers"])


def test_refine_triangle_grid(golden):
    out = []
    for mod in (pt, pt_jax):
        g = mod.StructuredTriangleGrid([2, 2], [1.0, 1.0])
        g.compute_geometry()
        h, parent = (my_r if mod is pt else r_jax).refine_triangle_grid(g)
        h.compute_geometry()
        out.append((g, h, parent))
    (g, hm, pm), (_g, hj, pj) = out
    _same_grid(hm, hj)
    _equal(pm, pj, "parent")

    def compute(ref_pp):
        import porepy.grids.refinement as rr

        gr = ref_pp.StructuredTriangleGrid(np.array([2, 2]), np.array([1.0, 1.0]))
        gr.compute_geometry()
        hr, pr = rr.refine_triangle_grid(gr)
        hr.compute_geometry()
        return {
            "num_cells": np.array([hr.num_cells]),
            "parent": np.asarray(pr),
            "nodes": np.asarray(hr.nodes),
            "vols_sorted": np.sort(hr.cell_volumes),
        }

    rec = golden(compute)
    assert hm.num_cells == int(rec["num_cells"][0]) == 4 * g.num_cells
    assert np.array_equal(pm, rec["parent"])
    assert np.allclose(hm.nodes, rec["nodes"])
    assert np.allclose(np.sort(hm.cell_volumes), rec["vols_sorted"])


def test_remesh_1d(golden):
    hm = my_r.remesh_1d(_tensor_1d(pt), 7)
    _same_grid(hm, r_jax.remesh_1d(_tensor_1d(pt_jax), 7))

    def compute(ref_pp):
        import porepy.grids.refinement as rr

        gr = ref_pp.TensorGrid(np.array([0, 0.3, 0.7, 1.0]))
        gr.compute_geometry()
        return {"nodes": np.asarray(rr.remesh_1d(gr, 7).nodes)}

    rec = golden(compute)
    assert np.allclose(hm.nodes, rec["nodes"])


def test_structured_refinement_mapping():
    """Coarse-to-fine map on a generic (non-symmetric) triangulation: each
    fine cell maps to the parent from the refinement; the map equals
    porepy_tpu's."""
    maps = []
    for mod, r in ((pt, my_r), (pt_jax, r_jax)):
        rng = np.random.default_rng(7)
        g = mod.TriangleGrid(rng.random((2, 12)))
        g.compute_geometry()
        h, _parent = r.refine_triangle_grid(g)
        h.compute_geometry()
        maps.append((g, h, r.structured_refinement(g, h)))
    (g, h, mapping), (_gj, hj, mapping_jax) = maps
    _same_grid(h, hj)
    _equal(mapping, mapping_jax, "mapping")
    assert mapping.shape == (h.num_cells, g.num_cells)
    rows, cols = mapping.nonzero()
    assert rows.size == h.num_cells  # every fine cell mapped exactly once
    # Geometric check: each mapped fine centroid lies in its coarse cell.
    from porepy_tpu_torch.geometry.geometry_property_checks import point_in_polygon

    cn = g.cell_nodes().tocsc()
    for fine, coarse in zip(rows[:20], cols[:20]):
        ni = cn.indices[cn.indptr[coarse] : cn.indptr[coarse + 1]]
        assert point_in_polygon(g.nodes[:2, ni], h.cell_centers[:2, fine])[0]


def test_distort_grid_1d_keeps_topology():
    out = []
    for mod, r in ((pt, my_r), (pt_jax, r_jax)):
        g = mod.TensorGrid(np.linspace(0, 1, 8))
        g.compute_geometry()
        np.random.seed(0)
        out.append(r.distort_grid_1d(g, ratio=0.3))
    g, g_jax = out
    _equal(g.nodes, g_jax.nodes, "nodes")
    assert np.all(np.diff(g.nodes[0]) > 0)
    assert np.isclose(g.nodes[0, 0], 0) and np.isclose(g.nodes[0, -1], 1)


# -- tests/grids/test_extrusion.py ------------------------------------------------


def test_extrude_cart_2d(golden):
    out = []
    for mod, e in ((pt, my_e), (pt_jax, e_jax)):
        g = mod.CartGrid([3, 2], [1.0, 1.0])
        g.compute_geometry()
        out.append(e.extrude_grid(g, Z))
    (hm, cm, fm), (hj, cj, fj) = out
    _same_grid(hm, hj)
    for i, (a, b) in enumerate(zip(cm, cj)):
        _equal(a, b, f"cell map {i}")
    for i, (a, b) in enumerate(zip(fm, fj)):
        _equal(a, b, f"face map {i}")

    def compute(ref_pp):
        import porepy.grids.grid_extrusion as re_

        gr = ref_pp.CartGrid(np.array([3, 2]), np.array([1.0, 1.0]))
        gr.compute_geometry()
        hr, cr, fr = re_.extrude_grid(gr, Z)
        out = {
            "counts": np.array([hr.num_cells, hr.num_faces]),
            "nodes": np.asarray(hr.nodes),
            "cell_volumes": np.asarray(hr.cell_volumes),
            "cell_faces": hr.cell_faces,
        }
        for key in _TAG_KEYS:
            out[f"tag.{key}"] = np.asarray(hr.tags[key])
        for i, a in enumerate(cr):
            out[f"cmap{i}"] = np.asarray(a)
        return out

    rec = golden(compute)
    assert hm.num_cells == int(rec["counts"][0])
    assert hm.num_faces == int(rec["counts"][1])
    assert np.allclose(hm.nodes, rec["nodes"])
    assert np.allclose(hm.cell_volumes, rec["cell_volumes"])
    assert_sparse_equal(hm.cell_faces, rec["cell_faces"])
    for key in _TAG_KEYS:
        assert np.array_equal(hm.tags[key], rec[f"tag.{key}"])
    for i, a in enumerate(cm):
        assert np.array_equal(a, rec[f"cmap{i}"])


def test_extrude_triangles_and_1d(golden):
    grids = []
    for mod, e in ((pt, my_e), (pt_jax, e_jax)):
        g = mod.StructuredTriangleGrid([2, 2], [1.0, 1.0])
        g.compute_geometry()
        g1 = mod.TensorGrid(np.array([0.0, 0.4, 1.0]))
        g1.compute_geometry()
        grids.append((e.extrude_grid(g, Z)[0], e.extrude_grid(g1, Z)[0]))
    (hm, h1m), (hj, h1j) = grids
    _same_grid(hm, hj)
    _same_grid(h1m, h1j)

    def compute(ref_pp):
        import porepy.grids.grid_extrusion as re_

        gr = ref_pp.StructuredTriangleGrid(np.array([2, 2]), np.array([1.0, 1.0]))
        gr.compute_geometry()
        hr, _, _ = re_.extrude_grid(gr, Z)
        gr1 = ref_pp.TensorGrid(np.array([0.0, 0.4, 1.0]))
        gr1.compute_geometry()
        h1r, _, _ = re_.extrude_grid(gr1, Z)
        return {
            "tri.cell_volumes": np.asarray(hr.cell_volumes),
            "tri.face_areas": np.asarray(hr.face_areas),
            "t1.nodes": np.asarray(h1r.nodes),
            "t1.cell_faces": h1r.cell_faces,
        }

    rec = golden(compute)
    assert np.allclose(hm.cell_volumes, rec["tri.cell_volumes"])
    assert np.allclose(hm.face_areas, rec["tri.face_areas"])
    assert np.allclose(h1m.nodes, rec["t1.nodes"])
    assert_sparse_equal(h1m.cell_faces, rec["t1.cell_faces"])


def _fractured(mod):
    return mod.create_mdg(
        "cartesian",
        {"cell_size": 0.5},
        mod.create_fracture_network(
            [mod.LineFracture(np.array([[0.0, 1.0], [0.5, 0.5]]))],
            mod.Domain({"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1}),
        ),
    )


def test_extrude_fractured_mdg(golden):
    em, _ = my_e.extrude_mdg(_fractured(pt), Z)
    em.compute_geometry()
    ej, _ = e_jax.extrude_mdg(_fractured(pt_jax), Z)
    ej.compute_geometry()
    for sd, sdj in zip(em.subdomains(), ej.subdomains()):
        _same_grid(sd, sdj)
    for intf, intfj in zip(em.interfaces(), ej.interfaces()):
        for proj in ("mortar_to_secondary_int", "primary_to_mortar_int", "primary_to_mortar_avg"):
            _equal(getattr(intf, proj)(), getattr(intfj, proj)(), proj)

    def compute(ref_pp):
        import porepy.grids.grid_extrusion as re_

        er, _ = re_.extrude_mdg(_fractured(ref_pp), Z)
        er.compute_geometry()
        ir = er.interfaces()[0]
        return {
            "sd_cells": np.array([s.num_cells for s in er.subdomains()]),
            "intf": np.array([ir.num_cells, ir.num_sides()]),
            "m2s": ir.mortar_to_secondary_int(),
            "p2m": ir.primary_to_mortar_int(),
        }

    rec = golden(compute)
    assert [s.num_cells for s in em.subdomains()] == list(rec["sd_cells"])
    im = em.interfaces()[0]
    assert im.num_cells == int(rec["intf"][0])
    assert im.num_sides() == int(rec["intf"][1]) == 2
    assert_sparse_equal(im.mortar_to_secondary_int(), rec["m2s"])
    assert_sparse_equal(im.primary_to_mortar_int(), rec["p2m"])
