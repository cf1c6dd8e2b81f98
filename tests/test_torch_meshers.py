"""The host meshers and mortar matching of porepy_tpu_torch (copied from
porepy_tpu: ``fracs/simplex.py``, ``fracs/gmsh_interface.py``,
``fracs/cut_tet.py``, ``grids/match_grids.py``), against porepy_tpu on the
CPU, both packages in one process. The 2d simplex mesh of the Flemisch et
al. cases 1, 3 and 4 (case 4 at 20 m) through ``FractureNetwork2d.mesh``
equals porepy_tpu's bit for bit; the checks of
``tests/fracs/test_simplex_meshing.py``, ``test_gmsh_interface.py``,
``test_cut_tet.py``, ``tests/grids/test_match_grids.py`` and
``test_mortar_updates.py`` run through the port, each against porepy_tpu's
result where porepy_tpu's test held one against a reference; and Berre et
al. 3d case 3's grid at refinement level 0 equals porepy_tpu's."""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu.fracs import meshing as meshing_jax
from porepy_tpu.grids import refinement as refinement_jax
from porepy_tpu_torch.fracs import meshing, simplex
from porepy_tpu_torch.fracs.cut_tet import cut_tet_grid, cut_tet_subdomain_lists
from porepy_tpu_torch.fracs.fracture_network import create_fracture_network
from porepy_tpu_torch.fracs.gmsh_interface import GmshWriter, PhysicalNames
from porepy_tpu_torch.fracs.msh_2_grid import create_grids_from_msh, parse_msh
from porepy_tpu_torch.grids import match_grids
from porepy_tpu_torch.grids.grid import Grid
from porepy_tpu_torch.grids.mdg_generation import create_mdg
from porepy_tpu_torch.grids.simplex import StructuredTetrahedralGrid, TriangleGrid
from porepy_tpu_torch.grids.structured import CartGrid, TensorGrid

torch.set_num_threads(1)

# The MSH 4.1 fixture writers of porepy_tpu's gmsh interface test.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fracs import test_gmsh_interface as gmsh_source  # noqa: E402

DOM = {"xmin": 0.0, "xmax": 1.0, "ymin": 0.0, "ymax": 1.0}
FRAC_PTS = np.array([[0.2, 0.8, 0.5, 0.5], [0.5, 0.5, 0.2, 0.8]])
FRAC_EDGES = np.array([[0, 2], [1, 3]])
SOLID = dict(permeability=1.0, porosity=0.1, residual_aperture=0.01, normal_permeability=1.0)


def _no_save(base):
    class NoSave(base):
        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    return NoSave


def _canonical(m):
    """``m`` as a CSR matrix with sorted, summed entries (the storage order
    of a CSC matrix's entries within a column is not part of the grid)."""
    m = sps.csr_matrix(m, copy=True)
    m.sum_duplicates()
    m.sort_indices()
    return m


def _same_grid(g, h):
    """Two grids' nodes, ``cell_faces`` and ``face_nodes`` equal to the bit."""
    assert (g.dim, g.num_cells, g.num_faces, g.num_nodes) == (h.dim, h.num_cells, h.num_faces, h.num_nodes)
    np.testing.assert_array_equal(g.nodes, h.nodes)
    for name in ("cell_faces", "face_nodes"):
        a, b = _canonical(getattr(g, name)), _canonical(getattr(h, name))
        for part in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, part), getattr(b, part), err_msg=name)


def _same_mdg(mdg, mdg_jax):
    for dim in range(mdg.dim_max(), -1, -1):
        mine, theirs = mdg.subdomains(dim=dim), mdg_jax.subdomains(dim=dim)
        assert len(mine) == len(theirs), dim
        for g, h in zip(mine, theirs):
            _same_grid(g, h)
    assert len(mdg.interfaces()) == len(mdg_jax.interfaces())
    for a, b in zip(mdg.interfaces(), mdg_jax.interfaces()):
        assert a.num_cells == b.num_cells
        assert abs(a.primary_to_mortar_int() - b.primary_to_mortar_int()).sum() == 0.0


def _benchmark_network(pkg, case):
    """Case ``case``'s fractures and domain as the example sets them, a
    network of ``pkg`` (either package)."""
    if case == 4:
        mod = __import__(f"{pkg.__name__}.examples.flow_benchmark_2d_case_4", fromlist=["x"])
        fracs = mod.benchmark_2d_case_4_fractures()
        box = {"xmin": 0, "xmax": 700.0, "ymin": 0, "ymax": 600.0}
    else:
        sets = __import__(f"{pkg.__name__}.applications.md_grids.fracture_sets", fromlist=["x"])
        fracs = getattr(sets, f"benchmark_2d_case_{case}")()
        box = dict(DOM)
    network_mod = __import__(f"{pkg.__name__}.fracs.fracture_network", fromlist=["x"])
    return network_mod.create_fracture_network(fracs, pkg.Domain(box))


@pytest.mark.parametrize("case, cell_size", [(1, 0.05), (3, 0.1), (4, 20.0)])
def test_benchmark_simplex_mesh_bit_for_bit(case, cell_size):
    """``triangle_grid_fractured_2d`` through ``FractureNetwork2d.mesh`` (it
    raised ``ImportError`` before ``fracs/simplex.py`` was ported) gives
    porepy_tpu's grids for the cases' published fractures at the examples'
    cell sizes: every subdomain's nodes, ``cell_faces`` and ``face_nodes``
    to the bit, and the same mortar projections."""
    from porepy_tpu.grids.mdg_generation import create_mdg as create_mdg_jax

    mdg = create_mdg("simplex", {"cell_size": cell_size}, _benchmark_network(pt, case))
    mdg_jax = create_mdg_jax("simplex", {"cell_size": cell_size}, _benchmark_network(pt_jax, case))
    _same_mdg(mdg, mdg_jax)
    if case == 4:
        assert len(mdg.subdomains(dim=1)) == 63
        assert mdg.subdomains(dim=2)[0].num_cells == sum(
            g.num_cells for g in mdg_jax.subdomains(dim=2)
        )


# -- tests/fracs/test_simplex_meshing.py through the port ----------------------


def test_cdt_geometric_integrity():
    subs = simplex.triangle_grid_fractured_2d(DOM, FRAC_PTS, FRAC_EDGES, 0.1)
    g2 = subs[0][0]
    assert g2.cell_volumes.min() > 0
    assert abs(g2.cell_volumes.sum() - 1.0) < 1e-10
    assert len(subs[1]) == 2
    assert len(subs[2]) == 1
    for fi, g1 in enumerate(subs[1]):
        seg = FRAC_PTS[:, FRAC_EDGES[:, fi]]
        lo, hi = seg.min(axis=1), seg.max(axis=1)
        assert np.all(g1.nodes[:2].min(axis=1) >= lo - 1e-10)
        assert np.all(g1.nodes[:2].max(axis=1) <= hi + 1e-10)
        g1.compute_geometry()
        length = np.linalg.norm(seg[:, 1] - seg[:, 0])
        assert abs(g1.cell_volumes.sum() - length) < 1e-10


def test_cdt_constraint_edges_are_faces():
    builder = simplex.ConformingTriangulation2d(DOM, FRAC_PTS, FRAC_EDGES, 0.1).build()
    edges = set()
    for i, j in ((0, 1), (1, 2), (0, 2)):
        for a, b in zip(builder.simplices[:, i], builder.simplices[:, j]):
            edges.add((min(a, b), max(a, b)))
    for c in builder.chains + builder.boundary_chains:
        nodes = c["nodes"]
        for a, b in zip(nodes[:-1], nodes[1:]):
            assert (min(a, b), max(a, b)) in edges


def test_simplex_model_linear_pressure_exact():
    class Lin(_no_save(pt.SinglePhaseFlow)):
        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[0]

    params = {"grid_type": "simplex", "meshing_arguments": {"cell_size": 0.2}, "device": "cpu"}
    m = Lin(params)
    pt.run_time_dependent_model(m, params)
    p = m.equation_system.get_variable_values(time_step_index=0)
    ex = 1.0 - m.mdg.subdomains()[0].cell_centers[0]
    assert np.linalg.norm(p - ex) / np.linalg.norm(ex) < 1e-10


def test_simplex_fractured_model_runs():
    class MD(_no_save(pt.SinglePhaseFlow)):
        def set_fractures(self):
            self._fractures = [
                pt.LineFracture(np.array([[0.2, 0.8], [0.5, 0.5]])),
                pt.LineFracture(np.array([[0.5, 0.5], [0.2, 0.8]])),
            ]

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

    params = {
        "grid_type": "simplex",
        "meshing_arguments": {"cell_size": 0.12},
        "material_constants": {"solid": pt.SolidConstants(**SOLID)},
        "device": "cpu",
    }
    m = MD(params)
    pt.run_time_dependent_model(m, params)
    p = m.equation_system.get_variable_values(["pressure"], time_step_index=0)
    assert p.min() > -1e-8 and p.max() < 1.0 + 1e-8


def _flow_on(pkg, mdg, device=None):
    """One step of md flow with a north-south pressure drop on ``mdg``."""

    class M(_no_save(pkg.SinglePhaseFlow)):
        def set_geometry(self):
            self.mdg = mdg
            self.nd = 2
            self._domain = pkg.Domain(dict(DOM))
            pkg.set_local_coordinate_projections(self.mdg)
            self.set_well_network()

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

    params = {
        "material_constants": {"solid": pkg.SolidConstants(**SOLID)},
        "time_manager": pkg.TimeManager([0, 1.0], 1.0, constant_dt=True),
    }
    if device:
        params["device"] = device
    m = M(params)
    pkg.run_time_dependent_model(m, params)
    return m.equation_system.get_variable_values(["pressure"], time_step_index=0)


def test_simplex_md_flow_parity():
    """``test_simplex_md_flow_parity`` through the port: md flow on the
    native simplex mesh of two crossing fractures; the pressure within 1e-8
    of porepy_tpu's on its own mesh of the same network (the reference
    golden's bound), and the two meshes the same to the bit."""
    from porepy_tpu.fracs import simplex as simplex_jax

    subs = simplex.triangle_grid_fractured_2d(DOM, FRAC_PTS, FRAC_EDGES, 0.15)
    subs_jax = simplex_jax.triangle_grid_fractured_2d(DOM, FRAC_PTS, FRAC_EDGES, 0.15)
    mdg = meshing.subdomains_to_mdg([[subs[0][0]], list(subs[1]), list(subs[2])])
    mdg_jax = meshing_jax.subdomains_to_mdg([[subs_jax[0][0]], list(subs_jax[1]), list(subs_jax[2])])
    _same_mdg(mdg, mdg_jax)
    p = _flow_on(pt, mdg, device="cpu")
    p_jax = np.asarray(_flow_on(pt_jax, mdg_jax))
    assert p.shape == p_jax.shape
    assert np.abs(p - p_jax).max() < 1e-8


# -- tests/fracs/test_gmsh_interface.py through the port -----------------------


def test_geo_writer_structure(tmp_path):
    """``test_geo_writer_structure`` through the port; the ``.geo`` text is
    porepy_tpu's writer's, character for character."""
    from porepy_tpu.fracs.gmsh_interface import GmshWriter as GmshWriterJax

    w = GmshWriter(DOM, FRAC_PTS, FRAC_EDGES, mesh_size_frac=0.1)
    path = w.generate(str(tmp_path / "net.geo"))
    text = open(path).read()
    assert text.count("Point(") == FRAC_PTS.shape[1] + 4
    assert 'Physical Surface("DOMAIN")' in text
    assert f'Physical Line("{PhysicalNames.FRACTURE.value}0")' in text
    assert f'Physical Line("{PhysicalNames.FRACTURE.value}1")' in text
    assert "In Surface{1}" in text
    for ln in text.splitlines():
        if ln.startswith("Point("):
            assert ln.rstrip(";").rstrip("}").split(",")[-1].strip() != ""
    path_jax = GmshWriterJax(DOM, FRAC_PTS, FRAC_EDGES, mesh_size_frac=0.1).generate(str(tmp_path / "jax.geo"))
    assert text == open(path_jax).read()


@pytest.fixture()
def msh_file(tmp_path):
    subs = simplex.triangle_grid_fractured_2d(DOM, FRAC_PTS, FRAC_EDGES, 0.2)
    return gmsh_source._write_msh41(str(tmp_path / "net.msh"), subs), subs


def test_msh_parse(msh_file):
    path, subs = msh_file
    parsed = parse_msh(path)
    assert parsed["nodes"].shape[1] == subs[0][0].num_nodes
    names = set(parsed["physical"].values())
    assert "DOMAIN" in names and "FRACTURE_0" in names


def test_msh_reader_builds_working_mdg(msh_file):
    path, subs = msh_file
    grids = create_grids_from_msh(path)
    g2 = grids[0][0]
    assert g2.num_cells == subs[0][0].num_cells
    assert len(grids[1]) == 2 and len(grids[2]) == 1
    assert np.isclose(g2.cell_volumes.sum(), 1.0)
    mdg = meshing.subdomains_to_mdg(grids)
    assert len(mdg.subdomains(dim=1)) == 2
    assert len(list(mdg.interfaces())) >= 4
    mdg.compute_geometry()


def test_msh_reader_3d_builds_working_mdg(tmp_path):
    g3 = StructuredTetrahedralGrid([4, 4, 4], [1.0, 1.0, 1.0])
    g3.compute_geometry()
    fn = g3.face_nodes.tocsc()
    fc = g3.face_centers
    on_plane = (
        np.isclose(fc[0], 0.5) & (fc[1] > 0.25) & (fc[1] < 0.75) & (fc[2] > 0.25) & (fc[2] < 0.75)
    )
    tris = [fn.indices[fn.indptr[f] : fn.indptr[f + 1]] for f in np.flatnonzero(on_plane)]
    assert len(tris) > 0
    path = gmsh_source._write_msh41_3d(str(tmp_path / "cube.msh"), g3, tris)

    grids = create_grids_from_msh(path)
    assert len(grids) == 4
    g3_read = grids[0][0]
    assert g3_read.num_cells == g3.num_cells
    assert len(grids[1]) == 1
    assert grids[1][0].num_cells == len(tris)
    assert np.isclose(g3_read.cell_volumes.sum(), 1.0)
    mdg = meshing.subdomains_to_mdg(grids)
    assert mdg.dim_max() == 3
    assert len(list(mdg.interfaces())) == 1
    mdg.compute_geometry()

    class M(_no_save(pt.SinglePhaseFlow)):
        def set_geometry(self):
            self.mdg = mdg
            self.nd = 3
            self._domain = pt.Domain({"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1, "zmin": 0, "zmax": 1})
            self.well_network = None

        def set_well_network(self):
            self.well_network = None

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[0]

    params = {
        "material_constants": {
            "solid": pt.SolidConstants(
                permeability=1.0, porosity=0.1, residual_aperture=1e-2, normal_permeability=1.0
            )
        },
        "device": "cpu",
    }
    m = M(params)
    pt.run_time_dependent_model(m, params)
    p = m.equation_system.get_variable_values(["pressure"], time_step_index=0)
    assert np.all(np.isfinite(p)) and p.min() > -1e-8 and p.max() < 1 + 1e-8


# -- tests/fracs/test_cut_tet.py through the port ------------------------------

INCLINED = np.array([[0.2, 0.8, 0.8, 0.2], [0.2, 0.2, 0.8, 0.8], [0.3, 0.3, 0.7, 0.7]])
CROSSING = np.array([[0.3, 0.7, 0.7, 0.3], [0.2, 0.2, 0.8, 0.8], [0.7, 0.7, 0.3, 0.3]])


def _conformity(g3, box):
    cf = g3.cell_faces
    cnt = np.asarray((cf != 0).sum(axis=1)).ravel()
    fc = g3.face_centers
    onb = np.zeros(g3.num_faces, dtype=bool)
    for a in range(3):
        onb |= (np.abs(fc[a]) < 1e-9) | (np.abs(fc[a] - box[a]) < 1e-9)
    assert ((cnt == 1) & ~onb).sum() == 0, "interior crack faces"
    assert (cnt > 2).sum() == 0, "over-shared faces"


def test_single_inclined_fracture_exact_geometry():
    """``test_single_inclined_fracture_exact_geometry`` through the port;
    the grids are porepy_tpu's to the bit."""
    from porepy_tpu.fracs.cut_tet import cut_tet_subdomain_lists as lists_jax

    sub = cut_tet_subdomain_lists([INCLINED], np.array([6, 6, 6]), physdims=[1, 1, 1])
    g3 = sub[0][0]
    assert np.isclose(g3.cell_volumes.sum(), 1.0, rtol=0, atol=1e-12)
    assert g3.cell_volumes.min() > 0
    _conformity(g3, (1.0, 1.0, 1.0))
    expected_area = 0.6 * np.hypot(0.6, 0.4)
    assert np.isclose(sub[1][0].cell_volumes.sum(), expected_area, rtol=1e-12)
    sub_jax = lists_jax([INCLINED], np.array([6, 6, 6]), physdims=[1, 1, 1])
    for mine, theirs in zip(sub, sub_jax):
        assert len(mine) == len(theirs)
        for g, h in zip(mine, theirs):
            _same_grid(g, h)


def test_single_inclined_fracture_mdg_and_flow():
    mdg = cut_tet_grid([INCLINED], np.array([6, 6, 6]), physdims=[1, 1, 1])
    mdg.compute_geometry()
    assert len(mdg.subdomains(dim=2)) == 1
    for intf in mdg.interfaces():
        rs = np.asarray(intf.primary_to_mortar_avg().sum(axis=1)).ravel()
        assert np.allclose(rs, 1.0)

    class Model(_no_save(pt.SinglePhaseFlow)):
        def set_geometry(self):
            self.mdg = mdg
            self.nd = 3
            self._domain = pt.Domain({"xmin": 0, "xmax": 1, "ymin": 0, "ymax": 1, "zmin": 0, "zmax": 1})
            self.set_well_network()

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

    params = {
        "material_constants": {"solid": pt.SolidConstants(**dict(SOLID, residual_aperture=1e-2))},
        "time_manager": pt.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "linear_solver": "scipy_sparse",
        "device": "cpu",
    }
    m = Model(params)
    pt.run_time_dependent_model(m, params)
    p = m.equation_system.get_variable_values(["pressure"], time_step_index=0)
    assert np.all(np.isfinite(p))
    assert p.min() > -1e-8 and p.max() < 1.0 + 1e-8


def test_crossing_inclined_fractures_have_intersection_grid():
    sub = cut_tet_subdomain_lists([INCLINED, CROSSING], np.array([6, 6, 6]), physdims=[1, 1, 1])
    assert len(sub[1]) == 2
    assert len(sub[2]) >= 1, "crossing planes must create a 1d grid"
    g3 = sub[0][0]
    assert np.isclose(g3.cell_volumes.sum(), 1.0, atol=1e-12)
    _conformity(g3, (1.0, 1.0, 1.0))
    mdg = cut_tet_grid([INCLINED, CROSSING], np.array([6, 6, 6]), physdims=[1, 1, 1])
    mdg.compute_geometry()
    assert len(mdg.subdomains(dim=1)) >= 1
    for intf in mdg.interfaces():
        rs = np.asarray(intf.primary_to_mortar_avg().sum(axis=1)).ravel()
        assert np.allclose(rs, 1.0)


def _case3_fractures():
    from pathlib import Path

    from porepy_tpu_torch.fracs import fracture_importer

    lib = Path(pt.__file__).parent / "applications/md_grids/file_library/benchmark_3d_case_3"
    network = fracture_importer.network_3d_from_csv(str(lib / "fracture_network.csv"))
    return [f.pts for f in network.fractures]


def test_berre_case3_network_meshes():
    """The meshing half of ``test_berre_case3_network_meshes_and_flows``
    through the port: the Berre et al. case 3 network (8 fractures,
    inclined and T-intersecting) on a 6 x 14 x 6 lattice fills the 1 x
    2.25 x 1 box conformingly, with 8 fracture grids and at least two
    intersection lines."""
    sub = cut_tet_subdomain_lists(
        _case3_fractures(), np.array([6, 14, 6]), physdims=[1.0, 2.25, 1.0], exact_boundary=False
    )
    g3 = sub[0][0]
    assert np.isclose(g3.cell_volumes.sum(), 2.25, atol=1e-10)
    _conformity(g3, (1.0, 2.25, 1.0))
    assert len(sub[1]) == 8
    assert len(sub[2]) >= 2, "case 3 has fracture intersections"


def test_public_facade_simplex_3d_without_gmsh(tmp_path, monkeypatch):
    """``test_public_facade_simplex_3d_without_gmsh`` through the port:
    ``create_mdg("simplex", ...)`` on a 3d network meshes by cut tets (it
    raised ``ImportError`` before ``fracs/cut_tet.py`` was ported)."""
    from porepy_tpu_torch.fracs.fracture import PlaneFracture

    monkeypatch.chdir(tmp_path)
    f = PlaneFracture(np.array([[1.2, 1.8, 1.8, 1.2], [2.2, 2.2, 2.8, 2.8], [0.3, 0.3, 0.7, 0.7]]))
    dom = pt.Domain({"xmin": 1, "xmax": 2, "ymin": 2, "ymax": 3, "zmin": 0, "zmax": 1})
    mdg = create_mdg("simplex", {"cell_size": 0.25}, create_fracture_network([f], dom))
    subs = mdg.subdomains()
    assert [g.dim for g in subs] == [3, 2]
    g3, g2 = subs
    assert np.isclose(g3.cell_volumes.sum(), 1.0, atol=1e-10)
    assert np.isclose(g2.cell_volumes.sum(), 0.6 * np.hypot(0.6, 0.4), rtol=1e-10)
    assert g3.nodes[0].min() >= 1.0 - 1e-12 and g3.nodes[1].min() >= 2.0 - 1e-12
    for intf in mdg.interfaces():
        rs = np.asarray(intf.primary_to_mortar_avg().sum(axis=1)).ravel()
        assert np.allclose(rs, 1.0)


def test_benchmark_3d_case_3_grid():
    """``mdg_library.benchmark_3d_case_3(refinement_level=0)`` (it raised
    ``ImportError`` before ``cut_tet`` and its data were ported): 38,043
    tets, 16 subdomains and 22 interfaces, every grid porepy_tpu's to the
    bit."""
    mdg, _network = pt.mdg_library.benchmark_3d_case_3(refinement_level=0)
    mdg_jax, _ = pt_jax.mdg_library.benchmark_3d_case_3(refinement_level=0)
    assert mdg.subdomains(dim=3)[0].num_cells == 38043
    assert len(mdg.subdomains()) == 16 and len(mdg.interfaces()) == 22
    _same_mdg(mdg, mdg_jax)


# -- tests/grids/test_match_grids.py through the port --------------------------


def _pair_1d(nodes):
    out = []
    for cls in (TensorGrid, pt_jax.TensorGrid):
        g = cls(np.asarray(nodes, dtype=float))
        g.compute_geometry()
        out.append(g)
    return out


def _port_grid(g):
    """The port's grid with ``g``'s (a porepy_tpu grid's) topology."""
    out = Grid(g.dim, np.array(g.nodes), sps.csc_matrix(g.face_nodes), sps.csc_matrix(g.cell_faces), g.name)
    out.compute_geometry()
    return out


@pytest.mark.parametrize("scaling", [None, "averaged", "integrated"])
def test_match_1d_parity(scaling):
    """``test_match_1d_parity`` through the port, against porepy_tpu's
    ``match_1d`` (which its test holds to the reference) to the bit."""
    old, old_jax = _pair_1d(np.linspace(0, 1, 5))
    new, new_jax = _pair_1d(np.array([0.0, 0.3, 0.55, 0.8, 1.0]))
    mine = match_grids.match_1d(new, old, tol=1e-8, scaling=scaling)
    theirs = pt_jax.match_grids.match_1d(new_jax, old_jax, tol=1e-8, scaling=scaling)
    assert mine.shape == theirs.shape
    np.testing.assert_array_equal(mine.toarray(), theirs.toarray())
    if scaling == "averaged":
        assert np.allclose(np.asarray(mine.sum(axis=1)).ravel(), 1.0)


@pytest.mark.parametrize("scaling", [None, "averaged", "integrated"])
def test_match_2d_parity(scaling):
    """``test_match_2d_parity`` through the port: the refined triangle grid
    is porepy_tpu's ``refine_triangle_grid`` (not ported), rebuilt in the
    port; ``match_2d`` equals porepy_tpu's to the bit."""
    pts = np.array([[0, 1, 0, 1.0], [0, 0, 1, 1.0]])
    old, old_jax = TriangleGrid(pts.copy()), pt_jax.TriangleGrid(pts.copy())
    old.compute_geometry()
    old_jax.compute_geometry()
    new_jax = refinement_jax.refine_triangle_grid(old_jax)[0]
    new_jax.compute_geometry()
    new = _port_grid(new_jax)
    mine = match_grids.match_2d(new, old, tol=1e-8, scaling=scaling)
    theirs = pt_jax.match_grids.match_2d(new_jax, old_jax, tol=1e-8, scaling=scaling)
    assert mine.shape == theirs.shape
    np.testing.assert_array_equal(mine.toarray(), theirs.toarray())


def test_match_2d_self_identity():
    g = TriangleGrid(np.array([[0, 1, 0, 1.0], [0, 0, 1, 1.0]]))
    g.compute_geometry()
    m = match_grids.match_2d(g, g, tol=1e-8, scaling="integrated")
    assert np.allclose(m.toarray(), np.eye(g.num_cells))


def test_match_2d_rejects_non_simplex():
    g = CartGrid([2, 2])
    g.compute_geometry()
    with pytest.raises(ValueError, match="simplex"):
        match_grids.match_2d(g, g, tol=1e-8)


# -- tests/grids/test_mortar_updates.py through the port -----------------------
# ``refine_grid_1d`` (``grids/refinement.py``) is not ported: the refined 1d
# grids are porepy_tpu's, rebuilt in the port by ``_port_grid``.

FRAC_H = [np.array([[0.25, 0.75], [0.5, 0.5]])]


def _mdg():
    return meshing.cart_grid(FRAC_H, np.array([4, 4]), physdims=[1.0, 1.0])


def _refined_1d(g, ratio):
    """The port's copy of ``refine_grid_1d(g, ratio)``, by porepy_tpu."""
    twin = pt_jax.grids.grid.Grid(g.dim, np.array(g.nodes), sps.csc_matrix(g.face_nodes), sps.csc_matrix(g.cell_faces), g.name)
    twin.compute_geometry()
    return _port_grid(refinement_jax.refine_grid_1d(twin, ratio=ratio))


def test_update_mortar_refined_sides():
    """Mortar side grids refined twice (``MortarGrid.update_mortar``, which
    raised ``ImportError`` before ``grids/match_grids.py`` was ported):
    partition of unity, each mortar cell its parent's value."""
    mdg = _mdg()
    intf = list(mdg.interfaces())[0]
    new_sides = {side: _refined_1d(g, 2) for side, g in intf.side_grids.items()}
    n_old = intf.num_cells
    intf.update_mortar(new_sides, tol=1e-6)
    assert intf.num_cells == 2 * n_old
    for P in (intf.primary_to_mortar_avg(), intf.secondary_to_mortar_avg()):
        assert np.allclose(np.asarray(P.sum(axis=1)).ravel(), 1.0)
    _, sd_l = mdg.interface_to_subdomain_pair(intf)
    vals = np.arange(sd_l.num_cells, dtype=float) + 1.0
    at_mortar = intf.secondary_to_mortar_avg() @ vals
    parent = np.argmin(np.abs(intf.cell_centers[0][:, None] - sd_l.cell_centers[0][None, :]), axis=1)
    assert np.allclose(at_mortar, vals[parent])


def test_update_secondary_refined():
    mdg = _mdg()
    intf = list(mdg.interfaces())[0]
    _, sd_l = mdg.interface_to_subdomain_pair(intf)
    new_l = _refined_1d(sd_l, 3)
    intf.update_secondary(new_l, tol=1e-6)
    P = intf.secondary_to_mortar_avg()
    assert P.shape == (intf.num_cells, new_l.num_cells)
    assert np.allclose(np.asarray(P.sum(axis=1)).ravel(), 1.0)
    vols = intf.secondary_to_mortar_int() @ new_l.cell_volumes
    assert np.allclose(vols.sum(), intf.cell_volumes.sum())


def test_update_primary_renumbered_faces():
    mdg = _mdg()
    intf = list(mdg.interfaces())[0]
    sd_h, _ = mdg.interface_to_subdomain_pair(intf)
    old = intf.primary_to_mortar_int().copy()
    intf.update_primary(sd_h, sd_h, tol=1e-8)
    assert (abs(old - intf.primary_to_mortar_int())).nnz == 0


def test_match_grids_along_1d_mortar_nested():
    """``test_match_grids_along_1d_mortar_nested`` through the port, and
    both scalings equal to porepy_tpu's to the bit."""
    from porepy_tpu_torch.grids.match_grids import match_grids_along_1d_mortar

    grids = {}
    for tag, m in (("torch", meshing), ("jax", meshing_jax)):
        mdg_old = m.cart_grid(FRAC_H, np.array([4, 4]), physdims=[1.0, 1.0])
        mdg_new = m.cart_grid(FRAC_H, np.array([8, 8]), physdims=[1.0, 1.0])
        grids[tag] = (list(mdg_old.interfaces())[0], mdg_new.subdomains(dim=2)[0], mdg_old.subdomains(dim=2)[0])
    intf, g_new, g_old = grids["torch"]
    m_int = match_grids_along_1d_mortar(intf, g_new, g_old, tol=1e-8, scaling="integrated")
    faces_old = np.unique(intf._primary_to_mortar_int.tocoo().col)
    rowsum = np.asarray(m_int.sum(axis=1)).ravel()
    assert np.allclose(rowsum[faces_old], 2.0)
    off = np.setdiff1d(np.arange(g_old.num_faces), faces_old)
    assert np.allclose(rowsum[off], 0.0)
    assert np.all(np.diff(m_int.indptr)[faces_old] == 2)
    m_avg = match_grids_along_1d_mortar(intf, g_new, g_old, tol=1e-8, scaling="averaged")
    assert np.allclose(np.asarray(m_avg.sum(axis=1)).ravel()[faces_old], 1.0)
    for scaling, mine in (("integrated", m_int), ("averaged", m_avg)):
        theirs = pt_jax.match_grids.match_grids_along_1d_mortar(*grids["jax"], tol=1e-8, scaling=scaling)
        np.testing.assert_array_equal(mine.toarray(), theirs.toarray())


def test_replace_2d_grid_identical_copy():
    mdg = _mdg()
    intf = list(mdg.interfaces())[0]
    sd_old, _ = mdg.interface_to_subdomain_pair(intf)
    bg_old = mdg.subdomain_to_boundary_grid(sd_old)
    old = intf.primary_to_mortar_avg().toarray()
    sd_new = sd_old.copy()
    sd_new.compute_geometry()
    mdg.replace_subdomains_and_interfaces(sd_map={sd_old: sd_new})
    assert sd_old not in mdg and sd_new in mdg
    assert bg_old not in mdg
    assert mdg.subdomain_to_boundary_grid(sd_new) is not None
    assert np.allclose(intf.primary_to_mortar_avg().toarray(), old)
    assert mdg.interface_to_subdomain_pair(intf)[0] is sd_new


def test_replace_2d_grid_refined_nonmatching():
    mdg = _mdg()
    mdg_fine = meshing.cart_grid(FRAC_H, np.array([8, 8]), physdims=[1.0, 1.0])
    intf = list(mdg.interfaces())[0]
    sd_old, _ = mdg.interface_to_subdomain_pair(intf)
    sd_new = mdg_fine.subdomains(dim=2)[0]
    mdg.replace_subdomains_and_interfaces(sd_map={sd_old: sd_new})
    P = intf.primary_to_mortar_avg()
    assert P.shape == (intf.num_cells, sd_new.num_faces)
    assert np.allclose(np.asarray(P.sum(axis=1)).ravel(), 1.0)
    assert np.all(np.diff(P.tocsr().indptr) == 2)
    assert np.allclose(P @ sd_new.face_centers[0], intf.cell_centers[0])


def test_replace_1d_secondary_refined():
    mdg = _mdg()
    intf = list(mdg.interfaces())[0]
    _, sd_old = mdg.interface_to_subdomain_pair(intf)
    sd_new = _refined_1d(sd_old, 2)
    mdg.replace_subdomains_and_interfaces(sd_map={sd_old: sd_new})
    assert mdg.interface_to_subdomain_pair(intf)[1] is sd_new
    P = intf.secondary_to_mortar_avg()
    assert P.shape == (intf.num_cells, sd_new.num_cells)
    assert np.allclose(np.asarray(P.sum(axis=1)).ravel(), 1.0)


def test_replace_interface_side_grids():
    mdg = _mdg()
    intf = list(mdg.interfaces())[0]
    n_old = intf.num_cells
    new_sides = {side: _refined_1d(g, 2) for side, g in intf.side_grids.items()}
    mdg.replace_subdomains_and_interfaces(interface_map={intf: new_sides})
    assert intf.num_cells == 2 * n_old
    for P in (intf.primary_to_mortar_avg(), intf.secondary_to_mortar_avg()):
        assert np.allclose(np.asarray(P.sum(axis=1)).ravel(), 1.0)
