"""Wells and the meshing helpers through porepy_tpu_torch on the CPU
(``fracs/wells_3d.py`` and ``fracs/tools.py``, copied from porepy_tpu):
``tests/fracs/test_wells.py`` and ``tests/fracs/test_tools.py`` on the port,
each against porepy_tpu's result on the same input. porepy_tpu's
``test_intersection_parity_with_reference`` reads the reference itself;
here the port's well-fracture intersections are held against porepy_tpu's
(which that test holds to the reference) to the bit. And the Berre et al.
3d case 3 example's own ``set_geometry`` with a well, which reaches
``pp.compute_well_fracture_intersections`` through the flat namespace."""

import numpy as np
import pytest
import scipy.sparse as sps

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu_torch.applications.md_grids.domains import unit_cube_domain
from porepy_tpu_torch.fracs.fracture import PlaneFracture
from porepy_tpu_torch.fracs.wells_3d import (
    Well,
    WellNetwork3d,
    compute_well_fracture_intersections,
    compute_well_rock_matrix_intersections,
)

# Horizontal unit-square fractures at conforming heights for a cartesian mdg.
FRACTURE_COORDS = [
    np.array([[0, 1, 1, 0], [1, 1, 0, 0], [0.5, 0.5, 0.5, 0.5]]),
    np.array([[0, 1, 1, 0], [1, 1, 0, 0], [0.75, 0.75, 0.75, 0.75]]),
    np.array([[0, 1, 1, 0], [1, 1, 0, 0], [0.25, 0.25, 0.25, 0.25]]),
]
# Vertical well from the top boundary: well 0 ends at z=0.25 (on fracture 2),
# well 1 ends at z=0.6 (strictly inside).
WELL_COORDS = [
    np.array([[0.4, 0.4], [0.4, 0.4], [1, 0.25]]),
    np.array([[0.6, 0.6], [0.6, 0.6], [1, 0.6]]),
]


def _make_mdg(mod, fracture_indices, well_indices):
    fractures = [mod.PlaneFracture(FRACTURE_COORDS[i]) for i in fracture_indices]
    domain = mod.applications.md_grids.domains.unit_cube_domain(3)
    network = mod.create_fracture_network(fractures, domain)
    mdg = mod.create_mdg("cartesian", {"cell_size": 0.25}, network)
    wells = [mod.Well(WELL_COORDS[i]) for i in well_indices]
    well_network = mod.WellNetwork3d(domain, wells, parameters={"mesh_size": 1})
    mod.compute_well_fracture_intersections(well_network, network)
    well_network.mesh(mdg)
    return mdg, well_network


def _same_mdg(mdg, mdg_jax):
    """The port's mdg is porepy_tpu's: the same subdomains (nodes, maps,
    tags) and interfaces (projections), in the same order."""
    assert mdg.num_subdomains() == mdg_jax.num_subdomains()
    assert mdg.num_interfaces() == mdg_jax.num_interfaces()
    for sd, sdj in zip(mdg.subdomains(), mdg_jax.subdomains()):
        assert sd.dim == sdj.dim
        np.testing.assert_array_equal(sd.nodes, sdj.nodes)
        for attr in ("face_nodes", "cell_faces"):
            a, b = sps.csr_matrix(getattr(sd, attr)), sps.csr_matrix(getattr(sdj, attr))
            assert a.shape == b.shape and (a != b).nnz == 0, attr
        assert set(sd.tags) == set(sdj.tags)
        for key, val in sdj.tags.items():
            np.testing.assert_array_equal(np.asarray(sd.tags[key]), np.asarray(val), err_msg=key)
    for intf, intfj in zip(mdg.interfaces(), mdg_jax.interfaces()):
        assert intf.codim == intfj.codim and intf.num_cells == intfj.num_cells
        for proj in ("mortar_to_primary_int", "mortar_to_secondary_int"):
            a, b = sps.csr_matrix(getattr(intf, proj)()), sps.csr_matrix(getattr(intfj, proj)())
            assert a.shape == b.shape and (a != b).nnz == 0, proj


def test_intersection_tags():
    """Intersection points are inserted into the polyline and tagged."""
    fractures = [PlaneFracture(FRACTURE_COORDS[i]) for i in (0, 2)]
    network = pt.create_fracture_network(fractures, unit_cube_domain(3))
    well = Well(WELL_COORDS[0])
    wn = WellNetwork3d(unit_cube_domain(3), [well], parameters={"mesh_size": 1})
    compute_well_fracture_intersections(wn, network)
    # Original endpoints plus the internal crossing of fracture 0 at z=0.5;
    # the endpoint itself lies on fracture 2 (index 1 in this network).
    assert well.pts.shape == (3, 3)
    assert np.allclose(well.pts[2], [1.0, 0.5, 0.25])
    tags = well.tags["intersecting_fractures"]
    assert tags[0].size == 0
    assert tags[1].size == 1 and tags[1][0] == 0
    assert tags[2].size == 1 and tags[2][0] == 1


def test_intersection_parity_with_porepy_tpu():
    """``test_intersection_parity_with_reference``'s tilted well against all
    three fractures: the port's intersection points and tags equal
    porepy_tpu's (which that test holds to the reference) to the bit."""
    tilted = np.array([[0.3, 0.7], [0.3, 0.8], [1, 0.15]])
    wells = []
    for mod in (pt, pt_jax):
        domain = mod.applications.md_grids.domains.unit_cube_domain(3)
        net = mod.create_fracture_network([mod.PlaneFracture(c) for c in FRACTURE_COORDS], domain)
        well = mod.Well(tilted.copy())
        wn = mod.WellNetwork3d(domain, [well], parameters={"mesh_size": 1})
        mod.compute_well_fracture_intersections(wn, net)
        wells.append(well)
    mine, theirs = wells
    np.testing.assert_array_equal(mine.pts, theirs.pts)
    t_m, t_r = mine.tags["intersecting_fractures"], theirs.tags["intersecting_fractures"]
    assert len(t_m) == len(t_r) == mine.pts.shape[1]
    for a, b in zip(t_m, t_r):
        assert np.array_equal(np.atleast_1d(a), np.atleast_1d(b))
    assert sum(np.atleast_1d(t).size for t in t_m) >= 2


@pytest.mark.parametrize(
    "fracture_indices, fracture_faces, tip_faces",
    [
        # Single internal fracture: two well grids, lower one a tip.
        ([0], [[0, 1], [1, 0]], [[0, 0], [0, 1]]),
        # Fracture at the well endpoint: one well grid, no tip.
        ([2], [[0, 1]], [[0, 0]]),
        # Two internal + endpoint fracture: three well grids.
        ([1, 0, 2], [[0, 1], [1, 1], [1, 1]], [[0, 0], [0, 0], [0, 0]]),
    ],
)
def test_add_one_well(fracture_indices, fracture_faces, tip_faces):
    mdg, _ = _make_mdg(pt, fracture_indices, [0])
    _same_mdg(mdg, _make_mdg(pt_jax, fracture_indices, [0])[0])
    n_frac = len(fracture_indices)
    n_int = sum(1 for i in fracture_indices if i in (0, 1))
    n_end = int(2 in fracture_indices)
    # 1 matrix + n_frac fractures + well grids + 0d intersections.
    n_well_grids = n_int + (1 if not n_end else n_end)
    assert mdg.num_subdomains() == 1 + n_frac + n_well_grids + (n_int + n_end)
    # matrix-fracture + fracture-0d + well-0d interfaces.
    assert mdg.num_interfaces() == n_frac + (n_int + n_end) + (2 * n_int + n_end)

    boundary_faces = [[1, 0], [0, 0], [0, 0]]
    for ind, wg in enumerate(mdg.subdomains(dim=1)):
        assert np.array_equal(wg.tags["fracture_faces"], fracture_faces[ind])
        assert np.array_equal(wg.tags["tip_faces"], tip_faces[ind])
        assert np.array_equal(wg.tags["domain_boundary_faces"], boundary_faces[ind])
        assert wg.tags["parent_well_index"] == 0
        assert hasattr(wg, "well_num")


def test_add_two_wells():
    mdg, _ = _make_mdg(pt, [0], [0, 1])
    _same_mdg(mdg, _make_mdg(pt_jax, [0], [0, 1])[0])
    # 1 matrix, 1 fracture, 3 well grids (well 0 split by fracture 0, well 1
    # spans z in [0.6, 1] and does not cross z = 0.5), 1 intersection point.
    assert mdg.num_subdomains() == 1 + 1 + 3 + 1
    # Interfaces: 1 matrix-fracture, 1 fracture-0d, 2 well-0d.
    assert mdg.num_interfaces() == 1 + 1 + 2
    # Well 1 has an internal tip at its lower end.
    tips = [wg.tags["tip_faces"].tolist() for wg in mdg.subdomains(dim=1)]
    assert [0, 1] in tips


def test_well_rock_matrix_intersections():
    mdgs = []
    for mod in (pt, pt_jax):
        mdg, _ = _make_mdg(mod, [], [1])
        mod.compute_well_rock_matrix_intersections(mdg)
        mdgs.append(mdg)
    mdg, mdg_jax = mdgs
    _same_mdg(mdg, mdg_jax)
    assert compute_well_rock_matrix_intersections is pt.compute_well_rock_matrix_intersections
    assert mdg.num_subdomains() == 2
    assert mdg.num_interfaces() == 1
    intf = mdg.interfaces()[0]
    assert intf.codim == 3 - 1
    assert intf.num_sides() == 1
    assert np.allclose(intf.mortar_to_secondary_int().toarray(), 1.0)
    # The single well segment spans z in [0.6, 1] -> in-cell length fractions
    # must sum to 1 over the traversed matrix cells.
    weights = intf.mortar_to_primary_int().toarray()
    assert np.isclose(weights.sum(), 1.0)
    # Cells z in (0.75,1) carry 0.625 of the segment, the (0.5,0.75) cell
    # carries 0.375.
    assert np.isclose(np.sort(weights[weights > 0])[-1], 0.625)
    # The new well boundary grid is initialized with the boundary face.
    bgs = mdg.boundaries(dim=0)
    assert len(bgs) == 1
    assert bgs[0].num_cells == 1


# -- tests/fracs/test_tools.py ------------------------------------------------------


def test_mesh_size_graded_by_proximity():
    from porepy_tpu.fracs.tools import determine_mesh_size as size_jax
    from porepy_tpu_torch.fracs.tools import determine_mesh_size

    # Two parallel fractures 0.1 apart: the local size shrinks to the gap.
    pts = np.array([[0.2, 0.8, 0.2, 0.8], [0.5, 0.5, 0.6, 0.6]])
    lines = np.array([[0, 2], [1, 3]])
    pts_far = np.array([[0.0, 1.0], [0.0, 0.0]])
    lines_far = np.array([[0], [1]])
    cases = (
        ((pts, None, lines), {"mesh_size_frac": 0.4}),
        ((pts_far, None, lines_far), {"mesh_size_frac": 0.4}),
        ((pts_far, np.array([0, 1]), lines_far), {"mesh_size_frac": 0.4, "mesh_size_bound": 0.2}),
    )
    got = []
    for args, kw in cases:
        mine = determine_mesh_size(*args, **kw)
        theirs = size_jax(*args, **kw)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
        got.append(mine[0])
    assert np.allclose(got[0][:4], 0.1)
    # Isolated configuration keeps the user target.
    assert np.allclose(got[1], 0.4)
    # Boundary override.
    assert np.allclose(got[2], 0.2)


def test_interdim_mappings_match_split_faces():
    from porepy_tpu.fracs.tools import obtain_interdim_mappings as maps_jax
    from porepy_tpu_torch.fracs import meshing
    from porepy_tpu_torch.fracs.tools import obtain_interdim_mappings

    mdg = meshing.cart_grid([np.array([[0.25, 0.75], [0.5, 0.5]])], np.array([4, 4]), physdims=[1.0, 1.0])
    g_h = mdg.subdomains(dim=2)[0]
    g_l = mdg.subdomains(dim=1)[0]
    fn = g_h.face_nodes.indices.reshape((2, g_h.num_faces), order="F")
    fn = np.sort(g_h.global_point_ind[fn], axis=0)
    c2f, cells = obtain_interdim_mappings(g_l, fn, 2)
    c2f_j, cells_j = maps_jax(g_l, fn, 2)
    np.testing.assert_array_equal(c2f, c2f_j)
    np.testing.assert_array_equal(cells, cells_j)
    assert cells.size == g_l.num_cells
    # The matched faces are tagged fracture faces whose centers coincide
    # with the fracture cell centers.
    assert np.all(g_h.tags["fracture_faces"][c2f])
    assert np.allclose(g_h.face_centers[:, c2f], g_l.cell_centers[:, cells])


# -- the Berre et al. 3d case 3 example with a well ------------------------------

#: The vertical well: from the top boundary at (0.5, 1.1) down to z = 0.2,
#: through the case's fractures.
FB3D3_WELL = np.array([[0.5, 0.5], [1.1, 1.1], [1.0, 0.2]])


def _fb3d3_with_a_well(mod, monkeypatch):
    """The example's own ``Geometry.set_geometry`` of package ``mod``, on
    the small lattice (``cases.fb3d3_lattice``'s (6, 14, 6), meshed by the
    package's own cut-tet mesher) in place of the refinement-0 mesh, with
    one vertical well: the model after ``set_geometry``."""
    from importlib import import_module

    from porepy_tpu_torch.applications.benchmarking import cases

    example = import_module(f"{mod.__name__}.examples.flow_benchmark_3d_case_3")
    cut_tet_grid = import_module(f"{mod.__name__}.fracs.cut_tet").cut_tet_grid
    network_3d_from_csv = import_module(f"{mod.__name__}.fracs.fracture_importer").network_3d_from_csv

    def lattice(refinement_level=0):
        network = network_3d_from_csv(cases._fracture_csv("benchmark_3d_case_3"))
        mdg = cut_tet_grid([f.pts for f in network.fractures], np.array((6, 14, 6)), physdims=[1.0, 2.25, 1.0],
                           exact_boundary=False)
        mdg.compute_geometry()
        return mdg, network

    monkeypatch.setattr(example, "benchmark_3d_case_3", lattice)

    class Model(example.FlowBenchmark3dCase3Model):
        def set_well_network(self):
            well = mod.Well(FB3D3_WELL.copy())
            self.well_network = mod.WellNetwork3d(self.fracture_network.domain, [well],
                                                  parameters={"mesh_size": 0.2})

    params = {"material_constants": {"solid": example.solid_constants}, "suppress_export": True}
    if mod is pt:
        params["device"] = "cpu"
    model = Model(params)
    model.set_geometry()
    return model


def test_fb3d3_example_meshes_a_well(monkeypatch):
    """The example's ``set_geometry`` with a well network reaches
    ``pt.compute_well_fracture_intersections`` and meshes the well into
    the mdg, in both packages: the same subdomains and interfaces, the well
    split by the fractures it crosses."""
    mine = _fb3d3_with_a_well(pt, monkeypatch)
    theirs = _fb3d3_with_a_well(pt_jax, monkeypatch)
    well_grids = [sd for sd in mine.mdg.subdomains(dim=1) if hasattr(sd, "well_num")]
    assert len(well_grids) >= 2
    assert mine.mdg.num_subdomains() == theirs.mdg.num_subdomains() == 20
    assert mine.mdg.num_interfaces() == theirs.mdg.num_interfaces() == 25
    assert [sd.num_cells for sd in mine.mdg.subdomains()] == [sd.num_cells for sd in theirs.mdg.subdomains()]
    _same_mdg(mine.mdg, theirs.mdg)
