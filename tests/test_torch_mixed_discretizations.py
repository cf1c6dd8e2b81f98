"""The host discretizations TPSA, mixed VEM, RT0 and the hybrid dual VEM
through porepy_tpu_torch on the CPU (``numerics/fv/tpsa.py``,
``numerics/vem/*`` and ``numerics/fem/rt0.py``, copied from porepy_tpu):
``tests/numerics/test_tpsa.py``, ``tests/numerics/test_mvem_rt0.py`` and
``tests/numerics/vem/test_hybrid.py`` on the port. Every matrix and
right-hand side equals porepy_tpu's on the same grid and data
(``assert_array_equal``), and the port's matrices are held to the
reference's goldens in ``tests/goldens/`` that the mirrored tests read,
with those tests' tolerances. Their systems are solved by ``spsolve`` on
the host, as porepy_tpu's tests solve them; these discretizations have no
device route."""

import os
from importlib import import_module

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
PACKAGES = (pt, pt_jax)


def _m(mod, name):
    """The module ``name`` of the package ``mod``."""
    return import_module(f"{mod.__name__}.{name}")


def _golden(name: str) -> dict:
    """A golden of ``tests/goldens/`` as ``{name: ndarray | csr}`` (the
    conftest's packing: a sparse matrix is four ``name.csr.*`` arrays)."""
    z = np.load(os.path.join(GOLDENS, name))
    out = {}
    for key in z.files:
        if key.endswith(".csr.data"):
            base = key[: -len(".csr.data")]
            out[base] = sps.csr_matrix(
                (z[f"{base}.csr.data"], z[f"{base}.csr.indices"], z[f"{base}.csr.indptr"]),
                shape=tuple(z[f"{base}.csr.shape"]),
            )
        elif ".csr." not in key:
            out[key] = z[key]
    return out


def _equal(a, b, what="") -> None:
    """``a`` and ``b`` (sparse or dense) equal entry for entry."""
    a = a.toarray() if sps.issparse(a) else np.asarray(a)
    b = b.toarray() if sps.issparse(b) else np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _near(a, b, tol, what="") -> None:
    """The mirrored tests' check: the largest entry of ``|a - b|`` below ``tol``."""
    diff = abs(sps.csr_matrix(a) - sps.csr_matrix(b))
    assert a.shape == b.shape, what
    assert (diff.max() if diff.nnz else 0.0) < tol, what


# -- TPSA (tests/numerics/test_tpsa.py) ---------------------------------------

TPSA_KEYS = [
    "stress",
    "stress_rotation",
    "stress_total_pressure",
    "rotation_displacement",
    "rotation_rotation",
    "solid_mass_total_pressure",
    "solid_mass_displacement",
    "bound_stress",
    "bound_rotation_displacement",
    "bound_mass_displacement",
    "bound_displacement_cell",
    "bound_displacement_face",
    "bound_displacement_rotation_cell",
    "bound_displacement_solid_pressure_cell",
]


def _tpsa(mod, nx, bc_kind):
    rng = np.random.default_rng(21)
    nc = int(np.prod(nx))
    mu, lmbda = rng.uniform(0.5, 2.0, nc), rng.uniform(0.5, 2.0, nc)
    g = mod.CartGrid(list(nx))
    g.compute_geometry()
    bf = g.get_boundary_faces()
    cond = ["dir" if i % 2 == 0 else "neu" for i in range(bf.size)] if bc_kind == "mixed" else [bc_kind] * bf.size
    d = mod.initialize_data(
        {},
        "mech",
        {"fourth_order_tensor": mod.FourthOrderTensor(mu, lmbda), "bc": mod.BoundaryConditionVectorial(g, bf, cond)},
    )
    mod.Tpsa("mech").discretize(g, d)
    return d[mod.DISCRETIZATION_MATRICES]["mech"]


@pytest.mark.parametrize("nx", [[4, 3], [3, 2, 2]], ids=["2d", "3d"])
@pytest.mark.parametrize("bc_kind", ["mixed", "dir", "neu", "rob"])
def test_tpsa_matrix_parity(nx, bc_kind):
    """Every TPSA matrix of the port equals porepy_tpu's, and is within
    1e-12 of the golden ``test_tpsa_matrix_parity`` reads."""
    got, want = _tpsa(pt, nx, bc_kind), _tpsa(pt_jax, nx, bc_kind)
    assert pt.Tpsa.__module__ == "porepy_tpu_torch.numerics.fv.tpsa"
    golden = _golden(f"test_tpsa_matrix_parity({bc_kind}-{'2d' if len(nx) == 2 else '3d'}).npz")
    for key in TPSA_KEYS:
        _equal(got[key], want[key], key)
        _near(got[key], golden[key], 1e-12, key)


@pytest.mark.parametrize("tweak", ["basis", "robin_offdiag", "robin_mixed"])
def test_tpsa_bc_restrictions_match_reference(tweak):
    """The boundary conditions TPSA does not support raise
    ``NotImplementedError`` in both packages, as the golden records for
    the reference."""
    for mod in PACKAGES:
        g = mod.CartGrid([3, 3])
        g.compute_geometry()
        C = mod.FourthOrderTensor(np.ones(g.num_cells), np.ones(g.num_cells))
        bf = g.get_boundary_faces()
        bc = mod.BoundaryConditionVectorial(g, bf, ["rob"] * bf.size)
        if tweak == "basis":
            bc.basis[0, 1, :] = 0.5
        elif tweak == "robin_offdiag":
            bc.robin_weight[0, 1, :] = 0.3
        else:
            bc.is_rob[0, bf[0]] = False
            bc.is_neu[0, bf[0]] = True
        d = mod.initialize_data({}, "m", {"fourth_order_tensor": C, "bc": bc})
        with pytest.raises(NotImplementedError):
            mod.Tpsa("m").discretize(g, d)
    assert _golden(f"test_tpsa_bc_restrictions_match_reference({tweak}).npz")["reference_raises"] == 1


# -- MVEM and RT0 (tests/numerics/test_mvem_rt0.py) ----------------------------


def _grid(mod, kind):
    simplex = _m(mod, "grids.simplex")
    if kind == "cart2d":
        g = mod.CartGrid(np.array([4, 3]))
    elif kind == "cart3d":
        g = mod.CartGrid(np.array([2, 2, 2]))
    elif kind == "tri":
        g = simplex.StructuredTriangleGrid(np.array([3, 3]), np.array([1.0, 1.0]))
    elif kind == "tet":
        g = simplex.StructuredTetrahedralGrid(np.array([2, 2, 2]), np.array([1.0, 1.0, 1.0]))
    else:  # a rotated 1d grid
        g = _m(mod, "grids.structured").TensorGrid(np.linspace(0, 1, 6))
        g.nodes[1] = g.nodes[0] * 0.5
    g.compute_geometry()
    return g


def _dual(mod, scheme, kind):
    g = _grid(mod, kind)
    rng = np.random.default_rng(23)
    kxx = rng.uniform(0.5, 2.0, g.num_cells)
    bf = g.get_boundary_faces()
    cond = ["dir" if i % 2 == 0 else "neu" for i in range(bf.size)]
    bcv = rng.random(g.num_faces)
    d = mod.initialize_data(
        {},
        "flow",
        {
            "second_order_tensor": _m(mod, "params.tensor").SecondOrderTensor(kxx),
            "bc": mod.BoundaryCondition(g, bf, cond),
            "bc_values": bcv.copy(),
        },
    )
    Disc = mod.MVEM if scheme == "mvem" else mod.RT0
    Disc("flow").discretize(g, d)
    A, b = Disc("flow").assemble_matrix_rhs(g, d)
    return d[mod.DISCRETIZATION_MATRICES]["flow"], A, b


@pytest.mark.parametrize(
    "scheme,kind",
    [("mvem", "cart2d"), ("mvem", "cart3d"), ("mvem", "tri"), ("mvem", "1d"), ("rt0", "tri"), ("rt0", "tet"),
     ("rt0", "1d")],
)
def test_dual_discretization_parity(scheme, kind):
    """The mass, divergence and vector-projection matrices and the
    assembled saddle-point system of MVEM and RT0 equal porepy_tpu's, and
    are within 1e-10 of the golden ``test_dual_discretization_parity``
    reads."""
    md, A, b = _dual(pt, scheme, kind)
    md_ref, A_ref, b_ref = _dual(pt_jax, scheme, kind)
    golden = _golden(f"test_dual_discretization_parity({scheme}-{kind}).npz")
    for key in ("mass", "div", "vector_proj"):
        _equal(md[key], md_ref[key], key)
        _near(md[key], golden[key], 1e-10, key)
    _equal(A, A_ref, "A")
    _equal(b, b_ref, "b")
    _near(A, golden["A"], 1e-10, "A")
    assert np.allclose(b, golden["b"])


def _linear_pressure(mod):
    g = mod.CartGrid([5, 5], physdims=[1, 1])
    g.compute_geometry()
    bf = g.get_boundary_faces()
    bc_values = np.zeros(g.num_faces)
    bc_values[bf] = g.face_centers[0, bf]
    d = mod.initialize_data(
        {},
        "flow",
        {
            "second_order_tensor": _m(mod, "params.tensor").SecondOrderTensor(np.ones(g.num_cells)),
            "bc": mod.BoundaryCondition(g, bf, ["dir"] * bf.size),
            "bc_values": bc_values,
        },
    )
    discr = mod.MVEM("flow")
    discr.discretize(g, d)
    A, b = discr.assemble_matrix_rhs(g, d)
    x = spla.spsolve(A.tocsc(), b)
    return g, discr.extract_pressure(g, x, d), discr.extract_flux(g, x, d), A, b


def test_mvem_solves_linear_pressure():
    """The MVEM patch test: the linear pressure ``p = x`` exactly (1e-10),
    with the system, the pressure and the fluxes equal to porepy_tpu's."""
    g, p, u, A, b = _linear_pressure(pt)
    assert np.abs(p - g.cell_centers[0]).max() < 1e-10
    _, p_ref, u_ref, A_ref, b_ref = _linear_pressure(pt_jax)
    _equal(A, A_ref, "A")
    _equal(b, b_ref, "b")
    _equal(p, p_ref, "p")
    _equal(u, u_ref, "u")


# -- the hybrid dual VEM (tests/numerics/vem/test_hybrid.py) ---------------------


def _hybrid_data(mod, sd, bc_val_fn, k_diag=1.0):
    sd.compute_geometry()
    bf = sd.get_all_boundary_faces()
    bc_values = np.zeros(sd.num_faces)
    bc_values[bf] = bc_val_fn(sd.face_centers[:, bf])
    specified = {
        "second_order_tensor": _m(mod, "params.tensor").SecondOrderTensor(k_diag * np.ones(sd.num_cells)),
        "bc": mod.BoundaryCondition(sd, bf, "dir"),
        "bc_values": bc_values,
    }
    return mod.initialize_data({}, "flow", specified)


GRIDS = {
    "cart2d": lambda mod: mod.CartGrid([4, 4], [1.0, 1.0]),
    "tri": lambda mod: _m(mod, "grids.simplex").StructuredTriangleGrid([3, 3], [1.0, 1.0]),
    "cart3d": lambda mod: mod.CartGrid([3, 3, 3], [1.0, 1.0, 1.0]),
}


def _hybrid_linear(mod, grid):
    sd = GRIDS[grid](mod)
    data = _hybrid_data(mod, sd, lambda x: 2.0 - x[0] + 0.5 * x[1])
    hybrid = mod.HybridDualVEM("flow")
    H, rhs = hybrid.matrix_rhs(sd, data)
    lam = sps.linalg.spsolve(H, rhs)
    u, p = hybrid.compute_up(sd, lam, data)
    return sd, H, rhs, lam, u, p


@pytest.mark.parametrize("grid", list(GRIDS))
def test_hybrid_exact_on_linear_pressure(grid):
    """The hybrid form reproduces a linear pressure, its face values and
    its fluxes (1e-10), with the system and the solution equal to
    porepy_tpu's."""
    sd, H, rhs, lam, u, p = _hybrid_linear(pt, grid)

    def p_exact(x):
        return 2.0 - x[0] + 0.5 * x[1]

    assert np.allclose(p, p_exact(sd.cell_centers), atol=1e-10)
    assert np.allclose(lam, p_exact(sd.face_centers), atol=1e-10)
    assert np.allclose(u, sd.face_normals[0] - 0.5 * sd.face_normals[1], atol=1e-10)
    for got, want, what in zip((H, rhs, lam, u, p), _hybrid_linear(pt_jax, grid)[1:], ("H", "rhs", "lam", "u", "p")):
        _equal(got, want, what)


def _hybrid_and_mvem(mod):
    cc = _m(mod, "utils.common_constants")
    sd = _m(mod, "grids.simplex").StructuredTriangleGrid([4, 4], [1.0, 1.0])
    data_h = _hybrid_data(mod, sd, lambda x: np.zeros(x.shape[1]))
    data_m = _hybrid_data(mod, sd, lambda x: np.zeros(x.shape[1]))
    f = np.random.default_rng(2).random(sd.num_cells) * sd.cell_volumes
    data_h[cc.PARAMETERS]["flow"]["source"] = f
    hybrid = mod.HybridDualVEM("flow")
    H, rhs = hybrid.matrix_rhs(sd, data_h)
    u_h, p_h = hybrid.compute_up(sd, sps.linalg.spsolve(H, rhs), data_h)
    mod.MVEM("flow").discretize(sd, data_m)
    matrices = data_m[cc.DISCRETIZATION_MATRICES]["flow"]
    A = sps.bmat([[matrices["mass"], matrices["div"].T], [matrices["div"], None]], format="csr")
    x = sps.linalg.spsolve(A, np.concatenate([np.zeros(sd.num_faces), -f]))
    return H, rhs, u_h, p_h, A, x[: sd.num_faces], x[sd.num_faces:]


def test_hybrid_matches_mvem_with_source():
    """The hybrid solve with a source equals the MVEM saddle-point solve
    (1e-9), each system and solution equal to porepy_tpu's."""
    got = _hybrid_and_mvem(pt)
    H, rhs, u_h, p_h, A, u_m, p_m = got
    assert np.allclose(p_h, p_m, atol=1e-9)
    assert np.allclose(u_h, u_m, atol=1e-9)
    for a, b, what in zip(got, _hybrid_and_mvem(pt_jax), ("H", "rhs", "u_h", "p_h", "A", "u_m", "p_m")):
        _equal(a, b, what)


def _mass_and_source(mod):
    cc = _m(mod, "utils.common_constants")
    sd = mod.CartGrid([2, 2], [1.0, 1.0])
    sd.compute_geometry()
    w = 2.0 * np.ones(sd.num_cells)
    data = {
        cc.PARAMETERS: {"flow": {"mass_weight": w, "source": np.arange(4.0)}},
        cc.DISCRETIZATION_MATRICES: {"flow": {}},
    }
    out = []
    for disc in (mod.MixedMassMatrix, mod.MixedInvMassMatrix, mod.DualScalarSource):
        d = disc("flow")
        d.discretize(sd, data)
        out.extend(d.assemble_matrix_rhs(sd, data))
    return sd, w, out


def test_mixed_mass_matrix_and_source():
    """``MixedMassMatrix``, ``MixedInvMassMatrix`` and ``DualScalarSource``
    on the mixed (faces + cells) dofs, equal to porepy_tpu's."""
    sd, w, (M, rhs, Minv, _rhs_inv, A, b) = _mass_and_source(pt)
    nf = sd.num_faces
    assert np.allclose(M.diagonal()[:nf], 0.0)
    assert np.allclose(M.diagonal()[nf:], sd.cell_volumes * w)
    assert np.allclose(rhs, 0.0)
    assert np.allclose(Minv.diagonal()[nf:], 1.0 / (sd.cell_volumes * w))
    assert A.nnz == 0
    assert np.allclose(b[:nf], 0.0) and np.allclose(b[nf:], -np.arange(4.0))
    _, _, ref = _mass_and_source(pt_jax)
    for a, r, what in zip(_mass_and_source(pt)[2], ref, ("M", "rhs", "Minv", "rhs_inv", "A", "b")):
        _equal(a, r, what)


def _projected_flux(mod):
    """The patch test's face fluxes projected to cell vectors, through the
    flat ``project_flux`` on a one-subdomain md grid of the same 5 x 5
    cells."""
    g, _p, u, _A, _b = _linear_pressure(mod)
    mdg = _m(mod, "fracs.meshing").cart_grid([], np.array([5, 5]), physdims=[1.0, 1.0])
    sd, data = next(iter(mdg.subdomains(return_data=True)))
    bf = sd.get_boundary_faces()
    data.update(mod.initialize_data(
        {},
        "flow",
        {
            "second_order_tensor": _m(mod, "params.tensor").SecondOrderTensor(np.ones(sd.num_cells)),
            "bc": mod.BoundaryCondition(sd, bf, ["dir"] * bf.size),
        },
    ))
    discr = mod.MVEM("flow")
    discr.discretize(sd, data)
    data["darcy_flux"] = u
    mod.project_flux(mdg, discr, "darcy_flux", "P0_flux")
    return data["P0_flux"]


def test_project_flux_is_the_ports():
    """The flat ``project_flux`` is the port's ``dual_elliptic`` function:
    the patch test's fluxes project to the uniform field ``-K grad p = (-1,
    0, 0)`` in every cell (1e-10), equal to porepy_tpu's projection."""
    assert pt.project_flux.__module__ == "porepy_tpu_torch.numerics.vem.dual_elliptic"
    got = _projected_flux(pt)
    assert got.shape == (3, 25)
    assert np.allclose(got, np.array([[-1.0], [0.0], [0.0]]), atol=1e-10)
    _equal(got, _projected_flux(pt_jax))
