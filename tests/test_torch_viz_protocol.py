"""The plotting, diagnostics, protocol and ADT modules through
porepy_tpu_torch on the CPU (``viz/{plot_grid,diagnostics_mixin,
fracture_visualization}.py``, ``models/protocol.py``, ``utils/adtree.py``,
copied from porepy_tpu): ``tests/viz/test_diagnostics_plot.py``,
``tests/models/test_protocol.py`` and ``tests/utils/test_tables_adtree.py``'s
``test_adtree_parity`` on the port, each against porepy_tpu's result and
the reference's golden where the mirrored test reads one.

Both packages' diagnostics read the assembled matrix from
``model.linear_system``; on a ``device*`` linear solver that holds
``(None, b)`` (the matrix stays on the device), and ``run_diagnostics``
raises ``ValueError`` in both: the diagnostics work on the host-solver
route only.

The plotting tests need matplotlib (skipped without it) and draw with the
``Agg`` backend; importing the port does not import matplotlib."""

import numpy as np
import pytest

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from porepy_tpu_torch.grids.simplex import StructuredTriangleGrid  # noqa: E402
from porepy_tpu_torch.grids.structured import CartGrid, TensorGrid  # noqa: E402
from porepy_tpu_torch.viz.plot_grid import plot_grid, save_img  # noqa: E402


def _diagnostic_model(mod, **extra):
    """``tests/viz/test_diagnostics_plot.py``'s model in package ``mod``
    (the port's on the CPU), prepared and assembled once."""
    from importlib import import_module

    geometries = import_module(f"{mod.__name__}.applications.md_grids.model_geometries")

    class Model(mod.DiagnosticsMixin, geometries.SquareDomainOrthogonalFractures, mod.SinglePhaseFlow):
        def initialize_data_saving(self):
            pass

        def save_data_time_step(self):
            pass

    params = {"fracture_indices": [0], "grid_type": "cartesian", "meshing_arguments": {"cell_size": 0.5}, **extra}
    if mod is pt:
        params["device"] = "cpu"
    m = Model(params)
    m.prepare_simulation()
    m.before_nonlinear_loop()
    m.before_nonlinear_iteration()
    m.assemble_linear_system()
    return m


@pytest.fixture(scope="module")
def model():
    return _diagnostic_model(pt)


def _same_diagnostics(data, data_jax, tol=1e-12):
    """The same blocks, and each block's numbers within ``tol`` relative."""
    assert set(data) == set(data_jax)
    for key, entry in data_jax.items():
        assert data[key]["block_size"] == entry["block_size"], key
        for name, val in entry.items():
            if name != "block_size":
                assert abs(data[key][name] - val) <= tol * max(abs(val), 1e-300), (key, name)


def test_run_diagnostics(model):
    data = model.run_diagnostics(default_handlers=("max", "cond"))
    eq_names = {k[0] for k in data}
    var_names = {k[1] for k in data}
    assert "mass_balance_equation" in eq_names
    assert "pressure" in var_names
    # The pressure block of the mass balance has nonzero entries and finite
    # conditioning.
    entry = data[("mass_balance_equation", "pressure")]
    assert entry["max"] > 0
    assert np.isfinite(entry["cond"]) and entry["cond"] >= 1.0
    # Block sizes tile the full Jacobian.
    mat, _ = model.linear_system
    rows = sum(e["block_size"][0] for (eq, var), e in data.items() if var == "pressure")
    assert rows == mat.shape[0]
    # porepy_tpu's model gives the same blocks, maxima and condition numbers.
    theirs = _diagnostic_model(pt_jax).run_diagnostics(default_handlers=("max", "cond"))
    _same_diagnostics(data, theirs, tol=1e-9)


def test_plot_diagnostics(model):
    fig = model.plot_diagnostics(key="max")
    assert fig is not None


def test_plot_grid_dims(tmp_path):
    g1 = TensorGrid(np.linspace(0, 1, 4))
    g1.compute_geometry()
    fig = plot_grid(g1, plot=False)
    assert fig is not None

    g2 = StructuredTriangleGrid(np.array([2, 2]))
    g2.compute_geometry()
    save_img(str(tmp_path / "tri.png"), g2, cell_value=np.arange(g2.num_cells, dtype=float))
    assert (tmp_path / "tri.png").exists()

    g3 = CartGrid([2, 2, 2])
    g3.compute_geometry()
    fig = plot_grid(g3, cell_value=np.arange(g3.num_cells, dtype=float), plot=False)
    assert fig is not None


def test_plot_grid_mdg(model):
    fig = plot_grid(model.mdg, cell_value="pressure", plot=False)
    assert fig is not None


def test_plot_fractures_and_wells():
    """``pp.plot_fractures`` and ``pp.plot_wells`` draw a network and well
    heads in the domain box, as porepy_tpu's do."""
    pts = np.array([[0.2, 0.8, 0.5, 0.5], [0.5, 0.5, 0.2, 0.8]])
    edges = np.array([[0, 2], [1, 3]])
    domain = {"xmin": 0.0, "xmax": 1.0, "ymin": 0.0, "ymax": 1.0}
    wells = np.array([[0.3, 0.7], [0.3, 0.6]])
    for mod in (pt, pt_jax):
        ax = mod.plot_fractures(pts, edges, domain)
        assert len(ax.lines) == 1 + edges.shape[1]
        assert ax.get_xlim() == (0.0, 1.0)
        ax = mod.plot_wells(domain, wells)
        assert len(ax.lines) == 1 + wells.shape[1]
    import matplotlib.pyplot as plt

    plt.close("all")


def test_diagnostics_of_flow_benchmark_case_1():
    """``run_diagnostics`` at the profiling entry's geometry 0 (Flemisch et
    al. case 1) at 1/16 on the host-solver route, both handlers (the
    condition number a dense SVD per block): the port's blocks, maxima and
    condition numbers as porepy_tpu's."""
    from porepy_tpu.applications.profiling import run_profiling as rp_jax
    from porepy_tpu_torch.applications.profiling import run_profiling as rp

    out = []
    for build, mod in ((rp.build_model, pt), (rp_jax.build_model, pt_jax)):
        model, _params = (build("flow", 0, 0, device="cpu") if mod is pt else build("flow", 0, 0))

        class Diagnosed(mod.DiagnosticsMixin, type(model)):
            pass

        model = Diagnosed(model.params)
        model.prepare_simulation()
        model.before_nonlinear_loop()
        model.before_nonlinear_iteration()
        model.assemble_linear_system()
        out.append(model.run_diagnostics(default_handlers=("max", "cond")))
    data, data_jax = out
    assert len(data) >= 4
    _same_diagnostics(data, data_jax, tol=1e-9)
    for key, entry in data_jax.items():
        assert abs(data[key]["max"] - entry["max"]) <= 1e-12 * abs(entry["max"]), key


def test_diagnostics_on_a_device_route_raise_in_both():
    """A ``device*`` linear solver keeps the matrix on the device, and both
    packages store ``linear_system = (None, b)``: ``run_diagnostics`` then
    raises the same ``ValueError`` (``sps.csr_matrix(None)``) in both."""
    errors = []
    for mod in (pt, pt_jax):
        m = _diagnostic_model(mod, linear_solver="device_gmres")
        assert m.linear_system[0] is None
        with pytest.raises(ValueError) as err:
            m.run_diagnostics()
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_protocol_runtime_mixin_safe():
    """``tests/models/test_protocol.py`` on the port: the ``PorePyModel``
    protocol composes with a model at run time (no ``__slots__``)."""

    class Mixin(pt.PorePyModel):
        def extra_term(self):
            return self.nd

    class Model(Mixin, pt.SinglePhaseFlow):
        pass

    m = Model({"device": "cpu"})
    m.prepare_simulation()
    assert m.extra_term() == m.nd
    assert isinstance(m.equation_system.get_variable_values(iterate_index=0), np.ndarray)
    assert pt.PorePyModel is not pt_jax.PorePyModel


def test_adtree_parity(golden):
    """``test_adtree_parity`` on the port: the boxes each search finds, as
    the reference's golden and porepy_tpu's tree."""
    from porepy_tpu.utils.adtree import ADTNode as NodeJax
    from porepy_tpu.utils.adtree import ADTree as TreeJax
    from porepy_tpu_torch.utils.adtree import ADTNode, ADTree

    trees = []
    for mod, tree_cls in ((pt, ADTree), (pt_jax, TreeJax)):
        g = mod.CartGrid([6, 5], physdims=[1, 1])
        g.compute_geometry()
        tree = tree_cls(4, 2)
        tree.from_grid(g)
        trees.append(tree)
    tm, tj = trees
    rng = np.random.default_rng(6)
    boxes = []
    for _ in range(20):
        lo = rng.random(2) * 0.8
        hi = lo + rng.random(2) * 0.2
        boxes.append(np.hstack((lo, hi)))

    def compute(ref_pp):
        import porepy.utils.adtree as radt

        gr = ref_pp.CartGrid(np.array([6, 5]), np.array([1.0, 1.0]))
        gr.compute_geometry()
        tr = radt.ADTree(4, 2)
        tr.from_grid(gr)
        out = {}
        for i, box in enumerate(boxes):
            out[f"hits_{i}"] = np.asarray(tr.search(radt.ADTNode(99, box)), dtype=int)
        return out

    ref = golden(compute)
    for i, box in enumerate(boxes):
        a = np.asarray(tm.search(ADTNode(99, box)), dtype=int)
        assert np.array_equal(a, ref[f"hits_{i}"]), i
        assert np.array_equal(a, np.asarray(tj.search(NodeJax(99, box)), dtype=int)), i
