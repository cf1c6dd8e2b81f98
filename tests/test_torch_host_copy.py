"""The host (numpy/scipy) modules that porepy_tpu_torch carries over from
porepy_tpu stay identical to their sources, apart from the package name in
import statements. A change to either side without the other fails here.
"""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "porepy_tpu_torch")
SOURCE = os.path.join(REPO, "porepy_tpu")

# Modules of the port that are rewritten for torch (or new), not copied.
PORTED = {
    "__init__.py",
    "applications/benchmarking/cases.py",
    "applications/profiling/run_profiling.py",
    "compositional/flash.py",
    "examples/__init__.py",
    "models/constitutive_laws.py",
    "models/contact_mechanics.py",
    "models/darcys_law_ad.py",
    "models/solution_strategy.py",
    "numerics/ad/compiler.py",
    "numerics/ad/equation_system.py",
    "numerics/ad/functions.py",
    "numerics/ad/operator_functions.py",
    "numerics/ad/surrogate_operator.py",
    "numerics/fv/fv_mesh.py",
    "numerics/fv/local_solves.py",
    "numerics/fv/tpfa.py",
    "numerics/fv/upwind.py",
    "numerics/linalg/amg.py",
    "numerics/linalg/device_solver.py",
    "numerics/linalg/krylov.py",
    "numerics/linalg/matrix_operations.py",
    "parallel/__init__.py",
    "parallel/flow_step.py",
    "parallel/sharded.py",
    "parallel/structured_flow.py",
    "utils/device_policy.py",
}

_IMPORT = re.compile(r"\b(from|import)(\s+)porepy_tpu\b")


def _copied_modules():
    out = []
    for dirpath, _dirs, files in os.walk(PORT):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), PORT)
            if f.endswith(".py") and rel not in PORTED:
                if os.path.exists(os.path.join(SOURCE, rel)):
                    out.append(rel)
    return sorted(out)


COPIED = _copied_modules()


def test_ported_modules_exist():
    for rel in PORTED:
        assert os.path.exists(os.path.join(PORT, rel)), rel
    assert len(COPIED) >= 80


#: The modules copied since the drift check began listing them by name: each
#: is under :func:`test_host_copy_matches_source`.
NEW_COPIES = (
    "examples/flow_benchmark_3d_case_3.py",
    "examples/terzaghi_biot.py",
    "examples/mandel_biot.py",
    "utils/examples_utils.py",
    "utils/txt_io.py",
    "applications/convergence_analysis.py",
    "applications/material_values/numerical_values.py",
    "applications/material_values/reference_values.py",
    "applications/material_values/solid_values.py",
    "numerics/nonlinear/line_search.py",
    "numerics/nonlinear/anderson_acceleration.py",
    "numerics/fracture_deformation/__init__.py",
    "numerics/fracture_deformation/propagate_fracture.py",
    "numerics/fracture_deformation/propagation_model.py",
    "numerics/fracture_deformation/conforming_propagation.py",
    "numerics/displacement_correlation.py",
    "models/fracture_damage.py",
    "examples/fracture_damage.py",
    "numerics/fv/tpsa.py",
    "numerics/vem/__init__.py",
    "numerics/vem/dual_elliptic.py",
    "numerics/vem/mass_matrix.py",
    "numerics/vem/vem_source.py",
    "numerics/vem/mvem.py",
    "numerics/vem/hybrid.py",
    "numerics/fem/__init__.py",
    "numerics/fem/rt0.py",
    "grids/refinement.py",
    "grids/grid_extrusion.py",
    "fracs/tools.py",
    "fracs/wells_3d.py",
    "utils/adtree.py",
    "utils/permutations.py",
    "utils/porepy_types.py",
    "models/protocol.py",
    "viz/plot_grid.py",
    "viz/diagnostics_mixin.py",
    "viz/fracture_visualization.py",
    "applications/profiling/__init__.py",
)


def _source_files() -> set:
    return {
        os.path.relpath(os.path.join(d, f), SOURCE)
        for d, _dirs, files in os.walk(SOURCE)
        for f in files
        if f.endswith(".py")
    }


def test_every_source_module_is_in_the_port():
    """Of porepy_tpu's modules only the tunnel machinery
    (``applications/benchmarking/nopull.py``) is absent from the port; every
    other one is a copy under the drift check or in :data:`PORTED`."""
    missing = sorted(rel for rel in _source_files() if not os.path.exists(os.path.join(PORT, rel)))
    assert missing == ["applications/benchmarking/nopull.py"]


@pytest.mark.parametrize("rel", NEW_COPIES)
def test_new_copies_are_checked(rel):
    assert rel in COPIED and rel not in PORTED


@pytest.mark.parametrize("rel", COPIED)
def test_host_copy_matches_source(rel):
    with open(os.path.join(SOURCE, rel)) as fh:
        want = _IMPORT.sub(r"\1\2porepy_tpu_torch", fh.read())
    with open(os.path.join(PORT, rel)) as fh:
        got = fh.read()
    assert got == want, f"porepy_tpu_torch/{rel} drifted from porepy_tpu/{rel}"


# Data directories of the port copied from porepy_tpu: every file in them
# that is not a module equals its source byte for byte.
DATA_DIRS = ("applications/md_grids/file_library",)


def _copied_data_files():
    out = []
    for top in DATA_DIRS:
        for dirpath, _dirs, files in os.walk(os.path.join(PORT, top)):
            for f in files:
                if not f.endswith((".py", ".pyc")):
                    out.append(os.path.relpath(os.path.join(dirpath, f), PORT))
    return sorted(out)


DATA_FILES = _copied_data_files()


def test_copied_data_files_exist():
    """The Berre et al. 3d case 2 files that ``mdg_library`` reads beside
    itself are in the port."""
    lib = "applications/md_grids/file_library/benchmark_3d_case_2/"
    want = {lib + f for f in os.listdir(os.path.join(SOURCE, lib))}
    assert want <= set(DATA_FILES)
    assert lib + "fracture_network.csv" in DATA_FILES


@pytest.mark.parametrize("case", ["benchmark_2d_case_4", "benchmark_3d_case_3"])
def test_benchmark_data_dirs_copied(case):
    """The data the Flemisch et al. case 4 example and ``mdg_library``'s
    Berre et al. 3d case 3 read beside themselves are in the port, every
    file of porepy_tpu's directory."""
    lib = f"applications/md_grids/file_library/{case}/"
    want = {lib + f for f in os.listdir(os.path.join(SOURCE, lib))}
    assert want and want <= set(DATA_FILES)


@pytest.mark.parametrize("rel", DATA_FILES)
def test_data_file_matches_source(rel):
    with open(os.path.join(SOURCE, rel), "rb") as fh:
        want = fh.read()
    with open(os.path.join(PORT, rel), "rb") as fh:
        got = fh.read()
    assert got == want, f"porepy_tpu_torch/{rel} differs from porepy_tpu/{rel}"


def _flat_names_of_source() -> dict:
    """``{name: module}`` of every name ``porepy_tpu/__init__.py`` imports
    from a module of its own package."""
    import ast

    with open(os.path.join(SOURCE, "__init__.py")) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "porepy_tpu":
            for alias in node.names:
                out[alias.asname or alias.name] = node.module
    return out


#: The module of a case below that is where porepy_tpu defines the name,
#: in the port's package.
AS_SOURCE = "as in porepy_tpu"
_LISTED = (
    ("Thermoporomechanics", "porepy_tpu_torch.models.thermoporomechanics"),
        ("MassAndEnergyBalance", "porepy_tpu_torch.models.mass_and_energy_balance"),
        ("mdg_library", "porepy_tpu_torch.applications.md_grids.mdg_library"),
        ("PARAMETERS", None),
        ("ITERATE_SOLUTIONS", None),
        ("TIME_STEP_SOLUTIONS", None),
        ("DISCRETIZATION_MATRICES", None),
        ("set_local_coordinate_projections", "porepy_tpu_torch.utils.tangential_normal_projection"),
        ("Exporter", "porepy_tpu_torch.viz.exporter"),
        ("match_grids", "porepy_tpu_torch.grids.match_grids"),
        ("grid_utils", "porepy_tpu_torch.utils.grid_utils"),
        ("geometry_property_checks", "porepy_tpu_torch.geometry.geometry_property_checks"),
        ("LineSearchNewtonSolver", "porepy_tpu_torch.numerics.nonlinear.line_search"),
        ("SplineInterpolationLineSearch", "porepy_tpu_torch.numerics.nonlinear.line_search"),
        ("ConstraintLineSearch", "porepy_tpu_torch.numerics.nonlinear.line_search"),
        ("AndersonAcceleration", "porepy_tpu_torch.numerics.nonlinear.anderson_acceleration"),
        ("ContactIndicators", "porepy_tpu_torch.models.solution_strategy"),
        ("fluid_values", "porepy_tpu_torch.applications.material_values.fluid_values"),
        ("numerical_values", "porepy_tpu_torch.applications.material_values.numerical_values"),
        ("reference_values", "porepy_tpu_torch.applications.material_values.reference_values"),
        ("solid_values", "porepy_tpu_torch.applications.material_values.solid_values"),
        ("propagate_fractures", "porepy_tpu_torch.numerics.fracture_deformation.propagate_fracture"),
        ("propagate_fracture", "porepy_tpu_torch.numerics.fracture_deformation.propagate_fracture"),
        (
            "ConformingFracturePropagation",
            "porepy_tpu_torch.numerics.fracture_deformation.conforming_propagation",
        ),
        ("displacement_correlation", "porepy_tpu_torch.numerics.displacement_correlation"),
        ("fracture_damage", "porepy_tpu_torch.models.fracture_damage"),
        ("Tpsa", "porepy_tpu_torch.numerics.fv.tpsa"),
        ("MVEM", "porepy_tpu_torch.numerics.vem.mvem"),
        ("HybridDualVEM", "porepy_tpu_torch.numerics.vem.hybrid"),
        ("MixedMassMatrix", "porepy_tpu_torch.numerics.vem.mass_matrix"),
        ("MixedInvMassMatrix", "porepy_tpu_torch.numerics.vem.mass_matrix"),
        ("DualScalarSource", "porepy_tpu_torch.numerics.vem.vem_source"),
        ("RT0", "porepy_tpu_torch.numerics.fem.rt0"),
        ("project_flux", "porepy_tpu_torch.numerics.vem.dual_elliptic"),
)
_SOURCE_NAMES = _flat_names_of_source()


@pytest.mark.parametrize(
    "name, module",
    list(_LISTED) + [(n, AS_SOURCE) for n in sorted(set(_SOURCE_NAMES) - {n for n, _m in _LISTED})],
)
def test_exported_names_are_the_ports_own(name, module):
    """Every public name of ``porepy_tpu``'s flat namespace resolves in
    ``porepy_tpu_torch`` to the port's object, never to porepy_tpu's: a
    class, function or module defined in the port's counterpart of the
    module that defines porepy_tpu's (``AS_SOURCE``), a constant or a type
    alias bound from the port's counterpart of the module porepy_tpu binds
    it from, and equal to porepy_tpu's."""
    import types
    from importlib import import_module

    import porepy_tpu as pt_jax
    import porepy_tpu_torch as pt

    obj = getattr(pt, name)
    if module == AS_SOURCE:
        src = getattr(pt_jax, name)
        where = src.__name__ if isinstance(src, types.ModuleType) else getattr(src, "__module__", None)
        if not str(where).startswith("porepy_tpu."):
            # A constant or a typing alias: the same value, the port's binding.
            port_module = import_module(_SOURCE_NAMES[name].replace("porepy_tpu", "porepy_tpu_torch", 1))
            assert obj is getattr(port_module, name) and obj == src
            return
        module = where.replace("porepy_tpu", "porepy_tpu_torch", 1)
    if module is None:
        # A string key: the port's own constant, equal to porepy_tpu's.
        from porepy_tpu_torch.utils import common_constants

        assert obj is getattr(common_constants, name) and obj == getattr(pt_jax, name)
        return
    assert getattr(obj, "__module__", getattr(obj, "__name__", None)) == module
    assert obj is not getattr(pt_jax, name)
    if name == "mdg_library":
        assert obj.benchmark_3d_case_2.__module__ == module
        assert obj.create_mdg.__module__ == "porepy_tpu_torch.grids.mdg_generation"


def _module_file(dotted: str):
    """The file of the port's module ``dotted`` (a package's
    ``__init__.py``), or None if there is no such module."""
    base = os.path.join(REPO, *dotted.split("."))
    if os.path.isfile(os.path.join(base, "__init__.py")):
        return os.path.join(base, "__init__.py")
    if os.path.isfile(base + ".py"):
        return base + ".py"
    return None


def _top_level_names(path: str) -> tuple[set, bool]:
    """The names a module binds at its top level (definitions, imports,
    assignments, also inside top-level ``if``/``try``), and whether it
    star-imports."""
    import ast

    with open(path) as fh:
        tree = ast.parse(fh.read())
    names, star = set(), False
    for node in tree.body:
        for sub in ast.walk(node) if isinstance(node, (ast.If, ast.Try)) else [node]:
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(sub.name)
            elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                for alias in sub.names:
                    star |= alias.name == "*"
                    names.add((alias.asname or alias.name).split(".")[0])
            elif isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                for target in targets:
                    names.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
    return names, star


def _imports_of_absent_modules():
    """Every import statement inside the port (at any depth, lazy ones
    too) that names a ``porepy_tpu_torch`` module that does not exist:
    ``import a.b``, ``from a.b import c`` where ``a.b`` is missing, and
    ``from a import b`` where ``b`` is neither a module of package ``a``
    nor a name its ``__init__`` (or module ``a``) binds."""
    import ast

    bad = []
    for dirpath, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, REPO)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        if alias.name.split(".")[0] == "porepy_tpu_torch" and not _module_file(alias.name):
                            bad.append(f"{rel}:{node.lineno} import {alias.name}")
                elif isinstance(node, ast.ImportFrom) and not node.level and node.module:
                    if node.module.split(".")[0] != "porepy_tpu_torch":
                        continue
                    target = _module_file(node.module)
                    if target is None:
                        bad.append(f"{rel}:{node.lineno} from {node.module}")
                        continue
                    names, star = _top_level_names(target)
                    for alias in node.names:
                        sub = f"{node.module}.{alias.name}"
                        if not (_module_file(sub) or star or alias.name in names):
                            bad.append(f"{rel}:{node.lineno} from {node.module} import {alias.name}")
    return bad


def test_no_import_of_an_absent_module():
    """Every ``porepy_tpu_torch`` module named in an import statement of
    the port exists: a module copied without the modules it imports fails
    here, not in a user's run. A name imported from a package (say
    ``kernels.EllOperator``) may be an attribute the package binds rather
    than a module."""
    assert _imports_of_absent_modules() == []


def test_absent_module_check_finds_the_faults(tmp_path, monkeypatch):
    """The check above reports an import of a missing module, of a missing
    submodule from a package, and of a name the package does not bind, and
    passes a name that the package binds."""
    pkg = tmp_path / "porepy_tpu_torch"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "__init__.py").write_text("from porepy_tpu_torch.sub.here import thing\n")
    (pkg / "sub" / "__init__.py").write_text("bound = 1\n")
    (pkg / "sub" / "here.py").write_text(
        "thing = 2\n"
        "def f():\n"
        "    from porepy_tpu_torch.sub import bound, here\n"
        "    from porepy_tpu_torch.sub import gone\n"
        "    from porepy_tpu_torch.sub.missing import x\n"
        "    import porepy_tpu_torch.other\n"
    )
    monkeypatch.setitem(globals(), "REPO", str(tmp_path))
    monkeypatch.setitem(globals(), "PORT", str(pkg))
    bad = _imports_of_absent_modules()
    assert [b.split(" ", 1)[1] for b in bad] == [
        "from porepy_tpu_torch.sub import gone",
        "from porepy_tpu_torch.sub.missing",
        "import porepy_tpu_torch.other",
    ]


def _absent_flat_names():
    """Every ``pt.X`` in the port's modules and ``chip_smoke.py``, where
    ``pt`` is a name the file binds to ``porepy_tpu_torch`` (``import
    porepy_tpu_torch as pt``, ``import porepy_tpu_torch[.sub]``), whose
    ``X`` is neither a name the package's ``__init__.py`` binds nor a
    module of the package: the attribute would raise ``AttributeError`` in
    a user's run."""
    import ast

    bound, _star = _top_level_names(os.path.join(PORT, "__init__.py"))
    files = [os.path.join(d, f) for d, _dirs, fs in os.walk(PORT) for f in sorted(fs) if f.endswith(".py")]
    smoke = os.path.join(REPO, "chip_smoke.py")
    bad = []
    for path in sorted(files) + ([smoke] if os.path.exists(smoke) else []):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        aliases = {
            alias.asname or "porepy_tpu_torch"
            for node in ast.walk(tree)
            if isinstance(node, ast.Import)
            for alias in node.names
            if alias.name == "porepy_tpu_torch" or (alias.asname is None and alias.name.startswith("porepy_tpu_torch."))
        }
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in aliases
                and not node.attr.startswith("__")
                and node.attr not in bound
                and not _module_file(f"porepy_tpu_torch.{node.attr}")
            ):
                bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {node.value.id}.{node.attr}")
    return bad


def test_no_absent_flat_name():
    """Every ``pt.X`` the port and ``chip_smoke.py`` reach is bound by the
    port's ``__init__.py`` (or is one of its modules)."""
    assert _absent_flat_names() == []


def test_absent_flat_name_check_finds_the_faults(tmp_path, monkeypatch):
    """The check above reports a name the package does not bind, in a
    module of the port and in ``chip_smoke.py``, and passes a bound name,
    an imported name, a module and an alias of another package."""
    pkg = tmp_path / "porepy_tpu_torch"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "__init__.py").write_text("from porepy_tpu_torch.sub.here import thing\nbound = 1\n")
    (pkg / "sub" / "__init__.py").write_text("")
    (pkg / "sub" / "here.py").write_text(
        "import numpy as np\n"
        "thing = np.gone\n"
        "def f():\n"
        "    import porepy_tpu_torch as pt\n"
        "    return pt.bound, pt.thing, pt.sub, pt.__version__, pt.gone\n"
    )
    (tmp_path / "chip_smoke.py").write_text("import porepy_tpu_torch as pp\npp.thing(pp.missing)\n")
    monkeypatch.setitem(globals(), "REPO", str(tmp_path))
    monkeypatch.setitem(globals(), "PORT", str(pkg))
    assert _absent_flat_names() == ["porepy_tpu_torch/sub/here.py:5 pt.gone", "chip_smoke.py:2 pp.missing"]
