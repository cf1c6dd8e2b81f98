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


@pytest.mark.parametrize("rel", DATA_FILES)
def test_data_file_matches_source(rel):
    with open(os.path.join(SOURCE, rel), "rb") as fh:
        want = fh.read()
    with open(os.path.join(PORT, rel), "rb") as fh:
        got = fh.read()
    assert got == want, f"porepy_tpu_torch/{rel} differs from porepy_tpu/{rel}"


@pytest.mark.parametrize(
    "name, module",
    [
        ("Thermoporomechanics", "porepy_tpu_torch.models.thermoporomechanics"),
        ("MassAndEnergyBalance", "porepy_tpu_torch.models.mass_and_energy_balance"),
        ("mdg_library", "porepy_tpu_torch.applications.md_grids.mdg_library"),
    ],
)
def test_exported_names_are_the_ports_own(name, module):
    """The names this slice adds to ``porepy_tpu_torch`` resolve to the
    port's objects, never to porepy_tpu's."""
    import porepy_tpu as pt_jax
    import porepy_tpu_torch as pt

    obj = getattr(pt, name)
    assert getattr(obj, "__module__", getattr(obj, "__name__", None)) == module
    assert obj is not getattr(pt_jax, name)
    if name == "mdg_library":
        assert obj.benchmark_3d_case_2.__module__ == module
        assert obj.create_mdg.__module__ == "porepy_tpu_torch.grids.mdg_generation"
