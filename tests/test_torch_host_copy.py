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
