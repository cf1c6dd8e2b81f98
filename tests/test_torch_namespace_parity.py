"""The flat namespace of porepy_tpu_torch against porepy_tpu's and the
reference's: ``tests/test_namespace_parity.py`` on the port. Every public
name of ``porepy_tpu`` and every public name of the reference's ``pp``
namespace (its golden, ``tests/goldens/test_reference_namespace_covered.npz``)
exists in ``porepy_tpu_torch``, so a script written against either resolves
its names on the port. That each name is the port's own object, not
porepy_tpu's, is ``tests/test_torch_host_copy.py``'s
``test_exported_names_are_the_ports_own``."""

import os

import numpy as np

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt

# Import-side-effect artifacts of the reference's __init__, not API (as in
# tests/test_namespace_parity.py).
_NON_API = {
    "os", "sys", "Path", "warnings", "configparser", "cwd", "pth",
    "porepy", "test_utils", "cfg", "config",
}


def test_porepy_tpu_namespace_covered():
    theirs = {n for n in dir(pt_jax) if not n.startswith("_")}
    missing = sorted(n for n in theirs if not hasattr(pt, n))
    assert not missing, f"missing top-level names: {missing}"


def test_reference_namespace_covered(golden):
    """The reference's names, as ``tests/test_namespace_parity.py`` holds
    porepy_tpu to them (the same golden: this test's name is that one's)."""
    def compute(ref_pp):
        names = sorted(
            {n for n in dir(ref_pp) if not n.startswith("_")} - _NON_API
        )
        return {"names": np.array(names)}

    theirs = [str(n) for n in golden(compute)["names"]]
    assert len(theirs) > 150
    missing = sorted(n for n in theirs if not hasattr(pt, n))
    assert not missing, f"missing top-level names: {missing}"


def test_import_promise():
    """Importing the port binds all of that without jax, matplotlib or
    triton, and leaves torch's default dtype and device as they were."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "dtype, dev = torch.get_default_dtype(), torch.get_default_device()\n"
        "import porepy_tpu_torch as pp\n"
        "pp.create_mdg, pp.Well, pp.plot_grid, pp.DiagnosticsMixin, pp.BAR\n"
        "loaded = [m for m in ('jax', 'matplotlib', 'triton') if sys.modules.get(m) is not None]\n"
        "assert not loaded, loaded\n"
        "assert (torch.get_default_dtype(), torch.get_default_device()) == (dtype, dev)\n"
        "from porepy_tpu_torch.kernels import build\n"
        "assert build._LIB is None\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, env=env, timeout=300)
