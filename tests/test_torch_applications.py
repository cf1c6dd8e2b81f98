"""The applications layer's material values and convergence-analysis
harness through porepy_tpu_torch on the CPU
(``applications/material_values/*``, ``applications/convergence_analysis.py``
and ``utils/txt_io.py``, copied from porepy_tpu): the tests of
``tests/applications/test_applications.py`` that use them, and the harness's
errors against porepy_tpu's on the same inputs."""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu.applications.convergence_analysis import ConvergenceAnalysis as ConvergenceAnalysisJax
from porepy_tpu_torch.applications.convergence_analysis import ConvergenceAnalysis
from porepy_tpu_torch.applications.material_values import fluid_values, solid_values
from porepy_tpu_torch.utils.txt_io import read_data_from_txt

torch.set_num_threads(1)


def test_material_values_construct_constants():
    solid = pt.SolidConstants(**solid_values.granite)
    fluid = pt.FluidComponent(**fluid_values.water)
    assert solid.biot_coefficient == 0.47
    assert np.isclose(fluid.viscosity, 1.002e-3)


@pytest.mark.parametrize("name", ["fluid_values", "numerical_values", "reference_values", "solid_values"])
def test_material_values_equal_porepy_tpus(name):
    """Every dictionary of the four modules equals porepy_tpu's."""
    mine, theirs = getattr(pt, name), getattr(pt_jax, name)
    tables = {k: v for k, v in vars(theirs).items() if isinstance(v, dict) and not k.startswith("__")}
    assert tables
    for key, table in tables.items():
        assert getattr(mine, key) == table, key


@dataclass
class _Result:
    error_pressure: float = 0.0


def _manufactured(pkg, analysis):
    """``test_applications.py``'s manufactured solution ``sin(pi x) sin(pi
    y)`` on the unit square for ``pkg``, its L2 error collected by
    ``analysis`` (that package's ``ConvergenceAnalysis``)."""

    class Manufactured(pkg.SinglePhaseFlow):
        def exact_pressure(self, sd):
            return np.sin(np.pi * sd.cell_centers[0]) * np.sin(np.pi * sd.cell_centers[1])

        def fluid_source(self, subdomains):
            if not subdomains or subdomains[0].dim != self.nd:
                return super().fluid_source(subdomains)
            vals = [2 * np.pi**2 * self.exact_pressure(sd) * sd.cell_volumes for sd in subdomains]
            return pkg.ad.DenseArray(np.concatenate(vals), "source")

        def bc_values_pressure(self, bg):
            return np.zeros(bg.num_cells)

        def collect_data(self):
            sd = self.mdg.subdomains(dim=self.nd)[0]
            p = np.asarray(self.equation_system.get_variable_values(["pressure"], iterate_index=0))
            err = analysis.l2_error(sd, self.exact_pressure(sd), p[: sd.num_cells], True, True, relative=True)
            return _Result(error_pressure=err)

    return Manufactured


def _params(pkg, **extra):
    params = {
        "meshing_arguments": {"cell_size": 0.25},
        "material_constants": {
            "solid": pkg.SolidConstants(permeability=1.0, porosity=0.1),
            "fluid": pkg.FluidComponent(viscosity=1.0, density=1.0, compressibility=0.0),
        },
        "time_manager": pkg.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "suppress_export": True,
    }
    params.update(extra)
    return params


def test_convergence_analysis_second_order(tmp_path):
    """Three levels, halving the cell size: the pressure converges at an
    observed order between 1.8 and 2.3; each level's error within 1e-12 of
    porepy_tpu's harness on the same model; the errors written by
    ``export_errors_to_txt`` read back."""
    ca = ConvergenceAnalysis(_manufactured(pt, ConvergenceAnalysis), _params(pt, device="cpu"), levels=3,
                             spatial_refinement_rate=2)
    results = ca.run_analysis()
    ooc = ca.order_of_convergence(results)
    assert 1.8 < ooc["ooc_pressure"] < 2.3

    ca_jax = ConvergenceAnalysisJax(_manufactured(pt_jax, ConvergenceAnalysisJax), _params(pt_jax), levels=3,
                                    spatial_refinement_rate=2)
    results_jax = ca_jax.run_analysis()
    errors = np.array([r.error_pressure for r in results])
    np.testing.assert_allclose(errors, [r.error_pressure for r in results_jax], rtol=0, atol=1e-12)
    assert [r.cell_diameter for r in results] == [r.cell_diameter for r in results_jax]
    assert abs(ooc["ooc_pressure"] - ca_jax.order_of_convergence(results_jax)["ooc_pressure"]) < 1e-9

    path = tmp_path / "errors.txt"
    ca.export_errors_to_txt(results, file_name=path)
    table = read_data_from_txt(path)
    assert sorted(table) == ["cell_diameter", "error_pressure", "time_step"]
    np.testing.assert_allclose(table["error_pressure"], errors, rtol=1e-2)
