"""The port's VTK exporter (``porepy_tpu_torch.viz.exporter``, copied from
porepy_tpu: its own VTK XML writer, no meshio) against porepy_tpu's on the
CPU, both packages in one process: a default model run with export on
writes its files, the two exporters write the same bytes for the same grids
and fields, and the checks of ``tests/viz/test_exporter.py`` through the
port."""

import glob
import itertools
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import porepy_tpu as pt_jax
import porepy_tpu_torch as pt
from porepy_tpu.fracs import meshing as meshing_jax
from porepy_tpu_torch.fracs import meshing
from porepy_tpu_torch.viz.exporter import Exporter

torch.set_num_threads(1)


def _files(folder):
    return sorted(os.path.basename(f) for f in glob.glob(os.path.join(folder, "*")))


def test_default_model_run_exports(tmp_path):
    """``run_time_dependent_model`` on a default ``SinglePhaseFlow`` with
    export on (it raised ``ModuleNotFoundError`` before the exporter was
    ported) writes porepy_tpu's files, every one valid XML; the pressures
    in them agree within 1e-12 of the largest (the two solves of
    systems equal to rounding)."""
    out = {}
    for name, pkg, params in (
        ("torch", pt, {"device": "cpu"}),
        ("jax", pt_jax, {}),
    ):
        folder = tmp_path / name
        params = dict(params, folder_name=str(folder))
        model = pkg.SinglePhaseFlow(params)
        pkg.run_time_dependent_model(model, params)
        out[name] = (folder, model)
    files = _files(out["torch"][0])
    assert files == _files(out["jax"][0])
    assert {"data_000000.pvd", "data_000001.pvd", "data_2_000000.vtu", "data_2_000001.vtu"} <= set(files)
    for f in files:
        ET.parse(out["torch"][0] / f)
    p, p_jax = (
        m.equation_system.get_variable_values(["pressure"], time_step_index=0) for _f, m in out.values()
    )
    assert np.abs(p - np.asarray(p_jax)).max() <= 1e-12 * max(np.abs(p_jax).max(), 1.0)


@pytest.fixture()
def same_ids(monkeypatch):
    """Both packages number their grids and mortar grids from one start
    (the ids are process-wide counters, which the exported
    ``subdomain_id`` and ``interface_id`` carry)."""
    from porepy_tpu.grids import grid as grid_jax
    from porepy_tpu.grids.mortar_grid import MortarGrid as MortarGridJax
    from porepy_tpu_torch.grids import grid as grid_torch
    from porepy_tpu_torch.grids.mortar_grid import MortarGrid

    def restart():
        for module in (grid_torch, grid_jax):
            monkeypatch.setattr(module, "_counter", itertools.count(10**6))
        for cls in (MortarGrid, MortarGridJax):
            monkeypatch.setattr(cls, "_counter", itertools.count(10**6))

    return restart


def _md_pair(restart):
    """A 2d Cartesian grid with two crossing fractures in both packages."""
    fracs = [np.array([[0.25, 0.75], [0.5, 0.5]]), np.array([[0.5, 0.5], [0.2, 0.8]])]
    out = []
    for m in (meshing, meshing_jax):
        restart()
        out.append(m.cart_grid(fracs, np.array([6, 5]), physdims=[1.0, 1.0]))
    return out


@pytest.mark.parametrize("binary", [True, False])
def test_same_bytes_as_porepy_tpu(tmp_path, binary, same_ids):
    """The port's ``Exporter`` and porepy_tpu's, given the same md grid
    (subdomains and mortars) and the same numpy fields, two time steps,
    write byte-identical ``.vtu`` and ``.pvd`` files."""
    rng = np.random.default_rng(7)
    mdgs = _md_pair(same_ids)
    fields = []
    for sd in mdgs[0].subdomains():
        fields.append(("p", rng.standard_normal(sd.num_cells)))
    folders = []
    for mdg, exp, tag in zip(mdgs, (Exporter, pt_jax.Exporter), ("torch", "jax")):
        folder = tmp_path / tag
        e = exp(mdg, "md", folder_name=str(folder), binary=binary)
        for step, scale in enumerate((1.0, 2.0)):
            data = [(sd, name, scale * v) for sd, (name, v) in zip(mdg.subdomains(), fields)]
            intf_data = [
                (intf, "lam", scale * np.arange(intf.num_cells, dtype=float)) for intf in mdg.interfaces()
            ]
            e.write_vtu(data + intf_data, time_step=step)
        e.write_pvd(np.array([0.0, 1.0]))
        folders.append(folder)
    names = _files(folders[0])
    assert names == _files(folders[1]) and len(names) > 4
    for f in names:
        with open(folders[0] / f, "rb") as a, open(folders[1] / f, "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("binary", [True, False])
def test_single_grid_export(tmp_path, binary):
    """``test_single_grid_export`` through the port."""
    g = pt.CartGrid([3, 2], physdims=[1, 1])
    g.compute_geometry()
    e = Exporter(g, "g2", folder_name=str(tmp_path), binary=binary)
    e.write_vtu([("p", np.arange(g.num_cells, dtype=float))])
    path = tmp_path / "g2_2_000000.vtu"
    assert path.exists()
    tree = ET.parse(path)
    piece = tree.getroot().find(".//Piece")
    assert int(piece.get("NumberOfCells")) == g.num_cells
    names = {d.get("Name") for d in tree.getroot().find(".//CellData")}
    assert {"p", "grid_dim", "cell_id", "subdomain_id"} <= names


def test_3d_polyhedral_export(tmp_path, same_ids):
    """``test_3d_polyhedral_export`` through the port, and the same bytes as
    porepy_tpu's file."""
    for tag, pkg, exp in (("torch", pt, Exporter), ("jax", pt_jax, pt_jax.Exporter)):
        same_ids()
        g = pkg.CartGrid([2, 2, 2], physdims=[1, 1, 1])
        g.compute_geometry()
        exp(g, "g3", folder_name=str(tmp_path / tag)).write_vtu()
    tree = ET.parse(tmp_path / "torch" / "g3_3_000000.vtu")
    cells = tree.getroot().find(".//Cells")
    assert any(d.get("Name") == "faces" for d in cells)
    assert any(d.get("Name") == "faceoffsets" for d in cells)
    with open(tmp_path / "torch" / "g3_3_000000.vtu", "rb") as a, open(tmp_path / "jax" / "g3_3_000000.vtu", "rb") as b:
        assert a.read() == b.read()


def test_md_export_and_restart_roundtrip(tmp_path):
    """``test_md_export_and_restart_roundtrip`` through the port (on the
    CPU): one vtu a dimension a step, the mortar files and the pvd index,
    all valid XML, and the pressure read back from them to the bit."""

    class Model(pt.SinglePhaseFlow):
        def set_fractures(self):
            self._fractures = [np.array([[0.25, 0.75], [0.5, 0.5]])]

        def bc_values_pressure(self, bg):
            return 1.0 - bg.cell_centers[1]

    params = {
        "grid_type": "cartesian",
        "meshing_arguments": {"cell_size": 0.25},
        "folder_name": str(tmp_path),
        "file_name": "sol",
        "material_constants": {
            "solid": pt.SolidConstants(
                permeability=1.0,
                porosity=0.1,
                residual_aperture=0.01,
                normal_permeability=1.0,
            )
        },
        "time_manager": pt.TimeManager([0, 1.0], 1.0, constant_dt=True),
        "device": "cpu",
    }
    m = Model(params)
    pt.run_time_dependent_model(m, params)

    files = _files(tmp_path)
    assert "sol_2_000001.vtu" in files
    assert "sol_1_000001.vtu" in files
    assert "sol_mortar_1_000001.vtu" in files
    assert "sol_000001.pvd" in files
    for f in glob.glob(str(tmp_path / "*")):
        ET.parse(f)

    p0 = m.equation_system.get_variable_values(["pressure"], iterate_index=0)
    m.equation_system.set_variable_values(np.zeros_like(p0), ["pressure"], iterate_index=0, time_step_index=0)
    m.load_data_from_pvd(str(tmp_path / "sol_000001.pvd"))
    p1 = m.equation_system.get_variable_values(["pressure"], iterate_index=0)
    assert np.abs(p0 - p1).max() == 0.0
