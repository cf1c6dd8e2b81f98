"""Import of fracture networks from CSV files (reference
``fracs/fracture_importer.py``). The gmsh/fab importers are gated on their
external formats."""

from __future__ import annotations

from typing import Optional

import numpy as np

from porepy_tpu_torch.fracs.fracture import LineFracture, PlaneFracture
from porepy_tpu_torch.fracs.fracture_network_2d import FractureNetwork2d
from porepy_tpu_torch.fracs.fracture_network_3d import FractureNetwork3d

__all__ = ["network_2d_from_csv", "network_3d_from_csv"]


def network_2d_from_csv(
    f_name,
    tagcols=None,
    tol: float = 1e-8,
    max_num_fracs: Optional[int] = None,
    polyline: bool = False,
    return_frac_id: bool = False,
    domain=None,
    **kwargs,
):
    """Read a 2d network from CSV rows ``FID, START_X, START_Y, END_X,
    END_Y`` (or ``FID, PT_X, PT_Y`` polylines)."""
    npargs = {"delimiter": kwargs.get("delimiter", ","),
              "skip_header": kwargs.get("skip_header", 1)}
    data = np.atleast_2d(np.genfromtxt(f_name, **npargs))
    if data.size == 0:
        net = FractureNetwork2d(None, domain, tol)
        return (net, np.zeros(0)) if return_frac_id else net
    fracs: list[LineFracture] = []
    frac_id: list = []
    if polyline:
        ids = data[:, 0]
        for fid in np.unique(ids):
            pts = data[ids == fid, 1:3].T
            for k in range(pts.shape[1] - 1):
                fracs.append(LineFracture(pts[:, k : k + 2]))
                frac_id.append(fid)
    else:
        if max_num_fracs is not None:
            data = data[:max_num_fracs]
        for row in data:
            tags = None
            if tagcols is not None:
                tags = row[np.asarray(tagcols, dtype=int)]
            pts = np.array([[row[1], row[3]], [row[2], row[4]]])
            if np.allclose(pts[:, 0], pts[:, 1], atol=tol):
                continue
            fracs.append(LineFracture(pts, tags=tags))
            frac_id.append(row[0])
    network = FractureNetwork2d(fracs, domain, tol)
    if return_frac_id:
        return network, np.asarray(frac_id)
    return network


def network_3d_from_csv(
    file_name, has_domain: bool = True, tol: float = 1e-4, **kwargs
):
    """Read a 3d network from CSV: optionally a first domain row
    ``xmin, ymin, zmin, xmax, ymax, zmax``, then one fracture per row as
    ``x0, y0, z0, x1, y1, z1, ...`` vertex coordinate triplets."""
    from porepy_tpu_torch.geometry.domain import Domain

    delimiter = kwargs.get("delimiter", ",")
    with open(file_name) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    start = 0
    domain = None
    if has_domain:
        vals = np.fromstring(lines[0], sep=delimiter)
        domain = Domain(
            {
                "xmin": vals[0],
                "ymin": vals[1],
                "zmin": vals[2],
                "xmax": vals[3],
                "ymax": vals[4],
                "zmax": vals[5],
            }
        )
        start = 1
    fracs = []
    for ln in lines[start:]:
        vals = np.fromstring(ln, sep=delimiter)
        pts = vals.reshape((-1, 3)).T
        fracs.append(PlaneFracture(pts))
    return FractureNetwork3d(fracs, domain, tol)
