"""Export of (mixed-dimensional) grids and cell data to vtu/pvd.

Parity counterpart of reference ``viz/exporter.py:47``, with a
self-contained VTK XML writer instead of the meshio dependency: one vtu
file per dimension per time step (plus mortar-grid files), indexed by a
pvd file per step and a global pvd across steps. State import for restart
reads the same files back.

Cell geometry mapping: 0d cells are VTK vertices, 1d lines, 2d polygons,
3d polyhedra (general polytopal cells with explicit face streams).
"""

from __future__ import annotations

import base64
import os
import struct
import xml.etree.ElementTree as ET
from typing import Iterable, Optional, Union

import numpy as np

from porepy_tpu_torch.grids.grid import Grid
from porepy_tpu_torch.grids.md_grid import MixedDimensionalGrid
from porepy_tpu_torch.grids.mortar_grid import MortarGrid

__all__ = ["Exporter"]

# VTK cell type ids.
_VTK_VERTEX = 1
_VTK_LINE = 3
_VTK_POLYGON = 7
_VTK_POLYHEDRON = 42


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode()


_VTU_TYPE = {
    np.dtype(np.float64): "Float64",
    np.dtype(np.float32): "Float32",
    np.dtype(np.int64): "Int64",
    np.dtype(np.int32): "Int32",
    np.dtype(np.uint8): "UInt8",
    np.dtype(np.int8): "Int8",
}


class _VtuFile:
    """Accumulates one unstructured-grid piece and serializes it to XML."""

    def __init__(self, binary: bool = True) -> None:
        self.binary = binary
        self.points: np.ndarray = np.zeros((0, 3))
        self.connectivity: np.ndarray = np.zeros(0, dtype=np.int64)
        self.offsets: np.ndarray = np.zeros(0, dtype=np.int64)
        self.types: np.ndarray = np.zeros(0, dtype=np.uint8)
        self.faces: Optional[np.ndarray] = None
        self.faceoffsets: Optional[np.ndarray] = None
        self.cell_data: dict[str, np.ndarray] = {}

    def _data_array(self, name: str, arr: np.ndarray, n_comp: int = 0) -> ET.Element:
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.int32 or arr.dtype == np.int64:
            arr = arr.astype(np.int64)
        elif arr.dtype != np.uint8:
            arr = arr.astype(np.float64)
        el = ET.Element("DataArray", type=_VTU_TYPE[arr.dtype], Name=name)
        if n_comp:
            el.set("NumberOfComponents", str(n_comp))
        if self.binary:
            el.set("format", "binary")
            el.text = _b64(arr)
        else:
            el.set("format", "ascii")
            el.text = " ".join(map(str, arr.ravel().tolist()))
        return el

    def serialize(self, path: str) -> None:
        root = ET.Element(
            "VTKFile",
            type="UnstructuredGrid",
            version="0.1",
            byte_order="LittleEndian",
            header_type="UInt32",
        )
        ug = ET.SubElement(root, "UnstructuredGrid")
        piece = ET.SubElement(
            ug,
            "Piece",
            NumberOfPoints=str(self.points.shape[0]),
            NumberOfCells=str(self.types.size),
        )
        pts = ET.SubElement(piece, "Points")
        pts.append(self._data_array("Points", self.points, n_comp=3))
        cells = ET.SubElement(piece, "Cells")
        cells.append(self._data_array("connectivity", self.connectivity))
        cells.append(self._data_array("offsets", self.offsets))
        cells.append(self._data_array("types", self.types))
        if self.faces is not None and self.faces.size:
            cells.append(self._data_array("faces", self.faces))
            cells.append(self._data_array("faceoffsets", self.faceoffsets))
        cd = ET.SubElement(piece, "CellData")
        for name, arr in self.cell_data.items():
            n_comp = 3 if arr.ndim == 2 else 0
            if arr.ndim == 2:
                # Pad vector data to 3 components, point-major.
                padded = np.zeros((arr.shape[0], 3))
                padded[:, : arr.shape[1]] = arr
                arr = padded
            cd.append(self._data_array(name, arr, n_comp=n_comp))
        tree = ET.ElementTree(root)
        ET.indent(tree)
        tree.write(path, xml_declaration=True, encoding="utf-8")


def _grid_piece(grids: list, binary: bool) -> _VtuFile:
    """Concatenate same-dimension grids into one vtu piece (reference
    ``exporter.py:1781`` exports per-dimension files)."""
    f = _VtuFile(binary)
    pts = []
    conn = []
    offsets = []
    types = []
    faces = []
    faceoffsets = []
    node_offset = 0
    running_offset = 0
    running_face_offset = 0
    for g in grids:
        dim = g.dim
        if dim == 0:
            pts.append(np.asarray(g.cell_centers).T)
            for c in range(g.num_cells):
                conn.append(np.array([node_offset + c]))
                running_offset += 1
                offsets.append(running_offset)
                types.append(_VTK_VERTEX)
                faceoffsets.append(-1)
            node_offset += g.num_cells
            continue
        pts.append(np.asarray(g.nodes).T)
        cf = g.cell_faces.tocsc()
        fn = g.face_nodes.tocsc()
        if dim == 1:
            for c in range(g.num_cells):
                loc_f = cf.indices[cf.indptr[c] : cf.indptr[c + 1]]
                nodes = np.array(
                    [fn.indices[fn.indptr[fc]] for fc in loc_f], dtype=np.int64
                )
                conn.append(nodes + node_offset)
                running_offset += nodes.size
                offsets.append(running_offset)
                types.append(_VTK_LINE)
                faceoffsets.append(-1)
        elif dim == 2:
            sorted_nodes = _sorted_cell_nodes_2d(g)
            for c in range(g.num_cells):
                nodes = sorted_nodes[c]
                conn.append(nodes + node_offset)
                running_offset += nodes.size
                offsets.append(running_offset)
                types.append(_VTK_POLYGON)
                faceoffsets.append(-1)
        else:
            for c in range(g.num_cells):
                loc_f = cf.indices[cf.indptr[c] : cf.indptr[c + 1]]
                cell_nodes = []
                stream = [len(loc_f)]
                for fc in loc_f:
                    f_nodes = fn.indices[fn.indptr[fc] : fn.indptr[fc + 1]]
                    stream.append(f_nodes.size)
                    stream.extend((f_nodes + node_offset).tolist())
                    cell_nodes.extend(f_nodes.tolist())
                uniq = np.unique(np.asarray(cell_nodes, dtype=np.int64))
                conn.append(uniq + node_offset)
                running_offset += uniq.size
                offsets.append(running_offset)
                types.append(_VTK_POLYHEDRON)
                faces.extend(stream)
                running_face_offset += len(stream)
                faceoffsets.append(running_face_offset)
        node_offset += g.num_nodes
    f.points = np.vstack(pts) if pts else np.zeros((0, 3))
    f.connectivity = (
        np.concatenate(conn).astype(np.int64) if conn else np.zeros(0, np.int64)
    )
    f.offsets = np.asarray(offsets, dtype=np.int64)
    f.types = np.asarray(types, dtype=np.uint8)
    if faces:
        f.faces = np.asarray(faces, dtype=np.int64)
        f.faceoffsets = np.asarray(faceoffsets, dtype=np.int64)
    return f


def _sorted_cell_nodes_2d(g: Grid) -> list[np.ndarray]:
    """Counter-clockwise node loop per 2d cell, walking the face chain."""
    cf = g.cell_faces.tocsc()
    fn = g.face_nodes.tocsc()
    out = []
    for c in range(g.num_cells):
        loc_f = cf.indices[cf.indptr[c] : cf.indptr[c + 1]]
        edges = {}
        for fc in loc_f:
            n0, n1 = fn.indices[fn.indptr[fc] : fn.indptr[fc + 1]][:2]
            edges.setdefault(n0, []).append(n1)
            edges.setdefault(n1, []).append(n0)
        start = next(iter(edges))
        loop = [start]
        prev = None
        cur = start
        for _ in range(len(loc_f) - 1):
            nxt = [n for n in edges[cur] if n != prev]
            prev, cur = cur, nxt[0]
            loop.append(cur)
        nodes = np.asarray(loop, dtype=np.int64)
        # Orient counter-clockwise in the cell plane.
        xy = g.nodes[:2, nodes]
        area2 = np.sum(
            xy[0] * np.roll(xy[1], -1) - np.roll(xy[0], -1) * xy[1]
        )
        if area2 < 0:
            nodes = nodes[::-1]
        out.append(nodes)
    return out


class Exporter:
    """Write (mixed-dimensional) grids with cell data to vtu/pvd files.

    Reference ``viz/exporter.py:47``. Data may be specified as:

    - ``"key"``: fetch the iterate solution named ``key`` from every grid
      that stores it,
    - ``(grids, "key")``: restrict to the given subdomains/interfaces,
    - ``(grid, "key", values)`` or ``("key", values)``: explicit values.
    """

    def __init__(
        self,
        grid: Union[Grid, MixedDimensionalGrid],
        file_name: str,
        folder_name: Optional[str] = None,
        **kwargs,
    ) -> None:
        if isinstance(grid, Grid):
            mdg = MixedDimensionalGrid()
            mdg.add_subdomains(grid)
            self.mdg = mdg
        elif isinstance(grid, MixedDimensionalGrid):
            self.mdg = grid
        else:
            raise TypeError("Exporter needs a Grid or MixedDimensionalGrid")
        self.file_name = file_name
        self.folder_name = folder_name or "."
        self.fixed_grid: bool = kwargs.pop("fixed_grid", True)
        self.binary: bool = kwargs.pop("binary", True)
        kwargs.pop("export_constants_separately", None)
        kwargs.pop("length_scale", None)
        if kwargs:
            raise TypeError(f"Exporter() got unexpected kwargs {list(kwargs)}")
        os.makedirs(self.folder_name, exist_ok=True)
        self._exported_steps: list[tuple[Optional[float], int]] = []

    # -- writing ----------------------------------------------------------

    def write_vtu(
        self,
        data=None,
        time_dependent: bool = False,
        time_step: Optional[int] = None,
        grid: Optional[MixedDimensionalGrid] = None,
    ) -> None:
        if grid is not None:
            if self.fixed_grid:
                raise ValueError("Cannot replace grid with fixed_grid=True")
            self.mdg = grid
        if time_step is None:
            time_step = len(self._exported_steps) if time_dependent else 0
        fields = self._resolve_data(data)
        dims = sorted({sd.dim for sd in self.mdg.subdomains()})
        pvd_entries = []
        for dim in dims:
            grids = self.mdg.subdomains(dim=dim)
            piece = _grid_piece(grids, self.binary)
            self._append_constant_data(piece, grids, is_mortar=False)
            for name, per_grid in fields.items():
                vals = [per_grid[g] for g in grids if g in per_grid]
                if len(vals) != len(grids):
                    continue
                arr = np.concatenate([np.atleast_1d(v) for v in vals])
                num_cells = sum(g.num_cells for g in grids)
                if arr.size == num_cells:
                    piece.cell_data[name] = arr
                elif arr.size % num_cells == 0:
                    piece.cell_data[name] = arr.reshape(num_cells, -1)
            fname = self._vtu_name(dim, time_step)
            piece.serialize(os.path.join(self.folder_name, fname))
            pvd_entries.append(fname)
        # Mortar grids, per dimension.
        intf_dims = sorted({intf.dim for intf in self.mdg.interfaces()})
        for dim in intf_dims:
            intfs = [i for i in self.mdg.interfaces() if i.dim == dim]
            side_grids = []
            for intf in intfs:
                side_grids.extend(intf.side_grids.values())
            piece = _grid_piece(side_grids, self.binary)
            self._append_constant_data(piece, intfs, is_mortar=True)
            for name, per_grid in fields.items():
                vals = [per_grid[i] for i in intfs if i in per_grid]
                if len(vals) != len(intfs):
                    continue
                arr = np.concatenate([np.atleast_1d(v) for v in vals])
                num_cells = sum(i.num_cells for i in intfs)
                if arr.size == num_cells:
                    piece.cell_data[name] = arr
                elif arr.size % num_cells == 0:
                    piece.cell_data[name] = arr.reshape(num_cells, -1)
            fname = self._vtu_name(dim, time_step, mortar=True)
            piece.serialize(os.path.join(self.folder_name, fname))
            pvd_entries.append(fname)
        self._write_step_pvd(pvd_entries, time_step)
        self._exported_steps.append((None, time_step))

    def write_pvd(
        self,
        times: Optional[np.ndarray] = None,
        file_extension: Optional[Iterable[int]] = None,
    ) -> None:
        """Global pvd across exported steps."""
        steps = [s for _, s in self._exported_steps]
        if file_extension is not None:
            steps = list(file_extension)
        if times is None:
            times = np.arange(len(steps), dtype=float)
        root = ET.Element(
            "VTKFile", type="Collection", version="0.1", byte_order="LittleEndian"
        )
        coll = ET.SubElement(root, "Collection")
        for t, step in zip(np.atleast_1d(times), steps):
            ET.SubElement(
                coll,
                "DataSet",
                group="",
                part="0",
                timestep=str(float(t)),
                file=f"{os.path.basename(self.file_name)}_{step:06d}.pvd",
            )
        tree = ET.ElementTree(root)
        ET.indent(tree)
        tree.write(
            os.path.join(self.folder_name, f"{os.path.basename(self.file_name)}.pvd"),
            xml_declaration=True,
            encoding="utf-8",
        )

    # -- restart ----------------------------------------------------------

    def import_state_from_vtu(
        self, vtu_files: Union[str, list[str]], keys=None, **kwargs
    ) -> None:
        """Read cell data from previously written vtu files back into the
        iterate/time-step solution storage of the mdg (reference
        ``exporter.py:309``)."""
        from porepy_tpu_torch.utils.solution_storage import set_solution_values

        if isinstance(vtu_files, str):
            vtu_files = [vtu_files]
        for path in vtu_files:
            tree = ET.parse(path)
            cd = tree.getroot().find(".//CellData")
            if cd is None:
                continue
            arrays = {}
            for da in cd.findall("DataArray"):
                arrays[da.get("Name")] = _read_data_array(da)
            dims = arrays.get("grid_dim")
            if dims is None:
                continue
            is_mortar = arrays.get("is_mortar")
            if is_mortar is not None and is_mortar.size and is_mortar[0]:
                self._import_mortar_arrays(arrays, dims)
                continue
            sd_ids = arrays.get("subdomain_id")
            for name, arr in arrays.items():
                if name in (
                    "grid_dim",
                    "cell_id",
                    "subdomain_id",
                    "interface_id",
                    "is_mortar",
                    "mortar_side",
                ):
                    continue
                if keys is not None and name not in keys:
                    continue
                n_comp = arr.size // dims.size if dims.size else 1
                offset = 0
                # Grid ids are process-global counters and differ between
                # the exporting and the importing run; map id-blocks to the
                # importer's subdomains positionally (the export order is
                # the deterministic mdg iteration order).
                if sd_ids is not None:
                    _, first_pos, counts = np.unique(
                        sd_ids, return_index=True, return_counts=True
                    )
                    order = np.argsort(first_pos)
                    block_counts = counts[order]
                else:
                    block_counts = None
                for k, sd in enumerate(self.mdg.subdomains(dim=int(dims[0]))):
                    if block_counts is not None and k < block_counts.size:
                        num = int(block_counts[k])
                    else:
                        num = sd.num_cells
                    vals = arr.reshape(-1, n_comp)[offset : offset + num]
                    offset += num
                    if vals.size == 0:
                        continue
                    data = self.mdg.subdomain_data(sd)
                    store = vals[:, : 1 if n_comp == 1 else n_comp]
                    flat = (
                        vals.ravel() if n_comp == 1 else vals[:, :n_comp].ravel()
                    )
                    set_solution_values(
                        name, flat, data, time_step_index=0, iterate_index=0
                    )

    def _import_mortar_arrays(self, arrays: dict, dims: np.ndarray) -> None:
        """Restore interface (mortar) cell fields; id-blocks map to the
        importer's interfaces positionally, like subdomains."""
        from porepy_tpu_torch.utils.solution_storage import set_solution_values

        intf_ids = arrays.get("interface_id")
        intfs = [
            intf
            for intf in self.mdg.interfaces()
            if intf.dim == int(dims[0])
        ]
        if intf_ids is not None:
            _, first_pos, counts = np.unique(
                intf_ids, return_index=True, return_counts=True
            )
            block_counts = counts[np.argsort(first_pos)]
        else:
            block_counts = None
        skip = {
            "grid_dim",
            "cell_id",
            "subdomain_id",
            "interface_id",
            "is_mortar",
            "mortar_side",
        }
        for name, arr in arrays.items():
            if name in skip:
                continue
            n_comp = arr.size // dims.size if dims.size else 1
            offset = 0
            for k, intf in enumerate(intfs):
                if block_counts is not None and k < block_counts.size:
                    num = int(block_counts[k])
                else:
                    num = intf.num_cells
                vals = arr.reshape(-1, n_comp)[offset : offset + num]
                offset += num
                if vals.size == 0:
                    continue
                set_solution_values(
                    name,
                    vals.ravel(),
                    self.mdg.interface_data(intf),
                    time_step_index=0,
                    iterate_index=0,
                )

    # -- internals ---------------------------------------------------------

    def _vtu_name(self, dim: int, step: int, mortar: bool = False) -> str:
        base = os.path.basename(self.file_name)
        kind = "_mortar_" if mortar else "_"
        return f"{base}{kind}{dim}_{step:06d}.vtu"

    def _write_step_pvd(self, entries: list[str], step: int) -> None:
        root = ET.Element(
            "VTKFile", type="Collection", version="0.1", byte_order="LittleEndian"
        )
        coll = ET.SubElement(root, "Collection")
        for fname in entries:
            ET.SubElement(
                coll, "DataSet", group="", part="0", timestep="0", file=fname
            )
        tree = ET.ElementTree(root)
        ET.indent(tree)
        base = os.path.basename(self.file_name)
        tree.write(
            os.path.join(self.folder_name, f"{base}_{step:06d}.pvd"),
            xml_declaration=True,
            encoding="utf-8",
        )

    def _append_constant_data(
        self, piece: _VtuFile, grids: list, is_mortar: bool
    ) -> None:
        dims = np.concatenate(
            [np.full(g.num_cells, g.dim, dtype=np.int64) for g in grids]
        ) if grids else np.zeros(0, np.int64)
        piece.cell_data["grid_dim"] = dims
        piece.cell_data["cell_id"] = np.concatenate(
            [np.arange(g.num_cells, dtype=np.int64) for g in grids]
        ) if grids else np.zeros(0, np.int64)
        ids = np.concatenate(
            [
                np.full(g.num_cells, getattr(g, "id", i), dtype=np.int64)
                for i, g in enumerate(grids)
            ]
        ) if grids else np.zeros(0, np.int64)
        if is_mortar:
            piece.cell_data["interface_id"] = ids
            piece.cell_data["is_mortar"] = np.ones_like(dims)
            sides = []
            for g in grids:
                for side, sg in g.side_grids.items():
                    sides.append(
                        np.full(sg.num_cells, int(side.value), dtype=np.int64)
                    )
            piece.cell_data["mortar_side"] = (
                np.concatenate(sides) if sides else np.zeros(0, np.int64)
            )
        else:
            piece.cell_data["subdomain_id"] = ids
            piece.cell_data["is_mortar"] = np.zeros_like(dims)

    def _resolve_data(self, data) -> dict[str, dict]:
        """Normalize user data spec to {field name: {grid: values}}."""
        from porepy_tpu_torch.utils.common_constants import ITERATE_SOLUTIONS

        out: dict[str, dict] = {}

        def fetch(name, grids):
            per = out.setdefault(name, {})
            for g in grids:
                if isinstance(g, MortarGrid):
                    d = self.mdg.interface_data(g)
                else:
                    d = self.mdg.subdomain_data(g)
                sols = d.get(ITERATE_SOLUTIONS, {})
                if name in sols and 0 in sols[name]:
                    per[g] = np.asarray(sols[name][0])

        if data is None:
            return out
        for item in data:
            if isinstance(item, str):
                fetch(item, list(self.mdg.subdomains()) + list(self.mdg.interfaces()))
            elif isinstance(item, tuple) and len(item) == 2:
                first, second = item
                if isinstance(first, str):
                    # ("key", values) on the unique subdomain of max dim.
                    sd = self.mdg.subdomains(dim=self.mdg.dim_max())[0]
                    out.setdefault(first, {})[sd] = np.asarray(second)
                else:
                    grids = list(first) if isinstance(first, (list, tuple)) else [first]
                    fetch(second, grids)
            elif isinstance(item, tuple) and len(item) == 3:
                g, name, vals = item
                out.setdefault(name, {})[g] = np.asarray(vals)
            else:
                raise ValueError(f"Cannot interpret data spec {item!r}")
        return out


def _read_data_array(da: ET.Element) -> np.ndarray:
    dtype = {v: k for k, v in _VTU_TYPE.items()}[da.get("type")]
    if da.get("format") == "binary":
        raw = base64.b64decode(da.text.strip())
        (nbytes,) = struct.unpack("<I", raw[:4])
        return np.frombuffer(raw[4 : 4 + nbytes], dtype=dtype)
    if not da.text or not da.text.strip():
        return np.zeros(0)
    return np.array(da.text.split(), dtype=dtype)
