"""Data-saving mixin (reference ``viz/data_saving_model_mixin.py:21``).

Collects per-timestep data through ``data_to_export``; vtu export arrives
with the exporter layer — until then results accumulate in memory and the
hooks keep the reference lifecycle contract.
"""

from __future__ import annotations

from typing import Any

__all__ = ["DataSavingMixin"]


class DataSavingMixin:
    def initialize_data_saving(self) -> None:
        self.suppress_export: bool = self.params.get("suppress_export", False)
        self.exporter = None
        self.results: list = []
        if not self.suppress_export and self.params.get("write_vtu", True):
            from porepy_tpu_torch.viz.exporter import Exporter

            self.exporter = Exporter(
                self.mdg,
                file_name=self.params.get("file_name", "data"),
                folder_name=self.params.get("folder_name", "visualization"),
            )

    def save_data_time_step(self) -> None:
        collected = self.collect_data()
        if collected is not None:
            self.results.append(collected)
        if self.suppress_export or self.exporter is None:
            return
        self.write_vtu()

    def collect_data(self) -> Any:
        return None

    def data_to_export(self) -> list:
        out = []
        for var in self.equation_system.variables:
            vals = self.equation_system.get_variable_values(
                [var], time_step_index=0
            )
            out.append((var.domain, var.name, vals))
        return out

    def write_vtu(self) -> None:
        assert self.exporter is not None
        self.exporter.write_vtu(
            self.data_to_export(), time_dependent=self._is_time_dependent(),
            time_step=self.time_manager.time_index,
        )

    def load_data_from_vtu(self, vtu_files, **kwargs) -> None:
        """Restart: read states from previously exported vtu files."""
        assert self.exporter is not None
        self.exporter.import_state_from_vtu(vtu_files, **kwargs)

    def load_data_from_pvd(self, pvd_file, **kwargs) -> None:
        """Restart from a step pvd file: loads every vtu it indexes."""
        import os
        import xml.etree.ElementTree as ET

        assert self.exporter is not None
        tree = ET.parse(pvd_file)
        folder = os.path.dirname(pvd_file)
        files = [
            os.path.join(folder, ds.get("file"))
            for ds in tree.getroot().iter("DataSet")
        ]
        self.exporter.import_state_from_vtu(
            [f for f in files if f.endswith(".vtu")], **kwargs
        )
