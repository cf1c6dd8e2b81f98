"""Block-wise diagnostics of the assembled Jacobian.

Parity counterpart of reference ``viz/diagnostics_mixin.py:45``: split the
Jacobian into (equation x variable) blocks, compute per-block absolute
maxima and condition-number estimates, optionally rendered as a heatmap.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sps

__all__ = ["DiagnosticsMixin"]


class DiagnosticsMixin:
    def run_diagnostics(
        self,
        grouping=None,
        default_handlers: Sequence[str] = ("max",),
        additional_handlers: Optional[dict] = None,
    ) -> dict:
        """Compute per-block diagnostics of the assembled Jacobian; returns
        {(equation name, variable name): {handler: value}}."""
        if not hasattr(self, "linear_system"):
            self.assemble_linear_system()
        mat, _ = self.linear_system
        mat = sps.csr_matrix(mat)
        eq_rows = self._equation_row_ranges()
        var_cols = self._variable_col_ranges()

        handlers = {}
        if "max" in default_handlers:
            handlers["max"] = lambda block: (
                float(np.abs(block.data).max()) if block.nnz else 0.0
            )
        if "cond" in default_handlers:
            handlers["cond"] = self._condition_number
        handlers.update(additional_handlers or {})

        data: dict = {}
        for eq_name, (r0, r1) in eq_rows.items():
            for var_name, cols in var_cols.items():
                block = mat[r0:r1][:, cols]
                entry = {
                    name: fn(block) for name, fn in handlers.items()
                }
                entry["block_size"] = block.shape
                data[(eq_name, var_name)] = entry
        self.diagnostics_data = data
        return data

    @staticmethod
    def _condition_number(block: sps.spmatrix) -> float:
        if block.nnz == 0:
            return 0.0
        dense = np.asarray(block.todense())
        s = np.linalg.svd(dense, compute_uv=False)
        s = s[s > 1e-300]
        return float(s.max() / s.min()) if s.size else 0.0

    def _equation_row_ranges(self) -> dict:
        out = {}
        offset = 0
        es = self.equation_system
        for name in es.equations:
            compiled = es._compiled.get(name)
            if compiled is not None:
                n = compiled.pattern.shape[0]
            else:
                n = es.evaluate(es.equations[name]).shape[0]
            out[name] = (offset, offset + n)
            offset += n
        return out

    def _variable_col_ranges(self) -> dict:
        out: dict = {}
        es = self.equation_system
        for v in es.variables:
            start, n = es._dof_offsets[(v.name, id(v.domain))]
            out.setdefault(v.name, []).extend(range(start, start + n))
        return {k: np.asarray(cols) for k, cols in out.items()}

    def plot_diagnostics(self, data: Optional[dict] = None, key: str = "max"):
        """Heatmap of one diagnostic over the (equation, variable) grid."""
        import matplotlib.pyplot as plt

        if data is None:
            data = getattr(self, "diagnostics_data", None) or self.run_diagnostics()
        eq_names = sorted({k[0] for k in data})
        var_names = sorted({k[1] for k in data})
        table = np.zeros((len(eq_names), len(var_names)))
        for (e, v), entry in data.items():
            table[eq_names.index(e), var_names.index(v)] = entry.get(key, 0.0)
        fig, ax = plt.subplots()
        im = ax.imshow(np.log10(np.maximum(table, 1e-300)))
        ax.set_xticks(range(len(var_names)), var_names, rotation=45)
        ax.set_yticks(range(len(eq_names)), eq_names)
        fig.colorbar(im, ax=ax, label=f"log10({key})")
        return fig
