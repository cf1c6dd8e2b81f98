"""Differentiable-permeability constitutive fluxes (``DarcysLawAd`` /
``FouriersLawAd``).

Counterpart of the reference's ``AdTpfaFlux``/``DarcysLawAd``
(``models/constitutive_laws.py:1151,1803``): when the permeability (or
thermal conductivity) depends on the solution — cubic-law apertures driven
by displacement jumps, pressure-dependent permeability, total-mobility
tensors — the flux Jacobian must include the tensor's derivatives.

The reference re-discretizes a dedicated ``DifferentiableTpfa`` and splices
matrix products into its AdArray machinery. Here the TPFA transmissibility
computation is *already* a pure torch function of the permeability
(``numerics/fv/tpfa.py``), so the flux becomes one ``evaluate`` node whose
children are the permeability operator, the specific volume, the pressure,
and the boundary/mortar operands — the harmonic averaging sits inside the
residual and forward-mode differentiation goes through it exactly. No
rediscretization, no lagging.

On a CUDA tensor the node runs the K14 kernels ``tpfa_ad_flux`` and
``tpfa_ad_trace`` (``kernels/csrc/tpfa_ad.cu``: the value and all colored
tangents in one launch per subdomain). The assembly's forward-mode pass
calls them directly through the node's dual rule, by
``kernels.tpfa_ad_dual`` (on a CPU tensor their plain versions in
``kernels/reference.py``); the traced function that
``torch.func`` differentiates reaches them through autograd Functions, and
on a CPU tensor runs the plain functions of ``numerics/fv/tpfa.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sps
import torch

from porepy_tpu_torch import kernels
from porepy_tpu_torch.kernels import functions as kfn
from porepy_tpu_torch.kernels import ops
from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.ad import forward

__all__ = ["AdTpfaFlux", "DarcysLawAd", "FouriersLawAd"]


class _DiffTpfaGeometry:
    """Static per-subdomain-list arrays for the in-residual TPFA. Meshes
    and masks are host (CPU) tensors; :meth:`kernel_geometry` gives the K14
    kernels' arrays on a device, made once per device."""

    def __init__(self, subdomains, bc_of) -> None:
        from porepy_tpu_torch.numerics.fv.fv_mesh import BoundaryMasks, FvMesh

        self.meshes = []
        self.masks = []
        self.cell_offsets = [0]
        self.face_offsets = [0]
        for sd in subdomains:
            self.meshes.append(FvMesh.from_grid(sd))
            self.masks.append(BoundaryMasks.from_bc(bc_of(sd)))
            self.cell_offsets.append(self.cell_offsets[-1] + sd.num_cells)
            self.face_offsets.append(self.face_offsets[-1] + sd.num_faces)
        self.num_cells = self.cell_offsets[-1]
        self.num_faces = self.face_offsets[-1]
        self._on: dict = {}
        # Structural face-from-cell adjacency for the sparsity pattern.
        rows, cols = [], []
        for mesh, co, fo in zip(
            self.meshes, self.cell_offsets[:-1], self.face_offsets[:-1]
        ):
            rows.append(mesh.fi.numpy() + fo)
            cols.append(mesh.ci.numpy() + co)
        if rows:
            r = np.concatenate(rows)
            c = np.concatenate(cols)
        else:
            r = c = np.zeros(0, dtype=int)
        adj = sps.coo_matrix(
            (np.ones(r.size, dtype=bool), (r, c)),
            shape=(self.num_faces, self.num_cells),
        ).tocsr()
        # Two-cell stencil: faces see both adjacent cells' permeability and
        # pressure columns.
        self.face_cell_pattern = adj

    def kernel_geometry(self, device) -> list:
        """One :class:`~porepy_tpu_torch.kernels.TpfaAdGeometry` per
        subdomain on ``device``."""
        dev = torch.device(device)
        geoms = self._on.get(dev)
        if geoms is None:
            geoms = self._on[dev] = [
                kernels.TpfaAdGeometry(
                    face_ptr=mesh.face_ptr.to(dev),
                    face_hf=mesh.face_hf.to(dev),
                    ci=mesh.ci.to(dev, torch.int32),
                    sgn=mesh.sgn.to(dev),
                    nrm=(mesh.face_normals[:, mesh.fi] * mesh.sgn).to(dev),
                    dvec=mesh.fc_cc().to(dev),
                    is_dir=bnd.is_dir.to(dev),
                    is_neu=bnd.is_neu.to(dev),
                    is_dir_raw=bnd.is_dir_raw.to(dev),
                    is_neu_raw=bnd.is_neu_raw.to(dev),
                )
                for mesh, bnd in zip(self.meshes, self.masks)
            ]
        return geoms

    def _per_subdomain(self, plain, kernel, trace: bool):
        """``(k9, vol, p, bco, lam) -> face field``: ``kernel`` per subdomain
        for CUDA tensors, ``plain`` (on the host meshes) for CPU tensors. The
        function's ``dual_rule`` calls :func:`~porepy_tpu_torch.kernels.tpfa_ad_dual`
        of the pressure trace (``trace``) or of the flux once per subdomain."""
        geos = list(zip(self.meshes, self.masks))
        co, fo = self.cell_offsets, self.face_offsets

        def fn(k9, vol, p, bco, lam):
            on_card = p.is_cuda
            kgeos = self.kernel_geometry(p.device) if on_card else None
            out = []
            for i, (mesh, bnd) in enumerate(geos):
                k9_i = k9[9 * co[i] : 9 * co[i + 1]]
                vol_i = vol[co[i] : co[i + 1]]
                p_i = p[co[i] : co[i + 1]]
                bco_i = bco[fo[i] : fo[i + 1]]
                lam_i = lam[fo[i] : fo[i + 1]]
                if on_card:
                    out.append(kernel(kgeos[i], k9_i, vol_i, p_i, bco_i, lam_i))
                    continue
                nc = co[i + 1] - co[i]
                kv = (k9_i.reshape(nc, 3, 3) * vol_i[:, None, None]).permute(1, 2, 0)
                out.append(plain(mesh, bnd, kv, p_i, bco_i + lam_i))
            if not out:
                return torch.zeros(0, dtype=p.dtype, device=p.device)
            return torch.cat(out)

        gather = ops.DualGatherCopy()

        def dual_rule(run, k9, vol, p, bco, lam):
            """The same face field on duals: value and the tangent rows of
            all seeds in one K14 launch per subdomain (the geometry's
            launcher), concatenated by the rule's own launcher."""
            geoms = self.kernel_geometry(p.val.device)
            duals = (k9, vol, p, bco, lam)
            out = []
            for i, geom in enumerate(geoms):
                spans = (
                    (9 * co[i], 9 * co[i + 1]), (co[i], co[i + 1]), (co[i], co[i + 1]),
                    (fo[i], fo[i + 1]), (fo[i], fo[i + 1]),
                )
                primals = [d.val[lo:hi] for d, (lo, hi) in zip(duals, spans)]
                seeds = [
                    None if d.tan is None else d.tan[:, lo:hi]
                    for d, (lo, hi) in zip(duals, spans)
                ]
                out.append(forward.Dual(*ops.tpfa_ad_dual(geom, primals, seeds, trace)))
            return forward.concat(run, out, gather)

        fn.dual_rule = dual_rule
        return fn

    def flux_fn(self):
        """Function ``(k9, vol, p, bco, lam_faces) -> face fluxes``.

        ``k9``: 9-per-cell tensor entries (cell-major); ``vol``: specific
        volumes scaling the tensor (aperture weighting); ``bco``: combined
        boundary operand (Dirichlet: boundary pressure; Neumann: prescribed
        flux); ``lam_faces``: mortar fluxes projected to faces.
        """
        from porepy_tpu_torch.numerics.fv.tpfa import (
            apply_flux,
            boundary_flux_coefficients,
            effective_transmissibilities,
        )

        def plain(mesh, bnd, kv, p, b):
            t, _ = effective_transmissibilities(mesh, kv, bnd)
            coeff = boundary_flux_coefficients(mesh, t, bnd)
            return apply_flux(mesh, t, p, coeff, b)

        return self._per_subdomain(plain, kfn.tpfa_ad_flux, trace=False)

    def trace_fn(self):
        """Function reconstructing the pressure trace on boundary faces:
        Dirichlet faces take the boundary value; Neumann faces take
        ``p_cell - flux / t_full``."""
        from porepy_tpu_torch.numerics.fv.tpfa import face_transmissibilities

        def plain(mesh, bnd, kv, p, b):
            t_full = face_transmissibilities(mesh, kv)
            # Owner-cell pressure on each (boundary) face: that of the
            # face's last half-face.
            last = mesh.face_hf[(mesh.face_ptr[1:] - 1).long()].long()
            p_face = p[mesh.ci[last]]
            neu = bnd.is_neu_raw
            safe = torch.where(neu, t_full, torch.ones_like(t_full))
            return torch.where(
                bnd.is_dir_raw,
                b,
                torch.where(neu, p_face - b / safe, torch.zeros_like(t_full)),
            )

        return self._per_subdomain(plain, kfn.tpfa_ad_trace, trace=True)


class AdTpfaFlux:
    """Differentiable two-point flux machinery shared by Darcy and Fourier
    variants; mix in *above* the stored-matrix law so the overrides win."""

    def _diff_tpfa_geometry(self, subdomains, bc_of, cache_key: str):
        cache = getattr(self, "_adtpfa_cache", None)
        if cache is None:
            cache = self._adtpfa_cache = {}
        key = (cache_key, tuple(sd.id for sd in subdomains))
        if key not in cache:
            cache[key] = _DiffTpfaGeometry(subdomains, bc_of)
            # The kernels' arrays go to the card now, outside any transform
            # of the residual.
            device = torch.device(self.equation_system.device)
            if device.type == "cuda":
                cache[key].kernel_geometry(device)
        return cache[key]

    def _diff_flux(
        self,
        subdomains: Sequence,
        geometry: _DiffTpfaGeometry,
        tensor_op: ad.Operator,
        potential_op: ad.Operator,
        boundary_op: ad.Operator,
        interface_flux,
        name: str,
    ) -> ad.Operator:
        lam = self._mortar_face_operand(subdomains, interface_flux)
        pat = geometry.face_cell_pattern

        def pattern_fn(child_patterns, ndof):
            import scipy.sparse as spsp

            from porepy_tpu_torch.numerics.ad.compiler import _union

            k_pat, vol_pat, p_pat, bco_pat, lam_pat = child_patterns
            # Collapse the 9-per-cell tensor pattern to cells.
            ncell = geometry.num_cells
            collapse = spsp.csr_matrix(
                (
                    np.ones(9 * ncell, dtype=bool),
                    (np.repeat(np.arange(ncell), 9), np.arange(9 * ncell)),
                ),
                shape=(ncell, 9 * ncell),
            )
            cell_pat = (collapse @ k_pat).astype(bool)
            cell_pat = _union(cell_pat, vol_pat)
            cell_pat = _union(cell_pat, p_pat)
            out = (pat @ cell_pat).astype(bool).tocsr()
            return _union(_union(out, bco_pat), lam_pat)

        fn = ad.Function(geometry.flux_fn(), name=name, pattern_fn=pattern_fn)
        flux = fn(
            tensor_op,
            self.specific_volume(list(subdomains)),
            potential_op,
            boundary_op,
            lam,
        )
        flux.set_name(name)
        return flux

    def _diff_trace(
        self,
        subdomains: Sequence,
        geometry: _DiffTpfaGeometry,
        tensor_op: ad.Operator,
        potential_op: ad.Operator,
        boundary_op: ad.Operator,
        interface_flux,
        name: str,
    ) -> ad.Operator:
        lam = self._mortar_face_operand(subdomains, interface_flux)
        pat = geometry.face_cell_pattern

        def pattern_fn(child_patterns, ndof):
            import scipy.sparse as spsp

            from porepy_tpu_torch.numerics.ad.compiler import _union

            k_pat, vol_pat, p_pat, bco_pat, lam_pat = child_patterns
            ncell = geometry.num_cells
            collapse = spsp.csr_matrix(
                (
                    np.ones(9 * ncell, dtype=bool),
                    (np.repeat(np.arange(ncell), 9), np.arange(9 * ncell)),
                ),
                shape=(ncell, 9 * ncell),
            )
            cell_pat = (collapse @ k_pat).astype(bool)
            cell_pat = _union(cell_pat, vol_pat)
            cell_pat = _union(cell_pat, p_pat)
            out = (pat @ cell_pat).astype(bool).tocsr()
            return _union(_union(out, bco_pat), lam_pat)

        fn = ad.Function(geometry.trace_fn(), name=name, pattern_fn=pattern_fn)
        trace = fn(
            tensor_op,
            self.specific_volume(list(subdomains)),
            potential_op,
            boundary_op,
            lam,
        )
        trace.set_name(name)
        return trace

    def _mortar_face_operand(self, subdomains, interface_flux) -> ad.Operator:
        """Mortar fluxes projected onto primary faces (zero without
        interfaces)."""
        interfaces = self.subdomains_to_interfaces(list(subdomains), [1])
        if interfaces and interface_flux is not None:
            projection = ad.MortarProjections(
                self.mdg, list(subdomains), interfaces, dim=1
            )
            return projection.mortar_to_primary_int() @ interface_flux(
                interfaces
            )
        num_faces = int(sum(sd.num_faces for sd in subdomains))
        return ad.DenseArray(np.zeros(num_faces), name="zero_mortar_fluxes")


class DarcysLawAd(AdTpfaFlux):
    """Darcy flux with the permeability operator differentiated in-kernel
    (reference ``constitutive_laws.py:1803`` DarcysLawAd)."""

    def darcy_flux(self, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if len(domains) == 0 or all(isinstance(d, BoundaryGrid) for d in domains):
            return super().darcy_flux(domains)
        subdomains = [sd for sd in domains if sd.dim > 0]
        zero_d = [sd for sd in domains if sd.dim == 0]
        if zero_d:
            raise NotImplementedError(
                "Differentiable TPFA expects positive-dimensional subdomains"
            )
        geometry = self._diff_tpfa_geometry(
            subdomains, self.bc_type_darcy_flux, "darcy"
        )
        return self._diff_flux(
            subdomains,
            geometry,
            self.permeability(subdomains),
            self.pressure(subdomains),
            self.combine_boundary_operators_darcy_flux(subdomains),
            self.interface_darcy_flux,
            "differentiable_darcy_flux",
        )

    def pressure_trace(self, subdomains: Sequence) -> ad.Operator:
        geometry = self._diff_tpfa_geometry(
            list(subdomains), self.bc_type_darcy_flux, "darcy"
        )
        return self._diff_trace(
            list(subdomains),
            geometry,
            self.permeability(list(subdomains)),
            self.pressure(list(subdomains)),
            self.combine_boundary_operators_darcy_flux(list(subdomains)),
            self.interface_darcy_flux,
            "differentiable_pressure_trace",
        )


class FouriersLawAd(AdTpfaFlux):
    """Fourier flux with a differentiable thermal conductivity tensor
    (reference ``constitutive_laws.py`` FouriersLawAd)."""

    def fourier_flux(self, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if len(domains) == 0 or all(isinstance(d, BoundaryGrid) for d in domains):
            return super().fourier_flux(domains)
        subdomains = list(domains)
        geometry = self._diff_tpfa_geometry(
            subdomains, self.bc_type_fourier_flux, "fourier"
        )
        return self._diff_flux(
            subdomains,
            geometry,
            self.thermal_conductivity(subdomains),
            self.temperature(subdomains),
            self.combine_boundary_operators_fourier_flux(subdomains),
            self.interface_fourier_flux,
            "differentiable_fourier_flux",
        )
