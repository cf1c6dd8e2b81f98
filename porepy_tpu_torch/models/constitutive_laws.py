"""Constitutive-law mixin library.

Parity counterpart of (a growing subset of) reference
``models/constitutive_laws.py`` (4,839 LoC). Implemented so far: dimension
reduction (aperture/specific volume), constant permeability + tensor
utilities, Darcy's law on the TPFA/MPFA matrix contract, zero/constant
gravity, advective flux with in-residual upwinding (no per-iteration
rediscretization — direction switching happens inside the traced residual,
see ``porepy_tpu_torch/numerics/fv/upwind.py``), fluid density/viscosity/mobility
laws, porosity laws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from porepy_tpu_torch.numerics import ad
from porepy_tpu_torch.numerics.ad import forward
from porepy_tpu_torch.numerics.ad.discretizations import TpfaAd, UpwindAd
from porepy_tpu_torch.numerics.fv.upwind import (
    UpwindGeometry,
    upwind_apply,
    upwind_apply_dual,
    upwind_flux,
    upwind_flux_dual,
    upwind_interface_dual,
    upwind_select_pair,
    upwind_select_pair_dual,
)
from porepy_tpu_torch.params.tensor import SecondOrderTensor

__all__ = [
    "DimensionReduction",
    "DisplacementJumpAperture",
    "ConstantPermeability",
    "SecondOrderTensorUtils",
    "DarcysLaw",
    "FouriersLaw",
    "ElasticModuli",
    "LinearElasticMechanicalStress",
    "ZeroGravityForce",
    "GravityForce",
    "AdvectiveFlux",
    "ConstantFluidThermalConductivity",
    "ThermalConductivityLTE",
    "FluidEnthalpyFromTemperature",
    "EnthalpyFromTemperature",
    "ConstantSolidDensity",
    "FluidDensityFromPressure",
    "FluidDensityFromTemperature",
    "FluidDensityFromPressureAndTemperature",
    "ConstantViscosity",
    "FluidMobility",
    "ConstantPorosity",
]


class DimensionReduction:
    """Apertures and specific volumes (reference
    ``constitutive_laws.py:131-285``)."""

    def grid_aperture(self, sd) -> np.ndarray:
        """Cell-wise aperture of a single grid: 1 in the top dimension,
        residual aperture below."""
        aperture = np.ones(sd.num_cells)
        if sd.dim < self.nd:
            aperture *= self.solid.residual_aperture
        return aperture

    def aperture(self, subdomains: Sequence) -> ad.Operator:
        ops = [
            ad.DenseArray(self.grid_aperture(sd), name=f"aperture_{sd.id}")
            for sd in subdomains
        ]
        if not ops:
            return ad.DenseArray(np.zeros(0), name="aperture")
        out = ad.concat(ops, name="aperture")
        return out

    def specific_volume(self, grids: Sequence) -> ad.Operator:
        """Aperture^(nd - dim) per subdomain; for interfaces, inherited
        from the higher-dimensional neighbor via the primary projection
        (reference ``constitutive_laws.py:203-250``)."""
        from porepy_tpu_torch.grids.mortar_grid import MortarGrid

        if not grids:
            return ad.DenseArray(np.zeros(0), name="specific_volume")
        if isinstance(grids[0], MortarGrid):
            interfaces = list(grids)
            neighbors = self.interfaces_to_subdomains(interfaces)
            projection = ad.MortarProjections(self.mdg, neighbors, interfaces, dim=1)
            codim = interfaces[0].codim
            if codim == 1:
                trace = ad.Trace(neighbors)
                sv_neighbors = trace @ self.specific_volume(neighbors)
            else:
                sv_neighbors = self.specific_volume(neighbors)
            out = projection.primary_to_mortar_avg() @ sv_neighbors
            out.set_name("specific_volume")
            return out
        if all(getattr(g, "dim", self.nd) == self.nd for g in grids):
            return ad.DenseArray(
                np.ones(sum(g.num_cells for g in grids)), name="specific_volume"
            )
        parts = []
        for g in grids:
            a = self.aperture([g])
            parts.append(a ** float(self.nd - g.dim))
        return ad.concat(parts, name="specific_volume")


class DisplacementJumpAperture(DimensionReduction):
    """Fracture aperture from the normal displacement jump (reference
    ``constitutive_laws.py:285``): matrix aperture is one, fracture aperture
    is ``max(normal_jump + residual, residual)``, intersection aperture is
    the average of the adjacent fracture apertures."""

    def residual_aperture(self, subdomains: Sequence) -> ad.Scalar:
        return ad.Scalar(self.solid.residual_aperture, "residual_aperture")

    def aperture(self, subdomains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.numerics.ad.grid_operators import (
            MortarProjections,
            SubdomainProjections,
            Trace,
        )

        projection = SubdomainProjections(subdomains, dim=1)
        nd_subdomains = [sd for sd in subdomains if sd.dim == self.nd]
        num_cells_nd = int(sum(sd.num_cells for sd in nd_subdomains))
        one = ad.DenseArray(np.ones(num_cells_nd), name="one")
        apertures = projection.cell_prolongation(nd_subdomains) @ one

        # Reverse dimension order so results follow the md-grid iteration
        # order of the subdomains.
        for dim in range(self.nd - 1, -1, -1):
            subdomains_of_dim = [sd for sd in subdomains if sd.dim == dim]
            if len(subdomains_of_dim) == 0:
                continue
            if dim == self.nd - 1:
                normal_jump = self.normal_component(
                    subdomains_of_dim
                ) @ self.displacement_jump(subdomains_of_dim)
                # Guard against non-physical negative jumps in unconverged
                # states: aperture is bounded below by the residual.
                a_ref = self.residual_aperture(subdomains_of_dim)
                apertures_of_dim = ad.maximum(normal_jump + a_ref, a_ref)
                apertures_of_dim.set_name("aperture_maximum_function")
                apertures = apertures + (
                    projection.cell_prolongation(subdomains_of_dim)
                    @ apertures_of_dim
                )
            else:
                # Intersections: average of the neighboring (parent)
                # fracture apertures, reached via trace + mortar maps.
                interfaces_dim = self.subdomains_to_interfaces(
                    subdomains_of_dim, [1]
                )
                interfaces_dim = [
                    intf for intf in interfaces_dim if intf.dim == dim
                ]
                parent_subdomains = self.interfaces_to_subdomains(
                    interfaces_dim
                )
                parent_subdomains = [
                    sd for sd in parent_subdomains if sd.dim == dim + 1
                ]
                combined = self.mdg.sort_subdomains(
                    subdomains_of_dim + parent_subdomains
                )
                mortar_projection = MortarProjections(
                    self.mdg, combined, interfaces_dim, 1
                )
                combined_projection = SubdomainProjections(combined, 1)
                trace = Trace(parent_subdomains)
                parent_cells_to_intersection_cells = (
                    mortar_projection.mortar_to_secondary_avg().mat
                    @ mortar_projection.primary_to_mortar_avg().mat
                    @ combined_projection.face_prolongation(
                        parent_subdomains
                    ).mat
                    @ trace.mat
                ).tocsr()
                average_weights = np.ravel(
                    parent_cells_to_intersection_cells.sum(axis=1)
                )
                nonzero = average_weights > 0
                average_weights[nonzero] = 1.0 / average_weights[nonzero]
                divide_by_num_neighbors = ad.DenseArray(
                    average_weights, name="average_weights"
                )
                parent_apertures = self.aperture(parent_subdomains)
                apertures_of_dim = divide_by_num_neighbors * (
                    ad.SparseArray(
                        parent_cells_to_intersection_cells,
                        name="parents_to_intersections",
                    )
                    @ parent_apertures
                )
                apertures_of_dim = (
                    combined_projection.cell_restriction(subdomains_of_dim)
                    @ apertures_of_dim
                )
                apertures_of_dim.set_name(
                    f"Displacement_jump_aperture_dim_{dim}"
                )
                apertures = apertures + (
                    projection.cell_prolongation(subdomains_of_dim)
                    @ apertures_of_dim
                )

        apertures.set_name("Displacement_jump_apertures")
        return apertures


class ConstantPermeability:
    """Reference ``constitutive_laws.py:572``: homogeneous permeability as a
    9-component-per-cell tensor operator."""

    def permeability(self, subdomains: Sequence) -> ad.Operator:
        size = sum(sd.num_cells for sd in subdomains)
        permeability = ad.DenseArray(
            self.solid.permeability * np.ones(size), name="permeability"
        )
        return self.isotropic_second_order_tensor(subdomains, permeability)

    def normal_permeability(self, interfaces: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.normal_permeability, "normal_permeability")


class DimensionDependentPermeability(ConstantPermeability):
    """Permeability assembled per subdomain dimension class (reference
    ``constitutive_laws.py:722``): override the matrix/fracture/intersection
    sub-methods individually."""

    def permeability(self, subdomains: Sequence) -> ad.Operator:
        projection = ad.SubdomainProjections(subdomains, dim=9)
        matrix = [sd for sd in subdomains if sd.dim == self.nd]
        fractures = [sd for sd in subdomains if sd.dim == self.nd - 1]
        intersections = [sd for sd in subdomains if sd.dim < self.nd - 1]
        return (
            projection.cell_prolongation(matrix)
            @ self.matrix_permeability(matrix)
            + projection.cell_prolongation(fractures)
            @ self.fracture_permeability(fractures)
            + projection.cell_prolongation(intersections)
            @ self.intersection_permeability(intersections)
        )

    def matrix_permeability(self, subdomains: Sequence) -> ad.Operator:
        return super().permeability(subdomains)

    def fracture_permeability(self, subdomains: Sequence) -> ad.Operator:
        size = sum(sd.num_cells for sd in subdomains)
        vals = ad.wrap_as_dense_ad_array(
            self.solid.permeability, size, name="fracture_permeability"
        )
        return self.isotropic_second_order_tensor(subdomains, vals)

    def intersection_permeability(self, subdomains: Sequence) -> ad.Operator:
        size = sum(sd.num_cells for sd in subdomains)
        vals = ad.wrap_as_dense_ad_array(
            self.solid.permeability, size, name="intersection_permeability"
        )
        return self.isotropic_second_order_tensor(subdomains, vals)


class CubicLawPermeability(DimensionDependentPermeability):
    """Parallel-plate (cubic-law) permeability of fractures and
    intersections: ``a^2 / 12`` (reference ``constitutive_laws.py:802``; the
    aperture factor converting permeability to transmissivity is applied by
    the dimension-reduction specific-volume scaling)."""

    def cubic_law_permeability(self, subdomains: Sequence) -> ad.Operator:
        aperture = self.aperture(subdomains)
        perm = (aperture ** ad.Scalar(2.0)) / ad.Scalar(12.0)
        return self.isotropic_second_order_tensor(subdomains, perm)

    def fracture_permeability(self, subdomains: Sequence) -> ad.Operator:
        return self.cubic_law_permeability(subdomains)

    def intersection_permeability(self, subdomains: Sequence) -> ad.Operator:
        return self.cubic_law_permeability(subdomains)


class MassWeightedPermeability(ConstantPermeability):
    """Fractional-flow permeability: the total mass mobility enters the
    diffusive tensor isotropically on top of the constant absolute
    permeability (reference ``constitutive_laws.py:616``). Combine with
    ``MassicPressureEquations``; the tensor is lagged and refreshed by the
    nonlinear-rediscretization machinery."""

    def mass_mobility_weighted_permeability(self, subdomains: Sequence) -> ad.Operator:
        abs_perm = ad.wrap_as_dense_ad_array(
            self.solid.permeability,
            size=sum(sd.num_cells for sd in subdomains),
            name="absolute_permeability",
        )
        # Clamp at a small positive floor: transient Newton iterates can
        # push saturations (hence relative permeabilities) slightly out of
        # bounds; the tensor is lagged, so the clamp only guards the
        # rediscretization against indefiniteness.
        floor = ad.wrap_as_dense_ad_array(
            1e-8 * self.solid.permeability,
            size=sum(sd.num_cells for sd in subdomains),
        )
        op = ad.maximum(self.total_mass_mobility(subdomains) * abs_perm, floor)
        op.set_name("mass_mobility_weighted_permeability")
        return op

    def permeability(self, subdomains: Sequence) -> ad.Operator:
        return self.isotropic_second_order_tensor(
            subdomains, self.mass_mobility_weighted_permeability(subdomains)
        )

    def normal_permeability(self, interfaces: Sequence) -> ad.Operator:
        subdomains = self.interfaces_to_subdomains(interfaces)
        projection = ad.MortarProjections(self.mdg, subdomains, interfaces, dim=1)
        return projection.secondary_to_mortar_avg() @ (
            self.mass_mobility_weighted_permeability(subdomains)
        )


class SecondOrderTensorUtils:
    """Reference ``constitutive_laws.py:492-570``."""

    def isotropic_second_order_tensor(
        self, subdomains: Sequence, permeability: ad.Operator
    ) -> ad.Operator:
        """Expand a cell-wise scalar to the diagonal of a 9-entries-per-cell
        tensor representation."""
        basis = self.basis(subdomains, dim=9)
        out = ad.sum_operator_list(
            [basis[i] @ permeability for i in (0, 4, 8)]
        )
        out.set_name("isotropic_second_order_tensor")
        return out

    def operator_to_SecondOrderTensor(
        self, subdomains: Sequence, operator: ad.Operator, fallback_value: float
    ) -> SecondOrderTensor:
        """Evaluate a (9 x num_cells) tensor operator and scale by the
        specific volume — the aperture scaling of effective fracture
        permeability (reference ``constitutive_laws.py:518-570``)."""
        if not isinstance(subdomains, (list, tuple)):
            subdomains = [subdomains]
        volume = np.asarray(
            self.equation_system.evaluate(self.specific_volume(list(subdomains)))
        )
        num_cells = sum(sd.num_cells for sd in subdomains)
        try:
            tensor = np.asarray(self.equation_system.evaluate(operator))
        except Exception:
            return SecondOrderTensor(fallback_value * np.ones(num_cells) * volume)
        val = tensor.reshape(9, -1, order="F")
        components = [val[i] for i in (0, 4, 8)]
        for i, j in zip((1, 2, 5), (3, 6, 7)):
            if not np.allclose(val[i], val[j]):
                raise ValueError("Tensor operator is not symmetric")
            components.append(val[i])
        kxx, kyy, kzz, kxy, kxz, kyz = [c * volume for c in components]
        return SecondOrderTensor(
            kxx, kyy=kyy, kzz=kzz, kxy=kxy, kxz=kxz, kyz=kyz
        )


class ZeroGravityForce:
    """Reference ``constitutive_laws.py:2722`` (zero variant)."""

    def gravity_force(self, grids: Sequence, material: str) -> ad.Operator:
        num_cells = int(sum(g.num_cells for g in grids))
        return ad.DenseArray(np.zeros(num_cells * self.nd), name="gravity_force")


class GravityForce:
    """Gravity force density: - rho * g * e_z (or e_y in 2d), cell-wise
    vector (reference ``constitutive_laws.py:2722``)."""

    def gravity_force(self, grids: Sequence, material: str) -> ad.Operator:
        from porepy_tpu_torch.utils import common_constants as cc

        g_val = self.units.convert_units(cc.GRAVITY_ACCELERATION, "m*s^-2")
        if material == "fluid":
            rho = self.fluid_density(grids)
        else:
            rho = ad.Scalar(self.solid.density)
        e_last = self.e_i(grids, i=self.nd - 1, dim=self.nd)
        force = ad.Scalar(-g_val) * (e_last @ rho)
        force.set_name("gravity_force")
        return force


class DarcysLaw:
    """Darcy flux on the FV matrix contract (reference
    ``constitutive_laws.py:852``). Mobility is *not* included (it upwinds
    separately)."""

    def darcy_flux(self, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if len(domains) == 0 or all(isinstance(d, BoundaryGrid) for d in domains):
            return self.create_boundary_operator(
                name=self.bc_data_darcy_flux_key, domains=domains
            )
        subdomains = list(domains)
        discr = self.darcy_flux_discretization(subdomains)
        p = self.pressure(subdomains)
        boundary_operator = self.combine_boundary_operators_darcy_flux(subdomains)
        flux = (
            discr.flux() @ p
            + discr.bound_flux() @ boundary_operator
            + discr.vector_source() @ self.vector_source_darcy_flux(subdomains)
        )
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            from porepy_tpu_torch.numerics.ad.grid_operators import MortarProjections

            projection = MortarProjections(self.mdg, subdomains, interfaces, dim=1)
            flux = flux + discr.bound_flux() @ (
                projection.mortar_to_primary_int()
                @ self.interface_darcy_flux(interfaces)
            )
        flux.set_name("darcy_flux")
        return flux

    def pressure_trace(self, subdomains: Sequence) -> ad.Operator:
        discr = self.darcy_flux_discretization(subdomains)
        p = self.pressure(subdomains)
        boundary_operator = self.combine_boundary_operators_darcy_flux(subdomains)
        trace = (
            discr.bound_pressure_cell() @ p
            + discr.bound_pressure_face() @ boundary_operator
            + discr.bound_pressure_vector_source()
            @ self.vector_source_darcy_flux(subdomains)
        )
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            from porepy_tpu_torch.numerics.ad.grid_operators import MortarProjections

            projection = MortarProjections(self.mdg, subdomains, interfaces, dim=1)
            trace = trace + discr.bound_pressure_face() @ (
                projection.mortar_to_primary_int()
                @ self.interface_darcy_flux(interfaces)
            )
        trace.set_name("pressure_trace")
        return trace

    def combine_boundary_operators_darcy_flux(
        self, subdomains: Sequence
    ) -> ad.Operator:
        return self._combine_boundary_operators(
            subdomains=subdomains,
            dirichlet_operator=self.pressure,
            neumann_operator=self.darcy_flux,
            robin_operator=self.darcy_flux,
            bc_type=self.bc_type_darcy_flux,
            name="bc_values_" + self.bc_data_darcy_flux_key,
        )

    def vector_source_darcy_flux(self, grids: Sequence) -> ad.Operator:
        force = self.gravity_force(grids, "fluid")
        force.set_name("vector_source_darcy_flux")
        return force

    def interface_vector_source_darcy_flux(self, interfaces: Sequence) -> ad.Operator:
        """Gravity along the interface normal; zero with ZeroGravityForce
        (reference ``constitutive_laws.py`` DarcysLaw)."""
        num = int(sum(intf.num_cells for intf in interfaces))
        return ad.DenseArray(
            np.zeros(num), name="interface_vector_source_darcy_flux"
        )

    def interface_darcy_flux_equation(self, interfaces: Sequence) -> ad.Operator:
        """Two-sided interface Darcy law: flux variable minus the
        normal-permeability-scaled pressure jump across the interface
        (reference ``constitutive_laws.py:1032``)."""
        subdomains = self.interfaces_to_subdomains(interfaces)
        projection = ad.MortarProjections(self.mdg, subdomains, interfaces, dim=1)
        to_mortar_lo = projection.secondary_to_mortar_avg()
        to_mortar_hi = projection.primary_to_mortar_avg()
        # 2/aperture: the distance from fracture center to interface.
        normal_gradient = ad.Scalar(2.0) * (
            to_mortar_lo @ self.aperture(subdomains) ** (-1.0)
        )
        normal_gradient.set_name("normal_gradient")
        p_jump = (
            to_mortar_hi @ self.pressure_trace(subdomains)
            - to_mortar_lo @ self.pressure(subdomains)
        )
        driving_force = normal_gradient * p_jump + (
            self.interface_vector_source_darcy_flux(interfaces)
        )
        eq = self.interface_darcy_flux(interfaces) - self.volume_integral(
            self.normal_permeability(interfaces) * driving_force, interfaces, 1
        )
        eq.set_name("interface_darcy_flux_equation")
        return eq

    def darcy_flux_discretization(self, subdomains: Sequence) -> MpfaAd:
        """MPFA by default, matching the reference
        (``constitutive_laws.py:1078``); override to return TpfaAd for
        two-point schemes."""
        from porepy_tpu_torch.numerics.ad.discretizations import MpfaAd

        return MpfaAd(self.darcy_keyword, subdomains, self.mdg)


class AdvectiveFlux:
    """Upwinded advective flux (reference ``constitutive_laws.py:2507``).

    The upstream selection runs inside the traced residual (``sign(q)``,
    detached), so there is no upwind matrix to rediscretize between
    iterations.
    """

    def advective_flux(
        self,
        subdomains: Sequence,
        advected_entity: ad.Operator,
        discr,  # accepted for API parity; selection happens in-kernel
        bc_values: ad.Operator,
        interface_flux: Optional[Callable] = None,
        bc_type: Optional[Callable] = None,
    ) -> ad.Operator:
        q = self.darcy_flux(subdomains)
        # Each advected quantity carries its own boundary-condition type
        # (e.g. the enthalpy flux is Dirichlet on all faces while the fluid
        # flux is not); the Dirichlet/Neumann face masks must match it.
        geom, pattern = self._upwind_geometry(subdomains, bc_type)

        def f(q_v, w_v, bc_v):
            return upwind_flux(geom, q_v, w_v, bc_v)

        def pattern_fn(child_patterns, ndof):
            q_pat, w_pat, bc_pat = child_patterns
            out = (pattern @ w_pat).astype(bool).tocsr()
            from porepy_tpu_torch.numerics.ad.compiler import _union

            return _union(_union(out, q_pat), bc_pat)

        def dual_rule(run, q_d, w_d, bc_d):
            return upwind_flux_dual(geom, q_d, w_d, bc_d)

        fn = ad.Function(
            f, name="advective_flux", pattern_fn=pattern_fn, dual_rule=dual_rule
        )
        flux = fn(q, advected_entity, bc_values)

        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interface_flux is not None and interfaces:
            from porepy_tpu_torch.numerics.ad.grid_operators import MortarProjections

            projection = MortarProjections(self.mdg, subdomains, interfaces, dim=1)
            # Influx from lower-dimensional neighbors acts like a Neumann
            # pickup on the internal boundary faces.
            neu_sel = self._neumann_pickup_operator(subdomains, bc_type)
            flux = flux + neu_sel @ (
                projection.mortar_to_primary_int() @ interface_flux(interfaces)
            )
        return flux

    def _upwind_geometry(self, subdomains: Sequence, bc_type=None):
        if bc_type is None:
            bc_type = self.bc_type_fluid_flux
        cache = getattr(self, "_upwind_geom_cache", None)
        if cache is None:
            cache = self._upwind_geom_cache = {}
        key = (getattr(bc_type, "__name__", repr(bc_type)),) + tuple(
            sd.id for sd in subdomains
        )
        if key not in cache:
            bcs = [bc_type(sd) for sd in subdomains]
            geom = UpwindGeometry(subdomains, bcs)
            cache[key] = (geom, geom.structural_pattern())
        return cache[key]

    def _neumann_pickup_operator(
        self, subdomains: Sequence, bc_type=None
    ) -> ad.SparseArray:
        import scipy.sparse as sps

        geom, _ = self._upwind_geometry(subdomains, bc_type)
        coeff = np.asarray(geom.sgn_div) * np.asarray(geom.is_neu)
        return ad.SparseArray(
            sps.dia_matrix((coeff, 0), shape=(coeff.size, coeff.size)).tocsr(),
            name="bound_transport_neu",
        )

    def interface_advective_flux(
        self, interfaces: Sequence, advected_entity: ad.Operator, discr
    ) -> ad.Operator:
        """Upwinded advective flux over interfaces: the interface Darcy flux
        times the upstream (primary trace / secondary) advected value
        (reference ``constitutive_laws.py:2571``). Upstream selection runs
        inside the traced residual, like the subdomain upwinding."""
        subdomains = self.interfaces_to_subdomains(interfaces)
        projection = ad.MortarProjections(self.mdg, subdomains, interfaces, dim=1)
        trace = ad.Trace(subdomains)

        w_primary = (
            projection.primary_to_mortar_avg() @ trace @ advected_entity
        )
        w_secondary = projection.secondary_to_mortar_avg() @ advected_entity
        lam = self.interface_darcy_flux(interfaces)

        def f(lam_v, wp, ws):
            return lam_v * upwind_select_pair(lam_v, wp, ws)

        def pattern_fn(child_patterns, ndof):
            from porepy_tpu_torch.numerics.ad.compiler import _union

            out = child_patterns[0]
            for other in child_patterns[1:]:
                out = _union(out, other)
            return out

        def dual_rule(run, lam_d, wp, ws):
            return upwind_interface_dual(lam_d, wp, ws)

        fn = ad.Function(
            f, name="interface_upwind", pattern_fn=pattern_fn, dual_rule=dual_rule
        )
        return fn(lam, w_primary, w_secondary)


class ElasticModuli:
    """Elastic moduli and the cell-wise stiffness tensor (reference
    ``constitutive_laws.py`` ElasticModuli)."""

    def shear_modulus(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.shear_modulus, "shear_modulus")

    def lame_lambda(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.lame_lambda, "lame_lambda")

    def youngs_modulus(self, subdomains: Sequence) -> ad.Operator:
        mu = self.solid.shear_modulus
        lmbda = self.solid.lame_lambda
        val = mu * (3 * lmbda + 2 * mu) / (lmbda + mu)
        return ad.Scalar(val, "youngs_modulus")

    def bulk_modulus(self, subdomains: Sequence) -> ad.Operator:
        val = self.solid.lame_lambda + 2 * self.solid.shear_modulus / 3
        return ad.Scalar(val, "bulk_modulus")

    def stiffness_tensor(self, subdomain):
        """Cell-wise isotropic stiffness from the solid's Lame parameters."""
        from porepy_tpu_torch.params.tensor import FourthOrderTensor as _C

        mu = self.solid.shear_modulus * np.ones(subdomain.num_cells)
        lmbda = self.solid.lame_lambda * np.ones(subdomain.num_cells)
        return _C(mu, lmbda)


class LinearElasticMechanicalStress:
    """MPSA-discretized linear elastic stress (reference
    ``constitutive_laws.py:2812``)."""

    def mechanical_stress(self, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if len(domains) == 0 or all(isinstance(d, BoundaryGrid) for d in domains):
            return self.create_boundary_operator(
                name=self.stress_keyword, domains=domains
            )
        subdomains = list(domains)
        for sd in subdomains:
            if sd.dim != self.nd:
                raise ValueError("Mechanical stress requires co-dimension 0")
        discr = self.stress_discretization(subdomains)
        boundary_operator = self.combine_boundary_operators_mechanical_stress(
            subdomains
        )
        stress = (
            discr.stress() @ self.displacement(subdomains)
            + discr.bound_stress() @ boundary_operator
        )
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            proj = ad.MortarProjections(
                self.mdg, subdomains, interfaces, dim=self.nd
            )
            stress = stress + discr.bound_stress() @ (
                proj.mortar_to_primary_avg()
                @ self.interface_displacement(interfaces)
            )
        stress.set_name("mechanical_stress")
        return stress

    def combine_boundary_operators_mechanical_stress(
        self, subdomains: Sequence
    ) -> ad.Operator:
        return self._combine_boundary_operators(
            subdomains=subdomains,
            dirichlet_operator=self.displacement,
            neumann_operator=self.mechanical_stress,
            robin_operator=self.mechanical_stress,
            bc_type=self.bc_type_mechanics,
            dim=self.nd,
            name="bc_values_mechanics",
        )

    def stress_discretization(self, subdomains: Sequence):
        from porepy_tpu_torch.numerics.ad.discretizations import MpsaAd

        return MpsaAd(self.stress_keyword, subdomains, self.mdg)


    def fracture_stress(self, interfaces):
        """Contact traction rotated to global coordinates and projected to
        the interface, rescaled to physical units (reference
        ``constitutive_laws.py:2956``)."""
        for interface in interfaces:
            if interface.dim != self.nd - 1:
                raise ValueError("Interface must be of co-dimension 1")
        subdomains = self.interfaces_to_subdomains(interfaces)
        fracture_subdomains = [sd for sd in subdomains if sd.dim == self.nd - 1]
        subdomain_projection = ad.SubdomainProjections(subdomains, self.nd)
        mortar_projection = ad.MortarProjections(
            self.mdg, subdomains, interfaces, self.nd
        )
        # Rotate the (nondimensional) contact traction from local frames to
        # global coordinates, then lift it onto the mortar with side signs.
        rotate = self.local_coordinates(fracture_subdomains).transpose()
        lift = (
            mortar_projection.sign_of_mortar_sides()
            @ mortar_projection.secondary_to_mortar_int()
            @ subdomain_projection.cell_prolongation(fracture_subdomains)
        )
        scale = self.characteristic_contact_traction(fracture_subdomains)
        traction = (
            lift @ (rotate @ self.contact_traction(fracture_subdomains))
        ) * scale
        traction.set_name("mechanical_fracture_stress")
        return traction



class DisplacementJump:
    """Displacement jump across fractures in local (tangential/normal)
    coordinates, split into elastic and plastic parts (reference
    ``constitutive_laws.py:26``)."""

    def displacement_jump(self, subdomains: Sequence) -> ad.Operator:
        if not all(sd.dim == self.nd - 1 for sd in subdomains):
            raise ValueError("Displacement jump only defined on fractures")
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        interfaces = [intf for intf in interfaces if intf.dim == self.nd - 1]
        mortar_projection = ad.MortarProjections(
            self.mdg, subdomains, interfaces, self.nd
        )
        rotated_jumps = (
            self.local_coordinates(subdomains)
            @ mortar_projection.mortar_to_secondary_avg()
            @ mortar_projection.sign_of_mortar_sides()
            @ self.interface_displacement(interfaces)
        )
        rotated_jumps.set_name("rotated_displacement_jump")
        return rotated_jumps

    def elastic_displacement_jump(self, subdomains: Sequence) -> ad.Operator:
        basis = self.basis(subdomains, dim=self.nd)
        local_basis = self.basis(subdomains, dim=self.nd - 1)
        tangential_to_nd = ad.sum_operator_list(
            [e_nd @ e_f.T for e_nd, e_f in zip(basis[:-1], local_basis)]
        )
        normal_to_nd = basis[-1]
        u_t = self.elastic_tangential_fracture_deformation(subdomains)
        u_n = self.elastic_normal_fracture_deformation(subdomains)
        return tangential_to_nd @ u_t + normal_to_nd @ u_n

    def plastic_displacement_jump(self, subdomains: Sequence) -> ad.Operator:
        u_p = self.displacement_jump(subdomains) - self.elastic_displacement_jump(
            subdomains
        )
        u_p.set_name("plastic_displacement_jump")
        return u_p


class CharacteristicTractionFromDisplacement:
    """Reference ``constitutive_laws.py:3682``."""

    def characteristic_contact_traction(self, subdomains: Sequence) -> ad.Operator:
        size = ad.Scalar(float(np.max(self.domain.side_lengths())))
        strain = self.characteristic_displacement(subdomains) / size
        t_char = strain * self.youngs_modulus(subdomains)
        t_char.set_name("characteristic_contact_traction")
        return t_char

    def characteristic_displacement(self, subdomains: Sequence) -> ad.Operator:
        u_char = ad.Scalar(self.numerical.characteristic_displacement)
        u_char.set_name("characteristic_displacement")
        return u_char


class CoulombFrictionBound:
    """b = -F t_n (reference ``constitutive_laws.py:3776``)."""

    def friction_bound(self, subdomains: Sequence) -> ad.Operator:
        t_n = self.normal_component(subdomains) @ self.contact_traction(subdomains)
        bound = ad.Scalar(-1.0) * self.friction_coefficient(subdomains) * t_n
        bound.set_name("friction_bound")
        return bound

    def friction_coefficient(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.friction_coefficient, "friction_coefficient")


class ShearDilation:
    """Dilation gap tan(psi) * |u_t^plastic| (reference constitutive law)."""

    def shear_dilation_gap(self, subdomains: Sequence) -> ad.Operator:
        angle = self.dilation_angle(subdomains)
        norm = ad.l2_norm(
            self.nd - 1,
            self.tangential_component(subdomains)
            @ self.plastic_displacement_jump(subdomains),
        )
        out = ad.tan(angle) * norm
        out.set_name("shear_dilation")
        return out

    def dilation_angle(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.dilation_angle, "dilation_angle")


class FrictionDamage:
    """Damage-dependent friction: the intact friction bound is scaled by
    ``1 + (d0 - 1) exp(-c h)`` with ``h`` the damage history variable
    (J. White 2014; reference ``constitutive_laws.py:4160-4250``)."""

    def friction_damage(self, subdomains: Sequence) -> ad.Operator:
        d0 = ad.Scalar(self.solid.initial_friction_damage)
        c = ad.Scalar(self.solid.friction_damage_decay)
        h = self.damage_history(subdomains)
        one = ad.Scalar(1.0)
        out = one + (d0 - one) * ad.exp(ad.Scalar(-1.0) * c * h)
        out.set_name("friction_damage")
        return out

    def friction_bound(self, subdomains: Sequence) -> ad.Operator:
        out = self.friction_damage(subdomains) * super().friction_bound(
            subdomains
        )
        out.set_name("damaged_friction_bound")
        return out


class DilationDamage:
    """Damage-dependent shear dilation: the intact dilation gap is scaled
    by ``1 + (d0 - 1) exp(-c h)`` (reference
    ``constitutive_laws.py:4253-4330``)."""

    def dilation_damage(self, subdomains: Sequence) -> ad.Operator:
        d0 = ad.Scalar(self.solid.initial_dilation_damage)
        c = ad.Scalar(self.solid.dilation_damage_decay)
        h = self.damage_history(subdomains)
        one = ad.Scalar(1.0)
        out = one + (d0 - one) * ad.exp(ad.Scalar(-1.0) * c * h)
        out.set_name("dilation_damage")
        return out

    def shear_dilation_gap(self, subdomains: Sequence) -> ad.Operator:
        out = self.dilation_damage(subdomains) * super().shear_dilation_gap(
            subdomains
        )
        out.set_name("damaged_shear_dilation")
        return out


class BartonBandis:
    """Barton-Bandis elastic normal fracture deformation (reference
    ``constitutive_laws.py:3883``); void when the maximum opening is 0."""

    def elastic_normal_fracture_deformation(
        self, subdomains: Sequence
    ) -> ad.Operator:
        maximum_opening = self.maximum_elastic_fracture_opening(subdomains)
        val = self.equation_system.evaluate(maximum_opening)
        if np.any(np.asarray(val) == 0):
            num_cells = sum(sd.num_cells for sd in subdomains)
            return ad.DenseArray(np.zeros(num_cells), "zero_barton_bandis_opening")
        if np.any(np.asarray(val) < 0):
            raise ValueError("The maximum opening must be non-negative")
        # Compressive normal traction (positive in compression), and the
        # stiffness nondimensionalized like the traction variable.
        t_n = self.normal_component(subdomains) @ (
            ad.Scalar(-1.0) * self.contact_traction(subdomains)
        )
        k_n = self.fracture_normal_stiffness(
            subdomains
        ) / self.characteristic_contact_traction(subdomains)
        # Barton-Bandis hyperbola: opening loss t_n u_max / (k_n u_max + t_n).
        elastic_opening = maximum_opening - (
            t_n * maximum_opening / (k_n * maximum_opening + t_n)
        )
        elastic_opening.set_name("barton_bandis_elastic_opening")
        return elastic_opening

    def maximum_elastic_fracture_opening(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.solid.maximum_elastic_fracture_opening, "maximum_opening"
        )

    def fracture_normal_stiffness(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.solid.fracture_normal_stiffness, "fracture_normal_stiffness"
        )


class FractureGap(BartonBandis, ShearDilation):
    """gap = reference + shear dilation + elastic opening (reference
    ``constitutive_laws.py:4022``)."""

    def fracture_gap(self, subdomains: Sequence) -> ad.Operator:
        gap = (
            self.reference_fracture_gap(subdomains)
            + self.shear_dilation_gap(subdomains)
            + self.elastic_normal_fracture_deformation(subdomains)
        )
        gap.set_name("fracture_gap")
        return gap

    def reference_fracture_gap(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.fracture_gap, "reference_fracture_gap")


class ElasticTangentialFractureDeformation:
    """u_t = t_t / K_t; zero when K_t = -1 (reference
    ``constitutive_laws.py:4062``)."""

    def fracture_tangential_stiffness(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.solid.fracture_tangential_stiffness,
            "fracture_tangential_stiffness",
        )

    def elastic_tangential_fracture_deformation(
        self, subdomains: Sequence
    ) -> ad.Operator:
        stiffness = self.fracture_tangential_stiffness(subdomains)
        stiffness_value = self.units.convert_units(
            float(self.equation_system.evaluate(stiffness)), "Pa*m^-1", to_si=True
        )
        if np.any(np.isclose(stiffness_value, -1.0, atol=1e-12, rtol=1e-12)):
            num_cells = sum(sd.num_cells for sd in subdomains)
            zero = ad.DenseArray(np.zeros((self.nd - 1) * num_cells))
            zero.set_name("zero_elastic_tangential_fracture_deformation")
            return zero
        t_t = self.tangential_component(subdomains) @ self.contact_traction(
            subdomains
        )
        scaled_stiffness = stiffness / self.characteristic_contact_traction(
            subdomains
        )
        u_t = t_t / scaled_stiffness
        u_t.set_name("elastic_tangential_fracture_deformation")
        return u_t


class BiotCoefficient:
    """Reference ``constitutive_laws.py:4350``."""

    def biot_coefficient(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.biot_coefficient, "biot_coefficient")

    def biot_tensor(self, subdomains: Sequence) -> SecondOrderTensor:
        size = sum(sd.num_cells for sd in subdomains)
        return SecondOrderTensor(
            self.solid.biot_coefficient * np.ones(size)
        )


class SpecificStorage:
    """Reference ``constitutive_laws.py:4383``."""

    def specific_storage(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.specific_storage, "specific_storage")


class PressureStress(LinearElasticMechanicalStress):
    """Pressure contribution to poromechanical stress (reference
    ``constitutive_laws.py:3377``)."""

    def pressure_stress(self, subdomains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.numerics.ad.discretizations import BiotAd

        for sd in subdomains:
            if sd.dim != self.nd:
                raise ValueError("Pressure stress requires dimension nd")
        discr = BiotAd(self.stress_keyword, subdomains, self.mdg)
        stress = discr.scalar_gradient(
            self.darcy_keyword
        ) @ self.perturbation_from_reference("pressure", subdomains)
        stress.set_name("pressure_stress")
        return stress

    def fracture_stress(self, interfaces: Sequence) -> ad.Operator:
        """Contact traction plus fluid pressure inside the fracture
        (reference ``constitutive_laws.py:3445``)."""
        if not all(intf.dim == self.nd - 1 for intf in interfaces):
            raise ValueError("Interfaces must be of dimension nd - 1")
        traction = super().fracture_stress(
            interfaces
        ) + self.fracture_pressure_stress(interfaces)
        traction.set_name("poro_mechanical_fracture_stress")
        return traction

    def fracture_pressure_stress(self, interfaces: Sequence) -> ad.Operator:
        """Normal force from the fluid pressure inside the fracture acting
        on the matrix boundary (reference ``constitutive_laws.py:3470``)."""
        subdomains = self.interfaces_to_subdomains(interfaces)
        mortar_projection = ad.MortarProjections(
            self.mdg, subdomains, interfaces, 1
        )
        outwards_normal = self.outwards_internal_boundary_normals(
            interfaces, unitary=True
        )
        scalar_to_nd = ad.sum_operator_list(
            self.basis(interfaces, dim=self.nd)
        )
        stress = outwards_normal * (
            scalar_to_nd
            @ mortar_projection.secondary_to_mortar_avg()
            @ self.pressure(subdomains)
        )
        stress.set_name("fracture_pressure_stress")
        return stress

    def stress_discretization(self, subdomains: Sequence):
        from porepy_tpu_torch.numerics.ad.discretizations import BiotAd

        return BiotAd(self.stress_keyword, subdomains, self.mdg)


class ThermalExpansion:
    """Solid thermal expansion coefficient and the associated
    thermo-mechanical coupling tensor (reference
    ``constitutive_laws.py:2010``)."""

    def solid_thermal_expansion_coefficient(
        self, subdomains: Sequence
    ) -> ad.Operator:
        return ad.Scalar(
            self.solid.thermal_expansion, "solid_thermal_expansion"
        )

    def solid_thermal_expansion_tensor(
        self, subdomains: Sequence
    ) -> SecondOrderTensor:
        """Isotropic thermal stress coefficient
        ``(2 mu + 3 lambda) * alpha`` (Boley & Weiner Eq. 1.12.14)."""
        size = sum(sd.num_cells for sd in subdomains)
        val = (
            2 * self.solid.shear_modulus + 3 * self.solid.lame_lambda
        ) * self.solid.thermal_expansion
        return SecondOrderTensor(val * np.ones(size))


class ThermoPressureStress(PressureStress):
    """Pressure and temperature contributions to the poromechanical stress.
    The temperature stress reuses the Biot discretization with the
    thermal-expansion tensor under the enthalpy keyword (reference
    ``constitutive_laws.py:3521``)."""

    def thermal_stress(self, subdomains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.numerics.ad.discretizations import BiotAd

        for sd in subdomains:
            if sd.dim != self.nd:
                raise ValueError("Thermal stress requires dimension nd")
        discr = BiotAd(self.stress_keyword, subdomains, self.mdg)
        stress = discr.scalar_gradient(
            self.enthalpy_keyword
        ) @ self.perturbation_from_reference("temperature", subdomains)
        stress.set_name("thermal_stress")
        return stress


class PoroMechanicsPorosity:
    """Pressure- and displacement-dependent matrix porosity with MPSA
    consistency stabilization (reference ``constitutive_laws.py:4427``)."""

    def porosity(self, subdomains: Sequence) -> ad.Operator:
        subdomains_nd = [sd for sd in subdomains if sd.dim == self.nd]
        subdomains_lower = [sd for sd in subdomains if sd.dim < self.nd]
        projection = ad.SubdomainProjections(subdomains, dim=1)
        size = sum(sd.num_cells for sd in subdomains_lower)
        one = ad.DenseArray(np.ones(size), name="one")
        phi = projection.cell_prolongation(subdomains_nd) @ self.matrix_porosity(
            subdomains_nd
        )
        if subdomains_lower:
            phi = phi + projection.cell_prolongation(subdomains_lower) @ one
        phi.set_name("porosity")
        return phi

    def matrix_porosity(self, subdomains: Sequence) -> ad.Operator:
        if not all(sd.dim == self.nd for sd in subdomains):
            raise ValueError("Matrix porosity requires dimension nd")
        phi = (
            self.reference_porosity(subdomains)
            + self.porosity_change_from_pressure(subdomains)
            + self.porosity_change_from_displacement(subdomains)
        )
        phi = phi + self._mpsa_consistency(
            subdomains, self.darcy_keyword, self.pressure_variable
        )
        phi.set_name("stabilized_matrix_porosity")
        return phi

    def reference_porosity(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.porosity, "reference_porosity")

    def porosity_change_from_pressure(self, subdomains: Sequence) -> ad.Operator:
        alpha = self.biot_coefficient(subdomains)
        phi_ref = self.reference_porosity(subdomains)
        bulk = self.bulk_modulus(subdomains)
        dp = self.perturbation_from_reference("pressure", subdomains)
        n_inv = (alpha - phi_ref) * (ad.Scalar(1.0) - alpha) / bulk
        out = n_inv * dp
        out.set_name("porosity_change_from_pressure")
        return out

    def porosity_change_from_displacement(self, subdomains: Sequence) -> ad.Operator:
        out = self.displacement_divergence(subdomains)
        out.set_name("porosity_change_from_displacement")
        return out

    def displacement_divergence(self, subdomains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.numerics.ad.discretizations import BiotAd

        if not all(sd.dim == self.nd for sd in subdomains):
            raise ValueError("Displacement divergence requires dimension nd")
        discr = BiotAd(self.stress_keyword, subdomains, self.mdg)
        boundary_operator = self.combine_boundary_operators_mechanical_stress(
            subdomains
        )
        bc_contribution = boundary_operator
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            sd_projection = ad.SubdomainProjections(subdomains, dim=self.nd)
            mortar_projection = ad.MortarProjections(
                self.mdg, subdomains, interfaces, dim=self.nd
            )
            bc_contribution = boundary_operator + sd_projection.face_restriction(
                subdomains
            ) @ (
                mortar_projection.mortar_to_primary_avg()
                @ self.interface_displacement(interfaces)
            )
        integrated = discr.displacement_divergence(
            self.darcy_keyword
        ) @ self.displacement(subdomains) + discr.bound_displacement_divergence(
            self.darcy_keyword
        ) @ bc_contribution
        cell_volumes_inv = ad.Scalar(1.0) / self.wrap_grid_attribute(
            subdomains, "cell_volumes", dim=1
        )
        out = cell_volumes_inv * integrated
        out.set_name("displacement_divergence")
        return out

    def _mpsa_consistency(
        self, subdomains: Sequence, physics_name: str, variable_name: str
    ) -> ad.Operator:
        from porepy_tpu_torch.numerics.ad.discretizations import BiotAd

        discr = BiotAd(self.stress_keyword, subdomains, self.mdg)
        dp = self.perturbation_from_reference(variable_name, subdomains)
        integrated = discr.consistency(physics_name) @ dp
        cell_volumes_inv = ad.Scalar(1.0) / self.wrap_grid_attribute(
            subdomains, "cell_volumes", dim=1
        )
        out = cell_volumes_inv * integrated
        out.set_name("mpsa_consistency")
        return out


class BiotPoroMechanicsPorosity(PoroMechanicsPorosity):
    """Porosity recovering the classical Biot consolidation equations after
    the chain rule: the pressure contribution is ``S_eps * dp`` (constant
    fluid density and specific storage assumed; reference
    ``constitutive_laws.py:4737``)."""

    def porosity_change_from_pressure(self, subdomains: Sequence) -> ad.Operator:
        specific_storage = self.specific_storage(subdomains)
        dp = self.perturbation_from_reference("pressure", subdomains)
        out = specific_storage * dp
        out.set_name("Biot's porosity change from pressure")
        return out


class ThermoPoroMechanicsPorosity(PoroMechanicsPorosity):
    """Extends the poromechanical porosity with thermal contraction:
    ``beta_phi = -(alpha - phi_ref) * beta_solid * dT`` (Coussy Eq. 4.44;
    reference ``constitutive_laws.py:4776``)."""

    def matrix_porosity(self, subdomains: Sequence) -> ad.Operator:
        phi = super().matrix_porosity(subdomains)
        phi = phi + self.porosity_change_from_temperature(subdomains)
        phi.set_name("Thermoporomechanics porosity")
        return phi

    def porosity_change_from_temperature(
        self, subdomains: Sequence
    ) -> ad.Operator:
        if not all(sd.dim == self.nd for sd in subdomains):
            raise ValueError("Subdomains must be of dimension nd")
        dtemperature = self.perturbation_from_reference(
            "temperature", subdomains
        )
        phi_ref = self.reference_porosity(subdomains)
        beta = self.solid_thermal_expansion_coefficient(subdomains)
        alpha = self.biot_coefficient(subdomains)
        phi = ad.Scalar(-1.0) * (alpha - phi_ref) * beta * dtemperature
        phi.set_name("Porosity change from temperature")
        return phi


class FouriersLaw:
    """Conductive heat flux on the FV matrix contract — structural mirror of
    :class:`DarcysLaw` with the fourier keyword (reference
    ``constitutive_laws.py:2184``)."""

    def fourier_flux(self, domains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.grids.boundary_grid import BoundaryGrid

        if len(domains) == 0 or all(isinstance(d, BoundaryGrid) for d in domains):
            return self.create_boundary_operator(
                name=self.bc_data_fourier_flux_key, domains=domains
            )
        subdomains = list(domains)
        discr = self.fourier_flux_discretization(subdomains)
        t = self.temperature(subdomains)
        boundary_operator = self.combine_boundary_operators_fourier_flux(subdomains)
        flux = (
            discr.flux() @ t
            + discr.bound_flux() @ boundary_operator
            + discr.vector_source() @ self.vector_source_fourier_flux(subdomains)
        )
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            from porepy_tpu_torch.numerics.ad.grid_operators import MortarProjections

            projection = MortarProjections(self.mdg, subdomains, interfaces, dim=1)
            flux = flux + discr.bound_flux() @ (
                projection.mortar_to_primary_int()
                @ self.interface_fourier_flux(interfaces)
            )
        flux.set_name("fourier_flux")
        return flux

    def temperature_trace(self, subdomains: Sequence) -> ad.Operator:
        discr = self.fourier_flux_discretization(subdomains)
        t = self.temperature(subdomains)
        boundary_operator = self.combine_boundary_operators_fourier_flux(subdomains)
        trace = (
            discr.bound_pressure_cell() @ t
            + discr.bound_pressure_face() @ boundary_operator
            + discr.bound_pressure_vector_source()
            @ self.vector_source_fourier_flux(subdomains)
        )
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            from porepy_tpu_torch.numerics.ad.grid_operators import MortarProjections

            projection = MortarProjections(self.mdg, subdomains, interfaces, dim=1)
            trace = trace + discr.bound_pressure_face() @ (
                projection.mortar_to_primary_int()
                @ self.interface_fourier_flux(interfaces)
            )
        trace.set_name("temperature_trace")
        return trace

    def combine_boundary_operators_fourier_flux(
        self, subdomains: Sequence
    ) -> ad.Operator:
        return self._combine_boundary_operators(
            subdomains=subdomains,
            dirichlet_operator=self.temperature,
            neumann_operator=self.fourier_flux,
            robin_operator=self.fourier_flux,
            bc_type=self.bc_type_fourier_flux,
            name="bc_values_" + self.bc_data_fourier_flux_key,
        )

    def vector_source_fourier_flux(self, grids: Sequence) -> ad.Operator:
        num_cells = int(sum(g.num_cells for g in grids))
        return ad.DenseArray(
            np.zeros(num_cells * self.nd), name="vector_source_fourier_flux"
        )

    def interface_vector_source_fourier_flux(
        self, interfaces: Sequence
    ) -> ad.Operator:
        num = int(sum(intf.num_cells for intf in interfaces))
        return ad.DenseArray(
            np.zeros(num), name="interface_vector_source_fourier_flux"
        )

    def interface_fourier_flux_equation(self, interfaces: Sequence) -> ad.Operator:
        subdomains = self.interfaces_to_subdomains(interfaces)
        projection = ad.MortarProjections(self.mdg, subdomains, interfaces, dim=1)
        to_mortar_lo = projection.secondary_to_mortar_avg()
        to_mortar_hi = projection.primary_to_mortar_avg()
        normal_gradient = ad.Scalar(2.0) * (
            to_mortar_lo @ self.aperture(subdomains) ** (-1.0)
        )
        t_jump = (
            to_mortar_hi @ self.temperature_trace(subdomains)
            - to_mortar_lo @ self.temperature(subdomains)
        )
        driving_force = normal_gradient * t_jump + (
            self.interface_vector_source_fourier_flux(interfaces)
        )
        eq = self.interface_fourier_flux(interfaces) - self.volume_integral(
            self.normal_thermal_conductivity(interfaces) * driving_force,
            interfaces,
            1,
        )
        eq.set_name("interface_fourier_flux_equation")
        return eq

    def fourier_flux_discretization(self, subdomains: Sequence):
        from porepy_tpu_torch.numerics.ad.discretizations import MpfaAd

        return MpfaAd(self.fourier_keyword, subdomains, self.mdg)


class ConstantFluidThermalConductivity:
    """Reference ``constitutive_laws.py`` ConstantFluidThermalConductivity."""

    def fluid_thermal_conductivity(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.fluid.reference_component.thermal_conductivity,
            "fluid_thermal_conductivity",
        )

    def normal_thermal_conductivity(self, interfaces: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.fluid.reference_component.normal_thermal_conductivity,
            "normal_thermal_conductivity",
        )


class ThermalConductivityLTE(ConstantFluidThermalConductivity):
    """Porosity-weighted local-thermal-equilibrium conductivity (reference
    ``constitutive_laws.py:2093``)."""

    def solid_thermal_conductivity(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.solid.thermal_conductivity, "solid_thermal_conductivity"
        )

    def thermal_conductivity(self, subdomains: Sequence) -> ad.Operator:
        # The conductivity is a discretization parameter: it may be requested
        # before variables exist (e.g. variable-dependent porosity in THM).
        # Fall back to the reference porosity then (reference
        # ``constitutive_laws.py:2158``).
        try:
            phi = self.porosity(subdomains)
            self.equation_system.evaluate(phi)
        except (KeyError, ValueError):
            phi = self.reference_porosity(subdomains)
        if isinstance(phi, ad.Scalar):
            size = sum(sd.num_cells for sd in subdomains)
            phi = phi * ad.DenseArray(np.ones(size))
        conductivity = phi * self.fluid_thermal_conductivity(subdomains) + (
            ad.Scalar(1.0) - phi
        ) * self.solid_thermal_conductivity(subdomains)
        return self.isotropic_second_order_tensor(subdomains, conductivity)


class FluidEnthalpyFromTemperature:
    """h = c_p (T - T_ref) (reference ``fluid_property_library.py:1325``)."""

    def fluid_specific_heat_capacity(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.fluid.reference_component.specific_heat_capacity,
            "fluid_specific_heat_capacity",
        )

    def fluid_specific_enthalpy(self, domains: Sequence) -> ad.Operator:
        c = self.fluid_specific_heat_capacity(domains)
        enthalpy = c * self.perturbation_from_reference("temperature", domains)
        enthalpy.set_name("fluid_enthalpy")
        return enthalpy


class EnthalpyFromTemperature(FluidEnthalpyFromTemperature):
    """Fluid and solid linear enthalpies (reference
    ``constitutive_laws.py:2652``)."""

    def enthalpy_discretization(self, subdomains: Sequence) -> UpwindAd:
        return UpwindAd(self.enthalpy_keyword, subdomains, self.mdg)

    def interface_enthalpy_discretization(self, interfaces: Sequence) -> UpwindAd:
        return UpwindAd(self.enthalpy_keyword, [], self.mdg)

    def solid_specific_heat_capacity(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.solid.specific_heat_capacity, "solid_specific_heat_capacity"
        )

    def solid_enthalpy(self, subdomains: Sequence) -> ad.Operator:
        c = self.solid_specific_heat_capacity(subdomains)
        enthalpy = c * self.perturbation_from_reference("temperature", subdomains)
        enthalpy.set_name("solid_enthalpy")
        return enthalpy


class ConstantSolidDensity:
    def solid_density(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.density, "solid_density")


class FluidDensityFromPressure:
    """rho = rho_ref * exp(c_f (p - p_ref)) (reference
    ``constitutive_laws.py`` FluidDensityFromPressure)."""

    def fluid_compressibility(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.fluid.reference_component.compressibility, "fluid_compressibility"
        )

    def pressure_exponential(self, domains: Sequence) -> ad.Operator:
        dp = self.perturbation_from_reference("pressure", domains)
        c = self.fluid_compressibility(domains)
        return ad.exp(c * dp)

    def fluid_density(self, domains: Sequence) -> ad.Operator:
        rho_ref = ad.Scalar(
            self.fluid.reference_component.density, "reference_fluid_density"
        )
        rho = rho_ref * self.pressure_exponential(domains)
        rho.set_name("fluid_density")
        return rho


class FluidDensityFromTemperature:
    """rho = rho_ref exp(-c_T (T - T_ref)) (reference
    ``fluid_property_library.py:126``)."""

    def fluid_thermal_expansion(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(
            self.fluid.reference_component.thermal_expansion,
            "fluid_thermal_expansion",
        )

    def temperature_exponential(self, domains: Sequence) -> ad.Operator:
        dT = self.perturbation_from_reference("temperature", domains)
        c = self.fluid_thermal_expansion(domains)
        return ad.exp(ad.Scalar(-1.0) * c * dT)

    def fluid_density(self, domains: Sequence) -> ad.Operator:
        rho_ref = ad.Scalar(
            self.fluid.reference_component.density, "reference_fluid_density"
        )
        rho = rho_ref * self.temperature_exponential(domains)
        rho.set_name("fluid_density")
        return rho


class FluidDensityFromPressureAndTemperature(
    FluidDensityFromPressure, FluidDensityFromTemperature
):
    """rho = rho_ref exp(c_p dp - c_T dT) (reference
    ``fluid_property_library.py:192``)."""

    def fluid_density(self, domains: Sequence) -> ad.Operator:
        rho_ref = ad.Scalar(
            self.fluid.reference_component.density, "reference_fluid_density"
        )
        rho = (
            rho_ref
            * self.pressure_exponential(domains)
            * self.temperature_exponential(domains)
        )
        rho.set_name("fluid_density_from_pressure_and_temperature")
        return rho


class ConstantViscosity:
    def fluid_viscosity(self, domains: Sequence) -> ad.Operator:
        return ad.Scalar(self.fluid.reference_component.viscosity, "viscosity")


class FluidMobility:
    """Mobility laws of general fluid mixtures (reference
    ``fluid_property_library.py:229-463``). For single-phase single-component
    fluids all expressions reduce to ``rho / mu`` and ``1 / mu``."""

    mobility_keyword: str

    def mobility(self, domains: Sequence) -> ad.Operator:
        return ad.Scalar(1.0) / self.fluid_viscosity(domains)

    def phase_mobility(self, phase, domains: Sequence) -> ad.Operator:
        """``k_r(s_j) / mu_j`` (volumetric; single phase: ``1/mu``)."""
        if self.fluid.num_phases > 1:
            mob = self.relative_permeability(phase, domains) / phase.viscosity(
                domains
            )
        else:
            mob = phase.viscosity(domains) ** ad.Scalar(-1.0)
        mob.set_name(f"phase_mobility_{phase.name}")
        return mob

    def total_mass_mobility(self, domains: Sequence) -> ad.Operator:
        """``sum_j rho_j k_r(s_j) / mu_j`` — the nonlinear weight of the
        total mass flux (and the diffusive-tensor weight in fractional
        flow)."""
        out = ad.sum_operator_list(
            [
                phase.density(domains) * self.phase_mobility(phase, domains)
                for phase in self.fluid.phases
            ],
            "total_mass_mobility",
        )
        return out

    def component_mass_mobility(self, component, domains: Sequence) -> ad.Operator:
        """``sum_j x_{cj} rho_j k_r(s_j)/mu_j`` over phases containing the
        component (reference ``fluid_property_library.py:351``)."""
        if self.fluid.num_phases > 1 or self.fluid.num_components > 1:
            mob = ad.sum_operator_list(
                [
                    phase.partial_fraction_of[component](domains)
                    * phase.density(domains)
                    * self.phase_mobility(phase, domains)
                    for phase in self.fluid.phases
                    if component in list(phase)
                ]
            )
        else:
            mob = self.fluid.reference_phase.density(
                domains
            ) * self.phase_mobility(self.fluid.reference_phase, domains)
        mob.set_name(f"component_mass_mobility_{component.name}")
        return mob

    def fractional_component_mass_mobility(
        self, component, domains: Sequence
    ) -> ad.Operator:
        """``component_mass_mobility / total_mass_mobility`` — the advective
        weight in fractional-flow component balances where the total mobility
        sits in the diffusive tensor."""
        out = self.component_mass_mobility(
            component, domains
        ) / self.total_mass_mobility(domains)
        out.set_name(f"fractional_component_mass_mobility_{component.name}")
        return out

    def fractional_phase_mass_mobility(self, phase, domains: Sequence) -> ad.Operator:
        """``rho_j k_r(s_j)/mu_j / total_mass_mobility``."""
        out = (
            phase.density(domains)
            * self.phase_mobility(phase, domains)
            / self.total_mass_mobility(domains)
        )
        out.set_name(f"fractional_phase_mass_mobility_{phase.name}")
        return out

    def relative_permeability(self, phase, domains: Sequence) -> ad.Operator:
        """Linear law ``k_r = s_j`` by default (reference
        ``compositional_flow.py:990``); override for Brooks-Corey etc."""
        return phase.saturation(domains)

    def mobility_discretization(self, subdomains: Sequence) -> UpwindAd:
        return UpwindAd(self.mobility_keyword, subdomains, self.mdg)

    def interface_mobility_discretization(self, interfaces: Sequence) -> UpwindAd:
        """Placeholder for API parity; interface upwinding runs in-kernel."""
        return UpwindAd(self.mobility_keyword, [], self.mdg)


class FluidBuoyancy:
    """Buoyancy for multiphase fractional flow (reference
    ``fluid_property_library.py:464``): the Darcy flux's gravity vector
    source carries the fractional-flow-weighted mixture density, and the
    hybrid-upwinding scheme of Bosma et al. (2022) adds pairwise
    counter-current buoyant fluxes per phase pair.

    In-residual: the reference stores signed per-pair face-flux arrays and
    re-discretizes per-pair Upwind matrices every nonlinear iteration
    (reference ``fluid_property_library.py:1130-1260``); here the pair
    upwind directions are the in-kernel sign of the density-driven flux
    (gradient-stopped), so no stored arrays or rediscretization exist.

    The gravity force is active by default
    (``params['enable_buoyancy_effects']`` defaults to True here, matching
    reference ``fluid_property_library.py:684``); the equation-level
    buoyant fluxes are added by the compositional-flow equations under the
    same parameter (defaulting to False there, reference
    ``compositional_flow.py:482-493``).
    """

    def set_buoyancy_discretization_parameters(self) -> None:
        """No-op: the reference initializes per-pair Upwind parameter
        containers and signed flux arrays here (reference
        ``fluid_property_library.py:1130``); the in-kernel upwinding has no
        stored state. Kept so reference model setups port unchanged."""

    def set_nonlinear_buoyancy_discretization(self) -> None:
        """No-op: the reference registers per-pair Upwind matrices for
        rediscretization (reference ``fluid_property_library.py:1156``);
        in-kernel directions re-evaluate on every residual call."""

    def update_buoyancy_driven_fluxes(self) -> None:
        """No-op: the reference recomputes and stores the signed pair flux
        arrays before each nonlinear iteration (reference
        ``fluid_property_library.py:1194``)."""

    def fractionally_weighted_density(self, domains: Sequence) -> ad.Operator:
        op = ad.sum_operator_list(
            [
                self.fractional_phase_mass_mobility(phase, domains)
                * phase.density(domains)
                for phase in self.fluid.phases
            ],
            "fractionally_weighted_density",
        )
        return op

    def gravity_field(self, subdomains: Sequence) -> ad.Operator:
        from porepy_tpu_torch.utils import common_constants as cc

        val = self.units.convert_units(cc.GRAVITY_ACCELERATION, "m*s^-2")
        return ad.Scalar(val, "gravity_field")

    def gravity_force(self, grids: Sequence, material: str) -> ad.Operator:
        if material == "fluid" and self.params.get(
            "enable_buoyancy_effects", True
        ):
            rho = self.fractionally_weighted_density(grids)
            e_n = self.e_i(grids, i=self.nd - 1, dim=self.nd)
            op = ad.Scalar(-1.0) * (e_n @ (rho * self.gravity_field(grids)))
            op.set_name("overall_gravity_flux")
            return op
        return super().gravity_force(grids, material)

    def density_driven_flux(
        self, subdomains: Sequence, density_metric: ad.Operator
    ) -> ad.Operator:
        """Face flux induced by ``density_metric * g`` along the gravity
        direction, through the Darcy discretization's vector-source matrix
        (reference ``fluid_property_library.py:711``)."""
        e_n = self.e_i(subdomains, i=self.nd - 1, dim=self.nd)
        gravity_flux = ad.Scalar(-1.0) * (
            e_n @ (density_metric * self.gravity_field(subdomains))
        )
        discr = self.darcy_flux_discretization(subdomains)
        w_flux = discr.vector_source() @ gravity_flux
        w_flux.set_name("density_driven_flux")
        return w_flux

    def interface_density_driven_flux(
        self, interfaces: Sequence, density_metric: ad.Operator
    ) -> ad.Operator:
        """Mortar flux induced by ``density_metric * g`` across interfaces
        (reference ``fluid_property_library.py:753``)."""
        from porepy_tpu_torch.numerics.ad.grid_operators import MortarProjections

        normals = self.outwards_internal_boundary_normals(
            interfaces, unitary=True
        )
        subdomains = self.interfaces_to_subdomains(interfaces)
        projection = MortarProjections(
            self.mdg, subdomains, interfaces, dim=self.nd
        )
        e_n = self.e_i(subdomains, i=self.nd - 1, dim=self.nd)
        gravity_flux = ad.Scalar(-1.0) * (
            e_n @ (density_metric * self.gravity_field(subdomains))
        )
        intf_vector_source = (
            projection.secondary_to_mortar_avg() @ gravity_flux
        )
        normals_times_source = normals * intf_vector_source
        import scipy.sparse as sps

        bas = self.basis(interfaces, dim=self.nd)
        mat = bas[0].mat.T
        for e in bas[1:]:
            mat = mat + e.mat.T
        nd_to_scalar_sum = ad.SparseArray(
            sps.csr_matrix(mat), "nd_to_scalar_sum"
        )
        w_flux = self.volume_integral(
            self.normal_permeability(interfaces)
            * (nd_to_scalar_sum @ normals_times_source),
            interfaces,
            1,
        )
        w_flux.set_name("interface_density_driven_flux")
        return w_flux

    def phase_pairs_for(self, phase) -> list[tuple]:
        from itertools import combinations

        pairs = []
        for pair in combinations(self.fluid.phases, 2):
            if phase not in pair:
                continue
            if pair[0] is phase:
                pairs.append((pair[0], pair[1]))
            else:
                pairs.append((pair[1], pair[0]))
        return pairs

    def _buoyancy_upwind_geometry(self, subdomains: Sequence):
        """Upwind geometry with all-Neumann boundaries: buoyant fluxes
        vanish on external boundary faces (the reference initializes the
        pair Upwind discretizations with default all-Neumann data,
        ``fluid_property_library.py:1130``)."""
        from porepy_tpu_torch.numerics.fv.upwind import UpwindGeometry
        from porepy_tpu_torch.params.bc import BoundaryCondition

        cache = getattr(self, "_buoy_geom_cache", None)
        if cache is None:
            cache = self._buoy_geom_cache = {}
        key = tuple(sd.id for sd in subdomains)
        if key not in cache:
            bcs = [BoundaryCondition(sd) for sd in subdomains]
            geom = UpwindGeometry(subdomains, bcs)
            cache[key] = (geom, geom.structural_pattern())
        return cache[key]

    def _pair_buoyancy_flux(
        self, adv_gamma, gamma, delta, subdomains: Sequence
    ) -> list[ad.Operator]:
        """Counter-current pair flux ``up_w(adv*f_g) * up_{-w}(f_d) * w``
        with ``w`` the density-driven flux of ``rho_g - rho_d`` (reference
        ``fluid_property_library.py:798``), plus the mortar pickup on
        internal boundaries when interfaces exist."""
        w = self.density_driven_flux(
            subdomains, gamma.density(subdomains) - delta.density(subdomains)
        )
        wg = adv_gamma * self.fractional_phase_mass_mobility(gamma, subdomains)
        wd = self.fractional_phase_mass_mobility(delta, subdomains)
        geom, pattern = self._buoyancy_upwind_geometry(subdomains)

        def f(w_v, g_v, d_v):
            up_g = upwind_apply(geom, w_v, g_v)
            up_d = upwind_apply(geom, -w_v, d_v)
            return up_g * up_d * w_v

        def pattern_fn(child_patterns, ndof):
            from porepy_tpu_torch.numerics.ad.compiler import _union

            w_pat, g_pat, d_pat = child_patterns
            out = (pattern @ _union(g_pat, d_pat)).astype(bool).tocsr()
            return _union(out, w_pat)

        def dual_rule(run, w_d, g_d, d_d):
            up_g = upwind_apply_dual(geom, w_d, g_d)
            up_d = upwind_apply_dual(geom, forward.neg(run, w_d), d_d)
            return forward.mul(run, up_g, up_d, w_d)

        fn = ad.Function(
            f,
            name=f"buoyancy_flux_{gamma.name}_{delta.name}",
            pattern_fn=pattern_fn,
            dual_rule=dual_rule,
        )
        fluxes = [fn(w, wg, wd)]

        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if interfaces:
            coupling = self._pair_interface_coupling(
                adv_gamma, gamma, delta, subdomains, interfaces
            )
            from porepy_tpu_torch.numerics.ad.grid_operators import (
                MortarProjections,
            )

            projection = MortarProjections(
                self.mdg, subdomains, interfaces, dim=1
            )
            neu_sel = self._neumann_pickup_operator(
                subdomains, self._all_neumann_bc
            )
            fluxes.append(
                neu_sel
                @ (projection.mortar_to_primary_int() @ coupling)
            )
        return fluxes

    def _all_neumann_bc(self, sd):
        from porepy_tpu_torch.params.bc import BoundaryCondition

        return BoundaryCondition(sd)

    def _pair_interface_coupling(
        self, adv_gamma, gamma, delta, subdomains, interfaces
    ) -> ad.Operator:
        """Upwinded interface buoyant coupling ``(up_w[adv*f_g] *
        up_{-w}[f_d]) * w_intf`` with upstream sides selected in-kernel by
        the sign of the interface density-driven flux."""
        from porepy_tpu_torch.numerics.ad.grid_operators import (
            MortarProjections,
            Trace,
        )

        intf_w = self.interface_density_driven_flux(
            interfaces, gamma.density(subdomains) - delta.density(subdomains)
        )
        projection = MortarProjections(self.mdg, subdomains, interfaces, dim=1)
        trace = Trace(subdomains)
        wg = adv_gamma * self.fractional_phase_mass_mobility(gamma, subdomains)
        wd = self.fractional_phase_mass_mobility(delta, subdomains)
        gp = projection.primary_to_mortar_avg() @ (trace @ wg)
        gs = projection.secondary_to_mortar_avg() @ wg
        dp = projection.primary_to_mortar_avg() @ (trace @ wd)
        ds = projection.secondary_to_mortar_avg() @ wd

        def f(w_v, gp_v, gs_v, dp_v, ds_v):
            up_g = upwind_select_pair(w_v, gp_v, gs_v)
            up_d = upwind_select_pair(w_v, ds_v, dp_v)
            return up_g * up_d * w_v

        def pattern_fn(child_patterns, ndof):
            from porepy_tpu_torch.numerics.ad.compiler import _union

            out = child_patterns[0]
            for p in child_patterns[1:]:
                out = _union(out, p)
            return out

        def dual_rule(run, w_d, gp_d, gs_d, dp_d, ds_d):
            up_g = upwind_select_pair_dual(w_d, gp_d, gs_d)
            up_d = upwind_select_pair_dual(w_d, ds_d, dp_d)
            return forward.mul(run, up_g, up_d, w_d)

        fn = ad.Function(
            f,
            name=f"interface_buoyancy_{gamma.name}_{delta.name}",
            pattern_fn=pattern_fn,
            dual_rule=dual_rule,
        )
        return fn(intf_w, gp, gs, dp, ds)

    def _pair_buoyancy_jump(
        self, adv_gamma, gamma, delta, subdomains: Sequence
    ) -> list[ad.Operator]:
        """Secondary-side source from the interface buoyant coupling
        (reference ``fluid_property_library.py:904``)."""
        interfaces = self.subdomains_to_interfaces(subdomains, [1])
        if not interfaces:
            return []
        from porepy_tpu_torch.numerics.ad.grid_operators import MortarProjections

        coupling = self._pair_interface_coupling(
            adv_gamma, gamma, delta, subdomains, interfaces
        )
        projection = MortarProjections(self.mdg, subdomains, interfaces, dim=1)
        return [projection.mortar_to_secondary_int() @ coupling]

    def component_buoyancy(self, component, domains: Sequence) -> ad.Operator:
        """Total buoyant flux of a component: counter-current pair fluxes
        advecting its partial fraction in each phase (reference
        ``fluid_property_library.py:1025``)."""
        fluxes = [self.density_driven_flux(domains, ad.Scalar(0.0))]
        for phase in self.fluid.phases:
            for gamma, delta in self.phase_pairs_for(phase):
                # A component absent from phase gamma is not advected by it.
                if component not in gamma.partial_fraction_of:
                    continue
                chi = gamma.partial_fraction_of[component](domains)
                fluxes += self._pair_buoyancy_flux(chi, gamma, delta, domains)
        op = ad.sum_operator_list(fluxes)
        op.set_name(f"component_buoyancy_{component.name}")
        return op

    def enthalpy_buoyancy(self, domains: Sequence) -> ad.Operator:
        """Total buoyant enthalpy flux (reference
        ``fluid_property_library.py:1051``)."""
        fluxes = [self.density_driven_flux(domains, ad.Scalar(0.0))]
        for phase in self.fluid.phases:
            for gamma, delta in self.phase_pairs_for(phase):
                h = gamma.specific_enthalpy(domains)
                fluxes += self._pair_buoyancy_flux(h, gamma, delta, domains)
        op = ad.sum_operator_list(fluxes)
        op.set_name("enthalpy_buoyancy")
        return op

    def component_buoyancy_jump(self, component, domains: Sequence) -> ad.Operator:
        num = sum(g.num_cells for g in domains)
        fluxes = [
            ad.DenseArray(np.zeros(num), name="component_buoyancy_jump_zero")
        ]
        for phase in self.fluid.phases:
            for gamma, delta in self.phase_pairs_for(phase):
                if component not in gamma.partial_fraction_of:
                    continue
                chi = gamma.partial_fraction_of[component](domains)
                fluxes += self._pair_buoyancy_jump(chi, gamma, delta, domains)
        op = ad.sum_operator_list(fluxes)
        op.set_name(f"component_buoyancy_jump_{component.name}")
        return op

    def enthalpy_buoyancy_jump(self, domains: Sequence) -> ad.Operator:
        num = sum(g.num_cells for g in domains)
        fluxes = [
            ad.DenseArray(np.zeros(num), name="enthalpy_buoyancy_jump_zero")
        ]
        for phase in self.fluid.phases:
            for gamma, delta in self.phase_pairs_for(phase):
                h = gamma.specific_enthalpy(domains)
                fluxes += self._pair_buoyancy_jump(h, gamma, delta, domains)
        op = ad.sum_operator_list(fluxes)
        op.set_name("enthalpy_buoyancy_jump")
        return op


class ConstantPorosity:
    def porosity(self, subdomains: Sequence) -> ad.Operator:
        return ad.Scalar(self.solid.porosity, "porosity")
