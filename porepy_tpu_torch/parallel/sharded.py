"""Execution of the framework Newton iteration with its linear algebra
sharded over the ranks of a ``torch.distributed`` process group (K19).

Counterpart of ``porepy_tpu``'s ``parallel/sharded.py``, which shards the
same jitted kernels over a 1d ``jax.sharding.Mesh`` and leaves the
collectives to GSPMD. Here the collectives are written out:

- every rank owns the contiguous dof rows ``[lo, hi)`` of ``ceil(n / P)``
  rows (:func:`porepy_tpu_torch.parallel.halo.shard_bounds`);
- the assembly (K8) runs replicated on every rank, and each rank keeps its
  own rows of the ELL values and of ``-residual``: the port's design for
  now (an assembly of owned rows only would cut the replicated work);
- every Krylov matvec is a halo exchange between the two launches of the
  shard matrix's ``HaloOperator`` (``halo_interior``, which also packs
  the send buffer; ``all_to_all_single``; ``halo_boundary``), every norm
  and dot product a local partial and one ``all_reduce``
  (:meth:`DeviceLinearSolver.set_dof_sharding`);
- the preconditioner is built and applied replicated on the gathered
  residual, so the iterates are those of the single-device solve up to the
  order of the sums;
- the increment is gathered, and the model state stays replicated on
  every rank, as ``porepy_tpu`` keeps its host state.

A CUDA mesh is one rank per card over NCCL (``torchrun --nproc-per-node
N``); a CPU mesh is gloo, for tests. Nothing falls back from one to the
other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from porepy_tpu_torch.parallel.halo import same_device

__all__ = ["DofMesh", "ShardedNewton", "make_dof_mesh"]


@dataclass(frozen=True)
class DofMesh:
    """The 1d mesh of the dof axis: the process group, this process's rank
    in it, its size, and the rank's device."""

    group: Any
    rank: int
    size: int
    device: torch.device


def make_dof_mesh(n_devices: Optional[int] = None, devices=None) -> DofMesh:
    """The dof mesh over the default process group, which the caller must
    have initialized (``torch.distributed.init_process_group``).

    ``devices=None``: one CUDA card per rank, ``cuda:{LOCAL_RANK}`` (or the
    rank modulo the card count), over the NCCL backend; more ranks than
    cards raise. ``devices="cpu"``: every rank on the host, over gloo.
    ``n_devices``, if given, must be the world size."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_dof_mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group first"
        )
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices {n_devices} differs from the world size {size}")
    backend = str(dist.get_backend())
    if devices is None:
        if "nccl" not in backend:
            raise RuntimeError(f"a CUDA dof mesh needs the nccl backend, not {backend}")
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if size > count:
            raise RuntimeError(f"{size} ranks but {count} CUDA devices: one rank per card")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank % count)))
        torch.cuda.set_device(dev)
    elif torch.device(devices).type == "cpu":
        if "gloo" not in backend:
            raise RuntimeError(f"a CPU dof mesh needs the gloo backend, not {backend}")
        dev = torch.device("cpu")
    else:
        raise ValueError(f"devices must be None (the CUDA cards) or 'cpu', not {devices!r}")
    return DofMesh(dist.group.WORLD, rank, size, dev)


class ShardedNewton:
    """Run a model's Newton iterations with all linear algebra sharded.

    Usage, on every rank::

        model.prepare_simulation()
        sn = ShardedNewton(model, make_dof_mesh())
        model.before_nonlinear_loop()
        model.before_nonlinear_iteration()
        increment, residual_norm = sn.step()

    ``step`` assembles (replicated), solves with the model's device solver
    sharded over the mesh, and feeds the whole increment through the
    model's ``after_nonlinear_iteration`` on every rank, so that state
    bookkeeping matches the host loop. The model must live on the mesh's
    device.
    """

    def __init__(self, model, mesh: DofMesh, method: str = "gmres", dof_permutation=None) -> None:
        from porepy_tpu_torch.numerics.linalg.device_solver import DeviceLinearSolver

        self.model = model
        self.mesh = mesh
        eq = model.equation_system
        self.cs = eq.compiled_system()
        if not same_device(self.cs.device, mesh.device):
            raise ValueError(
                f"the model runs on {self.cs.device}, the mesh's rank on {mesh.device}"
            )
        if not hasattr(model, "_device_solvers"):
            model._device_solvers = {}
        if not model.linear_solver.startswith("device"):
            model.linear_solver = f"device_{method}"
        # Optional spatial dof permutation (parallel/placement.py): the
        # solver is built over permuted index tables so each rank's
        # contiguous dof shard is a spatially coherent region; vectors are
        # permuted in and the increment permuted back out.
        self.perm = None
        if dof_permutation is not None:
            from porepy_tpu_torch.parallel.placement import PermutedSystem

            self.perm = np.asarray(dof_permutation)
            self._perm_t = torch.tensor(self.perm, device=self.cs.device)
            self._psys = PermutedSystem(self.cs, self.perm)
            # The host view carries no device; its solver runs on the model's.
            self._psys.device = self.cs.device
            self.solver = DeviceLinearSolver(self._psys, method=method)
        else:
            self.solver = model._device_solver_for(self.cs)
        self.solver.set_dof_sharding(mesh)
        self.shard = self.solver.dof_shard

    def assemble(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(Jacobian nonzero data, -residual) of the whole system, computed
        on every rank."""
        return self.cs.assemble(self.model.equation_system)

    def _solve(self, data, b) -> tuple[np.ndarray, float]:
        if self.perm is not None:
            b = b[self._perm_t]
        dx, res = self.solver.solve_device(data, self.shard.own(b))
        dx_host = self.shard.gather(dx).cpu().numpy()
        if self.perm is not None:
            dx_host = dx_host[self._psys.inv]
        return dx_host, float(res)

    def step(self) -> tuple[np.ndarray, float]:
        data, b = self.assemble()
        dx_host, res = self._solve(data, b)
        self.model.after_nonlinear_iteration(dx_host)
        return dx_host, res

    def solve_once(self) -> tuple[np.ndarray, float]:
        """Assemble + solve without mutating model state (for parity tests)."""
        data, b = self.assemble()
        return self._solve(data, b)
