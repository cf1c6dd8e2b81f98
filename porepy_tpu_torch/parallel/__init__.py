"""Hand-fused flow steps and the sharded execution of the framework path.

- :mod:`~porepy_tpu_torch.parallel.structured_flow`: the 7-point stencil
  step on Cartesian grids (K12);
- :mod:`~porepy_tpu_torch.parallel.flow_step`: the unstructured TPFA step
  with face gathers (K13);
- :mod:`~porepy_tpu_torch.parallel.sharded`: ``ShardedNewton``, the Newton
  iteration with its Krylov solve sharded over the ranks of a
  ``torch.distributed`` process group (K19), on the halo exchange of
  :mod:`~porepy_tpu_torch.parallel.halo`;
- :mod:`~porepy_tpu_torch.parallel.placement`: the spatial dof permutation
  that makes each rank's rows a coherent region (a copy of the host module).
"""
