"""Hand-fused single-phase flow steps (no operator DAG, no sparse matrices).

- :mod:`~porepy_tpu_torch.parallel.structured_flow`: the 7-point stencil
  step on Cartesian grids (K12);
- :mod:`~porepy_tpu_torch.parallel.flow_step`: the unstructured TPFA step
  with face gathers (K13).

The sharded execution of ``porepy_tpu.parallel`` (``sharded.py``,
``placement.py``) is not ported yet.
"""
