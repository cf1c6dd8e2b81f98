"""The pressure block that the device route's field split hands to SA-AMG
for Berre et al. (2021) 3d case 3, by flux discretization: its rows,
nonzeros and widest row after the mortar block is eliminated, and
optionally the seconds of the host SA-AMG build on it.

Under MPFA the interface equations couple the mortar fluxes of a fracture
side through its pressure traces, so the elimination is blockwise (one
dense inverse per coupled component) and folds each component densely into
the pressure block; under TPFA the mortar block is diagonal and the fold is
local. Runs on the host CPU (the first Newton system of the case on the
cut-tet lattice ``--lattice``, no card needed)::

    python -m porepy_tpu_torch.applications.benchmarking.fold_width --flux tpfa --lattice 6 14 6
    python -m porepy_tpu_torch.applications.benchmarking.fold_width --flux mpfa --lattice 6 14 6 --build

Refinement level 0 is the lattice (9, 20, 9). The MPFA fold grows fast
with the lattice: its memory is the caller's to watch.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


class _Captured(Exception):
    pass


def folded_block(flux: str, lattice, build: bool = False) -> dict:
    """The first block that the first solve of case 3 on ``lattice`` by
    ``flux`` hands to ``amg.build_hierarchy`` (the pressure block): ``n``,
    ``nnz``, ``widest`` (the most nonzeros of a row) and, with ``build``,
    ``build_s`` (the host build's seconds); the run stops there. It runs on
    one thread with ``amg.build_hierarchy`` replaced, and restores both."""
    import torch

    import porepy_tpu_torch as pt
    from porepy_tpu_torch.applications.benchmarking.cases import build_flow_benchmark_3d_case_3, fb3d3_lattice
    from porepy_tpu_torch.numerics.linalg import amg

    block: dict = {}
    build_hierarchy = amg.build_hierarchy

    def capture(A, *args, **kwargs):
        A = A.tocsr()
        block.update(n=A.shape[0], nnz=int(A.nnz), widest=int(np.diff(A.indptr).max()))
        if build:
            tic = time.perf_counter()
            build_hierarchy(A, *args, **kwargs)
            block["build_s"] = time.perf_counter() - tic
        raise _Captured

    Model, params = build_flow_benchmark_3d_case_3(device="cpu", grid=fb3d3_lattice(tuple(lattice)))
    params["flux_discretization"] = flux
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    amg.build_hierarchy = capture
    try:
        model = Model(params)
        pt.run_time_dependent_model(model, params)
    except _Captured:
        pass
    finally:
        amg.build_hierarchy = build_hierarchy
        torch.set_num_threads(threads)
    return block


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--flux", choices=("tpfa", "mpfa"), default="tpfa")
    parser.add_argument("--lattice", type=int, nargs=3, default=(6, 14, 6))
    parser.add_argument("--build", action="store_true", help="time the host SA-AMG build too")
    args = parser.parse_args(argv)
    b = folded_block(args.flux, args.lattice, args.build)
    build = f", host SA-AMG build {b['build_s']:.1f} s" if "build_s" in b else ""
    print(f"{args.flux} at {tuple(args.lattice)}: the pressure block of {b['n']} rows, {b['nnz']} nonzeros "
          f"({b['nnz'] / b['n']:.1f} a row, the widest {b['widest']}){build}")


if __name__ == "__main__":
    main()
