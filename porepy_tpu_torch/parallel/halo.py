"""Row shards of the dof axis and the halo exchange of the sharded solve (K19).

``porepy_tpu`` shards its Krylov solve by pinning every length-n vector
and the ELL value array to a ``NamedSharding`` over the dofs; GSPMD then
inserts the gathers of the operand vector that each matvec needs. The port
makes that exchange explicit. Rank ``r`` of ``P`` owns the contiguous rows
``[lo, hi)`` with ``chunk = ceil(n / P)``, ``lo = r chunk`` (the last shard
shorter, possibly empty), the split that
:func:`porepy_tpu_torch.parallel.placement.nnz_locality` assumes. A matvec
reads the owned entries ``x_own = x[lo:hi]`` and the *halo*: the remote
entries its rows' columns name. Its plan is built once on the host:

- the remote columns of the rows ``[lo, hi)``, sorted, hence grouped by
  the rank that owns them (what this rank receives from each rank);
- what every other rank needs from this one (what it sends), by one
  ``all_to_all_single`` of the counts and one of the indices
  (:func:`exchange_plan`), or, for all ranks of one process, by
  transposing the lists (:func:`local_plans`);
- the row shard's column table remapped: an owned column ``c`` to
  ``c - lo``, a remote one to ``n_own + k`` (its place in the halo), the
  padding column ``n`` to ``n_own + n_halo``;
- the shard's rows split into *interior* rows (every column owned or
  padding) and *boundary* rows (at least one column in the halo).

A shard matrix is a :class:`~porepy_tpu_torch.kernels.HaloOperator`, made
once per matrix (:meth:`DofShard.operator`). Each matvec is then one
launch that packs the send entries and computes the interior rows, one
``all_to_all_single`` into the operator's receive buffer, and one launch
for the boundary rows from ``x_own`` and the received halo (not
concatenated); with no halo, the first launch is the whole matvec.
:class:`DofShard` holds the plan on a rank's device with these steps and
the all-reduced norms and dot products of the solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "shard_bounds",
    "HaloPlan",
    "local_plans",
    "exchange_local",
    "matvec_local",
    "exchange_plan",
    "same_device",
    "DofShard",
]


def shard_bounds(n: int, size: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` of each of ``size`` contiguous shards of ``n`` rows,
    ``ceil(n / size)`` rows each, the last ones shorter or empty."""
    chunk = -(-n // size)
    return [(min(r * chunk, n), min((r + 1) * chunk, n)) for r in range(size)]


def _needs(ell_col: np.ndarray, n: int, size: int, lo: int, hi: int) -> list[np.ndarray]:
    """The sorted global columns outside ``[lo, hi)`` that the rows
    ``[lo, hi)`` of the padded column table read, split by owning rank."""
    c = np.unique(ell_col[lo:hi])
    c = c[(c < n) & ((c < lo) | (c >= hi))]
    chunk = -(-n // size)
    split = np.searchsorted(c // chunk, np.arange(size + 1))
    return [c[split[q] : split[q + 1]] for q in range(size)]


@dataclass
class HaloPlan:
    """One rank's halo plan: its rows ``[lo, hi)``, the remapped column
    table ``col`` (``(n_own, K)`` int32), the entries it receives from and
    sends to each rank (``recv_counts``, ``send_counts``, in rank order),
    the local rows of ``x_own`` it sends (``send_idx``, int32, grouped by
    destination), ``exchange``: whether any rank has a halo at all, the
    same on every rank, and the local rows that read no halo entry
    (``interior``) and those that read one (``boundary``), int32,
    increasing: with no halo every row is interior."""

    lo: int
    hi: int
    col: np.ndarray
    recv_counts: list
    send_counts: list
    send_idx: np.ndarray
    exchange: bool
    interior: np.ndarray
    boundary: np.ndarray

    @property
    def n_own(self) -> int:
        return self.hi - self.lo

    @property
    def n_halo(self) -> int:
        return int(sum(self.recv_counts))

    @classmethod
    def from_lists(cls, ell_col, n, lo, hi, needs, sends, exchange) -> "HaloPlan":
        halo = np.concatenate(needs) if needs else np.zeros(0, np.int64)
        n_own = hi - lo
        col = np.asarray(ell_col[lo:hi], dtype=np.int64)
        local = np.full(col.shape, n_own + halo.size, dtype=np.int64)
        own = (col >= lo) & (col < hi)
        local[own] = col[own] - lo
        remote = (col < n) & ~own
        local[remote] = n_own + np.searchsorted(halo, col[remote])
        send = np.concatenate(sends) if sends else np.zeros(0, np.int64)
        reads_halo = remote.any(axis=1)
        return cls(
            lo=lo,
            hi=hi,
            col=local.astype(np.int32),
            recv_counts=[int(v.size) for v in needs],
            send_counts=[int(v.size) for v in sends],
            send_idx=(send - lo).astype(np.int32),
            exchange=bool(exchange),
            interior=np.flatnonzero(~reads_halo).astype(np.int32),
            boundary=np.flatnonzero(reads_halo).astype(np.int32),
        )

    def tensors(self, device) -> tuple:
        """``(col, send_idx, interior, boundary)`` on ``device``: the tables
        a :class:`~porepy_tpu_torch.kernels.HaloOperator` takes after the
        values."""
        return tuple(
            torch.tensor(a, device=device) for a in (self.col, self.send_idx, self.interior, self.boundary)
        )


def local_plans(ell_col: np.ndarray, n: int, size: int) -> list[HaloPlan]:
    """The plans of all ``size`` ranks, built in one process from the whole
    padded column table (``(n, K)``, padding ``n``): what rank ``q`` sends
    to rank ``r`` is what ``r`` needs from ``q``."""
    ell_col = np.asarray(ell_col)
    bounds = shard_bounds(n, size)
    needs = [_needs(ell_col, n, size, lo, hi) for lo, hi in bounds]
    exchange = any(v.size for row in needs for v in row)
    return [
        HaloPlan.from_lists(
            ell_col, n, lo, hi, needs[r], [needs[q][r] for q in range(size)], exchange
        )
        for r, (lo, hi) in enumerate(bounds)
    ]


def exchange_local(plans: list[HaloPlan], sends: list[torch.Tensor]) -> list[torch.Tensor]:
    """The halos that one ``all_to_all_single`` would deliver, in one
    process: ``sends[q]`` is rank ``q``'s packed send buffer."""
    pieces = [list(torch.split(s, p.send_counts)) for p, s in zip(plans, sends)]
    return [torch.cat([pieces[q][r] for q in range(len(plans))]) for r in range(len(plans))]


def matvec_local(plans: list[HaloPlan], ops: list, x_owns: list[torch.Tensor]) -> list[torch.Tensor]:
    """The matvecs of all ranks in one process, each rank's through its
    :class:`~porepy_tpu_torch.kernels.HaloOperator`: every interior launch,
    the exchange (:func:`exchange_local`) into the operators' receive
    buffers, every boundary launch."""
    ys = [op.interior(x) for op, x in zip(ops, x_owns)]
    for op, h in zip(ops, exchange_local(plans, [op.send for op in ops])):
        op.recv.copy_(h)
    return [op.boundary(x, y) for op, x, y in zip(ops, x_owns, ys)]


def exchange_plan(ell_col: np.ndarray, n: int, mesh) -> HaloPlan:
    """This rank's plan over ``mesh``'s process group: its needs from its
    own rows, what the others need from it by ``all_to_all_single`` (first
    the counts, then the global indices)."""
    import torch.distributed as dist

    ell_col = np.asarray(ell_col)
    lo, hi = shard_bounds(n, mesh.size)[mesh.rank]
    needs = _needs(ell_col, n, mesh.size, lo, hi)
    dev = mesh.device
    recv_counts = torch.tensor([v.size for v in needs], dtype=torch.int64, device=dev)
    send_counts = torch.empty_like(recv_counts)
    dist.all_to_all_single(send_counts, recv_counts, group=mesh.group)
    send_counts = send_counts.cpu().tolist()
    total = torch.tensor([sum(send_counts) + int(recv_counts.sum())], device=dev)
    dist.all_reduce(total, group=mesh.group)
    exchange = int(total.item()) > 0
    send = torch.empty(sum(send_counts), dtype=torch.int64, device=dev)
    if exchange:
        need = torch.tensor(np.concatenate(needs), dtype=torch.int64, device=dev)
        dist.all_to_all_single(
            send, need,
            output_split_sizes=send_counts,
            input_split_sizes=recv_counts.cpu().tolist(),
            group=mesh.group,
        )
    sends = np.split(send.cpu().numpy(), np.cumsum(send_counts)[:-1])
    return HaloPlan.from_lists(ell_col, n, lo, hi, needs, sends, exchange)


def same_device(a, b) -> bool:
    """Whether two device specs name one device (``"cuda"`` is the current
    CUDA device)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


class DofShard:
    """A rank's part of a dof-sharded solve over ``mesh`` (any object with
    ``group``, ``rank``, ``size`` and ``device``): its plan on the device,
    the halo matvec, and the reductions of the Krylov iteration, each a
    local partial and one all-reduce, so that every rank takes the same
    branches. ``ell_sel``/``ell_col`` are the owned rows of the solver's
    global ELL tables (the value gather and the Ruiz column scales)."""

    def __init__(self, mesh, plan: HaloPlan, n: int, ell_sel, ell_col) -> None:
        dev = torch.device(mesh.device)
        self.mesh = mesh
        self.plan = plan
        self.n = n
        self.lo, self.hi = plan.lo, plan.hi
        self.chunk = -(-n // mesh.size)
        self.tables = plan.tensors(dev)
        self.ell_sel = ell_sel[self.lo : self.hi]
        self.ell_col = ell_col[self.lo : self.hi]

    def operator(self, val: torch.Tensor):
        """The :class:`~porepy_tpu_torch.kernels.HaloOperator` of the owned
        rows ``val`` of a matrix's ELL values (global column order), made
        once per matrix."""
        from porepy_tpu_torch import kernels

        return kernels.HaloOperator(val, *self.tables, self.plan.n_halo)

    def matvec(self, op, x_own: torch.Tensor) -> torch.Tensor:
        """The owned rows of ``A x`` through ``op`` (:meth:`operator`): the
        interior rows and the send buffer, the exchange into ``op.recv``,
        then the boundary rows."""
        y = op.interior(x_own)
        if self.plan.exchange:
            import torch.distributed as dist

            dist.all_to_all_single(
                op.recv, op.send,
                output_split_sizes=self.plan.recv_counts,
                input_split_sizes=self.plan.send_counts,
                group=self.mesh.group,
            )
        return op.boundary(x_own, y)

    def _sum(self, t: torch.Tensor, op=None) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=self.mesh.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (the finished sums of an
        FGMRES Arnoldi step's phases, :class:`~porepy_tpu_torch.kernels.
        FgmresArnoldi`); on one rank ``t`` as it is."""
        return self._sum(t)

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """The global 2-norm, a 0-d tensor: the local norms' squares summed.
        On one rank this is the local norm to the bit (``sqrt(x * x) == x``
        in binary floating point)."""
        nrm = torch.linalg.vector_norm(v)
        return self._sum((nrm * nrm).reshape(1)).sqrt().reshape(())

    def dot(self, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``A @ v`` over the global rows: ``A`` is ``(k, n_own)``."""
        return self._sum(A @ v)

    def all_finite(self, d: torch.Tensor) -> torch.Tensor:
        """Whether every rank's ``d`` is finite, a 0-d bool tensor."""
        import torch.distributed as dist

        ok = torch.all(torch.isfinite(d)).to(torch.int32).reshape(1)
        return self._sum(ok, dist.ReduceOp.MIN)[0].bool()

    def gather(self, v_own: torch.Tensor) -> torch.Tensor:
        """The whole vector on every rank, from each rank's owned rows."""
        import torch.distributed as dist

        padded = torch.nn.functional.pad(v_own, (0, self.chunk - v_own.shape[0]))
        parts = [torch.empty_like(padded) for _ in range(self.mesh.size)]
        dist.all_gather(parts, padded, group=self.mesh.group)
        return torch.cat(parts)[: self.n]

    def own(self, v: torch.Tensor) -> torch.Tensor:
        """The owned rows of a whole vector."""
        return v[self.lo : self.hi]
