"""The data-parallel mesh on ``torch.distributed`` (counterpart of ``honk_tpu.parallel.mesh``).

The JAX package's ``data`` axis is GSPMD over one global batch: XLA
computes what one device computes on the whole batch, with the batch's
rows spread over the devices, the parameters replicated, and the
all-reduces inserted where the program needs them. The port spells that
out with one process per device:

- parameters are replicated: ``replicate`` broadcasts rank 0's and checks
  that every rank held the same;
- each rank takes its rows of the global batch, ``shard_rows(n)``: blocks
  of ``ceil(n / size)`` rows in rank order, the last one shorter (GSPMD's
  uneven tail; a rank with no row is refused), so reductions add sums and
  counts, never means;
- BN all-reduces its float64 sums in place, once in the forward and once
  in the backward (``models/res.py``, ``_BatchNorm``);
- ``all_reduce_grads`` is the step's one all-reduce of the flattened
  float64 gradients; ``all_gather_rows`` puts the rows of the ranks back in
  order.

At size 1 every collective is the identity and nothing is communicated,
so a one-rank run computes exactly what the single-device code computes.
``collectives``, when a list, records ``(op, numel, element_size)`` of
each collective launched (the count tests hold against the JAX step's
all-reduces; numel times element_size is its bytes).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import runtime


@dataclasses.dataclass
class DataMesh:
    """A 1-D mesh of ``size`` ranks along ``axis_name``; this process is ``rank``."""

    axis_name: str
    rank: int
    size: int
    group: object = None  # the process group (None: the default group, or no group at size 1)
    collectives: list | None = None

    def shard_rows(self, n: int) -> tuple[int, int]:
        """This rank's rows ``[start, stop)`` of ``n`` rows; raises if some rank would get none."""
        chunk = -(-n // self.size)
        if (self.size - 1) * chunk >= n:
            raise ValueError(f"{n} rows in blocks of {chunk} leave a rank of {self.size} without a row")
        start = min(self.rank * chunk, n)
        return start, min(start + chunk, n)

    def _record(self, op: str, t: torch.Tensor) -> None:
        if self.collectives is not None:
            self.collectives.append((op, t.numel(), t.element_size()))

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks, no autograd (counts, gradients)."""
        if self.size > 1:
            self._record("all_reduce", t)
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_grads(self, grads: list[torch.Tensor]) -> None:
        """Sum ``grads`` (each a parameter's float64 gradient over this rank's rows) over the ranks, in
        place: one all-reduce of them all, flattened."""
        if self.size == 1:
            return
        flat = self.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def all_gather_rows(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The ``n`` rows whose shards (``shard_rows(n)``) the ranks hold, in order, on every rank."""
        if self.size == 1:
            return t
        chunk = -(-n // self.size)
        pad = t.new_zeros((chunk,) + tuple(t.shape[1:]))
        pad[: t.shape[0]] = t
        parts = [torch.empty_like(pad) for _ in range(self.size)]
        self._record("all_gather", pad)
        dist.all_gather(parts, pad, group=self.group)
        return torch.cat(parts)[:n]

    def replicate(self, module: torch.nn.Module) -> torch.nn.Module:
        """Broadcast rank 0's parameters and buffers to every rank; raises if any rank held others."""
        if self.size == 1:
            return module
        differ = torch.zeros((), dtype=torch.int64)
        with torch.no_grad():
            for t in module.state_dict().values():
                mine = t.detach().clone()
                self._record("broadcast", t)
                dist.broadcast(t, src=0, group=self.group)
                differ += int(not torch.equal(mine, t))
        flag = differ.to(next(module.parameters()).device)
        self.all_reduce_(flag)
        if int(flag):
            raise ValueError(f"replicate: {int(flag)} tensors differed from rank 0's across the ranks")
        return module


def make_data_mesh(n_devices: int = 0, axis_name: str = "data") -> DataMesh:
    """The 1-D mesh over the process group's ranks along ``axis_name``.

    ``n_devices`` 0 means every rank of the world; any other value must be
    the world size (one process per device), or this raises.
    """
    size = runtime.world_size()
    if n_devices not in (0, size):
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} ranks, one per device; this world has {size} "
            "(start the ranks with --n_devices, or --coordinator / --num-processes / --process-id)"
        )
    return DataMesh(axis_name, runtime.rank(), size)
