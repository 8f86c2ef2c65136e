"""Rank 0's messages to the other ranks of the world: work every rank replays in one order.

A server runs in one process, rank 0 (the *leader*), while a collective
step needs every rank of the world. The other ranks (*followers*) wait
for the leader to say what to do next, replay it on their own shards, and
meet it in the step's collectives. ``RankChannel`` carries that:

- a message (an op and a few small JSON fields) goes through the process
  group's store, under one key per follower. A follower waits for its next
  key for as long as it takes, renewing the store's wait, so hours without
  a message are fine where a follower parked in a collective would be
  aborted at the group's timeout (NCCL's watchdog, gloo's timeout);
- a follower that has read its key answers under a key of its own, and
  ``send`` returns only once every follower has answered. A follower that
  does not answer within the group's timeout (the store's) is named in the
  leader's ``RuntimeError``, and the channel refuses every later message,
  so the leader never enters a collective with a follower that is gone, on
  any backend. A follower that dies inside a collective is left to the
  backend: gloo raises on the other ranks, NCCL's watchdog aborts them at
  the group's timeout;
- tensors go on the group itself, broadcast from rank 0 only once every
  follower has the message (``broadcast_bytes``: PyTorch's NCCL and gloo
  backends both refuse ``torch.int16``), so no rank waits in a collective
  for long.

Every rank must make its channels of one name in the same order (each
rank counts them in the store), as every rank builds the same objects.
"""

from __future__ import annotations

import datetime
import json
from typing import Any

import torch
import torch.distributed as dist

from . import runtime

# How long one wait of a follower for its next message lasts before it is renewed.
_IDLE_WAIT = datetime.timedelta(hours=1)


def broadcast_bytes(t: torch.Tensor) -> torch.Tensor:
    """Broadcast the contiguous ``t`` from rank 0 into every rank's ``t`` as a uint8 view of its bytes; returns ``t``.

    Any dtype goes, on any backend: NCCL and gloo refuse ``torch.int16``.
    """
    if not t.is_contiguous():
        raise ValueError("broadcast_bytes needs a contiguous tensor")
    dist.broadcast(t.view(-1).view(torch.uint8), src=0)
    return t


class RankChannel:
    """Rank 0 tells the other ranks of the world, in order, what to replay next (see the module docstring).

    Made by every rank of a world of two or more, with the same ``name``,
    on the default process group. The leader ``send``s, every follower
    ``receive``s in the same order, and tensors go with ``broadcast_bytes``.
    """

    def __init__(self, name: str):
        self.rank, self.size = runtime.rank(), runtime.world_size()
        if self.size < 2:
            raise ValueError(f"a RankChannel needs a world of two or more ranks; this one has {self.size}")
        self._store = dist.distributed_c10d._get_default_store()  # the store init_process_group made
        n = self._store.add(f"{name}/made/{self.rank}", 1)  # this rank's n-th channel of the name: every rank's n
        self._prefix = f"{name}/{n}"
        self._seq = 0
        self._closed: str | None = None  # why the leader sends no more

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def _key(self, rank: int, seq: int) -> str:
        return f"{self._prefix}/{rank}/{seq}"

    def send(self, op: str, **fields: Any) -> None:
        """Rank 0: every follower's next message, ``{"op": op, **fields}`` (JSON).

        Returns once every follower has taken it; raises naming the
        followers that did not within the group's timeout, and from then on
        at once.
        """
        if not self.leader:
            raise RuntimeError(f"rank {self.rank} follows rank 0: only rank 0 sends")
        if self._closed is not None:
            raise RuntimeError(self._closed)
        seq, followers = self._seq, range(1, self.size)
        self._seq += 1
        msg = json.dumps({"op": op, **fields})
        for r in followers:
            self._store.set(self._key(r, seq), msg)
        taken = [self._key(r, seq) + "/taken" for r in followers]
        try:
            self._store.wait(taken, self._store.timeout)
        except dist.DistStoreError as e:
            lost = [r for r, k in zip(followers, taken) if not self._store.check([k])]
            self._closed = (f"rank {', '.join(map(str, lost))} never took message {seq} ({op!r}) of rank 0 "
                            f"within {self._store.timeout} in a world of {self.size}; rank 0 sends no more")
            raise RuntimeError(self._closed) from e
        for k in taken:
            self._store.delete_key(k)

    def receive(self) -> dict[str, Any]:
        """A follower: the next message of rank 0, waiting for it as long as it takes."""
        key = self._key(self.rank, self._seq)
        while True:
            try:
                self._store.wait([key], _IDLE_WAIT)
                break
            except dist.DistStoreError:  # the wait timed out; a lost store raises DistNetworkError
                continue
        msg = json.loads(self._store.get(key))
        self._store.delete_key(key)
        self._store.set(key + "/taken", "")
        self._seq += 1
        return msg

    def stop(self) -> None:
        """Rank 0: the followers' last message, ``stop``; returns once every follower has it. Later sends raise."""
        self.send("stop")
        self._closed = f"rank 0 stopped its {self.size - 1} followers: no message after stop"
