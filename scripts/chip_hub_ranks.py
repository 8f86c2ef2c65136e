#!/usr/bin/env python3
"""One rank of the stream hub sharded over ranks on the card (``chip_smoke.py`` phase 32, ``scripts/chip_hub_nccl.py``).

    python scripts/chip_hub_ranks.py <rank> <world> <port> <inputs.pt> <out.json> [gloo|nccl] [drive|dead]

Joins a process group of ``world`` ranks over 127.0.0.1 with its tensors
on a card: ``gloo`` puts every rank on card 0 (gloo stages CUDA
broadcasts and all-gathers through the host; NCCL refuses two ranks on one
device), ``nccl`` puts rank r on card r. Builds
``StreamHub(LabelService("res8"), data_axis="data", wire_dtype="int16")``
on its card, and leads it (rank 0) or follows it (the others).

- ``drive`` (the default): rank 0 opens a session per stream of
  ``inputs.pt``, pushes one ``push_rows`` of PCM16 rows a tick, and swaps
  in the weights of ``inputs.pt`` before tick ``swap_at``. Writes this
  rank's slots, its kernel launches over the ticks, and on rank 0 every
  answer, every close and each tick's host ms, to ``out.json``.
- ``dead`` (two ranks): after one tick rank 0 asks rank 1 to exit, waits
  until it has, and writes how its next push and ``shutdown()`` fail and how
  long the push took to (the group's timeout is ``group_timeout_s``).
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from honk_tpu_torch import use_full_f32  # noqa: E402
from honk_tpu_torch.config import StreamConfig  # noqa: E402
from honk_tpu_torch.ops import mfcc_kernel, res_kernel  # noqa: E402
from honk_tpu_torch.serve import LabelService, StreamHub  # noqa: E402


def drive(hub: StreamHub, inputs: dict, out: dict) -> None:
    pcm, chunk = inputs["pcm"], inputs["chunk"]
    sids = [hub.open() for _ in range(pcm.shape[0])]
    ticks, tick_ms = [], []
    for t in range(pcm.shape[1] // chunk):
        if t == inputs["swap_at"]:
            hub.set_variables(inputs["swap"])
        t0 = time.perf_counter()
        res = hub.push_rows(sids, pcm[:, t * chunk:(t + 1) * chunk])
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        ticks.append([res[s] for s in sids])
    out.update(ticks=ticks, tick_ms=tick_ms, closed=[hub.close(s) for s in sids])
    hub.shutdown()


def dead(hub: StreamHub, inputs: dict, out: dict, store: dist.TCPStore) -> None:
    """Rank 0: one tick on every rank, then the last rank exits and the next push must raise naming it."""
    pcm, chunk = inputs["pcm"], inputs["chunk"]
    sids = [hub.open() for _ in range(pcm.shape[0])]  # the last slots live on the last rank
    out["first_tick_ok"] = all("posterior" in r for r in hub.push_rows(sids, pcm[:, :chunk]).values())
    store.set("hub_ranks/exit", "")
    store.wait(["hub_ranks/exited"], datetime.timedelta(seconds=60))
    time.sleep(1.0)  # past the follower's os._exit
    t0 = time.perf_counter()
    try:
        hub.push_rows(sids, pcm[:, chunk:2 * chunk])
        out["push_error"] = None
    except RuntimeError as e:
        out["push_error"] = str(e)
    out["push_error_s"] = time.perf_counter() - t0
    try:
        hub.shutdown()
        out["shutdown_error"] = None
    except RuntimeError as e:
        out["shutdown_error"] = str(e)


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inputs, out_path = torch.load(sys.argv[4], weights_only=False), sys.argv[5]
    backend = sys.argv[6] if len(sys.argv) > 6 else "gloo"
    scenario = sys.argv[7] if len(sys.argv) > 7 else "drive"
    if scenario == "dead" and world != 2:
        raise SystemExit("the dead scenario runs on two ranks")
    card = rank if backend == "nccl" else 0
    torch.cuda.set_device(card)
    use_full_f32()
    timeout = datetime.timedelta(seconds=inputs.get("group_timeout_s", 300))
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=timeout)
    # A client of the group's store of its own, for the dead scenario's signals.
    store = dist.TCPStore("127.0.0.1", port, world, False, timeout=datetime.timedelta(seconds=120))
    svc = LabelService("res8", inputs["checkpoint"], device=f"cuda:{card}")
    hub = StreamHub(svc, inputs["n_slots"], StreamConfig(**inputs["cfg"]), inputs["chunk"], data_axis="data",
                    coalesce_ms=0.0, wire_dtype="int16")
    out = {"rank": rank, "backend": dist.get_backend(), "rows": list(hub._bs.rows), "card": card,
           "device": torch.cuda.get_device_name(card)}
    for mod in (mfcc_kernel, res_kernel):
        mod.launches = 0
    if scenario == "dead" and rank == 1:
        def exit_when_asked():
            store.wait(["hub_ranks/exit"], datetime.timedelta(seconds=600))
            store.set("hub_ranks/exited", "")
            os._exit(0)

        threading.Thread(target=exit_when_asked, daemon=True).start()
    if rank:
        hub.follow()
    elif scenario == "drive":
        drive(hub, inputs, out)
    else:
        dead(hub, inputs, out, store)
    torch.cuda.synchronize(card)
    out["launches"] = {"mfcc": mfcc_kernel.launches, "res_stack": res_kernel.launches,
                       "res_stack_by_mode": dict(res_kernel.launches_by_mode)}
    with open(out_path, "w") as f:
        json.dump(out, f)
    if scenario == "dead":
        os._exit(0)  # the group has lost a rank: leave without tearing it down
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
