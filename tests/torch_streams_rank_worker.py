"""One rank of the sharded stream hub's tests (``tests/test_torch_streams_ranks.py``).

    python tests/torch_streams_rank_worker.py <scenario> <rank> <world> <port> <spec.pt> <out.pt>

Joins a gloo process group of ``world`` ranks over 127.0.0.1 and builds
``StreamHub(..., data_axis="data")`` on the port's res8-narrow service
(the weights in ``spec.pt``, made by the test from seeded flax weights).
Rank 0 drives the hub, the other ranks ``follow()``. Scenarios:

- ``drive``: ``drive()`` below once per wire and mode (float32 and int16,
  sync and pipelined), then a hub with fewer slots than ranks, refused;
- ``idle``: the group's timeout is 2 s; rank 0 serves the hub over HTTP,
  waits past the timeout with nothing to do, then opens sessions and
  pushes ticks through ``/stream/push_bin``;
- ``dead``: rank 0 pushes a tick, asks the test to kill rank 1, waits for
  it, and records how its next push and ``shutdown()`` fail.

Each rank writes what it saw to ``out.pt``. ``drive`` is also what the
test runs in its own process for a world of one. Imports nothing of JAX.
"""

import datetime
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from honk_tpu_torch.config import StreamConfig  # noqa: E402
from honk_tpu_torch.serve import LabelService, StreamHub  # noqa: E402
from honk_tpu_torch.serve.http import make_handler  # noqa: E402

MODES = [(wire, pipelined) for wire in ("float32", "int16") for pipelined in (False, True)]


def drive(hub, spec: dict, swap=None) -> dict:
    """Rank 0's session script, on any hub with the JAX hub's methods.

    ``spec["pcm"]`` holds one PCM16 stream per session (the last row for the
    reopened one); each tick pushes the sessions whose turn it is (a mask
    that changes from tick to tick), as int16 rows on the int16 wire and as
    their exact float32 values (x / 32768) on the float wire. At tick
    ``swap_at`` the weights become ``swap`` (when given), at ``reopen_at``
    session 0 (the first opened: the slab's last slot, on the last rank)
    is closed and a new session opens on its slot and starts the last row.
    Returns every response and every close, by session index.
    """
    pcm = spec["pcm"]
    n_sessions, chunk = pcm.shape[0] - 1, hub.chunk
    int16 = hub.wire_dtype == np.int16
    sids = [hub.open() for _ in range(n_sessions)]
    streams = list(range(n_sessions))  # the pcm row each session index reads
    cursor = [0] * n_sessions
    ticks, closed = [], {}
    for t in range(spec["n_ticks"]):
        if t == spec["swap_at"] and swap is not None:
            hub.set_variables(swap)
        if t == spec["reopen_at"]:
            closed["0"] = hub.close(sids[0])
            sids.append(hub.open())
            reopened_slot = hub._sessions[sids[-1]].slot
            streams.append(n_sessions)
            cursor.append(0)
            sids[0] = None
        active = [i for i, sid in enumerate(sids) if sid is not None and (t + i) % 4 != 3]
        rows = np.stack([pcm[streams[i], cursor[i] * chunk:(cursor[i] + 1) * chunk] for i in active])
        if not int16:
            rows = rows.astype(np.float32) / np.float32(32768.0)
        res = hub.push_rows([sids[i] for i in active], rows)
        ticks.append({str(i): res[sids[i]] for i in active})
        for i in active:
            cursor[i] += 1
    for i, sid in enumerate(sids):
        if sid is not None:
            closed[str(i)] = hub.close(sid)
    return {"ticks": ticks, "closed": closed, "reopened_slot": reopened_slot}


def _service(spec: dict) -> LabelService:
    return LabelService("res8-narrow", spec["variables"], device="cpu")


def _hub(svc, spec: dict, wire: str = "float32", pipelined: bool = False, n_slots: int | None = None) -> StreamHub:
    return StreamHub(svc, n_slots or spec["n_slots"], StreamConfig(**spec["cfg"]), spec["chunk"], data_axis="data",
                     wire_dtype=wire, pipelined=pipelined, coalesce_ms=0.0)


def scenario_drive(rank: int, world: int, spec: dict) -> dict:
    svc = _service(spec)
    out: dict = {"rank": rank, "runs": {}}
    for wire, pipelined in MODES:
        hub = _hub(svc, spec, wire, pipelined)
        out.setdefault("rows", hub._bs.rows)
        if rank == 0:
            out["runs"][f"{wire}/{'pipelined' if pipelined else 'sync'}"] = drive(hub, spec, spec["swapped"])
            hub.shutdown()
        else:
            if wire == "float32" and not pipelined:
                try:
                    hub.open()
                except RuntimeError as e:
                    out["open_on_follower"] = str(e)
            t0 = time.monotonic()
            hub.follow()
            out.setdefault("follow_returned_s", []).append(time.monotonic() - t0)
    try:
        _hub(svc, spec, n_slots=world - 1)
    except ValueError as e:
        out["too_few_slots"] = str(e)
    return out


def scenario_idle(rank: int, world: int, spec: dict) -> dict:
    from http.server import ThreadingHTTPServer

    svc = _service(spec)
    hub = _hub(svc, spec, "int16")
    if rank:
        hub.follow()
        return {"rank": rank}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc, None, hub))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body, ctype="application/json"):
        req = urllib.request.Request(url + path, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    time.sleep(spec["idle_s"])  # the followers wait, idle, past the group's timeout
    pcm = spec["pcm"]
    n = pcm.shape[0] - 1
    sids = [post("/stream/open", b"{}")["stream_id"] for _ in range(n)]
    ticks = []
    for t in range(spec["n_ticks"]):
        header = json.dumps({"stream_ids": sids, "posterior": True}).encode()
        rows = pcm[:n, t * spec["chunk"]:(t + 1) * spec["chunk"]]
        out = post("/stream/push_bin", len(header).to_bytes(4, "little") + header + rows.astype("<i2").tobytes(),
                   "application/octet-stream")
        ticks.append({str(i): out["results"][s] for i, s in enumerate(sids)})
    closed = {str(i): post("/stream/close", json.dumps({"stream_id": s}).encode()) for i, s in enumerate(sids)}
    httpd.shutdown()
    httpd.server_close()
    hub.shutdown()
    th.join(timeout=30)
    return {"rank": rank, "ticks": ticks, "closed": closed}


def scenario_dead(rank: int, world: int, spec: dict, out_path: str) -> dict:
    svc = _service(spec)
    hub = _hub(svc, spec)
    if rank:
        hub.follow()  # killed in here by the test
        return {"rank": rank}
    pcm = spec["pcm"].astype(np.float32) / np.float32(32768.0)
    sid = hub.open()  # the last slot: rank 1's
    first = hub.push(sid, pcm[0, :spec["chunk"]])
    # Ask the test to kill rank 1, and wait until it has.
    open(out_path + ".kill", "w").close()
    deadline = time.monotonic() + 60
    while not os.path.exists(out_path + ".killed") and time.monotonic() < deadline:
        time.sleep(0.05)
    out = {"rank": rank, "first": first}
    t0 = time.monotonic()
    try:
        hub.push(sid, pcm[0, spec["chunk"]:2 * spec["chunk"]])
        out["push_error"] = None
    except RuntimeError as e:
        out["push_error"] = str(e)
    out["push_error_s"] = time.monotonic() - t0
    try:
        hub.shutdown()
        out["shutdown_error"] = None
    except RuntimeError as e:
        out["shutdown_error"] = str(e)
    return out


def main() -> int:
    scenario, rank, world, port, spec_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    spec = torch.load(spec_path, weights_only=False)
    timeout = datetime.timedelta(seconds=spec.get("group_timeout_s", 300))
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                         rank=rank, timeout=timeout)
    if scenario == "drive":
        out = scenario_drive(rank, world, spec)
    elif scenario == "idle":
        out = scenario_idle(rank, world, spec)
    else:
        out = scenario_dead(rank, world, spec, out_path)
    torch.save(out, out_path)
    if scenario == "dead":
        os._exit(0)  # the group has lost a rank: leave without tearing it down
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
