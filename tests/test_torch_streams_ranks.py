"""The port's stream hub sharded over ranks (``StreamHub(data_axis="data")``), on the CPU.

Every rank builds the hub; rank 0 leads it and the other ranks
``follow()`` (``tests/torch_streams_rank_worker.py``, gloo ranks over
127.0.0.1, under ``torch_ranks.run_ranks``' timeout). The session script
(``drive``) opens seven sessions on eight slots, pushes a mask that
changes every tick, swaps the weights at tick 4, closes the first session
at tick 6 and opens a new one on its slot, for each wire (float32, int16)
and mode (sync, pipelined). Gates, the repo's own:

- a world of one with ``data_axis`` is the unsharded hub, bit for bit
  (``tests/test_torch_parallel.py``);
- 2 and 4 ranks within 1e-6 of one rank, events equal (the same file's
  streaming gate);
- the JAX hub, sharded over 2 and 4 of the 8 virtual CPU devices, within
  1e-5 on float chunks and 2e-3 on the int16 wire
  (``tests/test_torch_streams.py``), events equal. The JAX hub shards only
  when every push comes from the thread that holds its mesh: pushed from
  another thread, as its HTTP server does, its step raises (pinned below).

Then the protocol's own cases: a reopened slot of the last rank is a fresh
stream, a weight swap reaches every rank from the next tick on, a follower
idle past a 2 s group timeout then serves ``/stream/push_bin``, a dead
follower makes rank 0's next push raise naming it, fewer slots than ranks
are refused, ``shutdown`` releases every follower, and only rank 0 leads.
"""

import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_streams_rank_worker as W
from torch_ranks import REPO, free_port, run_ranks
from honk_tpu.config import StreamConfig as JStreamConfig
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.parallel import make_data_mesh as jmake_data_mesh
from honk_tpu.serve import LabelService as JLabelService
from honk_tpu.serve import StreamHub as JStreamHub
from honk_tpu_torch.config import StreamConfig
from honk_tpu_torch.models import find_config, find_model, from_flax_variables, load_state_dict
from honk_tpu_torch.serve import LabelService, StreamHub
from honk_tpu_torch.stream import Streamer

RANKS_ATOL = 1e-6
JAX_ATOL = {"float32": 1e-5, "int16": 2e-3}
MODES = [f"{wire}/{'pipelined' if p else 'sync'}" for wire, p in W.MODES]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Tiny tensors one op at a time, as in ``tests/test_torch_streams.py``."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flax_variables(seed: int) -> dict:
    fmodel = jfind_model("res8-narrow")(config=jfind_config("res8-narrow"))
    return jax.tree.map(np.asarray, dict(
        fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 101, 40), jnp.float32), train=False)))


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    fvars = _flax_variables(0)
    fswapped = jax.tree.map(lambda v: v * np.float32(1.25), fvars)
    rng = np.random.default_rng(5)
    n_ticks, chunk = 10, 3200
    s = {
        "variables": from_flax_variables(fvars), "swapped": from_flax_variables(fswapped),
        "cfg": dict(smoothing_window=3, detection_threshold=0.1, min_gap_windows=2),
        "chunk": chunk, "n_slots": 8, "n_ticks": n_ticks, "swap_at": 4, "reopen_at": 6,
        # Seven sessions' streams and the reopened session's.
        "pcm": np.clip(rng.standard_normal((8, n_ticks * chunk)) * 0.3 * 32768, -32768, 32767).astype(np.int16),
        "idle_s": 5.0,
    }
    path = tmp_path_factory.mktemp("spec") / "spec.pt"
    torch.save(s, path)
    return {"spec": s, "path": str(path), "flax": fvars, "flax_swapped": fswapped}


def _ranks(spec, scenario: str, world: int, tmp, during=None, returncodes=None, **extra) -> list[dict]:
    path = spec["path"]
    if extra:
        path = str(tmp / f"spec-{scenario}.pt")
        torch.save({**spec["spec"], **extra}, path)
    port = free_port()
    outs = [str(tmp / f"{scenario}{r}.pt") for r in range(world)]
    run_ranks([[sys.executable, os.path.join(REPO, "tests", "torch_streams_rank_worker.py"), scenario, str(r),
                str(world), str(port), path, outs[r]] for r in range(world)], during, returncodes)
    return [torch.load(o, weights_only=False) if os.path.exists(o) else None for o in outs]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, spec, tmp_path_factory):
    """The drive scenario on ``world`` gloo ranks: every rank's record."""
    world = request.param
    return world, _ranks(spec, "drive", world, tmp_path_factory.mktemp(f"world{world}"))


@pytest.fixture(scope="module")
def one(spec):
    """The drive scenario in this process (a world of one): with data_axis, without it, and without the swap."""
    s = spec["spec"]
    svc = LabelService("res8-narrow", s["variables"], device="cpu")
    out = {}
    for (wire, pipelined), mode in zip(W.MODES, MODES):
        for axis in ("data", None):
            hub = StreamHub(svc, s["n_slots"], StreamConfig(**s["cfg"]), s["chunk"], data_axis=axis,
                            wire_dtype=wire, pipelined=pipelined, coalesce_ms=0.0)
            out[(mode, axis)] = W.drive(hub, s, s["swapped"])
            hub.shutdown()
    hub = W._hub(svc, s)
    out["no_swap"] = W.drive(hub, s)
    hub.shutdown()
    return out


def _assert_same_run(got: dict, ref: dict, atol: float) -> None:
    """Posteriors within ``atol``, everything else (labels, pending, events by time and label) equal."""
    assert len(got["ticks"]) == len(ref["ticks"])
    for t, (a, b) in enumerate(zip(got["ticks"], ref["ticks"])):
        assert a.keys() == b.keys(), t
        for i in a:
            pa, pb = a[i].get("posterior"), b[i].get("posterior")
            assert (pa is None) == (pb is None), (t, i)
            if pa is not None:
                np.testing.assert_allclose(pa, pb, atol=atol, rtol=0, err_msg=f"tick {t} session {i}")
                assert a[i]["label"] == b[i]["label"], (t, i)
            assert a[i].get("pending") == b[i].get("pending"), (t, i)
            assert [(e["time_s"], e["label"]) for e in a[i]["events"]] == [
                (e["time_s"], e["label"]) for e in b[i]["events"]], (t, i)
    assert got["closed"].keys() == ref["closed"].keys()
    for i in got["closed"]:
        ea, eb = got["closed"][i]["events"], ref["closed"][i]["events"]
        assert [(e["time_s"], e["label"]) for e in ea] == [(e["time_s"], e["label"]) for e in eb], i
        assert all(abs(x["prob"] - y["prob"]) <= max(atol, 1e-4) for x, y in zip(ea, eb)), i


@pytest.mark.parametrize("mode", MODES)
def test_one_rank_with_data_axis_is_the_unsharded_hub(one, mode):
    assert one[(mode, "data")] == one[(mode, None)]
    assert sum(len(c["events"]) for c in one[(mode, None)]["closed"].values()) >= 1, "the scenario must fire"


@pytest.mark.parametrize("mode", MODES)
def test_ranks_equal_one_rank(ranks, one, mode):
    world, outs = ranks
    block = 8 // world
    assert [o["rows"] for o in outs] == [(r * block, (r + 1) * block) for r in range(world)]
    _assert_same_run(outs[0]["runs"][mode], one[(mode, "data")], RANKS_ATOL)


def _jax_run(spec, world: int, mode: str) -> dict:
    """The drive scenario through the JAX hub, sharded over ``world`` virtual devices, on its mesh's thread."""
    s = spec["spec"]
    wire, sched = mode.split("/")
    svc = JLabelService("res8-narrow", spec["flax"], precision=None)
    with jax.set_mesh(jmake_data_mesh(world, "data")):
        hub = JStreamHub(svc, s["n_slots"], JStreamConfig(**s["cfg"]), s["chunk"], data_axis="data",
                         wire_dtype=wire, pipelined=sched == "pipelined", coalesce_ms=0.0)
        run = W.drive(hub, s, spec["flax_swapped"])
        devices = {sh.device for sh in hub._state.feat_ring.addressable_shards}
    assert len(devices) == world, f"the JAX hub's slab lives on {len(devices)} devices"
    return run


@pytest.mark.parametrize("mode", MODES)
def test_ranks_equal_the_jax_hub_sharded(ranks, spec, mode):
    world, outs = ranks
    _assert_same_run(outs[0]["runs"][mode], _jax_run(spec, world, mode), JAX_ATOL[mode.split("/")[0]])


def test_the_jax_hub_shards_only_on_its_mesh_thread(spec):
    """The reference's fault, pinned: pushed from a thread that does not hold
    the mesh (an HTTP handler's), the sharded JAX hub's step raises."""
    s = spec["spec"]
    svc = JLabelService("res8-narrow", spec["flax"], precision=None)
    rows = s["pcm"][:2, : s["chunk"]].astype(np.float32) / np.float32(32768.0)
    with jax.set_mesh(jmake_data_mesh(2, "data")):
        hub = JStreamHub(svc, 4, JStreamConfig(**s["cfg"]), s["chunk"], data_axis="data")
        sids = [hub.open() for _ in range(2)]
        errors = []

        def push():
            try:
                hub.push_rows(sids, rows)
            except RuntimeError as e:
                errors.append(str(e))

        th = threading.Thread(target=push)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive()
        assert len(errors) == 1 and "requires a non-empty mesh" in errors[0], errors
        hub.push_rows(sids, rows)  # the mesh's own thread
        assert len({sh.device for sh in hub._state.feat_ring.addressable_shards}) == 2


def _model(variables):
    return load_state_dict(find_model("res8-narrow")(find_config("res8-narrow")), variables).eval()


def _check_reopened(run: dict, spec: dict) -> None:
    """The session opened on the closed session's slot (the slab's last) scores like a fresh Streamer."""
    s = spec["spec"]
    assert run["reopened_slot"] == s["n_slots"] - 1
    streamer = Streamer(_model(s["swapped"]), None, StreamConfig(**s["cfg"]), s["chunk"])
    state, n = streamer.reset(), 0
    new = str(len(s["pcm"]) - 1)  # the reopened session's index, which reads the last stream
    for t, tick in enumerate(run["ticks"]):
        if new in tick:
            x = s["pcm"][-1, n * s["chunk"]:(n + 1) * s["chunk"]].astype(np.float32) / np.float32(32768.0)
            state, post = streamer.process(state, x)
            np.testing.assert_allclose(tick[new]["posterior"], post.numpy(), atol=RANKS_ATOL, rtol=0, err_msg=str(t))
            n += 1
    assert n >= 2


def test_a_reopened_slot_is_a_fresh_stream_on_one_rank(one, spec):
    _check_reopened(one[("float32/sync", "data")], spec)


def test_a_reopened_slot_of_the_last_rank_is_a_fresh_stream(ranks, spec):
    world, outs = ranks
    start, stop = outs[-1]["rows"]
    assert start <= spec["spec"]["n_slots"] - 1 < stop  # the slot lives on the last rank
    _check_reopened(outs[0]["runs"]["float32/sync"], spec)


def test_a_weight_swap_reaches_every_rank_from_the_next_tick(ranks, one, spec):
    """Each session's posteriors equal the unswapped run's before the swap and differ from them from its
    tick on; sessions on every rank, each equal to the one-rank run with the swap."""
    world, outs = ranks
    s = spec["spec"]
    block = s["n_slots"] // world
    got, swapped, unswapped = outs[0]["runs"]["float32/sync"], one[("float32/sync", "data")], one["no_swap"]
    n_sessions = len(s["pcm"]) - 1
    changed_on = set()
    for t, tick in enumerate(got["ticks"]):
        for i, r in tick.items():
            slot = s["n_slots"] - 1 - int(i) if int(i) < n_sessions else s["n_slots"] - 1
            same = np.allclose(r["posterior"], unswapped["ticks"][t][i]["posterior"], atol=RANKS_ATOL, rtol=0)
            assert same == (t < s["swap_at"]), (t, i)
            np.testing.assert_allclose(r["posterior"], swapped["ticks"][t][i]["posterior"], atol=RANKS_ATOL, rtol=0)
            if t >= s["swap_at"]:
                changed_on.add(slot // block)
    assert changed_on == set(range(world))


def test_fewer_slots_than_ranks_are_refused(ranks):
    world, outs = ranks
    for o in outs:
        assert f"StreamHub(n_slots={world - 1}) over {world} ranks" in o["too_few_slots"]
        assert "without a row" in o["too_few_slots"]


def test_shutdown_releases_every_follower(ranks):
    """Each of the four hubs' shutdown() on rank 0 ended every follower's follow() (and the ranks exited)."""
    world, outs = ranks
    assert len(outs[0]["runs"]) == len(MODES)
    for o in outs[1:]:
        assert len(o["follow_returned_s"]) == len(MODES)


def test_only_rank_zero_leads(ranks):
    world, outs = ranks
    for o in outs[1:]:
        assert f"open on rank {o['rank']}: rank 0 leads the hub" in o["open_on_follower"]


def test_follow_needs_a_follower_of_a_world_of_several_ranks(spec):
    s = spec["spec"]
    svc = LabelService("res8-narrow", s["variables"], device="cpu")
    for axis in ("data", None):
        hub = StreamHub(svc, 2, StreamConfig(**s["cfg"]), s["chunk"], data_axis=axis)
        with pytest.raises(ValueError, match="rank 0 leads"):
            hub.follow()
        hub.shutdown()


def test_a_follower_idle_past_its_group_timeout_then_serves_push_bin(spec, tmp_path):
    """The group's timeout is 2 s; the followers wait 5 s for a first message, then serve every tick."""
    s = spec["spec"]
    assert s["idle_s"] > 2
    outs = _ranks(spec, "idle", 2, tmp_path, group_timeout_s=2)
    svc = LabelService("res8-narrow", s["variables"], device="cpu")
    hub = W._hub(svc, s, "int16")
    n = len(s["pcm"]) - 1
    sids = [hub.open() for _ in range(n)]
    ref = {"ticks": [], "closed": {}}
    for t in range(s["n_ticks"]):
        res = hub.push_rows(sids, s["pcm"][:n, t * s["chunk"]:(t + 1) * s["chunk"]])
        ref["ticks"].append({str(i): res[sid] for i, sid in enumerate(sids)})
    ref["closed"] = {str(i): hub.close(sid) for i, sid in enumerate(sids)}
    hub.shutdown()
    _assert_same_run({k: outs[0][k] for k in ("ticks", "closed")}, ref, RANKS_ATOL)


def test_a_dead_follower_makes_the_leader_raise_naming_it(spec, tmp_path):
    """Rank 1 is killed while it waits for a message: rank 0's next push raises naming it, and so does shutdown."""
    flag = str(tmp_path / "dead0.pt")

    def kill_rank_1(procs):
        deadline = time.monotonic() + 120
        while not os.path.exists(flag + ".kill"):
            if time.monotonic() > deadline or procs[0].poll() is not None:
                raise RuntimeError("rank 0 never asked for rank 1's death")
            time.sleep(0.05)
        procs[1].kill()
        procs[1].wait()
        open(flag + ".killed", "w").close()

    # A 10 s group timeout: rank 0 waits that long for rank 1 to take its next message.
    outs = _ranks(spec, "dead", 2, tmp_path, kill_rank_1, returncodes={1: -9}, group_timeout_s=10)
    out = outs[0]
    assert "posterior" in out["first"]
    assert out["push_error"] is not None and "rank 1 never took message" in out["push_error"], out["push_error"]
    assert "within 0:00:10" in out["push_error"] and out["push_error_s"] < 60
    assert out["shutdown_error"] is not None and "rank 1 never took message" in out["shutdown_error"]

