"""The port's data parallel (``honk_tpu_torch.parallel``) against one rank and against the JAX package, on the CPU.

The JAX package's ``data`` axis is GSPMD over one global batch, so its
gates say what the port's ranks must compute (``tests/test_parallel.py``,
``tests/test_multiprocess.py``):

- batches and dropout masks: the global batch's draws are made on every
  rank, so a rank's rows are bitwise the rows of the one-rank batch;
- train steps, 2 ranks against 1 from the same weights and draws: the
  first step's loss within rtol 1e-5, the weights after 2 steps within
  atol 5e-4 and at most 1e-3 apart (BN and ReLU amplify the reassociation
  of the sums), and every rank's weights bitwise equal;
- one step on the JAX step's own batch at 2 ranks against
  ``make_train_step(data_axis="data")`` on 8 virtual devices: the gate of
  ``tests/test_torch_train.py`` (loss 1e-5, weights atol 1e-5 rtol 1e-4);
- eval counts: exactly equal at 1 and 2 ranks and to JAX on 8 devices;
- collectives of a step: one all-reduce of exactly the parameter count,
  the BN statistics' all-reduces (forward and backward) and the metrics
  under 5% of it;
- streaming: 2 ranks equal to 1 rank (posteriors within 1e-6, events
  equal), 1 rank with ``data_axis`` bitwise the unsharded run, and the
  JAX package's within the streaming gate of ``tests/test_torch_stream.py``
  (1e-4); masked-off slots bit for bit;
- ``train`` in two processes: replicated weights' checksums within rtol
  1e-12, equal test accuracy, "final test accuracy:" on rank 0 only; a
  checkpoint resumed on the ranks that wrote it is bit for bit the
  uninterrupted run, in float32 and bf16; one resumes across 1 and 2
  ranks both ways, the float32 runs within twice the largest of the JAX
  package's own 1-vs-2-device gaps over five corpora (the bf16 runs held
  to JAX's gap on the corpus are an open difference, a strict xfail);
  the CLI and the dry run start their own ranks. The corpus is written
  with a fixed hash seed.

Ranks are processes joined by gloo over 127.0.0.1, each started with a
free port, waited for with a timeout, and killed by exact PID.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as W
import torch_resume as R
from torch_ranks import REPO, TIMEOUT, free_port, rank_env, run_ranks
from honk_tpu import stream as jstream
from honk_tpu.config import StreamConfig as JStreamConfig
from honk_tpu.data import augment as JA
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.parallel import make_data_mesh as jmake_data_mesh
from honk_tpu.parallel import replicate as jreplicate
from honk_tpu.train import state as JS
from honk_tpu.train import steps as JT
from honk_tpu_torch.data import augment as A
from honk_tpu_torch.models import find_config, find_model, from_flax_variables
from honk_tpu_torch.parallel import DataMesh, make_data_mesh
from honk_tpu_torch.stream import BatchStreamer, stream_file

LOSS_RTOL = 1e-5
DP_PARAM_ATOL, DP_PARAM_MAX = 5e-4, 1e-3
JAX_LOSS_ATOL = 1e-5
JAX_PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
STREAM_RANKS_ATOL = 1e-6
SMOOTH_ATOL = 1e-4
# Twice the largest JAX 1-vs-2-device gap of the resume recipe, float32, over
# the corpora of hash seeds 0-4 (scripts/probe_torch_topology_gap.py).
TOPOLOGY_GAP_F32 = 2 * 3.8933753967285156e-3


def _jax_draws(key, n, cfg, n_noise, batch):
    """The draws of honk_tpu.data.augment.sample_train_batch, from its key."""
    k_idx, k_shift, k_off, k_noise, k_scale = jax.random.split(key, 5)
    ts = cfg.timeshift_samples

    def t(a):
        return torch.from_numpy(np.array(a))

    return A.Draws(
        idx=t(jax.random.randint(k_idx, (batch,), 0, n + cfg.n_silence)).long(),
        shift=t(jax.random.randint(k_shift, (batch,), -ts, ts + 1)).long(),
        noise_row=t(jax.random.randint(k_off, (batch,), 0, n_noise)).long(),
        add_u=t(jax.random.uniform(k_noise, (batch,))),
        scale_u=t(jax.random.uniform(k_scale, (batch,))),
    )


def _flax_res8_narrow(seed):
    model = jfind_model("res8-narrow")(config=jfind_config("res8-narrow"), precision="highest")
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 101, 40), jnp.float32), train=False)
    return model, jax.tree.map(np.asarray, dict(variables))


def _jax_step_spec() -> dict:
    """JAX's data-parallel step on 8 virtual devices, and its batch for the port to inject."""
    rng = np.random.default_rng(11)
    n, batch = 32, 16
    raw = rng.integers(-3000, 3000, (n, 16000), dtype=np.int16)
    labels = rng.integers(2, 12, (n,), dtype=np.int32)
    noise = (rng.standard_normal(16000 * 3) * 0.05).astype(np.float32)
    jaug = JA.AugmentConfig(n_silence=4)
    jpool, jwin = JA.prepare_train_arrays(raw, noise, jaug, layout="xla")
    fmodel = jfind_model("res8-narrow")(config=jfind_config("res8-narrow"), precision="highest")
    tx = JS.make_optimizer(lrs=(0.01,), boundaries=())
    jstate = JS.create_train_state(fmodel, tx, jax.random.PRNGKey(0))
    variables = from_flax_variables({"params": jax.tree.map(np.asarray, jstate.params),
                                     "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    mesh = jmake_data_mesh(8, "data")
    step = JT.make_train_step(fmodel, tx, batch, jaug, donate=False, data_axis="data")
    key = jax.random.PRNGKey(3)
    with jax.set_mesh(mesh):
        jstate, jm = step(jreplicate(mesh, jstate), key, *jreplicate(mesh, (jpool, jnp.asarray(labels), jwin)))
    aug = A.AugmentConfig(n_silence=4)
    arrays = A.prepare_train_arrays(raw, labels, noise, aug)
    k_sample, _ = jax.random.split(jax.random.fold_in(key, 0))
    audio, lab = A.assemble_batch(_jax_draws(k_sample, n, jaug, arrays.n_noise, batch), arrays, aug)
    after = from_flax_variables({"params": jax.tree.map(np.asarray, jax.device_get(jstate.params)),
                                 "batch_stats": jax.tree.map(np.asarray, jax.device_get(jstate.batch_stats))})
    return {"variables": variables, "audio": audio, "labels": lab, "jax_loss": float(jm["loss"]),
            "jax_acc": float(jm["acc"]), "jax_after": after}


def _jax_eval_counts(variables, raw, labels, batch) -> tuple[int, int]:
    fmodel = jfind_model("res8-narrow")(config=jfind_config("res8-narrow"), precision="highest")
    mesh = jmake_data_mesh(8, "data")
    sweep = JT.make_eval_sweep(fmodel, batch_size=batch, data_axis="data")
    with jax.set_mesh(mesh):
        c, t = sweep(jreplicate(mesh, variables["params"]), jreplicate(mesh, variables["batch_stats"]),
                     jreplicate(mesh, jnp.asarray(raw)), jreplicate(mesh, jnp.asarray(labels)))
    return int(c), int(t)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Everything the two ranks computed, one rank's references, and the JAX package's."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    n = 48
    spec = {
        "raw": rng.integers(-3000, 3000, (n, 16000), dtype=np.int16),
        "labels": rng.integers(2, 12, (n,), dtype=np.int32),
        "noise": (rng.standard_normal(16000 * 3) * 0.05).astype(np.float32),
        "n_silence": 4, "batch": 16, "steps": 2, "key": 7,
    }
    spec["jax_step"] = _jax_step_spec()
    fmodel, fvars = _flax_res8_narrow(4)
    eval_raw = np.random.default_rng(3).integers(-3000, 3000, (100, 16000), dtype=np.int16)
    eval_labels = np.random.default_rng(4).integers(0, 12, (100,), dtype=np.int32)
    spec["eval"] = {"variables": from_flax_variables(fvars), "audio": torch.from_numpy(eval_raw),
                    "labels": torch.from_numpy(eval_labels).long(), "batch": 32}
    srng = np.random.default_rng(5)
    chunk, n_streams, n_chunks = 3200, 3, 8
    masks = np.ones((n_chunks, n_streams), bool)
    masks[2, 1] = masks[3, 0] = masks[5, 2] = False
    svars = from_flax_variables(_flax_res8_narrow(6)[1])
    spec["stream"] = {
        "variables": svars, "swapped": {k: v * 1.25 if v.is_floating_point() else v for k, v in svars.items()},
        "cfg": dict(min_gap_windows=2, smoothing_window=3, detection_threshold=0.1),
        "audio": (srng.standard_normal(16000 * 3 + 800) * 0.3).astype(np.float32),
        "chunk": chunk, "n_streams": n_streams, "swap_at": 5, "masks": masks,
        "chunks": [(srng.standard_normal((n_streams, chunk)) * 0.3).astype(np.float32) for _ in range(n_chunks)],
    }
    data_dir = str(tmp / "sc")
    # The same corpus under every hash seed of this process.
    R.write_corpus(data_dir, "0", rank_env(), TIMEOUT)
    spec["train"] = {"data_dir": data_dir}
    spec_path = str(tmp / "spec.pt")
    torch.save(spec, spec_path)

    port = free_port()
    outs = [str(tmp / f"out{r}.pt") for r in range(2)]
    logs = run_ranks([[sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"),
                        str(r), "2", str(port), spec_path, outs[r]] for r in range(2)])
    ranks = [torch.load(o, weights_only=False) for o in outs]

    # One rank, in this process (no process group: a world of one).
    spec["world"] = 1
    mesh = make_data_mesh(0, "data")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs
    try:
        one = {
            "steps": {conf: W.train_steps(spec, conf, mesh) for conf in ("res8-narrow", "cnn-trad-pool2")},
            "jax_step": W.jax_batch_step(spec, mesh),
            "eval": W.eval_counts(spec, mesh),
            "stream": W.streaming(spec),
        }
    finally:
        torch.set_num_threads(threads)
    jax_eval = _jax_eval_counts(fvars, eval_raw, eval_labels, 32)
    return {"spec": spec, "ranks": ranks, "logs": logs, "one": one, "jax_eval": jax_eval}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layout", ["exact", "subrow"])
def test_batch_and_keep_masks_of_every_world_equal_one_rank(world, layout):
    """A rank's rows of the batch and of the dropout masks are bitwise the one-rank batch's rows."""
    rng = np.random.default_rng(1)
    raw = rng.integers(-32768, 32768, (40, 16000), dtype=np.int16)
    labels = rng.integers(2, 12, (40,), dtype=np.int32)
    noise = (rng.standard_normal(16000 * 4) * 0.3).astype(np.float32)
    aug = A.AugmentConfig(n_silence=6)
    arrays = A.prepare_train_arrays(raw, labels, noise, aug, layout=layout)
    cnn = find_model("cnn-trad-pool2")(find_config("cnn-trad-pool2"))
    batch = 18  # uneven: blocks of 9 at 2 ranks, of 5, 5, 5, 3 at 4

    def rank_batch(mesh):
        gen = A.step_generator(3, 5, "cpu")
        rows = mesh.shard_rows(batch)
        audio, lab = A.sample_train_batch(gen, arrays, batch, aug, rows)
        return audio, lab, [m[rows[0]:rows[1]] for m in cnn.keep_masks(batch, gen)]

    audio1, lab1, masks1 = rank_batch(DataMesh("data", 0, 1))
    parts = [rank_batch(DataMesh("data", r, world)) for r in range(world)]
    assert [p[0].shape[0] for p in parts] == [-(-batch // world)] * (world - 1) + [batch - (world - 1) * -(-batch // world)]
    assert torch.equal(torch.cat([p[0] for p in parts]), audio1)
    assert torch.equal(torch.cat([p[1] for p in parts]), lab1)
    for k, m1 in enumerate(masks1):
        assert torch.equal(torch.cat([p[2][k] for p in parts]), m1)
    assert bool((lab1 == 0).any()), "the draws should hold a silence row"


def test_a_rank_without_rows_is_refused():
    with pytest.raises(ValueError, match="without a row"):
        DataMesh("data", 0, 4).shard_rows(3)
    with pytest.raises(ValueError, match="ranks"):
        make_data_mesh(2, "data")  # a world of one


@pytest.mark.parametrize("conf", ["res8-narrow", "cnn-trad-pool2"])
def test_two_rank_train_steps_match_one_rank(dp, conf):
    one, ranks = dp["one"]["steps"][conf], [r["steps"][conf] for r in dp["ranks"]]
    np.testing.assert_allclose(ranks[0]["losses"][0], one["losses"][0], rtol=LOSS_RTOL)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for k, v in one["state"].items():
        a, b = ranks[0]["state"][k], ranks[1]["state"][k]
        assert torch.equal(a, b), f"{k} differs across the ranks"
        if v.is_floating_point():
            np.testing.assert_allclose(a.numpy(), v.numpy(), atol=DP_PARAM_ATOL, err_msg=k)
            assert float((a - v).abs().max()) < DP_PARAM_MAX, k


def test_two_rank_step_on_the_jax_batch_matches_jax_on_eight_devices(dp):
    j = dp["spec"]["jax_step"]
    for r in dp["ranks"] + [dp["one"]]:
        got = r["jax_step"]
        assert abs(got["loss"] - j["jax_loss"]) < JAX_LOSS_ATOL
        assert got["acc"] == pytest.approx(j["jax_acc"], abs=1e-7)
        for k, v in j["jax_after"].items():
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), err_msg=k, **JAX_PARAM_TOL)


def test_eval_counts_equal_at_one_and_two_ranks_and_jax(dp):
    assert dp["one"]["eval"] == dp["ranks"][0]["eval"] == dp["ranks"][1]["eval"] == dp["jax_eval"]
    assert dp["one"]["eval"][1] == 100


def test_one_gradient_all_reduce_of_the_parameter_count(dp):
    collectives = dp["ranks"][0]["steps"]["res8-narrow"]["collectives"]
    n_params = sum(v.numel() for k, v in dp["one"]["steps"]["res8-narrow"]["state"].items()
                   if "running" not in k and "num_batches" not in k)
    assert all(op == "all_reduce" for op, _ in collectives)
    sizes = [n for _, n in collectives]
    assert sizes.count(n_params) == 1
    rest = [n for n in sizes if n != n_params]
    # 6 BN layers x (sums, sums of squares, count) forward and backward, and the loss and hits.
    assert len(rest) == 2 * 6 + 1
    assert sum(rest) < 0.05 * n_params


def test_streaming_at_two_ranks_equals_one_rank_and_jax(dp):
    s, one = dp["spec"]["stream"], dp["one"]["stream"]
    cfg = W.StreamConfig(**s["cfg"])
    model = W.model_of("res8-narrow", s["variables"]).eval()
    # One rank with data_axis is the unsharded run, bit for bit.
    smoothed, events = stream_file(model, None, s["audio"], cfg)
    assert np.array_equal(one["smoothed"], smoothed)
    assert one["events"] == [(e.time_s, e.label, e.score) for e in events]
    bs = BatchStreamer(model, None, s["n_streams"], cfg, s["chunk"])
    state = bs.reset()
    for t, chunks in enumerate(s["chunks"]):
        if t == s["swap_at"]:
            bs.set_variables(s["swapped"])
        state, post = bs.process(state, chunks, s["masks"][t])
        assert torch.equal(one["posts"][t], post)
    # Two ranks: each holds its rows, and gets every stream's posteriors.
    assert [r["stream"]["rows"] for r in dp["ranks"]] == [(0, 2), (2, 3)]
    for r in dp["ranks"]:
        got = r["stream"]
        assert got["masked_off_kept"] and one["masked_off_kept"]
        np.testing.assert_allclose(got["smoothed"], one["smoothed"], atol=STREAM_RANKS_ATOL, rtol=0)
        assert [(t, lab) for t, lab, _ in got["events"]] == [(t, lab) for t, lab, _ in one["events"]]
        np.testing.assert_allclose(got["posts"].numpy(), one["posts"].numpy(), atol=STREAM_RANKS_ATOL, rtol=0)
    assert one["events"], "the detection config should fire on this audio"
    assert bool((one["posts"][2, 1] == 0).all()) and bool((one["posts"][3, 0] == 0).all())
    assert not torch.allclose(one["posts"][s["swap_at"]], one["posts"][s["swap_at"] - 1])

    # The JAX package's offline and batched streaming on the same weights and audio.
    fmodel = jfind_model("res8-narrow")(config=jfind_config("res8-narrow"), precision="highest")
    fvars = _flax_res8_narrow(6)[1]
    jcfg = JStreamConfig(**s["cfg"])
    jsmoothed, jevents = jstream.stream_file(fmodel, fvars, s["audio"], jcfg)
    np.testing.assert_allclose(one["smoothed"], np.asarray(jsmoothed), atol=SMOOTH_ATOL, rtol=0)
    assert [(t, lab) for t, lab, _ in one["events"]] == [(e.time_s, e.label) for e in jevents]
    jbs = jstream.BatchStreamer(fmodel, fvars, s["n_streams"], jcfg, s["chunk"])
    jstate = jbs.reset()
    for t, chunks in enumerate(s["chunks"][: s["swap_at"]]):
        jstate, jpost = jbs.process(jstate, chunks, s["masks"][t])
        np.testing.assert_allclose(one["posts"][t].numpy(), np.asarray(jpost), atol=SMOOTH_ATOL, rtol=0)


def test_two_process_training_agrees_and_only_rank_zero_prints(dp):
    a, b = (r["train"] for r in dp["ranks"])
    np.testing.assert_allclose(a["param_checksum"], b["param_checksum"], rtol=1e-12)
    assert a["test_acc"] == b["test_acc"] and np.isfinite(a["test_acc"])
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
    assert "final test accuracy:" in dp["logs"][0]
    assert "final test accuracy:" not in dp["logs"][1]
    assert "[train_epoch]" not in dp["logs"][1]


@pytest.fixture(scope="module")
def resumed_float32(dp, tmp_path_factory):
    return R.resume_runs(dp["spec"]["train"]["data_dir"], "float32", tmp_path_factory.mktemp("resume_float32"))


@pytest.fixture(scope="module")
def resumed_bfloat16(dp, tmp_path_factory):
    return R.resume_runs(dp["spec"]["train"]["data_dir"], "bfloat16", tmp_path_factory.mktemp("resume_bfloat16"))


def _assert_resumed_across(r: dict) -> None:
    """1 -> 2 ranks and 2 -> 1 resumed where the other topology stopped, and finished as a run does."""
    half = int(r["state"]["half1"]["step"])
    assert int(r["state"]["half2"]["step"]) == half
    for n in ("1to2", "2to1"):
        assert "[resume]" in r["logs"][n] and r["logs"][n].count("final test accuracy:") == 1, n
        assert int(r["state"][n]["step"]) == 2 * half == int(r["state"]["whole1"]["step"]), n
        assert r["best"][n], n


@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_resume_on_one_topology_is_bitwise_the_uninterrupted_run(request, dtype, ranks):
    """2 epochs, then 2 more resumed on the same ranks: the model and the optimizer bit for bit the 4-epoch run's."""
    r = request.getfixturevalue(f"resumed_{dtype}")
    resumed, whole = r["state"][f"{ranks}to{ranks}"], r["state"][f"whole{ranks}"]
    assert "[resume]" in r["logs"][f"{ranks}to{ranks}"] and "[resume]" not in r["logs"][f"whole{ranks}"]
    assert int(resumed["step"]) == int(whole["step"]) > int(r["state"][f"half{ranks}"]["step"])
    a, b = R.flat_tensors(resumed), R.flat_tensors(whole)
    assert a.keys() == b.keys() and any("momentum" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_checkpoints_resume_across_one_and_two_ranks(resumed_float32):
    """1 -> 2 ranks and 2 -> 1, through the CLI: the resumed run continues where the other stopped.

    float32. The two resumed runs, and the two uninterrupted topologies,
    part no further than TOPOLOGY_GAP_F32: twice the largest of the JAX
    package's own 1-vs-2-device gaps on this recipe over the corpora of
    hash seeds 0-4 (``scripts/probe_torch_topology_gap.py``). Reassociated
    sums grow over 4 epochs into noise of no steady size, so one corpus's
    JAX gap is no limit: over those corpora JAX's runs 7.5e-5 to 3.9e-3,
    the port's 3.8e-6 to 6.9e-3 (ROADMAP.md §3).
    """
    r = resumed_float32
    _assert_resumed_across(r)
    w = {n: R.port_weights(r["state"][n]) for n in ("1to2", "2to1", "whole1", "whole2")}
    for a, b in (("1to2", "2to1"), ("whole1", "whole2")):
        gap = R.max_gap(w[a], w[b])
        assert gap <= TOPOLOGY_GAP_F32, f"{a} and {b} {gap:.6g} apart; the limit {TOPOLOGY_GAP_F32:.6g}"


def test_bf16_checkpoints_resume_across_one_and_two_ranks(resumed_bfloat16):
    """The CLI's default dtype, bfloat16: 1 -> 2 ranks and 2 -> 1 resume where the other topology stopped."""
    _assert_resumed_across(resumed_bfloat16)


@pytest.mark.xfail(strict=True, raises=AssertionError,
                   reason="open difference, ROADMAP.md §3: in bf16 the port's 1 and 2 ranks part further "
                          "than the JAX package's 1 and 2 devices")
def test_bf16_resumes_across_one_and_two_ranks_within_the_jax_gap(dp, resumed_bfloat16):
    """The two resumed bf16 runs part no further than the JAX package's 1 and 2 devices in bf16 on the same corpus."""
    data = dp["spec"]["train"]["data_dir"]
    jax_gap = R.max_gap(*(R.jax_weights(data, "bfloat16", n) for n in (1, 2)))
    gap = R.max_gap(*(R.port_weights(resumed_bfloat16["state"][n]) for n in ("1to2", "2to1")))
    assert gap <= jax_gap, f"1 -> 2 and 2 -> 1 ranks {gap:.6g} apart; JAX's 1 and 2 devices {jax_gap:.6g}"


def test_dryrun_multichip_on_two_gloo_ranks():
    out = run_ranks([[sys.executable, "-m", "honk_tpu_torch.parallel.dryrun", "--n", "2", "--device", "cpu"]])[0]
    for what in ("exact train step ok", "subrow train step ok", "sharded eval ok, acc=", "sharded streaming ok",
                 "masked session slab ok", "sharded slab weight refresh ok"):
        assert out.count(f"dryrun_multichip(2): {what}") == 1, out
