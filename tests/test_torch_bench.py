"""The port's measuring tools against the reference's, on the CPU.

- ``graft_entry.entry()``'s logits against ``__graft_entry__.entry()``'s on
  the JAX weights carried across (``from_flax_variables``): within 2e-4,
  the reference's logit gate; the eight utterances bit for bit.
- One inference link of ``cli.bench`` against ``bench.py``'s scan body
  (rolling slice + ``acc * 1e-12``, ``compute_mfccs``, ``model.apply``) on
  the same pool and weights, float32 res8-narrow at B=4: each row's logit
  sum within 2e-4, and the link's accumulator with it.
- ``cli.bench_stream``'s steps (a bf16 ``BatchStreamer``, no mask) against
  the JAX ``BatchStreamer``'s ``_step_all`` on the same chunks and weights:
  smoothed posteriors within the stream gate, 1e-4.
- Each tool end to end at tiny knobs with ``--device cpu`` prints one JSON
  line whose keys are the reference tool's (listed here from ``bench.py``
  :203-219, ``scripts/bench_stream.py`` :83-96 and
  ``scripts/bench_http_serve.py`` :231-258); ``cli.bench_serve`` for 1 s
  on 2 slots and 1 gateway, binary and JSON, answers every push.
- Without ``--device cpu`` every tool raises here: there is no card.
- A fault of the reference not copied: ``scripts/bench_stream.py`` calls
  the JAX streamer's ``_step_all(state, chunks)``, which takes the weights
  first, so it stops at its first step; the port's link is the streamer's
  own unmasked ``process``.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from honk_tpu.config import StreamConfig as JStreamConfig
from honk_tpu.frontend.mfcc import compute_mfccs as jcompute_mfccs
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.stream import BatchStreamer as JBatchStreamer
from honk_tpu_torch import graft_entry
from honk_tpu_torch.cli import bench, bench_serve, bench_stream
from honk_tpu_torch.models import find_config, find_model
from honk_tpu_torch.models.torch_compat import from_flax_variables, load_state_dict

LOGIT_ATOL = 2e-4
STREAM_ATOL = 1e-4
CPU = torch.device("cpu")

BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "infer_audio_s_per_s", "train_audio_s_per_s",
              "infer_spread", "train_spread", "batch", "scan_lens", "infer_scan_lens", "model", "device",
              "implied_tflops", "suspect"]
SPREAD_KEYS = ["min", "median", "max", "n_reps", "per_rep"]
STREAM_KEYS = ["model", "n_streams", "chunk_samples", "step_ms", "audio_s_per_s", "realtime_streams_capacity",
               "device"]
SERVE_KEYS = ["metric", "value", "unit", "device_only_streams", "host_share", "payload", "pipelined", "inflight",
              "wire_dtype", "coalesce_ms", "dispatches", "chunks_per_dispatch", "slots", "gateways",
              "chunk_samples", "seconds", "total_chunks", "model", "checkpoint", "device", "note"]
TINY_BENCH = {"BENCH_BATCH": "2", "BENCH_SCAN_SHORT": "1", "BENCH_SCAN_LONG": "4", "BENCH_REPS": "2",
              "BENCH_MODEL": "res8-narrow"}
TINY_STREAM = {"ST_STREAMS": "2", "ST_REPS": "2", "ST_MODEL": "res8-narrow"}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small tensors one op at a time: OpenMP workers would spin against the other test workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_model(name: str, dtype=jnp.float32):
    model = jfind_model(name)(config=jfind_config(name), dtype=dtype)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 101, 40), jnp.float32), train=False)
    return model, variables


def test_entry_matches_the_reference_entry():
    jfn, jargs = jentry.entry()
    ref = np.asarray(jfn(*jargs))
    fn, (model, audio) = graft_entry.entry("cpu")
    np.testing.assert_array_equal(audio.numpy(), np.asarray(jargs[2]))
    load_state_dict(model, from_flax_variables({"params": jargs[0], "batch_stats": jargs[1]}))
    got = fn(model, audio)
    assert got.shape == ref.shape == (8, 12)
    np.testing.assert_allclose(got.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


def test_infer_link_matches_the_reference_scan_body():
    batch, i, acc = 4, 3, np.float32(0.25)
    jmodel, variables = _jax_model("res8-narrow")
    pool = bench.make_pool(np.random.default_rng(0), batch, CPU)
    pool_n = pool.shape[0]
    assert pool_n == 2048  # max(2048, 2 B)
    start = (i * batch) % (pool_n - batch)
    audio = jnp.asarray(pool.numpy())[start:start + batch] + jnp.float32(acc) * 1e-12
    ref = np.asarray(jmodel.apply(variables, jcompute_mfccs(audio, fast=False), train=False))

    model = find_model("res8-narrow")(find_config("res8-narrow"))
    load_state_dict(model, from_flax_variables(variables))
    link = bench.make_infer_link(model, pool, batch)
    t_acc = torch.tensor(acc)
    rows = link.logits(i, t_acc)
    np.testing.assert_allclose(rows.sum(-1).numpy(), ref.sum(-1), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(link(i, t_acc)), float(acc + ref.sum()), atol=LOGIT_ATOL, rtol=0)


def test_stream_bench_steps_match_the_jax_batch_streamer():
    n, chunk, steps = 3, 3200, 4
    jmodel, variables = _jax_model("res8-narrow", jnp.bfloat16)
    jb = JBatchStreamer(jmodel, variables, n, JStreamConfig(), chunk)
    tb = bench_stream.make_streamer("res8-narrow", n, chunk, CPU, from_flax_variables(variables))
    pool = (np.random.default_rng(0).standard_normal((steps, n, chunk)) * 0.1).astype(np.float32)
    jst, tst = jb.reset(), tb.reset()
    for t in range(steps):
        jst, jp = jb.process(jst, pool[t])
        tst, tp = tb.process(tst, torch.from_numpy(pool[t]))
        assert tp.shape == (n, 12)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp, np.float32), atol=STREAM_ATOL, rtol=0)


def _json_line(out: str) -> dict:
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.mark.parametrize("tool", ["bench", "bench_stream"])
def test_tool_prints_the_reference_keys(tool, monkeypatch, capsys):
    for k, v in (TINY_BENCH if tool == "bench" else TINY_STREAM).items():
        monkeypatch.setenv(k, v)
    mod = bench if tool == "bench" else bench_stream
    assert mod.main(["--device", "cpu"]) == 0
    row = _json_line(capsys.readouterr().out)
    if tool == "bench":
        assert list(row) == BENCH_KEYS
        assert list(row["infer_spread"]) == list(row["train_spread"]) == SPREAD_KEYS
        assert row["metric"] == "audio_seconds_per_s_per_chip_res8_narrow_train_infer_geomean"
        assert row["scan_lens"] == [1, 4] and row["infer_scan_lens"] == [2, 8] and row["batch"] == 2
        assert row["infer_audio_s_per_s"] > 0 and row["train_audio_s_per_s"] > 0 and row["suspect"] is False
    else:
        assert list(row) == STREAM_KEYS
        assert row["n_streams"] == 2 and row["chunk_samples"] == 3200 and row["step_ms"] > 0
    assert row["device"] == "cpu"


@pytest.mark.parametrize("payload", ["push_bin", "json"])
def test_bench_serve_answers_every_push(payload, capsys):
    argv = ["--slots", "2", "--gateways", "1", "--seconds", "1", "--device", "cpu"]
    assert bench_serve.main(argv + (["--json"] if payload == "json" else [])) == 0
    row = _json_line(capsys.readouterr().out)
    assert list(row) == SERVE_KEYS
    assert row["payload"] == ("json+base64" if payload == "json" else "binary pcm16")
    assert row["total_chunks"] > 0 and row["total_chunks"] % 2 == 0
    assert 0 < row["dispatches"] and 0 < row["chunks_per_dispatch"] <= 2
    assert row["value"] > 0 and row["device_only_streams"] > 0 and row["device"] == "cpu"
    assert row["note"].startswith(f"server+gateways share one {os.cpu_count()}-core host process")


@pytest.mark.parametrize("tool", ["entry", "bench", "bench_stream", "bench_serve"])
def test_tools_raise_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"entry": graft_entry.entry, "bench": lambda: bench.main([]),
           "bench_stream": lambda: bench_stream.main([]), "bench_serve": lambda: bench_serve.main([])}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()


def test_the_reference_stream_bench_calls_its_step_without_the_weights(monkeypatch):
    for k, v in TINY_STREAM.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "reference_bench_stream", os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts", "bench_stream.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                                                 "jax_persistent_cache_min_entry_size_bytes")}
    try:
        with pytest.raises(TypeError, match="chunks"):
            ref.main()
    finally:
        for k, v in saved.items():  # the script points JAX's cache elsewhere
            jax.config.update(k, v)
    assert bench_stream.main(["--device", "cpu"]) == 0
