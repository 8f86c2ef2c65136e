"""Port's streaming module (honk_tpu_torch.stream) against the JAX package, on the CPU.

The same seeded numpy inputs go through ``honk_tpu.stream`` and its
counterpart in the port, with res8-narrow weights carried across by
``from_flax_variables``. On CPU tensors the MFCC and res-stack wrappers run
their plain versions, so these tests hold the kernels' arithmetic (the
MFCC kernel's new causal framing included) against the reference; the
CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``. Then the ground-truth track of ``tests/test_stream.py``
(``zoo/res8.pt``, keywords planted at known positions in 60 s of noise)
through the offline, online and batched paths of both packages.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu import stream as jstream
from honk_tpu.cli import demo as jdemo
from honk_tpu.config import StreamConfig as JStreamConfig
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.models import load_honk_checkpoint as jload_honk_checkpoint
from honk_tpu.stream.streamer import _mfcc_of_frames
from honk_tpu_torch import stream as tstream
from honk_tpu_torch.cli import demo as tdemo
from honk_tpu_torch.config import StreamConfig
from honk_tpu_torch.models import (
    find_config,
    find_model,
    from_flax_variables,
    load_honk_checkpoint,
    load_state_dict,
)
from honk_tpu_torch.ops import mfcc_kernel
from honk_tpu_torch.serve import LabelService

ZOO_RES8 = os.path.join(os.path.dirname(__file__), "..", "zoo", "res8.pt")
# MFCC: the gate of tests/test_torch_frontend.py (the reference's own gate
# between its Pallas kernel and its XLA frontend).
MFCC_TOL = dict(atol=2e-5, rtol=1e-5)
# Smoothed posteriors: probabilities from logits within the 2e-4 gate,
# averaged; softmax and the mean do not enlarge the error.
SMOOTH_ATOL = 1e-4
LABELS = ["__silence__", "__unknown__", "yes", "no", "up", "down",
          "left", "right", "on", "off", "stop", "go"]


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """These tests step tiny tensors one op at a time: run them on one
    intra-op thread. PyTorch's OpenMP workers spin between ops, and with
    several test processes on one host they starve each other (the online
    ground-truth test takes 10 s so, and 290 s with the default threads,
    beside two other such processes on 8 cores)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _audio(n, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def narrow():
    """res8-narrow: the flax model and variables from a seed, and the port's model with the same weights."""
    conf = "res8-narrow"
    fmodel = jfind_model(conf)(config=jfind_config(conf))
    variables = jax.tree.map(np.asarray, dict(
        fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 101, 40), jnp.float32), train=False)))
    rng = np.random.default_rng(0)
    variables["batch_stats"] = {
        k: {"mean": rng.normal(0, 0.1, v["mean"].shape).astype(np.float32),
            "var": (rng.random(v["var"].shape) * 0.5 + 0.5).astype(np.float32)}
        for k, v in variables["batch_stats"].items()
    }
    model = load_state_dict(find_model(conf)(find_config(conf)), from_flax_variables(variables)).eval()
    return fmodel, variables, model


def _events(events):
    return [(e.time_s, e.label) for e in events]


def _assert_events_equal(got, want):
    """Label and time exactly; score within the smoothed-posterior gate."""
    assert _events(got) == _events(want)
    for g, w in zip(got, want):
        assert abs(g.score - w.score) <= SMOOTH_ATOL


# ---- frontend: the two framings ----

def test_frame_mfccs_matches_jax():
    audio = _audio(int(16000 * 4.3), seed=1)
    got = tstream.frame_mfccs(torch.from_numpy(audio)).numpy()
    ref = np.asarray(jstream.frame_mfccs(jnp.asarray(audio)))
    assert got.shape == ref.shape == (1 + len(audio) // 160, 40)
    np.testing.assert_allclose(got, ref, **MFCC_TOL)


@pytest.mark.parametrize("chunk", [3200, 160, 16000])
def test_causal_step_frames_match_jax(chunk):
    """One online step's frames: ``[480-sample tail | chunk]`` framed at
    0, 160, ... with no pad, against the JAX step's ``_mfcc_of_frames``."""
    n_new = chunk // 160
    buf = np.stack([_audio(480 + chunk, seed=10 + i) for i in range(3)])
    got = mfcc_kernel.mfcc(torch.from_numpy(buf), center=False, n_frames=n_new).numpy()
    idx = np.arange(n_new)[:, None] * 160 + np.arange(480)[None, :]
    ref = np.stack([np.asarray(_mfcc_of_frames(jnp.asarray(b[idx]))) for b in buf])
    assert got.shape == ref.shape == (3, n_new, 40)
    np.testing.assert_allclose(got, ref, **MFCC_TOL)


def test_causal_framing_is_unfold_without_pad():
    buf = _audio(480 + 3200, seed=3)[None]
    got = mfcc_kernel.frames_plain(torch.from_numpy(buf), center=False, n_frames=20).numpy()
    idx = np.arange(20)[:, None] * 160 + np.arange(480)[None, :]
    np.testing.assert_array_equal(got[0], buf[0][idx])
    # The last 160 samples are the next step's: no frame of this step reads them.
    assert got[0, -1, -1] == buf[0, 480 + 3200 - 160 - 1]


def test_mfcc_framing_is_checked():
    x = torch.zeros((1, 480 + 3200))
    with pytest.raises(ValueError, match="causal framing"):
        mfcc_kernel.mfcc(x, center=False, n_frames=22)  # frame 21 would read past the buffer
    with pytest.raises(ValueError, match="causal framing"):
        mfcc_kernel.mfcc(x, center=False)
    with pytest.raises(ValueError, match="center framing"):
        mfcc_kernel.mfcc(torch.zeros((1, 16000)), n_frames=100)
    assert mfcc_kernel.geometry(x, center=False, n_frames=20)["frames"] == 20
    assert mfcc_kernel.geometry(torch.zeros((2, 16000)))["frames"] == 202


# ---- smoothing and event detection (host side) ----

def test_smooth_posteriors_matches_jax():
    """The JAX formula on a (500, 12) posterior series, w=5. Both packages
    take a float32 cumsum, summed in another order (XLA:CPU rewrites it as
    a windowed reduction), so each carries its own rounding of the running
    sums: JAX's result is itself 1.2-1.5e-6 from the float64 value on such
    series. The port must be no further from that value than JAX is, and
    within the two errors together of JAX."""
    logits = np.random.default_rng(4).standard_normal((500, 12)) * 2
    post = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    got = tstream.smooth_posteriors(torch.from_numpy(post), 5).numpy()
    ref = np.asarray(jstream.smooth_posteriors(jnp.asarray(post), 5))
    cs = np.concatenate([np.zeros((1, 12)), np.cumsum(post.astype(np.float64), axis=0)])
    starts = np.maximum(np.arange(500) - 4, 0)
    exact = (cs[np.arange(500) + 1] - cs[starts]) / (np.arange(500) - starts + 1)[:, None]
    ref_err = np.abs(ref - exact).max()
    assert np.abs(got - exact).max() <= ref_err
    np.testing.assert_allclose(got, ref, atol=2 * ref_err, rtol=0)
    sm = tstream.smooth_posteriors(torch.eye(4), 2).numpy()
    np.testing.assert_allclose(sm[:3], [[1, 0, 0, 0], [0.5, 0.5, 0, 0], [0, 0.5, 0.5, 0]])


def _posterior_series(n, n_labels=12):
    s = np.full((n, n_labels), 0.01, np.float32)
    s[:, 0] = 0.9
    return s


def _series_cases():
    two = _posterior_series(20)
    two[3:5, 0], two[3:5, 2] = 0.05, 0.8
    two[11:13, 0], two[11:13, 5] = 0.05, 0.8
    flap = _posterior_series(24)
    for i in range(2, 22):
        flap[i, 0], flap[i, 2 if i % 2 == 0 else 5] = 0.05, 0.8
    logits = np.random.default_rng(17).standard_normal((300, 12)).astype(np.float32) * 3
    rand = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return {"two_keywords": (two, dict(detection_threshold=0.7, min_gap_windows=4)),
            "flapping": (flap, dict(detection_threshold=0.7, min_gap_windows=4)),
            "random": (rand.astype(np.float32), dict(detection_threshold=0.3, min_gap_windows=3))}


@pytest.mark.parametrize("case", ["two_keywords", "flapping", "random"])
def test_detectors_equal_jax(case):
    """detect, detect_step, StreamDetector and detect_stream give exactly the JAX events."""
    series, kw = _series_cases()[case]
    cfg, jcfg = StreamConfig(**kw), JStreamConfig(**kw)

    def as_tuples(events):
        return [(e.time_s, e.label, e.score) for e in events]

    batch = tstream.detect(series, cfg, hop_s=0.2)
    assert batch and as_tuples(batch) == as_tuples(jstream.detect(series, jcfg, hop_s=0.2))
    st = tstream.DetectorState()
    assert as_tuples(e for row in series if (e := tstream.detect_step(row, st, cfg, 0.2))) == as_tuples(batch)
    stream = tstream.detect_stream(series, cfg, 3200)
    assert as_tuples(stream) == as_tuples(jstream.detect_stream(series, jcfg, 3200))
    det = tstream.StreamDetector(cfg, 3200)
    assert as_tuples(e for row in series if (e := det.step(row))) == as_tuples(stream)
    if case == "flapping":
        assert [round(e.time_s / 0.2) for e in batch] == [2, 6, 10, 14, 18]


def test_detect_step_threshold_compare_is_float64():
    """float32(0.7) < 0.7 in float64: no fire, as the JAX detect_step."""
    cfg = StreamConfig(smoothing_window=1, detection_threshold=0.7, min_gap_windows=1)
    row = np.zeros(4, np.float32)
    row[2] = np.float32(0.7)
    row[0] = np.float32(0.3) - row[2] + np.float32(0.3)
    assert row.argmax() == 2
    assert tstream.detect_step(row, tstream.DetectorState(), cfg, 0.2) is None
    assert jstream.detect_step(row, jstream.DetectorState(), JStreamConfig(**vars(cfg)), 0.2) is None
    row[2] = np.float32(0.75)
    e = tstream.detect_step(row, tstream.DetectorState(), cfg, 0.2)
    assert e is not None and e.label == 2


# ---- offline: stream_file ----

def test_stream_file_matches_jax(narrow):
    fmodel, variables, model = narrow
    audio = _audio(int(16000 * 4.3), seed=5, scale=0.3)
    # Random weights give near-uniform posteriors: a low threshold makes events.
    kw = dict(hop_samples=3200, smoothing_window=3, detection_threshold=0.1, min_gap_windows=2)
    got, got_events = tstream.stream_file(model, None, audio, StreamConfig(**kw))
    ref, ref_events = jstream.stream_file(fmodel, variables, audio, JStreamConfig(**kw))
    assert got.shape == ref.shape == (17, 12)
    np.testing.assert_allclose(got, ref, atol=SMOOTH_ATOL, rtol=0)
    assert ref_events, "the scenario must produce events"
    _assert_events_equal(got_events, ref_events)
    # The same weights given as a state dict load into a copy of the model.
    fresh = find_model("res8-narrow")(find_config("res8-narrow")).eval()
    again, _ = tstream.stream_file(fresh, from_flax_variables(variables), audio, StreamConfig(**kw))
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("n", [100, 8000])
def test_stream_file_shorter_than_a_window(narrow, n):
    fmodel, variables, model = narrow
    before = mfcc_kernel.launches
    got, events = tstream.stream_file(model, None, _audio(n, seed=6))
    ref, ref_events = jstream.stream_file(fmodel, variables, _audio(n, seed=6))
    assert got.shape == ref.shape == (0, 1) and events == ref_events == []
    assert mfcc_kernel.launches == before


def test_data_axis_is_refused(narrow, monkeypatch):
    """data_axis is ported: in a world of one rank it is the unsharded run,
    bit for bit; the stream hub alone refuses it across more than one rank
    (tests/test_torch_parallel.py drives two ranks)."""
    _, _, model = narrow
    audio = _audio(32000, seed=7)
    sharded, unsharded = (tstream.stream_file(model, None, audio, data_axis=ax)[0] for ax in ("data", None))
    assert np.array_equal(sharded, unsharded)
    chunks = _audio(2 * 3200, seed=8).reshape(2, 3200)
    outs = []
    for ax in ("data", None):
        bs = tstream.BatchStreamer(model, None, 2, data_axis=ax)
        outs.append(bs.process(bs.reset(), chunks, np.array([True, False]))[1])
    assert torch.equal(outs[0], outs[1])
    from honk_tpu_torch.serve import streams

    monkeypatch.setattr(streams, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="not in the port"):
        streams.StreamHub(LabelService("res8-narrow", {k: v for k, v in model.state_dict().items()},
                                       device="cpu"), 2, data_axis="data")


# ---- online: Streamer and BatchStreamer ----

def test_streamer_matches_jax(narrow):
    fmodel, variables, model = narrow
    kw = dict(smoothing_window=3)
    audio = _audio(10 * 3200, seed=8)
    js, ts = jstream.Streamer(fmodel, variables, JStreamConfig(**kw), 3200), \
        tstream.Streamer(model, None, StreamConfig(**kw), 3200)
    jst, tst = js.reset(), ts.reset()
    shapes = [tuple(x.shape) for x in tst]
    for c in range(10):
        chunk = audio[c * 3200:(c + 1) * 3200]
        jst, jp = js.process(jst, chunk)
        tst, tp = ts.process(tst, chunk)
        assert tp.shape == (12,)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=SMOOTH_ATOL, rtol=0)
    assert [tuple(x.shape) for x in tst] == shapes  # O(1) state
    assert int(tst.frames_seen) == 200 and int(tst.windows_seen) == 10
    np.testing.assert_array_equal(tst.sample_tail.numpy(), audio[-480:])


@pytest.mark.parametrize("masked", [False, True])
def test_batch_streamer_matches_jax(narrow, masked):
    fmodel, variables, model = narrow
    n, chunk, steps = 3, 3200, 5
    kw = dict(smoothing_window=3)
    audio = np.stack([_audio(steps * chunk, seed=20 + i) for i in range(n)])
    jb = jstream.BatchStreamer(fmodel, variables, n, JStreamConfig(**kw), chunk)
    tb = tstream.BatchStreamer(model, None, n, StreamConfig(**kw), chunk)
    jst, tst = jb.reset(), tb.reset()
    masks = [np.array([True, t % 2 == 0, t != 2]) for t in range(steps)]
    for t in range(steps):
        chunks = audio[:, t * chunk:(t + 1) * chunk]
        mask = masks[t] if masked else None
        before = [x.clone() for x in tst]
        jst, jp = jb.process(jst, chunks, mask)
        tst, tp = tb.process(tst, chunks, mask)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=SMOOTH_ATOL, rtol=0)
        if masked:
            for i in np.flatnonzero(~mask):  # a masked slot keeps its state bit for bit
                assert all(torch.equal(b[i], a[i]) for b, a in zip(before, tst))
                assert (tp[i] == 0).all()
    # Streams never interact: each row equals a lone Streamer fed only its own chunks.
    for i in range(n):
        s = tstream.Streamer(model, None, StreamConfig(**kw), chunk)
        st = s.reset()
        for t in range(steps):
            if not masked or masks[t][i]:
                st, p = s.process(st, audio[i, t * chunk:(t + 1) * chunk])
        np.testing.assert_allclose(tst.post_ring[i].numpy(), st.post_ring.numpy(), atol=1e-6, rtol=0)


def test_int16_chunks_equal_float_chunks(narrow):
    """int16 chunks are decoded on the device as ``x * (1 / 32768)``: the
    same result, bit for bit, as float chunks of ``i / 32768``."""
    _, _, model = narrow
    pcm = (np.random.default_rng(9).standard_normal((2, 4 * 3200)) * 9000).astype(np.int16)
    as_float = pcm.astype(np.float32) / 32768.0
    s = tstream.Streamer(model, None, StreamConfig(smoothing_window=3), 3200)
    b = tstream.BatchStreamer(model, None, 2, StreamConfig(smoothing_window=3), 3200)
    sf, si, bf, bi = s.reset(), s.reset(), b.reset(), b.reset()
    for c in range(4):
        sl = slice(c * 3200, (c + 1) * 3200)
        sf, pf = s.process(sf, as_float[0, sl])
        si, pi = s.process(si, pcm[0, sl])
        assert torch.equal(pf, pi)
        bf, qf = b.process(bf, as_float[:, sl], np.array([True, c != 1]))
        bi, qi = b.process(bi, pcm[:, sl], np.array([True, c != 1]))
        assert torch.equal(qf, qi)
    assert all(torch.equal(x, y) for x, y in zip(bf, bi))


def test_streamer_set_variables_matches_jax(narrow):
    """Weights swapped between steps reach the next step, as in the JAX
    Streamer; the caller's model keeps its own weights."""
    fmodel, variables, model = narrow
    new_vars = jax.tree.map(np.asarray, dict(
        fmodel.init(jax.random.PRNGKey(123), jnp.zeros((1, 101, 40), jnp.float32), train=False)))
    kw = dict(smoothing_window=3)
    a0, a1 = _audio(3200, seed=30), _audio(3200, seed=31)
    js = jstream.Streamer(fmodel, variables, JStreamConfig(**kw), 3200)
    ts = tstream.Streamer(model, None, StreamConfig(**kw), 3200)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jst, jp0 = js.process(js.reset(), a0)
    tst, tp0 = ts.process(ts.reset(), a0)
    js.set_variables(new_vars)
    ts.set_variables(from_flax_variables(new_vars))
    jst, jp1 = js.process(jst, a1)
    tst, tp1 = ts.process(tst, a1)
    np.testing.assert_allclose(tp0.numpy(), np.asarray(jp0), atol=SMOOTH_ATOL, rtol=0)
    np.testing.assert_allclose(tp1.numpy(), np.asarray(jp1), atol=SMOOTH_ATOL, rtol=0)
    assert not np.allclose(tp1.numpy(), tp0.numpy(), atol=1e-3)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


def test_chunk_must_fit_the_hop_and_the_window(narrow):
    _, _, model = narrow
    for bad in (3000, 16320, 0):
        with pytest.raises(ValueError, match="multiple"):
            tstream.Streamer(model, None, None, bad)


# ---- the ground-truth track (tests/test_stream.py) ----

DETECT_KEYWORDS = ["yes", "stop", "go", "left", "no", "right"]
DETECT_CFG = dict(min_gap_windows=10, smoothing_window=3, detection_threshold=0.6)


@pytest.fixture(scope="module")
def track():
    audio, positions = tdemo.synthesize_long_audio(DETECT_KEYWORDS, seconds=60, seed=7, gap_s=8.0, noise_amp=0.01)
    fmodel = jfind_model("res8")(config=jfind_config("res8"))
    variables = jload_honk_checkpoint(ZOO_RES8)
    model = load_honk_checkpoint(ZOO_RES8, find_model("res8")(find_config("res8"))).eval()
    return audio, positions, fmodel, variables, model


def _assert_ground_truth(events, positions):
    assert [LABELS[e.label] for e in events] == [w for _, w in positions]
    for e, (t, _) in zip(events, positions):
        assert abs(e.time_s - t) <= 0.25


def test_track_is_the_jax_track(track):
    audio, positions = track[:2]
    ref, ref_positions = jdemo.synthesize_long_audio(DETECT_KEYWORDS, seconds=60, seed=7, gap_s=8.0, noise_amp=0.01)
    assert audio.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(audio, ref)
    assert positions == ref_positions and len(positions) == 6


def test_track_offline_detection(track):
    audio, positions, fmodel, variables, model = track
    got, events = tstream.stream_file(model, None, audio, StreamConfig(**DETECT_CFG))
    ref, ref_events = jstream.stream_file(fmodel, variables, audio, JStreamConfig(**DETECT_CFG))
    np.testing.assert_allclose(got, ref, atol=SMOOTH_ATOL, rtol=0)
    _assert_events_equal(events, ref_events)
    _assert_ground_truth(events, positions)
    mask = np.ones(got.shape[0], bool)  # no keyword argmax outside the keywords' neighbourhoods
    for t, _ in positions:
        mask[int((t - 0.6) / 0.2): int((t + 1.6) / 0.2)] = False
    assert (got[mask].argmax(-1) >= 2).sum() == 0


def test_track_online_and_batched_detection(track):
    """Streamer on the track and BatchStreamer on [track, noise]: events equal
    to the JAX package's and to the planted positions, none on the noise."""
    audio, positions, fmodel, variables, model = track
    noise = (0.01 * np.random.default_rng(99).standard_normal(len(audio))).astype(np.float32)
    both = np.stack([audio, noise])
    jcfg, cfg = JStreamConfig(**DETECT_CFG), StreamConfig(**DETECT_CFG)
    js, ts = jstream.Streamer(fmodel, variables, jcfg, 3200), tstream.Streamer(model, None, cfg, 3200)
    jb, tb = jstream.BatchStreamer(fmodel, variables, 2, jcfg, 3200), tstream.BatchStreamer(model, None, 2, cfg, 3200)
    jst, tst, jbs, tbs = js.reset(), ts.reset(), jb.reset(), tb.reset()
    series = {k: [] for k in ("j", "t", "jb", "tb")}
    for c in range(len(audio) // 3200):
        sl = slice(c * 3200, (c + 1) * 3200)
        jst, p = js.process(jst, audio[sl])
        series["j"].append(np.asarray(p))
        tst, p = ts.process(tst, audio[sl])
        series["t"].append(p.numpy())
        jbs, p = jb.process(jbs, both[:, sl])
        series["jb"].append(np.asarray(p))
        tbs, p = tb.process(tbs, both[:, sl])
        series["tb"].append(p.numpy())
    s = {k: np.stack(v) for k, v in series.items()}
    np.testing.assert_allclose(s["t"], s["j"], atol=SMOOTH_ATOL, rtol=0)
    np.testing.assert_allclose(s["tb"], s["jb"], atol=SMOOTH_ATOL, rtol=0)
    online = tstream.detect_stream(s["t"], cfg, 3200)
    _assert_events_equal(online, jstream.detect_stream(s["j"], jcfg, 3200))
    _assert_ground_truth(online, positions)
    batched = tstream.detect_stream(s["tb"][:, 0], cfg, 3200)
    _assert_events_equal(batched, jstream.detect_stream(s["jb"][:, 0], jcfg, 3200))
    _assert_ground_truth(batched, positions)
    assert tstream.detect_stream(s["tb"][:, 1], cfg, 3200) == []


@pytest.mark.parametrize("online", [False, True])
def test_demo_cli_prints_what_the_jax_demo_prints(online):
    flags = ["--model", "res8", "--checkpoint", ZOO_RES8] + (["--online"] if online else [])
    outs = []
    for main, extra in ((tdemo.main, ["--device", "cpu"]), (jdemo.main, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(flags + extra) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "detections over 10.0s audio" in outs[0]


def test_evaluate_long_matches_jax_service():
    from honk_tpu.serve import LabelService as JLabelService

    audio, _ = tdemo.synthesize_long_audio(["go", "no"], seconds=6, seed=3, gap_s=1.0, noise_amp=0.01)
    got = LabelService("res8", ZOO_RES8, device="cpu").evaluate_long(audio)
    ref = JLabelService("res8", ZOO_RES8).evaluate_long(audio)
    assert [(e["time_s"], e["label"]) for e in got] == [(e["time_s"], e["label"]) for e in ref]
    assert got
    for g, r in zip(got, ref):
        assert abs(g["prob"] - r["prob"]) <= SMOOTH_ATOL
