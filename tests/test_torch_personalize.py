"""Port's personalization slice (AudioSnippet, TrainingService, POST /train) against the JAX package, on the CPU.

Mirrors the snippet and personalization tests of ``tests/test_serve.py`` on
the port, holds every ``AudioSnippet`` method bit for bit against the JAX
class, and three fine-tune steps of res8-narrow and cnn-trad-pool2 (their
committed checkpoints) against ``honk_tpu.serve.TrainingService`` within
1e-4 in loss and every weight. Then the weight swap (``set_variables``
builds a new module; the old one keeps its weights), ``/train`` over HTTP
(``/listen`` and an open hub session answer with the new weights), and the
400 and 503 answers, including the unknown label and the empty positives
on which the JAX server drops the connection.
"""

import base64
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu.audio import AudioSnippet as JAudioSnippet
from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu.serve import LabelService as JLabelService
from honk_tpu.serve import TrainingService as JTrainingService
from honk_tpu_torch.audio import AudioSnippet
from honk_tpu_torch.cli import serve as cli_serve
from honk_tpu_torch.config import StreamConfig
from honk_tpu_torch.data.synthetic import DEFAULT_WORDS, _word_signal
from honk_tpu_torch.models import from_flax_variables
from honk_tpu_torch.serve import LabelService, StreamHub, TrainingService, serve

ROOT = Path(__file__).resolve().parents[1]
ZOO = ROOT / "zoo"
# Loss and weights after three fine-tune steps, port against JAX: the
# train-step gate of tests/test_torch_train.py.
TRAIN_ATOL = 1e-4
CHUNK = 3200


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Small tensors, one op at a time: one intra-op thread, so test
    processes on one host do not starve each other's OpenMP workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _keyword(scale=0.4, freq=700.0):
    """The positive of tests/test_serve.py: a 1 s tone burst under a Gaussian envelope."""
    t = np.arange(16000) / 16000.0
    return (scale * np.sin(2 * np.pi * freq * t) * np.exp(-((t - 0.5) ** 2) / 0.05)).astype(np.float32)


def _word(word, seed):
    """A keyword of the synthetic generator (the one planted in the streaming
    tracks) over a 0.01 noise floor. (A pure tone is a poor input for a
    parity test: its far mel bins hold only rounding noise, whose log differs
    between any two f32 frontends, and a few steps of SGD amplify that.)"""
    rng = np.random.default_rng(seed)
    clip = _word_signal(DEFAULT_WORDS.index(word), speaker=0, n=0, sr=16000, rng=rng)
    return (clip + rng.standard_normal(16000) * 0.01).astype(np.float32)


def _pcm16(audio):
    return np.clip(np.round(audio * 32767), -32768, 32767).astype(np.int16)


def _b64(pcm):
    return base64.b64encode(pcm.tobytes()).decode()


# ---- AudioSnippet (mirrors tests/test_serve.py) ----
def test_snippet_trim():
    x = np.zeros(16000, np.float32)
    x[4000:8000] = 0.5 * np.sin(np.linspace(0, 200, 4000))
    s = AudioSnippet(x).trim(threshold=0.05)
    assert 3800 <= len(s) <= 4400  # keeps only the loud span (window quantized)


def test_snippet_trim_window_finds_energy():
    x = np.zeros(48000, np.float32)
    x[30000:34000] = 0.8
    s = AudioSnippet(x).trim_window(16000)
    assert len(s) == 16000
    assert s.data.sum() > 3000 * 0.8  # the energetic span is inside


def test_snippet_contrastive():
    x = np.sin(np.linspace(0, 100, 16000)).astype(np.float32)
    negs = AudioSnippet(x).generate_contrastive(8)
    assert len(negs) == 8
    for n in negs:
        assert len(n) == 16000
        assert not np.array_equal(n.data, x)


def test_snippet_all_silent_trim():
    s = AudioSnippet(np.zeros(8000, np.float32)).trim()
    assert len(s) == 0


def _same(got, want):
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snippet_methods_equal_jax(seed):
    """Every method on seeded audio (quiet margins around a loud span), bit for bit."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(7000, 40000))
    x = (rng.standard_normal(n) * 0.003).astype(np.float32)
    lo = int(rng.integers(0, n // 2))
    x[lo : lo + n // 3] += (rng.standard_normal(n // 3) * 0.3).astype(np.float32)
    for thr in (0.01, 0.05):
        for method in ("trim", "ltrim", "rtrim"):
            _same(getattr(AudioSnippet(x), method)(thr).data, getattr(JAudioSnippet(x), method)(thr).data)
        _same(AudioSnippet(x).trim(thr, window=320).data, JAudioSnippet(x).trim(thr, window=320).data)
    for size in (8000, 16000, 48000):
        _same(AudioSnippet(x).trim_window(size).pad_to(size).data, JAudioSnippet(x).trim_window(size).pad_to(size).data)
        for stride in (None, 4000):
            got, want = AudioSnippet(x).chunk(size, stride), JAudioSnippet(x).chunk(size, stride)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _same(g.data, w.data)
    got, want = AudioSnippet(x).generate_contrastive(8, seed), JAudioSnippet(x).generate_contrastive(8, seed)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _same(g.data, w.data)
    assert AudioSnippet(np.zeros(0, np.float32)).generate_contrastive(4, seed) == []
    snip = AudioSnippet(x)
    twin = snip.copy()
    snip.trim(0.05)
    _same(twin.data, x)


# ---- TrainingService against JAX ----
@pytest.mark.parametrize("conf, with_negatives", [("res8-narrow", False), ("cnn-trad-pool2", True)])
def test_fine_tune_matches_jax(conf, with_negatives):
    """Three steps from the committed checkpoint: the loss and every weight within 1e-4."""
    rng = np.random.default_rng(5)
    positives = [_word("yes", 1), _word("yes", 2)[:14000], (rng.standard_normal(20000) * 0.1).astype(np.float32)]
    negatives = [(rng.standard_normal(12000) * 0.1).astype(np.float32)] if with_negatives else None
    path = str(ZOO / f"{conf}.pt")
    want = JTrainingService(JLabelService(conf, path, precision=None), steps=3).fine_tune(
        positives, "yes", negatives=negatives, seed=3)
    port = LabelService(conf, path, device="cpu")
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    got = TrainingService(port, steps=3).fine_tune(positives, "yes", negatives=negatives, seed=3)
    assert abs(got["final_loss"] - want["final_loss"]) <= TRAIN_ATOL
    ref = from_flax_variables(want["variables"])
    assert set(ref) <= set(got["variables"])
    for name, w in ref.items():
        np.testing.assert_allclose(got["variables"][name].numpy(), w.numpy(), rtol=0, atol=TRAIN_ATOL, err_msg=name)
    moved = max(float((got["variables"][k] - before[k]).abs().max()) for k in ref)
    assert moved > 10 * TRAIN_ATOL  # the steps did train
    for k, v in port.model.state_dict().items():  # the service's own model was not trained
        assert torch.equal(v, before[k]), k


@pytest.fixture(scope="module")
def narrow_path():
    return str(ZOO / "res8-narrow.pt")


def test_training_service_personalizes():
    """tests/test_serve.py::test_training_service_personalizes on the port,
    from the same weights (flax's init of res8-narrow, PRNGKey(0))."""
    fmodel = jfind_model("res8-narrow")(config=jfind_config("res8-narrow"))
    variables = fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 101, 40), jnp.float32), train=False)
    positive = _keyword()
    service = LabelService("res8-narrow", from_flax_variables(variables), device="cpu")
    trainer = TrainingService(service, learning_rate=0.05, steps=30)
    result = trainer.fine_tune([positive, positive * 0.9], target_label="yes")
    new_svc = LabelService("res8-narrow", result["variables"], device="cpu")
    label, prob = new_svc.evaluate(positive)
    assert label == "yes", f"personalization failed: {label} ({prob})"


def test_fine_tune_builds_on_current_weights(narrow_path):
    """After set_variables, the next fine-tune starts from the new weights, as JAX's reads base.variables."""
    pos = [_keyword()]
    svc = LabelService("res8-narrow", narrow_path, device="cpu")
    first = TrainingService(svc, steps=2).fine_tune(pos, "yes")
    svc.set_variables(first["variables"])
    second = TrainingService(svc, steps=2).fine_tune(pos, "no")
    fresh = LabelService("res8-narrow", first["variables"], device="cpu")
    again = TrainingService(fresh, steps=2).fine_tune(pos, "no")
    assert second["final_loss"] == again["final_loss"]
    for k, v in again["variables"].items():
        assert torch.equal(second["variables"][k], v), k


def test_fine_tune_refuses_unknown_label_and_no_positives(narrow_path):
    svc = LabelService("res8-narrow", narrow_path, device="cpu")
    trainer = TrainingService(svc, steps=1)
    with pytest.raises(ValueError, match="unknown label 'banana'"):
        trainer.fine_tune([_keyword()], "banana")
    with pytest.raises(ValueError, match="no positives"):
        trainer.fine_tune([], "yes")
    # The JAX method fails on both too, deeper down (list.index, np.stack):
    # its HTTP handler lets that escape and drops the connection.
    jtrainer = JTrainingService(JLabelService("res8-narrow", narrow_path, precision=None), steps=1)
    with pytest.raises(ValueError):
        jtrainer.fine_tune([_keyword()], "banana")
    with pytest.raises(ValueError):
        jtrainer.fine_tune([], "yes")


# ---- LabelService: state dicts and the swap ----
def test_label_service_takes_a_state_dict(narrow_path):
    from_path = LabelService("res8-narrow", narrow_path, device="cpu")
    sd = torch.load(narrow_path, map_location="cpu", weights_only=True)
    from_sd = LabelService("res8-narrow", sd, device="cpu")
    audio = (np.random.default_rng(9).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    assert torch.equal(from_path.logits(audio), from_sd.logits(audio))


def test_set_variables_swaps_and_never_writes_the_old_module(narrow_path):
    svc = LabelService("res8-narrow", narrow_path, device="cpu")
    old_model, old_packed = svc.model, svc._packed
    old_sd = {k: v.clone() for k, v in old_model.state_dict().items()}
    new_sd = TrainingService(svc, steps=2).fine_tune([_keyword()], "yes")["variables"]
    svc.set_variables(new_sd)
    assert svc.model is not old_model and svc._packed is not old_packed
    for k, v in old_model.state_dict().items():
        assert torch.equal(v, old_sd[k]), k
    for k, v in svc.model.state_dict().items():
        assert torch.equal(v, new_sd[k]), k
    audio = (np.random.default_rng(4).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    assert torch.equal(svc.logits(audio), LabelService("res8-narrow", new_sd, device="cpu").logits(audio))
    assert not torch.equal(svc.logits(audio), LabelService("res8-narrow", old_sd, device="cpu").logits(audio))


# ---- /train over HTTP ----
def _request(url, body=None):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Server:
    def __init__(self, httpd):
        self.httpd = httpd
        self.base = f"http://127.0.0.1:{httpd.server_address[1]}"
        self.thread = threading.Thread(target=httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()

    def post(self, path, obj):
        return _request(f"{self.base}{path}", json.dumps(obj).encode())


def test_http_train_round_trip(narrow_path):
    """POST /train: 200, then /listen equals a fresh service built from the
    fine-tune's weights, and a hub session opened before /train scores its
    next chunk with them; the pre-/train module keeps its weights."""
    cfg = StreamConfig()
    positives = [_pcm16(_keyword()), _pcm16(_keyword(0.3, 900.0))]
    decoded = [p.astype(np.float32) / 32768.0 for p in positives]
    rng = np.random.default_rng(11)
    chunks = [(rng.standard_normal(CHUNK) * 0.1).astype(np.float32) for _ in range(2)]
    svc = LabelService("res8-narrow", narrow_path, device="cpu")
    old_model = svc.model
    old_sd = {k: v.clone() for k, v in old_model.state_dict().items()}
    with _Server(serve(svc, port=0, n_stream_slots=2, stream_cfg=cfg, chunk_samples=CHUNK)) as srv:
        sid = srv.post("/stream/open", {})[1]["stream_id"]
        before = srv.post("/stream/push", {"stream_id": sid, "wav_data": _b64(_pcm16(chunks[0]))})[1]
        code, out = srv.post("/train", {"positives": [_b64(p) for p in positives], "label": "yes"})
        assert code == 200 and set(out) == {"final_loss"}
        after = srv.post("/stream/push", {"stream_id": sid, "wav_data": _b64(_pcm16(chunks[1]))})[1]
        listens = [srv.post("/listen", {"wav_data": _b64(p)})[1] for p in positives]

    # The same fine-tune (TrainingService's defaults, seed 0) on a fresh service.
    want = TrainingService(LabelService("res8-narrow", narrow_path, device="cpu")).fine_tune(decoded, "yes")
    # The server trains on its handler thread: equal up to the order of a reduction.
    assert abs(out["final_loss"] - want["final_loss"]) <= 1e-6
    fresh = LabelService("res8-narrow", want["variables"], device="cpu")
    for ans, audio in zip(listens, decoded):
        label, prob = fresh.evaluate(audio)
        assert ans["label"] == label and ans["contains_command"] == (label not in ("__silence__", "__unknown__"))
        assert abs(ans["prob"] - prob) <= 1e-6
    assert [a["label"] for a in listens] == ["yes", "yes"]
    # The hub: old weights for the first chunk, the new ones from the next.
    ref = StreamHub(LabelService("res8-narrow", narrow_path, device="cpu"), 2, cfg, CHUNK)
    rsid = ref.open()
    want_before = ref.push(rsid, _pcm16(chunks[0]).astype(np.float32) / 32768.0)
    ref.set_variables(want["variables"])
    want_after = ref.push(rsid, _pcm16(chunks[1]).astype(np.float32) / 32768.0)
    np.testing.assert_allclose(before["posterior"], want_before["posterior"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(after["posterior"], want_after["posterior"], rtol=0, atol=1e-6)
    assert not np.allclose(after["posterior"], _unswapped_posterior(narrow_path, cfg, chunks), atol=1e-4)
    assert svc.model is not old_model
    for k, v in old_model.state_dict().items():
        assert torch.equal(v, old_sd[k]), k


def _unswapped_posterior(path, cfg, chunks):
    """The second chunk's posterior had the weights not been swapped."""
    hub = StreamHub(LabelService("res8-narrow", path, device="cpu"), 2, cfg, CHUNK)
    sid = hub.open()
    for c in chunks:
        out = hub.push(sid, _pcm16(c).astype(np.float32) / 32768.0)
    return out["posterior"]


@pytest.mark.parametrize("payload, reason", [
    ({}, "positives/label missing"),
    ({"positives": [_b64(_pcm16(_keyword()))]}, "positives/label missing"),
    ({"label": "yes"}, "positives/label missing"),
    ({"positives": "AAAA", "label": "yes"}, "must be a list"),
    ({"positives": ["AAA"], "label": "yes"}, "positives/label missing"),  # not base64
    ({"positives": [], "label": "yes"}, "no positives"),
    ({"positives": [_b64(_pcm16(_keyword()))], "label": "banana"}, "unknown label"),
    ([1, 2], "positives/label missing"),
])
def test_http_train_bad_requests_answer_400(narrow_path, payload, reason):
    svc = LabelService("res8-narrow", narrow_path, device="cpu")
    model = svc.model
    with _Server(serve(svc, port=0, n_stream_slots=0)) as srv:
        code, out = srv.post("/train", payload)
        assert code == 400 and reason in out["error"]
        assert srv.post("/listen", {"wav_data": _b64(_pcm16(_keyword()))})[0] == 200  # still serving
    assert svc.model is model


def test_http_train_disabled_answers_503(narrow_path):
    svc = LabelService("res8-narrow", narrow_path, device="cpu")
    with _Server(serve(svc, port=0, enable_training=False, n_stream_slots=0)) as srv:
        code, out = srv.post("/train", {"positives": [_b64(_pcm16(_keyword()))], "label": "yes"})
        assert code == 503 and out == {"error": "training service disabled"}
    argv = ["--device", "cpu", "--model", "res8-narrow", "--checkpoint", narrow_path, "--port", "0",
            "--stream-slots", "0"]
    for flags, want in (([], 400), (["--no-train"], 503)):
        with _Server(cli_serve.make_server(argv + flags)) as srv:
            assert srv.post("/train", {})[0] == want


def test_http_train_that_diverges_answers_422_and_keeps_the_weights():
    """The reference's defaults (lr 0.01, momentum 0.9, 60 steps, BN frozen)
    diverge on zoo/res8.pt: JAX's fine-tune reaches NaN too, and its server
    would swap those weights in. The port answers 422 and keeps serving the
    old ones."""
    positives = [_word("up", s) for s in (1, 2)]
    path = str(ZOO / "res8.pt")
    jloss = JTrainingService(JLabelService("res8", path, precision=None), steps=20).fine_tune(positives, "go")
    assert not np.isfinite(jloss["final_loss"])
    svc = LabelService("res8", path, device="cpu")
    model = svc.model
    with _Server(serve(svc, port=0, n_stream_slots=0)) as srv:
        code, out = srv.post("/train", {"positives": [_b64(_pcm16(p)) for p in positives], "label": "go"})
        assert code == 422 and "diverged (final loss nan)" in out["error"]
        listened = srv.post("/listen", {"wav_data": _b64(_pcm16(positives[0]))})[1]
    assert svc.model is model
    label, prob = LabelService("res8", path, device="cpu").evaluate(_pcm16(positives[0]).astype(np.float32) / 32768.0)
    assert listened["label"] == label == "up" and listened["prob"] == prob
