"""Port's stream hub and its HTTP surface (honk_tpu_torch.serve), on the CPU.

Mirrors, case for case, the hub and stream tests of ``tests/test_serve.py``
on the port's res8-narrow service (random weights made by flax from a seed
and carried across with ``from_flax_variables``), with the port's own
``Streamer`` as the independent reference where the JAX tests use theirs.
Then one test per fault the JAX hub keeps and the port's must not (tick
history kept alive, an empty push that dispatches, a shutdown that races
the fetcher pool's start), and one test that sends the same chunks through
the JAX hub and the port's and compares the event JSON.
"""

import base64
import gc
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from honk_tpu.models import find_config as jfind_config
from honk_tpu.models import find_model as jfind_model
from honk_tpu_torch.config import StreamConfig
from honk_tpu_torch.models import from_flax_variables
from honk_tpu_torch.serve import LabelService, StreamHub, serve
from honk_tpu_torch.stream import Streamer, detect_stream


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


def _flax_variables(seed):
    fmodel = jfind_model("res8-narrow")(config=jfind_config("res8-narrow"))
    return jax.tree.map(np.asarray, dict(
        fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 101, 40), jnp.float32), train=False)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "res8-narrow.pt"
    torch.save(from_flax_variables(_flax_variables(0)), path)
    return str(path)


@pytest.fixture(scope="module")
def service(checkpoint):
    return LabelService("res8-narrow", checkpoint, device="cpu")


def _reference(service, scfg, audio, chunk):
    """Independent Streamers, one per row of ``audio``: (n, ticks, n_labels)."""
    out = []
    for row in audio:
        s = Streamer(service.model, None, scfg, chunk)
        st = s.reset()
        posts = []
        for t in range(row.shape[0] // chunk):
            st, post = s.process(st, row[t * chunk:(t + 1) * chunk])
            posts.append(post.numpy())
        out.append(np.stack(posts))
    return out


class _Server:
    def __init__(self, service, **kw):
        self.httpd = serve(service, port=0, **kw)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _post_bin(port, sids, rows, posterior=False):
    """POST /stream/push_bin: u32 header_len | header JSON | PCM16 LE."""
    header = json.dumps({"stream_ids": sids, "posterior": posterior}).encode()
    pcm = (np.concatenate(rows) * 32767).astype("<i2").tobytes()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/stream/push_bin", data=len(header).to_bytes(4, "little") + header + pcm,
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _b64(x):
    return base64.b64encode((x * 32767).astype("<i2").tobytes()).decode()


class Boom:
    """A device result whose fetch fails."""

    def __array__(self, *a, **k):
        raise RuntimeError("device lost")


# ---- the JAX package's hub and stream cases (tests/test_serve.py) ----

def test_http_stream_sessions_match_independent_streamers(service):
    scfg = StreamConfig(smoothing_window=3)
    n, chunk = 3, 3200
    audio = (np.random.default_rng(11).standard_normal((n, 6 * chunk)) * 0.1).astype(np.float32)
    ref = _reference(service, scfg, audio, chunk)
    with _Server(service, n_stream_slots=4, stream_cfg=scfg) as srv:
        sids = [_post(srv.port, "/stream/open", {})["stream_id"] for _ in range(n)]
        order = [0, 0, 1, 2, 0, 1, 2, 2, 1, 0, 1, 2, 0, 1, 2, 0, 1, 2]
        cursor = [0] * n
        for i in order:
            t = cursor[i]
            out = _post(srv.port, "/stream/push",
                        {"stream_id": sids[i], "wav_data": _b64(audio[i, t * chunk:(t + 1) * chunk])})
            np.testing.assert_allclose(out["posterior"], ref[i][t], atol=2e-3)  # int16 quantization
            cursor[i] = t + 1
        assert cursor == [6, 6, 6]
        assert "events" in _post(srv.port, "/stream/close", {"stream_id": sids[0]})
        sid_new = _post(srv.port, "/stream/open", {})["stream_id"]  # reused slot, fresh state
        out = _post(srv.port, "/stream/push", {"stream_id": sid_new, "wav_data": _b64(audio[0, :chunk])})
        np.testing.assert_allclose(out["posterior"], ref[0][0], atol=2e-3)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "/stream/push", {"stream_id": "nope", "wav_data": ""})
        assert e.value.code == 404


def test_label_service_batch_streamer(service):
    bs = service.make_batch_streamer(4, chunk_samples=3200)
    rng = np.random.default_rng(9)
    state = bs.reset()
    for _ in range(6):
        state, post = bs.process(state, (rng.standard_normal((4, 3200)) * 0.1).astype(np.float32))
    assert post.shape == (4, len(service.labels))
    np.testing.assert_allclose(post.sum(-1).numpy(), 1.0, atol=1e-4)


def test_stream_hub_slots_and_errors(service):
    hub = StreamHub(service, n_slots=2, chunk_samples=3200)
    a, b = hub.open(), hub.open()
    with pytest.raises(RuntimeError):
        hub.open()
    chunk = (np.random.default_rng(1).standard_normal(3200) * 0.1).astype(np.float32)
    out = hub.push(a, chunk)
    assert set(out) == {"posterior", "label", "prob", "events"}
    with pytest.raises(ValueError):
        hub.push(a, chunk[:100])
    hub.close(a)
    with pytest.raises(KeyError):
        hub.push(a, chunk)
    c = hub.open()  # freed slot is reusable, with fresh state
    assert hub.push(c, chunk)["posterior"] == out["posterior"]
    hub.close(b)
    hub.close(c)


def test_stream_push_many_matches_individual_pushes(service):
    scfg = StreamConfig(smoothing_window=3)
    n, chunk, ticks = 3, 3200, 4
    audio = (np.random.default_rng(21).standard_normal((n, ticks * chunk)) * 0.1).astype(np.float32)
    hub_a = StreamHub(service, n_slots=4, cfg=scfg, chunk_samples=chunk)
    hub_b = StreamHub(service, n_slots=4, cfg=scfg, chunk_samples=chunk)
    sids_a = [hub_a.open() for _ in range(n)]
    sids_b = [hub_b.open() for _ in range(n)]
    for t in range(ticks):
        batched = hub_a.push_many({sids_a[i]: audio[i, t * chunk:(t + 1) * chunk] for i in range(n)})
        for i in range(n):
            single = hub_b.push(sids_b[i], audio[i, t * chunk:(t + 1) * chunk])
            np.testing.assert_allclose(batched[sids_a[i]]["posterior"], single["posterior"], atol=1e-5)
    hub_c = StreamHub(service, n_slots=4, cfg=scfg, chunk_samples=chunk)
    sids_c = [hub_c.open() for _ in range(n)]
    ref = hub_c.push_many({sids_c[i]: audio[i, :chunk] for i in range(n)})
    with _Server(service, n_stream_slots=4, stream_cfg=scfg) as srv:
        sids = [_post(srv.port, "/stream/open", {})["stream_id"] for _ in range(n)]
        out = _post(srv.port, "/stream/push_many", {"chunks": {sids[i]: _b64(audio[i, :chunk]) for i in range(n)}})
        assert set(out["results"]) == set(sids)
        for i in range(n):
            np.testing.assert_allclose(out["results"][sids[i]]["posterior"], ref[sids_c[i]]["posterior"], atol=2e-3)


def test_http_demo_page_and_long_audio(service):
    """GET / serves the demo page with its LIVE mode; POST /stream runs
    evaluate_long; /train without positives is 400; with no hub /stream/* is 503."""
    with _Server(service, n_stream_slots=0) as srv:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/", timeout=60) as r:
            assert r.headers["Content-Type"].startswith("text/html")
            page = r.read().decode()
        assert "/listen" in page and "/stream/open" in page and "/stream/push" in page and "/stream/close" in page
        assert json.dumps(service.labels) in page
        audio = (np.random.default_rng(2).standard_normal(48000) * 0.1).astype(np.float32)
        out = _post(srv.port, "/stream", {"wav_data": _b64(audio)})
        decoded = (audio * 32767).astype("<i2").astype(np.float32) / 32768.0  # what the server decodes
        assert out == {"detections": service.evaluate_long(decoded)}
        for path, code in (("/train", 400), ("/stream/open", 503), ("/stream/push_bin", 503)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, path, {})
            assert e.value.code == code, path
            if path == "/train":
                assert "positives/label missing" in json.loads(e.value.read())["error"]


def test_stream_session_incremental_matches_batch_recompute(service):
    scfg = StreamConfig(smoothing_window=3, detection_threshold=0.1, min_gap_windows=3)
    chunk, ticks = 3200, 40
    hub = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk)
    sid = hub.open()
    rng = np.random.default_rng(41)
    series, incremental = [], []
    for _ in range(ticks):
        out = hub.push(sid, (rng.standard_normal(chunk) * 0.3).astype(np.float32))
        series.append(np.asarray(out["posterior"], np.float32))
        incremental.extend(out["events"])
    batch = [{"time_s": round(e.time_s, 3), "label": service.labels[e.label], "prob": round(e.score, 4)}
             for e in detect_stream(np.stack(series), scfg, chunk)]
    assert batch, "the scenario must produce events"
    assert [(e["time_s"], e["label"]) for e in incremental] == [(e["time_s"], e["label"]) for e in batch]
    for a, b in zip(incremental, batch):
        assert abs(a["prob"] - b["prob"]) < 1e-3
    assert hub.close(sid)["events"] == incremental


def _threads(target, n, timeout):
    errors = []

    def run(i):
        try:
            target(i)
        except Exception as e:  # surfaced through errors
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
        assert not th.is_alive(), "hub deadlocked"
    assert not errors, errors


def test_stream_hub_concurrent_load(service):
    scfg = StreamConfig(smoothing_window=3)
    n_threads, chunk, ticks = 4, 3200, 6
    hub = StreamHub(service, n_slots=n_threads, cfg=scfg, chunk_samples=chunk)
    audio = (np.random.default_rng(77).standard_normal((n_threads, ticks * chunk)) * 0.1).astype(np.float32)
    ref = _reference(service, scfg, audio, chunk)

    def worker(i):
        for _round in range(2):  # close + reopen: slot recycling under load
            sid = hub.open()
            for t in range(ticks):
                out = hub.push(sid, audio[i, t * chunk:(t + 1) * chunk])
                np.testing.assert_allclose(np.asarray(out["posterior"]), ref[i][t], atol=1e-5)
            hub.close(sid)

    _threads(worker, n_threads, 120)
    for sid in [hub.open() for _ in range(n_threads)]:
        hub.close(sid)


def test_hub_set_variables_reaches_open_sessions(service, checkpoint):
    scfg = StreamConfig(smoothing_window=3)
    chunk = 3200
    new_vars = from_flax_variables(_flax_variables(123))
    rng = np.random.default_rng(55)
    a0, a1 = ((rng.standard_normal(chunk) * 0.1).astype(np.float32) for _ in range(2))
    s = Streamer(service.model, None, scfg, chunk)
    st, p0 = s.process(s.reset(), a0)
    s.set_variables(new_vars)
    st, p1 = s.process(st, a1)
    hub = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk)
    sid = hub.open()
    out0 = hub.push(sid, a0)
    hub.set_variables(new_vars)
    out1 = hub.push(sid, a1)
    np.testing.assert_allclose(np.asarray(out0["posterior"]), p0.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out1["posterior"]), p1.numpy(), atol=1e-5)
    assert not np.allclose(p1.numpy(), p0.numpy(), atol=1e-3)
    hub.close(sid)
    # The service's own weights are untouched: /listen still answers as before.
    fresh = LabelService("res8-narrow", checkpoint, device="cpu")
    x = (rng.standard_normal((1, 16000)) * 0.1).astype(np.float32)
    assert service.evaluate_batch(x) == fresh.evaluate_batch(x)


def test_stream_hub_survives_fetch_failure(service):
    hub = StreamHub(service, n_slots=2, chunk_samples=3200)
    sid = hub.open()
    chunk = np.zeros(3200, np.float32)
    real_process = hub._bs.process

    def bad_process(state, chunks, mask):
        state, _post = real_process(state, chunks, mask)
        return state, Boom()

    hub._bs.process = bad_process
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            hub.push(sid, chunk)
    finally:
        hub._bs.process = real_process
    assert "posterior" in hub.push(sid, chunk)  # still usable, no deadlock
    assert "events" in hub.close(sid)


def test_stream_push_bin_matches_json_push_many(service):
    scfg = StreamConfig(smoothing_window=3)
    n, chunk, ticks = 3, 3200, 3
    audio = (np.random.default_rng(33).standard_normal((n, ticks * chunk)) * 0.1).astype(np.float32)
    audio = (audio * 32767).astype(np.int16).astype(np.float32) / 32767.0
    with _Server(service, n_stream_slots=2 * n, stream_cfg=scfg) as srv:
        sids_bin = [_post(srv.port, "/stream/open", {})["stream_id"] for _ in range(n)]
        sids_json = [_post(srv.port, "/stream/open", {})["stream_id"] for _ in range(n)]
        for t in range(ticks):
            rows = [audio[i, t * chunk:(t + 1) * chunk] for i in range(n)]
            out_bin = _post_bin(srv.port, sids_bin, rows, posterior=(t == ticks - 1))
            out_json = _post(srv.port, "/stream/push_many", {"chunks": {sids_json[i]: _b64(rows[i]) for i in range(n)}})
            for i in range(n):
                b, j = out_bin["results"][sids_bin[i]], out_json["results"][sids_json[i]]
                assert b["label"] == j["label"] and abs(b["prob"] - j["prob"]) < 2e-3
                assert [e["label"] for e in b["events"]] == [e["label"] for e in j["events"]]
                if t == ticks - 1:
                    np.testing.assert_allclose(b["posterior"], j["posterior"], atol=2e-3)
                else:
                    assert "posterior" not in b
        header = json.dumps({"stream_ids": sids_bin}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/stream/push_bin",
                                     data=len(header).to_bytes(4, "little") + header + b"\x00\x00",
                                     headers={"Content-Type": "application/octet-stream"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400


def test_stream_open_slot_exhaustion_is_503(service):
    with _Server(service, n_stream_slots=1) as srv:
        sid = _post(srv.port, "/stream/open", {})["stream_id"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "/stream/open", {})
        assert e.value.code == 503
        _post(srv.port, "/stream/close", {"stream_id": sid})


def test_hub_coalesces_concurrent_pushes(service):
    scfg = StreamConfig(smoothing_window=3)
    n_threads, chunk, ticks = 4, 3200, 5
    hub = StreamHub(service, n_slots=n_threads, cfg=scfg, chunk_samples=chunk, coalesce_ms=200.0)
    audio = (np.random.default_rng(91).standard_normal((n_threads, ticks * chunk)) * 0.1).astype(np.float32)
    ref = _reference(service, scfg, audio, chunk)
    dispatches = [0]
    real_process = hub._bs.process

    def counting_process(state, chunks, mask):
        dispatches[0] += 1
        return real_process(state, chunks, mask)

    hub._bs.process = counting_process
    sids = [hub.open() for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads)

    def worker(i):
        for t in range(ticks):
            barrier.wait(timeout=60)
            out = hub.push(sids[i], audio[i, t * chunk:(t + 1) * chunk])
            np.testing.assert_allclose(np.asarray(out["posterior"]), ref[i][t], atol=1e-5)

    _threads(worker, n_threads, 120)
    assert dispatches[0] <= n_threads * ticks * 0.75, dispatches[0]
    for sid in sids:
        hub.close(sid)


def test_fetch_failure_degrades_session_with_aligned_times(service):
    scfg = StreamConfig(smoothing_window=2, detection_threshold=0.05, min_gap_windows=1)
    chunk, ticks, fail_at = 3200, 8, 3
    audio = (np.random.default_rng(7).standard_normal((ticks, chunk)) * 0.3).astype(np.float32)
    hub_ok = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk)
    hub_bad = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk)
    sid_ok, sid_bad = hub_ok.open(), hub_bad.open()
    real_process = hub_bad._bs.process

    def bad_process(state, chunks, mask):
        state, _post = real_process(state, chunks, mask)
        return state, Boom()

    ok_events, bad_events = [], []
    for t in range(ticks):
        out_ok = hub_ok.push(sid_ok, audio[t])
        ok_events.append(out_ok["events"])
        if t == fail_at:
            hub_bad._bs.process = bad_process
            with pytest.raises(RuntimeError, match="device lost"):
                hub_bad.push(sid_bad, audio[t])
            hub_bad._bs.process = real_process
            bad_events.append([])
        else:
            out_bad = hub_bad.push(sid_bad, audio[t])
            bad_events.append(out_bad["events"])
            assert (out_bad.get("degraded") is True) == (t > fail_at)
        assert "degraded" not in out_ok
    for t in range(ticks):
        if t != fail_at:
            assert bad_events[t] == ok_events[t], (t, bad_events[t], ok_events[t])
    closed_bad = hub_bad.close(sid_bad)
    assert closed_bad.get("degraded") is True
    assert hub_ok.close(sid_ok)["events"] == [e for evs in ok_events for e in evs]
    assert closed_bad["events"] == [e for t, evs in enumerate(ok_events) if t != fail_at for e in evs]
    assert sum(len(e) for e in ok_events) >= 1, "scenario produced no events"


def test_pipelined_hub_is_exactly_lag_one(service):
    scfg = StreamConfig(smoothing_window=3, detection_threshold=0.05, min_gap_windows=2)
    chunk, ticks = 3200, 10
    audio = (np.random.default_rng(17).standard_normal((ticks, chunk)) * 0.3).astype(np.float32)
    hub_sync = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk)
    hub_pipe = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk, pipelined=True)
    sid_s, sid_p = hub_sync.open(), hub_pipe.open()
    sync_out = [hub_sync.push(sid_s, a) for a in audio]
    pipe_out = [hub_pipe.push(sid_p, a) for a in audio]
    assert pipe_out[0].get("pending") is True and pipe_out[0]["events"] == []
    for t in range(1, ticks):
        assert "pending" not in pipe_out[t]
        for k in ("label", "prob", "posterior", "events"):
            assert pipe_out[t][k] == sync_out[t - 1][k]
    closed_s, closed_p = hub_sync.close(sid_s), hub_pipe.close(sid_p)
    assert closed_p["events"] == closed_s["events"]
    assert len(closed_s["events"]) >= 1, "scenario produced no events"
    hub_pipe.shutdown()


def test_pipelined_hub_concurrent_sessions_match_streamers(service):
    scfg = StreamConfig(smoothing_window=3)
    n_threads, chunk, ticks = 4, 3200, 6
    hub = StreamHub(service, n_slots=n_threads, cfg=scfg, chunk_samples=chunk, coalesce_ms=50.0, pipelined=True)
    audio = (np.random.default_rng(23).standard_normal((n_threads, ticks * chunk)) * 0.1).astype(np.float32)
    ref = _reference(service, scfg, audio, chunk)
    sids = [hub.open() for _ in range(n_threads)]

    def worker(i):
        for t in range(ticks):
            out = hub.push(sids[i], audio[i, t * chunk:(t + 1) * chunk])
            if t == 0:
                assert out.get("pending") is True
            else:
                np.testing.assert_allclose(np.asarray(out["posterior"]), ref[i][t - 1], atol=1e-5)

    _threads(worker, n_threads, 120)
    for sid in sids:
        hub.close(sid)
    hub.shutdown()


def test_pipelined_hub_open_close_churn(service):
    scfg = StreamConfig(smoothing_window=3)
    chunk, ticks, churn_rounds = 3200, 4, 3
    hub = StreamHub(service, n_slots=4, cfg=scfg, chunk_samples=chunk, coalesce_ms=10.0, pipelined=True)
    audio = (np.random.default_rng(101).standard_normal((4, ticks * chunk)) * 0.1).astype(np.float32)
    ref = _reference(service, scfg, audio, chunk)

    def churner(i):
        for _ in range(churn_rounds):
            sid = hub.open()
            for t in range(ticks):
                out = hub.push(sid, audio[i, t * chunk:(t + 1) * chunk])
                if t == 0:
                    assert out.get("pending") is True
                else:
                    np.testing.assert_allclose(np.asarray(out["posterior"]), ref[i][t - 1], atol=1e-5)
            hub.close(sid)

    _threads(churner, 4, 180)
    for sid in [hub.open() for _ in range(4)]:
        hub.close(sid)
    hub.shutdown()


def test_int16_wire_hub_matches_float_wire_exactly(service):
    scfg = StreamConfig(smoothing_window=3, detection_threshold=0.05, min_gap_windows=2)
    chunk, ticks = 3200, 6
    pcm = (np.random.default_rng(61).standard_normal((ticks, chunk)) * 9000).astype(np.int16)
    as_float = pcm.astype(np.float32) / 32768.0
    hub_f = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk)
    hub_i = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk, wire_dtype="int16")
    sid_f, sid_i = hub_f.open(), hub_i.open()
    for t in range(ticks):
        out_f, out_i = hub_f.push(sid_f, as_float[t]), hub_i.push(sid_i, as_float[t])
        assert out_i["posterior"] == out_f["posterior"]
        assert out_i["events"] == out_f["events"]
    hub_r = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk, wire_dtype="int16")
    sid_r = hub_r.open()
    for t in range(ticks):
        hub_r.push_rows([sid_r], pcm[t:t + 1])
    assert hub_r.close(sid_r)["events"] == hub_i.close(sid_i)["events"]
    hub_f.close(sid_f)
    with pytest.raises(ValueError, match="wire_dtype"):
        StreamHub(service, wire_dtype="bfloat16")


def test_pipelined_overlapped_pushes_keep_lag_one(service):
    scfg = StreamConfig(smoothing_window=3)
    chunk, ticks = 3200, 8
    hub = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=chunk, pipelined=True)
    audio = (np.random.default_rng(71).standard_normal((ticks, chunk)) * 0.1).astype(np.float32)
    ref = _reference(service, scfg, audio.reshape(1, -1), chunk)[0]
    sid = hub.open()
    sess = hub._sessions[sid]
    outs = [None] * ticks
    with ThreadPoolExecutor(max_workers=2) as pool:
        pending = []
        for t in range(ticks):
            before = sess.last_tick
            pending.append((t, pool.submit(hub.push, sid, audio[t])))
            deadline = time.time() + 30
            while sess.last_tick is before:  # arrival order: t joined a tick before t+1 is sent
                assert time.time() < deadline, "push never joined a tick"
                time.sleep(0.001)
            if len(pending) == 2:
                i, fut = pending.pop(0)
                outs[i] = fut.result(timeout=60)
        for i, fut in pending:
            outs[i] = fut.result(timeout=60)
    assert outs[0].get("pending") is True
    for t in range(1, ticks):
        assert "pending" not in outs[t], (t, outs[t])
        np.testing.assert_allclose(np.asarray(outs[t]["posterior"]), ref[t - 1], atol=1e-5)
    hub.close(sid)
    hub.shutdown()


def test_pipelined_fetch_failure_yields_degraded_pending(service):
    scfg = StreamConfig(smoothing_window=3)
    hub = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=3200, pipelined=True)
    sid = hub.open()
    chunks = (np.random.default_rng(87).standard_normal((6, 3200)) * 0.1).astype(np.float32)
    real_process = hub._bs.process
    fail_once = [True]

    def flaky_process(state, chs, mask):
        state, post = real_process(state, chs, mask)
        if fail_once[0]:
            fail_once[0] = False
            return state, Boom()
        return state, post

    out0 = hub.push(sid, chunks[0])
    assert out0.get("pending") is True and "degraded" not in out0
    hub._bs.process = flaky_process
    try:
        out1 = hub.push(sid, chunks[1])  # dispatch ok, its FETCH fails
    finally:
        hub._bs.process = real_process
    assert "pending" not in out1
    out2 = hub.push(sid, chunks[2])
    assert out2.get("pending") is True and out2.get("degraded") is True
    out3 = hub.push(sid, chunks[3])
    assert "pending" not in out3 and out3.get("degraded") is True
    assert hub.close(sid).get("degraded") is True
    hub.shutdown()


def test_pipelined_dispatch_failure_rolls_back_session_chain(service):
    scfg = StreamConfig(smoothing_window=3)
    hub = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=3200, pipelined=True)
    sid = hub.open()
    chunks = (np.random.default_rng(93).standard_normal((4, 3200)) * 0.1).astype(np.float32)
    assert hub.push(sid, chunks[0]).get("pending") is True
    assert "pending" not in hub.push(sid, chunks[1])
    real_process = hub._bs.process

    def broken_process(state, chs, mask):
        raise RuntimeError("dispatch refused")

    hub._bs.process = broken_process
    try:
        with pytest.raises(RuntimeError, match="dispatch refused"):
            hub.push(sid, chunks[2])
    finally:
        hub._bs.process = real_process
    out2 = hub.push(sid, chunks[2])
    assert "pending" not in out2 and "degraded" not in out2
    hub2 = StreamHub(service, n_slots=2, cfg=scfg, chunk_samples=3200, pipelined=True)
    sid2 = hub2.open()
    hub2.push(sid2, chunks[0])
    hub2.push(sid2, chunks[1])
    assert out2["posterior"] == hub2.push(sid2, chunks[2])["posterior"]
    hub.close(sid)
    hub2.close(sid2)
    hub.shutdown()
    hub2.shutdown()


def test_apply_exception_does_not_wedge_the_hub(service):
    hub = StreamHub(service, n_slots=2, chunk_samples=3200)
    sid = hub.open()
    chunk = np.zeros(3200, np.float32)
    real_apply = hub._apply
    boom = [True]

    def flaky_apply(tick, fetched):
        if boom[0]:
            boom[0] = False
            raise RuntimeError("apply exploded")
        return real_apply(tick, fetched)

    hub._apply = flaky_apply
    with pytest.raises(RuntimeError, match="apply exploded"):
        hub.push(sid, chunk)
    assert "posterior" in hub.push(sid, chunk)
    assert "events" in hub.close(sid)


def test_push_bin_fuzz_never_kills_the_connection(service):
    with _Server(service, n_stream_slots=2) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)

        def post(path, body, ctype="application/octet-stream"):
            conn.request("POST", path, body, {"Content-Type": ctype})
            r = conn.getresponse()
            return r.status, json.loads(r.read())

        status, o = post("/stream/open", b"{}", "application/json")
        assert status == 200
        sid = o["stream_id"]
        good_header = json.dumps({"stream_ids": [sid]}).encode()
        good = len(good_header).to_bytes(4, "little") + good_header + b"\x00\x00" * 3200
        frames = [
            b"", b"\x01", (10**6).to_bytes(4, "little") + b"{}",
            len(b"[1,2]").to_bytes(4, "little") + b"[1,2]",
            len(b'{"x":1}').to_bytes(4, "little") + b'{"x":1}',
            len(good_header).to_bytes(4, "little") + good_header + b"\x00" * 7,
            np.random.default_rng(5).bytes(200),
            len(b'{"stream_ids":["nope"]}').to_bytes(4, "little") + b'{"stream_ids":["nope"]}' + b"\x00\x00" * 3200,
        ]
        for i, frame in enumerate(frames):
            status, err = post("/stream/push_bin", frame)
            assert 400 <= status < 500 and "error" in err, (i, status, err)
            status, ok = post("/stream/push_bin", good)  # the same connection still works
            assert status == 200 and sid in ok["results"], (i, status, ok)
        status, _ = post("/stream/close", json.dumps({"stream_id": sid}).encode(), "application/json")
        assert status == 200
        conn.close()


def test_stream_entry_points_raise_without_cuda(checkpoint):
    """No hidden CPU fallback: without a CUDA device and without an explicit
    CPU device the demo, the serving CLI with its stream flags, and the
    service behind evaluate_long and the hub raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from honk_tpu_torch.cli import demo, serve as cli_serve

    for call in (
        lambda: demo.main(["--model", "res8-narrow", "--checkpoint", checkpoint]),
        lambda: demo.main(["--model", "res8-narrow", "--checkpoint", checkpoint, "--online"]),
        lambda: cli_serve.make_server(["--model", "res8-narrow", "--checkpoint", checkpoint, "--port", "0",
                                       "--stream-slots", "4", "--pipelined"]),
        lambda: LabelService("res8-narrow", checkpoint).evaluate_long(np.zeros(32000, np.float32)),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---- faults of the JAX hub the port does not copy ----

def test_empty_push_rows_dispatches_nothing(service):
    hub = StreamHub(service, n_slots=2, chunk_samples=3200)
    sid = hub.open()
    calls = [0]
    real_process = hub._bs.process

    def counting(state, chunks, mask):
        calls[0] += 1
        return real_process(state, chunks, mask)

    hub._bs.process = counting
    assert hub.push_rows([], np.zeros((0, 3200), np.float32)) == {}
    assert hub.push_many({}) == {}
    assert calls[0] == 0 and hub._last_tick is None and hub._pending is None
    hub.push(sid, np.zeros(3200, np.float32))
    assert calls[0] == 1
    hub.close(sid)


@pytest.mark.parametrize("pipelined", [False, True])
def test_ticks_release_rollback_links_and_device_results(service, pipelined):
    """After dispatch a tick drops its links to earlier ticks, and after
    fetch its device result: a long session does not keep its history."""
    hub = StreamHub(service, n_slots=2, chunk_samples=3200, pipelined=pipelined)
    sid = hub.open()
    sess = hub._sessions[sid]
    first = None
    for t in range(6):
        hub.push(sid, np.zeros(3200, np.float32))
        tick = sess.last_tick
        first = first or tick
        assert tick.prev_of is None and tick.chunks is None
    hub.close(sid)  # flushes the last tick
    assert sess.last_tick.future is None and first.future is None
    first_id = id(first)
    del first, tick
    gc.collect()
    assert all(id(o) != first_id for o in gc.get_objects() if type(o).__name__ == "_Tick")
    hub.shutdown()


def test_shutdown_racing_first_pipelined_push_does_not_hang(service):
    for trial in range(20):
        hub = StreamHub(service, n_slots=2, chunk_samples=3200, pipelined=True)
        sid = hub.open()
        chunk = np.zeros(3200, np.float32)
        start = threading.Barrier(2)
        outs = []

        def pusher():
            start.wait(timeout=30)
            outs.append(hub.push(sid, chunk))
            outs.append(hub.push(sid, chunk))

        def stopper():
            start.wait(timeout=30)
            if trial % 2:
                time.sleep(0.0005 * trial)
            hub.shutdown()

        threads = [threading.Thread(target=f) for f in (pusher, stopper)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive(), f"trial {trial}: hung"
        assert outs[0].get("pending") is True and "pending" not in outs[1]
        assert "events" in hub.close(sid)  # the last tick is flushed, after shutdown too
        assert all(not th.is_alive() for th in hub._fetchers)
        hub.shutdown()  # idempotent


# ---- the same chunks through the JAX hub and the port's ----

def test_hub_events_equal_jax_hub(checkpoint):
    from honk_tpu.config import StreamConfig as JStreamConfig
    from honk_tpu.serve import LabelService as JLabelService
    from honk_tpu.serve import StreamHub as JStreamHub

    kw = dict(smoothing_window=3, detection_threshold=0.1, min_gap_windows=2)
    port_svc = LabelService("res8-narrow", checkpoint, device="cpu")
    jax_svc = JLabelService("res8-narrow", _flax_variables(0), precision=None)
    hubs = [StreamHub(port_svc, n_slots=3, cfg=StreamConfig(**kw), chunk_samples=3200),
            JStreamHub(jax_svc, n_slots=3, cfg=JStreamConfig(**kw), chunk_samples=3200)]
    audio = (np.random.default_rng(5).standard_normal((3, 12 * 3200)) * 0.3).astype(np.float32)
    pcm = (audio * 32767).astype(np.int16)
    outs = []
    for hub in hubs:
        sids = [hub.open() for _ in range(3)]
        events = []
        for t in range(12):
            res = hub.push_rows(sids[: 2 + t % 2], pcm[: 2 + t % 2, t * 3200:(t + 1) * 3200], want_posterior=False)
            events.append([(res[s]["label"], res[s]["events"]) for s in sids[: 2 + t % 2]])
        outs.append((events, [hub.close(s) for s in sids]))
    assert sum(len(c["events"]) for c in outs[1][1]) >= 1, "the scenario must produce events"
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]
