"""Port's serving slice (LabelService, HTTP, CLI) against the JAX package, on the CPU.

Also pins what the port must not do: fall back to the CPU when no CUDA
device is present, run convolutions in TF32, or import JAX or the JAX
package at run time.
"""

import ast
import base64
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from honk_tpu.serve import LabelService as JLabelService
from honk_tpu_torch.cli import serve as cli_serve
from honk_tpu_torch.ops import _build
from honk_tpu_torch.serve import LabelService, default_labels, serve

ROOT = Path(__file__).resolve().parents[1]
ZOO_RES8 = str(ROOT / "zoo" / "res8.pt")
# Softmax probabilities of the same checkpoint on the same audio; the logits
# agree within the reference's 2e-4 gate, and softmax does not enlarge that.
PROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def services():
    return (
        LabelService("res8", ZOO_RES8, device="cpu"),
        JLabelService("res8", ZOO_RES8),
    )


def _utterances(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_default_labels_match_reference(services):
    port, ref = services
    assert port.labels == ref.labels == default_labels()


@pytest.mark.parametrize("n_samples", [16000, 12000, 20000])
def test_evaluate_matches_jax_service(services, n_samples):
    port, ref = services
    audio = _utterances(n_samples, n_samples)
    audio[n_samples // 3 : n_samples // 3 + 4000] *= 5  # a loud span for trim_window to find
    label, prob = port.evaluate(audio)
    rlabel, rprob = ref.evaluate(audio)
    assert label == rlabel
    assert abs(prob - rprob) <= PROB_ATOL


@pytest.mark.parametrize("batch", [1, 3])
def test_evaluate_batch_matches_jax_service(services, batch):
    port, ref = services
    audio = _utterances(100 + batch, (batch, 16000))
    got, want = port.evaluate_batch(audio), ref.evaluate_batch(audio)
    assert [lab for lab, _ in got] == [lab for lab, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=PROB_ATOL)


def test_no_hidden_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LabelService("res8", ZOO_RES8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LabelService("res8", ZOO_RES8, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.main(["--model", "res8", "--checkpoint", ZOO_RES8, "--port", "0"])


def test_service_turns_tf32_off():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        LabelService("res8", ZOO_RES8, device="cpu")
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _request(url, body=None):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_listen_labels_and_errors(services):
    port_svc, _ = services
    httpd = serve(port_svc, port=0)  # port 0 = ephemeral
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, body = _request(f"{base}/labels")
        assert code == 200 and json.loads(body)["labels"] == port_svc.labels

        pcm = (np.random.default_rng(0).standard_normal(16000) * 3000).astype(np.int16)
        code, body = _request(
            f"{base}/listen", json.dumps({"wav_data": base64.b64encode(pcm.tobytes()).decode()}).encode()
        )
        out = json.loads(body)
        label, prob = port_svc.evaluate(pcm.astype(np.float32) / 32768.0)
        assert code == 200
        assert out == {
            "contains_command": label not in ("__silence__", "__unknown__"),
            "label": label,
            "prob": prob,
        }

        assert _request(f"{base}/listen", b"not json")[0] == 400
        assert _request(f"{base}/listen", b'{"method": "all"}')[0] == 400  # no wav_data
        assert _request(f"{base}/listen", b'{"wav_data": "AAA"}')[0] == 400  # bad base64
        code, body = _request(f"{base}/train", b"{}")  # training is on by default, as in JAX
        assert code == 400 and "positives/label missing" in json.loads(body)["error"]
        assert _request(f"{base}/stream", b"{}")[0] == 400  # no wav_data
        assert _request(f"{base}/stream/push_bin", b"{}")[0] == 400  # not a binary frame
        assert _request(f"{base}/stream/push", b'{"stream_id": "nope", "wav_data": ""}')[0] == 404
        code, body = _request(f"{base}/stream/open", b"{}")
        assert code == 200 and json.loads(body)["chunk_samples"] == 3200
        assert _request(f"{base}/nope", b"{}")[0] == 404

        code, body = _request(f"{base}/")
        assert code == 200 and b"keyword spotting" in body
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()
    httpd = serve(port_svc, port=0, enable_training=False, n_stream_slots=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        code, body = _request(f"http://127.0.0.1:{httpd.server_address[1]}/train", b"{}")
        assert code == 503 and json.loads(body) == {"error": "training service disabled"}
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_device_calls_of_every_connection_run_on_the_service_worker(monkeypatch):
    """/listen, /stream and hub pushes from 8 client threads, each request on
    a new connection (so a new server thread): every MFCC and res-stack call
    runs on the service's one worker thread, and every answer equals the
    call made from this thread."""
    from concurrent.futures import ThreadPoolExecutor

    from honk_tpu_torch.ops import mfcc_kernel, res_kernel
    from honk_tpu_torch.serve import StreamHub

    idents = set()

    def recorded(fn):
        def call(*args, **kwargs):
            idents.add(threading.get_ident())
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(mfcc_kernel, "mfcc_plain", recorded(mfcc_kernel.mfcc_plain))
    monkeypatch.setattr(res_kernel, "res_stack_plain", recorded(res_kernel.res_stack_plain))
    svc = LabelService("res8", ZOO_RES8, device="cpu")
    rng = np.random.default_rng(9)
    clips = [(rng.standard_normal(16000) * 3000).astype(np.int16) for _ in range(8)]
    long_pcm = (rng.standard_normal(3 * 16000) * 3000).astype(np.int16)
    chunks = (rng.standard_normal((3, 8, 3200)) * 3000).astype(np.int16)
    # The same calls from this thread, and a hub driven from it alone.
    want_listen = [svc.evaluate(c.astype(np.float32) / 32768.0) for c in clips]
    want_stream = svc.evaluate_long(long_pcm.astype(np.float32) / 32768.0)
    ref_hub = StreamHub(LabelService("res8", ZOO_RES8, device="cpu"), 8, chunk_samples=3200)
    ref_sids = [ref_hub.open() for _ in range(8)]
    want_push = [ref_hub.push_rows(ref_sids, chunks[t]) for t in range(3)]

    httpd = serve(svc, port=0, n_stream_slots=8, stream_coalesce_ms=2.0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, obj):
        code, body = _request(f"{base}{path}", json.dumps(obj).encode())
        assert code == 200, body
        return json.loads(body)

    def b64(pcm):
        return base64.b64encode(pcm.tobytes()).decode()

    try:
        sids = [post("/stream/open", {})["stream_id"] for _ in range(8)]
        idents.clear()

        def client(i):
            listen = post("/listen", {"wav_data": b64(clips[i])})
            stream = post("/stream", {"wav_data": b64(long_pcm)}) if i < 2 else None
            pushes = [post("/stream/push", {"stream_id": sids[i], "wav_data": b64(chunks[t, i])}) for t in range(3)]
            return listen, stream, pushes

        with ThreadPoolExecutor(max_workers=8) as pool:
            answers = list(pool.map(client, range(8)))
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()
    assert idents == {svc.worker.ident}
    assert svc.worker.ident not in (threading.get_ident(), th.ident)
    for i, (listen, stream, pushes) in enumerate(answers):
        assert (listen["label"], listen["prob"]) == want_listen[i]
        if stream is not None:
            assert stream["detections"] == want_stream
        for t, got in enumerate(pushes):
            want = want_push[t][ref_sids[i]]
            assert got["label"] == want["label"] and got["events"] == want["events"]
            np.testing.assert_allclose(got["posterior"], want["posterior"], atol=1e-6)


def test_device_worker_runs_every_job_on_one_thread_in_turn():
    """More caller threads than cores, a short switch interval: every job runs on
    the worker's thread, one at a time (a non-atomic counter loses no update),
    each caller gets its own result, a job's exception reaches its caller, and
    a job that calls ``run`` from the worker runs inline."""
    from honk_tpu_torch.serve.worker import DeviceWorker

    worker = DeviceWorker("test-worker")
    state = {"count": 0, "idents": set()}

    def job(i):
        n = state["count"]
        state["idents"].add(threading.get_ident())
        for _ in range(50):
            pass
        state["count"] = n + 1
        return i * i

    def fail(i):
        raise ValueError(f"job {i}")

    n_threads, per_thread = 4 * (os.cpu_count() or 1), 25
    results, nested = {}, []

    def caller(t):
        for k in range(per_thread):
            i = t * per_thread + k
            results[i] = worker.run(job, i)
            with pytest.raises(ValueError, match=f"job {i}"):
                worker.run(fail, i)
        nested.append(worker.run(lambda: worker.run(job, -1)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=caller, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        worker.close()
    assert not any(th.is_alive() for th in threads)
    assert state["count"] == n_threads * (per_thread + 1)
    assert results == {i: i * i for i in range(n_threads * per_thread)}
    assert nested == [1] * n_threads
    assert state["idents"] == {worker.ident}
    with pytest.raises(RuntimeError, match="has stopped"):
        worker.run(job, 0)


def test_server_queues_a_burst_of_new_connections(services):
    """32 connections at once, before the accept loop takes any: each completes
    its handshake at once. socketserver's backlog of 5 (the JAX server's)
    stalls the seventh on, each for a SYN retransmit, a second or more."""
    import socket

    httpd = serve(services[0], port=0, enable_training=False, n_stream_slots=0)  # listening, not serving
    socks = []
    try:
        for _ in range(32):
            s = socket.socket()
            socks.append(s)
            s.settimeout(5.0)
            s.connect(("127.0.0.1", httpd.server_address[1]))  # raises TimeoutError on a full backlog
    finally:
        for s in socks:
            s.close()
        httpd.server_close()
    assert len(socks) == 32


@pytest.mark.parametrize("flag", [["--stream-slots", "4"], ["--pipelined"], ["--wire-dtype=int16"], ["--bogus"]])
def test_cli_refuses_flags_of_later_slices(flag, capsys):
    """The stream hub's flags parse and reach the hub; an unknown flag is refused."""
    argv = ["--device", "cpu", "--checkpoint", ZOO_RES8, "--port", "0", *flag]
    if flag == ["--bogus"]:
        with pytest.raises(SystemExit) as e:
            cli_serve.make_server(argv)
        assert e.value.code == 2 and "unrecognized arguments: --bogus" in capsys.readouterr().err
        return
    httpd = cli_serve.make_server(argv)
    try:
        hub = httpd.hub
        assert hub.n_slots == (4 if flag[0] == "--stream-slots" else 8) and hub.chunk == 3200
        assert hub.pipelined == (flag == ["--pipelined"])
        assert hub.wire_dtype == (np.int16 if flag == ["--wire-dtype=int16"] else np.float32)
    finally:
        httpd.server_close()
    httpd = cli_serve.make_server(["--device", "cpu", "--checkpoint", ZOO_RES8, "--port", "0", "--stream-slots", "0"])
    httpd.server_close()
    assert httpd.hub is None


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent-build-dir"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("mfcc", "res_stack")


def test_build_is_keyed_by_source_and_flags(monkeypatch):
    lib = _build.library_path("mfcc")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libmfcc-")
    assert _build.library_path("res_stack") != lib
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("mfcc") != lib
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def _port_sources():
    pkg = ROOT / "honk_tpu_torch"
    sources = [p for p in pkg.rglob("*.py") if "_build" not in p.relative_to(pkg).parts]
    return sorted(sources) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "honk_tpu"), f"{path}: imports {n}"


def test_port_runtime_loads_no_jax():
    code = (
        "import honk_tpu_torch.serve.http, honk_tpu_torch.serve.streams, honk_tpu_torch.stream, "
        "honk_tpu_torch.cli.serve, honk_tpu_torch.cli.demo, honk_tpu_torch.cli.manage_audio, "
        "honk_tpu_torch.datagen.cli, honk_tpu_torch.cli.train, honk_tpu_torch.parallel.dryrun, "
        "honk_tpu_torch.native, sys; "
        "assert not any(m=='jax' or m=='honk_tpu' or m.startswith(('jax.','honk_tpu.')) "
        "for m in sys.modules)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
