"""Minimal HTTP serving front end for the label service and the stream hub.

Counterpart of ``honk_tpu.serve.http`` (the reference's root server entry,
``python .`` on port 16888), with the same framing, JSON shapes and
keep-alive behaviour. Endpoints in this port:

    POST /listen   {"wav_data": <base64 PCM16 16 kHz mono>, "method": "all"}
        -> {"contains_command": bool, "label": str, "prob": float}
    GET  /labels   -> {"labels": [...]}
    GET  /         -> the browser demo page (1 s capture and LIVE streaming)
    POST /stream   {"wav_data": <base64 PCM16, any length>} -> {"detections": [...]}
    POST /stream/open  {"chunk_samples"?}        -> {"stream_id", "chunk_samples"}
    POST /stream/push  {"stream_id","wav_data"}  -> {"posterior","label","prob","events"}
    POST /stream/push_many {"chunks": {sid: wav_data}} -> {"results": {sid: ...}}
    POST /stream/push_bin  (binary frame, below) -> {"results": {sid: ...}}
    POST /stream/close {"stream_id"}             -> {"events"}
    POST /train    {"positives": [<base64 PCM16>...], "label": str} -> {"final_loss": float}

``/stream/push_bin`` is the gateway path: the body is
``u32 LE header_len | header JSON | raw PCM16 LE samples``, the header
``{"stream_ids": [...], "posterior": false?}``, the payload
``len(stream_ids) * chunk_samples`` samples in stream_ids order. The
response is push_many's without the per-label posterior unless asked.
``/stream/open`` answers 503 when every slot is taken, the session
endpoints 404 for an unknown session, and all of ``/stream/*`` 503 when
the hub is disabled (``n_stream_slots=0``).

``/train`` fine-tunes the served model on the positives (``TrainingService``,
on its own worker thread, so ``/listen`` and the hub keep answering), then
swaps the new weights into the service and the hub: ``/listen`` and every
open and later stream session use them from their next request. It
answers 400 for missing or malformed positives or label, for no positives
and for a label the model does not have (the JAX server drops the
connection on the last two), 422 when the fine-tune
diverged (a non-finite loss or weight: the JAX server swaps such weights in,
and then answers every request with NaN), and 503 when training is disabled
(``enable_training=False``, the CLI's ``--no-train``).

stdlib http.server only. The server is THREADED (ThreadingHTTPServer, a
thread per connection, with a listen backlog of 128 where socketserver's
is 5) and speaks HTTP/1.1 with keep-alive (every response carries
Content-Length). The handler threads make no device call: the
service's device work, the hub's slab steps included, runs on the
service's one worker thread (``serve/worker.py``), and the hub coalesces
concurrent pushes into slab dispatches on one CUDA stream. Start via
``python -m honk_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import base64
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from .service import LabelService, TrainingService
from .streams import StreamHub


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: a burst of new connections
    # (the hub's clients reconnecting, 8 slots by default) past it waits out
    # a SYN retransmit, a second, before the accept loop sees it.
    request_queue_size = 128


def _decode_pcm16(b64: str) -> np.ndarray:
    raw = base64.b64decode(b64)
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


# Minimal single-file browser demo (equivalent of the reference's web
# demo page): mic -> 1 s capture -> 16 kHz PCM16 -> POST /listen, plus a
# LIVE mode that drives the /stream session API (open -> 200 ms pushes
# -> close) for continuous detection — the capability the reference's
# speech_demo.py provides from a local microphone, served to a browser.
_DEMO_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>honk_tpu demo</title><style>
body{font-family:system-ui,sans-serif;max-width:40rem;margin:3rem auto;padding:0 1rem}
button{font-size:1.2rem;padding:.6rem 1.4rem;cursor:pointer;margin-right:.6rem}
#out{font-size:2rem;margin-top:1rem}
#events{margin-top:1rem;color:#555;font-family:monospace;white-space:pre-line}</style></head><body>
<h1>honk_tpu keyword spotting</h1>
<p>Known labels: <code id="labels"></code></p>
<button id="rec">record 1 s</button>
<button id="live">start live stream</button>
<div id="out"></div>
<div id="events"></div>
<script>
const LABELS = __LABELS__;
document.getElementById('labels').textContent = LABELS.join(', ');
const out = document.getElementById('out');
const eventsDiv = document.getElementById('events');

function pcm16b64(f32) {
  // f32 samples at 16 kHz -> PCM16 -> base64, chunked: spreading 32k
  // args onto the call stack (String.fromCharCode(...bytes)) overflows
  // some engines' argument limits and throws RangeError.
  const pcm = new Int16Array(f32.length);
  for (let i = 0; i < f32.length; i++)
    pcm[i] = Math.max(-32768, Math.min(32767, Math.round((f32[i] || 0) * 32767)));
  const bytes = new Uint8Array(pcm.buffer);
  let bin = '';
  for (let o = 0; o < bytes.length; o += 8192)
    bin += String.fromCharCode.apply(null, bytes.subarray(o, o + 8192));
  return btoa(bin);
}

function resample(samples, fromRate, n) {
  const ratio = fromRate / 16000;
  const f32 = new Float32Array(n);
  for (let i = 0; i < n; i++) f32[i] = samples[Math.floor(i * ratio)] || 0;
  return f32;
}

async function post(path, obj) {
  const resp = await fetch(path, {method: 'POST',
    headers: {'Content-Type': 'application/json'}, body: JSON.stringify(obj)});
  return resp.json();
}

document.getElementById('rec').onclick = async () => {
  out.textContent = 'listening...';
  try {
    const stream = await navigator.mediaDevices.getUserMedia({audio: true});
    const ctx = new AudioContext();
    const src = ctx.createMediaStreamSource(stream);
    const proc = ctx.createScriptProcessor(4096, 1, 1);
    const samples = [];
    proc.onaudioprocess = e => samples.push(...e.inputBuffer.getChannelData(0));
    src.connect(proc); proc.connect(ctx.destination);
    await new Promise(r => setTimeout(r, 1100));
    proc.disconnect(); src.disconnect();
    stream.getTracks().forEach(t => t.stop());
    const j = await post('/listen', {wav_data: pcm16b64(resample(samples, ctx.sampleRate, 16000)), method: 'all'});
    out.textContent = j.contains_command ? `\\u2192 ${j.label} (p=${j.prob.toFixed(2)})`
                                         : `(${j.label}, p=${j.prob.toFixed(2)})`;
  } catch (err) { out.textContent = 'error: ' + err; }
};

let liveStop = null;
let liveSid = null;
document.getElementById('live').onclick = async function () {
  if (liveStop) { liveStop(); return; }
  const btn = this;
  let sid = null, media = null, ctx = null;
  try {
    // Acquire the mic BEFORE opening a server slot: a denied permission
    // must not leak a hub session (slots are finite).
    media = await navigator.mediaDevices.getUserMedia({audio: true});
    const o = await post('/stream/open', {});
    // Surface open failures (e.g. 503 all slots in use): without this the
    // mic pipeline would start with an undefined stream id and never push.
    if (o.error || !o.stream_id) throw new Error(o.error || 'stream open failed');
    sid = o.stream_id; liveSid = sid;
    const chunk_samples = o.chunk_samples;
    ctx = new AudioContext();
    const src = ctx.createMediaStreamSource(media);
    const proc = ctx.createScriptProcessor(4096, 1, 1);
    let buf = [];
    const chunkIn = Math.round(chunk_samples * ctx.sampleRate / 16000);
    let busy = false;
    proc.onaudioprocess = async e => {
      buf.push(...e.inputBuffer.getChannelData(0));
      // Backpressure: if the server falls behind real time, keep only
      // the freshest 3 chunks — bounded memory, bounded latency drift.
      if (buf.length > 3 * chunkIn) buf = buf.slice(buf.length - 3 * chunkIn);
      if (buf.length >= chunkIn && !busy) {
        const take = buf.slice(0, chunkIn); buf = buf.slice(chunkIn);
        busy = true;
        try {
          const j = await post('/stream/push',
            {stream_id: sid, wav_data: pcm16b64(resample(take, ctx.sampleRate, chunk_samples))});
          // Pipelined servers answer the first push (and fetch-degraded
          // ticks) with {pending: true} and no label/prob.
          if (!j.pending) out.textContent = `${j.label} (p=${j.prob.toFixed(2)})`;
          for (const ev of (j.events || []))
            eventsDiv.textContent = `${ev.time_s.toFixed(1)}s  ${ev.label}  p=${ev.prob.toFixed(2)}\\n` + eventsDiv.textContent;
        } finally { busy = false; }
      }
    };
    src.connect(proc); proc.connect(ctx.destination);
    btn.textContent = 'stop live stream';
    liveStop = async () => {
      proc.disconnect(); src.disconnect();
      media.getTracks().forEach(t => t.stop());
      await ctx.close();  // AudioContexts are capped per page
      await post('/stream/close', {stream_id: sid});
      liveSid = null;
      btn.textContent = 'start live stream';
      liveStop = null;
    };
  } catch (err) {
    out.textContent = 'error: ' + err;
    if (media) media.getTracks().forEach(t => t.stop());
    if (ctx) try { await ctx.close(); } catch (_) {}
    if (sid) try { await post('/stream/close', {stream_id: sid}); } catch (_) {}
    liveSid = null; liveStop = null;
  }
};
// Tab close/navigation mid-stream: free the server slot (keepalive lets
// the request outlive the page).
addEventListener('pagehide', () => {
  if (liveSid) fetch('/stream/close', {method: 'POST', keepalive: true,
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({stream_id: liveSid})});
});
</script></body></html>
"""


def make_handler(service: LabelService, trainer: TrainingService | None, hub: StreamHub | None):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1: keep-alive connections (every response sets
        # Content-Length, which 1.1 requires for reuse).
        protocol_version = "HTTP/1.1"

        def _read_body(self) -> bytes | None:
            """Read the request body, or respond + close on bad framing.

            Under HTTP/1.1 keep-alive an unread (or unreadable) body would
            be parsed as the next request line, silently shifting every
            later response on a pipelined connection — so anything not
            framed by a valid Content-Length (e.g. chunked transfer
            encoding) gets an error AND ``close_connection``.
            """
            if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
                self.close_connection = True
                self._send(411, {"error": "Content-Length required (chunked "
                                          "transfer encoding not supported)"})
                return None
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self.close_connection = True
                self._send(400, {"error": "invalid Content-Length"})
                return None
            return self.rfile.read(n)

        def _send(self, code: int, obj: dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/labels":
                self._send(200, {"labels": service.labels})
            elif self.path in ("/", "/index.html"):
                # Browser demo page (reference web-demo parity): records
                # 1 s from the microphone, downsamples to 16 kHz PCM16,
                # POSTs to /listen and shows the label.
                body = _DEMO_HTML.replace("__LABELS__", json.dumps(service.labels)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):
            body = self._read_body()
            if body is None:
                return
            if self.path == "/stream/push_bin":
                self._handle_push_bin(body)
                return
            try:
                payload = json.loads(body or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            if self.path == "/listen":
                try:
                    audio = _decode_pcm16(payload["wav_data"])
                except (KeyError, ValueError) as e:
                    self._send(400, {"error": f"wav_data missing/invalid: {e}"})
                    return
                label, prob = service.evaluate(audio)
                self._send(
                    200,
                    {
                        "contains_command": label not in ("__silence__", "__unknown__"),
                        "label": label,
                        "prob": prob,
                    },
                )
            elif self.path == "/stream":
                # Continuous detection over long audio: overlapping windows +
                # posterior smoothing (stream module), events as JSON.
                try:
                    audio = _decode_pcm16(payload["wav_data"])
                except (KeyError, ValueError) as e:
                    self._send(400, {"error": f"wav_data missing/invalid: {e}"})
                    return
                self._send(200, {"detections": service.evaluate_long(audio)})
            elif self.path.startswith("/stream/"):
                self._handle_stream(payload)
            elif self.path == "/train":
                self._handle_train(payload)
            else:
                self._send(404, {"error": "unknown endpoint"})

        def _handle_train(self, payload: Any) -> None:
            if trainer is None:
                self._send(503, {"error": "training service disabled"})
                return
            try:
                if not isinstance(payload["positives"], list):
                    raise ValueError("positives must be a list of base64 PCM16 strings")
                positives = [_decode_pcm16(p) for p in payload["positives"]]
                target = payload["label"]
            except (KeyError, TypeError, ValueError) as e:
                self._send(400, {"error": f"positives/label missing or invalid: {e}"})
                return
            try:
                result = trainer.fine_tune(positives, target)
            except ValueError as e:  # an unknown label, no positives
                self._send(400, {"error": str(e)})
                return
            if not trainer.finite(result):
                self._send(422, {"error": f"the fine-tune diverged (final loss {result['final_loss']}); "
                                          "the served weights are unchanged"})
                return
            service.set_variables(result["variables"])
            if hub is not None:
                # Open and later stream sessions score with the new weights
                # from their next chunk, as /listen does.
                hub.set_variables(result["variables"])
            self._send(200, {"final_loss": result["final_loss"]})

        def _handle_push_bin(self, body: bytes) -> None:
            """Binary gateway tick: header JSON + raw PCM16, no base64.

            Frame: u32 LE header length | header JSON | PCM16 samples (one
            ``hub.chunk``-sample block per stream id, in header order). The
            body was read by do_POST even on error paths (keep-alive framing).
            """
            if hub is None:
                self._send(503, {"error": "streaming disabled"})
                return
            try:
                hlen = int.from_bytes(body[:4], "little")
                header = json.loads(body[4 : 4 + hlen])
                if not isinstance(header, dict) or not isinstance(header.get("stream_ids"), list):
                    raise ValueError("header must be a JSON object with a stream_ids list")
                sids = header["stream_ids"]
                pcm = np.frombuffer(body[4 + hlen :], dtype="<i2")
                if pcm.size != len(sids) * hub.chunk:
                    raise ValueError(
                        f"payload has {pcm.size} samples, expected {len(sids)} x {hub.chunk}"
                    )
                # Raw int16 to the hub: verbatim to the device with the int16
                # wire (decoded there), converted once with the float wire.
                rows = pcm.reshape(len(sids), hub.chunk)
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad binary frame: {e}"})
                return
            try:
                results = hub.push_rows(sids, rows, want_posterior=bool(header.get("posterior", False)))
            except KeyError as e:
                self._send(404, {"error": f"unknown stream_id: {e}"})
                return
            except (ValueError, RuntimeError) as e:
                self._send(400, {"error": str(e)})
                return
            self._send(200, {"results": results})

        def _handle_stream(self, payload: dict[str, Any]) -> None:
            if hub is None:
                self._send(503, {"error": "streaming disabled"})
                return
            try:
                if self.path == "/stream/open":
                    try:
                        sid = hub.open()
                    except RuntimeError as e:
                        # Capacity, not malformed input: "retry later".
                        self._send(503, {"error": str(e)})
                        return
                    self._send(200, {"stream_id": sid, "chunk_samples": hub.chunk})
                elif self.path == "/stream/push":
                    chunk = _decode_pcm16(payload["wav_data"])
                    self._send(200, hub.push(payload["stream_id"], chunk))
                elif self.path == "/stream/push_many":
                    # {"chunks": {stream_id: <b64 pcm16>}}: one masked slab
                    # dispatch advances every listed session.
                    chunks = {sid: _decode_pcm16(b64) for sid, b64 in payload["chunks"].items()}
                    self._send(200, {"results": hub.push_many(chunks)})
                elif self.path == "/stream/close":
                    self._send(200, hub.close(payload["stream_id"]))
                else:
                    self._send(404, {"error": "unknown stream endpoint"})
            except KeyError as e:
                self._send(404, {"error": f"unknown/missing stream_id: {e}"})
            except (ValueError, RuntimeError) as e:
                self._send(400, {"error": str(e)})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(
    service: LabelService,
    port: int = 16888,
    enable_training: bool = True,
    n_stream_slots: int = 8,
    stream_cfg=None,
    chunk_samples: int = 3200,
    stream_coalesce_ms: float = 2.0,
    stream_pipelined: bool = False,
    stream_wire_dtype: str = "float32",
) -> ThreadingHTTPServer:
    """Start the HTTP front end (returns the server; call serve_forever).

    ``enable_training`` serves ``/train`` (``TrainingService`` with its
    defaults); otherwise it answers 503. The stream hub (``n_stream_slots``
    sessions on one slab, 0 disables) runs on the service's device.
    ``stream_coalesce_ms``: how long a tick leader waits for the remaining
    open sessions to join.
    ``stream_pipelined``: each push returns the session's PREVIOUS chunk's
    result (exact lag-1), hiding the result fetch behind the next tick.
    ``server_close()`` also stops the hub's fetcher threads.
    """
    trainer = TrainingService(service) if enable_training else None
    hub = (
        StreamHub(
            service, n_stream_slots, stream_cfg, chunk_samples,
            coalesce_ms=stream_coalesce_ms, pipelined=stream_pipelined,
            wire_dtype=stream_wire_dtype,
        )
        if n_stream_slots > 0
        else None
    )
    httpd = _Server(("0.0.0.0", port), make_handler(service, trainer, hub))
    httpd.hub = hub
    if hub is not None:
        orig_close = httpd.server_close

        def _close_all():
            try:
                hub.shutdown()
            finally:
                orig_close()

        httpd.server_close = _close_all
    return httpd
