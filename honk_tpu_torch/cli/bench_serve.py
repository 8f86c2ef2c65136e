"""End-to-end HTTP serving capacity (counterpart of ``scripts/bench_http_serve.py``).

    python -m honk_tpu_torch.cli.bench_serve --slots 64 --gateways 4 --seconds 60 \\
        --checkpoint zoo_hard_v2/res8.pt [--json] [--pipelined] [--out <file>]
    python -m honk_tpu_torch.cli.bench_serve --slots 2 --gateways 1 --seconds 1 --device cpu

What the real serving path sustains: ``--gateways`` threads, each holding
a block of ``--slots / --gateways`` sessions on the port's ``serve()``
(one ``ThreadingHTTPServer`` and its ``StreamHub``, a float32
``LabelService`` of ``--checkpoint``), push one chunk per session per tick
for ``--seconds`` over one persistent HTTP/1.1 connection each: binary
PCM16 frames on ``/stream/push_bin``, or JSON + base64 on
``/stream/push_many`` with ``--json``. Every push must be answered with a
result for each of the gateway's sessions; a failed or short answer ends
the run with exit code 1.

Reports sustained real-time streams (audio-seconds pushed per second), the
hub's slab dispatches (``StreamHub.dispatches``) and chunks per dispatch,
and the device-only capacity of the same slab: the service's
``BatchStreamer`` stepped 50 times on its worker with every slot masked in,
no HTTP. Prints one JSON line with the reference's keys; ``note`` names
this host's cores, which the server's threads and the gateways share.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import socket
import sys
import threading
import time

import numpy as np
import torch

DEVICE_ITERS = 50


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.bench_serve", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="res8")
    p.add_argument("--checkpoint", default="zoo_hard_v2/res8.pt")
    p.add_argument("--slots", type=int, default=64)
    p.add_argument("--gateways", type=int, default=4)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--chunk", type=int, default=3200)
    p.add_argument("--coalesce-ms", type=float, default=4.0)
    p.add_argument("--pipelined", action="store_true",
                   help="double-buffered hub: responses lag one chunk, the result fetch overlaps the next "
                        "tick's device step")
    p.add_argument("--inflight", type=int, default=0,
                   help="HTTP requests each gateway keeps in flight (needs --pipelined for >1; 0 = auto: "
                        "2 pipelined, 1 sync)")
    p.add_argument("--json", action="store_true",
                   help="use the JSON+base64 push_many path instead of binary /stream/push_bin")
    p.add_argument("--wire-dtype", choices=["float32", "int16"], default="float32",
                   help="int16: raw PCM16 goes to the device verbatim and decodes there")
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p


def device_only_streams(svc, slots: int, chunk: int, chunks: np.ndarray) -> float:
    """Streams the service's slab sustains stepped back to back on its worker, without HTTP."""
    bs = svc.make_batch_streamer(slots, chunk_samples=chunk)
    mask = np.ones((slots,), bool)

    def loop(iters: int) -> float:
        state = bs.reset()
        with torch.no_grad():
            for _ in range(3):  # warm (the masked step is the serving path's)
                state, post = bs.process(state, chunks, mask)
            post.cpu()
            t0 = time.perf_counter()
            for _ in range(iters):
                state, post = bs.process(state, chunks, mask)
            post.cpu()
        return time.perf_counter() - t0

    dt = svc.worker.run(loop, DEVICE_ITERS)
    return slots * DEVICE_ITERS * (chunk / 16000.0) / dt


class Gateway:
    """One persistent HTTP/1.1 connection to the server: raw requests, replies read in order."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.rfile = self.sock.makefile("rb")

    def send(self, path: str, body: bytes, ctype: str) -> None:
        head = (f"POST {path} HTTP/1.1\r\nHost: bench\r\n"
                f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n\r\n").encode()
        self.sock.sendall(head + body)

    def reply(self) -> dict:
        status = self.rfile.readline()
        if not status:
            raise RuntimeError("the server closed the connection")
        code = int(status.split()[1])
        clen = 0
        while True:
            line = self.rfile.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.partition(b":")
            if k.strip().lower() == b"content-length":
                clen = int(v)
        data = self.rfile.read(clen)
        if code != 200:
            raise RuntimeError(f"-> {code}: {data[:200]!r}")
        return json.loads(data)

    def rpc(self, path: str, obj) -> dict:
        self.send(path, json.dumps(obj).encode(), "application/json")
        return self.reply()

    def close(self) -> None:
        self.rfile.close()
        self.sock.close()


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device
    from ..serve import LabelService, serve
    from .bench import device_name

    p = build_parser()
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.slots % args.gateways != 0:
        p.error(f"--slots ({args.slots}) must be divisible by --gateways ({args.gateways}) "
                "so every slot is driven (otherwise host_share is skewed)")
    inflight = args.inflight or (2 if args.pipelined else 1)
    if inflight > 1 and not args.pipelined:
        p.error("--inflight > 1 requires --pipelined (sync responses wait for their own tick, so pipelined "
                "requests would deadlock the connection)")
    device = resolve_device(args.device)
    svc = LabelService(args.model, args.checkpoint, device=device)

    # ---- device-only capacity of the same slab (reference point) ----
    rng = np.random.default_rng(0)
    chunks = (rng.standard_normal((args.slots, args.chunk)) * 0.1).astype(np.float32)
    device_streams = device_only_streams(svc, args.slots, args.chunk, chunks)
    chunk_s = args.chunk / 16000.0

    # ---- the real path: ThreadingHTTPServer + StreamHub over a socket ----
    httpd = serve(svc, port=0, enable_training=False, n_stream_slots=args.slots, chunk_samples=args.chunk,
                  stream_coalesce_ms=args.coalesce_ms, stream_pipelined=args.pipelined,
                  stream_wire_dtype=args.wire_dtype)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    hub = httpd.hub

    per_gateway = args.slots // args.gateways
    pcm = (chunks[0] * 32767).astype("<i2").tobytes()
    b64 = base64.b64encode(pcm).decode()
    counts = [0] * args.gateways
    stop = threading.Event()
    errors: list[str] = []

    def answered(out: dict, g: int) -> None:
        if len(out.get("results", ())) != per_gateway:
            raise RuntimeError(f"gateway {g}: a push answered {len(out.get('results', ()))} of "
                               f"{per_gateway} sessions")
        counts[g] += per_gateway

    def gateway(g: int) -> None:
        # One persistent connection; with --inflight > 1 the next tick's
        # request goes onto the socket before the previous response is read
        # (the server handles a connection's requests in order).
        conn = None
        try:
            conn = Gateway(port)
            sids = [conn.rpc("/stream/open", {})["stream_id"] for _ in range(per_gateway)]
            if args.json:
                path, ctype = "/stream/push_many", "application/json"
                frame = json.dumps({"chunks": {sid: b64 for sid in sids}}).encode()
            else:
                header = json.dumps({"stream_ids": sids}).encode()
                frame = len(header).to_bytes(4, "little") + header + pcm * per_gateway
                path, ctype = "/stream/push_bin", "application/octet-stream"
            outstanding = 0
            while not stop.is_set():
                if outstanding >= inflight:
                    answered(conn.reply(), g)
                    outstanding -= 1
                conn.send(path, frame, ctype)
                outstanding += 1
            while outstanding:  # drain: every push is answered
                answered(conn.reply(), g)
                outstanding -= 1
            for sid in sids:
                conn.rpc("/stream/close", {"stream_id": sid})
        except Exception as e:  # noqa: BLE001 - recorded, and the run fails
            errors.append(repr(e))
            stop.set()
        finally:
            if conn is not None:
                conn.close()

    threads = [threading.Thread(target=gateway, args=(g,)) for g in range(args.gateways)]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        stop.wait(args.seconds)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        dt = time.perf_counter() - t0
        dispatches = hub.dispatches
    finally:
        httpd.shutdown()
        httpd.server_close()
    if errors or any(th.is_alive() for th in threads):
        print(json.dumps({"error": errors[:3] or ["a gateway did not finish within 60 s"]}), flush=True)
        return 1

    total_chunks = sum(counts)
    http_streams = total_chunks * chunk_s / dt
    result = {
        "metric": "sustained_realtime_streams_per_chip_http",
        "value": round(http_streams, 1),
        "unit": "streams (1s audio/s each)",
        "device_only_streams": round(device_streams, 1),
        "host_share": round(1.0 - http_streams / device_streams, 4),
        "payload": "json+base64" if args.json else "binary pcm16",
        "pipelined": args.pipelined,
        "inflight": inflight,
        "wire_dtype": args.wire_dtype,
        "coalesce_ms": args.coalesce_ms,
        "dispatches": dispatches,
        "chunks_per_dispatch": round(total_chunks / max(1, dispatches), 1),
        "slots": args.slots,
        "gateways": args.gateways,
        "chunk_samples": args.chunk,
        "seconds": round(dt, 1),
        "total_chunks": total_chunks,
        "model": args.model,
        "checkpoint": args.checkpoint,
        "device": device_name(device),
        "note": (
            f"server+gateways share one {os.cpu_count()}-core host process; device_only_streams "
            "is the same slab stepped without HTTP. Gateways reuse one HTTP/1.1 "
            "connection each; the hub coalesces concurrent gateway ticks into "
            "full-slab dispatches and detects events in one vectorized pass."
        ),
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
