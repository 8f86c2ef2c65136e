"""Serving CLI: start the keyword-spotting HTTP service on the card.

Counterpart of ``python -m honk_tpu.cli.serve``:

    python -m honk_tpu_torch.cli.serve --model res8 --checkpoint zoo/res8.pt \\
        [--port 16888] [--no-train] [--config config.json] [--device cuda|cpu] \\
        [--stream-slots 8] [--chunk-samples 3200] [--coalesce-ms 2] \\
        [--wire-dtype float32|int16] [--pipelined]
    python -m honk_tpu_torch.cli.serve --model res15 --checkpoint zoo_hard_v2/res15.pt
    python -m honk_tpu_torch.cli.serve --model cnn-trad-pool2 --checkpoint zoo/cnn-trad-pool2.pt

``--model`` is any of the 16 configs (res*, cnn-*).

--config accepts a reference-style config.json with keys
{"model_path": ..., "commands": "cmd1,cmd2,..."}. The checkpoint is a honk
``.pt`` file or, as for the JAX server, an Orbax checkpoint directory
(``zoo/res8/best`` or ``zoo/res8``, read by the port itself; a path that
is neither is refused before the server starts). ``--device`` defaults to
cuda and fails where no CUDA device
is present; the stream hub (``/stream/*``) and ``/train`` run on the same
device. ``--no-train`` turns personalization off: ``/train`` answers 503.
"""

from __future__ import annotations

import argparse
import json


def make_server(argv: list[str] | None = None):
    """Parse the CLI flags and build the service and its HTTP server (not started)."""
    p = argparse.ArgumentParser(prog="honk_tpu_torch.serve", description=__doc__)
    p.add_argument("--model", default="res8")
    p.add_argument("--checkpoint", required=False, default="")
    p.add_argument("--port", type=int, default=16888)
    p.add_argument("--no-train", action="store_true", help="disable POST /train (it answers 503)")
    p.add_argument("--config", default="", help="reference-style config.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument(
        "--stream-slots", type=int, default=8,
        help="concurrent /stream sessions sharing one batched slab (0 disables)",
    )
    p.add_argument("--chunk-samples", type=int, default=3200)
    p.add_argument(
        "--coalesce-ms", type=float, default=2.0,
        help="tick leader waits this long for other open sessions to join "
             "before dispatching the slab (0 disables; no wait when every "
             "open session already joined)",
    )
    p.add_argument(
        "--wire-dtype", choices=["float32", "int16"], default="float32",
        help="int16 ships raw PCM16 chunks to the device and decodes them "
             "there: half the host->device bytes (PCM16-derived audio "
             "round-trips exactly)",
    )
    p.add_argument(
        "--pipelined", action="store_true",
        help="each push returns the session's PREVIOUS chunk's result "
             "(exact lag-1), hiding the result fetch behind the next tick",
    )
    args = p.parse_args(argv)

    labels = None
    checkpoint = args.checkpoint
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
        checkpoint = cfg.get("model_path", checkpoint)
        if "commands" in cfg:
            labels = ["__silence__", "__unknown__", *cfg["commands"].split(",")]

    from ..ckpt import is_orbax_path
    from ..ckpt.orbax import check
    from ..serve import LabelService, serve

    if checkpoint and is_orbax_path(checkpoint):
        try:
            check(checkpoint)
        except FileNotFoundError as e:
            p.error(f"checkpoint: {e}")
    service = LabelService(args.model, checkpoint, labels=labels, device=args.device)
    httpd = serve(
        service,
        port=args.port,
        enable_training=not args.no_train,
        n_stream_slots=args.stream_slots,
        chunk_samples=args.chunk_samples,
        stream_coalesce_ms=args.coalesce_ms,
        stream_pipelined=args.pipelined,
        stream_wire_dtype=args.wire_dtype,
    )
    print(f"listening on :{args.port} model={args.model} device={service.device} labels={service.labels} "
          f"stream_slots={args.stream_slots}")
    return httpd


def main(argv: list[str] | None = None) -> int:
    httpd = make_server(argv)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
