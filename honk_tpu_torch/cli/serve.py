"""Serving CLI: start the keyword-spotting HTTP service on the card.

Counterpart of ``python -m honk_tpu.cli.serve``:

    python -m honk_tpu_torch.cli.serve --model res8 --checkpoint zoo/res8.pt \\
        [--port 16888] [--config config.json] [--device cuda|cpu]
    python -m honk_tpu_torch.cli.serve --model res15 --checkpoint zoo_hard_v2/res15.pt
    python -m honk_tpu_torch.cli.serve --model cnn-trad-pool2 --checkpoint zoo/cnn-trad-pool2.pt

``--model`` is any of the 16 configs (res*, cnn-*).

--config accepts a reference-style config.json with keys
{"model_path": ..., "commands": "cmd1,cmd2,..."}. The checkpoint is a honk
``.pt`` file. ``--device`` defaults to cuda and fails where no CUDA device
is present. /train answers 501 in this port, so ``--no-train`` changes
nothing; the streaming flags of the JAX CLI are refused until streaming
is ported.
"""

from __future__ import annotations

import argparse
import json

# Flags of honk_tpu.cli.serve that belong to the stream hub.
_STREAM_FLAGS = ("--stream-slots", "--chunk-samples", "--coalesce-ms", "--wire-dtype", "--pipelined")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.serve", description=__doc__)
    p.add_argument("--model", default="res8")
    p.add_argument("--checkpoint", required=False, default="")
    p.add_argument("--port", type=int, default=16888)
    p.add_argument("--no-train", action="store_true",
                   help="accepted for compatibility: /train is not in this port yet (501)")
    p.add_argument("--config", default="", help="reference-style config.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = p.parse_known_args(argv)
    stream = [a for a in rest if a.split("=", 1)[0] in _STREAM_FLAGS]
    if stream:
        p.error(f"{stream[0].split('=', 1)[0]}: streaming is not in this port yet")
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")

    labels = None
    checkpoint = args.checkpoint
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
        checkpoint = cfg.get("model_path", checkpoint)
        if "commands" in cfg:
            labels = ["__silence__", "__unknown__", *cfg["commands"].split(",")]

    from ..serve import LabelService, serve

    service = LabelService(args.model, checkpoint, labels=labels, device=args.device)
    httpd = serve(service, port=args.port)
    print(f"listening on :{args.port} model={args.model} device={service.device} labels={service.labels}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
