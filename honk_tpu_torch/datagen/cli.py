"""Dataset-generator CLI (counterpart of ``python -m honk_tpu.datagen``).

    python -m honk_tpu_torch.datagen --keywords yes no --source local \\
        --input_dir corpus/ --out_dir data/generated

    # quality evaluation of generated clips with a trained checkpoint, on the card:
    python -m honk_tpu_torch.datagen --keywords yes no --source local \\
        --input_dir corpus/ --out_dir data/generated \\
        --eval_checkpoint zoo/res8.pt --eval_model res8 [--device cuda|cpu]

The JAX CLI's flags, plus ``--device`` (default cuda; with
``--eval_checkpoint`` it fails where no CUDA device is present, before any
clip is written). ``--eval_checkpoint`` takes a honk ``.pt`` or, as the
JAX CLI's, an Orbax checkpoint directory (it needs ``tensorstore``: where
that is missing, it is refused before any clip is written).
"""

from __future__ import annotations

import argparse
import json
import sys

from .align import find_keyword_occurrences
from .extract import extract_clips, write_clips
from .fetch import LocalFileSource, YouTubeSource


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.datagen", description=__doc__)
    p.add_argument("--keywords", nargs="+", required=True)
    p.add_argument("--source", choices=["local", "youtube"], default="local")
    p.add_argument("--input_dir", help="LocalFileSource root of (wav, srt/vtt) pairs")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_videos", type=int, default=50)
    p.add_argument("--no_recenter", action="store_true", help="disable RMS recentering")
    p.add_argument("--eval_checkpoint", default="", help="honk .pt or Orbax dir for quality eval")
    p.add_argument("--eval_model", default="res8")
    p.add_argument("--report_json", default="", help="write the quality report here")
    p.add_argument("--device", default="cuda", help="quality eval device: cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.eval_checkpoint:
        from .. import resolve_device
        from ..ckpt import is_orbax_path
        from ..ckpt.orbax import check

        if is_orbax_path(args.eval_checkpoint):
            try:
                check(args.eval_checkpoint)
            except (FileNotFoundError, RuntimeError) as e:
                p.error(f"--eval_checkpoint: {e}")
        resolve_device(args.device)
    if args.source == "local":
        if not args.input_dir:
            print("--input_dir is required with --source local", file=sys.stderr)
            return 2
        source = LocalFileSource(args.input_dir)
    else:
        source = YouTubeSource(args.keywords, max_videos=args.max_videos)

    all_clips = []
    n_videos = 0
    for item in source:
        n_videos += 1
        occs = find_keyword_occurrences(item.captions, args.keywords)
        clips = extract_clips(item.audio, occs, recenter=not args.no_recenter)
        write_clips(clips, args.out_dir, item.source_id)
        all_clips.extend(clips)
        print(f"{item.source_id}: {len(occs)} occurrences -> {len(clips)} clips")
    print(f"total: {n_videos} sources, {len(all_clips)} clips -> {args.out_dir}")

    if args.eval_checkpoint:
        from ..serve.service import LabelService
        from .quality import evaluate_clips

        svc = LabelService(args.eval_model, args.eval_checkpoint, device=args.device)
        report = evaluate_clips(svc.model, None, svc.labels, all_clips)
        if args.report_json:
            with open(args.report_json, "w") as f:
                json.dump(report, f, indent=2)
        del report["verdicts"]  # keep stdout compact; full detail via --report_json
        print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
