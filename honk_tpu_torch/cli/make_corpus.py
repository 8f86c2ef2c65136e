"""Generate a synthetic Speech Commands corpus, easy or hard (counterpart of ``scripts/make_corpus.py``).

    python -m honk_tpu_torch.cli.make_corpus data/hard_v1 --hard --clips_per_word 800
    python -m honk_tpu_torch.cli.make_corpus <dir> --hard --clips_per_word 2 --n_speakers 2 --device cpu

Easy mode (``data.generate_dataset``): well-separated word classes for
overfit smoke tests. Hard mode (``data.generate_hard_dataset``):
confusable formant-trajectory classes, speaker variation and noise at an
SNR, tuned so the reference's 26-epoch recipe lands res8 at 85-95%. The
reference's arguments and defaults; the files are the reference's byte for
byte (easy mode names clips with Python's salted ``hash()``, so its names
match within one process). Prints the hard corpus's ``CORPUS.json``, or
the easy generator's arguments, as one JSON line.

The corpus is written on the host; like every entry point of the port,
the tool runs where a card is (``--device``, default ``cuda``) and raises
without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HARD_ONLY = ("snr_db", "speaker_spread", "formant_jitter", "segments_per_word", "word_mode")


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device
    from ..data import generate_dataset, generate_hard_dataset

    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.make_corpus", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root")
    p.add_argument("--hard", action="store_true")
    p.add_argument("--clips_per_word", type=int, default=None)
    p.add_argument("--n_speakers", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snr_db", type=float, nargs=2, default=None)
    p.add_argument("--speaker_spread", type=float, default=None)
    p.add_argument("--formant_jitter", type=float, default=None)
    p.add_argument("--segments_per_word", type=int, default=None,
                   help="2 = permutation-twin two-segment words (temporal-order task)")
    p.add_argument("--word_mode", default=None, choices=["glide", "ngram"],
                   help="ngram = equal-bigram 5-symbol words (receptive-field instrument)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    resolve_device(args.device)

    kw = {"seed": args.seed}
    for k in ("clips_per_word", "n_speakers", "speaker_spread", "formant_jitter", "segments_per_word", "word_mode"):
        if getattr(args, k) is not None:
            kw[k] = getattr(args, k)
    if args.snr_db is not None:
        kw["snr_db"] = tuple(args.snr_db)
    if args.hard:
        root = generate_hard_dataset(args.root, **kw)
        with open(os.path.join(root, "CORPUS.json")) as f:
            print(json.dumps(json.load(f)))
    else:
        kw = {k: v for k, v in kw.items() if k not in HARD_ONLY}
        root = generate_dataset(args.root, **kw)
        print(json.dumps({"generator": "generate_dataset", "root": root, **kw}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
