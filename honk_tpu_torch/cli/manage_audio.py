"""Audio management CLI: trim, window-trim, synthesize, inspect.

Counterpart of ``python -m honk_tpu.cli.manage_audio`` (reference
``python -m utils.manage_audio {record,trim} ...``), over the port's
``AudioSnippet``, WAV reader and writer and synthetic corpus, so every file
it writes is the same bytes as the JAX CLI's. Host only: no device. With no
microphone, ``record`` is replaced by ``synth``; ``trim`` is the reference's
in-place dataset trimming.

    python -m honk_tpu_torch.cli.manage_audio trim <dir> [--threshold 0.01]
    python -m honk_tpu_torch.cli.manage_audio window <dir> [--size 16000]
    python -m honk_tpu_torch.cli.manage_audio synth <dir> [--clips 12]
    python -m honk_tpu_torch.cli.manage_audio info <wav...>
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..audio import AudioSnippet
from ..data import generate_dataset, read_wav, write_wav


def _iter_wavs(root: str):
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".wav"):
                yield os.path.join(dirpath, f)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.manage_audio", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trim", help="amplitude-trim all wavs in a directory, in place")
    t.add_argument("dir")
    t.add_argument("--threshold", type=float, default=0.01)

    w = sub.add_parser("window", help="keep the max-energy window of each wav, in place")
    w.add_argument("dir")
    w.add_argument("--size", type=int, default=16000)

    s = sub.add_parser("synth", help="generate the synthetic dev corpus")
    s.add_argument("dir")
    s.add_argument("--clips", type=int, default=12)

    i = sub.add_parser("info", help="print duration/rms of wav files")
    i.add_argument("files", nargs="+")

    args = p.parse_args(argv)

    if args.cmd == "trim":
        n = 0
        for path in _iter_wavs(args.dir):
            data, sr = read_wav(path)
            snip = AudioSnippet(data).trim(args.threshold)
            write_wav(path, snip.data, sr)
            n += 1
        print(f"trimmed {n} files")
    elif args.cmd == "window":
        n = 0
        for path in _iter_wavs(args.dir):
            data, sr = read_wav(path)
            snip = AudioSnippet(data).trim_window(args.size).pad_to(args.size)
            write_wav(path, snip.data, sr)
            n += 1
        print(f"windowed {n} files")
    elif args.cmd == "synth":
        generate_dataset(args.dir, clips_per_word=args.clips)
        print(f"synthetic dataset written to {args.dir}")
    elif args.cmd == "info":
        for path in args.files:
            data, sr = read_wav(path)
            rms = float(np.sqrt((data**2).mean())) if len(data) else 0.0
            print(f"{path}: {len(data)/sr:.2f}s sr={sr} rms={rms:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
