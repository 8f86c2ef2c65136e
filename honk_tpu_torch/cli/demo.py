"""File-streaming detection demo on the card.

Counterpart of ``python -m honk_tpu.cli.demo`` (reference
``utils/speech_demo.py``, adapted to a host with no audio hardware): streams
a long wav file, or a synthesized track with keywords at known positions,
through the streaming detector and prints timestamped detections.

    python -m honk_tpu_torch.cli.demo --checkpoint zoo/res8.pt --model res8 \\
        [--wav long.wav] [--synth-keywords yes no stop] [--hop-ms 200] \\
        [--threshold 0.6] [--online] [--device cuda|cpu]

``--device`` defaults to cuda and fails where no CUDA device is present.
"""

from __future__ import annotations

import argparse

import numpy as np


def synthesize_long_audio(
    keywords, data_dir=None, seconds=10, seed=0, gap_s=1.0, noise_amp=0.02
):
    """Long noise track with synthetic keyword clips at known positions.

    The JAX package's track, draw for draw (``honk_tpu.cli.demo``): each
    keyword occupies 1 s starting at its returned position, and ``gap_s`` of
    noise-only audio follows each clip. ``noise_amp`` sets the noise floor
    (the training augmentation's noise is about 0.01).
    """
    from ..data.synthetic import DEFAULT_WORDS, _word_signal

    rng = np.random.default_rng(seed)
    sr = 16000
    track = noise_amp * rng.standard_normal(seconds * sr).astype(np.float32)
    positions = []
    t = sr
    for word in keywords:
        if t + sr > len(track):
            break
        idx = DEFAULT_WORDS.index(word)
        clip = _word_signal(idx, speaker=0, n=0, sr=sr, rng=rng).astype(np.float32)
        track[t : t + sr] += clip
        positions.append((t / sr, word))
        t += sr + int(gap_s * sr)
    return np.clip(track, -1, 1), positions


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.demo", description=__doc__)
    p.add_argument("--model", default="res8")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--wav", default="", help="long wav file to stream")
    p.add_argument("--synth-keywords", nargs="*", default=["yes", "no", "stop"])
    p.add_argument("--hop-ms", type=int, default=200)
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument(
        "--online", action="store_true",
        help="drive the O(1)-state online Streamer chunk by chunk instead "
        "of the offline batched path (same detection semantics)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..config import StreamConfig
    from ..serve import LabelService

    service = LabelService(args.model, args.checkpoint, device=args.device)
    if args.wav:
        from ..data import read_wav

        audio, _ = read_wav(args.wav)
    else:
        audio, expected = synthesize_long_audio(args.synth_keywords)
        print("synthesized track with keywords at:", expected)

    cfg = StreamConfig(hop_samples=args.hop_ms * 16, detection_threshold=args.threshold)
    if args.online:
        from ..stream import StreamDetector, Streamer

        chunk = args.hop_ms * 16
        s = Streamer(service.model, None, cfg, chunk_samples=chunk)
        state = s.reset()
        det = StreamDetector(cfg, chunk)  # O(1) incremental detection
        events = []
        for c in range(len(audio) // chunk):
            state, post = s.process(state, audio[c * chunk : (c + 1) * chunk])
            e = det.step(post.cpu().numpy())
            if e is not None:
                events.append(
                    {"time_s": e.time_s, "label": service.labels[e.label], "prob": e.score}
                )
    else:
        events = service.evaluate_long(audio, cfg)
    for e in events:
        print(f"  {e['time_s']:6.2f}s  {e['label']:>10}  p={e['prob']:.2f}")
    print(f"{len(events)} detections over {len(audio)/16000:.1f}s audio")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
