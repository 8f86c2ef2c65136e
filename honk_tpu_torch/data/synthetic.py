"""Synthetic miniature Speech Commands fixture (a copy of ``honk_tpu.data.synthetic``).

Tests, ``--synthetic`` training runs and ``chip_smoke.py`` need no copy of
the real dataset: they use a procedurally generated one in the exact honk
directory layout:

    root/<word>/<speaker-hash>_nohash_<n>.wav     (1 s, 16 kHz PCM16)
    root/_background_noise_/*.wav                 (long noise clips)

Each word is a distinct deterministic "vowel chord" (word-specific
formant frequencies with speaker-specific pitch/jitter), so classifiers
can genuinely learn to separate them — good enough for overfit smoke
tests and end-to-end pipeline validation.

The recipe written to ``<root>/CORPUS.json`` names the reference generator
(``honk_tpu.data.synthetic``): the draws are the same, so a corpus is the
same bytes whichever package wrote it (``tests/test_torch_loop.py``).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .wavio import write_wav

DEFAULT_WORDS = ("yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go")
UNKNOWN_WORDS = ("cat", "dog", "tree")


def _write_recipe(root: str, recipe: dict) -> None:
    """Record generator provenance at <root>/CORPUS.json (consumed by
    scripts/make_zoo.py so committed artifacts cite a reproducible recipe
    instead of a volatile corpus path)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "CORPUS.json"), "w") as f:
        json.dump(recipe, f, indent=2)
        f.write("\n")


def _word_signal(word_idx: int, speaker: int, n: int, sr: int, rng: np.random.Generator) -> np.ndarray:
    t = np.arange(sr) / sr
    # Word identity -> a deterministic, well-separated chord of 3 formants:
    # base frequencies spaced ~170 Hz apart so classes are cleanly separable
    # in mel space (the fixture must be learnable for overfit smoke tests).
    f0 = 230.0 + 170.0 * word_idx
    formants = np.array([f0, 2.13 * f0, 3.41 * f0])
    formants = np.minimum(formants, 3900.0)
    pitch = 0.97 + 0.06 * ((speaker % 7) / 7.0)
    sig = np.zeros_like(t)
    for k, f in enumerate(formants):
        sig += (0.5 / (k + 1)) * np.sin(2 * np.pi * f * pitch * t + rng.uniform(0, 2 * np.pi))
    # Amplitude envelope: word "spoken" in the middle ~0.6 s.
    center = 0.5 + 0.05 * rng.standard_normal()
    env = np.exp(-(((t - center) / 0.18) ** 2))
    sig = 0.4 * sig * env + 0.005 * rng.standard_normal(len(t))
    return np.clip(sig, -1.0, 1.0)


def generate_dataset(
    root: str,
    words: tuple[str, ...] = DEFAULT_WORDS,
    unknown_words: tuple[str, ...] = UNKNOWN_WORDS,
    clips_per_word: int = 12,
    n_speakers: int = 6,
    noise_seconds: int = 8,
    sr: int = 16000,
    seed: int = 0,
) -> str:
    """Write the synthetic dataset under `root`; returns `root`.

    NOTE: clip filenames use Python's salted ``hash()`` (kept for
    compatibility with existing fixtures), so exact file names differ
    between processes; use ``generate_hard_dataset`` when byte
    reproducibility matters. The generator recipe is still recorded in
    ``<root>/CORPUS.json`` for artifact provenance (zoo manifests).
    """
    rng = np.random.default_rng(seed)
    _write_recipe(root, {
        "generator": "honk_tpu.data.synthetic.generate_dataset",
        "words": list(words), "unknown_words": list(unknown_words),
        "clips_per_word": clips_per_word, "n_speakers": n_speakers,
        "noise_seconds": noise_seconds, "sr": sr, "seed": seed,
    })
    for w_idx, word in enumerate(tuple(words) + tuple(unknown_words)):
        d = os.path.join(root, word)
        os.makedirs(d, exist_ok=True)
        for i in range(clips_per_word):
            speaker = i % n_speakers
            # Hex speaker id mimics the real corpus's "<hash>_nohash_<n>.wav".
            sid = f"{abs(hash((word, speaker))) % (16**8):08x}"
            path = os.path.join(d, f"{sid}_nohash_{i // n_speakers}.wav")
            write_wav(path, _word_signal(w_idx, speaker, i, sr, rng), sr)
    nd = os.path.join(root, "_background_noise_")
    os.makedirs(nd, exist_ok=True)
    for name, gen in [
        ("white_noise.wav", lambda n: 0.1 * rng.standard_normal(n)),
        ("pink_ish_noise.wav", lambda n: np.cumsum(0.01 * rng.standard_normal(n)) % 0.4 - 0.2),
    ]:
        write_wav(os.path.join(nd, name), gen(noise_seconds * sr), sr)
    return root


# ---------------------------------------------------------------------------
# Hard mode: confusable classes for recipe-dynamics rehearsal.
#
# The easy generator above places word classes ~170 Hz apart — any model
# saturates at accuracy 1.0 within an epoch, which leaves the training
# recipe (lr ladder boundaries, weight decay, BN statistics, capacity
# ordering res8 > res8-narrow) completely unexercised. Hard mode makes the
# class structure genuinely speech-like-difficult:
#
# - Words are FORMANT TRAJECTORIES (F1/F2 start->end glides) drawn from a
#   shared small grid, so many word pairs differ in a single endpoint by
#   ~190-450 Hz — confusable, but learnable from trajectory shape.
# - Speakers have a vocal-tract scale factor alpha (multiplies all
#   formants, +/- speaker_spread) and a fundamental f0 whose amplitude
#   modulation spreads spectral energy — within-class variance comparable
#   to between-class distance, so models must learn speaker-invariant
#   trajectory shape. Speaker identity (not (word, speaker)) keys the
#   filename hash, so the SHA1 split separates SPEAKERS across
#   train/dev/test — generalization, not memorization.
# - A per-clip SNR knob buries the word under white noise at snr_db
#   (uniformly drawn from a range), on top of the train pipeline's own
#   background-noise augmentation.
#
# Default knobs tuned on the real TPU (scripts/hard_probe.py sweeps) so
# the 26-epoch reference recipe on a 10.4k-clip corpus lands res8 around
# ~90% dev accuracy (the 85-95% band) instead of 1.0: the 8% per-clip
# formant jitter creates genuine class overlap (irreducible Bayes error
# that more data cannot wash out — jitter 0.035 saturated at 0.9985 with
# 10.4k clips), and per-clip SNR in [-3, 9] dB keeps the noise floor
# binding. Committed rehearsal: runs/res8_hard_recipe_tpu.jsonl.
# ---------------------------------------------------------------------------

# (F1_start, F1_end, F2_start, F2_end) in Hz. Neighbouring rows share most
# coordinates; the last three are the unknown-word prototypes.
_HARD_PROTOS = np.array(
    [
        (430, 620, 1800, 1350),
        (430, 620, 1800, 1800),  # differs from row 0 only in F2 end
        (430, 810, 1800, 1350),  # differs from row 0 only in F1 end
        (620, 620, 1800, 1350),
        (620, 620, 1350, 1800),
        (620, 430, 1350, 1800),
        (620, 430, 2250, 1800),
        (810, 430, 2250, 1800),
        (810, 620, 2250, 1350),
        (810, 620, 1800, 1350),  # differs from row 3 only in F1 start
        (430, 430, 1350, 2250),
        (620, 810, 2250, 2250),
        (810, 810, 1350, 1350),
    ],
    dtype=np.float64,
)


def _hard_prototypes(n: int, rng: np.random.Generator) -> np.ndarray:
    if n <= len(_HARD_PROTOS):
        return _HARD_PROTOS[:n]
    extra = rng.choice([430.0, 620.0, 810.0], (n - len(_HARD_PROTOS), 2))
    extra2 = rng.choice([1350.0, 1800.0, 2250.0], (n - len(_HARD_PROTOS), 2))
    return np.concatenate([_HARD_PROTOS, np.concatenate([extra, extra2], axis=1)])


# Segment alphabet for multi-segment words (segments_per_word == 2): each
# row is one (F1_start, F1_end, F2_start, F2_end) glide lasting half the
# word. Words are ORDERED segment pairs chosen so almost every word has a
# permutation twin (same segment set, opposite order): any short local
# window shows content identical to the twin's — only temporal ORDER
# separates the classes. This is the capacity/receptive-field probe the
# single-glide corpus cannot provide: models that integrate context
# across the segment boundary (deeper stacks, dilation — res15/res26)
# have an expressible advantage over shallow/narrow ones, mirroring WHY
# dilated deep residual nets win on real speech (Tang & Lin ICASSP'18).
_SEGMENT_ALPHABET = np.array(
    [
        (430, 620, 1800, 1350),
        (620, 810, 1350, 1800),
        (810, 620, 2250, 1800),
        (430, 430, 1350, 2250),
        (620, 430, 1800, 2250),
    ],
    dtype=np.float64,
)

# 13 words: six permutation-twin pairs + one repeated segment.
_SEGMENT_WORDS = [
    (0, 1), (1, 0),
    (0, 2), (2, 0),
    (1, 2), (2, 1),
    (0, 3), (3, 0),
    (1, 3), (3, 1),
    (2, 3), (3, 2),
    (0, 0),
]


def _hard_prototypes_seq(n: int, rng: np.random.Generator) -> np.ndarray:
    """(n, 2, 4) two-segment word prototypes (permutation-twin heavy)."""
    protos = [
        np.stack([_SEGMENT_ALPHABET[a], _SEGMENT_ALPHABET[b]])
        for a, b in _SEGMENT_WORDS
    ]
    while len(protos) < n:  # beyond 13 words: random ordered pairs
        a, b = rng.integers(0, len(_SEGMENT_ALPHABET), 2)
        protos.append(np.stack([_SEGMENT_ALPHABET[a], _SEGMENT_ALPHABET[b]]))
    return np.stack(protos[:n])


# ---------------------------------------------------------------------------
# N-gram mode ("ngram"): the receptive-field / capacity instrument.
#
# Measured fact (the JAX package's zoo probe): two-segment glide words are
# LOCALLY discriminative — every junction between distinct segments is a
# unique spectral event, so even res8-narrow hits 0.998 and the model
# ladder cannot be resolved. To make temporal CONTEXT (not local texture)
# the binding constraint, words here are 5-symbol strings of identical
# out-and-back formant excursions from a shared anchor, and the word list
# is built from PAIRS WITH EQUAL BIGRAM MULTISETS:
#
#     XXYYX vs XYYXX   and   XXYXY vs XYXXY
#
# share unigram AND bigram statistics (e.g. AABBA/ABBAA both contain
# {AA, AB, YY->BB, BA}), so no feature seen through a window spanning
# fewer than THREE symbols — and no global average of such features —
# can separate a twin pair. Three symbols span ~0.6 s: beyond the ~0.54 s
# receptive field of the res8/narrow stack (3x3 convs after 4x3 pooling),
# within the dilated res15 (~1.2 s) and res26 (~1.0 s) fields. This is
# the same mechanism that makes deep dilated residual nets win on real
# speech (Tang & Lin, ICASSP 2018), distilled into a synthetic corpus
# whose Bayes floor stays controlled by the jitter/SNR knobs.
# ---------------------------------------------------------------------------

_NGRAM_ANCHOR = (620.0, 1800.0)  # (F1, F2) shared rest point
_NGRAM_TARGETS = {
    "A": (400.0, 1250.0),
    "B": (850.0, 2350.0),
    "C": (560.0, 2900.0),
}
# Six equal-bigram twin pairs + one easy 13th word.
_NGRAM_WORDS = [
    "AABBA", "ABBAA",
    "AABAB", "ABAAB",
    "BBABA", "BABBA",
    "AACAC", "ACAAC",
    "BBCBC", "BCBBC",
    "CCBCB", "CBCCB",
    "ABCBA",
]


def _ngram_prototypes(n: int, rng: np.random.Generator) -> np.ndarray:
    """(n, 5, 2) excursion-target sequences for the n-gram word set."""
    protos = [
        np.array([_NGRAM_TARGETS[ch] for ch in w], dtype=np.float64)
        for w in _NGRAM_WORDS
    ]
    syms = list(_NGRAM_TARGETS)
    while len(protos) < n:
        w = "".join(syms[i] for i in rng.integers(0, len(syms), 5))
        protos.append(np.array([_NGRAM_TARGETS[ch] for ch in w], dtype=np.float64))
    return np.stack(protos[:n])


def _speaker_params(speaker: int, spread: float, seed: int) -> tuple[float, float]:
    """Deterministic per-speaker (vocal-tract alpha, fundamental f0)."""
    r = np.random.default_rng(seed * 100003 + speaker)
    alpha = 1.0 + r.uniform(-spread, spread)
    f0 = r.uniform(90.0, 240.0)
    return float(alpha), float(f0)


def _hard_word_signal(
    proto: np.ndarray,
    alpha: float,
    f0: float,
    rng: np.random.Generator,
    sr: int,
    jitter_frac: float,
    snr_db: tuple[float, float],
) -> np.ndarray:
    t = np.arange(sr) / sr
    if np.ndim(proto) == 2 and proto.shape[1] == 2:
        # N-gram excursion mode: proto is (n_seg, 2) (F1, F2) targets; every
        # segment is an out-and-back excursion from the shared anchor, so
        # junctions are acoustically identical across words — word identity
        # lives ONLY in the symbol sequence (see _NGRAM_WORDS).
        n_seg = proto.shape[0]
        dur = rng.uniform(0.90, 0.99)  # the word fills the clip: trigram
        center = 0.5                   # context must span ~0.6 s of audio
        tau = np.clip((t - (center - dur / 2)) / dur, 0.0, 1.0)
        seg_idx = np.minimum((tau * n_seg).astype(int), n_seg - 1)
        tau_k = np.clip(tau * n_seg - seg_idx, 0.0, 1.0)
        bump = np.sin(np.pi * tau_k)  # 0 at both segment edges (anchor)
        sig = np.zeros(sr)
        anchors = (_NGRAM_ANCHOR[0], _NGRAM_ANCHOR[1], 2800.0)
        for k in range(3):
            a = anchors[k] * alpha * (1.0 + jitter_frac * rng.standard_normal())
            if k < 2:
                tgt = proto[:, k] * alpha * (1.0 + jitter_frac * rng.standard_normal(n_seg))
                f = a + (tgt[seg_idx] - a) * bump
            else:
                f = np.full(sr, a)  # speaker-only nuisance formant
            f = np.clip(f, 60.0, 3900.0)
            phase = 2 * np.pi * np.cumsum(f) / sr + rng.uniform(0, 2 * np.pi)
            sig += (0.6 / (k + 1)) * np.sin(phase)
        # Flat-top envelope: outer symbols must carry as much evidence as
        # central ones (a Gaussian would fade positions 0 and 4).
        sig *= 1.0 + 0.35 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
        sig *= np.exp(-0.5 * ((t - center) / (0.45 * dur)) ** 6)
        lo, hi = snr_db
        snr = rng.uniform(lo, hi)
        noise_pow = np.mean(sig**2) / (10.0 ** (snr / 10.0))
        sig = sig + np.sqrt(noise_pow) * rng.standard_normal(sr)
        return (0.5 * sig / (np.max(np.abs(sig)) + 1e-9)).astype(np.float64)
    dur = rng.uniform(0.38, 0.72)
    center = 0.5 + 0.06 * rng.standard_normal()
    tau = np.clip((t - (center - dur / 2)) / dur, 0.0, 1.0)
    if np.ndim(proto) == 1:
        # Single-glide word. This branch's rng draw sequence is frozen:
        # committed corpus recipes (hard_v1/hard_v2 CORPUS.json) must
        # regenerate byte-identically.
        f1s, f1e, f2s, f2e = proto
        tracks = ((f1s, f1e), (f2s, f2e), (2800.0, 2800.0))
        sig = np.zeros(sr)
        # Two word-bearing formant glides + one speaker-only nuisance formant.
        for k, (fs, fe) in enumerate(tracks):
            fs = fs * alpha * (1.0 + jitter_frac * rng.standard_normal())
            fe = fe * alpha * (1.0 + jitter_frac * rng.standard_normal())
            f = np.clip(fs + (fe - fs) * tau, 60.0, 3900.0)
            phase = 2 * np.pi * np.cumsum(f) / sr + rng.uniform(0, 2 * np.pi)
            sig += (0.6 / (k + 1)) * np.sin(phase)
    else:
        # Multi-segment word: piecewise formant glides. Segment k owns tau
        # in [k/n_seg, (k+1)/n_seg); the local 0..1 coordinate drives that
        # segment's glide, with independent endpoint jitter per segment.
        n_seg = proto.shape[0]
        seg_idx = np.minimum((tau * n_seg).astype(int), n_seg - 1)
        tau_k = np.clip(tau * n_seg - seg_idx, 0.0, 1.0)
        sig = np.zeros(sr)
        nuisance = np.full((n_seg, 2), 2800.0)
        for k, ends in enumerate((proto[:, 0:2], proto[:, 2:4], nuisance)):
            fs = ends[:, 0] * alpha * (1.0 + jitter_frac * rng.standard_normal(n_seg))
            fe = ends[:, 1] * alpha * (1.0 + jitter_frac * rng.standard_normal(n_seg))
            f = np.clip(fs[seg_idx] + (fe[seg_idx] - fs[seg_idx]) * tau_k, 60.0, 3900.0)
            phase = 2 * np.pi * np.cumsum(f) / sr + rng.uniform(0, 2 * np.pi)
            sig += (0.6 / (k + 1)) * np.sin(phase)
    # Voicing: amplitude modulation at f0 puts speaker-dependent sidebands
    # around every formant (spectral nuisance the classifier must ignore).
    sig *= 1.0 + 0.35 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
    sig *= np.exp(-0.5 * ((t - center) / (0.30 * dur)) ** 2)
    lo, hi = snr_db
    snr = rng.uniform(lo, hi)
    noise_pow = np.mean(sig**2) / (10.0 ** (snr / 10.0))
    sig = sig + np.sqrt(noise_pow) * rng.standard_normal(sr)
    return (0.5 * sig / (np.max(np.abs(sig)) + 1e-9)).astype(np.float64)


def generate_hard_dataset(
    root: str,
    words: tuple[str, ...] = DEFAULT_WORDS,
    unknown_words: tuple[str, ...] = UNKNOWN_WORDS,
    clips_per_word: int = 800,
    n_speakers: int = 60,
    noise_seconds: int = 30,
    sr: int = 16000,
    seed: int = 0,
    snr_db: tuple[float, float] = (-3.0, 9.0),
    speaker_spread: float = 0.15,
    formant_jitter: float = 0.08,
    segments_per_word: int = 1,
    word_mode: str = "glide",
) -> str:
    """Write the hard-mode corpus under `root`; returns `root`.

    Filenames hash the SPEAKER id only (md5, not Python's salted hash), so
    (a) regeneration with the same args is byte-reproducible and (b) the
    SHA1 split buckets whole speakers, like the real corpus convention.
    The full generator recipe is recorded in `<root>/CORPUS.json`.

    ``segments_per_word=2`` switches to the permutation-twin word set
    (see ``_SEGMENT_WORDS``): words share segment CONTENT and differ in
    segment ORDER. Measured caveat: distinct-glide junctions are locally
    discriminative, so this mode does NOT bind capacity (all models hit
    ~0.998 in the JAX package's probe). ``word_mode="ngram"`` is the instrument
    that does: equal-bigram 5-symbol excursion words where only features
    spanning >= 3 symbols (~0.6 s) separate the twin pairs — see the
    _NGRAM_WORDS block comment.
    """
    rng = np.random.default_rng(seed)
    all_words = tuple(words) + tuple(unknown_words)
    if word_mode == "ngram":
        protos = _ngram_prototypes(len(all_words), rng)
    elif segments_per_word == 1:
        protos = _hard_prototypes(len(all_words), rng)
    else:
        assert segments_per_word == 2, "only 1- and 2-segment words defined"
        protos = _hard_prototypes_seq(len(all_words), rng)
    for w_idx, word in enumerate(all_words):
        d = os.path.join(root, word)
        os.makedirs(d, exist_ok=True)
        for i in range(clips_per_word):
            speaker = i % n_speakers
            alpha, f0 = _speaker_params(speaker, speaker_spread, seed)
            sid = hashlib.md5(f"spk{seed}:{speaker}".encode()).hexdigest()[:8]
            path = os.path.join(d, f"{sid}_nohash_{i // n_speakers}.wav")
            clip = _hard_word_signal(
                protos[w_idx], alpha, f0, rng, sr, formant_jitter, snr_db
            )
            write_wav(path, clip, sr)
    nd = os.path.join(root, "_background_noise_")
    os.makedirs(nd, exist_ok=True)
    for name, gen in [
        ("white_noise.wav", lambda n: 0.1 * rng.standard_normal(n)),
        ("pink_ish_noise.wav", lambda n: np.cumsum(0.01 * rng.standard_normal(n)) % 0.4 - 0.2),
    ]:
        write_wav(os.path.join(nd, name), gen(noise_seconds * sr), sr)
    _write_recipe(root, {
        "generator": "honk_tpu.data.synthetic.generate_hard_dataset",
        "words": list(words),
        "unknown_words": list(unknown_words),
        "clips_per_word": clips_per_word,
        "n_speakers": n_speakers,
        "noise_seconds": noise_seconds,
        "sr": sr,
        "seed": seed,
        "snr_db": list(snr_db),
        "speaker_spread": speaker_spread,
        "formant_jitter": formant_jitter,
        "segments_per_word": segments_per_word,
        "word_mode": word_mode,
    })
    return root
