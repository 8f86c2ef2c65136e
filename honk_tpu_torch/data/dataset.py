"""Speech Commands loader -> packed int16 arrays (counterpart of ``honk_tpu.data.dataset``).

The corpus is decoded once on the host into packed int16 arrays; the
training loop moves the train split to the device once, and the batch
assembly (``data/augment.py``) runs there on every step.

Label convention (reference parity): 0 = __silence__, 1 = __unknown__,
2.. = wanted words in order. Unknown-word files are shuffled and a
fraction ``unknown_prob * n_known`` is appended to each split with label
1 — exactly the reference's allocation. Silence is "virtual": the train
sampler draws it with probability n_silence / (n + n_silence); the eval
sets materialize ``int(silence_prob * n)`` deterministic noise-scaled
silence clips so accuracy is reproducible.

Clips are decoded by the native batched reader (``native/wavpack.py``)
where it builds, file by file with the pure-Python reader (``wavio``)
where it does not or a file fails to decode, as the JAX package does; the
two give the same arrays (``tests/test_torch_native.py``). Background noise
is read with ``wavio``, as there.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Sequence

import numpy as np

from ..native import wavpack
from . import splits as S
from .wavio import read_wav, read_wav_int16

LABEL_SILENCE = "__silence__"
LABEL_UNKNOWN = "__unknown__"
BACKGROUND_NOISE_DIR = "_background_noise_"
DEFAULT_WANTED_WORDS = ("yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go")

AUDIO_SAMPLES = 16000


@dataclasses.dataclass
class PackedSplit:
    """One split's utterances, fixed-length int16."""

    audio: np.ndarray  # (N, 16000) int16
    labels: np.ndarray  # (N,) int32
    n_silence: int  # virtual silence slots (train) or materialized count (eval)

    def __len__(self) -> int:
        return len(self.labels)


@dataclasses.dataclass
class PackedDataset:
    train: PackedSplit
    dev: PackedSplit
    test: PackedSplit
    noise: np.ndarray  # (M,) float32 concatenated background noise
    label_names: tuple[str, ...]

    @property
    def n_labels(self) -> int:
        return len(self.label_names)


def _load_clip(path: str) -> np.ndarray:
    data = read_wav_int16(path)
    if len(data) >= AUDIO_SAMPLES:
        return data[:AUDIO_SAMPLES]
    return np.pad(data, (0, AUDIO_SAMPLES - len(data)))


def load_speech_commands(
    root: str,
    wanted_words: Sequence[str] = DEFAULT_WANTED_WORDS,
    unknown_prob: float = 0.1,
    silence_prob: float = 0.1,
    dev_pct: float = 10.0,
    test_pct: float = 10.0,
    seed: int = 0,
) -> PackedDataset:
    """Walk a Speech Commands directory tree into a PackedDataset."""
    words = {w: i + 2 for i, w in enumerate(wanted_words)}
    label_names = (LABEL_SILENCE, LABEL_UNKNOWN) + tuple(wanted_words)

    known: list[list[tuple[str, int]]] = [[], [], []]
    unknown: list[list[str]] = [[], [], []]
    noise_files: list[str] = []

    for folder in sorted(os.listdir(root)):
        path = os.path.join(root, folder)
        if not os.path.isdir(path):
            continue
        if folder == BACKGROUND_NOISE_DIR:
            noise_files = [
                os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith(".wav")
            ]
            continue
        label = words.get(folder)
        for f in sorted(os.listdir(path)):
            if not f.endswith(".wav"):
                continue
            fp = os.path.join(path, f)
            bucket = S.which_set(fp, dev_pct, test_pct)
            if label is None:
                unknown[bucket].append(fp)
            else:
                known[bucket].append((fp, label))

    # Reference allocation: shuffle unknowns, append unknown_prob*n per split.
    rng = random.Random(seed)
    all_unknown = unknown[S.TRAIN] + unknown[S.DEV] + unknown[S.TEST]
    rng.shuffle(all_unknown)
    counts = [int(unknown_prob * len(known[i])) for i in range(3)]
    a = 0
    chosen_unknown: list[list[str]] = []
    for c in counts:
        chosen_unknown.append(all_unknown[a : a + c])
        a += c

    # Background noise -> one concatenated float32 buffer.
    if noise_files:
        noise = np.concatenate([read_wav(f)[0] for f in noise_files]).astype(np.float32)
    else:
        noise = np.zeros(AUDIO_SAMPLES * 2, np.float32)
    if len(noise) < AUDIO_SAMPLES + 1:
        noise = np.pad(noise, (0, AUDIO_SAMPLES + 1 - len(noise)))

    np_rng = np.random.default_rng(seed)

    def pack(bucket: int, is_train: bool) -> PackedSplit:
        entries = known[bucket] + [(f, 1) for f in chosen_unknown[bucket]]
        n = len(entries)
        audio = np.zeros((max(n, 1), AUDIO_SAMPLES), np.int16)
        labels = np.zeros((max(n, 1),), np.int32)
        native = wavpack.load_files_packed([f for f, _ in entries], AUDIO_SAMPLES) if n else None
        if native is not None:
            audio[:n] = native[0]
        for i, (f, lab) in enumerate(entries):
            labels[i] = lab
            if native is None or native[1][i] < 0:  # no native reader, or it failed on this file
                audio[i] = _load_clip(f)
        n_sil = int(silence_prob * n)
        if not is_train and n_sil > 0:
            # Deterministic materialized silence: scaled noise slices.
            sil = np.zeros((n_sil, AUDIO_SAMPLES), np.int16)
            for i in range(n_sil):
                off = int(np_rng.integers(0, len(noise) - AUDIO_SAMPLES))
                a_scale = float(np_rng.random()) * 0.1
                clip = np.clip(a_scale * noise[off : off + AUDIO_SAMPLES], -1, 1)
                sil[i] = (clip * 32767.0).astype(np.int16)
            audio = np.concatenate([audio[:n], sil]) if n else sil
            labels = np.concatenate([labels[:n], np.zeros(n_sil, np.int32)])
            return PackedSplit(audio, labels, n_sil)
        return PackedSplit(audio[:n] if n else audio, labels[:n] if n else labels, n_sil)

    return PackedDataset(
        train=pack(S.TRAIN, True),
        dev=pack(S.DEV, False),
        test=pack(S.TEST, False),
        noise=noise,
        label_names=label_names,
    )
