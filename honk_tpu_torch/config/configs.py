"""Typed configuration for the port (a copy of ``honk_tpu.config.configs``).

Equivalent of reference ``utils/train.py::ConfigBuilder`` (which merges
per-component default dicts into one argparse namespace). Here: explicit
dataclasses per subsystem with the same knobs and defaults as the
reference flag system, composable into an ``ExperimentConfig`` and
overridable from the CLI (``honk_tpu_torch.cli.train``). The model names
come from the port's own registry.

Reference defaults preserved (SURVEY.md §5.6): ``unknown_prob=0.1``,
``silence_prob=0.1``, ``noise_prob=0.8``, ``timeshift_ms=100``,
``batch_size=64``, SGD momentum 0.9, weight decay 1e-5, lr ladder
(0.1, 0.01, 0.001) stepped at (3000, 6000) global steps, ``n_epochs=26``,
``dev_every=1`` — the res8 training recipe.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..models.registry import ConfigType


@dataclasses.dataclass
class DataConfig:
    data_dir: str = "data/speech_dataset"
    wanted_words: Sequence[str] = ("yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go")
    unknown_prob: float = 0.1
    silence_prob: float = 0.1
    noise_prob: float = 0.8
    timeshift_ms: float = 100.0
    dev_pct: float = 10.0
    test_pct: float = 10.0
    sample_rate: int = 16000
    seed: int = 0

    @property
    def timeshift_samples(self) -> int:
        return int(self.timeshift_ms / 1000.0 * self.sample_rate)


@dataclasses.dataclass
class TrainConfig:
    model: str = ConfigType.RES8.value
    batch_size: int = 64
    n_epochs: int = 26
    lr: Sequence[float] = (0.1, 0.01, 0.001)
    schedule: Sequence[int] = (3000, 6000)  # global-step boundaries for the lr ladder
    momentum: float = 0.9
    weight_decay: float = 1e-5
    use_nesterov: bool = False
    dev_every: int = 1  # epochs between dev evaluations
    seed: int = 0
    eval_batch_size: int = 256
    input_file: str = ""  # warm-start checkpoint
    output_file: str = "model_best.ckpt"
    # Compute dtype of the model ("bfloat16": flax's dtype flow, cuDNN on the
    # tensor cores; params, BN statistics, the mean, the output Dense and the
    # loss stay f32).
    # Use "float32" for strict reference-numerics parity runs.
    compute_dtype: str = "bfloat16"
    # Train steps per chunk of the epoch loop (a Python loop in the port; the
    # JAX package folds them into one compiled scan). 1 disables.
    steps_per_call: int = 16


@dataclasses.dataclass
class MeshConfig:
    """Device-mesh layout. The models are tiny: replica-only param sharding,
    1-D data-parallel batch axis (BASELINE.json:5)."""

    data_axis: str = "data"
    n_devices: int = 0  # 0 = all visible devices


@dataclasses.dataclass
class StreamConfig:
    """Streaming continuous inference (reference service.py stride logic)."""

    window_samples: int = 16000
    hop_samples: int = 3200  # 200 ms detection stride
    smoothing_window: int = 5  # posteriors averaged over this many windows
    detection_threshold: float = 0.7
    min_gap_windows: int = 4  # refractory gap between repeated detections


@dataclasses.dataclass
class ExperimentConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
