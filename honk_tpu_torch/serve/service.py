"""Label service: single-utterance and batch keyword classification.

Counterpart of ``honk_tpu.serve.service.LabelService`` (reference
``service.py::LabelService``): ``evaluate(audio)`` trims/pads to 1 s, runs
MFCC + classifier, softmax, argmax, for any of the 16 model configs. On
``cuda`` (the default) the forward is the MFCC kernel, then the model's
eval forward: for res8 / res26 conv0 + pool in PyTorch and the res-stack
kernel, for res15 and cnn-* cuDNN convs and cuBLAS dense layers, all in
float32 with TF32 off. ``evaluate_long`` runs continuous detection over
long audio (``stream.stream_file``: one MFCC launch for the whole
waveform, one model call for all its windows), and ``make_batch_streamer``
gives the online slab the stream hub serves from. It takes honk ``.pt``
checkpoints; the Orbax loader and ``TrainingService`` come with later
slices.
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

import numpy as np
import torch

from .. import resolve_device, use_full_f32
from ..audio import AudioSnippet
from ..config import StreamConfig
from ..data import DEFAULT_WANTED_WORDS, LABEL_SILENCE, LABEL_UNKNOWN
from ..frontend import compute_mfccs
from ..models import find_config, find_model, load_honk_checkpoint
from ..stream import BatchStreamer, stream_file


def default_labels(wanted_words: Sequence[str] = DEFAULT_WANTED_WORDS) -> list[str]:
    return [LABEL_SILENCE, LABEL_UNKNOWN, *wanted_words]


class LabelService:
    """Keyword classification of 1 s utterances on one device.

    ``device`` defaults to ``cuda`` and raises where no CUDA device is
    present; ``device="cpu"`` runs the kernels' plain versions. The device
    forward is serialized by a lock, because the HTTP server is threaded.
    """

    def __init__(
        self,
        model_name: str,
        checkpoint: str,
        labels: Sequence[str] | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        use_full_f32()  # cuDNN convolutions and dense layers: keep them out of TF32
        cfg = find_config(model_name)
        self.labels = list(labels or default_labels())
        cfg["n_labels"] = len(self.labels)
        self.model = find_model(model_name)(cfg)
        load_honk_checkpoint(checkpoint, self.model)
        self.model.to(self.device).eval()
        self._packed = self.model.eval_operands()
        self._lock = threading.Lock()

    def logits(self, audio: np.ndarray) -> torch.Tensor:
        """(B, 16000) float32 -> (B, n_labels) logits on the service's device."""
        x = torch.as_tensor(np.asarray(audio, np.float32))
        with self._lock, torch.inference_mode():
            return self.model(compute_mfccs(x.to(self.device)), packed=self._packed)

    def evaluate(self, audio: np.ndarray) -> tuple[str, float]:
        """audio: float32 mono [-1,1], any length -> (label, prob)."""
        snip = AudioSnippet(np.asarray(audio, np.float32))
        if len(snip) > 16000:
            snip.trim_window(16000)
        snip.pad_to(16000)
        return self.evaluate_batch(snip.data[None, :])[0]

    def evaluate_batch(self, audio: np.ndarray) -> list[tuple[str, float]]:
        """(B, 16000) float32 -> [(label, prob)] per utterance."""
        probs = torch.softmax(self.logits(audio), dim=-1).cpu().numpy()
        idx = probs.argmax(axis=-1)
        return [(self.labels[int(i)], float(p[int(i)])) for i, p in zip(idx, probs)]

    def evaluate_long(
        self,
        audio: np.ndarray,
        stream_cfg: StreamConfig | None = None,
        data_axis: str | None = None,
    ) -> list[dict[str, Any]]:
        """Continuous detection over long audio; returns detection events
        ``{"time_s", "label", "prob"}``. ``data_axis`` (data parallel) is
        not in this port yet and raises."""
        with self._lock:
            _, events = stream_file(
                self.model, None, np.asarray(audio, np.float32), stream_cfg,
                data_axis=data_axis, packed=self._packed,
            )
        return [
            {"time_s": e.time_s, "label": self.labels[e.label], "prob": e.score}
            for e in events
        ]

    def make_batch_streamer(
        self,
        n_streams: int,
        stream_cfg: StreamConfig | None = None,
        chunk_samples: int = 3200,
        data_axis: str | None = None,
    ) -> BatchStreamer:
        """N concurrent online streams scored by one step, on the service's
        device with its model: feed ``(n_streams, chunk_samples)`` chunks per
        call."""
        return BatchStreamer(self.model, None, n_streams, stream_cfg, chunk_samples, data_axis)
