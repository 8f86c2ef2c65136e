"""Label and training services: utterance classification and personalization.

Counterparts of ``honk_tpu.serve.service`` (reference
``service.py::LabelService / TrainingService``):

- ``LabelService.evaluate(audio)`` trims/pads to 1 s, runs MFCC +
  classifier, softmax, argmax, for any of the 16 model configs. On ``cuda``
  (the default) the forward is the MFCC kernel, then the model's eval
  forward: for res8 / res26 one launch of the res-stack kernel (conv0 and
  the pool inside), for res15 and cnn-* cuDNN convs and cuBLAS dense
  layers, all in float32 with TF32 off. ``evaluate_long`` runs continuous detection over
  long audio (``stream.stream_file``: one MFCC launch for the whole
  waveform, one model call for all its windows), and ``make_batch_streamer``
  gives the online slab the stream hub serves from. It takes a honk ``.pt``,
  an Orbax checkpoint directory of the JAX package (``ckpt.read_state_dict``:
  ``zoo/res8/best`` or the run directory ``zoo/res8``; it needs
  ``tensorstore``, and raises saying so where that is missing) or a state
  dict in the port's names; ``set_variables`` swaps in new weights.
- ``TrainingService.fine_tune`` personalizes: the JAX method step for step
  (positives, their contrastive scrambles as ``__unknown__``, SGD with
  momentum on the mean cross-entropy, BN frozen), on a copy of the
  service's current model. The features are one launch of the MFCC kernel
  (the audio has no gradient); the steps differentiate the model's
  ``frozen_forward``, because the res-stack kernel has no backward.

Threads: each service does its device work on one long-lived thread of its
own (``DeviceWorker``), whichever thread calls it: the HTTP server's thread
per connection would otherwise pay PyTorch's per-thread setup on every
new connection. ``LabelService``'s worker also runs the stream hub's slab
steps (``service.worker``); ``TrainingService`` has a second one, so a
fine-tune does not hold up ``/listen`` or the hub.
"""

from __future__ import annotations

import copy
import math
import threading
from typing import Any, Sequence

import numpy as np
import torch

from .. import resolve_device, use_full_f32
from ..audio import AudioSnippet
from ..config import StreamConfig
from ..data import DEFAULT_WANTED_WORDS, LABEL_SILENCE, LABEL_UNKNOWN
from ..frontend import compute_mfccs
from ..ckpt import read_state_dict
from ..models import find_config, find_model, load_state_dict
from ..stream import BatchStreamer, stream_file
from .worker import DeviceWorker


def default_labels(wanted_words: Sequence[str] = DEFAULT_WANTED_WORDS) -> list[str]:
    return [LABEL_SILENCE, LABEL_UNKNOWN, *wanted_words]


class LabelService:
    """Keyword classification of 1 s utterances on one device.

    ``device`` defaults to ``cuda`` and raises where no CUDA device is
    present; ``device="cpu"`` runs the kernels' plain versions. Every call's
    device work runs on the service's worker thread (``worker``), and the
    model and its packed operands are read and swapped together under a
    lock. ``variables`` is a honk ``.pt`` path, an Orbax checkpoint directory
    (``ckpt.read_state_dict``) or a state dict in the port's names.
    """

    def __init__(
        self,
        model_name: str,
        variables: str | dict[str, torch.Tensor],
        labels: Sequence[str] | None = None,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        use_full_f32()  # cuDNN convolutions and dense layers: keep them out of TF32
        cfg = find_config(model_name)
        self.labels = list(labels or default_labels())
        cfg["n_labels"] = len(self.labels)
        self.model = find_model(model_name)(cfg)
        load_state_dict(self.model, read_state_dict(variables) if isinstance(variables, str) else variables)
        self._lock = threading.Lock()
        self.worker = DeviceWorker("label-service-device")
        self.model, self._packed = self.worker.run(self._on_device, self.model)

    def _on_device(self, model: torch.nn.Module):
        model = model.to(self.device).eval()
        with torch.no_grad():
            return model, model.eval_operands()

    def set_variables(self, variables: dict[str, torch.Tensor]) -> None:
        """Serve new weights (a state dict in the port's names) from the next request on.

        The weights go into a new module and its ``eval_operands()`` are
        computed before ``(model, operands)`` are swapped under the lock: the
        old module is never written, so whatever still holds it (a stream
        hub's ``Streamer`` until its own ``set_variables``) keeps one whole
        model, never new convs against old packed operands.
        """
        self.worker.run(self._set_variables, variables)

    def _set_variables(self, variables: dict[str, torch.Tensor]) -> None:
        new, packed = self._on_device(load_state_dict(copy.deepcopy(self.model), variables))
        with self._lock:
            self.model, self._packed = new, packed

    def logits(self, audio: np.ndarray) -> torch.Tensor:
        """(B, 16000) float32 -> (B, n_labels) logits on the service's device."""
        return self.worker.run(self._logits, np.asarray(audio, np.float32))

    def _logits(self, audio: np.ndarray) -> torch.Tensor:
        with self._lock:
            model, packed = self.model, self._packed
        with torch.inference_mode():
            return model(compute_mfccs(torch.as_tensor(audio).to(self.device)), packed=packed)

    def evaluate(self, audio: np.ndarray) -> tuple[str, float]:
        """audio: float32 mono [-1,1], any length -> (label, prob)."""
        snip = AudioSnippet(np.asarray(audio, np.float32))
        if len(snip) > 16000:
            snip.trim_window(16000)
        snip.pad_to(16000)
        return self.evaluate_batch(snip.data[None, :])[0]

    def evaluate_batch(self, audio: np.ndarray) -> list[tuple[str, float]]:
        """(B, 16000) float32 -> [(label, prob)] per utterance."""
        probs = self.worker.run(lambda a: torch.softmax(self._logits(a), dim=-1).cpu().numpy(),
                                np.asarray(audio, np.float32))
        idx = probs.argmax(axis=-1)
        return [(self.labels[int(i)], float(p[int(i)])) for i, p in zip(idx, probs)]

    def evaluate_long(
        self,
        audio: np.ndarray,
        stream_cfg: StreamConfig | None = None,
        data_axis: str | None = None,
    ) -> list[dict[str, Any]]:
        """Continuous detection over long audio; returns detection events
        ``{"time_s", "label", "prob"}``. With ``data_axis``, every rank of
        the mesh calls this with the same audio (``stream_file``)."""

        def job():
            with self._lock:
                model, packed = self.model, self._packed
            return stream_file(model, None, np.asarray(audio, np.float32), stream_cfg,
                               data_axis=data_axis, packed=packed)[1]

        events = self.worker.run(job)
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
        call (from the service's worker, as the hub does). ``data_axis``
        shards the stream axis over the mesh's ranks (``BatchStreamer``)."""
        return self.worker.run(BatchStreamer, self.model, None, n_streams, stream_cfg, chunk_samples, data_axis)


class TrainingService:
    """Few-shot personalization: fine-tune on user positives + contrastives.

    The new keyword takes over an existing label slot (like the reference's
    web demo, which personalizes one of the command words); negatives are
    contrastive scrambles of the positives plus optional user negatives.
    Runs on the base service's device, on a worker thread of its own.
    """

    def __init__(self, base: LabelService, learning_rate: float = 0.01, steps: int = 60):
        self.base = base
        self.lr = learning_rate
        self.steps = steps
        self.worker = DeviceWorker("training-service-device")

    def fine_tune(
        self,
        positives: list[np.ndarray],
        target_label: str,
        negatives: list[np.ndarray] | None = None,
        seed: int = 0,
    ) -> dict[str, Any]:
        """New weights adapted so `positives` score as `target_label`:
        ``{"variables": <state dict in the port's names>, "final_loss": float}``.

        ``final_loss`` is the loss of the last step's forward, before its
        update, as in the JAX method. Raises ``ValueError`` for a label the
        service does not have or for no positives (the JAX method fails on
        both deeper down, in ``list.index`` and ``np.stack``).
        """
        return self.worker.run(self._fine_tune, positives, target_label, negatives, seed)

    def finite(self, result: dict[str, Any]) -> bool:
        """Whether a fine-tune's loss and every floating-point weight are finite (on the worker)."""
        return self.worker.run(lambda: math.isfinite(result["final_loss"]) and all(
            bool(torch.isfinite(v).all()) for v in result["variables"].values() if v.is_floating_point()))

    def _fine_tune(self, positives, target_label, negatives, seed) -> dict[str, Any]:
        labels = self.base.labels
        if not isinstance(target_label, str) or target_label not in labels:
            raise ValueError(f"unknown label {target_label!r}: the model's labels are {labels}")
        if not positives:
            raise ValueError("no positives: fine_tune needs at least one example of the keyword")
        label_idx = labels.index(target_label)
        unknown_idx = labels.index(LABEL_UNKNOWN)

        pos = [AudioSnippet(p).trim_window(16000).pad_to(16000).data for p in positives]
        negs = [n for p in positives for n in AudioSnippet(p).generate_contrastive(4, seed)]
        neg = [AudioSnippet(n.data).pad_to(16000).data[:16000] for n in negs]
        if negatives:
            neg += [AudioSnippet(n).trim_window(16000).pad_to(16000).data for n in negatives]
        # Balance classes: contrastive generation yields ~4 negatives per
        # positive; unbalanced CE drags everything to __unknown__.
        if len(pos) < len(neg):
            reps = -(-len(neg) // len(pos))
            pos = (pos * reps)[: len(neg)]

        device = self.base.device
        y = torch.tensor([label_idx] * len(pos) + [unknown_idx] * len(neg), dtype=torch.int64, device=device)
        with torch.no_grad():  # one MFCC launch: the audio takes no gradient
            feats = compute_mfccs(torch.from_numpy(np.stack(pos + neg)).to(device))

        # A copy of the service's current model, trained in eval mode (BN
        # frozen, no dropout); the service keeps answering meanwhile.
        model = copy.deepcopy(self.base.model).eval()
        opt = torch.optim.SGD(model.parameters(), lr=self.lr, momentum=0.9)  # = optax.sgd(lr, momentum=0.9)
        loss = None
        for _ in range(self.steps):
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(model.frozen_forward(feats), y)
            loss.backward()
            opt.step()
        return {"variables": model.state_dict(), "final_loss": loss.item()}
