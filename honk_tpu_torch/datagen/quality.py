"""Model-based quality evaluation for generated clips.

Counterpart of ``honk_tpu.datagen.quality``. The reference pairs its
generator with a human labeling workflow
(``keyword_spotting_data_generator/evaluation``); here a trained KWS model
scores every extracted clip in batches, and a clip is accepted when the
model's top-1 label is its claimed keyword at sufficient confidence. The
report (per-keyword acceptance and per-clip verdicts) has the JAX
function's keys and verdicts.

On the card each batch is one launch of the MFCC kernel and the model's
eval forward, its ``eval_operands()`` prepared once: for res8 / res26 one
launch of the res-stack kernel, for res15 and cnn-* cuDNN and cuBLAS.
Batches are padded to ``batch_size`` as in the JAX function, whose padding
keeps one compiled shape.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from ..frontend import compute_mfccs
from ..models import load_state_dict
from .extract import ExtractedClip


def evaluate_clips(
    model: torch.nn.Module,
    variables: dict[str, torch.Tensor] | None,
    labels: Sequence[str],
    clips: Iterable[ExtractedClip],
    min_prob: float = 0.5,
    batch_size: int = 256,
) -> dict[str, Any]:
    """Score clips with a trained model in eval mode, on its device; returns the acceptance report.

    ``variables`` is None (the model's own weights) or a state dict in the
    port's names, loaded into a copy of the model. ``labels`` is the
    model's output-index -> label-name list (the label service convention,
    serve/service.py). Clips whose keyword is not in ``labels`` are
    reported under ``unknown_keywords`` rather than scored.
    """
    if model.training:
        raise ValueError("evaluate_clips scores with the eval forward: pass a model in eval mode")
    clips = list(clips)
    idx_of = {w: i for i, w in enumerate(labels)}
    scored = [c for c in clips if c.keyword in idx_of]
    skipped = [c.keyword for c in clips if c.keyword not in idx_of]
    if variables is not None:
        model = load_state_dict(copy.deepcopy(model), variables).eval()
    device = next(model.parameters()).device

    verdicts: list[dict[str, Any]] = []
    with torch.inference_mode():
        packed = model.eval_operands()
        for i in range(0, len(scored), batch_size):
            chunk = scored[i : i + batch_size]
            batch = np.stack([c.audio for c in chunk])
            pad = batch_size - batch.shape[0]
            if pad:
                batch = np.pad(batch, ((0, pad), (0, 0)))
            audio = torch.from_numpy(np.asarray(batch, np.float32)).to(device)
            logits = model(compute_mfccs(audio), packed=packed)
            probs = torch.softmax(logits, dim=-1)[: len(chunk)].cpu().numpy()
            for c, p in zip(chunk, probs):
                top = int(p.argmax())
                want = idx_of[c.keyword]
                verdicts.append(
                    {
                        "keyword": c.keyword,
                        "source_time": float(c.source_time),
                        "pred": labels[top],
                        "prob": float(p[top]),
                        "keyword_prob": float(p[want]),
                        "accept": bool(top == want and p[top] >= min_prob),
                    }
                )

    per_kw: dict[str, dict[str, int]] = {}
    for v in verdicts:
        s = per_kw.setdefault(v["keyword"], {"total": 0, "accepted": 0})
        s["total"] += 1
        s["accepted"] += int(v["accept"])
    return {
        "n_clips": len(clips),
        "n_scored": len(scored),
        "unknown_keywords": sorted(set(skipped)),
        "per_keyword": {
            k: {**s, "acceptance": (s["accepted"] / s["total"]) if s["total"] else 0.0}
            for k, s in sorted(per_kw.items())
        },
        "verdicts": verdicts,
    }
