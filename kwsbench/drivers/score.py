"""Offline batch scoring: the port's eval forward over a device-resident split, batch after batch.

Traffic keys: ``batch``, ``n_clips`` (one-second int16 clips made from the
seed on the device), ``clip_gain`` (log-uniform), ``output_gain`` (the Dense
weights' scale, so the logits spread as a trained model's),
``bn_clips`` (clips whose statistics become BN's running ones),
``trace_batches``.

Each batch is what ``train.steps.make_eval_step`` and datagen's
``evaluate_clips`` run: ``data.augment.eval_batch`` (B rows of the split,
the tail masked), the MFCC kernel (``frontend.mfcc.compute_mfccs``) and the
model's eval forward with its operands packed once (a bf16 res8: one
launch of the res-stack kernel in its ``bfloat16_activations`` mode). The
window sweeps the split round and round; each batch's logits go to their
rows of a device buffer. Every valid clip scored counts one audio-second.

``correct``: once the window has closed, every clip's logits in the buffer
(its last scoring) against the float32 reference's
(``reference.compare.logit_gaps``).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from kwsbench import common, harness, tracing
from kwsbench.reference import compare, frontend, precision

CLIP_SAMPLES = 16000


@dataclasses.dataclass
class Inputs:
    clips: torch.Tensor  # (n, 16000) int16 on the device
    weights: dict
    bn: dict


def make_inputs(seed: int, tr: dict, family, config: dict, device: torch.device) -> Inputs:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = tr["n_clips"]
    lo, hi = (float(np.log(v)) for v in tr["clip_gain"])
    gain = torch.exp(torch.rand(n, generator=g, device=device) * (hi - lo) + lo)
    clips = torch.empty((n, CLIP_SAMPLES), dtype=torch.int16, device=device)
    for a in range(0, n, 1024):
        x = torch.randn((min(n, a + 1024) - a, CLIP_SAMPLES), generator=g, device=device) * gain[a:a + 1024, None]
        clips[a:a + 1024] = (x.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    weights = common.make_weights(seed + 1, family, config, device, tr["output_gain"])
    with precision.no_tf32():
        feats = frontend.mfcc(clips[:tr["bn_clips"]].float() / 32768.0)
    return Inputs(clips, weights, family.eval_state(weights, config, feats))


def reference_logits(inputs: Inputs, family, config: dict, variant: str | None = None,
                     block: int = 1024) -> torch.Tensor:
    if variant not in (None, "fp8", "int8"):
        raise SystemExit(f"kwsbench: no control {variant!r} for scoring")
    out = []
    with precision.no_tf32(), torch.no_grad():
        for a in range(0, inputs.clips.shape[0], block):
            feats = frontend.mfcc(inputs.clips[a:a + block].float() / 32768.0)
            out.append(family.forward(inputs.weights, config, feats, bn=inputs.bn,
                                      rounding=precision.rounding(variant)))
    return torch.cat(out)


class Session:
    """The port's scoring objects for one seed: the model with its operands packed once, the split and the
    logits buffer."""

    def __init__(self, cell: harness.Cell, seed: int, device: torch.device):
        from honk_tpu_torch import use_full_f32
        from honk_tpu_torch.data.augment import eval_batch
        from honk_tpu_torch.frontend.mfcc import compute_mfccs
        from honk_tpu_torch.models import find_model

        self.eval_batch, self.compute_mfccs = eval_batch, compute_mfccs
        self.cell, self.device, config = cell, device, cell.config
        use_full_f32()
        self.inputs = make_inputs(seed, cell.traffic, cell.family, config, device)
        model = find_model(config["registry_name"])(config, dtype=getattr(torch, config["compute_dtype"]))
        self.model = common.load_weights(model.to(device), self.inputs.weights, self.inputs.bn).eval()
        self.n, self.b = self.inputs.clips.shape[0], cell.traffic["batch"]
        self.labels = torch.zeros(self.n, dtype=torch.int64, device=device)
        self.starts = list(range(0, self.n, self.b))
        self.logits = torch.zeros((len(self.starts) * self.b, config["n_labels"]), device=device)
        with torch.no_grad():
            self.packed = self.model.eval_operands()

    def score(self, i: int) -> int:
        """Score the ``i``-th batch of the sweep (round and round); returns the clips it scored."""
        start = self.starts[i % len(self.starts)]
        audio, _, _ = self.eval_batch(self.inputs.clips, self.labels, start, self.b)
        with torch.no_grad():
            self.logits[start:start + self.b] = self.model(self.compute_mfccs(audio), packed=self.packed)
        return min(self.b, self.n - start)

    def sweep(self) -> None:
        for i in range(len(self.starts)):
            self.score(i)

    def release(self) -> torch.Tensor:
        """Every clip's logits; frees the model and the buffer."""
        got = self.logits[:self.n].clone()
        del self.model, self.packed, self.logits
        return got

    def checks(self, got: torch.Tensor, control: str | None = None) -> list[tuple[str, float, float]]:
        ref = reference_logits(self.inputs, self.cell.family, self.cell.config)
        if control:
            got = reference_logits(self.inputs, self.cell.family, self.cell.config, control)
        largest, median = compare.logit_gaps(got, ref)
        return common.finite([("logit_gap", largest, self.cell.limits["logit_gap"]),
                              ("row_gap", median, self.cell.limits["row_gap"])])


def run(cell: harness.Cell, args, clock: common.Clock) -> None:
    from honk_tpu_torch import resolve_device

    tr, config = cell.traffic, cell.config
    device = resolve_device(args.device)
    power = harness.power_limit() if device.type == "cuda" else None
    if power:
        print(f"kwsbench: card and power limit: {power}", file=sys.stderr, flush=True)
    session = Session(cell, args.seed, device)
    session.sweep()  # warm every shape
    common.sync(device)

    setup_s = clock.since_start()
    scored, batches = 0, 0
    t = time.perf_counter()
    while time.perf_counter() - t < args.seconds:
        scored += session.score(batches)
        batches += 1
    common.sync(device)
    window_s = time.perf_counter() - t

    trace = None
    if args.trace:
        with tracing.traced(lambda: common.sync(device)) as out:
            for i in range(tr["trace_batches"]):
                session.score(i)
        trace = out[0]
    peak = common.peak_bytes(device)
    checks = session.checks(session.release(), args.control)
    result = {"correct": all(v <= lim for _, v, lim in checks), "attempted": batches, "failed": 0}
    if args.trace:
        counters = {"model_flops": scored * cell.family.model_flops(config), "window_s": window_s,
                    "res_forward_batch": session.b,
                    "mfcc_launch": (session.b * frontend.WINDOW_FRAMES, session.b * CLIP_SAMPLES),
                    "units": batches, "traced_units": tr["trace_batches"], "work_s": trace.busy_s()}
        reading = common.Reading(trace, counters, config, tr, common.device_name(device), 1)
        result["metrics"] = common.per_layer(cell, reading)
        result["device"] = common.device_block(device, 1, peak, trace.busy_s(), trace.window_s, power)
        result["breakdown"] = trace.breakdown()
    else:
        result["metrics"] = common.end_to_end(cell, {"score_audio_s_per_s": scored / window_s, "setup_s": setup_s})
        result["device"] = common.device_block(device, 1, peak, power=power)
    harness.emit(result, checks)


def readings(cell: harness.Cell, seed: int, device: torch.device, variants: list[str], mesh=None) -> dict:
    """The compared numbers of one seed without a window: the program's over one sweep, and each variant's
    in its place (for the calibration of the limits)."""
    session = Session(cell, seed, device)
    session.sweep()
    got = session.release()
    return {v: session.checks(got, v if v != "program" else None) for v in variants}
