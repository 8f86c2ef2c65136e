"""Offline keyword search: the port's ``stream.streamer.stream_file`` over long recordings, one client in a
closed loop.

Traffic keys: ``recording_seconds``, ``n_recordings`` (float32 recordings
made from the seed in set-up and held in host memory: noise whose gain
changes every ``gain_block_s`` seconds, log-uniform in ``gain``),
``output_gain`` and ``bn_windows`` (as the scoring driver's
``output_gain`` / ``bn_clips``), ``stream`` (the port's ``StreamConfig``),
``check_requests``, ``trace_requests``.

A request is one recording, taken in a seeded order, from the waveform in
host memory to the smoothed posteriors and the detections in host memory:
the copy to the card, the MFCC kernel's centre framing of the whole
recording, every 101-frame window every hop through the model's eval
forward (its operands prepared once, as a service prepares them), the
softmax, the smoothing, the copy back and the detections. Latency is each
request's host time; every recording-second searched counts one
audio-second.

``correct``: once the window has closed, a sample of the requests drawn
from the seed: their smoothed posteriors against the float32 reference's
for the same recording (the largest gap), and their detections against the
reference's detector run on the posteriors the program returned (an exact
match: the detector takes no arithmetic the posteriors' gap does not
already cover).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from kwsbench import common, harness, tracing
from kwsbench.reference import frontend, precision, stream as ref_stream


@dataclasses.dataclass
class Inputs:
    recordings: list  # float32 numpy arrays in host memory
    weights: dict
    bn: dict


def make_inputs(seed: int, tr: dict, family, config: dict, device: torch.device) -> Inputs:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_samples = int(tr["recording_seconds"] * frontend.SAMPLE_RATE)
    block = int(tr["gain_block_s"] * frontend.SAMPLE_RATE)
    lo, hi = (math.log(v) for v in tr["gain"])
    recs = []
    for _ in range(tr["n_recordings"]):
        gains = torch.exp(torch.rand(-(-n_samples // block), generator=g, device=device) * (hi - lo) + lo)
        x = torch.randn(n_samples, generator=g, device=device) * gains.repeat_interleave(block)[:n_samples]
        recs.append(x.clamp(-1.0, 1.0).cpu().numpy())
    weights = common.make_weights(seed + 1, family, config, device, tr["output_gain"])
    with precision.no_tf32():
        feats = frontend.mfcc(torch.from_numpy(recs[0]).to(device)[None])[0]
        windows = feats.unfold(0, frontend.WINDOW_FRAMES, tr["stream"]["hop_samples"] // frontend.HOP)
        windows = windows.transpose(1, 2)[:tr["bn_windows"]]
    return Inputs(recs, weights, family.eval_state(weights, config, windows))


def reference_search(inputs: Inputs, family, config: dict, stream: dict, r: int, device: torch.device,
                     variant: str | None = None) -> np.ndarray:
    if variant not in (None, "fp8", "int8"):
        raise SystemExit(f"kwsbench: no control {variant!r} for recordings")
    rounding = precision.rounding(variant)
    audio = torch.from_numpy(inputs.recordings[r]).to(device)
    return ref_stream.search(family.forward, inputs.weights, config, inputs.bn, audio, stream,
                             rounding).cpu().numpy()


class Session:
    """The port's search objects for one seed: the model with its operands prepared once, the recordings in
    host memory and their seeded order."""

    def __init__(self, cell: harness.Cell, seed: int, device: torch.device):
        from honk_tpu_torch import use_full_f32
        from honk_tpu_torch.config import StreamConfig
        from honk_tpu_torch.models import find_model
        from honk_tpu_torch.stream import streamer

        self.streamer, self.cell, self.device, config = streamer, cell, device, cell.config
        use_full_f32()
        self.inputs = make_inputs(seed, cell.traffic, cell.family, config, device)
        model = find_model(config["registry_name"])(config, dtype=getattr(torch, config["compute_dtype"]))
        self.model = common.load_weights(model.to(device), self.inputs.weights, self.inputs.bn).eval()
        self.cfg = StreamConfig(**cell.traffic["stream"])
        with torch.no_grad():
            self.packed = self.model.eval_operands()
        self.order = np.random.default_rng(seed).permutation(len(self.inputs.recordings))

    def recording(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def request(self, i: int):
        """The ``i``-th request: (smoothed posteriors, detections) on the host."""
        return self.streamer.stream_file(self.model, None, self.inputs.recordings[self.recording(i)], self.cfg,
                                         packed=self.packed)

    def release(self) -> None:
        del self.model, self.packed

    def checks(self, done: list, control: str | None = None) -> list[tuple[str, float, float]]:
        """``done``: (request index, smoothed, detections) of the requests to compare."""
        tr, family, config, cfg = self.cell.traffic, self.cell.family, self.cell.config, self.cfg
        hop_s = cfg.hop_samples / frontend.SAMPLE_RATE
        refs: dict[int, np.ndarray] = {}
        gap, mismatched, found = (0.0 if done else math.inf), 0, 0
        for i, smoothed, dets in done:
            r = self.recording(i)
            if r not in refs:
                refs[r] = reference_search(self.inputs, family, config, tr["stream"], r, self.device)
            if control:
                smoothed = reference_search(self.inputs, family, config, tr["stream"], r, self.device, control)
                dets = [self.streamer.Detection(*e) for e in ref_stream.detect(
                    smoothed, cfg.detection_threshold, cfg.min_gap_windows, hop_s)]
            gap = max(gap, float(np.abs(smoothed - refs[r]).max()) if smoothed.shape == refs[r].shape else math.inf)
            want = ref_stream.detect(smoothed, cfg.detection_threshold, cfg.min_gap_windows, hop_s)
            mismatched += len(set(want) ^ {(d.time_s, d.label, d.score) for d in dets})
            found += len(want)
        print(f"kwsbench: {len(done)} searches compared, {found} detections among them", file=sys.stderr)
        return common.finite([("posterior_gap", gap, self.cell.limits["posterior_gap"]),
                              ("detections_mismatched", float(mismatched), self.cell.limits["detections_mismatched"])])


def run(cell: harness.Cell, args, clock: common.Clock) -> None:
    from honk_tpu_torch import resolve_device

    tr, config = cell.traffic, cell.config
    device = resolve_device(args.device)
    power = harness.power_limit() if device.type == "cuda" else None
    if power:
        print(f"kwsbench: card and power limit: {power}", file=sys.stderr, flush=True)
    session = Session(cell, args.seed, device)
    session.request(0)  # warm: every request has the same shapes
    common.sync(device)

    setup_s = clock.since_start()
    done, latencies, failed = [], [], 0
    t = time.perf_counter()
    while time.perf_counter() - t < args.seconds:
        i = len(latencies)
        t_req = time.perf_counter()
        try:
            smoothed, dets = session.request(i)
        except RuntimeError as e:  # counted against attempted; it misses every latency
            print(f"kwsbench: request {i} failed: {e}", file=sys.stderr)
            failed += 1
            latencies.append(math.inf)
            continue
        latencies.append(time.perf_counter() - t_req)
        done.append((i, smoothed, dets))
    window_s = time.perf_counter() - t

    trace = None
    if args.trace:
        with tracing.traced(lambda: common.sync(device)) as out:
            for i in range(tr["trace_requests"]):
                session.request(i)
        trace = out[0]
    peak = common.peak_bytes(device)
    session.release()
    pick = np.random.default_rng(args.seed + 1).choice(len(done), min(tr["check_requests"], len(done)),
                                                       replace=False)
    checks = session.checks([done[j] for j in sorted(pick)], args.control)
    result = {"correct": failed == 0 and all(v <= lim for _, v, lim in checks), "attempted": len(latencies),
              "failed": failed}
    windows = len(done[0][1]) if done else 0
    if args.trace:
        n_samples = int(tr["recording_seconds"] * frontend.SAMPLE_RATE)
        counters = {"model_flops": len(done) * windows * cell.family.model_flops(config), "window_s": window_s,
                    "mfcc_launch": (1 + n_samples // frontend.HOP, n_samples), "units": len(done),
                    "traced_units": tr["trace_requests"], "work_s": trace.busy_s()}
        reading = common.Reading(trace, counters, config, tr, common.device_name(device), 1)
        result["metrics"] = common.per_layer(cell, reading)
        result["device"] = common.device_block(device, 1, peak, trace.busy_s(), trace.window_s, power)
        result["breakdown"] = trace.breakdown()
    else:
        values = {"search_audio_s_per_s": len(done) * tr["recording_seconds"] / window_s, "setup_s": setup_s,
                  "recording_ms.p95": float(np.percentile(np.asarray(latencies) * 1e3, 95))}
        result["metrics"] = common.end_to_end(cell, values)
        result["device"] = common.device_block(device, 1, peak, power=power)
    harness.emit(result, checks)


def readings(cell: harness.Cell, seed: int, device: torch.device, variants: list[str], mesh=None) -> dict:
    """The compared numbers of one seed without a window: the program's over ``check_requests`` requests, and
    each variant's in its place (for the calibration of the limits)."""
    session = Session(cell, seed, device)
    done = [(i, *session.request(i)) for i in range(cell.traffic["check_requests"])]
    session.release()
    return {v: session.checks(done, v if v != "program" else None) for v in variants}
