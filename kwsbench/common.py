"""What the drivers share: seeded weights on the device, the clock and the card, the per-layer readings, the
result line."""

from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from . import harness


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def make_weights(seed: int, family, config: dict, device: torch.device, output_gain: float = 1.0) -> dict:
    """The model's float32 parameters from ``seed``, made on ``device`` in one uniform draw in [-1, 1), each its
    share of it in the order of the family's ``param_shapes``, by the family's ``init``; the ``output`` weight's
    scale times ``output_gain``."""
    shapes = family.param_shapes(config)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand(sum(math.prod(s) for s in shapes.values()), generator=g, device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        gain = output_gain if name == "output.weight" else 1.0
        out[name] = family.init(name, u[at:at + n].view(shape), gain, shapes)
        at += n
    return out


def load_weights(model: torch.nn.Module, weights: dict, bn: dict | None = None) -> torch.nn.Module:
    """Copy ``weights`` (and the family's eval state, where it has one: BN's running statistics
    ``bn[i] = (mean, var)``) into the port's model."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
        for i, (mean, var) in (bn or {}).items():
            getattr(model, f"bn{i}").running_mean.copy_(mean)
            getattr(model, f"bn{i}").running_var.copy_(var)
    return model


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads: the traced slice, the drivers' counts and the cell."""

    trace: object
    counters: dict
    config: dict
    traffic: dict
    device_name: str
    chips: int


def per_layer(cell: harness.Cell, reading: Reading) -> dict:
    """Each per-layer metric of the cell that its reader finds, by name, with its unit."""
    out = {}
    for m in cell.per_layer:
        value = harness.reader(m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(cell: harness.Cell, values: dict) -> dict:
    """The cell's end-to-end metrics from ``values``, with their units."""
    return {m["name"]: {"value": _finite(float(values[m["name"]])), "unit": m["unit"]} for m in cell.end_to_end}


def _finite(v: float) -> float:
    """``v``, or a stand-in for infinity that JSON can carry (a failed request's latency)."""
    return v if math.isfinite(v) else 1e300


def device_block(device: torch.device, chips: int, peak_bytes: int, busy_s: float | None = None,
                 window_s: float | None = None, power: str | None = None) -> dict:
    block = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": device_name(device), "count": chips,
             "memory_peak_bytes": int(peak_bytes)}
    if busy_s is not None:
        block.update(busy_s=busy_s, window_s=window_s)
    if power is not None:
        block["power"] = power
    return block


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def finite(checks: list[tuple[str, float, float]]) -> list[tuple[str, float, float]]:
    """The checks with a non-finite value replaced by infinity's stand-in, so the line stays JSON."""
    return [(n, _finite(v), lim) for n, v, lim in checks]


class Clock:
    """Wall time since the run began (``t0``, the time the process, or its launcher, started)."""

    def __init__(self, t0: float, verbose: bool = True):
        self.t0, self.verbose = t0, verbose

    def since_start(self) -> float:
        return time.time() - self.t0

    def stage(self, what: str, since: float | None = None) -> float:
        """Print on stderr how long a stage of set-up took (from ``since``, or the start); returns now."""
        now = self.since_start()
        if self.verbose:
            print(f"kwsbench: set-up: {what} in {now - (since or 0.0):.3f} s (at {now:.3f} s)", file=sys.stderr,
                  flush=True)
        return now

