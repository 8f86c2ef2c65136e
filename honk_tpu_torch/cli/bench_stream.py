"""Batched multi-stream online serving throughput (counterpart of ``scripts/bench_stream.py``).

    python -m honk_tpu_torch.cli.bench_stream                      # on the card
    ST_STREAMS=2 ST_REPS=1 ST_MODEL=res8-narrow python -m honk_tpu_torch.cli.bench_stream --device cpu

N concurrent online streams of a bf16 model (``ST_MODEL`` res8, weights
from a seeded generator) advanced by one ``BatchStreamer`` step per link:
the select-free step over every stream (no mask), the counterpart of the
JAX streamer's ``_step_all``. A step of a bf16 res8 launches the MFCC
kernel's causal mode once and the res stack's ``bfloat16_activations`` mode
once. ``ST_STREAMS`` 256 streams of ``ST_CHUNK`` 3200 samples (200 ms) a
step; chains of 8 and 32 back-to-back steps over a device-resident pool of
32 chunks per stream, each fenced once by ``.item()`` of the last
posteriors' sum; the step time is ``cli.bench``'s median marginal over
``ST_REPS`` 3 reps, after one untimed chain of each length. Prints one JSON
line with the reference's keys: audio-s advanced per s is
``N * chunk / 16000`` per step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .bench import device_name, marginal

CHAINS = (8, 32)


def settings() -> dict:
    """The knobs, from the environment, with the reference's defaults."""
    return {
        "model": os.environ.get("ST_MODEL", "res8"),
        "n_streams": int(os.environ.get("ST_STREAMS", "256")),
        "chunk": int(os.environ.get("ST_CHUNK", "3200")),
        "reps": int(os.environ.get("ST_REPS", "3")),
    }


def make_streamer(model_name: str, n_streams: int, chunk: int, device: torch.device, variables=None):
    """The bench's ``BatchStreamer``: a bf16 ``model_name`` on ``device``, its weights
    drawn from a seeded generator, or ``variables`` (a state dict in the port's names)."""
    from ..config import StreamConfig
    from ..models import find_config, find_model, init_weights
    from ..models.torch_compat import load_state_dict
    from ..stream import BatchStreamer

    model = find_model(model_name)(find_config(model_name), dtype=torch.bfloat16)
    if variables is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        load_state_dict(model, variables)
    return BatchStreamer(model.to(device).eval(), None, n_streams, StreamConfig(), chunk)


def run_bench(knobs: dict, device: torch.device) -> dict:
    n, chunk = knobs["n_streams"], knobs["chunk"]
    ll = CHAINS[1]
    bs = make_streamer(knobs["model"], n, chunk, device)
    rng = np.random.default_rng(0)
    pool = torch.from_numpy((rng.standard_normal((ll, n, chunk)) * 0.1).astype(np.float32)).to(device)

    # Serving-shaped: back-to-back steps, as a serving loop steps chunks it
    # has just received; the marginal between two chain lengths cancels the
    # fixed cost of a chain.
    def run_chain(length: int, seed: float) -> float:
        state = bs.reset()
        post = None
        t0 = time.perf_counter()
        for t in range(length):
            state, post = bs.process(state, pool[t % ll] + seed * 1e-12)
        post.sum().item()
        return time.perf_counter() - t0

    per_step, _ = marginal(run_chain, CHAINS, knobs["reps"])
    audio_per_step = n * chunk / 16000.0
    return {
        "model": knobs["model"],
        "n_streams": n,
        "chunk_samples": chunk,
        "step_ms": round(per_step * 1e3, 3),
        "audio_s_per_s": round(audio_per_step / per_step, 1),
        "realtime_streams_capacity": int(n * (chunk / 16000.0) / per_step),
        "device": device_name(device),
    }


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device

    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.bench_stream", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    print(json.dumps(run_bench(settings(), resolve_device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
