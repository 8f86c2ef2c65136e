"""The res-stack kernel against the library path of the same forward (counterpart of ``scripts/bench_res_kernel.py``).

    python -m honk_tpu_torch.cli.bench_res_kernel                          # on the card
    RK_MODEL=res8-narrow RK_BATCH=2 RK_REPS=1 python -m honk_tpu_torch.cli.bench_res_kernel --device cpu

The reference's knobs and defaults: ``RK_MODEL`` res8, ``RK_BATCH`` 1024,
``RK_REPS`` 3, chains of 8 and 32 links. The model is built bf16 (weights
from a seeded generator). A link is the reference's scan body: a rolling
slice of a pool of ``max(2048, 2 B)`` feature maps ``N(0, 2^2)`` (made
from ``default_rng(0)``, on the device) plus ``acc * 1e-12``, a forward,
and ``acc += logits.sum()``. The legs:

- ``fused`` (the reference's ``res_forward_fused``, the Pallas kernel):
  ``ops.res_forward_fused``, one launch of the res-stack kernel's
  ``bfloat16`` mode (bf16 operands, float32 activations, the TPU kernel's)
  with a float32 stem (conv0 and the pool) inside; its operands packed once;
- ``xla`` (flax's bf16 ``apply`` run by XLA): the library path of the same
  bf16 dtype flow, ``model._folded_stack(feats, bf16, *fold_bn(model))``:
  cuDNN's bf16 convs and PyTorch's elementwise ops, BN folded once. That is
  the code that serves a dilated res15's eval forward; it is not
  ``model(feats)``, which runs the kernel;
- printed first, on a line of its own and not in the JSON: the bf16
  model's own eval forward ``model(feats)``, the kernel's
  ``bfloat16_activations`` mode with its bf16 stem inside, what a user runs.

Each leg's time is ``cli.bench.marginal``: the median over reps of the
marginal between the two chain lengths, after one untimed chain of each.
``compile_s`` is the seconds of a leg's first chain (8 links), which
include a kernel's build at its first use in the process (``ops/_build``);
the reference's is XLA's compile. Prints one JSON line with the
reference's keys; ``device`` is the card's name (``cpu`` with ``--device
cpu``, which runs the kernel's plain version).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable

import numpy as np
import torch

from . import bench

CHAINS = (8, 32)


def settings() -> dict:
    """The knobs, from the environment, with the reference's defaults."""
    return {
        "model": os.environ.get("RK_MODEL", "res8"),
        "batch": int(os.environ.get("RK_BATCH", "1024")),
        "reps": int(os.environ.get("RK_REPS", "3")),
    }


def make_pool(batch: int, device: torch.device) -> torch.Tensor:
    """The reference's device-resident pool of feature maps."""
    pool_n = max(2048, batch * 2)
    rng = np.random.default_rng(0)
    return torch.from_numpy((rng.standard_normal((pool_n, 101, 40)) * 2).astype(np.float32)).to(device)


def make_forwards(model: torch.nn.Module) -> dict[str, Callable]:
    """``{leg: feats -> logits}`` for a bf16 res8 / res26 model, operands prepared once."""
    from ..ops.res_kernel import fold_bn, pack_res_params, res_forward_fused

    model.eval()
    with torch.no_grad():
        fused_ops = pack_res_params(model, torch.bfloat16)
        folded = fold_bn(model)
        own = model.eval_operands()
    return {
        "model": lambda f: model(f, packed=own),
        "xla": lambda f: model._folded_stack(f, torch.bfloat16, *folded),
        "fused": lambda f: res_forward_fused(model, f, packed=fused_ops),
    }


def make_link(forward: Callable, pool: torch.Tensor, batch: int) -> Callable:
    """``link(i, acc) -> acc``: the reference's scan body around ``forward``."""
    pool_n = pool.shape[0]

    @torch.no_grad()
    def link(i: int, acc: torch.Tensor) -> torch.Tensor:
        start = (i * batch) % (pool_n - batch)
        return acc + forward(pool[start:start + batch] + acc * 1e-12).float().sum()

    return link


def time_leg(link: Callable, device: torch.device, reps: int) -> tuple[float, float]:
    """(median marginal seconds per link, seconds of the first chain)."""
    times: list[float] = []
    t, _ = bench.marginal(bench.recorded(bench.make_infer_run(link, device), times), CHAINS, reps)
    return t, times[0]


def run_bench(knobs: dict, device: torch.device) -> tuple[float, dict]:
    """The bf16 model's own forward's seconds per batch, and the reference's record."""
    from .. import use_full_f32

    use_full_f32()
    name, batch, reps = knobs["model"], knobs["batch"], knobs["reps"]
    model = bench.make_model(name, torch.bfloat16, device)
    pool = make_pool(batch, device)
    t = {}
    compile_s = {}
    for leg, forward in make_forwards(model).items():
        t[leg], compile_s[leg] = time_leg(make_link(forward, pool, batch), device, reps)
    return t["model"], {
        "model": name,
        "batch": batch,
        "xla_ms_per_batch": round(t["xla"] * 1e3, 3),
        "fused_ms_per_batch": round(t["fused"] * 1e3, 3),
        "xla_audio_s_per_s": round(batch / t["xla"], 1),
        "fused_audio_s_per_s": round(batch / t["fused"], 1),
        "speedup_fused_over_xla": round(t["xla"] / t["fused"], 3),
        "compile_s": {"xla": round(compile_s["xla"], 1), "fused": round(compile_s["fused"], 1)},
        "device": bench.device_name(device),
    }


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device

    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.bench_res_kernel", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    knobs = settings()
    own, row = run_bench(knobs, resolve_device(args.device))
    print(f"model_eval_ms_per_batch: {own * 1e3:.3f} ({knobs['model']} bf16 model(feats), "
          f"the res stack's bfloat16_activations mode; {knobs['batch'] / own:.1f} audio-s/s)", flush=True)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
