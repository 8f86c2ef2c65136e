#!/usr/bin/env python3
"""How far apart two executions of one bf16 train step are, per tensor, against the bf16-float32 distance.

    python scripts/probe_bf16_step_spread.py [--conf res8] [--batch 64] [--seed 0]

One train step of a res config (flax's initial weights, biases drawn from N(0, 0.1^2),
features N(0, 10^2), the recipe of ``tests/test_torch_bf16_train.py``) of
``--conf`` at ``--batch`` in three executions: JAX's bf16 step op by op
(``jax.disable_jit()``: flax's dtype flow, the reference), JAX's compiled
bf16 step, and the port's bf16 step on the CPU; and JAX's compiled float32
step. For each execution other than the reference, prints each gradient
tensor's share ``|g - g_ref| / |g_ref - g_f32|`` (Frobenius norms) and the
share over all tensors, as one JSON line. JAX's own share says what two
legitimate executions of the same bf16 program part by, tensor by tensor.
Imports both packages, as the tests do; CPU only, seconds at res8 B=64.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def shares(got: dict, ref: dict, f32: dict) -> dict:
    import numpy as np

    out = {k: float(np.linalg.norm(got[k] - ref[k]) / np.linalg.norm(ref[k] - f32[k])) for k in ref}
    out["all"] = float(np.sqrt(sum(np.linalg.norm(got[k] - ref[k]) ** 2 for k in ref))
                       / np.sqrt(sum(np.linalg.norm(ref[k] - f32[k]) ** 2 for k in ref)))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--conf", default="res8", choices=["res8", "res8-narrow", "res15", "res15-narrow", "res26",
                                                       "res26-narrow"], help="a res config (no dropout)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    import test_torch_bf16_train as T

    variables = T._variables(args.conf, args.seed)
    rng = np.random.default_rng(args.seed)
    feats = (rng.standard_normal((args.batch, 101, 40)) * 10).astype(np.float32)
    labels = rng.integers(0, T.jfind_config(args.conf)["n_labels"], args.batch)
    step = {mode: T._jax_step(args.conf, variables, feats, labels, jnp.bfloat16, mode)["grads"]
            for mode in ("op-by-op", "jit")}
    f32 = T._jax_step(args.conf, variables, feats, labels, None, "jit")["grads"]
    port = T._port_step(args.conf, variables, feats, labels, None)["grads"]
    print(json.dumps({"conf": args.conf, "batch": args.batch, "seed": args.seed,
                      "jax_compiled": shares(step["jit"], step["op-by-op"], f32),
                      "port_cpu": shares(port, step["op-by-op"], f32)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
