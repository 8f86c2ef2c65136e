"""One rank of the bf16 data-parallel test of the port (``tests/test_torch_bf16_train.py``).

    python tests/torch_bf16_rank_worker.py <rank> <world> <port> <spec.pt> <out.pt>

Joins a gloo process group of ``world`` ranks over 127.0.0.1 and runs the
train steps of ``tests/torch_parallel_worker.py`` on models built in bf16,
for each config in ``spec['confs']``, or, where ``spec`` holds
``batches``, res8-narrow's steps on those global batches (the JAX step's
draws, injected) from ``spec['variables']``, this rank's rows of each, in
each of ``spec['dtypes']`` (bf16 alone by default): the state after every
step recorded, the first step's gradients, and each step's gradients,
momentum and BN input gradients (``steps``); writes what it computed to
``out.pt``.
With world 1 it joins no group: the one-rank reference, which also runs
the float32 steps. Imports nothing of JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parallel_worker import model_of, train_steps  # noqa: E402
from honk_tpu_torch.data import AugmentConfig  # noqa: E402
from honk_tpu_torch.models import res  # noqa: E402
from honk_tpu_torch.parallel import initialize_distributed, make_data_mesh, shutdown  # noqa: E402
from honk_tpu_torch.train import create_train_state, make_optimizer, make_train_step  # noqa: E402


def batch_steps(spec: dict, mesh, dtype=None) -> tuple[list[dict], dict, list[dict]]:
    """res8-narrow's steps on ``spec['batches']`` (this rank's rows) from ``spec['variables']``: the state
    after each, each parameter's gradient of the first step as the update took it, and of each step
    the gradients, the momentum and each BN's input gradient (its own cotangent of this rank's rows)."""
    tx = make_optimizer(lrs=(0.01,), boundaries=())
    state = create_train_state(model_of("res8-narrow", spec["variables"], dtype), tx)
    names = {p: n for n, p in state.model.named_parameters()}
    norm, bn_dx = res.batch_norm_train, []

    def tapped(x, bn, mesh=None):
        x = x.view_as(x)  # a node of its own: its cotangent is BN's input gradient alone
        x.register_hook(lambda g: bn_dx.append(g.detach().clone()))
        return norm(x, bn, mesh)

    states, grads, steps = [], {}, []
    res.batch_norm_train = tapped
    try:
        for audio, labels in spec["batches"]:
            start, stop = mesh.shard_rows(audio.shape[0])
            step = make_train_step(tx, audio.shape[0], AugmentConfig(), mesh)
            bn_dx.clear()
            state, _ = step.apply_batch(state, audio[start:stop], labels[start:stop])
            states.append({k: v.clone() for k, v in state.model.state_dict().items()})
            grads = grads or {k: p.grad.clone() for k, p in state.model.named_parameters()}
            steps.append({"grads": {k: p.grad.clone() for k, p in state.model.named_parameters()},
                          "momentum": {names[p]: s["momentum_buffer"].clone() for p, s in state.optimizer.state.items()},
                          "bn_dx": bn_dx[::-1]})  # in layer order
    finally:
        res.batch_norm_train = norm
    return states, grads, steps

def main() -> int:
    rank, world, port, spec_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    if world > 1:
        initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        spec = torch.load(spec_path, weights_only=False)
        mesh = make_data_mesh(world if world > 1 else 0, "data")
        if "batches" in spec:
            out = {"steps": {}}
            for name in spec.get("dtypes", ["bfloat16"]):
                states, grads, out["steps"][name] = batch_steps(spec, mesh, getattr(torch, name))
                if name == "bfloat16":
                    out.update({"bfloat16": states, "grads": grads})
        else:
            out = {conf: train_steps(spec, conf, mesh, torch.bfloat16) for conf in spec["confs"]}
            if world == 1:  # and the float32 steps, to show the bf16 ones are another computation
                out["float32"] = {conf: train_steps(spec, conf, mesh) for conf in spec["confs"]}
        torch.save(out, out_path)
    finally:
        if world > 1:
            shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
