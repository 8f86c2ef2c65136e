"""One rank of the data-parallel tests of the port (``tests/test_torch_parallel.py``).

    python tests/torch_parallel_worker.py <rank> <world> <port> <spec.pt> <out.pt>

Joins a gloo process group of ``world`` ranks over 127.0.0.1 and runs, in
order, every data-parallel path the tests hold against one rank and
against the JAX package, on the inputs in ``spec.pt`` (made by the test
from seeded numpy): train steps of res8-narrow and cnn-trad-pool2, the
step on an injected JAX batch, an eval sweep, ``stream_file`` and a
``BatchStreamer`` with a masked slab and a weight swap, then ``train`` of
cnn-trad-pool2 for two epochs. Each rank writes what it computed to
``out.pt``. Imports nothing of JAX.
"""

import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from honk_tpu_torch.config import DataConfig, ExperimentConfig, MeshConfig, StreamConfig, TrainConfig  # noqa: E402
from honk_tpu_torch.data import augment as A  # noqa: E402
from honk_tpu_torch.metrics import MetricsLogger  # noqa: E402
from honk_tpu_torch.models import find_config, find_model, init_weights, load_state_dict  # noqa: E402
from honk_tpu_torch.parallel import initialize_distributed, make_data_mesh, shutdown  # noqa: E402
from honk_tpu_torch.stream import BatchStreamer, stream_file  # noqa: E402
from honk_tpu_torch.train import create_train_state, make_eval_sweep, make_optimizer, make_train_step  # noqa: E402
from honk_tpu_torch.train import train  # noqa: E402


def model_of(conf: str, state_dict=None, dtype=None):
    model = init_weights(find_model(conf)(find_config(conf), dtype=dtype), torch.Generator().manual_seed(0))
    return model if state_dict is None else load_state_dict(model, state_dict)


def train_steps(spec: dict, conf: str, mesh, dtype=None) -> dict:
    """``spec['steps']`` steps of ``conf`` from seed-0 weights in ``dtype``; the last step's collectives recorded."""
    aug = A.AugmentConfig(n_silence=spec["n_silence"])
    arrays = A.prepare_train_arrays(spec["raw"], spec["labels"], spec["noise"], aug)
    tx = make_optimizer(lrs=(0.01,), boundaries=())
    state = create_train_state(model_of(conf, dtype=dtype), tx)
    step = make_train_step(tx, spec["batch"], aug, mesh)
    losses = []
    for s in range(spec["steps"]):
        mesh.collectives = [] if s == spec["steps"] - 1 else None
        state, m = step(state, spec["key"], arrays)
        losses.append(float(m["loss"]))
    collectives, mesh.collectives = mesh.collectives, None
    return {"losses": losses, "state": state.model.state_dict(), "collectives": collectives}


def jax_batch_step(spec: dict, mesh) -> dict:
    """One step on the JAX step's batch (injected), this rank's rows."""
    j = spec["jax_step"]
    tx = make_optimizer(lrs=(0.01,), boundaries=())
    state = create_train_state(model_of("res8-narrow", j["variables"]), tx)
    start, stop = mesh.shard_rows(j["audio"].shape[0])
    step = make_train_step(tx, j["audio"].shape[0], A.AugmentConfig(), mesh)
    state, m = step.apply_batch(state, j["audio"][start:stop], j["labels"][start:stop])
    return {"loss": float(m["loss"]), "acc": float(m["acc"]), "state": state.model.state_dict()}


def eval_counts(spec: dict, mesh) -> tuple[int, int]:
    e = spec["eval"]
    c, t = make_eval_sweep(e["batch"], mesh)(model_of("res8-narrow", e["variables"]), e["audio"], e["labels"])
    return int(c), int(t)


def streaming(spec: dict) -> dict:
    s = spec["stream"]
    model = model_of("res8-narrow", s["variables"]).eval()
    cfg = StreamConfig(**s["cfg"])
    smoothed, events = stream_file(model, None, s["audio"], cfg, data_axis="data")
    bs = BatchStreamer(model, None, s["n_streams"], cfg, s["chunk"], data_axis="data")
    state, posts, kept = bs.reset(), [], True
    start, stop = bs.rows
    for t, chunks in enumerate(s["chunks"]):
        if t == s["swap_at"]:
            bs.set_variables(s["swapped"])
        mask = s["masks"][t]
        before = copy.deepcopy(state)
        state, post = bs.process(state, chunks, mask)
        for leaf_old, leaf_new in zip(before, state):  # masked-off rows of this rank: bit for bit
            off = ~torch.from_numpy(np.asarray(mask[start:stop]))
            kept &= torch.equal(leaf_old[off], leaf_new[off])
        posts.append(post)
    return {"smoothed": smoothed, "events": [(e.time_s, e.label, e.score) for e in events],
            "posts": torch.stack(posts), "masked_off_kept": bool(kept), "rows": bs.rows}


def train_run(spec: dict, rank: int) -> dict:
    """``train`` as ``tests/mp_worker.py`` drives the JAX one: cnn-trad-pool2, two epochs."""
    t = spec["train"]
    cfg = ExperimentConfig(
        data=DataConfig(data_dir=t["data_dir"], noise_prob=0.1, timeshift_ms=40),
        train=TrainConfig(model="cnn-trad-pool2", batch_size=16, n_epochs=2, lr=(0.01,), schedule=(),
                          dev_every=1, eval_batch_size=32, steps_per_call=4),
        mesh=MeshConfig(n_devices=spec["world"]),
    )
    result = train(cfg, logger=MetricsLogger(), device="cpu")
    checksum = float(sum(np.float64(v.abs().double().sum()) for v in result["best"].values()))
    return {"test_acc": result["test_acc"], "best_dev": result["best_dev_acc"], "param_checksum": checksum,
            "state": result["state"].model.state_dict()}


def main() -> int:
    rank, world, port, spec_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        spec = torch.load(spec_path, weights_only=False)
        spec["world"] = world
        mesh = make_data_mesh(world, "data")
        out = {
            "rank": rank, "world": world,
            "steps": {conf: train_steps(spec, conf, mesh) for conf in ("res8-narrow", "cnn-trad-pool2")},
            "jax_step": jax_batch_step(spec, mesh),
            "eval": eval_counts(spec, mesh),
            "stream": streaming(spec),
            "train": train_run(spec, rank),
        }
        torch.save(out, out_path)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
