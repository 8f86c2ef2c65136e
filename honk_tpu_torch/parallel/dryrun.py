"""The multi-device dry run (counterpart of ``__graft_entry__.py::dryrun_multichip``).

    python -m honk_tpu_torch.parallel.dryrun --n 2 --device cpu   # 2 local ranks, gloo
    python -m honk_tpu_torch.parallel.dryrun --n 1                # 1 rank on the card, NCCL

``dryrun_multichip(n)`` runs in every rank of a world of ``n`` (a process
group of ``n`` ranks, or a single process without one when ``n`` is 1) and
drives, at res8's full width on tiny shapes, every data-parallel path:

1. one train step with the batch sharded over the ranks, on the exact
   layout and on the sub-row layout (the TPU kernel's), loss finite;
2. the sharded eval sweep: the count is every clip, once;
3. a ``BatchStreamer`` with its stream axis sharded (one stream per rank);
4. the masked slab: only the masked-on slot advances, the others keep
   their state bit for bit;
5. a weight refresh on every rank reaches the next step's posteriors.

It raises on the first failure and returns the numbers it checked.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device
from ..data import AugmentConfig, prepare_train_arrays
from ..models import find_config, find_model, init_weights
from ..stream import BatchStreamer
from ..train import create_train_state, make_eval_sweep, make_optimizer, make_train_step
from .mesh import make_data_mesh
from .runtime import initialize_distributed, is_primary, launch_local_ranks, rank_device, shutdown, world_size


def _say(msg: str) -> None:
    if is_primary():
        print(msg, flush=True)


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None) -> dict:
    """Every data-parallel path once over a world of ``n_devices`` ranks; raises on a failure."""
    if world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs {n_devices} ranks; this world has {world_size()}")
    dev = rank_device(resolve_device(device))
    mesh = make_data_mesh(n_devices, "data")
    out: dict = {}

    model = init_weights(find_model("res8")(find_config("res8")), torch.Generator().manual_seed(0))
    mesh.replicate(model.to(dev))
    tx = make_optimizer()
    state = create_train_state(model, tx)

    rng = np.random.default_rng(0)
    n_clips = 4 * n_devices
    batch = 2 * n_devices  # divisible by the mesh
    aug = AugmentConfig(n_silence=2)
    labels = rng.integers(2, 12, (n_clips,), dtype=np.int32)
    for layout, key in (("exact", 1), ("subrow", 2)):
        arrays = prepare_train_arrays(
            rng.integers(-3000, 3000, (n_clips, 16000), dtype=np.int16),
            labels, rng.standard_normal(16000 * 3).astype(np.float32) * 0.05, aug, layout=layout, device=dev,
        )
        state, m = make_train_step(tx, batch, aug, mesh)(state, key, arrays)
        loss = float(m["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite {layout} loss {loss}")
        out[f"loss_{layout}"] = loss
        _say(f"dryrun_multichip({n_devices}): {layout} train step ok, loss={loss:.4f}")

    eval_audio = torch.from_numpy(rng.integers(-3000, 3000, (n_clips, 16000), dtype=np.int16)).to(dev)
    correct, total = make_eval_sweep(batch, mesh)(model, eval_audio, torch.from_numpy(labels).long().to(dev))
    if int(total) != n_clips:
        raise RuntimeError(f"dryrun_multichip({n_devices}): eval counted {int(total)} of {n_clips}")
    out["eval"] = (int(correct), int(total))
    _say(f"dryrun_multichip({n_devices}): sharded eval ok, acc={int(correct)}/{int(total)}")

    bs = BatchStreamer(model, None, n_devices, chunk_samples=3200, data_axis="data")
    chunks = (rng.standard_normal((n_devices, 3200)) * 0.1).astype(np.float32)
    st, post = bs.process(bs.reset(), chunks)
    if tuple(post.shape) != (n_devices, model.output.out_features) or not bool(torch.isfinite(post).all()):
        raise RuntimeError(f"dryrun_multichip({n_devices}): streaming posteriors {tuple(post.shape)}")
    out["stream_post_shape"] = tuple(post.shape)
    _say(f"dryrun_multichip({n_devices}): sharded streaming ok, post shape={tuple(post.shape)}")

    mask = np.zeros((n_devices,), bool)
    mask[0] = True
    before = st.feat_ring.clone()
    st2, _ = bs.process(st, chunks, mask)
    after = st2.feat_ring
    start, stop = bs.rows
    for slot in range(start, stop):  # this rank's slots
        moved = not torch.equal(before[slot - start], after[slot - start])
        if moved != bool(mask[slot]):
            raise RuntimeError(f"dryrun_multichip({n_devices}): slot {slot} {'moved' if moved else 'stayed'} "
                               f"with mask {bool(mask[slot])}")
    _say(f"dryrun_multichip({n_devices}): masked session slab ok")

    st3, post_a = bs.process(st2, chunks)
    bs.set_variables({k: v * 1.5 if v.is_floating_point() else v for k, v in model.state_dict().items()})
    _, post_b = bs.process(st3, chunks)
    if torch.allclose(post_a, post_b, atol=1e-6):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the weight swap did not reach the sharded slab")
    out["refresh_max_change"] = float((post_a - post_b).abs().max())
    _say(f"dryrun_multichip({n_devices}): sharded slab weight refresh ok")
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.parallel.dryrun", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=1, help="ranks (one per device)")
    p.add_argument("--device", default="cuda", help="cuda (NCCL, the default) or cpu (gloo)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    if args.coordinator is None and args.n > 1:
        return launch_local_ranks("honk_tpu_torch.parallel.dryrun", argv, args.n)
    device = resolve_device(args.device)
    initialize_distributed(args.coordinator, args.num_processes, args.process_id, device)
    try:
        dryrun_multichip(args.n, device)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
