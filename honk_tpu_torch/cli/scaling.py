"""Data-parallel scaling harness (counterpart of ``scripts/scaling_bench.py``).

    python -m honk_tpu_torch.cli.scaling 1 2 4               # NCCL ranks, rank r on card r
    python -m honk_tpu_torch.cli.scaling 1 2 --device cpu    # gloo ranks on this host's cores

Weak scaling, with scaling_bench's model, data and knobs: res8 in float32
(``find_model("res8")(find_config("res8"))``, TF32 off), 1,024 seeded
int16 clips, 10 s of noise, ``AugmentConfig(n_silence=8)``, and a global
batch of ``SCALING_BATCH`` per device times the size (128 on the card, 16
on the CPU). For each size n this process starts n ranks, one process
each (``parallel.launch_local_ranks``; size 1 runs here, with no process
group), and each rank times ``make_train_scan`` at ``SCALING_SCAN_SHORT``
and ``SCALING_SCAN_LONG`` steps (20 and 80 on the card, 5 and 20 on the
CPU). Each timing ends with a host read of the scan's mean loss, which
depends on every step of it, as scaling_bench's ``block_until_ready`` of
the last loss does. The step time is the median over 2 reps of the
marginal ``(t_long - t_short) / (L_long - L_short)``, after one untimed
run of each length (cuDNN's first calls, NCCL's communicator).

Prints rank 0's row for each size, one JSON line, with scaling_bench's
keys: ``n_devices``, ``global_batch``, ``step_ms``, ``audio_s_per_s``
and ``scaling_efficiency_vs_1`` (the first size's step time over this
one's). On the CPU (``--device cpu`` or ``SCALING_CPU=1``) the ranks
share the host's cores, so the rows add ``note`` and
``serialized_throughput_frac``, as scaling_bench's CPU rows do. On the
card a size larger than the visible cards prints
``{"n_devices": n, "skipped": "not enough devices"}``; nothing falls back
to fewer cards or to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

N_CLIPS = 1024
REPS = 2


def settings(device: torch.device) -> dict:
    """The knobs, from the environment, with scaling_bench's defaults for the card or the CPU."""
    cpu = device.type == "cpu"
    return {
        "per_device_batch": int(os.environ.get("SCALING_BATCH", "16" if cpu else "128")),
        "scan_short": int(os.environ.get("SCALING_SCAN_SHORT", "5" if cpu else "20")),
        "scan_long": int(os.environ.get("SCALING_SCAN_LONG", "20" if cpu else "80")),
    }


def inputs() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """scaling_bench's clips, labels and noise, drawn in its order from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    audio = rng.integers(-3000, 3000, (N_CLIPS, 16000), dtype=np.int16)
    labels = rng.integers(2, 12, (N_CLIPS,), dtype=np.int32)
    noise = (rng.standard_normal(16000 * 10) * 0.05).astype(np.float32)
    return audio, labels, noise


def time_rank(n: int, device: torch.device) -> dict:
    """In every rank of a world of ``n``: this rank's marginal step seconds, the collectives of one
    step (``(op, elements)``), each kernel's launches and the steps it ran."""
    from .. import use_full_f32
    from ..data import AugmentConfig, prepare_train_arrays
    from ..models import find_config, find_model, init_weights
    from ..ops import assemble_kernel, mfcc_kernel, res_kernel
    from ..parallel import make_data_mesh, rank_device
    from ..train import create_train_state, make_optimizer, make_train_scan

    knobs = settings(device)
    dev = rank_device(device)
    use_full_f32()
    mesh = make_data_mesh(n, "data")
    model = init_weights(find_model("res8")(find_config("res8")), torch.Generator().manual_seed(0))
    mesh.replicate(model.to(dev))
    tx = make_optimizer()
    state = create_train_state(model, tx)
    aug = AugmentConfig(n_silence=8)
    arrays = prepare_train_arrays(*inputs(), aug, device=dev)
    batch = knobs["per_device_batch"] * n
    short, long = knobs["scan_short"], knobs["scan_long"]
    scans = {length: make_train_scan(tx, batch, aug, length, mesh) for length in (short, long)}
    counters = (assemble_kernel, mfcc_kernel, res_kernel)
    before = [k.launches for k in counters]

    def timed(length: int, key: int) -> float:
        t0 = time.perf_counter()
        _, m = scans[length](state, key, arrays)
        float(m["loss"])  # waits for every step of the scan
        return time.perf_counter() - t0

    mesh.collectives = []
    timed(short, 0)
    step_collectives = mesh.collectives[: len(mesh.collectives) // short]
    mesh.collectives = None
    timed(long, 0)
    marginal = []
    for r in range(REPS):
        t_short = timed(short, r + 1)
        t_long = timed(long, r + 1)
        marginal.append((t_long - t_short) / (long - short))
    launches = dict(zip(("assemble", "mfcc", "res_stack"), (k.launches - b for k, b in zip(counters, before))))
    return {"rank": mesh.rank, "step_s": statistics.median(marginal), "marginal_s": marginal,
            "collectives": step_collectives, "launches": launches, "steps": (1 + REPS) * (short + long),
            "global_batch": batch, "card": str(dev)}


def run_size(n: int, device: torch.device) -> list[dict]:
    """Every rank's ``time_rank`` record for a world of ``n``: here for 1, else n local ranks."""
    from ..parallel import launch_local_ranks

    if n == 1:
        return [time_rank(1, device)]
    with tempfile.TemporaryDirectory() as tmp:
        rc = launch_local_ranks("honk_tpu_torch.cli.scaling", [str(n), "--device", device.type, "--out", tmp], n)
        if rc:
            raise RuntimeError(f"cli.scaling: a rank of a world of {n} exited {rc}")
        records = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                records.append(json.load(f))
    return records


def run(sizes: list[int], device: torch.device) -> list[tuple[dict, list[dict] | None]]:
    """Each size's row and its ranks' records (None for a skipped size)."""
    out, base = [], None
    for n in sizes:
        if device.type == "cuda" and n > torch.cuda.device_count():
            out.append(({"n_devices": n, "skipped": "not enough devices"}, None))
            continue
        records = run_size(n, device)
        step_s = records[0]["step_s"]
        if base is None:
            base = step_s
        batch = records[0]["global_batch"]
        row = {
            "n_devices": n,
            "global_batch": batch,
            "step_ms": round(step_s * 1e3, 3),
            "audio_s_per_s": round(batch / step_s, 1),
            "scaling_efficiency_vs_1": round(base / step_s, 4),
        }
        if device.type == "cpu":
            # Ranks share the host's cores: weak-scaling step time grows with n by
            # construction, so efficiency says nothing here; the mechanism runs.
            row["note"] = "gloo ranks on the host's shared cores: mechanism check only"
            row["serialized_throughput_frac"] = round(base * n / step_s, 4)
        out.append((row, records))
    return out


def _rank_main(args: argparse.Namespace, device: torch.device) -> int:
    from ..parallel import initialize_distributed, shutdown

    initialize_distributed(args.coordinator, args.num_processes, args.process_id, device)
    try:
        record = time_rank(args.num_processes, device)
    finally:
        shutdown()
    with open(os.path.join(args.out, f"rank{args.process_id}.json"), "w") as f:
        json.dump(record, f)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.cli.scaling", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("sizes", type=int, nargs="*", default=[1, 2, 4, 8], help="world sizes, one rank per device")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu; SCALING_CPU=1 is --device cpu")
    # one rank of a world, as launch_local_ranks starts it
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> int:
    from .. import resolve_device

    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    default = "cpu" if os.environ.get("SCALING_CPU", "0") == "1" else "cuda"
    device = resolve_device(args.device or default)
    if args.coordinator is not None:
        return _rank_main(args, device)
    for row, _ in run(args.sizes, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
