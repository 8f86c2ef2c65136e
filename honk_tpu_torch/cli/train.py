"""Training / eval CLI of the port, with the flags of ``honk_tpu.cli.train``:

    python -m honk_tpu_torch.cli.train --type train --model res8 \\
        --data_dir data/speech_dataset --n_epochs 26 \\
        --lr 0.1 0.01 0.001 --schedule 3000 6000 --output_dir ckpts/res8
    python -m honk_tpu_torch.cli.train --type eval --model res8 \\
        --data_dir data/speech_dataset --input_file ckpts/res8/best.pt

``--model`` is any of the 17 configs: res8, res15, res26 and their
-narrow forms, the ten cnn-* (cnn-trad-pool2's recorded recipe is
``--lr 0.003 0.0003 --schedule 440``), and kwt-3, the Keyword Transformer,
which the port alone has. kwt-3 trains with its own recipe, AdamW with
warm-up and cosine decay and label smoothing 0.1 (``train.make_adamw``),
which ``--lr``, ``--schedule``, ``--momentum``, ``--weight_decay`` and
``--use_nesterov`` (the SGD recipe's) do not change; the paper's run is
``--model kwt-3 --batch_size 512 --n_epochs 140``. Runs on ``--device cuda`` (the
default; it raises where no CUDA device is present) or ``--device cpu``.
``--compute_dtype bfloat16`` (the default) runs the model as flax's
``dtype=bfloat16`` does (bf16 convolutions, CNN hidden dense layers and
activations between them, res8 / res26's res-stack kernel in its
bf16-activation mode), in the training steps and in the dev and test sweeps of the run,
as the JAX package does; ``float32`` is the parity mode. ``--type eval`` is
float32 whatever the flag says. TF32 is off either way. A train run writes
``<output_dir>/best.pt`` (a honk state dict) and ``step_XXXXXXXX.pt``
resume checkpoints.

Data parallel, one process per device (NCCL on the card, gloo with
``--device cpu``): ``--coordinator host:port --num-processes N
--process-id i`` joins rank ``i`` of ``N``; ``--n_devices N`` without a
coordinator starts the N ranks here, over 127.0.0.1 (more ranks than
visible cards raises on cuda). Rank 0 alone prints the final accuracy
and writes the checkpoints. ``--profile-dir`` writes ``torch.profiler``
traces of the first dispatch and the first dev eval (``metrics.trace_to``).
``--input_file`` is a honk ``.pt`` or, as for the JAX CLI, an Orbax
checkpoint directory (a run's ``best/`` or the run directory holding it),
which the port reads itself (``ckpt.orbax``). A path that is neither is
refused before any work.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..config import DataConfig, ExperimentConfig, MeshConfig, TrainConfig
from ..parallel import launch_local_ranks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="honk_tpu_torch.train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--type", choices=["train", "eval"], default="train")
    d, t = DataConfig(), TrainConfig()
    p.add_argument("--data_dir", default=d.data_dir)
    p.add_argument("--wanted_words", nargs="+", default=list(d.wanted_words))
    p.add_argument("--unknown_prob", type=float, default=d.unknown_prob)
    p.add_argument("--silence_prob", type=float, default=d.silence_prob)
    p.add_argument("--noise_prob", type=float, default=d.noise_prob)
    p.add_argument("--timeshift_ms", type=float, default=d.timeshift_ms)
    p.add_argument("--dev_pct", type=float, default=d.dev_pct,
                   help="SHA1-bucket validation percentage (TF Speech Commands convention)")
    p.add_argument("--test_pct", type=float, default=d.test_pct,
                   help="SHA1-bucket test percentage")
    p.add_argument("--model", default=t.model)
    p.add_argument("--batch_size", type=int, default=t.batch_size)
    p.add_argument("--n_epochs", type=int, default=t.n_epochs)
    p.add_argument("--lr", type=float, nargs="+", default=list(t.lr))
    p.add_argument("--schedule", type=int, nargs="*", default=list(t.schedule))
    p.add_argument("--momentum", type=float, default=t.momentum)
    p.add_argument("--weight_decay", type=float, default=t.weight_decay)
    p.add_argument("--use_nesterov", action="store_true")
    p.add_argument("--dev_every", type=int, default=t.dev_every)
    p.add_argument("--seed", type=int, default=t.seed)
    p.add_argument("--eval_batch_size", type=int, default=t.eval_batch_size)
    p.add_argument(
        "--compute_dtype", choices=["bfloat16", "float32"], default=t.compute_dtype,
        help="compute dtype of the model, as flax's dtype (bf16 convs, hidden dense layers and the activations "
             "between them; float32 = strict parity mode)",
    )
    p.add_argument(
        "--steps_per_call", type=int, default=t.steps_per_call,
        help="train steps per chunk of the epoch loop (1 disables chunking)",
    )
    p.add_argument("--input_file", default="",
                   help="warm-start (train) or eval checkpoint: a honk .pt or an Orbax checkpoint directory")
    p.add_argument("--output_dir", default="ckpts/run", help="checkpoint directory")
    p.add_argument("--metrics_jsonl", default="", help="JSONL metrics sink path")
    p.add_argument(
        "--save_every_epochs", type=int, default=5,
        help="epochs between periodic step checkpoints (crash recovery)",
    )
    p.add_argument("--profile-dir", default="",
                   help="write torch.profiler traces of the first dispatch and the first dev eval here")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset into data_dir first (no-network dev)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # data parallel: one process per device
    p.add_argument("--coordinator", default=None, help="host:port of rank 0's process group")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--n_devices", type=int, default=0,
                   help="ranks of the data mesh (0: the whole world); without --coordinator, "
                        "starts that many local ranks")
    return p


def _refuse(p: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    from ..ckpt import is_orbax_path
    from ..ckpt.orbax import check

    ranks = (args.num_processes, args.process_id)
    if args.coordinator is None and ranks != (None, None):
        p.error("--process-id and --num-processes need --coordinator (or --n_devices alone for local ranks)")
    if args.coordinator is not None:
        if None in ranks:
            p.error("--coordinator needs --num-processes and --process-id")
        if not 0 <= args.process_id < args.num_processes:
            p.error(f"--process-id {args.process_id} is not a rank of --num-processes {args.num_processes}")
        if args.n_devices not in (0, args.num_processes):
            p.error(f"--n_devices {args.n_devices}: the mesh has one device per process, "
                    f"{args.num_processes} here")
    if args.input_file and is_orbax_path(args.input_file):
        try:
            check(args.input_file)
        except FileNotFoundError as e:
            p.error(f"--input_file: {e}")
    if args.type == "eval" and not args.input_file:
        p.error("--type eval needs --input_file (a honk .pt or an Orbax checkpoint directory)")


def args_to_config(args: argparse.Namespace) -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(
            data_dir=args.data_dir,
            wanted_words=tuple(args.wanted_words),
            unknown_prob=args.unknown_prob,
            silence_prob=args.silence_prob,
            noise_prob=args.noise_prob,
            timeshift_ms=args.timeshift_ms,
            dev_pct=args.dev_pct,
            test_pct=args.test_pct,
            seed=args.seed,
        ),
        train=TrainConfig(
            model=args.model,
            batch_size=args.batch_size,
            n_epochs=args.n_epochs,
            lr=tuple(args.lr),
            schedule=tuple(args.schedule),
            momentum=args.momentum,
            weight_decay=args.weight_decay,
            use_nesterov=args.use_nesterov,
            dev_every=args.dev_every,
            seed=args.seed,
            eval_batch_size=args.eval_batch_size,
            compute_dtype=args.compute_dtype,
            steps_per_call=args.steps_per_call,
            input_file=args.input_file if args.type == "train" else "",
            output_file=args.output_dir,
        ),
        mesh=MeshConfig(n_devices=args.n_devices),
    )


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    _refuse(p, args)

    from .. import resolve_device

    device = resolve_device(args.device)  # no CUDA device and no --device cpu: raise now
    if args.coordinator is None and args.n_devices > 1:
        if device.type == "cuda" and args.n_devices > torch.cuda.device_count():
            p.error(f"--n_devices {args.n_devices}: only {torch.cuda.device_count()} CUDA devices are visible")
        if args.synthetic and not os.path.isdir(os.path.join(args.data_dir, "yes")):
            from ..data import generate_dataset

            generate_dataset(args.data_dir)  # once, before the ranks read it
        return launch_local_ranks("honk_tpu_torch.cli.train", argv, args.n_devices)

    from ..parallel import barrier, initialize_distributed, is_primary, shutdown

    initialize_distributed(args.coordinator, args.num_processes, args.process_id, device)
    try:
        if args.synthetic:
            if is_primary() and not os.path.isdir(os.path.join(args.data_dir, "yes")):
                from ..data import generate_dataset

                generate_dataset(args.data_dir)
            barrier()  # the other ranks read it after rank 0 wrote it
        return _run(args, device)
    finally:
        shutdown()


def _run(args: argparse.Namespace, device) -> int:
    cfg = args_to_config(args)
    from ..metrics import MetricsLogger
    from ..parallel import is_primary

    logger = MetricsLogger(args.metrics_jsonl or None)
    try:
        if args.type == "train":
            from ..ckpt import Checkpointer
            from ..train import train

            result = train(cfg, logger=logger, checkpoint_dir=args.output_dir,
                           save_every_epochs=args.save_every_epochs, device=device,
                           profile_dir=args.profile_dir or None)
            if is_primary():
                Checkpointer(args.output_dir).save_best(result["best"])
            return 0

        from ..ckpt import read_state_dict
        from ..train import evaluate

        evaluate(cfg, read_state_dict(args.input_file), device=device)
        return 0
    finally:
        logger.close()


if __name__ == "__main__":
    raise SystemExit(main())
