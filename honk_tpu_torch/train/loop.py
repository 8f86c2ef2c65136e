"""Host-side training and evaluation loops (counterpart of ``honk_tpu.train.loop``).

Equivalent of reference ``utils/train.py::train / evaluate`` with the JAX
package's structure: the packed corpus resident on the device, one train
step per batch (``steps.py``) in chunks of ``steps_per_call``, dev eval
every ``dev_every`` epochs keeping the best-dev model, periodic
checkpoints and resume from the latest, the final test accuracy printed
the way the reference prints it.

The batch of step ``s`` depends only on ``(cfg.train.seed + 1, s)``
(``data.augment.step_generator``), and the initial weights only on
``cfg.train.seed`` (drawn on the CPU, then moved), so a resumed run
repeats an unbroken one.

Data parallel: the mesh is ``cfg.mesh`` over the process group's ranks
(``parallel.make_data_mesh``), each rank on its own device
(``parallel.rank_device``). Every rank loads the corpus, starts from rank
0's weights (``replicate``) and runs the sharded steps and sweeps of
``steps.py``; rank 0 alone logs, prints and writes checkpoints, and every
rank restores from them. A checkpoint holds no trace of the world size,
so it resumes on any other.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Any

import numpy as np
import torch

from .. import resolve_device, use_full_f32
from ..ckpt import Checkpointer, read_state_dict
from ..config import ExperimentConfig
from ..data import AugmentConfig, load_speech_commands, prepare_train_arrays
from ..data.dataset import PackedDataset, PackedSplit
from ..metrics import MetricsLogger, trace_to
from ..parallel import is_primary, make_data_mesh, rank_device
from ..models import find_config, find_model, init_weights, load_state_dict
from .state import create_train_state, make_adamw, make_optimizer
from .steps import make_eval_sweep, make_train_scan

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _load_dataset(cfg: ExperimentConfig) -> PackedDataset:
    return load_speech_commands(
        cfg.data.data_dir,
        wanted_words=tuple(cfg.data.wanted_words),
        unknown_prob=cfg.data.unknown_prob,
        silence_prob=cfg.data.silence_prob,
        dev_pct=cfg.data.dev_pct,
        test_pct=cfg.data.test_pct,
        seed=cfg.data.seed,
    )


def _split_on(split: PackedSplit, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.from_numpy(np.ascontiguousarray(split.audio)).to(device),
        torch.from_numpy(split.labels.astype(np.int64)).to(device),
    )


def evaluate_split(eval_sweep, model, split: PackedSplit, device: torch.device) -> float:
    """Deterministic accuracy of ``model`` over a packed split."""
    correct, total = eval_sweep(model, *_split_on(split, device))
    return int(correct) / max(int(total), 1)


def _snapshot(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train(
    cfg: ExperimentConfig,
    dataset: PackedDataset | None = None,
    logger: MetricsLogger | None = None,
    checkpoint_dir: str | None = None,
    save_every_epochs: int = 5,
    resume: bool = True,
    device: str | torch.device | None = None,
    profile_dir: str | None = None,
) -> dict[str, Any]:
    """Full training run. Returns {'state', 'best', 'best_dev_acc', 'test_acc', 'model', 'dataset'}.

    ``device`` defaults to cuda (and raises without one). Any model of the
    registry trains, with the SGD recipe of ``cfg.train`` (lr ladder,
    momentum, weight decay) or, for a model whose registry config names
    ``"recipe": "adamw"`` (kwt-3), KWT's AdamW recipe over the run's
    ``n_epochs`` (``make_adamw``: 10 warm-up epochs, cosine decay to 0,
    label smoothing 0.1), which the SGD flags do not change. ``compute_dtype`` is the model's compute dtype (flax's
    ``dtype``: the convs, a CNN's hidden dense layers and the activations
    between them, the res stack's kernel mode),
    in its training steps and in the dev and test sweeps alike, as the JAX
    loop builds one model for both; ``float32`` is the parity mode. TF32 is
    off either way (``use_full_f32``): what runs in float32 stays float32.
    ``cfg.train.input_file`` (a honk ``.pt`` or an Orbax checkpoint
    directory, ``ckpt.read_state_dict``) warm-starts the weights. With ``checkpoint_dir``: a step checkpoint
    every ``save_every_epochs`` epochs and at the end, and resume from the
    latest when ``resume``. With ``profile_dir``: ``torch.profiler``
    traces of the first dispatch and the first dev eval (``metrics.trace_to``).
    """
    device = rank_device(resolve_device(device))
    mesh = make_data_mesh(cfg.mesh.n_devices, cfg.mesh.data_axis)
    dtype = COMPUTE_DTYPES[cfg.train.compute_dtype]
    use_full_f32()
    logger = logger or MetricsLogger()
    if dataset is None:
        dataset = _load_dataset(cfg)

    model_cfg = find_config(cfg.train.model)
    model_cfg["n_labels"] = dataset.n_labels
    model = find_model(cfg.train.model)(model_cfg, dtype=dtype)
    init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
    if cfg.train.input_file:
        load_state_dict(model, read_state_dict(cfg.train.input_file))
    mesh.replicate(model.to(device))

    n_train = len(dataset.train)
    n_silence = int(cfg.data.silence_prob * n_train)
    batch_size = cfg.train.batch_size
    steps_per_epoch = max(1, math.ceil((n_train + n_silence) / batch_size))
    if model_cfg.get("recipe") == "adamw":
        tx = make_adamw(steps_per_epoch, cfg.train.n_epochs)
    else:
        tx = make_optimizer(
            lrs=tuple(cfg.train.lr),
            boundaries=tuple(cfg.train.schedule),
            momentum=cfg.train.momentum,
            weight_decay=cfg.train.weight_decay,
            nesterov=cfg.train.use_nesterov,
        )
    state = create_train_state(model, tx)

    aug = AugmentConfig(
        noise_prob=cfg.data.noise_prob,
        timeshift_samples=cfg.data.timeshift_samples,
        n_silence=n_silence,
    )
    arrays = prepare_train_arrays(dataset.train.audio, dataset.train.labels, dataset.noise, aug, device=device)
    eval_sweep = make_eval_sweep(cfg.train.eval_batch_size, mesh)

    # Chunks of steps_per_call steps, then the epoch's tail, as the JAX loop
    # cuts its compiled scans (here each is a Python loop of single steps).
    chunk = min(steps_per_epoch, max(1, cfg.train.steps_per_call))
    tail = steps_per_epoch % chunk
    scans = {n: make_train_scan(tx, batch_size, aug, n, mesh) for n in {chunk, tail} if n}
    calls = [chunk] * (steps_per_epoch // chunk) + ([tail] if tail else [])
    key = cfg.train.seed + 1

    dev_audio, dev_labels = _split_on(dataset.dev, device)
    test_audio, test_labels = _split_on(dataset.test, device)

    best_dev = -1.0
    best = _snapshot(model)
    start_epoch = 0

    def payload(epoch: int) -> dict[str, Any]:
        return {
            "state": {"step": state.step, "model": model.state_dict(), "optimizer": state.optimizer.state_dict()},
            "epoch": epoch,
            "best_dev": best_dev,
            "best": best,
            "key": key,
        }

    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir is not None else None
    if ckpt is not None and resume:
        restored = ckpt.restore_latest(payload(0))
        if restored is not None:
            _, saved = restored
            state.step = int(saved["state"]["step"])
            model.load_state_dict(saved["state"]["model"])
            state.optimizer.load_state_dict(saved["state"]["optimizer"])
            start_epoch = int(saved["epoch"]) + 1
            best_dev = float(saved["best_dev"])
            best = {k: v.to(device) for k, v in saved["best"].items()}
            key = int(saved["key"])
            logger.log("resume", epoch=start_epoch, step=state.step, best_dev=best_dev)

    def _save(epoch: int) -> None:
        # Rank 0 writes (a filesystem every rank shares); its weights are every rank's.
        if ckpt is not None and is_primary():
            ckpt.save_step(state.step, payload(epoch))

    # With profile_dir, the run's first dispatch and its first dev eval each
    # go under the profiler, the device synchronised before the trace closes.
    traced: set[str] = set()

    def _traced(name: str, fn, *args):
        if not profile_dir or name in traced:
            return fn(*args)
        traced.add(name)
        with trace_to(profile_dir, name):
            out = fn(*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return out

    last_epoch = start_epoch - 1
    for epoch in range(start_epoch, cfg.train.n_epochs):
        # Metrics accumulate on the device and are read once at epoch end.
        loss_sum = torch.zeros((), device=device)
        acc_sum = torch.zeros((), device=device)
        t0 = time.perf_counter()
        for n in calls:
            state, m = _traced("train_dispatch", scans[n], state, key, arrays)
            loss_sum += m["loss"] * n
            acc_sum += m["acc"] * n
        # Reading the sums waits for the device, so audio_s_per_s is pure
        # train throughput; the dev eval below is timed apart, as eval_s.
        loss_v, acc_v = float(loss_sum), float(acc_sum)
        dt = time.perf_counter() - t0
        do_dev = (epoch + 1) % cfg.train.dev_every == 0
        eval_s = 0.0
        if do_dev:
            t1 = time.perf_counter()
            correct, total = _traced("dev_eval", eval_sweep, model, dev_audio, dev_labels)
            c_v, t_v = int(correct), int(total)
            eval_s = time.perf_counter() - t1
            # f32 on both sides, as the JAX loop compares on the device.
            dev_acc = float(np.float32(c_v) / np.float32(max(t_v, 1)))
            if dev_acc > best_dev:
                best = _snapshot(model)
        audio_s = steps_per_epoch * batch_size  # 1 s utterances
        logger.log(
            "train_epoch",
            epoch=epoch,
            step=state.step,
            loss=loss_v / steps_per_epoch,
            acc=acc_v / steps_per_epoch,
            audio_s_per_s=round(audio_s / max(dt, 1e-9) / mesh.size, 1),
            **({"eval_s": round(eval_s, 4)} if do_dev else {}),
        )
        if do_dev:
            logger.log("dev_eval", epoch=epoch, dev_acc=dev_acc)
            best_dev = max(best_dev, dev_acc)
        if (epoch + 1) % save_every_epochs == 0:
            _save(epoch)
        last_epoch = epoch

    _save(last_epoch)
    best_model = copy.deepcopy(model)
    best_model.load_state_dict(best)
    correct, total = eval_sweep(best_model, test_audio, test_labels)
    test_acc = int(correct) / max(int(total), 1)
    # The reference prints exactly this phrase (utils/train.py::evaluate), on rank 0.
    logger.log("final", test_acc=test_acc)
    if is_primary():
        print(f"final test accuracy: {test_acc}")
    return {
        "state": state,
        "best": best,
        "best_dev_acc": best_dev,
        "test_acc": test_acc,
        "model": model,
        "dataset": dataset,
    }


def evaluate(
    cfg: ExperimentConfig,
    state_dict: dict[str, torch.Tensor],
    dataset: PackedDataset | None = None,
    device: str | torch.device | None = None,
) -> float:
    """Test-set accuracy of given weights (reference ``--type eval``), float32 with TF32 off
    whatever ``cfg.train.compute_dtype`` says (the JAX ``evaluate`` builds its model
    with no dtype), under ``cfg.mesh`` as ``train``."""
    device = rank_device(resolve_device(device))
    mesh = make_data_mesh(cfg.mesh.n_devices, cfg.mesh.data_axis)
    use_full_f32()
    if dataset is None:
        # The same sampling knobs as train(): the test set the run reported.
        dataset = _load_dataset(cfg)
    model_cfg = find_config(cfg.train.model)
    model_cfg["n_labels"] = dataset.n_labels
    model = load_state_dict(find_model(cfg.train.model)(model_cfg), state_dict).to(device)
    acc = evaluate_split(make_eval_sweep(cfg.train.eval_batch_size, mesh), model, dataset.test, device)
    if is_primary():
        print(f"final test accuracy: {acc}")
    return acc
