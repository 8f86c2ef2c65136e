"""Train and eval steps on one device (counterpart of ``honk_tpu.train.steps``).

A train step is: draw the batch on the device from the step's generator,
assemble it (assembly kernel), MFCC (MFCC kernel), the training forward
(its dropout masks, for a CNN, drawn from the same generator after the
batch), the mean cross-entropy, backward (cuDNN through autograd), and the
SGD update. The only host-to-device traffic per step is the generator's
seed; the packed corpus stays on the device for the whole run. Eval sweeps
run the MFCC kernel and the model's eval forward (res8 / res26: the
res-stack kernel) on fixed-size batches, with the model's eval operands
(``model.eval_operands()``) prepared once per sweep. The eval forward
follows the model's dtype, so a training run's sweeps of its bf16 model
are bf16 in flax's dtype flow (res8 / res26: the kernel's
``bfloat16_activations`` mode), as the JAX package's. Every model trains
and evaluates through the same calls; a model without BN (cnn-*) has no
running statistics to update, as the JAX step's ``has_bn``.

PyTorch runs eagerly, so there is nothing to compile: a "scan" of N steps
is a Python loop (graph capture of it is open speed work, ROADMAP.md §2).
Steps update the state in place and also return it, in the JAX package's
``(state, metrics)`` shape; metrics stay on the device until read.

Data parallel (the JAX package's ``data_axis``, ``parallel/mesh.py``):
under a ``mesh`` of more than one rank, every rank draws the global batch
from the step's generator, then assembles, featurizes and runs forward and
backward on its own rows; BN's statistics are the global batch's; the loss
is the rank's cross-entropy *sum* over the global batch size (one formula
on every topology, one rank's included), so the one all-reduce of the
flattened gradients gives the global mean's gradient on every rank before
the same update; loss and accuracy are reduced too. Every sum over rows
that leaves a rank is float64: BN's, forward and backward
(``models/res.py``), and each parameter's gradient (``layers.wide_grads``),
all-reduced as one flat float64 vector and rounded once
(``layers.finish_grads``), as one rank rounds its whole batch's sums once.
On the CPU 1, 2 and 4 ranks take the same step bit for bit
(``tests/test_torch_topology_invariance.py``). An
eval sweep scores each rank's rows of every batch and all-reduces the two
counts once at the end. At one rank nothing is communicated and the step
is the single-device step.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..data.augment import AugmentConfig, TrainArrays, eval_batch, sample_train_batch, step_generator
from ..frontend.mfcc import compute_mfccs
from ..metrics import annotate
from ..models.layers import finish_grads, wide_grads
from ..parallel import DataMesh
from .state import SGD, TrainState


def _sharded(mesh: DataMesh | None) -> bool:
    return mesh is not None and mesh.size > 1


def make_train_step(tx: SGD, batch_size: int, aug_cfg: AugmentConfig, mesh: DataMesh | None = None):
    """Build the train step.

    ``step(state, key, arrays) -> (state, {"loss", "acc"})``: the batch of
    step ``state.step`` and then the model's dropout masks are drawn from
    ``step_generator(key, state.step)`` (JAX: ``fold_in(key, state.step)``),
    so they depend on the key and the step count alone.
    ``step.apply_batch(state, audio, labels, dropout)`` is the same step on
    a given batch and ``dropout`` (the keep masks, or a generator to draw
    them from; tests feed it the JAX package's batches and masks), and
    ``step.apply_features(state, feats, labels, dropout)`` the step after
    the MFCC: forward, loss, backward and update. Under a ``mesh`` the
    step takes this rank's rows (``mesh.shard_rows(batch_size)``) of the
    global batch, masks included, and its metrics are the global batch's.
    """
    sharded = _sharded(mesh)
    rows = mesh.shard_rows(batch_size) if mesh is not None else None

    def apply_features(state: TrainState, feats: torch.Tensor, labels: torch.Tensor, dropout=None):
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        with annotate("forward_backward"), wide_grads() as wide:
            logits = model(feats, dropout=dropout, mesh=mesh)
            # This rank's share of the global batch's mean (at one rank, the mean).
            loss = F.cross_entropy(logits, labels, reduction="sum") / batch_size
            loss.backward()
        with annotate("update"):
            finish_grads(model, wide, mesh)
            tx.apply(state)
        hits = logits.detach().argmax(dim=-1) == labels
        if not sharded:
            return state, {"loss": loss.detach(), "acc": hits.float().mean()}
        m = mesh.all_reduce_(torch.stack([loss.detach(), hits.sum().float()]))
        return state, {"loss": m[0], "acc": m[1] / batch_size}

    def apply_batch(state: TrainState, audio: torch.Tensor, labels: torch.Tensor, dropout=None):
        with torch.no_grad():
            feats = compute_mfccs(audio)
        return apply_features(state, feats, labels, dropout)

    def train_step(state: TrainState, key: int, arrays: TrainArrays):
        gen = step_generator(key, state.step, arrays.pool.device)
        with annotate("assemble"):
            audio, labels = sample_train_batch(gen, arrays, batch_size, aug_cfg, rows)
        dropout = gen
        if sharded and hasattr(state.model, "keep_masks"):
            # The global batch's masks, drawn after the batch as the forward
            # would draw them, then this rank's rows.
            dropout = [m[rows[0]:rows[1]] for m in state.model.keep_masks(batch_size, gen)]
        return apply_batch(state, audio, labels, dropout=dropout)

    train_step.apply_batch = apply_batch
    train_step.apply_features = apply_features
    return train_step


def make_train_scan(tx: SGD, batch_size: int, aug_cfg: AugmentConfig, n_steps: int,
                    mesh: DataMesh | None = None):
    """N single steps in a row: ``scan(state, key, arrays) -> (state, mean metrics)``.

    Same draws as calling the single step N times: each step derives its
    generator from ``state.step``, which advances inside the loop.
    """
    step = make_train_step(tx, batch_size, aug_cfg, mesh)

    def scan_fn(state: TrainState, key: int, arrays: TrainArrays):
        losses, accs = [], []
        for _ in range(n_steps):
            with annotate("train_step"):
                state, m = step(state, key, arrays)
            losses.append(m["loss"])
            accs.append(m["acc"])
        return state, {"loss": torch.stack(losses).mean(), "acc": torch.stack(accs).mean()}

    return scan_fn


def make_eval_sweep(batch_size: int, mesh: DataMesh | None = None) -> Callable:
    """Build the sweep over a whole packed split.

    ``sweep(model, audio_i16, labels) -> (correct, total)`` device scalars:
    ``ceil(n / B)`` fixed-size batches (``eval_batch``, the tail masked),
    each one MFCC kernel launch and one eval forward (res8 / res26: one
    res-stack kernel launch), counts accumulated on the device. The model
    is put in eval mode. Under a ``mesh`` each rank scores its rows of
    every batch and the counts are all-reduced once, exactly, at the end.
    """

    eval_step = make_eval_step()
    rows = mesh.shard_rows(batch_size) if mesh is not None else None

    @torch.no_grad()
    def sweep(model, audio_i16: torch.Tensor, labels: torch.Tensor):
        model.eval()
        packed = model.eval_operands()
        n = audio_i16.shape[0]
        counts = torch.zeros((2,), dtype=torch.int64, device=audio_i16.device)
        for start in range(0, n, batch_size):
            with annotate("eval_batch"):
                c, t = eval_step(model, *eval_batch(audio_i16, labels, start, batch_size, rows), packed=packed)
            counts[0] += c
            counts[1] += t
        if _sharded(mesh):
            mesh.all_reduce_(counts)
        return counts[0], counts[1]

    return sweep


def make_eval_step() -> Callable:
    """``eval_step(model, audio_f32, labels, valid, packed=None) -> (n_correct, n_valid)``
    device scalars; ``packed`` is ``model.eval_operands()``, computed if None."""

    @torch.no_grad()
    def eval_step(model, audio, labels, valid, packed=None):
        model.eval()
        logits = model(compute_mfccs(audio), packed=packed)
        correct = (logits.argmax(dim=-1) == labels) & valid
        return correct.sum(), valid.sum()

    return eval_step


def make_forward() -> Callable:
    """``forward(model, audio (B, 16000) f32) -> logits``: the eval forward on raw audio,
    in the model's dtype (a bf16 model: flax's bf16 dtype flow, as the JAX
    ``make_forward`` of a bf16 model; the frontend is the one float32 MFCC
    kernel, see ``compute_mfccs``)."""

    @torch.no_grad()
    def forward(model, audio):
        model.eval()
        return model(compute_mfccs(audio))

    return forward
