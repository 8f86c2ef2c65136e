"""Profiling hooks on ``torch.profiler`` (counterpart of ``honk_tpu.metrics.profiling``).

    from honk_tpu_torch.metrics import annotate, trace_to
    with trace_to("/tmp/trace"):      # a Chrome / Perfetto trace per rank
        with annotate("train_step"):
            state, m = step(state, key, arrays)

CLI: ``python -m honk_tpu_torch.cli.train --profile-dir /tmp/trace ...``
traces the run's first dispatch (a chunk of ``steps_per_call`` train
steps: assembly and MFCC kernels, cuDNN) and its first dev eval sweep (the
MFCC and, for res8 / res26, the res-stack kernel), one file each.

The port's spans (each through ``annotate``, each name a constant, no
span nested in one of its own name): the train loop's ``train_step``,
``assemble``, ``forward_backward`` and ``update``; ``mfcc``
(``frontend.compute_mfccs``); ``conv_weight_grad`` (a bf16 conv's weight
gradient, ``models/layers.py``); ``bn_forward`` and ``bn_backward``
(``models/res.py``); the eval path's ``eval_batch`` (a sweep's batch),
``eval_gather`` (``data.augment.eval_batch``) and ``eval_forward`` (a res
model's eval forward); ``stream_file``'s ``stream_copy``,
``stream_forward`` and ``stream_detect``. With no profiler running a span
costs one check and no range.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..parallel import runtime


def trace_file(log_dir: str, name: str = "trace") -> str:
    """Where ``trace_to(log_dir, name)`` writes this rank's trace."""
    return os.path.join(log_dir, f"{name}.rank{runtime.rank()}.pt.trace.json")


@contextlib.contextmanager
def trace_to(log_dir: str | None, name: str = "trace"):
    """Trace the block with ``torch.profiler`` (the CPU, and the card where there is one)
    into ``trace_file(log_dir, name)``; a no-op when ``log_dir`` is falsy.

    The caller synchronises the device before the block ends, so the
    device's work lands in the trace.
    """
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_file(log_dir, name))


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named range in the trace: ``with annotate('train_step'): ...``.

    A ``record_function`` range while a profiler runs (in any thread, so
    autograd's backward too); otherwise a shared null context: under a
    microsecond a span on a CPU, where a range with no profiler to record
    it costs about 10 µs.
    """
    return record_function(name) if torch.autograd._profiler_enabled() else _OFF
