"""Training: the recipe's steps through the port's ``train.steps.make_train_scan``, on one card or on the ranks
of a data-parallel group.

Traffic keys: ``batch`` (the global batch), ``steps_per_call`` (the scan's
length, the training CLI's), ``n_clips`` (one-second int16 clips of the
corpus, made from the seed on the device), ``noise_seconds``,
``silence_prob`` (virtual silence slots, a share of the clips),
``clip_gain`` (a clip's gain is log-uniform in it), ``noise_gain``,
``trace_calls`` (calls in the traced slice).

Set-up makes the corpus and the weights from the seed, builds the model,
its optimizer state and the corpus arrays once, drives that state through
three steps of the scan (``make_train_scan`` at one step a call, the same
step and feed as the window's) and one call of the window's scan, times a
second call, and so fixes the window's number of calls (the ranks agree on
rank 0's). The window is that many calls, fenced by one synchronise.

The traffic names its ``recipe`` (``reference/recipe_<recipe>.py``): the
port's optimizer, how its first gradient is read back, and the
reference's steps.

``correct``: the reference follows the first three steps from the same
weights on the same draws in float32 (the recipe's ``steps`` with the
family's ``forward``). Of these numbers, those that the cell's limits name
are compared: the largest gap of the three losses and the first step's
alone; the first gradient as the optimizer got it (the recipe's
``first_gradient``, read from its state after one step) and the change of
the parameters after three steps, each by the worst leaf and by the median
leaf (``reference.compare``).
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from kwsbench import common, harness
from kwsbench.reference import assemble as ref_assemble, compare, frontend, precision

NEEDS = ("recipe",)  # keys a traffic of this kind names (harness.find_cell)
CHECK_STEPS = 3
CLIP_SAMPLES = 16000
CLIP_SECONDS = 1.0  # a one-second clip at 16 kHz


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""

    clips: np.ndarray  # (n, 16000) int16
    labels: np.ndarray  # (n,) int32 in 1..n_labels - 1
    noise: np.ndarray  # float32
    weights: dict  # float32 leaves on the device
    n_silence: int
    key: int


def make_inputs(seed: int, tr: dict, family, config: dict, device: torch.device) -> Inputs:
    """The corpus, made on the device in blocks and kept on the host (the port's loader packs a corpus there),
    the noise and the weights, all from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = tr["n_clips"]
    lo, hi = (float(np.log(v)) for v in tr["clip_gain"])
    clips = np.empty((n, CLIP_SAMPLES), np.int16)
    block = 4096
    for a in range(0, n, block):
        b = min(n, a + block)
        gain = torch.exp(torch.rand(b - a, generator=g, device=device) * (hi - lo) + lo)
        x = torch.randn((b - a, CLIP_SAMPLES), generator=g, device=device) * gain[:, None]
        clips[a:b] = (x.clamp(-1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
    labels = torch.randint(1, config["n_labels"], (n,), generator=g, device=device).cpu().numpy().astype(np.int32)
    noise = (torch.randn(int(tr["noise_seconds"] * CLIP_SAMPLES), generator=g, device=device)
             * tr["noise_gain"]).cpu().numpy()
    weights = common.make_weights(seed + 1, family, config, device)
    return Inputs(clips, labels, noise, weights, int(tr["silence_prob"] * n), seed)


@dataclasses.dataclass
class Program:
    """The port's objects: the train state (model and optimizer), the scans and the corpus arrays."""

    state: object
    scan: object
    check_scan: object
    arrays: object
    mesh: object
    key: int


def build(cell: harness.Cell, inputs: Inputs, device: torch.device, mesh) -> Program:
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.data import AugmentConfig, prepare_train_arrays
    from honk_tpu_torch.models import find_model
    from honk_tpu_torch.train import create_train_state, make_train_scan

    tr, config = cell.traffic, cell.config
    use_full_f32()
    augment = ref_assemble.Recipe()
    aug = AugmentConfig(noise_prob=augment.noise_prob, timeshift_samples=augment.timeshift_samples,
                        noise_scale=augment.noise_scale, n_silence=inputs.n_silence)
    arrays = prepare_train_arrays(inputs.clips, inputs.labels, inputs.noise, aug, noise_stride=augment.noise_stride,
                                  device=device)
    dtype = getattr(torch, config["compute_dtype"])
    model = find_model(config["registry_name"])(config, dtype=dtype).to(device)
    mesh.replicate(common.load_weights(model, inputs.weights))
    tx = cell.recipe.port_optimizer(harness.port)
    state = create_train_state(model, tx)
    return Program(state, make_train_scan(tx, tr["batch"], aug, tr["steps_per_call"], mesh),
                   make_train_scan(tx, tr["batch"], aug, 1, mesh), arrays, mesh, inputs.key)


def program_readings(prog: Program, recipe) -> dict:
    """Three steps through the scan at one step a call: each step's loss, the first gradient as the optimizer
    got it (``recipe.first_gradient``), the parameters after three steps."""
    model, opt = prog.state.model, prog.state.optimizer
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grads1 = [], None
    for k in range(CHECK_STEPS):
        prog.state, m = prog.check_scan(prog.state, prog.key, prog.arrays)
        losses.append(m["loss"])
        if k == 0:
            grads1 = {n: recipe.first_gradient(opt, p, params0[n]) for n, p in model.named_parameters()}
    return {"losses": [float(v) for v in losses], "grads1": grads1, "params0": params0,
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


def reference_readings(inputs: Inputs, cell: harness.Cell, device: torch.device, variant: str | None = None,
                       ranks: int = 1) -> dict:
    """The reference's three steps; ``variant`` puts a lower precision (``fp8``, ``int8``), bf16's own rounding
    (``bf16``, the witness of the program's precision), half of each batch (``half_batch``) or one rank's rows
    without the exchange (``no_exchange``) in the program's place."""
    tr, augment = cell.traffic, ref_assemble.Recipe()
    b = tr["batch"]
    batches = [ref_assemble.batch(inputs.clips, inputs.labels, inputs.noise,
                                  ref_assemble.draws(inputs.key, k, b, len(inputs.clips), inputs.n_silence,
                                                     len(inputs.noise), augment, device), augment, device)
               for k in range(CHECK_STEPS)]
    kw = {}
    if variant in ("fp8", "int8", "bf16"):
        kw["rounding"] = precision.rounding(variant)
    elif variant == "half_batch":
        kw["rows"] = slice(0, b // 2)
    elif variant == "no_exchange":
        kw["rows"], kw["divisor"] = slice(0, -(-b // ranks)), b
    elif variant is not None:
        raise SystemExit(f"kwsbench: no control {variant!r} for training")
    out = cell.recipe.steps(inputs.weights, cell.config, batches, frontend.mfcc, cell.family.forward, **kw)
    out["params0"] = inputs.weights
    return out


def leaf_readings(prog: dict, ref: dict) -> tuple[dict, dict]:
    """Each live leaf's gap of the first gradient and of the change after the steps (``compare.leaf_gaps``)."""
    leaves = compare.live_leaves(ref["grads1"])
    change = lambda r: {k: r["params"][k].float() - r["params0"][k].float() for k in leaves}  # noqa: E731
    return (compare.leaf_gaps(prog["grads1"], ref["grads1"], leaves),
            compare.leaf_gaps(change(prog), change(ref), leaves))


def compare_readings(prog: dict, ref: dict, limits: dict | None) -> list[tuple[str, float, float | None]]:
    """The compared numbers that ``limits`` names, each beside its limit; with ``limits`` None, every number
    (for the calibration)."""
    grads, changes = leaf_readings(prog, ref)
    numbers = {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
               "first_loss_gap": compare.loss_gap(prog["losses"][:1], ref["losses"][:1]),
               "grad_gap": max(grads.values()), "update_gap": max(changes.values()),
               "grad_median_gap": statistics.median(grads.values()),
               "update_median_gap": statistics.median(changes.values())}
    if limits is None:
        return [(n, v, None) for n, v in numbers.items()]
    return [(n, numbers[n], limits[n]) for n in limits]


def run(cell: harness.Cell, args, clock: common.Clock) -> None:
    import torch.distributed as dist
    from honk_tpu_torch.parallel import barrier, initialize_distributed, make_data_mesh, rank_device, shutdown
    from kwsbench import tracing

    tr = cell.traffic
    initialize_distributed(args.coordinator, args.num_processes, args.process_id, args.device)
    device = rank_device(args.device)
    mesh = make_data_mesh(0)
    primary = mesh.rank == 0
    clock.verbose = primary
    power = harness.power_limit() if device.type == "cuda" and primary else None
    if power:
        print(f"kwsbench: card and power limit: {power}", file=sys.stderr, flush=True)
    torch.zeros(1, device=device)
    stage = clock.stage("interpreter, torch and the card ready")
    inputs = make_inputs(args.seed, tr, cell.family, cell.config, device)
    stage = clock.stage("inputs made", stage)
    prog = build(cell, inputs, device, mesh)
    stage = clock.stage("program built", stage)
    readings = program_readings(prog, cell.recipe)
    sync = lambda: common.sync(device)  # noqa: E731
    sync()
    stage = clock.stage("three steps taken", stage)
    # Warm the window's call, then time one to fix the window's length (rank 0's, on every rank).
    prog.state, _ = prog.scan(prog.state, prog.key, prog.arrays)
    sync()
    t = time.perf_counter()
    prog.state, _ = prog.scan(prog.state, prog.key, prog.arrays)
    sync()
    calls = torch.tensor([max(1, round(args.seconds / (time.perf_counter() - t)))], device=device)
    if mesh.size > 1:
        dist.broadcast(calls, src=0)
    calls = int(calls)
    clock.stage("window's call warmed and timed", stage)

    setup_s = clock.since_start()
    t = time.perf_counter()
    for _ in range(calls):
        prog.state, m = prog.scan(prog.state, prog.key, prog.arrays)
    sync()
    window_s = time.perf_counter() - t
    loss_ok = bool(torch.isfinite(m["loss"]))
    steps = calls * tr["steps_per_call"]
    utterances = steps * tr["batch"]

    trace = None
    if args.trace:
        mesh.collectives = []
        with tracing.traced(sync) as out:
            for _ in range(tr["trace_calls"]):
                prog.state, _ = prog.scan(prog.state, prog.key, prog.arrays)
        trace = out[0]
        exchanged = sum(n * size for _, n, size in mesh.collectives)
        mesh.collectives = None
    # Read the peak on every card, then free the program before the reference runs.
    peak = torch.tensor([common.peak_bytes(device)], device=device, dtype=torch.float64)
    busy = torch.tensor([trace.busy_s(), trace.busy_s(skip="nccl")] if trace else [0.0, 0.0], device=device,
                        dtype=torch.float64)
    if mesh.size > 1:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        dist.all_reduce(busy)
    peak, (busy_s, work_s) = int(peak), (busy / mesh.size).tolist()
    del prog
    if primary:
        ref = reference_readings(inputs, cell, device, None, mesh.size)
        if args.control:  # the reference in a lower precision, or with a fault, in the program's place
            readings = reference_readings(inputs, cell, device, args.control, mesh.size)
        checks = common.finite(compare_readings(readings, ref, cell.limits))
        correct = loss_ok and all(v <= lim for _, v, lim in checks)
        result = {"correct": correct, "attempted": steps, "failed": 0 if loss_ok else steps}
        if args.trace:
            traced_steps = tr["trace_calls"] * tr["steps_per_call"]
            counters = {"model_flops": 3 * utterances * cell.family.model_flops(cell.config), "window_s": window_s,
                        "units": steps, "traced_units": traced_steps, "work_s": work_s,
                        "exchanged_bytes_per_step": exchanged / traced_steps if mesh.size > 1 else None}
            reading = common.Reading(trace, counters, cell.config, tr, common.device_name(device), mesh.size)
            result["metrics"] = common.per_layer(cell, reading)
            result["device"] = common.device_block(device, mesh.size, peak, busy_s, trace.window_s, power)
            result["breakdown"] = trace.breakdown()
        else:
            values = {"train_audio_s_per_s": utterances * CLIP_SECONDS / window_s, "setup_s": setup_s}
            result["metrics"] = common.end_to_end(cell, values)
            result["device"] = common.device_block(device, mesh.size, peak, power=power)
        harness.emit(result, checks)
    barrier()
    shutdown()


def readings(cell: harness.Cell, seed: int, device: torch.device, variants: list[str], mesh=None) -> dict:
    """The compared numbers of one seed without a window: the program's three steps (on every rank of
    ``mesh``), and each variant's in its place (on rank 0, for the calibration of the limits)."""
    from honk_tpu_torch.parallel import make_data_mesh

    mesh = mesh or make_data_mesh(0)
    inputs = make_inputs(seed, cell.traffic, cell.family, cell.config, device)
    prog = build(cell, inputs, device, mesh)
    got = program_readings(prog, cell.recipe)
    del prog
    if mesh.rank != 0:
        return {}
    ranks = cell.chips
    ref = reference_readings(inputs, cell, device, None, ranks)
    out = {}
    for v in variants:  # every number, then each leaf's gaps, to see which leaf sets the worst
        r = got if v == "program" else reference_readings(inputs, cell, device, v, ranks)
        out[v] = compare_readings(r, ref, None)
        grads, changes = leaf_readings(r, ref)
        out[f"{v} leaves"] = ([(f"grad {k}", g, None) for k, g in grads.items()]
                              + [(f"change {k}", g, None) for k, g in changes.items()])
    return out
