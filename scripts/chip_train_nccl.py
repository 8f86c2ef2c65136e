#!/usr/bin/env python3
"""res8 data-parallel training on NCCL ranks, rank r on card r, on the cards of one host.

    python scripts/chip_train_nccl.py [--worlds 2 4]
        [--sections steps f32 bf16 dryrun scaling gap dead bf16steps repeat]
        [--recipe_seeds 0] [--gap_seeds 0 1 2 3 4] [--gap_budget_s 240] [--device cpu]

Needs as many cards as the largest world, and exits 1 with fewer
(``--device cpu`` rehearses the script on gloo ranks, where no kernel
launch is counted). Builds the three kernels once, then runs each section.
Runs that can go at once go at once on disjoint cards
(``CUDA_VISIBLE_DEVICES``): no two process groups share a card. A check
that does not hold is recorded and the next section runs. Prints the
cards' name and power limit, then one JSON line of the readings, and exits
0 only if every check held.

1. ``steps``: DP_STEPS float32 train steps of res8 at full width (B=64, lr
   0.01) from the same weights and draws on 1 rank and on each world,
   each group joined by ``initialize_distributed``. Held to the gate of
   ``tests/test_parallel.py::test_dp_matches_single_device``: the first
   loss within rtol 1e-5 and every weight within 5e-4 of one rank's. Every
   rank's state must be bitwise rank 0's.
2. ``f32``: res8 at full width on chip_smoke.py phase 10's synthetic corpus
   (written under hash seed 0) at its recipe (B=64, 2 epochs, a dev sweep
   each epoch) in float32, through cli.train's join flags
   (``--coordinator``, ``--num-processes``, ``--process-id``) on 1 rank and
   on each world. Every rank runs cuDNN's deterministic algorithms, since
   its float32 defaults do not repeat bit for bit from run to run on the
   card.
   - Each rank's launches are exact, and rank r runs on card r. The
     assembly runs once a step, the MFCC once a step and once an eval
     batch, and the res stack's float32 mode once an eval batch.
   - Every world's weights lie within ``torch_resume.TOPOLOGY_GAP_FULL_F32``
     of the one-rank run's: twice the JAX package's own largest gap between
     1 and 2 or 4 devices on this recipe.
   - One epoch on the first world resumed on the last, and the reverse, lie
     within the same gap.
   - One epoch on the first world resumed on it is bitwise its 2-epoch run.
3. ``bf16``, zoo_hard_v2's recipe: hard_v2 regenerated as
   ``scripts/chip_recipe.py`` does, res8 and res15 trained through ``python
   -m honk_tpu_torch.cli.train --n_devices <largest world>`` from each of
   ``--recipe_seeds``, then scored by ``cli.zoo``'s ``compare_zoo`` against
   zoo_hard_v2. The gate is chip_smoke.py phase 34's: each float32 recheck
   inside the JAX package's seeds 0-2 widened by 2 SE, and res15 over res8
   at McNemar z > 0.
4. ``dryrun``: ``honk_tpu_torch.parallel.dryrun`` through its join flags on
   each world. Rank 0 reports the six paths ok, and every rank launches
   what ``dryrun_multichip(1)`` launches in this process.
5. ``scaling``: ``cli.scaling``'s ``run`` for 1 and each world. Reads the
   rows, each world's collectives a step and their bytes beside the JAX
   step's (SCALING.md §1), and the host's cores. Every rank's launches are
   exact (assembly and MFCC once a step, no res stack). A skipped row
   fails; efficiency is a reading.
6. ``gap``, ROADMAP §3.2 on the cards: ``tests/torch_resume.py``'s recipe
   through the CLI, float32 and bf16, on the corpus of each hash seed. It
   runs 4 epochs on 1, 2 and each world's ranks, and 2 epochs on 1 and 2
   ranks resumed on 2 and 1. Each pair's ``max_gap`` is printed beside the
   JAX package's CPU reading (``torch_resume.JAX_BF16_GAP``; in float32
   JAX's largest is half of ``TOPOLOGY_GAP_F32``). This section is read,
   not gated. A seed starts only while the section is inside
   ``--gap_budget_s``.
7. ``dead``: ``cli.train --n_devices 2`` (bf16, phase 10's corpus). Once
   rank 0 has logged its first epoch, rank 1 is killed (SIGKILL): as it
   runs, and, in the other ``DEAD_RUNS`` runs, while it waits for rank 0 in
   a collective (rank 0 stopped for ``STOP_S``, continued a second after
   the kill). Each time the launcher must return non-zero within
   ``HEARTBEAT_TIMEOUT_S + EXIT_WAIT_S`` of ``parallel.runtime``, with no
   rank process left. Prints what the victim's ``/proc`` held
   ``PROC_READ_S`` after the kill while it was still there (its state,
   pending signals, ``wchan``, ``stack``, each thread's state) and
   ``nvidia-smi``'s compute processes.

8. ``bf16steps``, ROADMAP §3.2 step by step on the cards:
   ``tests/test_torch_bf16_ranks.py``'s comparison (res8-narrow, B=16, lr
   0.01, STEPS_N steps from seed-0 weights on cli.scaling's clips) with the
   port's own draws, in bf16 and float32, on 1 rank twice and on 2 NCCL
   ranks, with cuDNN's default algorithms and with its deterministic ones,
   and the same on 1 and 2 gloo ranks on the host's CPU. After each step:
   the 1-vs-2-rank distance over the parameters and over BN's running
   statistics (Frobenius), each as a share of the 2-rank bf16-to-float32
   distance (the test's unit), the largest absolute difference (the gap
   section's measure), and the 1-vs-1 distance of two processes (the
   card's run-to-run noise). Read, not gated, but for the ranks of a world
   being bitwise equal.
9. ``repeat``, ROADMAP §3.5: two float32 ``cli.train`` runs of res8 and of
   res15 from seed 0 at zoo_hard_v2's recipe (its corpus, 26 epochs, B=64,
   the lr ladder, the float32 dtype), each in a process of its own, with
   ``torch.backends.cudnn.deterministic`` set and without, at once on four
   cards. Reads whether each pair's weights are bitwise equal, their test
   accuracies, and the mean training rate of each run (the metrics'
   ``audio_s_per_s`` over the epochs after the first). Read, not gated.

Imports nothing of JAX. Its default worlds need four cards of one host.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke as C  # noqa: E402

SECTIONS = ("steps", "f32", "bf16", "dryrun", "scaling", "gap", "dead", "bf16steps", "repeat")
# A killed rank stops beating at once; the launcher sees it silent after
# parallel.runtime.HEARTBEAT_TIMEOUT_S, kills the others and waits up to
# EXIT_WAIT_S for them to be gone.
PROC_READ_S = (2.0, 20.0)  # when the victim's /proc is read, seconds after the kill
STOP_S = 3.0  # how long rank 0 is stopped before rank 1 is killed in a collective
DEAD_RUNS = 2  # runs of each way to kill (the hang of PR 12 came in some runs, not in others)
RUN_TIMEOUT_S = 180  # a rank group or CLI run of this script's small recipes
RECIPE_TIMEOUT_S = 900  # a zoo_hard_v2 recipe run
# tests/test_parallel.py::test_dp_matches_single_device's gate on 2 steps (lr
# 0.01), held here at res8's full width: the first loss, then every weight.
DP_STEPS, DP_LOSS_RTOL, DP_PARAM_ATOL = 2, 1e-5, 5e-4
DRYRUN_PATHS = ("exact train step ok", "subrow train step ok", "sharded eval ok, acc=", "sharded streaming ok",
                "masked session slab ok", "sharded slab weight refresh ok")
# The JAX package's data-parallel res8 step (SCALING.md §1, from its HLO): one
# fused gradient all-reduce of 441,244 B and 12 BN-statistic all-reduces of 360 B.
JAX_STEP_COLLECTIVES = {"all_reduces": 13, "bytes": 441_244 + 12 * 360}
# Every tensor the port's train step reduces across ranks is float32 (the
# gradients, BN's sums, the metrics): 4 bytes per element a collective records.
REDUCED_BYTES = 4
# The bf16steps section: tests/test_torch_bf16_ranks.py's config, batch and steps.
STEPS_CONF, STEPS_BATCH, STEPS_N = "res8-narrow", 16, 3
REPEAT_MODELS = ("res8", "res15")


def launches(counters) -> dict:
    return {**{k: m.launches for k, m in counters.items()},
            "res_stack_by_mode": dict(counters["res_stack"].launches_by_mode)}


def cards_env(env: dict, cards: list[int] | None) -> dict:
    """``env`` with only ``cards`` visible (None: all)."""
    return env if cards is None else dict(env, CUDA_VISIBLE_DEVICES=",".join(map(str, cards)))


def in_waves(jobs: list[tuple[str, int, object]], n_cards: int, device: str) -> dict:
    """Run ``jobs`` (name, cards it needs, fn(cards)) in waves, at once within a wave on disjoint
    cards (largest first, first fit); each job's result by name. On the CPU no card is assigned."""
    waves: list[list] = []
    for job in sorted(jobs, key=lambda j: -j[1]):
        for wave in waves:
            used = sum(j[1] for j, _ in wave)
            if used + job[1] <= n_cards:
                wave.append((job, list(range(used, used + job[1]))))
                break
        else:
            waves.append([(job, list(range(job[1])))])
    results = {}
    for wave in waves:
        with concurrent.futures.ThreadPoolExecutor(len(wave)) as ex:
            futures = {name: ex.submit(fn, cards if device == "cuda" else None) for (name, _, fn), cards in wave}
            results.update({name: f.result() for name, f in futures.items()})
    return results


def dp_steps(world: int, device: str) -> dict:
    """DP_STEPS train steps of res8 at full width (B=64, lr 0.01, float32) from seed-0 weights on
    cli.scaling's clips, in a world of ``world``: the losses and this rank's final state on the CPU."""
    import torch
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.cli.scaling import inputs
    from honk_tpu_torch.data import AugmentConfig, prepare_train_arrays
    from honk_tpu_torch.models import find_config, find_model, init_weights
    from honk_tpu_torch.parallel import make_data_mesh, rank_device
    from honk_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    dev = rank_device(device)
    use_full_f32()
    mesh = make_data_mesh(world, "data")
    model = init_weights(find_model("res8")(find_config("res8")), torch.Generator().manual_seed(0))
    mesh.replicate(model.to(dev))
    tx = make_optimizer(lrs=(0.01,), boundaries=())
    state = create_train_state(model, tx)
    aug = AugmentConfig(n_silence=8)
    arrays = prepare_train_arrays(*inputs(), aug, device=dev)
    step = make_train_step(tx, C.TRAIN_BATCH, aug, mesh)
    losses = [float(step(state, 7, arrays)[1]["loss"]) for _ in range(DP_STEPS)]
    return {"losses": losses, "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def dtype_steps(world: int, device: str) -> dict:
    """STEPS_N train steps of STEPS_CONF at B=STEPS_BATCH (lr 0.01) from seed-0 weights on cli.scaling's
    clips, in bf16 and in float32, in a world of ``world``: this rank's state on the CPU after each step."""
    import torch
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.cli.scaling import inputs
    from honk_tpu_torch.data import AugmentConfig, prepare_train_arrays
    from honk_tpu_torch.models import find_config, find_model, init_weights
    from honk_tpu_torch.parallel import make_data_mesh, rank_device
    from honk_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    dev = rank_device(device)
    use_full_f32()
    mesh = make_data_mesh(world, "data")
    aug = AugmentConfig(n_silence=4)
    arrays = prepare_train_arrays(*inputs(), aug, device=dev)
    out = {}
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", None)):
        model = init_weights(find_model(STEPS_CONF)(find_config(STEPS_CONF), dtype=dtype),
                             torch.Generator().manual_seed(0))
        mesh.replicate(model.to(dev))
        tx = make_optimizer(lrs=(0.01,), boundaries=())
        state = create_train_state(model, tx)
        step = make_train_step(tx, STEPS_BATCH, aug, mesh)
        out[name] = []
        for _ in range(STEPS_N):
            state, _ = step(state, 7, arrays)
            out[name].append({k: v.detach().to("cpu", torch.float32, copy=True) for k, v in model.state_dict().items()
                              if v.is_floating_point()})
    return out


def rank_main(rank: int, spec_path: str) -> int:
    """One rank: the spec's entry point with its join flags (``steps``: dp_steps in a group it joins);
    writes its launches and card."""
    import torch

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cudnn.deterministic = spec["deterministic"]
    from honk_tpu_torch.ops import assemble_kernel, mfcc_kernel, res_kernel
    from honk_tpu_torch.parallel import initialize_distributed, shutdown

    join = ["--device", spec["device"], "--coordinator", spec["coordinator"], "--num-processes", str(spec["world"]),
            "--process-id", str(rank)]
    if spec["module"] in ("steps", "bf16steps"):
        run = dp_steps if spec["module"] == "steps" else dtype_steps
        initialize_distributed(spec["coordinator"], spec["world"], rank, spec["device"])
        try:
            torch.save(run(spec["world"], spec["device"]), os.path.join(spec["out"], f"rank{rank}.pt"))
        finally:
            shutdown()
        rc = 0
    elif spec["module"] == "train":
        from honk_tpu_torch.cli.train import main

        rc = main(spec["argv"] + join)
    else:
        from honk_tpu_torch.parallel.dryrun import main

        rc = main(spec["argv"] + join)
    record = {"rc": rc, "card": torch.cuda.current_device() if spec["device"] == "cuda" else None,
              "launches": launches({"assemble": assemble_kernel, "mfcc": mfcc_kernel, "res_stack": res_kernel})}
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    return rc


def run_ranks(module: str, argv: list[str], world: int, device: str, tmp: str, name: str,
              deterministic: bool = False, cards: list[int] | None = None) -> dict:
    """``world`` rank processes of ``module`` (``steps``, ``train`` or ``dryrun``) on ``cards``; kills
    them all when one fails or at RUN_TIMEOUT_S. Each rank's record (None if it left none) and log,
    the exit codes and the seconds."""
    out = os.path.join(tmp, f"ranks-{name}")
    os.makedirs(out)
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"module": module, "argv": argv, "world": world, "coordinator": f"127.0.0.1:{C.free_port()}",
                   "out": out, "device": device, "deterministic": deterministic}, f)
    env = cards_env(dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"), cards)
    logs = [os.path.join(out, f"rank{r}.log") for r in range(world)]
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                           "--spec", spec_path], env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.perf_counter() - t0 > RUN_TIMEOUT_S:
                break
            time.sleep(0.2)
    finally:
        for p in procs:  # exact PIDs only
            if p.poll() is None:
                p.kill()
            p.wait()
    records = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.json")
        records.append(json.load(open(path)) if os.path.exists(path) else None)
    return {"records": records, "logs": [open(p).read() for p in logs], "rcs": [p.returncode for p in procs],
            "s": time.perf_counter() - t0, "cards": cards}


def run_cmd(cmd: list[str], env: dict, cards: list[int] | None, timeout: float = RUN_TIMEOUT_S) -> dict:
    """``cmd`` in a session of its own on ``cards``; at ``timeout`` the session's processes are killed."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=cards_env(env, cards), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and the ranks it started
        log = proc.communicate()[0] + f"\n[killed at {timeout} s]"
    return {"rc": proc.returncode, "log": log, "s": time.perf_counter() - t0}


class Checks:
    """Every check's failure, kept so that every section runs."""

    def __init__(self):
        self.failed: list[str] = []

    def require(self, ok: bool, msg: str) -> bool:
        if not ok:
            self.failed.append(msg)
            print(f"[check failed] {msg}", flush=True)
        return ok


def card(device: str, rank: int) -> int | None:
    """The card rank ``rank`` must run on (rank r on the r-th visible card), None on the CPU."""
    return rank if device == "cuda" else None


def section_steps(checks: Checks, worlds: list[int], n_cards: int, device: str, tmp: str) -> dict:
    """1. DP_STEPS steps at full width on 1 rank and on each world: JAX's DP gate, ranks bitwise."""
    import torch

    sizes = [1, *worlds]
    res = in_waves([(w, w, lambda cards, w=w: run_ranks("steps", [], w, device, tmp, f"steps{w}", True, cards))
                    for w in sizes], n_cards, device)
    out = {"s": {w: r["s"] for w, r in res.items()}}
    if not checks.require(all(r["rcs"] == [0] * w for w, r in res.items()), f"steps: ranks exited "
                          f"{ {w: r['rcs'] for w, r in res.items()} }\n" + "\n".join(
                              log[-2000:] for r in res.values() for log in r["logs"])):
        return out
    got = {w: [torch.load(os.path.join(tmp, f"ranks-steps{w}", f"rank{r}.pt")) for r in range(w)] for w in sizes}
    one = got[1][0]
    out[1] = {"losses": one["losses"]}
    for w in worlds:
        ranks = got[w]
        same = all(torch.equal(rk["state"][k], ranks[0]["state"][k]) for rk in ranks for k in one["state"])
        floats = [k for k, v in one["state"].items() if v.is_floating_point()]
        err = max(float((ranks[0]["state"][k] - one["state"][k]).abs().max()) for k in floats)
        loss_rel = abs(ranks[0]["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        out[w] = {"losses": ranks[0]["losses"], "weights_max_abs_err": err, "first_loss_rel_err": loss_rel,
                  "ranks_bitwise": same}
        checks.require(same and loss_rel <= DP_LOSS_RTOL and err <= DP_PARAM_ATOL,
                       f"steps: {DP_STEPS} steps on {w} ranks against 1: {out[w]}")
    print(f"[steps] res8 float32 B={C.TRAIN_BATCH}, {DP_STEPS} steps: " + json.dumps(out), flush=True)
    return out


def section_f32(checks: Checks, corpus: str, worlds: list[int], n_cards: int, device: str, tmp: str) -> dict:
    """2. float32 res8 at full width through the CLI on 1 rank and on each world, resumes across and on
    the same world."""
    import torch
    import torch_resume as R
    from honk_tpu_torch.data import load_speech_commands

    ds = load_speech_commands(corpus)
    n_train = len(ds.train)
    per_epoch = math.ceil((n_train + int(0.1 * n_train)) / C.TRAIN_BATCH)
    dev_b, test_b = math.ceil(len(ds.dev) / 256), math.ceil(len(ds.test) / 256)

    def expect(epochs: int) -> dict:
        steps, evals = epochs * per_epoch, epochs * dev_b + test_b
        if device == "cpu":  # the plain versions run on the CPU; nothing counts
            steps = evals = 0
        return {"assemble": steps, "mfcc": steps + evals, "res_stack": evals,
                "res_stack_by_mode": {"float32": evals, "bfloat16": 0, "bfloat16_activations": 0}}

    first, last = worlds[0], worlds[-1]
    dirs = {}

    def job(name: str, world: int, epochs: int, resume_from: str | None = None):
        dirs[name] = os.path.join(tmp, f"f32-{name}")

        def fn(cards):
            if resume_from is not None:
                shutil.copytree(dirs[resume_from], dirs[name])
            argv = ["--type", "train", "--model", "res8", "--batch_size", str(C.TRAIN_BATCH), "--n_epochs",
                    str(epochs), "--dev_every", "1", "--data_dir", corpus, "--output_dir", dirs[name],
                    "--compute_dtype", "float32"]
            return world, epochs if resume_from is None else 1, run_ranks(
                "train", argv, world, device, tmp, f"f32-{name}", True, cards)

        return name, world, fn

    runs = {}
    first_runs = {**{f"whole{w}": (w, 2) for w in [1, *worlds]}, **{f"half{w}": (w, 1) for w in (first, last)}}
    resumes = {f"{a}to{b}": (b, 2, f"half{a}") for a, b in ((first, last), (last, first), (first, first))}
    for wave in (first_runs, resumes):
        jobs = [job(name, *a) for name, a in wave.items()]
        for name, (world, epochs_run, res) in in_waves(jobs, n_cards, device).items():
            runs[name] = res
            if not checks.require(res["rcs"] == [0] * world and None not in res["records"],
                                  f"f32 {name}: ranks exited {res['rcs']}\n" + "\n".join(
                                      log[-2000:] for log in res["logs"])):
                continue
            want = expect(epochs_run)
            for r, rec in enumerate(res["records"]):
                checks.require(rec["launches"] == want and rec["card"] == card(device, r),
                               f"f32 {name} rank {r} on card {rec['card']} launched {rec['launches']}, "
                               f"expected {want} on card {card(device, r)}")
            checks.require(res["logs"][0].count("final test accuracy:") == 1 and not any(
                "final test accuracy:" in log for log in res["logs"][1:]),
                f"f32 {name}: 'final test accuracy:' on rank 0 alone")
    out = {"steps_per_epoch": per_epoch, "eval_batches": {"dev": dev_b, "test": test_b},
           "s": {n: r["s"] for n, r in runs.items()}, "cards": {n: r["cards"] for n, r in runs.items()},
           "launches_rank0": {n: r["records"][0]["launches"] for n, r in runs.items() if r["records"][0]},
           "limit": R.TOPOLOGY_GAP_FULL_F32, "gaps": {}}
    try:
        states = {n: R.latest(d) for n, d in dirs.items()}
    except (FileNotFoundError, ValueError) as e:
        checks.require(False, f"f32: a run left no step checkpoint: {e}")
        return out
    w = {n: R.port_weights(s) for n, s in states.items()}
    for name in [f"whole{x}" for x in worlds] + [f"{first}to{last}", f"{last}to{first}"]:
        gap = R.max_gap(w[name], w["whole1"])
        out["gaps"][f"{name}_vs_whole1"] = gap
        checks.require(gap <= R.TOPOLOGY_GAP_FULL_F32, f"f32 {name} is {gap:.3e} from one rank, past "
                                                       f"TOPOLOGY_GAP_FULL_F32 {R.TOPOLOGY_GAP_FULL_F32:.3e}")
        checks.require(int(states[name]["step"]) == int(states["whole1"]["step"]),
                       f"f32 {name} ended at step {states[name]['step']}, one rank at {states['whole1']['step']}")
    a, b = R.flat_tensors(states[f"{first}to{first}"]), R.flat_tensors(states[f"whole{first}"])
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    out["gaps"][f"{first}to{first}_bitwise_whole{first}"] = same
    checks.require(same, f"f32: 1 epoch on {first} ranks resumed on {first} is not bitwise the 2-epoch run")
    print(f"[f32] res8 float32 B={C.TRAIN_BATCH}, 2 epochs ({per_epoch} steps each): " + json.dumps(out), flush=True)
    return out


def section_bf16(checks: Checks, world: int, device: str, tmp: str, seeds: list[int]) -> dict:
    """3. res8 and res15 at zoo_hard_v2's recipe on ``world`` ranks through --n_devices from each of
    ``seeds``, scored as cli.zoo."""
    root = os.path.join(tmp, "hard_v2")
    corpus_s = C.hard_v2_corpus(root) if not os.path.isdir(root) else 0.0
    return {seed: recipe_on_ranks(checks, world, device, tmp, root, seed, corpus_s) for seed in seeds}


def recipe_on_ranks(checks: Checks, world: int, device: str, tmp: str, root: str, seed: int,
                    corpus_s: float) -> dict:
    """res8 and res15 at zoo_hard_v2's recipe from ``seed`` on ``world`` ranks, scored as cli.zoo."""
    from honk_tpu_torch.cli.zoo import compare_zoo

    out = {"corpus_s": corpus_s, "world": world, "seed": seed, "models": {}}
    recipe = C.hard_v2_manifest()["models"]["res8"]["recipe"]
    split = ["--dev_pct", str(recipe["dev_pct"]), "--test_pct", str(recipe["test_pct"])]
    flags = ["--n_epochs", str(recipe["n_epochs"]), "--batch_size", str(recipe["batch_size"]), "--seed", str(seed),
             "--compute_dtype", recipe["compute_dtype"], "--lr", *map(str, recipe["lr"]), "--schedule",
             *map(str, recipe["schedule"]), "--data_dir", root, *split]
    zoo = os.path.join(tmp, f"zoo-bf16-seed{seed}")
    os.makedirs(zoo)
    for name in C.RECIPE_MODELS:
        run_dir = os.path.join(tmp, f"bf16-{name}-seed{seed}")
        metrics = os.path.join(tmp, f"bf16-{name}-seed{seed}.jsonl")
        res = run_cmd([sys.executable, "-m", "honk_tpu_torch.cli.train", "--type", "train", "--model", name,
                       "--n_devices", str(world), "--device", device, "--output_dir", run_dir,
                       "--metrics_jsonl", metrics, *flags], dict(os.environ, PYTHONPATH=ROOT), None,
                      RECIPE_TIMEOUT_S)
        if not checks.require(res["rc"] == 0 and os.path.isfile(os.path.join(run_dir, "best.pt")),
                              f"bf16 {name} seed {seed} on {world} ranks exited {res['rc']}:\n"
                              f"{res['log'][-3000:]}"):
            return out
        with open(metrics) as f:
            epochs = [json.loads(line) for line in f if '"train_epoch"' in line]
        out["models"][name] = {"wall_s": res["s"], "test_acc": C.final_accuracy(res["log"]),
                               "audio_s_per_s_per_card": [e["audio_s_per_s"] for e in epochs]}
        shutil.copy(os.path.join(run_dir, "best.pt"), os.path.join(zoo, f"{name}.pt"))
    with open(os.path.join(zoo, "MANIFEST.json"), "w") as f:
        json.dump({"models": {n: {"pt": f"{n}.pt"} for n in C.RECIPE_MODELS}}, f)
    manifest = compare_zoo(zoo, root, recipe["dev_pct"], recipe["test_pct"], 256, C.HARD_V2, device)
    ranges = C.recipe_ranges()
    for name, m in out["models"].items():
        e = manifest["models"][name]
        m.update(test_acc_recheck=e["test_acc_recheck"], jax_range=ranges[name],
                 against=manifest["against_stats"]["pairwise"][name])
        m["in_range"] = ranges[name][0] <= e["test_acc_recheck"] <= ranges[name][1]
        checks.require(m["in_range"], f"bf16 {name} seed {seed} on {world} ranks: recheck "
                                      f"{e['test_acc_recheck']} outside {ranges[name]}")
    z = -manifest["ladder_stats"]["pairwise"]["_vs_".join(C.RECIPE_MODELS)]["mcnemar_z"]
    out["z_res15_over_res8"] = z
    checks.require(z > 0, f"bf16 seed {seed} on {world} ranks: res15 over res8 McNemar z {z}, not > 0")
    print(f"[bf16] zoo_hard_v2's recipe from seed {seed} on {world} ranks: " + json.dumps(out), flush=True)
    return out


def section_dryrun(checks: Checks, counters, worlds: list[int], device: str, tmp: str) -> dict:
    """4. dryrun_multichip on each world; every rank launches what dryrun_multichip(1) launches."""
    from honk_tpu_torch.parallel.dryrun import dryrun_multichip

    C.reset(counters)
    dryrun_multichip(1, device)
    want = launches(counters)
    out = {"world1_launches": want}
    for world in worlds:
        res = run_ranks("dryrun", ["--n", str(world)], world, device, tmp, f"dryrun{world}")
        if checks.require(res["rcs"] == [0] * world, f"dryrun_multichip({world}) exited {res['rcs']}:\n"
                          + "\n".join(log[-2000:] for log in res["logs"])):
            for what in DRYRUN_PATHS:
                checks.require(res["logs"][0].count(f"dryrun_multichip({world}): {what}") == 1,
                               f"dryrun_multichip({world}): rank 0 did not report '{what}'")
            for r, rec in enumerate(res["records"]):
                checks.require(rec["launches"] == want and rec["card"] == card(device, r),
                               f"dryrun_multichip({world}) rank {r} on card {rec['card']} launched {rec['launches']}, "
                               f"expected {want}")
        out[world] = {"s": res["s"], "rcs": res["rcs"],
                      "launches": [rec and rec["launches"] for rec in res["records"]]}
    print("[dryrun] " + json.dumps(out), flush=True)
    return out


def section_scaling(checks: Checks, worlds: list[int], device: str) -> dict:
    """5. cli.scaling at 1 and each world: rows, collectives and bytes a step, launches per rank."""
    import torch
    from honk_tpu_torch.cli import scaling

    dev = torch.device(device)
    out = {"host_cores": os.cpu_count(), "knobs": scaling.settings(dev), "jax_step": JAX_STEP_COLLECTIVES,
           "rows": [], "worlds": {}}
    for row, records in scaling.run([1, *worlds], dev):
        out["rows"].append(row)
        if not checks.require(records is not None, f"scaling: {row}"):
            continue
        coll = records[0]["collectives"]
        out["worlds"][row["n_devices"]] = {
            "collectives_per_step": len(coll), "bytes_per_step": REDUCED_BYTES * sum(n for _, n in coll),
            "largest_bytes": REDUCED_BYTES * max((n for _, n in coll), default=0),
            "rank_step_ms": [r["step_s"] * 1e3 for r in records], "rank_marginal_s": [r["marginal_s"] for r in records],
            "cards": [r["card"] for r in records]}
        for r, rec in enumerate(records):
            want = {"assemble": rec["steps"], "mfcc": rec["steps"], "res_stack": 0}
            if device == "cpu":  # the plain versions run on the CPU; nothing counts
                want = {"assemble": 0, "mfcc": 0, "res_stack": 0}
            checks.require(rec["launches"] == want and rec["card"] == (f"cuda:{r}" if device == "cuda" else "cpu"),
                           f"scaling {row['n_devices']} rank {r} on {rec['card']} launched {rec['launches']}, "
                           f"expected {want}")
    for row in out["rows"]:
        print(json.dumps(row), flush=True)
    print(f"[scaling] host cores {out['host_cores']}: " + json.dumps(out), flush=True)
    return out


def section_gap(checks: Checks, seeds: list[str], budget_s: float, worlds: list[int], n_cards: int, device: str,
                tmp: str) -> dict:
    """6. ROADMAP §3.2: the resume recipe on 1, 2 and each world's ranks, float32 and bf16, per corpus."""
    import torch_resume as R
    from torch_ranks import TIMEOUT, rank_env

    out = {"jax_bf16_1_vs_2": R.JAX_BF16_GAP, "jax_f32_largest": R.TOPOLOGY_GAP_F32 / 2, "seeds": {}}
    t0 = time.perf_counter()
    whole = sorted({1, 2, *worlds})
    first = {**{f"whole{w}": (R.EPOCHS, w) for w in whole}, "half1": (R.EPOCHS // 2, 1), "half2": (R.EPOCHS // 2, 2)}
    dtypes = ("float32", "bfloat16")
    for seed in seeds:
        if time.perf_counter() - t0 > budget_s:
            break
        t_seed = time.perf_counter()
        data = os.path.join(tmp, f"gap{seed}", "sc")
        R.write_corpus(data, seed, rank_env(), TIMEOUT)
        dirs = {(d, n): os.path.join(tmp, f"gap{seed}", f"{d}-{n}") for d in dtypes for n in [*first, "1to2", "2to1"]}

        def job(d, n, epochs, ranks, save_every=None):
            cmd = R.port_cli(data, d, dirs[d, n], epochs, ranks, save_every, device=device)
            return (d, n), ranks, lambda cards: run_cmd(cmd, rank_env(), cards)

        res = in_waves([job(d, n, e, k, 1 if n.startswith("half") else None) for d in dtypes
                        for n, (e, k) in first.items()], n_cards, device)
        for d in dtypes:
            for n in ("1to2", "2to1"):
                shutil.copytree(dirs[d, f"half{n[0]}"], dirs[d, n])
        res.update(in_waves([job(d, n, R.EPOCHS, int(n[-1])) for d in dtypes for n in ("1to2", "2to1")],
                            n_cards, device))
        failed = {k: r for k, r in res.items() if r["rc"] != 0}
        if not checks.require(not failed, f"gap, hash seed {seed}: runs failed: " + "\n".join(
                f"{k}: {r['rc']}\n{r['log'][-2000:]}" for k, r in failed.items())):
            break
        row = {"s": time.perf_counter() - t_seed}
        for d in dtypes:
            w = {n: R.port_weights(R.latest(dirs[d, n])) for n in [*(f"whole{x}" for x in whole), "1to2", "2to1"]}
            row[d] = {**{f"{a}_vs_{b}": R.max_gap(w[f"whole{a}"], w[f"whole{b}"])
                         for a in (1, 2) for b in whole if b > a},
                      "1to2_vs_2to1": R.max_gap(w["1to2"], w["2to1"])}
        row["bfloat16"]["jax_1_vs_2"] = R.JAX_BF16_GAP.get(seed)
        out["seeds"][seed] = row
        print(f"[gap] hash seed {seed}: " + json.dumps(row), flush=True)
    return out


def _distance(a: dict, b: dict, running: bool) -> float:
    """Frobenius distance of two states over the parameters (``running``: over BN's running statistics)."""
    keys = [k for k in a if ("running" in k) == running]
    return math.sqrt(sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in keys))


def _largest(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def section_bf16steps(checks: Checks, n_cards: int, device: str, tmp: str) -> dict:
    """8. ROADMAP §3.2 step by step: 1 rank (twice) and 2 ranks, bf16 and float32, on the cards with
    cuDNN's default and deterministic algorithms, and on gloo ranks of the host's CPU."""
    import torch

    runs = {"default": False, "deterministic": True}
    tags = (("one", 1), ("one_again", 1), ("two", 2))
    res = in_waves([(f"{name}-{tag}", world,
                     lambda cards, world=world, det=det, n=f"{name}-{tag}":
                     run_ranks("bf16steps", [], world, device, tmp, f"bf16steps-{n}", det, cards))
                    for name, det in runs.items() for tag, world in tags], n_cards, device)
    if device == "cuda":  # and on the host's CPU, one group at a time
        runs["cpu"] = False
        for tag, world in tags:
            res[f"cpu-{tag}"] = run_ranks("bf16steps", [], world, "cpu", tmp, f"bf16steps-cpu-{tag}")
    out = {"conf": STEPS_CONF, "batch": STEPS_BATCH, "s": {n: r["s"] for n, r in res.items()}}
    failed = {n: r for n, r in res.items() if r["rcs"] != [0] * len(r["rcs"])}
    if not checks.require(not failed, "bf16steps: ranks exited " + "\n".join(
            f"{n}: {r['rcs']}\n" + "\n".join(log[-2000:] for log in r["logs"]) for n, r in failed.items())):
        return out
    for name, det in runs.items():
        got = {tag: [torch.load(os.path.join(tmp, f"ranks-bf16steps-{name}-{tag}", f"rank{r}.pt"))
                     for r in range(world)] for tag, world in tags}
        a, b = got["two"]
        checks.require(all(torch.equal(a[d][s][k], b[d][s][k]) for d in a for s in range(STEPS_N) for k in a[d][s]),
                       f"bf16steps {name}: the two ranks' states differ")
        one, again, two = got["one"][0], got["one_again"][0], a
        rows = []
        for s in range(STEPS_N):
            row = {"step": s + 1}
            for running, part in ((False, "params"), (True, "running")):
                unit = _distance(two["bfloat16"][s], two["float32"][s], running)
                gap = _distance(one["bfloat16"][s], two["bfloat16"][s], running)
                row[part] = {"bf16_1_vs_2": gap, "bf16_1_vs_2_share": gap / unit,
                             "f32_1_vs_2": _distance(one["float32"][s], two["float32"][s], running),
                             "bf16_1_vs_1": _distance(one["bfloat16"][s], again["bfloat16"][s], running),
                             "f32_1_vs_1": _distance(one["float32"][s], again["float32"][s], running),
                             "bf16_vs_f32": unit}
            row["largest_abs"] = {"bf16_1_vs_2": _largest(one["bfloat16"][s], two["bfloat16"][s]),
                                  "bf16_1_vs_1": _largest(one["bfloat16"][s], again["bfloat16"][s]),
                                  "f32_1_vs_2": _largest(one["float32"][s], two["float32"][s])}
            rows.append(row)
        out[name] = rows
        print(f"[bf16steps] {name} (cudnn.deterministic {det}): " + json.dumps(rows), flush=True)
    return out


def section_repeat(checks: Checks, n_cards: int, device: str, tmp: str) -> dict:
    """9. ROADMAP §3.5: two float32 cli.train runs of each REPEAT_MODELS from seed 0 at zoo_hard_v2's
    recipe, with cuDNN's deterministic algorithms and without, each run in a process of its own."""
    import torch

    root = os.path.join(tmp, "hard_v2")
    if not os.path.isdir(root):
        C.hard_v2_corpus(root)
    recipe = C.hard_v2_manifest()["models"]["res8"]["recipe"]
    flags = ["--n_epochs", str(recipe["n_epochs"]), "--batch_size", str(recipe["batch_size"]), "--seed", "0",
             "--compute_dtype", "float32", "--lr", *map(str, recipe["lr"]), "--schedule",
             *map(str, recipe["schedule"]), "--data_dir", root, "--dev_pct", str(recipe["dev_pct"]),
             "--test_pct", str(recipe["test_pct"]), "--device", device]
    out = {}
    for name in REPEAT_MODELS:
        jobs = []
        for det, run in ((True, "a"), (False, "a"), (False, "b"), (True, "b")):  # in turns where they run in waves
            tag = f"{name}-{'det' if det else 'default'}-{run}"
            code = ("import sys, torch\n"
                    f"torch.backends.cudnn.deterministic = {det}\n"
                    "from honk_tpu_torch.cli.train import main\n"
                    "sys.exit(main(sys.argv[1:]))\n")
            cmd = [sys.executable, "-c", code, "--type", "train", "--model", name, *flags,
                   "--output_dir", os.path.join(tmp, f"repeat-{tag}"),
                   "--metrics_jsonl", os.path.join(tmp, f"repeat-{tag}.jsonl")]
            jobs.append((tag, 1, lambda cards, cmd=cmd: run_cmd(cmd, dict(os.environ, PYTHONPATH=ROOT), cards,
                                                               RECIPE_TIMEOUT_S)))
        res = in_waves(jobs, n_cards, device)
        failed = {t: r for t, r in res.items() if r["rc"] != 0}
        if not checks.require(not failed, "repeat: runs failed " + "\n".join(
                f"{t}: {r['rc']}\n{r['log'][-2000:]}" for t, r in failed.items())):
            return out
        for det in ("det", "default"):
            tags = [f"{name}-{det}-{run}" for run in ("a", "b")]
            weights = [torch.load(os.path.join(tmp, f"repeat-{t}", "best.pt"), weights_only=True) for t in tags]
            rates = []
            for t in tags:
                with open(os.path.join(tmp, f"repeat-{t}.jsonl")) as f:
                    epochs = [json.loads(line) for line in f if '"train_epoch"' in line]
                rates.append(sum(e["audio_s_per_s"] for e in epochs[1:]) / max(len(epochs) - 1, 1))
            out[f"{name}_{det}"] = {
                "bitwise": all(torch.equal(weights[0][k], weights[1][k]) for k in weights[0]),
                "largest_abs": max(float((weights[0][k].double() - weights[1][k].double()).abs().max())
                                   for k in weights[0] if weights[0][k].is_floating_point()),
                "test_acc": [C.final_accuracy(res[t]["log"]) for t in tags],
                "audio_s_per_s": rates, "wall_s": [res[t]["s"] for t in tags]}
        print(f"[repeat] {name} float32 at zoo_hard_v2's recipe, seed 0: "
              + json.dumps({k: v for k, v in out.items() if k.startswith(name + "_")}), flush=True)
    return out


def victim_proc(pid: int) -> dict:
    """What ``/proc/<pid>`` says of a process: its status lines, wchan, kernel stack and each thread's state."""

    def read(path: str) -> str | None:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError as e:
            return f"unreadable: {e.strerror}"

    status = read(f"/proc/{pid}/status") or ""
    out = {k: v.strip() for k, _, v in (line.partition(":") for line in status.splitlines())
           if k in ("State", "Threads", "SigPnd", "ShdPnd", "SigBlk", "SigIgn")}
    out["wchan"] = read(f"/proc/{pid}/wchan")
    out["stack"] = read(f"/proc/{pid}/stack")
    threads = {}
    try:
        for tid in sorted(os.listdir(f"/proc/{pid}/task")):
            stat = read(f"/proc/{pid}/task/{tid}/stat") or ""
            fields = stat.rsplit(")", 1)[-1].split()
            threads[tid] = {"name": stat[stat.find("(") + 1:stat.rfind(")")], "state": fields[0] if fields else None,
                            "wchan": read(f"/proc/{pid}/task/{tid}/wchan")}
    except OSError as e:
        threads = {"error": e.strerror}
    out["threads"] = threads
    return out


def dead_run(checks: Checks, corpus: str, device: str, tmp: str, name: str, in_collective: bool) -> dict:
    """One 2-rank cli.train whose rank 1 is SIGKILLed once rank 0 has logged its first epoch; with
    ``in_collective``, while rank 0 is stopped (SIGSTOP for STOP_S, rank 1 then waits for it in a
    collective), rank 0 continued a second after the kill."""
    from torch_ranks import child_pids
    from honk_tpu_torch.parallel.runtime import EXIT_WAIT_S, HEARTBEAT_TIMEOUT_S

    limit_s = HEARTBEAT_TIMEOUT_S + EXIT_WAIT_S
    cmd = [sys.executable, "-m", "honk_tpu_torch.cli.train", "--type", "train", "--model", "res8", "--batch_size",
           str(C.TRAIN_BATCH), "--n_epochs", "20", "--dev_every", "1", "--data_dir", corpus, "--output_dir",
           os.path.join(tmp, f"dead_{name}"), "--n_devices", "2", "--device", device]
    proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(RUN_TIMEOUT_S + limit_s, proc.kill)
    watchdog.start()
    log, ranks, took, gone, victim, reads = [], {}, None, {}, [], {}
    try:
        for line in proc.stdout:
            log.append(line)
            if line.startswith("[train_epoch]"):
                break
        ranks = child_pids(proc.pid)
        victim = [pid for pid, c in ranks.items() if c.endswith("--process-id 1")]
        peer = [pid for pid in ranks if pid not in victim]
        if checks.require(len(ranks) == 2 and len(victim) == 1, f"dead {name}: the launcher's ranks {ranks}"):
            if in_collective:
                os.kill(peer[0], signal.SIGSTOP)
                time.sleep(STOP_S)
            t0 = time.perf_counter()

            def sample():  # when each rank's process left, and the victim's /proc at PROC_READ_S
                due = list(PROC_READ_S)
                while proc.poll() is None and len(gone) < len(ranks):
                    now = time.perf_counter() - t0
                    for pid in ranks:
                        if pid not in gone and not os.path.exists(f"/proc/{pid}"):
                            gone[pid] = now
                    if due and now >= due[0] and victim[0] not in gone:
                        reads[f"{due.pop(0)}s"] = victim_proc(victim[0])
                        if device == "cuda":
                            reads["nvidia_smi_apps"] = subprocess.run(
                                ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv"],
                                capture_output=True, text=True, timeout=30).stdout.strip()
                    time.sleep(0.05)

            sampler = threading.Thread(target=sample, daemon=True)
            os.kill(victim[0], signal.SIGKILL)
            sampler.start()
            if in_collective:
                time.sleep(1.0)
                with contextlib.suppress(ProcessLookupError):  # the launcher may have killed it already
                    os.kill(peer[0], signal.SIGCONT)
            try:
                log.append(proc.communicate(timeout=limit_s)[0])
                took = time.perf_counter() - t0
            except subprocess.TimeoutExpired:
                log.append(f"[the launcher had not returned {limit_s} s after the kill]")
            sampler.join(timeout=35)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            for pid in child_pids(proc.pid):
                os.kill(pid, signal.SIGKILL)
            proc.kill()
            proc.communicate()
    left = [pid for pid in ranks if os.path.exists(f"/proc/{pid}")]
    out = {"rc": proc.returncode, "s_to_exit": took, "ranks": list(ranks), "victim": victim,
           "rank_gone_s": {str(pid): gone.get(pid) for pid in ranks}, "left": left, "limit_s": limit_s,
           "heartbeat_timeout_s": HEARTBEAT_TIMEOUT_S, "ended_by_heartbeat": "has not beaten" in "".join(log),
           "victim_proc": reads}
    checks.require(proc.returncode != 0 and took is not None and took < limit_s and not left,
                   f"dead {name}: {out}\n{''.join(log)[-3000:]}")
    print(f"[dead] {name}: " + json.dumps(out), flush=True)
    return out


def section_dead(checks: Checks, corpus: str, device: str, tmp: str) -> dict:
    """7. 2-rank cli.train runs whose rank 1 is killed, each ending non-zero in time and leaving no rank."""
    return {f"{name}{i}": dead_run(checks, corpus, device, tmp, f"{name}{i}", name == "in_collective")
            for name in ("after_epoch", "in_collective") for i in range(DEAD_RUNS)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    p.add_argument("--sections", nargs="+", choices=SECTIONS, default=list(SECTIONS))
    p.add_argument("--recipe_seeds", type=int, nargs="+", default=[0], help="training seeds of the bf16 section")
    p.add_argument("--gap_seeds", nargs="+", default=["0", "1", "2", "3", "4"])
    p.add_argument("--gap_budget_s", type=float, default=240.0)
    p.add_argument("--device", default="cuda", help="cuda, or cpu to rehearse the script on gloo ranks")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.spec)
    import torch

    cuda = args.device == "cuda"
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cuda and n_cards < max(args.worlds):
        print(f"chip_train_nccl: needs {max(args.worlds)} cards, found {n_cards}", file=sys.stderr)
        return 1
    import torch_resume as R
    from torch_ranks import TIMEOUT, rank_env
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.ops import _build, assemble_kernel, mfcc_kernel, res_kernel

    use_full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip() if cuda else "cpu"
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {n_cards} cards, {os.cpu_count()} host cores",
          flush=True)
    t0 = time.perf_counter()
    if cuda:
        _build.build("mfcc", "res_stack", "assemble")
    counters = {"assemble": assemble_kernel, "mfcc": mfcc_kernel, "res_stack": res_kernel}
    slots = n_cards if cuda else max(args.worlds)  # cards a wave may hold
    checks = Checks()
    out = {"smi": smi, "cards": n_cards, "host_cores": os.cpu_count(), "build_s": time.perf_counter() - t0,
           "worlds": args.worlds, "s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        R.write_corpus(corpus, "0", rank_env(), TIMEOUT, R.FULL_CORPUS)  # chip_smoke.py phase 10's
        d, worlds = args.device, args.worlds
        runs = {"steps": lambda: section_steps(checks, worlds, slots, d, tmp),
                "f32": lambda: section_f32(checks, corpus, worlds, slots, d, tmp),
                "bf16": lambda: section_bf16(checks, max(worlds), d, tmp, args.recipe_seeds),
                "dryrun": lambda: section_dryrun(checks, counters, worlds, d, tmp),
                "scaling": lambda: section_scaling(checks, worlds, d),
                "gap": lambda: section_gap(checks, args.gap_seeds, args.gap_budget_s, worlds, slots, d, tmp),
                "dead": lambda: section_dead(checks, corpus, d, tmp),
                "bf16steps": lambda: section_bf16steps(checks, slots, d, tmp),
                "repeat": lambda: section_repeat(checks, slots, d, tmp)}
        for name in args.sections:
            t1 = time.perf_counter()
            try:
                out[name] = runs[name]()
            except Exception as e:  # noqa: BLE001 - record it and run the next section
                import traceback

                traceback.print_exc()
                checks.require(False, f"section {name} raised {type(e).__name__}: {e}")
            out["s"][name] = time.perf_counter() - t1
            print(f"[{name}] took {out['s'][name]:.1f} s", flush=True)
    out["failed"] = checks.failed
    print(json.dumps(out))
    return 1 if checks.failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
