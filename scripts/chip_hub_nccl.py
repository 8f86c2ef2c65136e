#!/usr/bin/env python3
"""The stream hub sharded over NCCL ranks, one card each, against the unsharded hub.

    python scripts/chip_hub_nccl.py [--worlds 2 4]

Needs as many cards of one host as the largest world. The streams are
those of ``chip_smoke.py`` phase 32 (the 60 s planted track and seven of
noise, PCM16, eight sessions, the int16 wire): the unsharded hub on card 0
pushes them with ``push_rows`` and swaps in other weights (res8's, floats
x1.25) before tick ``HUB_SWAP_TICK``; then, for each world,
``scripts/chip_hub_ranks.py`` runs the same on NCCL ranks, rank r on card
r, rank 0 leading. Each world must be within ``RANKS_ATOL`` of the
unsharded hub with the same events, find the planted keywords before the
swap with no false alarm, and launch one mfcc and one float32 res stack a
tick on every rank. Then a world of 2 in which rank 1 exits after a tick:
rank 0's next push must raise naming rank 1 within the group's timeout
(20 s), and so must its ``shutdown()``.

Prints the card's name and power limit, then one JSON line of the readings
(host ms a tick on rank 0, seconds a world), and exits 0 if all held.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import chip_smoke as C  # noqa: E402

DEAD_TIMEOUT_S = 20


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--worlds", type=int, nargs="+", default=[2, 4])
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < max(args.worlds):
        C.fail(f"needs {max(args.worlds)} cards, found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from chip_hub_ranks import drive
    from honk_tpu_torch import use_full_f32
    from honk_tpu_torch.cli.demo import synthesize_long_audio
    from honk_tpu_torch.config import StreamConfig
    from honk_tpu_torch.serve import LabelService, StreamHub

    use_full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    track, positions = synthesize_long_audio(list(C.STREAM_KEYWORDS), seconds=60, seed=7, gap_s=8.0, noise_amp=0.01)
    pcm = C.hub_streams(track)
    n_ticks = pcm.shape[1] // C.CHUNK
    svc = LabelService("res8", C.CHECKPOINT, device="cuda:0")
    swap = {k: (v * 1.25 if v.is_floating_point() else v).cpu() for k, v in svc.model.state_dict().items()}
    inputs = {"checkpoint": C.CHECKPOINT, "pcm": pcm, "chunk": C.CHUNK, "n_slots": C.HUB_SLOTS,
              "cfg": C.STREAM_CFG, "swap_at": C.HUB_SWAP_TICK, "swap": swap}
    ref: dict = {}
    drive(StreamHub(svc, C.HUB_SLOTS, StreamConfig(**C.STREAM_CFG), C.CHUNK, coalesce_ms=0.0, wire_dtype="int16"),
          inputs, ref)
    fired = [[(e["time_s"], e["label"]) for a in ref["ticks"][:C.HUB_SWAP_TICK] for e in a[i]["events"]]
             for i in range(C.HUB_SLOTS)]
    if len(fired[0]) != len(positions) or any(lab != w or abs(ts - t) > 0.25
                                              for (ts, lab), (t, w) in zip(fired[0], positions)) or any(fired[1:]):
        C.fail(f"the unsharded hub before the swap fired {fired}, planted {positions} on session 0 alone")
    out: dict = {"smi": smi, "ticks": n_ticks,
                 "unsharded_host_ms_per_tick": C.ms_summary(ref["tick_ms"]), "worlds": {}}
    for world in args.worlds:
        ranks, seconds = C.hub_ranks(torch, world, inputs, "nccl")
        post_gap, prob_gap = C.check_hub_ranks(ranks, ref["ticks"], ref["closed"], n_ticks, "nccl")
        if [rk["card"] for rk in ranks] != list(range(world)):
            C.fail(f"NCCL world {world}: the ranks ran on cards {[rk['card'] for rk in ranks]}")
        out["worlds"][world] = {
            "s": seconds, "posterior_max_abs_err": post_gap, "prob_max_abs_err": prob_gap,
            "rows": [rk["rows"] for rk in ranks], "launches": [rk["launches"] for rk in ranks],
            "rank0_host_ms_per_tick": C.ms_summary(ranks[0]["tick_ms"]),
        }
    ranks, seconds = C.hub_ranks(torch, 2, {**inputs, "group_timeout_s": DEAD_TIMEOUT_S}, "nccl", "dead")
    dead = {k: ranks[0][k] for k in ("first_tick_ok", "push_error", "push_error_s", "shutdown_error")}
    if not dead["first_tick_ok"] or "rank 1 never took message" not in (dead["push_error"] or "") or not (
            DEAD_TIMEOUT_S - 1 < dead["push_error_s"] < 3 * DEAD_TIMEOUT_S) or "rank 1 never took message" not in (
            dead["shutdown_error"] or ""):
        C.fail(f"NCCL world 2 with a dead follower: {dead}")
    out["dead_follower"] = {**dead, "s": seconds}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
