"""Read the numbers that ``correct`` compares, for setting a cell's limits: the program's on each seed, and
each control's (the reference in a lower precision, or with a fault, in the program's place).

    python3 kwsbench/calibrate.py --workload res8.score.b256 --seeds 1 2 3 --variants program fp8

One JSON line a seed and variant on standard output. Runs no window: the
program does what the timed path does for the check (a training cell's
first three steps; one sweep; ``check_requests`` searches) at the cell's
sizes. A cell on more than one card starts one rank a card, as ``run.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["program"])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--rehearse", default=None)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    from kwsbench import harness

    cell = harness.find_cell(args.workload)
    if args.rehearse:
        shrink = json.loads(args.rehearse)
        cell.config.update(shrink.get("config", {}))
        cell.traffic.update(shrink.get("traffic", {}))
    # The program runs on the cell's cards; the controls alone, on one.
    ranks = cell.chips if "program" in args.variants else 1
    if args.device == "cuda":
        harness.check_cards(ranks)
    kind = cell.traffic["kind"]
    mesh = None
    if ranks > 1:
        if args.coordinator is None:
            from honk_tpu_torch.parallel import launch_local_ranks

            return launch_local_ranks("kwsbench.calibrate", argv, cell.chips)
        from honk_tpu_torch.parallel import initialize_distributed, make_data_mesh

        initialize_distributed(args.coordinator, args.num_processes, args.process_id, args.device)
        mesh = make_data_mesh(0)
    from honk_tpu_torch.parallel import barrier, rank_device, shutdown

    device = rank_device(args.device)
    for seed in args.seeds:
        for variant, checks in harness.driver(kind).readings(cell, seed, device, args.variants, mesh).items():
            print(json.dumps({"workload": cell.name, "seed": seed, "variant": variant,
                              "values": {n: v for n, v, _ in checks}}), flush=True)
    barrier()
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
