"""Run one cell of the benchmark once, on the machine it starts on.

    python3 kwsbench/run.py --workload res15.train.b64 --seed 7 --seconds 10 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number beside its limit
(also the last lines of standard error). Exits non-zero without a result
when CUDA or the cell's cards are missing, and when JAX or the JAX package
is loaded once the window has closed. A cell on more than one card starts
one rank a card through the port's launcher (``parallel/runtime.py``);
rank 0 prints the result.

Options for the tests and the calibration, which no check passes:
``--device cpu`` runs the plain paths at sizes ``--rehearse`` shrinks;
``--fault`` plants a fault under the timed path (``faults.py``);
``--control`` puts the reference, in a lower precision or with a fault, in
the program's place in the comparison.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)  # run as a script: import the harness as the package it is
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

T0_ENV = "KWSBENCH_T0"  # the launcher's start, for its ranks' set-up time


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--rehearse", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    p.add_argument("--control", default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-processes", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    from kwsbench import common, harness

    cell = harness.find_cell(args.workload)
    if args.rehearse:
        shrink = json.loads(args.rehearse)
        cell.config.update(shrink.get("config", {}))
        cell.traffic.update(shrink.get("traffic", {}))
    elif args.device != "cuda":
        harness.fail("--device cpu is for rehearsals at the sizes --rehearse gives")
    if args.device == "cuda":
        harness.check_cards(cell.chips)
    harness.cache_dirs()
    if cell.chips > 1 and args.coordinator is None:
        from honk_tpu_torch.parallel import launch_local_ranks

        os.environ[T0_ENV] = repr(T0)
        return launch_local_ranks("kwsbench.run", argv, cell.chips)
    if args.fault:
        from kwsbench import faults

        faults.plant(args.fault, cell)
    harness.driver(cell.traffic["kind"]).run(cell, args, common.Clock(float(os.environ.get(T0_ENV, T0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
