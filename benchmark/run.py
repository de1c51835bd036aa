"""Run one cell of the port's benchmark on this machine's cards.

    python3 benchmark/run.py --workload base-las.train-longform --seed 7 --seconds 20 --trace 0

Loads and builds the port (``attention_based_e2e_asr_dnn_tpu_torch``), makes
the weights and the traffic from ``--seed``, warms every batch shape of the
cell, measures for ``--seconds`` seconds, checks what the measured path
produced against the plain float32 reference (``benchmark/reference/``), and
prints one JSON line on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device`` and, traced, ``breakdown``; the compared
numbers with their limits come last, there and on standard error. Exits
non-zero without a result where no card (or too few) is visible, and where a
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), "
              f"{n} visible", file=sys.stderr)
        return 2
    with harness.stdout_to_stderr() as out_stream:
        run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
        outcome = harness.entry(cell).run(run)
        loaded = harness.forbidden_modules()
        if loaded:
            print(f"benchmark: forbidden modules loaded: {loaded}", file=sys.stderr)
            return 3
        harness.finish(run, outcome, out_stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
