"""Readings that set the limits of ``correct``: not part of a benchmark run.

    python3 benchmark/calibrate.py --workload base-las.train-longform --seeds 1 2 3 \
        --control-seeds 1 2 3 --fault-seeds 1 2 3 --out cal.jsonl

Any cell of BENCHMARK.json, through its entry (``harness.entry``) and its
configuration's family (``harness.family``). For each seed: the program's
compared numbers (its checked steps against the family's float32
reference). For each control seed: the same numbers with that reference, in
the nearest precision below the configuration's (the family's
``control_precision``; for ``las`` float8 e4m3 operands for bfloat16, TF32
for float32), standing in the program's place. For each fault seed: the
program with half of the batch left out. One JSON line a reading on
standard output and in ``--out``, with the leaf each number is worst at.
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, mixes, weights  # noqa: E402


def train_control(cell, seed, device):
    """The reference in the control's precision in the program's place on the
    checked steps."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import TrainDraws

    cfg, mix = cell.config, cell.mix
    model = cfg["model"]
    entry, fam = harness.entry(cell), harness.family(cell)
    flat = weights.make_flat(fam.leaf_specs(model), mixes.sub_seed(seed, 0), device)
    plans = mixes.plan_batches(mix, cfg)
    batches = mixes.make_batches(plans, seed, device, fam.feature_width(model))
    gen = torch.Generator(device=device).manual_seed(mixes.sub_seed(seed, 3))
    checked = mixes.step_order(len(plans), seed, 100000)[:mix["checked_steps"]]
    rates = fam.dropout_rates(model)
    steps = [(batches[i], entry.draw_step(model, rates, len(plans[i].lx), plans[i].l_pad, gen,
                                          device, TrainDraws)) for i in checked]
    low = entry.reference_readings(fam, cfg, flat, steps,
                                   fam.control_precision(cfg["compute_dtype"]))
    return entry.reference_numbers(fam, cfg, flat, steps, *low)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cell = harness.resolve(args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(what, seed, numbers, t):
        line = json.dumps({"workload": cell.name, "what": what, "seed": seed,
                           "numbers": {k: v[0] for k, v in numbers.items()},
                           "where": {k: v[1] for k, v in numbers.items()},
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for what, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        ("fault", args.fault_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            if what == "control":
                numbers = train_control(cell, seed, device)
            else:
                faults = ("half_batch",) if what == "fault" else ()
                run = harness.Run(cell, seed, 0.0, False, device, time.perf_counter(), faults)
                outcome = harness.entry(cell).run(run)
                numbers = {c.name: (c.value, note) for c, note in
                           zip(outcome.checks, outcome.notes)}
            emit(what, seed, numbers, t)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
