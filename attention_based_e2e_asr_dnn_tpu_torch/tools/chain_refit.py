"""Fit the Rewriter chain again on a finished LAS run's milestones (the
counterpart of the repository's ``tools/chain_refit.py``), through this
package's ``lmtrain`` and ``lminfer`` CLIs:

  for each milestone epoch M:
    1. decode train / dev / test prediction CSVs with milestone M (the
       reference's step that makes the Rewriter's data, src/train.py:323);
    2. ``lmtrain`` the corrector on (train predictions, gold transcripts);
    3. ``lminfer`` the test CSV three ways: margin 0 free rewrite, the
       ``"auto"`` margin without spans, the ``"auto"`` policy with span
       rewrites (the dev pairs as its calibration set);
    4. record the input and corrected test LD of each mode.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.chain_refit --data-dir /tmp/synth \\
        --run-dir <las experiment> --milestones 9 19 --out chain_refit.json

An existing prediction CSV or finished corrector run in ``--work-dir`` is
used again. Prints one JSON record (the JAX tool's keys); ``--device``
(default ``cuda``; ``cuda`` without a card raises) is where every stage runs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from attention_based_e2e_asr_dnn_tpu_torch.tools.full_recipe_run import (
    dev_ld_of_csv,
    rewriter_config,
    run_infer,
    write_yaml,
)
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import require_device

MODES = {
    "margin0_free": dict(gate_correction=True, confidence_margin=0.0, span_rewrite=False),
    "auto_margin_r3": dict(gate_correction=True, confidence_margin="auto",
                           span_rewrite=False),
    "auto_policy_r4": dict(gate_correction=True, confidence_margin="auto",
                           span_rewrite=True),
}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the Rewriter chain fitted again per milestone")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--run-dir", required=True,
                    help="a finished LAS experiment (config.json, ckpts/); its milestones "
                         "in ../milestones")
    ap.add_argument("--milestone-dir", default=None)
    ap.add_argument("--milestones", type=int, nargs="+", default=[9, 19, 29])
    ap.add_argument("--lm-epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lm-max-steps", type=int, default=288,
                    help="the corrector's decode cap: must cover the longest transcript")
    ap.add_argument("--lm-beam", type=int, default=8)
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; cuda without a card raises")
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    require_device(args.device, "chain_refit")
    from attention_based_e2e_asr_dnn_tpu_torch import lminfer as lminfer_mod
    from attention_based_e2e_asr_dnn_tpu_torch import lmtrain as lmtrain_mod

    work = args.work_dir or tempfile.mkdtemp(prefix="chainrefit-")
    os.makedirs(work, exist_ok=True)
    mst_dir = args.milestone_dir or os.path.join(
        os.path.dirname(os.path.dirname(args.run_dir)), "las", "milestones")
    if not os.path.isdir(mst_dir):
        mst_dir = os.path.join(os.path.dirname(args.run_dir), "milestones")
    dev_trans = os.path.join(args.data_dir, "dev-clean", "transcript", "raw")
    tst_trans = os.path.join(args.data_dir, "test-clean", "transcript", "raw")
    device_args = ["--device", args.device]

    rows = []
    for m_epoch in args.milestones:
        mst = os.path.join(mst_dir, f"epoch[{m_epoch}].ckpt")
        if not os.path.exists(mst):
            print(f"[chain_refit] SKIP epoch {m_epoch}: {mst} missing", file=sys.stderr)
            continue
        mst_local = os.path.join(args.run_dir, "ckpts", f"milestone-epoch[{m_epoch}].ckpt")
        shutil.copyfile(mst, mst_local)

        # 1. prediction CSVs: train feeds lmtrain, dev calibrates, test reports
        def decode(split, tag):
            csv_path = os.path.join(args.run_dir, "preds",
                                    f"milestone-epoch[{m_epoch}]-{tag}.csv")
            if os.path.exists(csv_path):
                print(f"[chain_refit] reuse {csv_path}")
                return csv_path
            return run_infer(args.run_dir, os.path.join(args.data_dir, split), mst_local,
                             args.batch_size, args.device)

        trn_pred = decode("train-clean-100", "trn")
        dev_pred = decode("dev-clean", "dev")
        tst_pred = decode("test-clean", "tst")
        ld_dev_in = dev_ld_of_csv(dev_pred, dev_trans)
        ld_tst_in = dev_ld_of_csv(tst_pred, tst_trans)
        print(f"[chain_refit] milestone {m_epoch}: input dev LD {ld_dev_in:.2f}, "
              f"held-out test LD {ld_tst_in:.2f}")

        # 2. the corrector on the milestone's train predictions; a finished
        # run (one with a checkpoint that is not a crash save) is used again
        lm_exp = os.path.join(work, f"lm-m{m_epoch}")

        def finished_runs():
            if not os.path.isdir(lm_exp):
                return []
            return [os.path.join(lm_exp, d) for d in sorted(os.listdir(lm_exp))
                    if any(not f.startswith("emergency")
                           for f in os.listdir(os.path.join(lm_exp, d, "ckpts")))]

        done = finished_runs()
        if done:
            lm_run = done[-1]
            print(f"[chain_refit] reuse trained corrector {lm_run}")
        else:
            lm_cfg = rewriter_config(args.data_dir, lm_exp, trn_pred, dev_pred,
                                     args.lm_epochs)
            lm_cfg["model"]["configs"]["CHR_MAX_STEPS"] = args.lm_max_steps
            lm_path = write_yaml(os.path.join(work, f"rewriter-m{m_epoch}.yml"), lm_cfg)
            lmtrain_mod.main(lmtrain_mod.build_argparser().parse_args(["-c", lm_path,
                                                                       *device_args]))
            lm_run = finished_runs()[-1]

        # 3. the held-out test CSV under each chain mode
        row = {"milestone_epoch": m_epoch, "input_dev_ld": ld_dev_in,
               "input_test_ld": ld_tst_in, "modes": {}}
        for name, extra in MODES.items():
            li_path = write_yaml(os.path.join(work, f"lminfer-m{m_epoch}-{name}.yml"), {
                "TST_DIR": tst_pred, "TST_FOLDER": os.path.join(args.data_dir, "test-clean"),
                "exp_folder": lm_run, "use_greedy": True, "batch_size": args.batch_size,
                "run_all": False, "epoch_num": None, "run_avg": True,
                "beam_size": args.lm_beam, "CAL_PRED_DIR": dev_pred,
                "CAL_TRANS_DIR": dev_trans, **extra})
            lminfer_mod.main(lminfer_mod.build_argparser().parse_args(["-c", li_path,
                                                                       *device_args]))
            ld_after = dev_ld_of_csv(os.path.join(lm_run, "ckpts", "avg-all-pred.csv"),
                                     tst_trans)
            row["modes"][name] = {"test_ld": ld_after, "delta": ld_tst_in - ld_after}
            print(f"[chain_refit] m{m_epoch} {name}: test LD {ld_after:.2f} "
                  f"(delta {ld_tst_in - ld_after:+.2f})")
        rows.append(row)

    result = {"run_dir": args.run_dir, "lm_epochs": args.lm_epochs, "lm_beam": args.lm_beam,
              "milestones": rows, "work_dir": work}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"[chain_refit] written {args.out}")
    return result


if __name__ == "__main__":
    main()
