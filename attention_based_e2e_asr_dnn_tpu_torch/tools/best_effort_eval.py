"""One combined best-effort number, served from artifacts (the counterpart
of the repository's ``tools/best_effort_eval.py``): beam search with the
fitted corrector, no experiment folder on the serving side.

It exports the LAS run twice (greedy and beam-K) and, given a Rewriter run,
its corrector, each through this package's ``tools/export_serving``
(``python -m attention_based_e2e_asr_dnn_tpu_torch.tools.export_serving``
in a child process, as a deployment would); decodes the split through
``ArtifactTranscriber``; and reports

    greedy | beam | beam + fitted corrector      (dev LD of each)

the reference's intended two-stage pipeline (its README.md:51-53: LAS,
then a Rewriter that corrects its predictions).

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.best_effort_eval \\
        --data-dir /tmp/synth --run-dir <las experiment> --lm-run <rewriter run> \\
        --span-family f90 --margin -0.94 --out best_effort.json

Prints one JSON record (the JAX tool's keys); ``--device`` (default
``cuda``; ``cuda`` without a card raises) is where the exports are checked
and the artifacts run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import require_device
from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import levenshtein


def export(exp_folder: str, out: str, batch: int, t_pad: int, device: str,
           beam_size: int = 0, model: str = "las", span_rewrite: bool = False) -> str:
    """``tools/export_serving`` in a child process; raises if it fails."""
    cmd = [sys.executable, "-m", "attention_based_e2e_asr_dnn_tpu_torch.tools.export_serving",
           exp_folder, "-o", out, "--batch", str(batch), "--t-pad", str(t_pad),
           "--device", device]
    if model != "las":
        cmd += ["--model", model, "--average"]
    if beam_size:
        cmd += ["--beam-size", str(beam_size)]
    if span_rewrite:
        cmd += ["--span-rewrite"]
    # the child imports the package from the directory that holds it
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    subprocess.run(cmd, check=True, env=env)
    return out


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="greedy | beam | beam + corrector from artifacts")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--lm-run", default=None,
                    help="a Rewriter experiment (the fitted corrector); without it no "
                         "corrector row")
    ap.add_argument("--span-family", default=None,
                    help="the fitted family of lminfer's auto calibration")
    ap.add_argument("--margin", type=float, default=0.0,
                    help="the fitted gate margin of lminfer")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--beam-size", type=int, default=8)
    ap.add_argument("--split", default="dev-clean")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; cuda without a card raises")
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    require_device(args.device, "best_effort_eval")
    from attention_based_e2e_asr_dnn_tpu_torch.export import (
        ArtifactTranscriber,
        ExportedCorrector,
    )

    work = args.work_dir or tempfile.mkdtemp(prefix="besteffort-")
    os.makedirs(work, exist_ok=True)
    # the split, and the t_pad that covers its longest utterance
    mfcc_dir = os.path.join(args.data_dir, args.split, "mfcc")
    trans_dir = os.path.join(args.data_dir, args.split, "transcript", "raw")
    files = sorted(f for f in os.listdir(mfcc_dir) if f.endswith(".npy"))
    feats = [np.load(os.path.join(mfcc_dir, f)) for f in files]
    golds = ["".join(str(c) for c in np.load(os.path.join(trans_dir, f))[1:-1])
             for f in files]
    t_max = max(f.shape[0] for f in feats)
    t_pad = int(-(-t_max // 128) * 128)
    print(f"[best_effort] {len(feats)} utterances, longest {t_max} frames -> t_pad {t_pad}")

    greedy_art = export(args.run_dir, os.path.join(work, "las-greedy.tlas"), args.batch,
                        t_pad, args.device)
    beam_art = export(args.run_dir, os.path.join(work, "las-beam.tlas"), args.batch, t_pad,
                      args.device, beam_size=args.beam_size)
    corr_art = None
    if args.lm_run:
        corr_art = export(args.lm_run, os.path.join(work, "corr.tlas"), 32, 320,
                          args.device, model="rewriter",
                          span_rewrite=args.span_family is not None)

    def decode_all(transcriber) -> list:
        out = []
        for i in range(0, len(feats), args.batch):
            out.extend(transcriber.transcribe(feats[i:i + args.batch]))
        return out

    def mean_ld(preds) -> float:
        return float(np.mean([levenshtein(p, g) for p, g in zip(preds, golds)]))

    result = {"run_dir": args.run_dir, "lm_run": args.lm_run, "split": args.split,
              "n_utts": len(feats), "beam_size": args.beam_size,
              "span_family": args.span_family, "margin": args.margin}
    result["greedy_dev_ld"] = mean_ld(decode_all(ArtifactTranscriber(greedy_art,
                                                                      device=args.device)))
    print(f"[best_effort] greedy dev LD {result['greedy_dev_ld']:.3f}")
    beam = ArtifactTranscriber(beam_art, device=args.device)
    result["beam_dev_ld"] = mean_ld(decode_all(beam))
    print(f"[best_effort] beam-{args.beam_size} dev LD {result['beam_dev_ld']:.3f}")
    if corr_art:
        chained = ArtifactTranscriber(beam_art, corrector=ExportedCorrector(
            corr_art, device=args.device), margin=args.margin,
            span_family=args.span_family, device=args.device)
        result["beam_corrector_dev_ld"] = mean_ld(decode_all(chained))
        print(f"[best_effort] beam+corrector dev LD {result['beam_corrector_dev_ld']:.3f} "
              f"(family {args.span_family}, margin {args.margin})")
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print(f"[best_effort] written {args.out}")
    return result


if __name__ == "__main__":
    main()
