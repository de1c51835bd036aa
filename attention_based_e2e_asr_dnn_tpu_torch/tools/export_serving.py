"""Export a trained experiment's decode to a deployable artifact (the
counterpart of the repository's ``tools/export_serving.py``), in this
package's own format (``export.py``: an npz of the parameters and the
model's record; no program is stored).

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.export_serving \\
        experiments/<run> -o las-b8-t512.tlas --batch 8 --t-pad 512 \\
        [--beam-size 8] [--average] [--quantize int8] [--check]
    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.export_serving \\
        lm_experiments/<run> -o corr.tlas --model rewriter --t-pad 256 [--no-gate]

``--check`` loads the artifact through ``ExportedDecoder`` /
``ExportedCorrector`` (the model rebuilt from the artifact alone) and holds
its output on random input to the in-process step of the experiment's own
checkpoint (under ``--quantize``: on the artifact's dequantized weights,
which the artifact must reproduce exactly). ``--device`` (default ``cuda``;
``cuda`` without a card raises) is where ``--check`` runs.

``--data-parallel N`` (LAS only) records an N-way split in the artifact:
its loader decodes each batch over N cards (``export.py``), and ``--check``
then needs them. Refused: ``--platforms``, which names the StableHLO targets of the JAX package's
artifact; this format holds no compiled program and runs where it is
loaded.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.export import (
    ExportedCorrector,
    ExportedDecoder,
    export_corrector_from_experiment,
    export_from_experiment,
    load_artifact,
)
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import require_device

TEXTS = ["HELLO WORLD", "THE CAT SAT", "A"]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="export a decode bucket to an artifact")
    ap.add_argument("exp_folder")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--model", choices=["las", "rewriter"], default="las")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--t-pad", type=int, default=512)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--average", action="store_true")
    ap.add_argument("--beam-size", type=int, default=0)
    ap.add_argument("--length-alpha", type=float, default=0.0)
    ap.add_argument("--max-len-factor", type=float, default=3.0)
    ap.add_argument("--no-gate", action="store_true",
                    help="rewriter only: leave out the never-worse scorer")
    ap.add_argument("--span-rewrite", action="store_true",
                    help="rewriter only: also the prefix-anchored candidates, so that a "
                         "fitted span policy runs from the artifact")
    ap.add_argument("--span-conf-tau", type=float, default=0.5,
                    help="with --span-rewrite: the 'conf' family's threshold; must be "
                         "lminfer's span_conf_tau of the fit")
    ap.add_argument("--span-fracs", type=float, nargs="+", default=[0.25, 0.5, 0.75, 0.9],
                    help="with --span-rewrite: the fixed-fraction anchor families; must "
                         "be lminfer's span_fracs of the fit")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="LAS only: split each decode batch over this many cards")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="weights-only int8 (quantize.py): large matrices int8 with "
                         "per-channel scales, dequantized when loaded")
    ap.add_argument("--platforms", nargs="+", default=None,
                    help="refused: the JAX artifact's StableHLO targets")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where --check runs: cuda (default), cuda:N or cpu")
    return ap


def check_las(args, path: str) -> bool:
    """The artifact's ids against the in-process decode step on the same
    random batch; True when equal."""
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import make_las_beam_step
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import make_las_greedy_step
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_config_from_dicts,
        las_from_jax_params,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.ops.precision import compute_dtype
    from attention_based_e2e_asr_dnn_tpu_torch.serving import load_experiment

    dec = ExportedDecoder(path, device=args.device)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((args.batch, args.t_pad, dec.meta["input_dim"])).astype(np.float32)
    lx = rng.integers(args.t_pad // 2, args.t_pad + 1, args.batch).astype(np.int32)
    got = dec.decode_ids(x, lx)

    snap, payload = load_experiment(args.exp_folder, args.checkpoint, args.average)
    model = snap["model"]["configs"]
    cfg = las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    cdt = compute_dtype(snap.get("compute_dtype", "float32"))
    # under --quantize the in-process step runs on the artifact's own
    # dequantized weights, which the artifact must reproduce exactly
    tree = load_artifact(path)[1] if args.quantize else payload["params"]
    params = las_from_jax_params(tree).to(args.device)
    if args.beam_size > 1:
        step = make_las_beam_step(cfg, beam_size=args.beam_size,
                                  length_alpha=args.length_alpha, compute_dtype=cdt,
                                  max_len_factor=args.max_len_factor)
    else:
        step = make_las_greedy_step(cfg, compute_dtype=cdt,
                                    max_len_factor=args.max_len_factor)
    want = step(params, torch.from_numpy(x).to(args.device),
                torch.from_numpy(lx).to(args.device))
    want = np.asarray(want.cpu().numpy() if torch.is_tensor(want) else want, np.int32)
    if not np.array_equal(got, want):
        n_bad = int((got != want).any(axis=-1).sum())
        print(f"check FAILED: artifact ids differ from the in-process step on "
              f"{n_bad}/{args.batch} rows")
        return False
    print(f"check: artifact ids match the in-process decode exactly ({args.batch} rows x "
          f"{got.shape[1]} steps{', int8 weights' if args.quantize else ''})")
    return True


def check_rewriter(args, path: str) -> bool:
    """The artifact's corrections against the in-process ``Corrector``'s
    on the same texts; True when equal."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import rewriter_from_jax_params
    from attention_based_e2e_asr_dnn_tpu_torch.serving import Corrector

    corr = Corrector(args.exp_folder, checkpoint=args.checkpoint, average=args.average,
                     beam_size=args.beam_size, length_alpha=args.length_alpha,
                     max_len_factor=args.max_len_factor, gate=not args.no_gate,
                     batch_size=args.batch, device=args.device)
    exported = ExportedCorrector(path, device=args.device)
    got = exported.correct(TEXTS)
    if args.quantize:
        corr.params = rewriter_from_jax_params(load_artifact(path)[1]).to(args.device)
    want = corr.correct(TEXTS)
    if got != want:
        print(f"check FAILED: artifact corrections {got!r} != in-process {want!r}")
        return False
    print(f"check: artifact corrections match the in-process Corrector exactly "
          f"({len(TEXTS)} texts{', int8 weights' if args.quantize else ''})")
    return True


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.platforms is not None:
        ap.error("--platforms names the StableHLO targets of the JAX package's .tlas; "
                 "this package's artifact holds no compiled program and runs where it "
                 "is loaded (ExportedDecoder(path, device=...))")
    if args.span_rewrite and args.model != "rewriter":
        ap.error("--span-rewrite applies to --model rewriter")
    if args.span_rewrite and args.no_gate:
        ap.error("--span-rewrite requires the gate scorer (drop --no-gate)")
    if not args.span_rewrite and (args.span_conf_tau != 0.5
                                  or args.span_fracs != [0.25, 0.5, 0.75, 0.9]):
        ap.error("--span-conf-tau/--span-fracs only apply with --span-rewrite (they name "
                 "the candidate families the fitted policy points into)")
    require_device(args.device, "export_serving")

    if args.model == "rewriter":
        path = export_corrector_from_experiment(
            args.exp_folder, args.output, batch=args.batch, t_pad=args.t_pad,
            checkpoint=args.checkpoint, average=args.average, beam_size=args.beam_size,
            length_alpha=args.length_alpha, max_len_factor=args.max_len_factor,
            gate=not args.no_gate, span_rewrite=args.span_rewrite,
            span_conf_tau=args.span_conf_tau, span_fracs=tuple(args.span_fracs),
            quantize=args.quantize)
    else:
        path = export_from_experiment(
            args.exp_folder, args.output, batch=args.batch, t_pad=args.t_pad,
            checkpoint=args.checkpoint, average=args.average, beam_size=args.beam_size,
            length_alpha=args.length_alpha, max_len_factor=args.max_len_factor,
            data_parallel=args.data_parallel, quantize=args.quantize)
    print(f"exported -> {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    if args.check:
        ok = (check_rewriter if args.model == "rewriter" else check_las)(args, path)
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
