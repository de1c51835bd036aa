"""Rewriter inference entry point (counterpart of the JAX ``lminfer.py``):
auto-correct a LAS prediction CSV.

    python -m attention_based_e2e_asr_dnn_tpu_torch.lminfer -c configs/lm-infer.yml [--device cpu]

The infer YAML's keys are the JAX CLI's: ``TST_DIR`` (the predictions),
``TST_FOLDER`` (whose ``transcript/random_submission.csv`` is the template),
``exp_folder`` (a Rewriter experiment), ``batch_size``, ``run_all`` /
``epoch_num`` / ``run_avg`` as in ``infer``; the decode: ``beam_size`` (> 1:
beam search), else ``early_stop`` (default true: the early-exit greedy
decode; false: the fixed ``CHR_MAX_STEPS`` decode, the fused decode kernel
under ``decoder_impl: pallas``), ``length_alpha``, ``max_len_factor``; the
gate: ``gate_correction`` (default true), ``confidence_margin`` (a number,
or ``"auto"``: fitted on ``CAL_PRED_DIR`` / ``CAL_TRANS_DIR``), and
``span_rewrite`` with ``span_family``, ``span_conf_tau``, ``span_fracs``.

Like the JAX CLI it decodes in float32 whatever ``compute_dtype`` the
experiment trained in. ``--device`` (default ``cuda``) names where the model
runs; ``cuda`` without a card fails. The output, ``<ckpt>-pred.csv`` beside
the checkpoint, is the template with its ``label`` column replaced, written
with the ``csv`` module (``infer.write_submission``), or one prediction a
line where there is no template that fits.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch.config import cfg_float, load_config
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import LmTestDataset, _npy_files
from attention_based_e2e_asr_dnn_tpu_torch.decoding.rescore import RewriteChain, fit_margin
from attention_based_e2e_asr_dnn_tpu_torch.infer import write_submission
from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import (
    RewriterConfig,
    rewriter_from_jax_params,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import (
    average_checkpoints,
    list_best_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import ids_to_str, levenshtein


def _decode_candidates(chain, params, batcher, n_examples):
    """Decode every input through ``chain`` (``decoding.rescore.RewriteChain``);
    returns ``(inputs, families)`` in dataset order, where ``families`` maps
    a rewrite policy's name to ``(corrected strings, score margins)``: one
    family ``"rewrite"`` for the plain chain; with span rewriting those of
    ``decoding.rescore.span_candidate_families`` (``"free"``, ``"conf"``,
    ``"fNN"``, ``"best"``)."""
    inputs = [None] * n_examples
    fam_out: dict = {}

    def _fam(name):
        if name not in fam_out:
            fam_out[name] = ([None] * n_examples, [0.0] * n_examples)
        return fam_out[name]

    for bt in batcher.epoch(0):
        lx = bt.lx.astype(np.int32)
        x = np.asarray(bt.x)
        batch_fams = chain(params, bt.x, lx)
        for row, orig in enumerate(bt.indices):
            if orig >= 0:
                inputs[orig] = ids_to_str(x[row][:lx[row]], constants.VOCAB,
                                          constants.SOS_IDX, constants.EOS_IDX)
                for name, (c_ids, m) in batch_fams.items():
                    corr, marg = _fam(name)
                    corr[orig] = ids_to_str(c_ids[row], constants.VOCAB,
                                            constants.SOS_IDX, constants.EOS_IDX)
                    if m is not None:
                        marg[orig] = float(m[row])
    return inputs, fam_out


def _calibrate_policy(tstcfgs, chain, params):
    """Fit the gate on the labelled calibration set (``CAL_PRED_DIR``
    predictions, ``CAL_TRANS_DIR`` gold transcripts, paired in sorted file
    order): per family the gain-maximising threshold (``fit_margin``) and
    its total LD gain. Returns ``(family, margin)`` of the best gain."""
    cal_pred = getattr(tstcfgs, "CAL_PRED_DIR", None)
    cal_trans = getattr(tstcfgs, "CAL_TRANS_DIR", None)
    if not cal_pred or not cal_trans:
        raise ValueError(
            'confidence_margin: "auto" requires CAL_PRED_DIR (prediction '
            "csv) and CAL_TRANS_DIR (gold transcript dir) in the config")
    ds = LmTestDataset(cal_pred, constants.VOCAB_MAP)
    cal_batcher = BucketBatcher(ds, tstcfgs.batch_size, pad_time_multiple=32,
                                has_labels=False, label_pad_id=constants.EOS_IDX)
    inputs, fams = _decode_candidates(chain, params, cal_batcher, len(ds))
    golds = ["".join(str(c) for c in np.load(f)[1:-1]) for f in _npy_files(cal_trans)]
    if len(golds) != len(ds):
        raise ValueError(f"calibration: {len(ds)} predictions in {cal_pred} for "
                         f"{len(golds)} transcripts in {cal_trans}")
    ld_in = np.asarray([levenshtein(i, g) for i, g in zip(inputs, golds)], np.float64)

    best = (float("-inf"), "rewrite" if chain.span is None else "best", float("inf"))
    for name, (corrected, margins) in sorted(fams.items()):
        ld_co = np.asarray([levenshtein(c, g) for c, g in zip(corrected, golds)], np.float64)
        t = fit_margin(margins, ld_in, ld_co)
        kept = np.asarray(margins, np.float64) > t
        gain = float((ld_in[kept] - ld_co[kept]).sum())
        print(f"  calibration [{name}]: margin {t:.4f} keeps "
              f"{int(kept.sum())}/{len(golds)}, LD gain {gain:+.1f}")
        if gain > best[0]:
            best = (gain, name, t)
    return best[1], best[2]


def infer_one_checkpoint(model_cfgs, tstcfgs, checkpoint_filepath, batcher, n_examples,
                         template_filepath, device) -> List[str]:
    print(f"running LM inference on checkpoint [{checkpoint_filepath}]")
    lm_cfg = RewriterConfig(**model_cfgs.model.configs)
    params = rewriter_from_jax_params(load_checkpoint(checkpoint_filepath)["params"]).to(device)

    # the confidence gate (on by default): a rewrite replaces its input only
    # where the model scores it above regenerating the input by the margin;
    # span_rewrite: prefix-anchored rewrites widen the candidate set, and
    # the auto gate fits which policy (and what margin) earns its keep
    gate = bool(getattr(tstcfgs, "gate_correction", True))
    span_rewrite = bool(getattr(tstcfgs, "span_rewrite", False))
    if span_rewrite and not gate:
        raise ValueError("span_rewrite requires gate_correction: true "
                         "(candidate selection uses the gate's scorer)")
    chain = RewriteChain(
        lm_cfg, beam_size=int(getattr(tstcfgs, "beam_size", 0) or 0),
        length_alpha=float(getattr(tstcfgs, "length_alpha", 0.0) or 0.0),
        max_len_factor=cfg_float(tstcfgs, "max_len_factor", 3.0),
        early_stop=bool(getattr(tstcfgs, "early_stop", True)), gate=gate,
        span_rewrite=span_rewrite, span_conf_tau=cfg_float(tstcfgs, "span_conf_tau", 0.5),
        span_fracs=getattr(tstcfgs, "span_fracs", None) or (0.25, 0.5, 0.75, 0.9))
    raw_margin = getattr(tstcfgs, "confidence_margin", 0.0)

    if gate and raw_margin == "auto":
        family, margin = _calibrate_policy(tstcfgs, chain, params)
        print(f"auto-calibrated policy: [{family}] margin {margin:.4f}")
    elif raw_margin == "auto":
        print("confidence_margin: auto ignored (gate_correction is off)")
        family, margin = "rewrite", 0.0
    else:
        family = getattr(tstcfgs, "span_family", None) or ("best" if span_rewrite else "rewrite")
        margin = cfg_float(tstcfgs, "confidence_margin", 0.0)
        # the family's name is checked before the decode, not after it
        chain.check_family(family, "" if span_rewrite else
                           " (anchored families need span_rewrite: true)")

    inputs, fams = _decode_candidates(chain, params, batcher, n_examples)
    corrected, margins = fams[family]
    if gate:
        use = [m > margin for m in margins]
        preds = [c if u else i for c, i, u in zip(corrected, inputs, use)]
        print(f"confidence gate kept {sum(use)}/{len(use)} corrections "
              f"(policy {family}, margin {margin})")
    else:
        preds = corrected

    # rewrite the basename only: a parent folder named "*.ckpt" stays
    ckpt_base = os.path.splitext(os.path.basename(checkpoint_filepath))[0]
    out_filepath = os.path.join(os.path.dirname(checkpoint_filepath), f"{ckpt_base}-pred.csv")
    try:
        write_submission(preds, template_filepath, out_filepath)
    except (FileNotFoundError, ValueError):
        # no template, or one of another length: one prediction a line
        with open(out_filepath, "w") as fh:
            fh.write("\n".join(preds) + "\n")
    print(f"wrote [{out_filepath}]")
    return preds


def main(args):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here; "
                           f"pass --device cpu to decode on the CPU")
    tstcfgs = load_config(args.config_file)
    exp_folder = tstcfgs.exp_folder
    model_cfgs = load_config(os.path.join(exp_folder, "config.json"))
    # on a card with a kernel tier configured: every kernel source built side
    # by side before the first batch
    cuda_build.build_for(device, model_cfgs.model.configs.get("lstm_impl"),
                         model_cfgs.model.configs.get("decoder_impl"))

    ds = LmTestDataset(tstcfgs.TST_DIR, constants.VOCAB_MAP)
    batcher = BucketBatcher(ds, tstcfgs.batch_size, pad_time_multiple=32,
                            has_labels=False, label_pad_id=constants.EOS_IDX)
    template = os.path.join(getattr(tstcfgs, "TST_FOLDER", "") or "", "transcript",
                            "random_submission.csv")

    ckpt_dir = os.path.join(exp_folder, "ckpts")
    # best-tag checkpoints only: crash saves and a previous avg-all stay out
    ckpts = list_best_checkpoints(ckpt_dir)
    common = dict(model_cfgs=model_cfgs, tstcfgs=tstcfgs, batcher=batcher,
                  n_examples=len(ds), template_filepath=template, device=device)

    if tstcfgs.run_all:
        for fp in ckpts:
            infer_one_checkpoint(checkpoint_filepath=os.path.join(ckpt_dir, fp), **common)
    elif getattr(tstcfgs, "epoch_num", None) is not None:
        match = [f for f in ckpts
                 if os.path.splitext(f)[0].endswith(f"epoch[{tstcfgs.epoch_num}]")]
        if not match:
            # fail loudly: a silent skip reads as success with no output
            raise FileNotFoundError(
                f"no checkpoint matches epoch[{tstcfgs.epoch_num}] in "
                f"{ckpt_dir}; available: {ckpts}")
        infer_one_checkpoint(checkpoint_filepath=os.path.join(ckpt_dir, match[0]), **common)

    if getattr(tstcfgs, "run_avg", False):
        avg = average_checkpoints([os.path.join(ckpt_dir, f) for f in ckpts])
        avg_path = os.path.join(ckpt_dir, "avg-all.ckpt")
        save_checkpoint(avg_path, avg)
        infer_one_checkpoint(checkpoint_filepath=avg_path, **common)


def build_argparser():
    parser = argparse.ArgumentParser(description="Rewriter LM inference (PyTorch)")
    parser.add_argument("--config-file", "-c", default="./configs/lm-infer.yml",
                        type=str, help="filepath of the inference YAML")
    parser.add_argument("--device", default="cuda", type=str,
                        help="where the model runs: cuda, cuda:N or cpu")
    return parser


if __name__ == "__main__":
    main(build_argparser().parse_args())
