"""LAS inference entry point (counterpart of the JAX ``infer.py``):

    python -m attention_based_e2e_asr_dnn_tpu_torch.infer -c configs/infer.yml [--device cpu]

Reads the infer YAML and the experiment's ``config.json`` snapshot to
rebuild the model, then decodes the test set for every best checkpoint
(``run_all``), one ``epoch_num``, and/or their uniform average (``run_avg``
-> ``ckpts/avg-all.ckpt``). ``beam_size > 1`` takes beam search
(``length_alpha``, ``max_len_factor``); otherwise ``early_stop`` (default
true) takes the early-exit greedy decoder and ``early_stop: false`` the
fixed ``CHR_MAX_STEPS`` decode of ``make_infer_step``, which is the fused
decode kernel when the speller sets ``decoder_impl: pallas``. Predictions
are written in the template's utterance order to
``preds/<ckpt>-<tag>.csv``.

``--device`` (default ``cuda``) names where the model runs; ``cuda``
without a card fails. The submission CSV is written with the ``csv``
module, byte for byte as pandas' ``to_csv(index=False)`` writes it; the
template's other columns are copied as they are.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List

import torch

from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch.config import cfg_float, load_config
from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import ids_to_str
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import (
    AsrTestDataset,
    ToyTestDataset,
)
from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import make_las_beam_step
from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import make_las_greedy_step
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_apply,
    las_config_from_dicts,
    las_from_jax_params,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.ops.precision import compute_dtype
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import (
    average_checkpoints,
    list_best_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import make_infer_step


def decode_dataset(params, step, batcher, vocab, sos_idx, eos_idx,
                   n_examples, device) -> List[str]:
    """Decode every utterance with ``step(params, x, lx) -> ids``; returns
    predictions in DATASET order."""
    preds = [None] * n_examples
    for bt in batcher.epoch(0):
        ids = step(params, torch.from_numpy(bt.x).to(device),
                   torch.from_numpy(bt.lx).to(device)).cpu().numpy()
        for row, orig in enumerate(bt.indices):
            if orig >= 0:
                preds[orig] = ids_to_str(ids[row], vocab, sos_idx, eos_idx)
    assert all(p is not None for p in preds)
    return preds


def write_submission(preds: List[str], template_filepath: str,
                     out_filepath: str) -> str:
    """The template CSV with its ``label`` column replaced by ``preds``
    (appended when it has none)."""
    with open(template_filepath, newline="") as fh:
        rows = [row for row in csv.reader(fh) if row]
    header, body = rows[0], rows[1:]
    if len(body) != len(preds):
        raise ValueError(f"{template_filepath} has {len(body)} rows for "
                         f"{len(preds)} predictions")
    if "label" not in header:
        header.append("label")
        for row in body:
            row.append("")
    col = header.index("label")
    for row, pred in zip(body, preds):
        row[col] = pred
    os.makedirs(os.path.dirname(out_filepath) or ".", exist_ok=True)
    with open(out_filepath, "w", newline="") as fh:
        csv.writer(fh, lineterminator="\n").writerows([header] + body)
    return out_filepath


def infer_one_checkpoint(model_cfgs, infcfgs, checkpoint_filepath, batcher,
                         n_examples, tag, template_filepath, vocab, sos_idx,
                         eos_idx, device):
    print(f"running inference on checkpoint [{checkpoint_filepath}]")
    las_cfg = las_config_from_dicts(
        model_cfgs.model.configs["listener_configs"],
        model_cfgs.model.configs["speller_configs"],
    )
    params = las_from_jax_params(
        load_checkpoint(checkpoint_filepath)["params"]).to(device)
    # decode with the dtype the experiment trained in (snapshotted config)
    dtype = compute_dtype(getattr(model_cfgs, "compute_dtype", "float32"))
    beam = int(getattr(infcfgs, "beam_size", 0) or 0)
    # the cap in characters per encoder frame; 0 disables it
    len_factor = cfg_float(infcfgs, "max_len_factor", 3.0)
    if beam > 1:
        step = make_las_beam_step(
            las_cfg, beam_size=beam,
            length_alpha=float(getattr(infcfgs, "length_alpha", 0.0) or 0.0),
            compute_dtype=dtype, max_len_factor=len_factor)
    elif bool(getattr(infcfgs, "early_stop", True)):
        # all-finished early exit
        step = make_las_greedy_step(las_cfg, compute_dtype=dtype,
                                    max_len_factor=len_factor)
    else:
        step = make_infer_step(lambda p, x, lx: las_apply(p, las_cfg, x, lx),
                               compute_dtype=dtype)
    preds = decode_dataset(params, step, batcher, vocab, sos_idx, eos_idx,
                           n_examples, device)

    # rewrite the basename and the immediate ckpts/ parent only
    ckpt_dir = os.path.dirname(checkpoint_filepath)
    out_dir = (os.path.join(os.path.dirname(ckpt_dir), "preds")
               if os.path.basename(ckpt_dir) == "ckpts" else ckpt_dir)
    ckpt_base = os.path.splitext(os.path.basename(checkpoint_filepath))[0]
    out_filepath = os.path.join(out_dir, f"{ckpt_base}-{tag}.csv")
    if template_filepath and os.path.exists(template_filepath):
        write_submission(preds, template_filepath, out_filepath)
    else:
        os.makedirs(os.path.dirname(out_filepath) or ".", exist_ok=True)
        with open(out_filepath, "w") as fh:
            fh.write("\n".join(preds) + "\n")
    print(f"wrote [{out_filepath}]")
    return preds


def main(args):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here; "
                           f"pass --device cpu to decode on the CPU")
    infcfgs = load_config(args.config_file)
    exp_folder = infcfgs.exp_folder
    model_cfgs = load_config(os.path.join(exp_folder, "config.json"))
    # on a card with a kernel tier configured: every kernel source built side
    # by side before the first batch
    cuda_build.build_for(
        device, model_cfgs.model.configs["listener_configs"].get("lstm_impl"),
        model_cfgs.model.configs["speller_configs"].get("decoder_impl"))

    use_mini = os.path.basename(model_cfgs.TRN_FOLDER).startswith("mini")
    # a reference experiment's snapshot has no vocabulary: the fixed table
    vocab = getattr(model_cfgs, "VOCAB", None)
    if vocab is None:
        vocab = constants.VOCAB
        sos_idx, eos_idx = constants.SOS_IDX, constants.EOS_IDX
    else:
        sos_idx = model_cfgs.SOS_IDX
        eos_idx = model_cfgs.EOS_IDX

    if use_mini:
        ds = ToyTestDataset(infcfgs.SOME_FOLDER)
    else:
        ds = AsrTestDataset(std_dir=infcfgs.SOME_FOLDER)
    batcher = BucketBatcher(
        ds, infcfgs.batch_size,
        pad_time_multiple=int(getattr(infcfgs, "pad_time_multiple", 128)),
        has_labels=False,
    )
    base = os.path.basename(os.path.normpath(infcfgs.SOME_FOLDER))
    tag = "trn" if "train" in base else "dev" if "dev" in base else "tst"

    template = os.path.join(infcfgs.SOME_FOLDER, "transcript", "random_submission.csv")
    if not os.path.exists(template):
        template = os.path.join(infcfgs.SOME_FOLDER, "transcript", "processed.csv")
        if not os.path.exists(template):
            template = None

    ckpt_dir = os.path.join(exp_folder, "ckpts")
    # best-tag checkpoints only: crash saves and a previous avg-all stay out
    ckpts = list_best_checkpoints(ckpt_dir)

    common = dict(model_cfgs=model_cfgs, infcfgs=infcfgs, batcher=batcher,
                  n_examples=len(ds), tag=tag, template_filepath=template,
                  vocab=vocab, sos_idx=sos_idx, eos_idx=eos_idx, device=device)

    if infcfgs.run_all:
        for fp in ckpts:
            infer_one_checkpoint(
                checkpoint_filepath=os.path.join(ckpt_dir, fp), **common)
    elif getattr(infcfgs, "epoch_num", None) is not None:
        match = [f for f in ckpts
                 if os.path.splitext(f)[0].endswith(f"epoch[{infcfgs.epoch_num}]")]
        if not match:
            # fail loudly: a silent skip reads as success with no output
            raise FileNotFoundError(
                f"no checkpoint matches epoch[{infcfgs.epoch_num}] in "
                f"{ckpt_dir}; available: {ckpts}"
            )
        infer_one_checkpoint(
            checkpoint_filepath=os.path.join(ckpt_dir, match[0]), **common)

    if getattr(infcfgs, "run_avg", False):
        avg = average_checkpoints([os.path.join(ckpt_dir, f) for f in ckpts])
        avg_path = os.path.join(ckpt_dir, "avg-all.ckpt")
        save_checkpoint(avg_path, avg)
        infer_one_checkpoint(checkpoint_filepath=avg_path, **common)


def build_argparser():
    parser = argparse.ArgumentParser(description="LAS model inference (PyTorch)")
    parser.add_argument("--config-file", "-c", default="./configs/infer.yml",
                        type=str, help="filepath of the inference YAML")
    parser.add_argument("--device", default="cuda", type=str,
                        help="where the model runs: cuda, cuda:N or cpu")
    return parser


if __name__ == "__main__":
    main(build_argparser().parse_args())
