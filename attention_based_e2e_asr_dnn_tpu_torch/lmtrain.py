"""Rewriter training entry point (counterpart of the JAX ``lmtrain.py``):

    python -m attention_based_e2e_asr_dnn_tpu_torch.lmtrain -c configs/rewriter.yml [--device cpu]

Pairs LAS prediction strings with gold transcripts and trains the
sequence-to-sequence Rewriter with the Trainer the LAS pipeline uses. The
YAML keys are the JAX CLI's, and so is the experiment folder it writes:
``config.json`` (the snapshot, with the LM vocabulary injected),
``ckpts/*.ckpt`` and ``log.json``, which either package's ``lminfer``,
``Corrector`` and ``Trainer`` read.

``--device`` (default ``cuda``) names where the model trains; ``cuda``
without a card fails. ``compute_dtype: bfloat16`` is the policy of the LAS:
float32 parameters, the activations in bfloat16 from the embedding lookup
on. With ``lstm_impl: pallas`` and ``decoder_impl: pallas`` in the model
block the encoder trains on the LSTM kernels (``lstm_scan_train`` forward,
``lstm_bwd_dw`` backward) and the decoder on the fused decode's training
form and its adjoint; the dev pass decodes on ``lstm_scan`` and the eval
form. ``parallel:`` is checked and routed as the JAX CLI does it:
``pipeline`` and ``sequence`` raise its ``ValueError``s (LAS-only),
``model > 1`` with a kernel tier its tensor-parallel ``ValueError``;
``model: M`` on the scan loops trains tensor-parallel in this process over a
``(data, model)`` grid (``parallel/mesh.py``: the encoder's and the
decoder's ``w_ih`` / ``w_hh``, the attention maps and ``char_emb``
column-sharded by the LAS rule; the visible cards, or with ``--device cpu``
the CPU at every position); ``use: true`` with ``data: N`` alone (or
``n_devices``; null: every visible card) trains data-parallel, as the
``train`` CLI does (one command; ``torchrun`` too).
With an
``export_artifact`` block the best checkpoint becomes a corrector artifact
(``export.export_corrector_from_experiment``) under
``<experiment>/artifacts/``; a failed export warns and leaves the trained
experiment in place, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import torch

from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch.config import Config, load_yaml
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import LmTrainDevDataset
from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import (
    RewriterConfig,
    draw_rewriter_noise,
    rewriter_apply,
    rewriter_init,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.precision import compute_dtype
from attention_based_e2e_asr_dnn_tpu_torch.parallel.dp import (
    close_experiment,
    open_experiment,
    run_training,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.grid import grid_devices
from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import (
    make_mesh_2d,
    shard_batch_fn,
    shard_train_state,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.trainer import Trainer


def scale_rewriter_dropouts(cfg: RewriterConfig, scale: float) -> RewriterConfig:
    """The dropout scheduler's multiplicative scale on every rate."""
    if scale == 1.0:
        return cfg
    return dataclasses.replace(
        cfg,
        enc_dropouts=tuple(d * scale for d in cfg.enc_dropouts),
        att_dropout=cfg.att_dropout * scale,
        dec_lstm_dropout=cfg.dec_lstm_dropout * scale,
    )


def make_rewriter_apply_factory(base_cfg: RewriterConfig, compute_dtype=None):
    """``make_apply(dropout_scale) -> apply_fn`` for the Trainer:
    ``rewriter_apply`` with the config, its dropout rates scaled, and the
    compute dtype bound. A training pass handed a ``generator`` and no
    ``draws`` draws its dropout masks and forcing coins from it;
    ``apply_fn.draw(batch, steps, generator, device)`` draws them for a
    whole batch (the steps over a device grid)."""

    def make_apply(dropout_scale: float):
        cfg = scale_rewriter_dropouts(base_cfg, dropout_scale)

        def apply_fn(params, x, lx, dec_y=None, tf_rate=1.0, init_force=False,
                     train=False, draws=None, generator=None):
            return rewriter_apply(params, cfg, x, lx, dec_y, tf_rate, init_force, train,
                                  compute_dtype=compute_dtype, draws=draws,
                                  generator=generator)

        apply_fn.draw = lambda batch, steps, generator, device: draw_rewriter_noise(
            cfg, batch, steps, generator, device)
        return apply_fn

    return make_apply


def inject_lm_vocab(cfg_dict: dict) -> dict:
    """Derived-config injection for the LM (reference src/lmtrain.py:270-278)."""
    cfg_dict["model"]["configs"]["vocab_size"] = len(constants.VOCAB)
    cfg_dict["model"]["configs"]["CHR_SOS_IDX"] = constants.SOS_IDX
    cfg_dict["model"]["configs"]["CHR_PAD_IDX"] = constants.EOS_IDX
    cfg_dict["VOCAB"] = list(constants.VOCAB)
    cfg_dict["VOCAB_MAP"] = dict(constants.VOCAB_MAP)
    cfg_dict["EOS_IDX"] = constants.EOS_IDX
    cfg_dict["SOS_IDX"] = constants.SOS_IDX
    return cfg_dict


def check_parallel(trncfgs, lm_cfg: RewriterConfig):
    """The JAX CLI's checks of the ``parallel:`` block: False where it is
    off, the number of data-parallel ranks (None: every visible card) for
    ``data`` alone, else ``{"model": M, "data": D}`` for tensor
    parallelism."""
    par = getattr(trncfgs, "parallel", None)
    if par is None or not par.use:
        return False
    if int(getattr(par, "pipeline", 0) or 0) > 0:
        raise ValueError("parallel: pipeline is LAS-only (the Rewriter has no "
                         "listener|speller stage split)")
    if int(getattr(par, "sequence", 0) or 0) > 1:
        raise ValueError("parallel: sequence is LAS-only (no encoder-output "
                         "sharding hook on the Rewriter)")
    model_par = int(getattr(par, "model", 1) or 1)
    pallas_flags = [name for name, v in (("lstm_impl", lm_cfg.lstm_impl),
                                         ("decoder_impl", lm_cfg.decoder_impl))
                    if v == "pallas"]
    if model_par > 1 and pallas_flags:
        raise ValueError(
            f"parallel: model={model_par} (tensor parallelism) requires the scan "
            f"implementations, but {' and '.join(pallas_flags)} is 'pallas'. Use scan "
            "impls with parallel.model, or keep the kernel tiers and scale with "
            "parallel.data.")
    if model_par > 1:
        data = getattr(par, "data", None)
        return {"model": model_par, "data": None if data is None else int(data)}
    n = getattr(par, "data", None) or getattr(par, "n_devices", None)
    return None if n is None else int(n)


def export_hook(trncfgs, tgt_folder: str) -> None:
    """``export_artifact: {batch, t_pad, beam_size, gate, average}``: the
    corrector artifact of the best (or averaged) checkpoint; a failure
    warns, it never fails the finished run."""
    exp_cfg = getattr(trncfgs, "export_artifact", None)
    if not exp_cfg:
        return
    from attention_based_e2e_asr_dnn_tpu_torch.export import export_corrector_from_experiment

    try:
        batch = int(getattr(exp_cfg, "batch", 8))
        t_pad = int(getattr(exp_cfg, "t_pad", 256))
        out = os.path.join(tgt_folder, "artifacts", f"corrector-b{batch}-t{t_pad}.tlas")
        export_corrector_from_experiment(
            tgt_folder, out, batch=batch, t_pad=t_pad,
            average=bool(getattr(exp_cfg, "average", False)),
            beam_size=int(getattr(exp_cfg, "beam_size", 0)),
            gate=bool(getattr(exp_cfg, "gate", True)),
        )
        print(f"exported correction artifact: {out}")
    except Exception as exc:  # noqa: BLE001 - the JAX hook's contract: warn
        print(f"WARNING: export_artifact failed: {exc}", file=sys.stderr)


def main(args):
    """Train as the YAML says. Returns the ``Trainer``, or under
    ``parallel.use`` rank 0's histories (``parallel.dp.run_training``)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here; "
                           f"pass --device cpu to train on the CPU")
    trncfgs = Config(inject_lm_vocab(load_yaml(args.config_file)))
    lm_cfg = RewriterConfig(**trncfgs.model.configs)
    n_ranks = check_parallel(trncfgs, lm_cfg)
    if isinstance(n_ranks, dict):  # tensor parallelism: this process, over a grid
        return _train(None, args, n_ranks)
    return run_training(_train, args, n_ranks,
                        build="pallas" in (lm_cfg.lstm_impl, lm_cfg.decoder_impl))


def _train(mesh, args, tp_plan: Optional[dict] = None):
    device = args.device if mesh is None else mesh.device
    print(f"device: {torch.cuda.get_device_name(device) if torch.device(device).type == 'cuda' else device}")
    trncfgs_dict = inject_lm_vocab(load_yaml(args.config_file))
    trncfgs = Config(trncfgs_dict)
    lm_cfg = RewriterConfig(**trncfgs.model.configs)

    logger, tgt_folder = open_experiment(mesh, trncfgs, trncfgs_dict)

    trn_ds = LmTrainDevDataset(trncfgs.TRN_FOLDER, trncfgs.TRN_PRED_DIR, constants.VOCAB_MAP)
    dev_ds = LmTrainDevDataset(trncfgs.DEV_FOLDER, trncfgs.DEV_PRED_DIR, constants.VOCAB_MAP)
    pad_mult = int(getattr(trncfgs, "pad_label_multiple", 32))
    trn_batcher = BucketBatcher(
        trn_ds, trncfgs.batch_size, pad_time_multiple=pad_mult,
        pad_label_multiple=pad_mult, label_pad_id=constants.EOS_IDX,
        shuffle=True, seed=int(trncfgs.seed),
    )
    dev_batcher = BucketBatcher(
        dev_ds, trncfgs.batch_size, pad_time_multiple=pad_mult,
        pad_label_multiple=pad_mult, label_pad_id=constants.EOS_IDX,
    )
    print(f"[data] {len(trn_batcher)} train batches, {len(dev_batcher)} dev batches")

    dtype = compute_dtype(getattr(trncfgs, "compute_dtype", "float32"))
    parallel = {}
    if tp_plan is not None:
        model_par, data = tp_plan["model"], tp_plan["data"]
        grid = make_mesh_2d(data, model_par,
                            devices=grid_devices(device, (data or 1) * model_par))
        print(f"[parallel] 2-D mesh: data={grid.shape['data']} x model={grid.shape['model']}")
        parallel = {"shard_batch": shard_batch_fn(grid),
                    "shard_state": lambda st: shard_train_state(st, grid)}
    trainer = Trainer(
        init_fn=lambda generator: rewriter_init(lm_cfg, generator),
        make_apply=make_rewriter_apply_factory(lm_cfg, compute_dtype=dtype),
        trn_batcher=trn_batcher,
        dev_batcher=dev_batcher,
        trncfgs=trncfgs,
        saving_dir=tgt_folder,
        sos_idx=constants.SOS_IDX,
        eos_idx=constants.EOS_IDX,
        compute_dtype=dtype,
        logger=logger,
        device=device,
        dp_mesh=mesh,
        **parallel,
    )
    trainer.train_eval(int(trncfgs.epochs))
    close_experiment(mesh, trainer, logger, tgt_folder,
                     lambda: export_hook(trncfgs, tgt_folder))
    return trainer


def build_argparser():
    parser = argparse.ArgumentParser(description="Training the Rewriter LM, PyTorch")
    parser.add_argument("--config-file", "-c", type=str, default="./configs/rewriter.yml",
                        help="filepath to the configuration file")
    parser.add_argument("--device", default="cuda", type=str,
                        help="where the model trains: cuda, cuda:N or cpu")
    return parser


if __name__ == "__main__":
    main(build_argparser().parse_args())
