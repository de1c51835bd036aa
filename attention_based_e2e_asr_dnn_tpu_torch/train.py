"""LAS training entry point (counterpart of the JAX ``train.py``):

    python -m attention_based_e2e_asr_dnn_tpu_torch.train -c configs/base-las.yml [--device cpu]

Flow: config load -> mini-vs-full vocab selection -> derived-config
injection -> experiment folder + config.json snapshot -> batchers -> model
-> Trainer -> train_eval -> log.json. The YAML keys are the JAX CLI's.

``--device`` (default ``cuda``) names where the model trains; ``cuda``
without a card fails.

``parallel: {use: true}`` with ``model`` 1 or null, ``sequence`` 0 and
``pipeline`` 0 trains data-parallel (``parallel/dp.py``): ``data`` (or
``n_devices``; null: every visible card) ranks, one process each, each on
its rows of every global batch. The same command starts them: one rank runs
in this process; more are spawned, one process each, on ``cuda:0 ..
cuda:N-1`` (with ``--device cpu``, all on the CPU over gloo). Under ``torchrun --nproc-per-node N -m
attention_based_e2e_asr_dnn_tpu_torch.train -c <yml>`` each process joins
the group it is given. Rank 0 writes the experiment folder.

Tensor, sequence and pipeline parallelism run in this one process over a
grid of devices (``parallel/mesh.py``, ``grid.py``, ``sequence.py``,
``pipeline.py``), routed as the JAX CLI routes them: ``sequence: S`` (with
``model: M``, a 3-D ``(data, seq, model)`` grid) time-shards the attention;
else ``pipeline: N`` trains the two-stage pipeline with N microbatches, each
stage over a ``(data, model)`` grid; else ``model: M`` a ``(data, model)``
grid. The grid takes the visible cards (``data: null``: every card divided
by the inner axes; more than are present raises the JAX ``make_mesh_2d`` /
``make_mesh_3d`` message); with ``--device cpu`` every position is the CPU
(``data: null`` is 1). Each refuses the kernel tiers with the JAX CLI's
``ValueError``, and so does ``sequence`` with ``pipeline``.
With an ``export_artifact`` block (``batch``, ``t_pad``,
``beam_size``, ``average``, ``data_parallel``) the best checkpoint becomes
a serving artifact (``export.export_from_experiment``) under
``<experiment>/artifacts/``; a failed export warns and leaves the trained
experiment in place, as in the JAX CLI. ``eval_beam_size
> 1`` takes the dev LD from beam search (``decoding/beam.py::
make_las_eval_beam_step``: one listener pass a dev batch for the loss decode
and the beam). ``lazy_data: true`` keeps the features on disk and
assembles each batch when it is due (``data/lazy.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch.config import (
    Config,
    cfg_float,
    inject_vocab,
    load_yaml,
)
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import (
    AsrTrainDevDataset,
    ToyTrainDevDataset,
)
from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import make_las_eval_beam_step
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    LASConfig,
    draw_train_noise,
    las_apply,
    las_config_from_dicts,
    las_init,
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
    make_mesh_3d,
    shard_batch_fn,
    shard_train_state,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.trainer import Trainer
from attention_based_e2e_asr_dnn_tpu_torch.utils.summary import (
    model_summary,
    shape_flop_summary,
)


def scale_las_dropouts(cfg: LASConfig, scale: float) -> LASConfig:
    """Apply the dropout scheduler's multiplicative scale to every rate
    (reference dropout_step, src/train.py:459-474)."""
    if scale == 1.0:
        return cfg
    lis = dataclasses.replace(
        cfg.listener,
        init_dropout=cfg.listener.init_dropout * scale,
        mid_dropout=cfg.listener.mid_dropout * scale,
        final_dropout=cfg.listener.final_dropout * scale,
    )
    spe = dataclasses.replace(
        cfg.speller,
        att_dropout=cfg.speller.att_dropout * scale,
        dec_emb_dropout=cfg.speller.dec_emb_dropout * scale,
        dec_lstm_dropout=cfg.speller.dec_lstm_dropout * scale,
    )
    return LASConfig(listener=lis, speller=spe)


def make_las_apply_factory(base_cfg: LASConfig):
    """``make_apply(dropout_scale) -> apply_fn`` for the Trainer: ``las_apply``
    with the config, its dropout rates scaled, bound; ``apply_fn.draw(batch,
    steps, generator, device)`` draws one training pass's ``TrainDraws``
    (the steps over a device grid draw the whole batch's)."""

    def make_apply(dropout_scale: float):
        cfg = scale_las_dropouts(base_cfg, dropout_scale)

        def apply_fn(params, x, lx, **kwargs):
            return las_apply(params, cfg, x, lx, **kwargs)

        apply_fn.draw = lambda batch, steps, generator, device: draw_train_noise(
            cfg, batch, steps, generator, device)
        return apply_fn

    return make_apply


def resolve_vocab(trncfgs_dict: dict):
    """Mini-vs-full vocab selection (reference src/train.py:492-510)."""
    use_mini = os.path.basename(trncfgs_dict["TRN_FOLDER"]).startswith("mini")
    if use_mini:
        dev_labels = np.load(os.path.join(trncfgs_dict["TRN_FOLDER"], "dev_labels.npy"))
        uniq = list(np.unique(dev_labels))
        vocab_map = {str(u): i for i, u in enumerate(uniq)}
        vocab_map["[PAD]"] = len(vocab_map)
        vocab = list(vocab_map.keys())
        sos_key, eos_key = "[SOS]", "[EOS]"
    else:
        vocab, vocab_map = constants.VOCAB, constants.VOCAB_MAP
        sos_key, eos_key = "<sos>", "<eos>"
    return use_mini, vocab, vocab_map, sos_key, eos_key


def _pallas_flags(las_cfg: LASConfig) -> list:
    return [name for name, v in (
        ("listener_configs.lstm_impl", las_cfg.listener.lstm_impl),
        ("speller_configs.decoder_impl", las_cfg.speller.decoder_impl),
    ) if v == "pallas"]


def check_ported(trncfgs, las_cfg: LASConfig):
    """The ``parallel:`` block: False where it is off, the number of
    data-parallel ranks (None: every visible card) for pure data
    parallelism, else a dict of the grid's degrees for tensor, sequence or
    pipeline parallelism (``{"model", "sequence", "pipeline", "data"}``).
    Raises, in the JAX CLI's order, its ``ValueError``s: tensor, sequence or
    pipeline parallelism with a kernel tier; sequence with pipeline."""
    par = getattr(trncfgs, "parallel", None)
    if par is None or not par.use:
        return False
    model_par = int(getattr(par, "model", 1) or 1)
    pipeline_mb = int(getattr(par, "pipeline", 0) or 0)
    seq_par = int(getattr(par, "sequence", 0) or 0)
    pallas_flags = _pallas_flags(las_cfg)
    if model_par > 1 and pallas_flags:
        raise ValueError(
            f"parallel: model={model_par} (tensor parallelism) "
            f"requires the scan implementations, but "
            f"{' and '.join(pallas_flags)} is 'pallas'. TP shards "
            "the LSTM gate matrices, which a fused kernel "
            "cannot consume sharded. Use the scan impls with "
            "parallel.model, or keep the kernel tiers and scale "
            "with parallel.data (DP composes with both kernel "
            "tiers).")
    data = getattr(par, "data", None)
    plan = {"model": model_par, "sequence": seq_par, "pipeline": pipeline_mb,
            "data": None if data is None else int(data)}
    if seq_par > 1:
        if pipeline_mb > 0:
            raise ValueError("parallel: sequence and pipeline are mutually exclusive "
                             "in this release")
        if pallas_flags:
            raise ValueError(
                f"parallel: sequence requires the scan implementations, "
                f"but {' and '.join(pallas_flags)} is 'pallas'. Use the "
                "scan impls with parallel.sequence, or keep the kernel "
                "tiers and scale with parallel.data alone (pure DP runs "
                "the kernels per rank).")
        return plan
    if pipeline_mb > 0:
        if pallas_flags:
            raise ValueError(
                f"parallel: pipeline requires the scan implementations, "
                f"but {' and '.join(pallas_flags)} is 'pallas'. Use the "
                "scan impls with parallel.pipeline, or keep the kernel "
                "tiers and scale with parallel.data alone (pure DP runs "
                "the kernels per rank).")
        return plan
    if model_par > 1:
        return plan
    n = data or getattr(par, "n_devices", None)
    return None if n is None else int(n)


def grid_parallelism(plan: dict, las_cfg: LASConfig, device) -> dict:
    """The Trainer's ``shard_batch`` / ``shard_state`` / ``pipeline`` for a
    grid plan of ``check_ported``, and the JAX CLI's ``[parallel]`` line."""
    model_par, seq_par = plan["model"], plan["sequence"]
    data = plan["data"]
    if seq_par > 1:
        inner = seq_par * model_par
        devices = grid_devices(device, (data or 1) * inner)
        if model_par > 1:
            grid = make_mesh_3d(data, seq_par, model_par, devices=devices)
            print(f"[parallel] 3-D mesh: data={grid.shape['data']} x seq={seq_par} x "
                  f"model={model_par} (sequence-parallel attention + tensor parallelism)")
            return {"shard_batch": shard_batch_fn(grid),
                    "shard_state": lambda st: shard_train_state(st, grid)}
        grid = make_mesh_2d(data, seq_par, axis_names=("data", "seq"), devices=devices)
        print(f"[parallel] 2-D mesh: data={grid.shape['data']} x seq={grid.shape['seq']} "
              f"(sequence-parallel attention)")
        return {"shard_batch": shard_batch_fn(grid)}
    if plan["pipeline"] > 0:
        pp_dp = int(data or 1)
        n_dev = 2 * pp_dp * model_par
        devices = grid_devices(device, n_dev)[:n_dev]
        extra = "".join([f" x dp={pp_dp}" if pp_dp > 1 else "",
                         f" x tp={model_par}" if model_par > 1 else ""])
        print(f"[parallel] 2-stage pipeline, {plan['pipeline']} microbatches" + extra
              + f" over devices {[str(d) for d in devices]}")
        return {"pipeline": {"cfg": las_cfg, "n_microbatches": plan["pipeline"],
                             "data": pp_dp, "model": model_par, "devices": devices}}
    grid = make_mesh_2d(data, model_par, devices=grid_devices(device, (data or 1) * model_par))
    print(f"[parallel] 2-D mesh: data={grid.shape['data']} x model={grid.shape['model']}")
    return {"shard_batch": shard_batch_fn(grid),
            "shard_state": lambda st: shard_train_state(st, grid)}


def export_hook(trncfgs, tgt_folder: str) -> None:
    """``export_artifact: {batch, t_pad, beam_size, average,
    data_parallel}``: the serving artifact of the best (or averaged)
    checkpoint; a failure warns, it never fails the finished run."""
    exp_cfg = getattr(trncfgs, "export_artifact", None)
    if not exp_cfg:
        return
    from attention_based_e2e_asr_dnn_tpu_torch.export import export_from_experiment

    try:
        batch = int(getattr(exp_cfg, "batch", 8))
        t_pad = int(getattr(exp_cfg, "t_pad", 512))
        out = os.path.join(tgt_folder, "artifacts", f"las-b{batch}-t{t_pad}.tlas")
        export_from_experiment(
            tgt_folder, out, batch=batch, t_pad=t_pad,
            average=bool(getattr(exp_cfg, "average", False)),
            beam_size=int(getattr(exp_cfg, "beam_size", 0)),
            data_parallel=int(getattr(exp_cfg, "data_parallel", 1)),
        )
        print(f"exported serving artifact: {out}")
    except Exception as exc:  # noqa: BLE001 - the JAX hook's contract: warn
        print(f"WARNING: export_artifact failed: {exc}", file=sys.stderr)


def main(args):
    """Train as the YAML says. Returns the ``Trainer``, or under
    ``parallel.use`` rank 0's histories (``parallel.dp.run_training``)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here; "
                           f"pass --device cpu to train on the CPU")
    cfg = load_yaml(args.config_file)
    las_cfg = las_config_from_dicts(cfg["model"]["configs"]["listener_configs"],
                                    cfg["model"]["configs"]["speller_configs"])
    n_ranks = check_ported(Config(cfg), las_cfg)
    if isinstance(n_ranks, dict):  # tensor / sequence / pipeline: this process
        return _train(None, args, n_ranks)
    return run_training(_train, args, n_ranks, build=bool(_pallas_flags(las_cfg)))


def _train(mesh, args, grid_plan: Optional[dict] = None):
    device = args.device if mesh is None else mesh.device
    print(f"device: {torch.cuda.get_device_name(device) if torch.device(device).type == 'cuda' else device}")
    trncfgs_dict = load_yaml(args.config_file)
    use_mini, vocab, vocab_map, sos_key, eos_key = resolve_vocab(trncfgs_dict)
    trncfgs_dict = inject_vocab(trncfgs_dict, vocab, vocab_map, sos_key, eos_key)
    trncfgs = Config(trncfgs_dict)
    eos_idx = trncfgs_dict["EOS_IDX"]
    sos_idx = trncfgs_dict["SOS_IDX"]
    las_cfg = las_config_from_dicts(
        trncfgs.model.configs["listener_configs"],
        trncfgs.model.configs["speller_configs"],
    )

    # wandb-or-timestamp experiment folder + config snapshot (src/train.py:519-530)
    logger, tgt_folder = open_experiment(mesh, trncfgs, trncfgs_dict)
    milestone_dir = getattr(trncfgs, "MST_FOLDER", None)

    # data
    pad_time = int(getattr(trncfgs, "pad_time_multiple", 128))
    pad_label = int(getattr(trncfgs, "pad_label_multiple", 32))
    if use_mini:
        trn_ds = ToyTrainDevDataset(trncfgs.TRN_FOLDER, "train", vocab_map)
        dev_ds = ToyTrainDevDataset(trncfgs.TRN_FOLDER, "dev", vocab_map)
    elif bool(getattr(trncfgs, "lazy_data", False)):
        # disk-backed features: each batch is assembled when it is due,
        # nothing is preloaded (the reference loads every feature into
        # memory, src/utils.py:69-76)
        from attention_based_e2e_asr_dnn_tpu_torch.data.lazy import LazyAsrTrainDevDataset

        trn_ds = LazyAsrTrainDevDataset(
            trncfgs.TRN_FOLDER, vocab_map, keep_tags=True,
            max_utterances=getattr(trncfgs, "max_utterances", None),
        )
        dev_ds = LazyAsrTrainDevDataset(
            trncfgs.DEV_FOLDER, vocab_map, keep_tags=True,
            max_utterances=getattr(trncfgs, "max_utterances", None),
        )
    else:
        trn_ds = AsrTrainDevDataset(
            std_dir=trncfgs.TRN_FOLDER, label_to_idx=vocab_map, keep_tags=True,
            max_utterances=getattr(trncfgs, "max_utterances", None),
        )
        dev_ds = AsrTrainDevDataset(
            std_dir=trncfgs.DEV_FOLDER, label_to_idx=vocab_map, keep_tags=True,
            max_utterances=getattr(trncfgs, "max_utterances", None),
        )
    trn_batcher = BucketBatcher(
        trn_ds, trncfgs.batch_size, pad_time, pad_label, label_pad_id=eos_idx,
        shuffle=True, seed=int(trncfgs.seed),
    )
    dev_batcher = BucketBatcher(
        dev_ds, trncfgs.batch_size, pad_time, pad_label, label_pad_id=eos_idx,
    )
    print(f"[data] {len(trn_batcher)} train batches, {len(dev_batcher)} dev batches")

    dtype = compute_dtype(getattr(trncfgs, "compute_dtype", "float32"))
    parallel = {} if grid_plan is None else grid_parallelism(grid_plan, las_cfg, device)
    # the beam's dev LD (eval_beam_size > 1)
    eval_beam_step = None
    eval_beam = int(getattr(trncfgs, "eval_beam_size", 0) or 0)
    if eval_beam > 1:
        eval_beam_step = make_las_eval_beam_step(
            las_cfg, beam_size=eval_beam, compute_dtype=dtype,
            length_alpha=float(getattr(trncfgs, "length_alpha", 0.0) or 0.0),
            max_len_factor=cfg_float(trncfgs, "max_len_factor", 3.0), mesh=mesh)

    trainer = Trainer(
        init_fn=lambda generator: las_init(las_cfg, generator),
        make_apply=make_las_apply_factory(las_cfg),
        trn_batcher=trn_batcher,
        dev_batcher=dev_batcher,
        trncfgs=trncfgs,
        saving_dir=tgt_folder,
        milestone_dir=milestone_dir,
        sos_idx=sos_idx,
        eos_idx=eos_idx,
        compute_dtype=dtype,
        logger=logger,
        device=device,
        eval_beam_step=eval_beam_step,
        dp_mesh=mesh,
        **parallel,
    )
    whole = trainer.whole_params()
    print(model_summary(whole, trncfgs.model.tag))
    # shape and FLOP summary on the first real batch's shapes; a wiring
    # mistake raises here, before the first epoch
    first = next(iter(trn_batcher.epoch(0)))
    print(shape_flop_summary(
        whole, las_cfg, batch=first.x.shape[0],
        time_steps=first.x.shape[1], label_len=max(first.y.shape[1] - 1, 1),
        feat_dim=first.x.shape[2],
    ))
    del whole

    trainer.train_eval(int(trncfgs.epochs))
    close_experiment(mesh, trainer, logger, tgt_folder,
                     lambda: export_hook(trncfgs, tgt_folder))
    return trainer


def build_argparser():
    parser = argparse.ArgumentParser(
        description="Training E2E Attention-Based ASR (LAS), PyTorch")
    parser.add_argument("--config-file", "-c", type=str,
                        default="./configs/base-las.yml",
                        help="filepath to the configuration file")
    parser.add_argument("--device", default="cuda", type=str,
                        help="where the model trains: cuda, cuda:N or cpu")
    return parser


if __name__ == "__main__":
    main(build_argparser().parse_args())
