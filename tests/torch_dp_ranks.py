"""Rank functions of ``tests/test_torch_dp.py`` and ``tests/test_torch_dp_cli.py``.

``parallel.dp.spawn`` starts each rank as a process of its own that imports
the rank's function by its module's name, so this module imports torch,
numpy and the port only, never JAX: the tests compute the JAX side in the
parent process and hand the ranks numpy arrays."""

from __future__ import annotations

import os

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import SpecAugDraws
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.parallel import dp, multihost
from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import shard_rows
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training import steps as tsteps

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Draws across the process boundary
# ---------------------------------------------------------------------------

def draws_to_numpy(d: tlas.TrainDraws):
    """A ``TrainDraws`` as nested tuples of numpy arrays (None kept)."""
    arr = lambda t: None if t is None else t.numpy()  # noqa: E731
    spec = None if d.specaug is None else tuple(t.numpy() for t in d.specaug)
    return ([arr(m) for m in d.listener_masks], arr(d.coins), arr(d.m1), arr(d.m2), spec)


def draws_from_numpy(n) -> tlas.TrainDraws:
    masks, coins, m1, m2, spec = n
    ten = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return tlas.TrainDraws([ten(m) for m in masks], ten(coins), ten(m1), ten(m2),
                           None if spec is None else SpecAugDraws(*map(ten, spec)))


def _state_leaves(state) -> list:
    """Every tensor of the parameters and the optimizer state, as numpy."""
    out = [p.detach().cpu().numpy().copy() for p in state.params.parameters()]
    for leaf in state.opt_state:
        if torch.is_tensor(leaf):
            out.append(leaf.cpu().numpy().copy())
        elif leaf is not None:
            out.extend(t.cpu().numpy().copy() for t in leaf)
    return out


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def _apply(cfg):
    def apply_fn(p, x, lx, **kwargs):
        return tlas.las_apply(p, cfg, x, lx, **kwargs)
    return apply_fn


def train_steps(mesh, params, cfg, opt_configs, batch, steps, use_specaug=False,
                specaug_time=200, seed=0, opt_start=None, nan_rows=None, grad_norm=5.0,
                accum_steps=1):
    """The DP train step on this rank's rows of ``batch`` (global numpy
    arrays x, lx, y, ly), once for each (tf_rate, lr, draws for each rank or
    None) of ``steps``, accumulating ``accum_steps`` steps' gradients an
    update. ``opt_start``: optax leaves (count, mu, nu, nu_max) to start
    from. ``nan_rows``: before the last step, a NaN is planted in these
    global rows. Returns the metrics of every step, the parameters as the
    JAX tree, the state's leaves and the first row's attention map."""
    rows = shard_rows(batch[0].shape[0], mesh)
    module = tlas.las_from_jax_params(params)
    opt = toptim.build_optimizer("adamw", opt_configs, grad_norm=grad_norm,
                                 accum_steps=accum_steps)
    state = tsteps.create_train_state(module, opt, seed=seed, device=mesh.device)
    if opt_start is not None:
        state.opt_state = toptim.opt_state_from_optax(state.params, *opt_start)
    step = dp.make_dp_train_step(_apply(cfg), opt, mesh, accum_steps=accum_steps,
                                 use_specaug=use_specaug, specaug_time=specaug_time)
    x, lx, y, ly = (torch.from_numpy(np.ascontiguousarray(a[rows])) for a in batch)
    metrics, before = [], None
    for i, (tf_rate, lr, draws) in enumerate(steps):
        xi = x
        if nan_rows is not None and i == len(steps) - 1:
            before = _state_leaves(state)
            xi = x.clone()
            for r in nan_rows:
                if rows.start <= r < rows.stop:
                    xi[r - rows.start, 0, 0] = float("nan")
        d = None if draws is None else draws_from_numpy(draws[mesh.rank])
        state, m, att = step(state, xi, lx, y, ly, tf_rate, lr, draws=d)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": tlas.las_to_jax_params(state.params),
            "leaves": _state_leaves(state), "before": before, "att": att.numpy(),
            "seed": None if state.shard_generator is None
            else int(state.shard_generator.initial_seed())}


def eval_steps(mesh, params, cfg, batch, beam_size=4):
    """The DP eval step and the eval beam step with the mesh on this rank's
    rows: each one's metrics and the global batch's ids."""
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import make_las_eval_beam_step

    rows = shard_rows(batch[0].shape[0], mesh)
    module = tlas.las_from_jax_params(params)
    x, lx, y, ly = (torch.from_numpy(np.ascontiguousarray(a[rows])) for a in batch)
    metrics, local = dp.make_dp_eval_step(_apply(cfg), mesh)(module, x, lx, y, ly)
    b_metrics, b_ids = make_las_eval_beam_step(cfg, beam_size, mesh=mesh)(module, x, lx, y, ly)
    as_floats = lambda m: {k: float(v) for k, v in m.items()}  # noqa: E731
    return (as_floats(metrics), dp.gather_rows(mesh, local), as_floats(b_metrics),
            b_ids.numpy())


def multihost_sum(mesh, global_batch):
    """Each rank loads its ``process_slice`` of ``global_batch``; the sum of
    the placed slices, all-reduced."""
    sl = multihost.process_slice(global_batch.shape[0])
    (local,) = multihost.shard_batch_multihost(mesh, [global_batch[sl]])
    total = dp.all_reduce_sum(local.sum().reshape(1), mesh)
    return sl.start, sl.stop, float(total[0]), str(local.device)


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------

def trainer_files(mesh, corpus, root, trn_cfg, cfg):
    """One epoch of a DP Trainer writing into ``root/rank<r>``; the files
    each rank's folder holds afterwards, and the dev history."""
    from attention_based_e2e_asr_dnn_tpu_torch import constants
    from attention_based_e2e_asr_dnn_tpu_torch.config import Config
    from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
    from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import AsrTrainDevDataset
    from attention_based_e2e_asr_dnn_tpu_torch.train import make_las_apply_factory
    from attention_based_e2e_asr_dnn_tpu_torch.training.trainer import Trainer

    sets = [AsrTrainDevDataset(std_dir=os.path.join(corpus, split),
                               label_to_idx=constants.VOCAB_MAP, keep_tags=True)
            for split in ("train-clean-100", "dev-clean")]
    trn = BucketBatcher(sets[0], 8, 64, 32, label_pad_id=29, shuffle=True, seed=3)
    dev = BucketBatcher(sets[1], 8, 64, 32, label_pad_id=29)
    folder = os.path.join(root, f"rank{mesh.rank}")
    trainer = Trainer(init_fn=lambda g: tlas.las_init(cfg, g),
                      make_apply=make_las_apply_factory(cfg), trn_batcher=trn,
                      dev_batcher=dev, trncfgs=Config(trn_cfg), saving_dir=folder,
                      milestone_dir=os.path.join(folder, "milestones"), device="cpu",
                      dp_mesh=mesh)
    trainer.train_eval(1)
    trainer.save(os.path.join(folder, "ckpts", "last.ckpt"))
    files = sorted(os.path.relpath(os.path.join(d, f), folder)
                   for d, _, fs in os.walk(folder) for f in fs) if os.path.isdir(folder) else []
    return files, trainer.dev_history
