"""The train and eval steps of one controller over a ``DeviceGrid``
(``parallel/mesh.py``): tensor parallelism (``model``), sequence parallelism
(``seq``) and their data rows (``data``), alone or together. The JAX package
runs these as GSPMD programs over a sharded ``TrainState``; its step is the
one-device step, partitioned. Here the step says where each piece runs:

  * the global batch is cut into the data axis's row blocks (the JAX shard
    order; a batch the rows cannot split raises the JAX message), and data
    row d runs the model on its block with ``GridParams.view(d)``: its
    copies of the replicated parameters on its gather device and of each
    column-sharded one on its model devices;
  * with a ``seq`` axis, the speller's attention cache is cut along time
    over the row's seq devices (``parallel/sequence.py``);
  * the rows' logits meet on the grid's first device, where the masked
    token-mean cross-entropy of the whole batch is taken, as the one-device
    step takes it; its gradient reaches each master through the ``.to``
    copies, so the rows' gradients add up there;
  * the random draws are the one-device step's: SpecAugment's and the
    model's, for the whole batch from the state's generator, each row then
    taking its rows of them; so a grid step equals the one-device step on
    the same generator state, up to the order of float sums;
  * the clip, the NaN guard, gradient accumulation and the optimizer are the
    one-device step's (``training/steps.py``), over the masters wherever
    they lie.

The apply function is the Trainer's (``apply_fn(params, x, lx, **kw)``); for
a train step it carries ``apply_fn.draw(batch, steps, generator, device)``,
the model's own draw of one training pass (``train.make_las_apply_factory``,
``lmtrain.make_rewriter_apply_factory``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import (
    SpecAugDraws,
    draw_specaug,
    specaugment,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import DeviceGrid, row_block
from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_loss
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import Optimizer
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
    _cast_features,
    apply_update,
    param_grads,
)


def row_slices(batch: int, grid: DeviceGrid) -> List[slice]:
    """The data axis's row blocks of a global batch of ``batch`` rows."""
    n = grid.axis_size("data")
    return [row_block(batch, d, n) for d in range(n)]


def _rows_of(t, rows: slice, device, dim: int = 0):
    if t is None:
        return None
    index = (slice(None),) * dim + (rows,)
    return t[index].to(device)


def rows_of_draws(draws, rows: slice, device, batch: int):
    """Rows ``rows`` of a whole batch's ``TrainDraws`` on ``device``: the
    listener's (or encoder's) masks and m1 / m2 cut by row, the coins
    shared, SpecAugment's (B,) draws cut and its (1,) ones shared."""
    spec = draws.specaug
    if spec is not None:
        spec = SpecAugDraws(*(t.to(device) if t.shape[0] != batch else t[rows].to(device)
                              for t in spec))
    return draws._replace(
        listener_masks=[_rows_of(m, rows, device) for m in draws.listener_masks],
        coins=draws.coins.to(device),
        m1=_rows_of(draws.m1, rows, device, 1),
        m2=_rows_of(draws.m2, rows, device, 1),
        specaug=spec)


def _cache_hook(grid: DeviceGrid, row: int):
    """The hook that cuts row ``row``'s attention cache over its seq devices
    (None without a seq axis)."""
    if grid.axis_size("seq") <= 1:
        return {}
    from attention_based_e2e_asr_dnn_tpu_torch.parallel.sequence import shard_cache_over_time

    devices = grid.seq_devices(row)
    return {"cache_hook": lambda cache: shard_cache_over_time(cache, devices)}


def make_grid_train_step(apply_fn, opt: Optimizer, grid: DeviceGrid, accum_steps: int = 1,
                         compute_dtype=torch.float32, use_specaug: bool = False,
                         specaug_freq: int = 6, specaug_time: int = 200,
                         specaug_iid: bool = False, nan_guard: bool = True):
    """The train step over ``grid`` for a state placed by
    ``parallel.mesh.shard_train_state``; the one-device step's signature
    and metrics:

        step(state, x, lx, y, ly, tf_rate, lr, init_force=False, draws=None)
            -> (state, metrics, att_map)

    ``draws`` (the whole batch's, ``models.las.TrainDraws`` with its
    ``specaug``) replays a given draw; by default the step draws them from
    ``state.generator`` as the one-device step does."""
    if accum_steps != opt.accum_steps:
        raise ValueError(f"accum_steps {accum_steps} differs from the optimizer's "
                         f"{opt.accum_steps}")
    home = grid.gather_device(0)

    def step(state, x, lx, y, ly, tf_rate, lr, init_force: bool = False, draws=None):
        batch = x.shape[0]
        slices = row_slices(batch, grid)
        gen = state.generator
        if draws is None:
            spec = (draw_specaug(batch, specaug_freq, specaug_time, specaug_iid, gen, gen.device)
                    if use_specaug else None)
            draws = apply_fn.draw(batch, y.shape[1], gen, gen.device)._replace(specaug=spec)
        logits, att_map = [], None
        for d, rows in enumerate(slices):
            dev = grid.gather_device(d)
            part = rows_of_draws(draws, rows, dev, batch)
            xd = x[rows].to(dev)
            if use_specaug:
                xd = specaugment(xd, part.specaug)
            out = apply_fn(state.params.view(d), _cast_features(xd, compute_dtype),
                           lx[rows].to(dev), dec_y=y[rows].to(dev), tf_rate=tf_rate,
                           init_force=init_force, train=True, draws=part,
                           **_cache_hook(grid, d))
            logits.append(out.logits.to(home))
            if att_map is None:
                att_map = out.att_map.detach().to(home)
        loss, n_tokens = masked_ce_loss(torch.cat(logits), y.to(home), ly.to(home))
        params = state.params.tensors()
        grads = param_grads(loss, params)
        grad_norm, ok = apply_update(state, opt, params, grads, lr, nan_guard)
        metrics = {"loss": loss.detach(), "ppl": torch.exp(loss.detach()),
                   "grad_norm": grad_norm, "n_tokens": n_tokens, "finite": ok}
        return state, metrics, att_map

    return step


def make_grid_eval_step(apply_fn, grid: DeviceGrid, compute_dtype=torch.float32):
    """The free-running eval step over ``grid`` (``GridParams`` in place of
    the module), the one-device eval step's loss and ids:

        step(params, x, lx, y, ly) -> ({"loss", "ppl", "n_tokens"}, ids)"""
    home = grid.gather_device(0)

    @torch.inference_mode()
    def step(params, x, lx, y, ly):
        logits = []
        for d, rows in enumerate(row_slices(x.shape[0], grid)):
            dev = grid.gather_device(d)
            out = apply_fn(params.view(d), _cast_features(x[rows].to(dev), compute_dtype),
                           lx[rows].to(dev), **_cache_hook(grid, d))
            logits.append(out.logits.to(home))
        logits = torch.cat(logits)
        n = min(logits.shape[1], y.shape[1])
        loss, n_tokens = masked_ce_loss(logits[:, :n], y[:, :n].to(home),
                                        torch.clamp(ly.to(home), max=n))
        pred_ids = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"loss": loss, "ppl": torch.exp(loss), "n_tokens": n_tokens}, pred_ids

    return step


def grid_devices(device, need: int, devices: Optional[list] = None) -> list:
    """The devices a CLI's grid of ``need`` positions runs on: the visible
    cards for ``cuda`` (the grid's own refusal names a shortfall), every
    position the CPU for ``cpu``."""
    if devices is not None:
        return list(devices)
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * need
    from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import visible_devices

    return visible_devices()
