"""Pipeline parallelism: the LAS graph in two stages (counterpart of the JAX
``parallel/pipeline.py``), the listener on stage 0's devices and the speller
on stage 1's, microbatches streamed through both.

One controller issues every piece: each stage's work runs on its devices
and ``Tensor.to`` carries what crosses between them. The JAX step's
semantics, kept here:

  * every microbatch's stage-0 forward is issued first (without a graph);
  * then, a microbatch at a time, stage 1's forward and backward (the
    speller's loss as a token sum), and stage 0's backward by recomputation:
    the listener's forward again under autograd, differentiated against the
    encoder output's cotangent. Only the encoder output (B_mb, T/8, 2H), its
    lengths and its cotangent cross between the stages;
  * the loss is token-weighted over the microbatches, as one big batch's;
  * the clip is the global norm across both stages, of which only two
    scalars cross (``scale = min(1, grad_norm / (norm + 1e-12))``); build
    the stages' optimizer without a clip of its own
    (``build_optimizer(..., grad_norm=1e30)``);
  * the NaN guard is a true no-op on both stages, and with accumulation it
    is checked per batch before the batch enters the accumulator;
  * ``accum_steps > 1`` accumulates the per-batch gradients inside the step
    and updates on their mean every ``accum_steps``-th call, the clip and
    the guard on the accumulated gradient (clip after accumulate); the
    window's position ``acc_count`` and the accumulators live in the state
    and are not checkpointed;
  * each microbatch draws its own randomness (one ``TrainDraws`` a
    microbatch: the listener's masks and the speller's coins and masks, the
    same masks in stage 0's forward and its recomputation); SpecAugment is
    drawn once for the global batch. With randomness quiesced (tf_rate 1,
    dropout 0, no SpecAugment) the step equals the one-device step;
  * PP x DP x TP: with ``dp`` / ``tp`` each stage runs over a (dp, tp) grid
    of the device list (``devices[:dp*tp]`` | the next ``dp*tp``): a
    microbatch's rows cut over the stage's data axis, the stage's
    parameters placed by ``parallel/mesh.py``'s tensor-parallel rule.

No kernel runs here: the JAX package refuses both kernel tiers with a
pipeline (``train.py``), and so does the port.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import draw_specaug, specaugment
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    LASConfig,
    ListenAttendSpell,
    draw_train_noise,
    listener_apply,
    speller_apply,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.shards import on_device
from attention_based_e2e_asr_dnn_tpu_torch.parallel.grid import rows_of_draws, row_slices
from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import (
    DeviceGrid,
    GridParams,
    make_mesh_2d,
    scatter_opt_state,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_loss
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import OptState, sum_of_squares
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import guarded_update


class PipelineState:
    """Each stage's parameters (``GridParams`` on its grid) and optimizer
    state, the generator the step draws from (on stage 0's first device),
    and the accumulation window: ``acc_listener`` / ``acc_speller`` (None
    between windows) and ``acc_count``."""

    def __init__(self, params_listener: GridParams, params_speller: GridParams,
                 opt_listener: OptState, opt_speller: OptState,
                 generator: Optional[torch.Generator], acc_listener=None, acc_speller=None,
                 acc_count: int = 0, step: int = 0):
        self.params_listener = params_listener
        self.params_speller = params_speller
        self.opt_listener = opt_listener
        self.opt_speller = opt_speller
        self.generator = generator
        self.acc_listener = acc_listener
        self.acc_speller = acc_speller
        self.acc_count = acc_count
        self.step = step

    def whole_params(self, device=None) -> ListenAttendSpell:
        """The whole LAS tree on ``device`` (default: stage 0's first
        device): what a checkpoint stores and the eval pass reads."""
        device = self.params_listener.grid.gather_device(0) if device is None else device
        return ListenAttendSpell({"listener": self.params_listener.whole_tree(device),
                                  "speller": self.params_speller.whole_tree(device)})


def _stage_grids(devices: Sequence, dp: int, tp: int):
    """Stage 0's and stage 1's (dp, tp) grids over the device list."""
    dp, tp = max(dp, 1), max(tp, 1)
    group = dp * tp
    if len(devices) < 2 * group:
        raise ValueError(f"pipeline x (dp={dp} x tp={tp}) needs 2*dp*tp = {2 * group} "
                         f"devices, got {len(devices)}")
    devices = list(devices)
    return (make_mesh_2d(dp, tp, devices=devices[:group]),
            make_mesh_2d(dp, tp, devices=devices[group:2 * group]))


def place_pipeline_state(params: ListenAttendSpell, opt, generator, devices: Sequence,
                         dp: int = 1, tp: int = 1, opt_listener: Optional[OptState] = None,
                         opt_speller: Optional[OptState] = None) -> PipelineState:
    """The listener on stage 0's grid and the speller on stage 1's (with
    ``tp > 1`` column-sharded there by the tensor-parallel rule), each
    with its optimizer state (fresh from ``opt`` unless given whole, one
    tensor a parameter, in the stage module's order)."""
    g0, g1 = _stage_grids(devices, dp, tp)
    p_l = GridParams(params["listener"], g0)
    p_s = GridParams(params["speller"], g1)

    def laid(gp: GridParams, whole: Optional[OptState]) -> OptState:
        return opt.init(gp.tensors()) if whole is None else scatter_opt_state(gp, whole)

    return PipelineState(p_l, p_s, laid(p_l, opt_listener), laid(p_s, opt_speller), generator)


def init_pipeline_state(params: ListenAttendSpell, opt, seed: int, devices: Sequence,
                        dp: int = 1, tp: int = 1) -> PipelineState:
    """A ``las_init`` parameter module split into placed per-stage state,
    the step's generator seeded with ``seed`` on stage 0's first device."""
    g0, _ = _stage_grids(devices, dp, tp)
    generator = torch.Generator(device=g0.gather_device(0)).manual_seed(seed)
    return place_pipeline_state(params, opt, generator, devices, dp, tp)


def _stage_rows(grid: DeviceGrid, gp: GridParams, fn: Callable, batch: int, *tensors):
    """``fn(view, *row tensors, row device, rows)`` for each data row of a
    stage, its outputs' tensors put together on the stage's first device."""
    home = grid.gather_device(0)
    outs = []
    for d, rows in enumerate(row_slices(batch, grid)):
        dev = grid.gather_device(d)
        outs.append(fn(gp.view(d), *(t[rows].to(dev) for t in tensors), dev, rows))
    return tuple(torch.cat([o[i].to(home) for o in outs]) for i in range(len(outs[0])))


def make_pipeline_train_step(cfg: LASConfig, opt, devices: Sequence, n_microbatches: int = 2,
                             compute_dtype=torch.float32, grad_norm: float = 0.0,
                             accum_steps: int = 1, use_specaug: bool = False,
                             specaug_freq: int = 6, specaug_time: int = 200,
                             specaug_iid: bool = False, nan_guard: bool = True,
                             dp: int = 1, tp: int = 1) -> Callable:
    """The two-stage step: ``step(state, x, lx, y, ly, tf_rate, lr) ->
    (state, metrics)`` with the JAX step's metrics (``loss``, ``ppl``,
    ``n_tokens``, ``grad_norm``, ``finite``); the global batch is cut into
    ``n_microbatches`` along its rows. The state must be placed with the same
    ``devices``, ``dp`` and ``tp`` (``init_pipeline_state``)."""
    g0, g1 = _stage_grids(devices, dp, tp)
    home0, home1 = g0.gather_device(0), g1.gather_device(0)
    dp = max(dp, 1)

    def listener(view, x, lx, dev, rows, draws, batch):
        part = rows_of_draws(draws, rows, dev, batch)
        enc_h, enc_l = listener_apply(view, cfg.listener, x.to(compute_dtype), lx, train=True,
                                      masks=part.listener_masks)
        return enc_h, enc_l

    def speller(view, enc_h, enc_l, y, ly, dev, rows, draws, batch, tf_rate):
        part = rows_of_draws(draws, rows, dev, batch)
        out = speller_apply(view, cfg.speller, enc_h, enc_l, y, tf_rate=tf_rate, train=True,
                            draws=part)
        return out.logits, y, ly

    def stage0(state, x, lx, draws, mb):
        return _stage_rows(g0, state.params_listener,
                           lambda v, xs, ls, dev, rows: listener(v, xs, ls, dev, rows, draws, mb),
                           mb, x, lx)

    def step(state: PipelineState, x, lx, y, ly, tf_rate, lr):
        batch = x.shape[0]
        if batch % n_microbatches:
            raise ValueError(f"batch {batch} not divisible by {n_microbatches} microbatches")
        mb = batch // n_microbatches
        if mb % dp:
            raise ValueError(f"microbatch {mb} not divisible by dp={dp} (stage-mesh batch "
                             "sharding needs equal shards)")
        gen = state.generator
        x, lx = x.to(home0), lx.to(home0)
        if use_specaug:
            x = specaugment(x, draw_specaug(batch, specaug_freq, specaug_time, specaug_iid,
                                            gen, gen.device))
        slices = [slice(i * mb, (i + 1) * mb) for i in range(n_microbatches)]
        draws = [draw_train_noise(cfg, mb, y.shape[1], gen, gen.device) for _ in slices]
        ls_params = state.params_listener.tensors()
        sp_params = state.params_speller.tensors()

        # fill the pipe: every microbatch's stage-0 forward, no graph kept
        with torch.no_grad():
            encs = [stage0(state, x[sl], lx[sl], draws[i], mb) for i, sl in enumerate(slices)]

        loss_sum = torch.zeros((), device=home0)
        tok_sum = torch.zeros((), device=home0)
        g_ls_acc = g_sp_acc = None
        for i, sl in enumerate(slices):
            enc_h = encs[i][0].to(home1).requires_grad_(True)
            enc_l = encs[i][1].to(home1)
            yi, lyi = y[sl].to(home1), ly[sl].to(home1)
            with torch.enable_grad():
                logits, ys, lys = _stage_rows(
                    g1, state.params_speller,
                    lambda v, eh, el, yy, ll, dev, rows: speller(
                        v, eh, el, yy, ll, dev, rows, draws[i], mb, tf_rate),
                    mb, enc_h, enc_l, yi, lyi)
                loss, n_tok = masked_ce_loss(logits, ys, lys)
                grads = torch.autograd.grad(loss * n_tok, sp_params + [enc_h],
                                            allow_unused=True)
            g_sp = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, sp_params)]
            d_enc = grads[-1].to(home0)
            # stage 0's backward: its forward again under autograd
            with torch.enable_grad():
                enc_again = stage0(state, x[sl], lx[sl], draws[i], mb)[0]
                g_ls = torch.autograd.grad(enc_again, ls_params, d_enc, allow_unused=True)
            g_ls = [torch.zeros_like(p) if g is None else g for g, p in zip(g_ls, ls_params)]
            loss_sum = loss_sum + (loss * n_tok).detach().to(home0)
            tok_sum = tok_sum + n_tok.to(home0)
            g_sp_acc = g_sp if g_sp_acc is None else [a + b for a, b in zip(g_sp_acc, g_sp)]
            g_ls_acc = g_ls if g_ls_acc is None else [a + b for a, b in zip(g_ls_acc, g_ls)]

        # the token mean, as the one-device loss takes it
        inv = 1.0 / tok_sum
        g_sp_acc = [g * on_device(inv, g.device) for g in g_sp_acc]
        g_ls_acc = [g * on_device(inv, g.device) for g in g_ls_acc]
        loss = loss_sum * inv

        # the batch's global norm across both stages: two scalars cross
        gnorm_batch = torch.sqrt(sum_of_squares(g_ls_acc) + sum_of_squares(g_sp_acc).to(home0))
        ok_batch = torch.isfinite(gnorm_batch) if nan_guard else torch.ones((), dtype=torch.bool,
                                                                             device=home0)
        if nan_guard and accum_steps > 1:
            g_ls_acc = [torch.where(on_device(ok_batch, g.device), g, 0.0) for g in g_ls_acc]
            g_sp_acc = [torch.where(on_device(ok_batch, g.device), g, 0.0) for g in g_sp_acc]

        if accum_steps > 1:
            # the window's mean of the batches' token-mean gradients
            acc_ls = [g / accum_steps for g in g_ls_acc]
            acc_sp = [g / accum_steps for g in g_sp_acc]
            if state.acc_listener is not None:
                acc_ls = [a + b for a, b in zip(state.acc_listener, acc_ls)]
                acc_sp = [a + b for a, b in zip(state.acc_speller, acc_sp)]
            if (state.acc_count + 1) % accum_steps != 0:
                # mid-window: keep the accumulators, no update; the metrics
                # report this batch
                state.acc_listener, state.acc_speller = acc_ls, acc_sp
                state.acc_count += 1
                return state, {"loss": loss, "ppl": torch.exp(loss), "n_tokens": tok_sum,
                               "grad_norm": gnorm_batch, "finite": ok_batch}
            g_ls_acc, g_sp_acc = acc_ls, acc_sp
            gnorm = torch.sqrt(sum_of_squares(g_ls_acc) + sum_of_squares(g_sp_acc).to(home0))
            ok = torch.isfinite(gnorm) if nan_guard else torch.ones_like(ok_batch)
        else:
            gnorm, ok = gnorm_batch, ok_batch
        if grad_norm and grad_norm > 0.0:
            scale = torch.clamp(grad_norm / (gnorm + 1e-12), max=1.0)
            g_ls_acc = [g * on_device(scale, g.device) for g in g_ls_acc]
            g_sp_acc = [g * on_device(scale, g.device) for g in g_sp_acc]
        state.opt_speller = guarded_update(opt, sp_params, g_sp_acc, state.opt_speller, lr,
                                           ok.to(home1))
        state.opt_listener = guarded_update(opt, ls_params, g_ls_acc, state.opt_listener, lr,
                                            ok)
        state.acc_listener = state.acc_speller = None
        state.acc_count = 0
        state.step += 1
        return state, {"loss": loss, "ppl": torch.exp(loss), "n_tokens": tok_sum,
                       "grad_norm": gnorm, "finite": ok}

    return step
