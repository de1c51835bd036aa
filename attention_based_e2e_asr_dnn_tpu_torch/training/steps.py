"""Train, eval and inference steps (counterpart of the JAX
``training/steps.py``).

PyTorch runs eagerly, so there is no ``jit``; a step is a plain function.

The train step: SpecAugment on the device, the model under autograd in the
compute dtype with float32 parameters (their casts stay in the graph, so the
gradients arrive in float32), the masked cross-entropy, the global gradient
norm, and the optimizer of ``training/optim.py`` with the learning rate and
the teacher-forcing rate as runtime scalars. With ``nan_guard`` a step whose
gradient norm is not finite is a true no-op: parameters and the whole
optimizer state, its count included, keep their values. That choice is made
with ``torch.where`` on device tensors, and the metrics stay device tensors,
so the step itself never waits for the device. Parameters are updated in
place. A running profiler sees the step's layers as spans
(``utils/profiling.py::span``): ``las.train_step`` around the whole step,
``las.specaug``, ``las.loss``, ``las.backward`` and ``las.optimizer``.

The eval and inference steps run under ``torch.inference_mode``: features
are cast to the compute dtype (integer inputs pass through), the model
free-runs for ``CHR_MAX_STEPS`` steps, and greedy ids come back for the
host-side Levenshtein pass or the transcript.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import draw_specaug, specaugment
from attention_based_e2e_asr_dnn_tpu_torch.ops.shards import on_device
from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_loss
from attention_based_e2e_asr_dnn_tpu_torch.training.optim import (
    Optimizer,
    OptState,
    global_norm,
)
from attention_based_e2e_asr_dnn_tpu_torch.utils.profiling import span


def _cast_features(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Cast float features to the compute dtype; integer inputs (the
    Rewriter's char ids) pass through untouched."""
    return x.to(compute_dtype) if x.is_floating_point() else x


class TrainState:
    """What a train step carries: the parameter module (updated in place),
    the optimizer state, the generator the step draws its noise from (on the
    parameters' device), and the update counter."""

    def __init__(self, params: torch.nn.Module, opt_state: OptState,
                 generator: Optional[torch.Generator], step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.generator = generator
        self.step = step
        # a data-parallel rank's own stream, seeded by the generator's seed
        # and the rank (``parallel/dp.py``), made at its first step
        self.shard_generator: Optional[torch.Generator] = None


def create_train_state(params: torch.nn.Module, opt: Optimizer, seed: int = 0,
                       device: str = "cuda") -> TrainState:
    """Move ``params`` to ``device`` (the card unless the caller asks for the
    CPU; no card raises) and build a fresh optimizer state and a generator
    seeded with ``seed`` there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_train_state: no CUDA device; training runs on "
                           "the card unless device='cpu' is asked for")
    params = params.to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(params, opt.init(params.parameters()), generator)


def make_train_step(apply_fn, opt: Optimizer, accum_steps: int = 1,
                    compute_dtype=torch.float32, use_specaug: bool = False,
                    specaug_freq: int = 6, specaug_time: int = 200,
                    specaug_iid: bool = False, nan_guard: bool = True):
    """Build the train step.

    ``apply_fn(params, x, lx, dec_y=, tf_rate=, init_force=, train=True,
    draws=, generator=)`` returns an object with ``.logits`` and
    ``.att_map`` (``las_apply`` with its config bound). It takes the pass's
    randomness from ``draws`` or, where that is None, draws it from
    ``generator``.

        step(state, x, lx, y, ly, tf_rate, lr, init_force=False, draws=None)
            -> (state, metrics, att_map)

    ``y`` has <sos> already stripped. ``draws`` (``models.las.TrainDraws``,
    its ``specaug`` field included) replays a given draw; by default every
    random number comes from ``state.generator``. ``metrics``: ``loss``,
    ``ppl``, ``grad_norm`` (before clipping), ``n_tokens``, ``finite``, all
    device tensors."""
    if accum_steps != opt.accum_steps:
        raise ValueError(f"accum_steps {accum_steps} differs from the optimizer's "
                         f"{opt.accum_steps}")

    def step(state: TrainState, x, lx, y, ly, tf_rate, lr,
             init_force: bool = False, draws: Any = None):
        with span("las.train_step"):
            params = list(state.params.parameters())
            if use_specaug:
                with span("las.specaug"):
                    spec = (draws.specaug if draws is not None else
                            draw_specaug(x.shape[0], specaug_freq, specaug_time, specaug_iid,
                                         state.generator, x.device))
                    x = specaugment(x, spec)
            out = apply_fn(state.params, _cast_features(x, compute_dtype), lx, dec_y=y,
                           tf_rate=tf_rate, init_force=init_force, train=True,
                           draws=draws, generator=state.generator)
            with span("las.loss"):
                loss, n_tokens = masked_ce_loss(out.logits, y, ly)
            grads = param_grads(loss, params)
            grad_norm, ok = apply_update(state, opt, params, grads, lr, nan_guard)
            metrics = {"loss": loss.detach(), "ppl": torch.exp(loss.detach()),
                       "grad_norm": grad_norm, "n_tokens": n_tokens, "finite": ok}
            return state, metrics, out.att_map.detach()

    return step


def param_grads(loss: torch.Tensor, params: list) -> list:
    """The gradient of ``loss`` for each of ``params`` (zeros where unused)."""
    with span("las.backward"):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


@torch.no_grad()
def apply_update(state: TrainState, opt: Optimizer, params: list, grads: list, lr,
                 nan_guard: bool = True):
    """The optimizer step on ``grads``, in place, behind the NaN guard; the
    step counter advances. Returns (grad_norm, finite) as device tensors."""
    with span("las.optimizer"):
        grad_norm = global_norm(grads)
        ok = torch.isfinite(grad_norm)
        if not nan_guard:
            ok = torch.ones_like(ok)
        state.opt_state = guarded_update(opt, params, grads, state.opt_state, lr,
                                         ok if nan_guard else None)
    state.step += 1
    return grad_norm, ok


@torch.no_grad()
def guarded_update(opt: Optimizer, params: list, grads: list, opt_state: OptState, lr,
                   ok=None) -> OptState:
    """``opt``'s update of ``params`` in place; returns the new optimizer
    state. With ``ok`` (a 0-d bool tensor) the update is a true no-op where
    ``ok`` is False: a zero update AND the previous optimizer state, or
    stale momentum and the decoupled weight decay would still move the
    parameters. The parameters may lie on several devices."""
    if ok is None:
        updates, new_state = opt.update(grads, opt_state, params, lr)
    else:
        grads = [torch.where(on_device(ok, g.device), g, 0.0) for g in grads]
        updates, new_state = opt.update(grads, opt_state, params, lr)
        updates = [torch.where(on_device(ok, u.device), u, 0.0) for u in updates]
        new_state = OptState(*(
            None if new is None else
            torch.where(on_device(ok, new.device), new, old) if torch.is_tensor(new) else
            [torch.where(on_device(ok, n.device), n, o) for n, o in zip(new, old)]
            for new, old in zip(new_state, opt_state)))
    for p, u in zip(params, updates):
        p.add_(u)
    return new_state


def make_eval_step(apply_fn, compute_dtype=torch.float32):
    """The free-running eval step (reference: src/train.py:199-258).

    ``apply_fn(params, x, lx)`` returns an object with ``.logits``
    (``las_apply`` with its config bound). The loss is taken on logits and
    labels truncated to the shorter horizon.

        step(params, x, lx, y, ly) -> ({"loss", "ppl", "n_tokens"}, ids)
    """

    @torch.inference_mode()
    def step(params, x, lx, y, ly):
        logits = apply_fn(params, _cast_features(x, compute_dtype), lx).logits
        n = min(logits.shape[1], y.shape[1])
        loss, n_tokens = masked_ce_loss(logits[:, :n], y[:, :n],
                                        torch.clamp(ly, max=n))
        pred_ids = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"loss": loss, "ppl": torch.exp(loss), "n_tokens": n_tokens}, pred_ids

    return step


def make_infer_step(apply_fn, compute_dtype=torch.float32):
    """Greedy inference step: (params, x, lx) -> ids (B, CHR_MAX_STEPS)
    int32, the argmax of the logits in the compute dtype."""

    @torch.inference_mode()
    def step(params, x, lx):
        logits = apply_fn(params, _cast_features(x, compute_dtype), lx).logits
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return step
