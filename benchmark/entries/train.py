"""The training entry: the port's train step (``training/steps.py::
make_train_step``, AdamW amsgrad after the clip, SpecAugment and dropout on,
bfloat16 compute, both kernel tiers) driven over the mix's batches, which
live on the card, in a seeded shuffled order pass after pass.

Set-up builds the kernels (``ops/cuda_build.py::build_for``), the weights
(``benchmark/weights.py``, the leaves of the configuration's family,
``harness.family``), the state and the step, then runs the first
``checked_steps`` steps of the order through the step, on batches that all
differ, keeping their losses, the first step's gradient (from the first
moment) and the parameters' change; then one step of every batch shape not
yet run. The window then steps on from that same state, in whole passes over
every batch, each pass in a fresh order, until the run's seconds are up, and
ends in a synchronize; a traced run profiles the window's first pass. After
it the state is freed and the family's reference follows the checked steps
from the same weights, batches and draws. Every random number of a step
(SpecAugment, dropout, the teacher-forcing coins) is drawn here on the card
and handed to the step.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import List, NamedTuple

import torch
from torch.profiler import record_function

from benchmark import checks, harness, mixes, traces, weights


class SpecDraws(NamedTuple):
    """SpecAugment's draws in the port's field names: widths in [0, param),
    unit starts in [0, 1), one mask shared by the batch."""
    freq_width: torch.Tensor
    freq_start: torch.Tensor
    time_width: torch.Tensor
    time_start: torch.Tensor


SPECAUG_FREQ, SPECAUG_TIME = 6, 200


def draw_step(model: dict, rates: list, batch: int, steps: int, gen: torch.Generator, device,
              draws_type):
    """One training pass's randomness, in the port's ``TrainDraws`` layout;
    ``rates``: the listener layers' dropout rates (the family's)."""
    lc, sc = model["listener_configs"], model["speller_configs"]
    width = lc["uniform_hid_dim"] * (2 if lc["bidirectional"] else 1)

    def keep(shape, rate):
        return torch.rand(shape, generator=gen, device=device) < (1.0 - rate)

    masks = [keep((batch, 1, width), r) if r > 0 else None for r in rates]
    coins = torch.rand((steps,), generator=gen, device=device)
    rate = sc["dec_lstm_dropout"]
    m1 = keep((steps, batch, sc["dec_lstm_hid_dim"]), rate) if rate > 0 else None
    m2 = keep((steps, batch, sc["dec_lstm_out_dim"]), rate) if rate > 0 else None
    unit = [torch.rand((1,), generator=gen, device=device) for _ in range(4)]
    spec = SpecDraws(unit[0] * SPECAUG_FREQ, unit[1], unit[2] * SPECAUG_TIME, unit[3])
    return draws_type(masks, coins, m1, m2, spec)


def launch_snapshot():
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda, speller_cuda
    return {**lstm_cuda.LAUNCHES, **speller_cuda.LAUNCHES}


class Program(NamedTuple):
    step: object
    state: object
    names: List[str]


def build_program(run: harness.Run, flat) -> Program:
    """The port's train state and step over the weights ``flat``."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        ListenAttendSpell, las_apply, las_config_from_dicts)
    from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
    from attention_based_e2e_asr_dnn_tpu_torch.training.optim import build_optimizer
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
        create_train_state, make_train_step)

    cfg_json = run.cell.config
    model = cfg_json["model"]
    cfg = las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    cuda_build.build_for(run.device, cfg.listener.lstm_impl, cfg.speller.decoder_impl)
    params = ListenAttendSpell(weights.nest(flat))
    opt_cfg = cfg_json["optimizer"]
    opt = build_optimizer(opt_cfg["name"], opt_cfg["configs"], grad_norm=cfg_json["grad_norm"])
    state = create_train_state(params, opt, seed=mixes.sub_seed(run.seed, 4),
                               device=str(run.device))

    def apply_fn(p, x, lx, **kwargs):
        return las_apply(p, cfg, x, lx, **kwargs)

    dtype = getattr(torch, cfg_json["compute_dtype"])
    step = make_train_step(apply_fn, opt, compute_dtype=dtype,
                           use_specaug=cfg_json["use_specaug"])
    names = [n for n, _ in state.params.named_parameters()]
    return Program(step, state, names)


def planted(step, faults):
    """The step with faults planted underneath it (the benchmark's own
    tests): ``frozen`` returns the state as it was; ``half_batch`` steps on
    the first half of the rows only."""
    if not faults:
        return step

    def broken(state, x, lx, y, ly, tf_rate, lr, draws=None):
        if "half_batch" in faults:
            h = x.shape[0] // 2
            x, lx, y, ly = x[:h], lx[:h], y[:h], ly[:h]
            draws = draws._replace(
                listener_masks=[None if m is None else m[:h] for m in draws.listener_masks],
                m1=None if draws.m1 is None else draws.m1[:, :h],
                m2=None if draws.m2 is None else draws.m2[:, :h])
        if "frozen" in faults:
            before = [p.detach().clone() for p in state.params.parameters()]
            opt_before = state.opt_state
        out = step(state, x, lx, y, ly, tf_rate, lr, draws=draws)
        if "frozen" in faults:
            with torch.no_grad():
                for p, b in zip(state.params.parameters(), before):
                    p.copy_(b)
            state.opt_state = opt_before
        return out

    return broken


def run(run: harness.Run) -> harness.Outcome:
    """One run of a training cell on one card."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import TrainDraws

    cell = run.cell
    device = run.device
    cfg_json, mix = cell.config, cell.mix
    model = cfg_json["model"]
    fam = harness.family(cell)
    flat = weights.make_flat(fam.leaf_specs(model), mixes.sub_seed(run.seed, 0), device)
    prog = build_program(run, flat)
    step = planted(prog.step, run.faults)
    state = prog.state
    plans = mixes.plan_batches(mix, cfg_json)
    batches = mixes.make_batches(plans, run.seed, device, fam.feature_width(model))
    rates = fam.dropout_rates(model)
    gen = torch.Generator(device=device).manual_seed(mixes.sub_seed(run.seed, 3))
    tf_rate, lr = cfg_json["tf_rate"], cfg_json["optimizer"]["configs"]["lr"]
    b1 = cfg_json["optimizer"]["configs"].get("betas", (0.9, 0.999))[0]

    def one_step(i):
        b = batches[i]
        with record_function("bench.draws"):
            draws = draw_step(model, rates, len(plans[i].lx), plans[i].l_pad, gen, device,
                              TrainDraws)
        with record_function("bench.train_step"):
            _, metrics, _ = step(state, b.x, b.lx, b.y, b.ly, tf_rate, lr, draws=draws)
        return metrics, draws

    # the checked steps: the order's first steps, on batches that all differ
    n_check = mix["checked_steps"]
    checked = mixes.step_order(len(plans), run.seed, 100000)[:n_check]
    if len(set(checked)) != n_check:
        raise RuntimeError("the checked steps must run distinct batches")
    losses, kept_draws, grad_norms = [], [], None
    for k, i in enumerate(checked):
        metrics, draws = one_step(i)
        losses.append(metrics["loss"])
        kept_draws.append(draws)
        if k == 0:
            grad_norms = {n: float(m.double().norm()) / (1 - b1)
                          for n, m in zip(prog.names, state.opt_state.mu)}
    change = {n: float((p.detach() - flat[n]).double().norm())
              for n, p in state.params.named_parameters()}
    prog_losses = [float(x) for x in losses]
    # one step of every shape not yet run
    seen = {(plans[i].t_pad, plans[i].l_pad) for i in checked}
    for i, p in enumerate(plans):
        if (p.t_pad, p.l_pad) not in seen:
            seen.add((p.t_pad, p.l_pad))
            one_step(i)
    harness.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # the window: whole passes over every batch, each in a fresh order,
    # until the run's seconds are up, so every run does the same mix of work;
    # the traced run profiles the window's first pass, every batch once
    window_order = mixes.step_order(len(plans), mixes.sub_seed(run.seed, 6), 100000)
    traced = harness.Traced(run.trace)
    bad = torch.zeros((), dtype=torch.int32, device=device)
    before = launch_snapshot() if run.trace else None
    traced.start()
    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    done, utts = 0, 0
    while True:
        i = window_order[done]
        metrics, _ = one_step(i)
        bad += (~metrics["finite"]).to(torch.int32)
        done += 1
        utts += len(plans[i].lx)
        if done == len(plans) and run.trace:
            traced.stop(lambda: harness.sync(device))
            after = launch_snapshot()
        if done % len(plans) == 0 and time.perf_counter() - t0 >= run.seconds:
            break
    harness.sync(device)
    seconds = time.perf_counter() - t0
    failed = int(bad)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace_ctx = None
    if run.trace:
        launches = [ln for p in plans for ln in fam.train_step_launches(
            model, cfg_json["compute_dtype"], p.t_pad, p.l_pad, p.lx)]
        delta = {k: after[k] - before[k] for k in after}
        flops = sum(fam.train_step_flops(model, p.lx, p.ly) for p in plans)
        lo, hi = traced.window_us()
        trace_ctx = traces.TraceContext(traced.events, (lo, hi), len(plans), launches, delta,
                                        flops, (hi - lo) / 1e6, cell.chips, "train")
    print(f"window: {done} steps, {utts} utterances, {seconds:.4f} s; set-up {setup_s:.4f} s",
          file=sys.stderr)

    # free the program, then the reference follows the checked steps
    del state, step, prog, metrics
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = reference_numbers(fam, cfg_json, flat,
                                [(batches[i], d) for i, d in zip(checked, kept_draws)],
                                prog_losses, grad_norms, change)
    print(f"reference: {time.perf_counter() - t_ref:.4f} s", file=sys.stderr)
    checks_out = [harness.Check(name, value, cell.limits.get(name, float("nan")))
                  for name, (value, _) in numbers.items()]
    notes = tuple(f"{name}: worst at {what}" for name, (_, what) in numbers.items())
    return harness.Outcome(done, failed, {"train_utt_s": utts / seconds, "setup_s": setup_s},
                           checks_out, peak, trace_ctx, notes)


def reference_numbers(fam, cfg_json, flat, steps, prog_losses, prog_grad, prog_change):
    """The family's float32 reference's run of the checked steps from the
    same weights, and the compared numbers."""
    ref_losses, ref_grad, ref_change = reference_readings(fam, cfg_json, flat, steps, None)
    return checks.train_numbers(prog_losses, ref_losses, prog_grad, ref_grad,
                                prog_change, ref_change)


def reference_readings(fam, cfg_json, flat, steps, precision):
    """(each step's loss, the first gradient's norm a leaf, the change's norm
    a leaf) of the family's reference in ``precision`` (its ``precision``)."""
    p = {n: t.clone() for n, t in flat.items()}
    opt = cfg_json["optimizer"]["configs"]
    with fam.precision(precision) as q:
        losses, first = fam.train_steps(p, cfg_json["model"], steps, cfg_json["tf_rate"],
                                        opt["lr"], opt, cfg_json["grad_norm"], q)
    return (losses, checks.leaf_norms(first),
            {n: float((p[n] - flat[n]).double().norm()) for n in p})
