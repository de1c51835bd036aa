"""Data parallelism with one process for each rank and explicit collectives
(counterpart of the JAX ``parallel/dp.py``).

The JAX package runs the whole train step, both Pallas kernel tiers
included, per shard under ``jax.shard_map`` and ``psum``s the gradients.
Here each rank is a process of its own over a ``torch.distributed`` group
(``parallel/mesh.py``): it runs this package's whole step, the CUDA kernels
included, on its B/n rows of the global batch, and the collectives are
explicit ``all_reduce``s that carry the JAX step's semantics:

  * loss and gradients are the global masked token mean: each rank
    normalises its cross-entropy *sum* by the all-reduced GLOBAL token
    count, and the rank gradients are summed. ``DistributedDataParallel``
    would average over ranks instead, which differs wherever the ranks hold
    different token counts;
  * the gradients go through one all-reduce of one flat buffer (the shard
    loss rides in it), not a collective a tensor;
  * SpecAugment, dropout and the teacher-forcing coins are drawn from a
    generator seeded by the state's seed and the rank (the JAX step's
    ``fold_in(key, shard index)``): distinct draws a rank;
  * the NaN guard tests the norm of the all-reduced gradient, which every
    rank holds bit for bit, so every rank skips or applies the update
    together and parameters and optimizer state stay bit-identical;
  * with gradient accumulation the gradients are all-reduced at every
    micro-step, as the JAX step ``psum``s at every call.

``spawn`` starts the ranks: ``python -m ...train -c <yml>`` with
``parallel: {use: true, data: N}`` calls it, and ``torchrun`` is the other
way in (``make_mesh`` joins its group).
"""

from __future__ import annotations

import contextlib
import os
import queue
import sys
import traceback
from types import SimpleNamespace
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from attention_based_e2e_asr_dnn_tpu_torch.config import snapshot_config
from attention_based_e2e_asr_dnn_tpu_torch.data.specaug import draw_specaug, specaugment
from attention_based_e2e_asr_dnn_tpu_torch.ops.masking import length_mask
from attention_based_e2e_asr_dnn_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    DataMesh,
    check_device_count,
    choose_backend,
    close_mesh,
    free_port,
    init_rank,
    make_mesh,
)
from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_sum
from attention_based_e2e_asr_dnn_tpu_torch.training.steps import (
    TrainState,
    _cast_features,
    apply_update,
    param_grads,
)
from attention_based_e2e_asr_dnn_tpu_torch.utils.logging import (
    MetricLogger,
    dump_log_json,
    experiment_folder,
)

_FOLD = 0x9E3779B97F4A7C15  # the golden-ratio multiplier of a 64-bit hash


def fold_seed(seed: int, rank: int) -> int:
    """A seed of its own for ``rank``, from ``seed`` (a 63-bit mix)."""
    return ((int(seed) * _FOLD) ^ (int(rank) + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)


def shard_generator(state: TrainState, mesh: DataMesh) -> torch.Generator:
    """The rank's noise generator of ``state``: seeded once, at the rank's
    first step, from the seed of ``state.generator`` and the rank."""
    if state.shard_generator is None:
        seed = state.generator.initial_seed() if state.generator is not None else 0
        device = state.generator.device if state.generator is not None else mesh.device
        state.shard_generator = torch.Generator(device=device).manual_seed(
            fold_seed(seed, mesh.rank))
    return state.shard_generator


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, in place (``t`` is returned)."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def gather_rows(mesh: DataMesh, local) -> np.ndarray:
    """Every rank's rows of ``local`` (a tensor or an array), concatenated in
    rank order, on the host of every rank. Through ``all_gather_object``,
    which both backends take (gloo has no ``all_gather`` of CUDA tensors)."""
    arr = local.cpu().numpy() if torch.is_tensor(local) else np.asarray(local)
    if mesh.size == 1:
        return arr
    parts: List[Any] = [None] * mesh.size
    dist.all_gather_object(parts, arr, group=mesh.group)
    return np.concatenate(parts, axis=0)


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], mesh: DataMesh, src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s values, in one
    broadcast of one flat buffer a dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=src, group=mesh.group)
        offset = 0
        for t in group:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_state(state: TrainState, mesh: DataMesh, src: int = 0) -> None:
    """Rank ``src``'s parameters and optimizer state on every rank."""
    tensors = list(state.params.parameters())
    for leaf in state.opt_state:
        if torch.is_tensor(leaf):
            tensors.append(leaf)
        elif leaf is not None:
            tensors.extend(leaf)
    broadcast_tensors([t.data if isinstance(t, torch.nn.Parameter) else t
                       for t in tensors], mesh, src)


def make_dp_train_step(apply_fn, opt, mesh: DataMesh, accum_steps: int = 1,
                       compute_dtype=torch.float32, use_specaug: bool = False,
                       specaug_freq: int = 6, specaug_time: int = 200,
                       specaug_iid: bool = False, nan_guard: bool = True):
    """The data-parallel twin of ``training.steps.make_train_step``, with its
    signature:

        step(state, x, lx, y, ly, tf_rate, lr, init_force=False, draws=None)
            -> (state, metrics, att_map)

    called on every rank with that rank's rows (``parallel.mesh.shard_rows``
    of the global batch). ``draws`` replays the rank's own draws. ``metrics``
    (``loss``, ``ppl``, ``grad_norm``, ``n_tokens``, ``finite``) are the
    global batch's and equal on every rank. ``att_map`` is the rank's sample
    0: on rank 0 the global batch's sample 0, the one the Trainer plots."""
    if accum_steps != opt.accum_steps:
        raise ValueError(f"accum_steps {accum_steps} differs from the optimizer's "
                         f"{opt.accum_steps}")

    def step(state: TrainState, x, lx, y, ly, tf_rate, lr,
             init_force: bool = False, draws: Any = None):
        params = list(state.params.parameters())
        generator = shard_generator(state, mesh) if draws is None else None
        if use_specaug:
            spec = (draws.specaug if draws is not None else
                    draw_specaug(x.shape[0], specaug_freq, specaug_time, specaug_iid,
                                 generator, x.device))
            x = specaugment(x, spec)
        # the global token count first: the shard loss is scaled by it before
        # the backward pass, as in the one-process step
        n_local = length_mask(ly, y.shape[1], dtype=torch.float32).sum()
        n_tokens = torch.clamp(all_reduce_sum(n_local, mesh), min=1.0)
        out = apply_fn(state.params, _cast_features(x, compute_dtype), lx, dec_y=y,
                       tf_rate=tf_rate, init_force=init_force, train=True,
                       draws=draws, generator=generator)
        ce_sum, _ = masked_ce_sum(out.logits, y, ly)
        shard_loss = ce_sum / n_tokens
        grads = param_grads(shard_loss, params)
        with torch.no_grad():
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]
                                            + [shard_loss.detach().reshape(1)]), mesh)
            loss = flat[-1]
            offset = 0
            for i, g in enumerate(grads):
                grads[i] = flat[offset: offset + g.numel()].view_as(g)
                offset += g.numel()
        grad_norm, ok = apply_update(state, opt, params, grads, lr, nan_guard)
        metrics = {"loss": loss, "ppl": torch.exp(loss), "grad_norm": grad_norm,
                   "n_tokens": n_tokens, "finite": ok}
        return state, metrics, out.att_map.detach()

    return step


def make_dp_eval_step(apply_fn, mesh: DataMesh, compute_dtype=torch.float32):
    """The data-parallel twin of ``training.steps.make_eval_step``: the
    free-running decode runs on the rank's rows; the loss is the global
    token mean (the cross-entropy sum and the raw token count all-reduced
    together, so a rank whose rows are all padding adds nothing to either);
    the prediction ids stay on the rank (``gather_rows`` brings them to every
    rank).

        step(params, x, lx, y, ly) -> ({"loss", "ppl", "n_tokens"}, ids)
    """

    @torch.inference_mode()
    def step(params, x, lx, y, ly):
        logits = apply_fn(params, _cast_features(x, compute_dtype), lx).logits
        n = min(logits.shape[1], y.shape[1])
        metrics = global_ce_metrics(logits[:, :n], y[:, :n], torch.clamp(ly, max=n), mesh)
        return metrics, torch.argmax(logits, dim=-1).to(torch.int32)

    return step


def global_ce_metrics(logits, y, ly, mesh: DataMesh) -> dict:
    """{"loss", "ppl", "n_tokens"} of the global batch from a rank's rows:
    the CE sum and the raw token count in one all-reduce."""
    ce_sum, n_raw = masked_ce_sum(logits, y, ly)
    # an all-padding shard adds zero, even where its CE is not finite
    ce_sum = torch.where(n_raw > 0, ce_sum, torch.zeros_like(ce_sum))
    tot = all_reduce_sum(torch.stack([ce_sum, n_raw]), mesh)
    n_tokens = torch.clamp(tot[1], min=1.0)
    loss = tot[0] / n_tokens
    return {"loss": loss, "ppl": torch.exp(loss), "n_tokens": n_tokens}


# ---------------------------------------------------------------------------
# The CLIs' ranks
# ---------------------------------------------------------------------------

def run_training(body: Callable, args, n_ranks, build: bool = True):
    """The ``train`` and ``lmtrain`` CLIs' run of ``body(mesh, args)``, which
    trains and returns its ``Trainer``. ``n_ranks`` False (``parallel.use``
    off): ``body(None, args)`` here, its ``Trainer`` returned. Otherwise on
    the ranks of ``launch`` (``n_ranks`` None: every visible card; ``build``
    is ``launch``'s): each rank prints the ``[parallel]`` line, the ranks
    other than 0 with their standard output sent nowhere, and rank 0's
    histories and folder are returned (a ``Trainer`` does not cross
    processes)."""
    if n_ranks is False:
        return body(None, args)
    return launch(_training_rank, n_ranks, args.device, args=(body, args), build=build)


def _training_rank(mesh: DataMesh, body: Callable, args) -> SimpleNamespace:
    with contextlib.ExitStack() as scope:
        if mesh.rank != 0:
            sink = scope.enter_context(open(os.devnull, "w"))
            scope.enter_context(contextlib.redirect_stdout(sink))
        print(f"[parallel] data-parallel mesh over {mesh.size} devices ({mesh.backend}: "
              f"one process a rank, per-rank batch shards, explicit all_reduce)")
        trainer = body(mesh, args)
        return SimpleNamespace(saving_dir=trainer.saving_dir, epoch=trainer.epoch,
                               train_history=trainer.train_history,
                               dev_history=trainer.dev_history)


def open_experiment(mesh: Optional[DataMesh], trncfgs, trncfgs_dict: dict):
    """A training run's (logger, experiment folder): wandb on rank 0 only
    (or the one process); the folder and its ``config.json`` made by rank 0,
    its path broadcast to the other ranks (src/train.py:519-530)."""
    wandb_cfg = getattr(trncfgs, "wandb", None)
    writer = mesh is None or mesh.rank == 0
    logger = MetricLogger(use_wandb=bool(wandb_cfg and wandb_cfg.use) and writer,
                          wandb_configs=getattr(wandb_cfg, "configs", None),
                          run_config=trncfgs_dict)
    box = [None]
    if writer:
        box[0] = experiment_folder(trncfgs.EXP_FOLDER, logger.run_name)
        snapshot_config(trncfgs_dict, box[0])
    if mesh is not None:
        dist.broadcast_object_list(box, src=0, group=mesh.group)
    return logger, box[0]


def close_experiment(mesh: Optional[DataMesh], trainer, logger, folder: str,
                     export: Callable[[], None]) -> None:
    """The end of a training run on rank 0 (or the one process): the
    histories' ``log.json``, the logger's finish, then ``export()``."""
    if mesh is not None and mesh.rank != 0:
        return
    dump_log_json(os.path.join(folder, "log.json"), trainer.train_history,
                  trainer.dev_history)
    logger.finish()
    export()


# ---------------------------------------------------------------------------
# Starting the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world_size: int, devices: List[str], backend: str,
               init_method: str, timeout_s: float, fn: Callable, args: tuple,
               results) -> None:
    try:
        mesh = init_rank(rank, world_size, devices[rank], init_method, backend, timeout_s)
        out = fn(mesh, *args)
        close_mesh()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        sys.stdout.flush()
        sys.stderr.flush()
        sys.exit(1)


def spawn(fn: Callable, world_size: int, args: tuple = (),
          devices: Optional[Sequence] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
          build: bool = True) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks, one process each, and
    return the ranks' results in rank order (they must pickle: return host
    values, not CUDA tensors).

    ``devices`` lists each rank's device; by default rank r takes ``cuda:r``,
    and more ranks than cards raise. Given explicitly it may repeat a card or
    name the CPU: the backend is NCCL where every rank has a card of its
    own, gloo otherwise. The ranks start with ``torch.multiprocessing``'s
    ``spawn`` method (never ``fork`` under CUDA) and meet on a loopback port.
    ``timeout_s`` bounds each collective, so that a rank stuck in one fails
    the run instead of hanging it. A rank's exception is raised again here,
    as a ``RuntimeError`` carrying its traceback, after the other ranks are
    stopped; ``fn`` must be importable by name (a module's function, not a
    lambda).

    With a card among the devices and ``build``, every kernel source is
    built once here, before the ranks start (``cuda_build.build_all``):
    ``cuda_build``'s locks hold only within a process, and although its
    ``os.replace`` keeps concurrent builds safe, each rank would otherwise
    run every ``nvcc`` itself."""
    if devices is None:
        check_device_count(world_size)
        devices = [f"cuda:{i}" for i in range(world_size)]
    else:
        check_device_count(world_size, devices)
    devices = [str(torch.device(d)) for d in devices]
    backend = choose_backend(devices)
    if build and any(torch.device(d).type == "cuda" for d in devices):
        from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, devices, backend, init_method, timeout_s, fn, tuple(args), results))
        for r in range(world_size)]
    for p in procs:
        p.start()
    out: list = [None] * world_size
    failed: dict = {}
    done: set = set()
    try:
        while len(done) < world_size and not failed:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if not dead:
                    continue
                try:  # a dead rank's report may still be in the pipe
                    rank, ok, payload = results.get(timeout=2.0)
                except queue.Empty:
                    for r in dead:
                        failed[r] = f"exited with code {procs[r].exitcode} and no report"
                    break
            done.add(rank)
            if ok:
                out[rank] = payload
            else:
                failed[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30 if not failed else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{failed[rank]}")
    return out


def launch(run_fn: Callable, n_ranks: Optional[int], device="cuda", args: tuple = (),
           build: bool = True):
    """The CLIs' way into data parallelism: ``run_fn(mesh, *args)`` on every
    rank, rank 0's result returned.

    Under ``torchrun`` this process is one rank and joins the group of its
    environment. Otherwise ``n_ranks`` (None: every visible card) decides:
    one rank runs here, in a group of its own; more are all started with
    ``spawn``, on ``cuda:0 .. cuda:n-1`` (or all on the CPU where ``device``
    is ``cpu``), while this process waits for them. ``build`` is
    ``spawn``'s."""
    device = torch.device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh = make_mesh(n_ranks, device=None if device.type == "cuda" else device)
        try:
            return run_fn(mesh, *args)
        finally:
            close_mesh()
    if n_ranks is None:
        n_ranks = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_ranks == 1:
        mesh = make_mesh(1, device=device)
        try:
            return run_fn(mesh, *args)
        finally:
            close_mesh()
    devices = None if device.type == "cuda" else [str(device)] * n_ranks
    return spawn(run_fn, n_ranks, args, devices=devices, build=build)[0]
