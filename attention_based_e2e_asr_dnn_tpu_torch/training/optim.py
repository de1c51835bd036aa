"""Optimizers and schedulers (counterpart of the JAX ``training/optim.py``).

The JAX package builds its optimizers from optax 0.2.6 and is the reference,
so the update rules here follow optax, not ``torch.optim``. Where the two
differ:

  * amsgrad: optax takes ``nu_max = max(nu_max, nu_hat)`` over the
    bias-corrected second moment and divides ``mu_hat`` by ``sqrt(nu_max) +
    eps``; ``torch.optim.Adam(amsgrad=True)`` keeps the maximum of the
    uncorrected moment and corrects afterwards. They part from step 2 on.
  * clipping: ``optax.clip_by_global_norm`` leaves the gradient alone where
    ``norm < max_norm`` and else forms ``(g / norm) * max_norm``;
    ``clip_grad_norm_`` multiplies by ``max_norm / (norm + 1e-6)``.
  * AdamW: ``update = -lr * (adam + wd * p)``, the decay added after the Adam
    scaling. Adam's and SGD's ``weight_decay`` is L2: ``wd * p`` joins the
    gradient before the moments.

``Optimizer.update`` is functional: (grads, state, params, lr) -> (updates,
new state), all float32 tensors on the parameters' devices, the step count a
0-d tensor on the first parameter's, so a train step can keep or drop a whole
update with ``torch.where`` and no host synchronisation. The learning rate is
a runtime scalar. The state is (count, mu, nu, nu_max) with one tensor per
parameter. The parameters may lie on several devices (tensor parallelism,
``parallel/mesh.py``): each moment stays with its parameter, and the 0-d
scalars (the global norm, the bias corrections, the count) are moved to each
tensor's device where they meet it.

Gradient accumulation (``accum_steps > 1``) follows ``optax.MultiSteps``: a
running mean of the mini-steps' gradients, the inner optimizer applied to
that mean on every ``accum_steps``-th call (the clip sees the mean), zero
updates and an untouched inner state on the calls between; the state then
also carries ``mini_step`` and ``acc_grads``.

The four host-side schedulers are plain Python, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops.shards import on_device


# ---------------------------------------------------------------------------
# Optimizer registry
# ---------------------------------------------------------------------------

class OptState(NamedTuple):
    count: torch.Tensor               # 0-d int32: updates taken
    mu: Optional[List[torch.Tensor]]  # first moment (adam/adamw) or momentum trace (sgd)
    nu: Optional[List[torch.Tensor]]  # second moment (adam/adamw)
    nu_max: Optional[List[torch.Tensor]]  # amsgrad's running maximum of nu_hat
    mini_step: Optional[torch.Tensor] = None        # accumulation: 0-d int32 in [0, k)
    acc_grads: Optional[List[torch.Tensor]] = None  # accumulation: running mean


def sum_of_squares(tensors) -> torch.Tensor:
    """The sum of squares over all tensors, float32, on the first tensor's
    device (each tensor's sum taken where it lies)."""
    tensors = list(tensors)
    home = tensors[0]
    return sum(on_device((t.float() ** 2).sum(), home.device) for t in tensors)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of ``sum_of_squares``."""
    return torch.sqrt(sum_of_squares(tensors))


class Optimizer:
    """clip-by-global-norm -> adam / adamw / sgd, honouring every config key
    the reference's ``**configs`` splat would pass and raising on any other."""

    def __init__(self, name: str, configs: dict, grad_norm: float = 5.0,
                 accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.accum_steps = accum_steps
        cfg = dict(configs)
        self.lr = float(cfg.pop("lr", 1e-3))
        self.name = name.lower()
        self.grad_norm = grad_norm
        if self.name in ("adam", "adamw"):
            self.b1, self.b2 = cfg.pop("betas", (0.9, 0.999))
            self.eps = cfg.pop("eps", 1e-8)
            self.weight_decay = cfg.pop("weight_decay", 0.0)
            self.amsgrad = cfg.pop("amsgrad", False)
        elif self.name == "sgd":
            self.momentum = cfg.pop("momentum", 0.0) or None
            self.nesterov = cfg.pop("nesterov", False)
            self.weight_decay = cfg.pop("weight_decay", 0.0)
        else:
            raise ValueError(f"unknown optimizer {name!r} (expected adam/adamw/sgd)")
        if cfg:
            raise ValueError(
                f"optimizer {name!r} got unsupported config keys {sorted(cfg)} — "
                f"refusing to silently drop hyperparameters")

    def init(self, params) -> OptState:
        params = list(params)

        def zeros():
            return [torch.zeros_like(p, dtype=torch.float32) for p in params]

        count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        accum = ((torch.zeros_like(count), zeros()) if self.accum_steps > 1
                 else (None, None))
        if self.name == "sgd":
            return OptState(count, zeros() if self.momentum else None, None, None, *accum)
        return OptState(count, zeros(), zeros(), zeros() if self.amsgrad else None, *accum)

    def update(self, grads, state: OptState, params, lr):
        """One optimizer step. Returns (updates, new state); the caller adds
        the updates to the parameters. Nothing is modified in place."""
        params = [p.detach() for p in params]
        if self.accum_steps == 1:
            return self._update(grads, state, params, lr)
        # optax.MultiSteps: the inner update runs on the running mean at every
        # call and is adopted only on the emitting one
        mini = state.mini_step
        acc = [a + (g - a) / on_device(mini + 1, a.device) for g, a in zip(grads, state.acc_grads)]
        updates, new = self._update(acc, state, params, lr)
        emit = mini == self.accum_steps - 1

        def adopt(new_leaf, old_leaf):
            if new_leaf is None:
                return None
            if torch.is_tensor(new_leaf):
                return torch.where(emit, new_leaf, old_leaf)
            return [torch.where(on_device(emit, n.device), n, o)
                    for n, o in zip(new_leaf, old_leaf)]

        inner = [adopt(n, o) for n, o in zip(new[:4], state[:4])]
        return ([torch.where(on_device(emit, u.device), u, 0.0) for u in updates],
                OptState(*inner, (mini + 1) % self.accum_steps,
                         [torch.where(on_device(emit, a.device), 0.0, a) for a in acc]))

    def _update(self, grads, state: OptState, params, lr):
        """The inner optimizer: clip, then adam / adamw / sgd."""
        g_norm = global_norm(grads)
        keep = g_norm < self.grad_norm
        grads = [torch.where(on_device(keep, g.device), g,
                             (g / on_device(g_norm, g.device)) * self.grad_norm)
                 for g in grads]
        count = state.count + 1
        if self.name == "sgd":
            if self.weight_decay:
                grads = [g + self.weight_decay * p for g, p in zip(grads, params)]
            trace = None
            if self.momentum:
                trace = [g + self.momentum * t for g, t in zip(grads, state.mu)]
                grads = ([g + self.momentum * t for g, t in zip(grads, trace)]
                         if self.nesterov else trace)
            return [-lr * g for g in grads], OptState(count, trace, None, None)

        if self.name == "adam" and self.weight_decay:
            grads = [g + self.weight_decay * p for g, p in zip(grads, params)]
        b1, b2 = self.b1, self.b2
        mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
        steps = count.float()
        bc1, bc2 = 1 - b1 ** steps, 1 - b2 ** steps
        mu_hat = [m / on_device(bc1, m.device) for m in mu]
        nu_hat = [v / on_device(bc2, v.device) for v in nu]
        nu_max = None
        if self.amsgrad:
            nu_max = [torch.maximum(a, b) for a, b in zip(state.nu_max, nu_hat)]
            nu_hat = nu_max
        updates = [m / (torch.sqrt(v) + self.eps) for m, v in zip(mu_hat, nu_hat)]
        if self.name == "adamw":
            updates = [u + self.weight_decay * p for u, p in zip(updates, params)]
        return [-lr * u for u in updates], OptState(count, mu, nu, nu_max)


def build_optimizer(name: str, configs: dict, grad_norm: float = 5.0,
                    accum_steps: int = 1) -> Optimizer:
    """Clip-by-global-norm -> optimizer, the learning rate a runtime scalar
    of ``update`` (``configs["lr"]`` is kept as ``.lr``, the initial value)."""
    return Optimizer(name, configs, grad_norm, accum_steps)


# ---------------------------------------------------------------------------
# The optimizer state across frameworks
# ---------------------------------------------------------------------------

def _tree_get(tree, dotted: str):
    for key in dotted.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def _nest(flat: dict):
    """{"a.0.w": x, "a.1.w": y, "b": z} -> {"a": [{"w": x}, {"w": y}], "b": z}."""
    if "" in flat:
        return flat[""]
    groups: dict = {}
    for name, value in flat.items():
        head, _, rest = name.partition(".")
        groups.setdefault(head, {})[rest] = value
    if all(key.isdigit() for key in groups):
        return [_nest(groups[str(i)]) for i in range(len(groups))]
    return {key: _nest(group) for key, group in groups.items()}


def opt_state_from_optax(module: torch.nn.Module, count, mu, nu, nu_max=None) -> OptState:
    """The leaves of optax's ``ScaleByAdamState`` / ``ScaleByAmsgradState``
    (``count`` and trees shaped like the JAX params tree) -> ``OptState`` in
    the order of ``module.parameters()``, on the module's device."""
    names = [n for n, _ in module.named_parameters()]
    device = next(module.parameters()).device

    def leaves(tree):
        if tree is None:
            return None
        return [torch.from_numpy(np.array(_tree_get(tree, n), dtype=np.float32)).to(device)
                for n in names]

    return OptState(torch.tensor(int(count), dtype=torch.int32, device=device),
                    leaves(mu), leaves(nu), leaves(nu_max))


def opt_state_to_optax(module: torch.nn.Module, state: OptState) -> dict:
    """``OptState`` -> {"count", "mu", "nu", "nu_max"}: the count as an int
    and trees of float32 numpy arrays shaped like the JAX params tree."""
    names = [n for n, _ in module.named_parameters()]

    def tree(leaves):
        if leaves is None:
            return None
        return _nest({n: leaf.detach().cpu().numpy() for n, leaf in zip(names, leaves)})

    return {"count": int(state.count), "mu": tree(state.mu), "nu": tree(state.nu),
            "nu_max": tree(state.nu_max)}


def _jax_leaf_order(module: torch.nn.Module) -> List[int]:
    """Positions in ``module.parameters()`` in the order JAX flattens the
    params tree: dict keys sorted at every level, lists by index."""
    names = [n for n, _ in module.named_parameters()]
    key = lambda i: [(0, int(p)) if p.isdigit() else (1, p)  # noqa: E731
                     for p in names[i].split(".")]
    return sorted(range(len(names)), key=key)


def opt_state_to_leaves(module: torch.nn.Module, state: OptState, lr: float) -> list:
    """``OptState`` -> the flat leaf list of the JAX package's optimizer state
    (``jax.tree_util.tree_leaves`` of ``build_optimizer(...)``'s state), as a
    ``.ckpt`` stores it: [count, learning_rate, count, mu.., nu.., nu_max..]
    for adam/adamw, [count, learning_rate, trace..] for sgd; with gradient
    accumulation [mini_step, gradient_step] before and the running mean of
    the gradients after. Per-parameter leaves in the JAX tree's order."""
    order = _jax_leaf_order(module)

    def per_param(leaves):
        return [] if leaves is None else [leaves[i].detach().cpu().numpy() for i in order]

    count = np.asarray(int(state.count), np.int32)
    inner = [count, np.asarray(lr, np.float32)]
    if state.nu is not None:  # adam / adamw keep their own count
        inner.append(count)
    inner += per_param(state.mu) + per_param(state.nu) + per_param(state.nu_max)
    if state.mini_step is None:
        return inner
    return ([np.asarray(int(state.mini_step), np.int32), count] + inner
            + per_param(state.acc_grads))


def opt_state_from_leaves(module: torch.nn.Module, leaves: list,
                          like: OptState) -> OptState:
    """The inverse of ``opt_state_to_leaves``: a ``.ckpt``'s flat optimizer
    leaves -> ``OptState`` shaped like ``like`` (a fresh state of the live
    optimizer) on its device. Raises ``ValueError`` where the leaf count does
    not fit (another optimizer or accumulation setting)."""
    order = _jax_leaf_order(module)
    n, device = len(order), like.count.device
    groups = [g for g in (like.mu, like.nu, like.nu_max) if g is not None]
    accum = like.mini_step is not None
    head = 2 + (1 if like.nu is not None else 0)
    want = (2 if accum else 0) + head + n * (len(groups) + (1 if accum else 0))
    if len(leaves) != want:
        raise ValueError(f"checkpoint has {len(leaves)} optimizer leaves, the live "
                         f"optimizer state has {want}")
    leaves = list(leaves)
    mini = leaves.pop(0) if accum else None
    if accum:
        leaves.pop(0)  # gradient_step: the inner count again
    count = torch.tensor(int(leaves[0]), dtype=torch.int32, device=device)
    leaves = leaves[head:]

    def per_param():
        out = [None] * n
        for pos, i in enumerate(order):
            out[i] = torch.from_numpy(np.array(leaves[pos], dtype=np.float32)).to(device)
        del leaves[:n]
        return out

    mu, nu, nu_max = (per_param() if g is not None else None
                      for g in (like.mu, like.nu, like.nu_max))
    if not accum:
        return OptState(count, mu, nu, nu_max)
    return OptState(count, mu, nu, nu_max,
                    torch.tensor(int(mini), dtype=torch.int32, device=device), per_param())


# ---------------------------------------------------------------------------
# Schedulers (host-side state machines)
# ---------------------------------------------------------------------------

class CosineWarmupSchedule:
    """Per-batch LR schedule: linear warmup then cosine annealing.

    Parity of intent with the reference's precomputed table
    (src/utils.py:295-332); see module docstring for the documented fix of
    its negative-LR tail.
    """

    def __init__(self, num_batches: int, warmup_epochs: float = 1.0,
                 max_epochs: int = 10, init_lr: float = 1e-3, min_lr: float = 1e-6):
        self.total = num_batches * max_epochs
        self.warmup = int(num_batches * warmup_epochs)
        self.init_lr = init_lr
        self.min_lr = min_lr
        self.step_count = 0

    def __call__(self, step: Optional[int] = None) -> float:
        i = self.step_count if step is None else step
        if i < self.warmup and self.warmup > 0:
            return self.min_lr + (self.init_lr - self.min_lr) * i / self.warmup
        left = max(self.total - self.warmup, 1)
        j = min(i - self.warmup, left)
        return self.min_lr + (self.init_lr - self.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * j / left)
        )

    def step(self) -> float:
        lr = self()
        self.step_count += 1
        return lr

    def state_dict(self) -> dict:
        return {"step_count": self.step_count}

    def load_state_dict(self, d: dict) -> None:
        self.step_count = d["step_count"]


class ReduceLROnPlateau:
    """torch-equivalent ReduceLROnPlateau (factor/patience/min mode).

    Reference instantiation: factor=0.5, patience=3, mode='min'
    (src/train.py:83-85).
    """

    def __init__(self, init_lr: float, factor: float = 0.5, patience: int = 3,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = init_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]


class TeacherForcingScheduler:
    """LD-gated tf_rate decay (reference: src/train.py:448-456).

    Drop tf_rate by ``factor`` when: epoch > 0, last dev LD <= 20, tf_rate
    above ``lowest``, more than ``interval`` epochs since the last turn, and
    dev LD improved vs. the last turn.
    """

    def __init__(self, tf_rate: float, factor: float = 0.1, interval: int = 10,
                 lowest: float = 0.6):
        self.tf_rate = tf_rate
        self.factor = factor
        self.interval = interval
        self.lowest = lowest
        self.last_turn = (-1, float("inf"))  # (epoch, ld)

    def step(self, epoch: int, dev_ld_history: list) -> float:
        if (
            epoch > 0
            and dev_ld_history
            and dev_ld_history[-1] <= 20
            # epsilon guard: repeated ``tf -= 0.1`` leaves 0.6000...01 > 0.6
            # and the floor is silently crossed (the reference has the same
            # float bug, src/train.py:452; documented fix)
            and self.tf_rate > self.lowest + 1e-9
            and epoch - self.last_turn[0] > self.interval
            and dev_ld_history[-1] < self.last_turn[1]
        ):
            self.tf_rate -= self.factor
            self.last_turn = (epoch, dev_ld_history[-1])
        return self.tf_rate

    def state_dict(self) -> dict:
        return {"tf_rate": self.tf_rate, "last_turn": list(self.last_turn)}

    def load_state_dict(self, d: dict) -> None:
        self.tf_rate = d["tf_rate"]
        self.last_turn = tuple(d["last_turn"])


class DropoutScheduler:
    """Epoch-keyed multiplicative dropout-rate table (src/train.py:459-474).

    ``step(epoch)`` returns the multiplier to apply to every dropout rate at
    that epoch (1.0 when the epoch has no entry).
    """

    def __init__(self, table: Dict[int, float]):
        self.table = {int(k): float(v) for k, v in table.items()}

    def step(self, epoch: int) -> float:
        return self.table.get(epoch, 1.0)
