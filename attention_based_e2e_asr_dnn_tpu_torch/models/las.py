"""Listen-Attend-Spell (counterpart of the JAX ``models/las.py``), inference.

Parameters live in ``ListenAttendSpell``, an ``nn.Module`` whose parameter
names mirror the JAX params tree's paths (``listener.base.0.fwd.w_ih``, ...,
``speller.init_h1``) and which indexes like that tree (``params["speller"]
["cell1"]["w_ih"]``), so the functions below read the same as their JAX
counterparts. ``las_from_jax_params`` / ``las_to_jax_params`` carry the whole
tree across, the trained ``init_h*/c*`` decoder states included (the
reference ``state_dict`` naming of ``compat`` has no slot for them).

Ported: the config dataclasses, ``las_config_from_dicts``, parameter init,
``listener_apply`` (with locked dropout in training), ``speller_apply``
(with ``decoder_impl: pallas`` the free-running eval decode and the
teacher-forced training decode on the fused decode kernels,
``ops/speller_cuda.py``, the training one differentiable through the adjoint
kernel; with ``decoder_impl: scan`` a loop of PyTorch ops, under autograd in
training, with dropout, per-step batch-shared teacher-forcing coins and the
``init_force`` prior, which the kernels do not compute: a ``pallas`` config
takes the loop for such a pass, says so and records the route, as the JAX
package does), the decode-route report and ``las_apply``.

Beyond the JAX package, for Chiu et al. 2018's LAS (``configs/chiu-las.yml``):
a frame-stacking front end (``stack_frames``: ``stack_left``, ``stack_stride``
in the listener's config), a listener with no pyramid (``plstm_layers: 0``),
and the additive attention score (``att_score: additive``, the leaf
``attention.v``), which the fused kernels do not compute either: its decode
takes the step loop, whose score runs on ``ops/speller_additive.py``; in
training the loop is one Function (``models/additive_decode.py``).

Randomness of a training pass is one ``TrainDraws`` record, either drawn
from an explicit ``torch.Generator`` (``draw_train_noise``) or handed in, so
a test can replay the JAX package's draws.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from attention_based_e2e_asr_dnn_tpu_torch.ops.attention import (
    AttentionCache,
    block_diagonal_prior,
    cross_attention_precompute,
    cross_attention_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.dropout import draw_keep_mask
from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm import (
    locked_lstm_stack_apply,
    lstm_cell_step,
    pyramidal_lstm_stack_apply,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.speller_cuda import speller_apply_fused
from attention_based_e2e_asr_dnn_tpu_torch.utils.profiling import span


# ---------------------------------------------------------------------------
# Configs: the same fields and defaults as the JAX package's
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ListenerConfig:
    input_dim: int = 15
    uniform_hid_dim: int = 256
    lstm_layers: int = 1
    plstm_layers: int = 3
    bidirectional: bool = True
    init_dropout: float = 0.2
    mid_dropout: float = 0.3
    final_dropout: float = 0.4
    # "pallas": the hand-written CUDA kernels (ops/lstm_cuda.py); "scan": the
    # plain PyTorch loops (ops/lstm.py)
    lstm_impl: str = "scan"
    remat: bool = False      # recompute each layer in the backward pass (ops/lstm.py)
    # the front end (``stack_frames``): each frame with the ``stack_left``
    # frames before it, kept at every ``stack_stride``-th frame (0 and 1: the
    # features as they come)
    stack_left: int = 0
    stack_stride: int = 1

    @property
    def enc_out_dim(self) -> int:
        return self.uniform_hid_dim * (2 if self.bidirectional else 1)

    @property
    def frame_dim(self) -> int:
        """The width of a frame the first layer reads: the stacked frames'."""
        return self.input_dim * (self.stack_left + 1)

    @property
    def time_reduction(self) -> int:
        """Total time downsampling: the stacking's stride, then 2x per
        pyramidal layer."""
        return self.stack_stride * 2 ** self.plstm_layers


@dataclass(frozen=True)
class SpellerConfig:
    enc_out_dim: int = 512
    att_proj_dim: int = 128
    att_heads: int = 4
    att_dropout: float = 0.2
    dec_vocab_size: int = 30
    dec_emb_dim: int = 256
    dec_emb_dropout: float = 0.5
    dec_lstm_hid_dim: int = 512
    dec_lstm_out_dim: int = 128
    dec_lstm_dropout: float = 0.2
    CHR_MAX_STEPS: int = 600
    CHR_PAD_IDX: int = 29
    CHR_SOS_IDX: int = 0
    USE_GREEDY: bool = True
    legacy_scale: bool = False
    # "pallas": the decode on the fused CUDA kernels (ops/speller_cuda.py), in
    # eval and in training; "scan": the step loop of PyTorch ops below
    decoder_impl: str = "scan"
    # "dot": the scaled dot-product score; "additive": v . tanh(q + k) a head,
    # with the leaf ``attention.v`` (ops/attention.py)
    att_score: str = "dot"

    def __post_init__(self):
        if self.att_score not in ("dot", "additive"):
            raise ValueError(f"att_score must be 'dot' or 'additive', got {self.att_score!r}")
        # weight tying: the classifier input is cat(projected query, context)
        if self.dec_emb_dim != 2 * self.att_proj_dim:
            raise ValueError(
                f"weight tying requires dec_emb_dim == 2*att_proj_dim, got "
                f"{self.dec_emb_dim} != 2*{self.att_proj_dim}"
            )


@dataclass(frozen=True)
class LASConfig:
    listener: ListenerConfig = field(default_factory=ListenerConfig)
    speller: SpellerConfig = field(default_factory=SpellerConfig)


def las_config_from_dicts(listener_configs: dict, speller_configs: dict) -> LASConfig:
    """LASConfig from reference-style config dicts; ``enc_out_dim`` is
    derived from the listener, as in the reference composition root."""
    listener = ListenerConfig(**listener_configs)
    speller_kwargs = dict(speller_configs)
    speller_kwargs["enc_out_dim"] = listener.enc_out_dim
    return LASConfig(listener=listener, speller=SpellerConfig(**speller_kwargs))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A module whose parameters mirror a nested dict/list tree of arrays:
    ``tree["a"][0]["b"]`` becomes parameter ``a.0.b``, and the module
    indexes the same way. Parameters are float32."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v) for v in value))
            elif torch.is_tensor(value):
                self.register_parameter(key, nn.Parameter(value.detach().float().clone()))
            else:
                self.register_parameter(key, nn.Parameter(
                    torch.from_numpy(np.array(value, dtype=np.float32))))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters


class ListenAttendSpell(ParamTree):
    """The LAS parameter tree ({"listener": ..., "speller": ...})."""

    def __init__(self, tree: dict):
        if set(tree) != {"listener", "speller"}:
            raise ValueError(f"LAS params need exactly listener and speller, "
                             f"got {sorted(tree)}")
        super().__init__(tree)


def _tree_to_numpy(node):
    if isinstance(node, nn.ModuleList):
        return [_tree_to_numpy(m) for m in node]
    out = {k: p.detach().cpu().numpy().astype(np.float32)
           for k, p in node._parameters.items()}
    out.update({k: _tree_to_numpy(m) for k, m in node._modules.items()})
    return out


def cast_params(tree, dtype: torch.dtype):
    """The tree as plain dicts/lists of tensors in ``dtype``. A decode casts
    the speller once up front, so the per-step ``.to(dtype)`` of each use
    is a no-op instead of a cast kernel."""
    if isinstance(tree, (list, nn.ModuleList)):
        return [cast_params(v, dtype) for v in tree]
    if isinstance(tree, ParamTree):
        tree = {**tree._parameters, **tree._modules}
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def las_from_jax_params(tree: dict) -> ListenAttendSpell:
    """JAX LAS params tree (nested dicts/lists of arrays) -> module."""
    return ListenAttendSpell(tree)


def las_to_jax_params(module: ListenAttendSpell) -> dict:
    """Module -> JAX LAS params tree of float32 numpy arrays."""
    return _tree_to_numpy(module)


def _uniform(shape, k: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2 - 1) * k


def _lstm_init(in_dim: int, hid: int, generator: torch.Generator) -> dict:
    k = 1.0 / math.sqrt(hid)
    return {"w_ih": _uniform((in_dim, 4 * hid), k, generator),
            "w_hh": _uniform((hid, 4 * hid), k, generator),
            "b": _uniform((4 * hid,), k, generator)}


def lstm_layer_init(in_dim: int, hid: int, bidirectional: bool,
                    generator: torch.Generator) -> dict:
    """One (Bi)LSTM layer's parameters, uniform +-1/sqrt(hid)."""
    if bidirectional:
        return {"fwd": _lstm_init(in_dim, hid, generator),
                "bwd": _lstm_init(in_dim, hid, generator)}
    return _lstm_init(in_dim, hid, generator)


def _linear_init(in_dim: int, out_dim: int, generator: torch.Generator) -> dict:
    k = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform((in_dim, out_dim), k, generator),
            "b": _uniform((out_dim,), k, generator)}


def speller_init(sc: SpellerConfig, emb: torch.Tensor, generator: torch.Generator) -> dict:
    """The speller's parameter tree around the embedding ``emb`` (tied with
    the classifier); an additive score adds ``attention.v`` (heads, d_head),
    uniform +-1/sqrt(d_head)."""
    attention = {
        "key_map": _linear_init(sc.enc_out_dim, sc.att_proj_dim, generator),
        "value_map": _linear_init(sc.enc_out_dim, sc.att_proj_dim, generator),
        "query_map": _linear_init(sc.dec_lstm_out_dim, sc.att_proj_dim, generator),
    }
    if sc.att_score == "additive":
        d_head = sc.att_proj_dim // sc.att_heads
        attention["v"] = _uniform((sc.att_heads, d_head), 1.0 / math.sqrt(d_head), generator)
    return {
        "attention": attention,
        "char_emb": emb,
        "cell1": _lstm_init(sc.dec_emb_dim + sc.att_proj_dim, sc.dec_lstm_hid_dim, generator),
        "cell2": _lstm_init(sc.dec_lstm_hid_dim, sc.dec_lstm_out_dim, generator),
        "init_query": torch.rand((1, sc.dec_lstm_out_dim), generator=generator),
        "init_h1": torch.zeros((1, sc.dec_lstm_hid_dim)),
        "init_c1": torch.zeros((1, sc.dec_lstm_hid_dim)),
        "init_h2": torch.zeros((1, sc.dec_lstm_out_dim)),
        "init_c2": torch.zeros((1, sc.dec_lstm_out_dim)),
        "cls_b": torch.zeros((sc.dec_vocab_size,)),
    }


def char_embedding_init(sc: SpellerConfig, generator: torch.Generator) -> torch.Tensor:
    """Normal embedding with a zero PAD row."""
    emb = torch.randn((sc.dec_vocab_size, sc.dec_emb_dim), generator=generator)
    emb[sc.CHR_PAD_IDX] = 0.0
    return emb


def las_init(cfg: LASConfig, generator: torch.Generator) -> ListenAttendSpell:
    """Fresh parameters with the JAX ``las_init`` distributions (torch
    defaults: uniform +-1/sqrt(fan) for LSTMs and linears, normal embedding
    with a zero PAD row, uniform [0, 1) init query, zero initial states)."""
    lc, sc = cfg.listener, cfg.speller
    mult = 2 if lc.bidirectional else 1
    hid = lc.uniform_hid_dim
    emb = char_embedding_init(sc, generator)
    tree = {
        "listener": {
            "base": [lstm_layer_init(lc.frame_dim if i == 0 else hid * mult, hid,
                                     lc.bidirectional, generator)
                     for i in range(lc.lstm_layers)],
            "pyramid": [lstm_layer_init(2 * lc.enc_out_dim, hid, lc.bidirectional, generator)
                        for _ in range(lc.plstm_layers)],
        },
        "speller": speller_init(sc, emb, generator),
    }
    return ListenAttendSpell(tree)


# ---------------------------------------------------------------------------
# Randomness of one training pass
# ---------------------------------------------------------------------------

class TrainDraws(NamedTuple):
    """Every random number of one training pass. Masks are keep masks (bool,
    True = keep; or 0/1), None where the rate is 0."""

    listener_masks: list                  # per listener layer, base then pyramid: (B, 1, D)
    coins: torch.Tensor                   # (L,) uniform [0, 1): teacher forcing per step
    m1: Optional[torch.Tensor]            # (L, B, dec_lstm_hid_dim) cell-1 output dropout
    m2: Optional[torch.Tensor]            # (L, B, dec_lstm_out_dim) cell-2 output dropout
    specaug: Optional[NamedTuple] = None  # data/specaug.SpecAugDraws, read by the train step


def draw_train_noise(cfg: "LASConfig", batch: int, steps: int,
                     generator: Optional[torch.Generator], device,
                     specaug=None) -> TrainDraws:
    """Draw one training pass's ``TrainDraws`` from ``generator`` on ``device``."""
    lc, sc = cfg.listener, cfg.speller
    out_dim = lc.enc_out_dim
    rates = ([lc.mid_dropout if i else lc.init_dropout for i in range(lc.lstm_layers)]
             + [lc.mid_dropout if i < lc.plstm_layers - 1 else lc.final_dropout
                for i in range(lc.plstm_layers)])
    masks = [draw_keep_mask((batch, 1, out_dim), r, generator, device) if r > 0.0 else None
             for r in rates]
    coins = torch.rand((steps,), generator=generator, device=device)
    rate = sc.dec_lstm_dropout
    m1 = m2 = None
    if rate > 0.0:
        m1 = draw_keep_mask((steps, batch, sc.dec_lstm_hid_dim), rate, generator, device)
        m2 = draw_keep_mask((steps, batch, sc.dec_lstm_out_dim), rate, generator, device)
    return TrainDraws(masks, coins, m1, m2, specaug)


# ---------------------------------------------------------------------------
# Listener
# ---------------------------------------------------------------------------

def stack_frames(x: torch.Tensor, lengths: torch.Tensor, left: int, stride: int):
    """Frame stacking and subsampling (Chiu et al. 2018, sec. 3): output
    frame k is input frames [stride k - left, ..., stride k] side by side,
    oldest first, zeros before the start: (B, T, F) -> (B, ceil(T / stride),
    (left + 1) F); lengths ceil(l / stride): the output frames whose newest
    input frame is valid."""
    batch, _, feats = x.shape
    windows = F.pad(x, (0, 0, left, 0)).unfold(1, left + 1, stride)  # (B, T', F, left + 1)
    out = windows.transpose(2, 3).reshape(batch, -1, (left + 1) * feats)
    return out, (lengths + stride - 1) // stride


def listener_apply(params, cfg: ListenerConfig, x: torch.Tensor,
                   lengths: torch.Tensor, train: bool = False,
                   masks: Optional[list] = None,
                   generator: Optional[torch.Generator] = None):
    """(B, T, input_dim) -> ((B, T / time_reduction, enc_out_dim), lengths):
    the frame stacking where configured, the base layers, the pyramid. In
    training, locked dropout after every layer from ``masks`` (one per
    layer, base then pyramid) or drawn from ``generator``."""
    n_base = cfg.lstm_layers
    with span("las.listener"):
        if cfg.stack_left or cfg.stack_stride != 1:
            x, lengths = stack_frames(x, lengths, cfg.stack_left, cfg.stack_stride)
        h, lengths = locked_lstm_stack_apply(
            params["base"], x, lengths, cfg.bidirectional, impl=cfg.lstm_impl,
            init_dropout=cfg.init_dropout, mid_dropout=cfg.mid_dropout, train=train,
            masks=None if masks is None else masks[:n_base], generator=generator,
            remat=cfg.remat)
        if not cfg.plstm_layers:
            return h, lengths
        return pyramidal_lstm_stack_apply(
            params["pyramid"], h, lengths, cfg.bidirectional, impl=cfg.lstm_impl,
            mid_dropout=cfg.mid_dropout, final_dropout=cfg.final_dropout, train=train,
            masks=None if masks is None else masks[n_base:], generator=generator,
            remat=cfg.remat)


# ---------------------------------------------------------------------------
# Speller
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    h1: torch.Tensor
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor
    context: torch.Tensor


def speller_start(params, cfg: SpellerConfig, enc_h: torch.Tensor,
                  enc_l: torch.Tensor, cache_hook=None):
    """Attention cache and the t = -1 decoder state (learned initial
    states, context of the learned initial query); also the t = -1
    attention weights. ``cache_hook(cache)`` replaces the cache where given
    (sequence parallelism: ``parallel/sequence.py::shard_cache_over_time``)."""
    batch, dtype = enc_h.shape[0], enc_h.dtype
    cache = cross_attention_precompute(params["attention"], enc_h, enc_l,
                                       cfg.att_heads)
    if cache_hook is not None:
        cache = cache_hook(cache)

    def init(name, width):
        return params[name].to(dtype).expand(batch, width)

    query = init("init_query", cfg.dec_lstm_out_dim)
    context, wgts, _ = cross_attention_step(params["attention"], cache, query,
                                            cfg.att_heads, cfg.legacy_scale)
    state = DecodeState(init("init_h1", cfg.dec_lstm_hid_dim),
                        init("init_c1", cfg.dec_lstm_hid_dim),
                        init("init_h2", cfg.dec_lstm_out_dim),
                        init("init_c2", cfg.dec_lstm_out_dim), context)
    return cache, state, wgts


def speller_step(params, cfg: SpellerConfig, cache: AttentionCache,
                 char: torch.Tensor, state: DecodeState, gold_prev=None,
                 use_gold=None, keep1=None, keep2=None, prior_row=None):
    """One decode step: previous char ids (B,) -> (logits (B, V), attention
    weights (B, heads, T), next state). Training extras: where ``use_gold``
    (a 0-d bool) the previous gold embedding ``gold_prev`` (B, E) replaces
    the fed-back one; ``keep1`` / ``keep2`` are this step's dropout masks
    already scaled by 1 / keep, and the dropped outputs are what the carry
    keeps (reference parity); ``prior_row`` is the init_force prior's row."""
    emb = params["char_emb"].to(state.context.dtype)
    char_e = emb[char]
    if use_gold is not None:
        char_e = torch.where(use_gold, gold_prev, char_e)
    cell_in = torch.cat([char_e, state.context], dim=-1)
    h1, c1 = lstm_cell_step(params["cell1"], cell_in, state.h1, state.c1)
    if keep1 is not None:
        h1 = h1 * keep1
    h2, c2 = lstm_cell_step(params["cell2"], h1, state.h2, state.c2)
    if keep2 is not None:
        h2 = h2 * keep2
    context, wgts, q_proj = cross_attention_step(
        params["attention"], cache, h2, cfg.att_heads, cfg.legacy_scale, prior_row)
    dec_out = torch.cat([q_proj, context], dim=-1)
    logits = dec_out @ emb.T + params["cls_b"].to(emb.dtype)
    return logits, wgts, DecodeState(h1, c1, h2, c2, context)


class SpellerOutput(NamedTuple):
    logits: torch.Tensor   # (B, steps, vocab)
    att_map: torch.Tensor  # (heads, enc_len, steps + 1) — sample 0, plot layout


# Which decoder served each (decoder, batch, enc_len) shape: "cuda" (the
# fused kernels), "plain" (their plain versions, for CPU tensors) or "scan".
_DECODE_ROUTES: dict = {}
_WARNED_FALLBACKS: set = set()


def _warn_fused_fallback(batch: int, enc_len: int, reason: str) -> None:
    """Say once per shape and reason, on stderr, that ``decoder_impl: pallas``
    took the scan decoder (the JAX package's ``_warn_fused_fallback``)."""
    key = (batch, enc_len, reason)
    if key in _WARNED_FALLBACKS:
        return
    _WARNED_FALLBACKS.add(key)
    print(f"WARNING: decoder_impl=pallas requested but shape "
          f"(B={batch}, Te={enc_len}) fell back to the scan decoder: "
          f"{reason}", file=sys.stderr)


def _decoder_key(cfg) -> str:
    """The decoder a route belongs to: two models in one process can decode
    the same shape through different configs."""
    return (f"p{cfg.att_proj_dim}h{cfg.att_heads}"
            f"e{cfg.dec_emb_dim}d{cfg.dec_lstm_hid_dim}"
            f"o{cfg.dec_lstm_out_dim}" + ("-additive" if cfg.att_score == "additive" else ""))


def decode_route_report() -> dict:
    """Which decoder implementation served each decoded (decoder, batch,
    enc_len) shape, keyed as the JAX package keys it."""
    many = len({k for (k, _, _) in _DECODE_ROUTES}) > 1
    return {(f"[{k}]B={b},Te={t}" if many else f"B={b},Te={t}"): impl
            for (k, b, t), impl in sorted(_DECODE_ROUTES.items())}


def reset_decode_routes() -> None:
    """Forget the routes and the warnings given, so that the next
    ``decode_route_report`` speaks of the decodes made from here on."""
    _DECODE_ROUTES.clear()
    _WARNED_FALLBACKS.clear()


def speller_apply(params, cfg: SpellerConfig, enc_h: torch.Tensor,
                  enc_l: torch.Tensor, dec_y: Optional[torch.Tensor] = None,
                  tf_rate=1.0, init_force: bool = False, train: bool = False,
                  draws: Optional[TrainDraws] = None, cache_hook=None) -> SpellerOutput:
    """The autoregressive decode (the JAX ``speller_apply``).

    Eval (``train=False``, ``dec_y=None``): free-running greedy for
    ``CHR_MAX_STEPS`` steps. Training (``train=True``, ``dec_y`` (B, L)
    given): L steps under autograd. Step t feeds the gold embedding of step
    t - 1 where ``coins[t] <= tf_rate`` (one coin per step, shared by the
    batch; step 0 is never forced), else the embedding of its own previous
    argmax. ``draws`` supplies the coins and the dropout masks; without it
    there is neither forcing nor dropout, as in the JAX package without a
    key. ``init_force`` biases every step's attention by the block-diagonal
    prior.

    ``decoder_impl: pallas`` runs either decode on the fused kernels (their
    plain versions for CPU tensors); a shape a kernel cannot take raises.
    The kernels compute neither the additive score, nor the ``init_force``
    prior, nor a pass with ``dec_y`` given outside training. Such a pass, on
    the card as on the CPU, warns once a shape, records the route ``"scan"``
    and takes the step loop: the JAX package's own route for a pass its
    kernel does not compute (its ``models/las.py``; the loop ignores
    ``dec_y`` outside training).
    A training pass of the additive score (without the prior or a
    ``final_map``) runs the step loop as one autograd Function with its own
    adjoint, captured as CUDA graphs on a card (``models/additive_decode.py``).
    Training without ``dec_y`` raises. ``cache_hook`` (the step loop only;
    the JAX package's ``enc_hook`` route refuses the kernels) shards the
    attention cache over time: sequence parallelism."""
    batch, enc_len, _ = enc_h.shape
    key = (_decoder_key(cfg), batch, enc_len)
    if cfg.decoder_impl == "pallas":
        if cache_hook is not None:
            raise ValueError("a time-sharded attention cache (sequence parallelism) "
                             "requires decoder_impl: scan")
        if train and dec_y is None:
            raise ValueError("training decode requires dec_y")
        if cfg.att_score == "additive":
            reason = ("additive attention score (the fused kernels compute "
                      "dot-product scores only)")
        elif init_force:
            reason = ("init_force epoch (the fused kernels do not compute the "
                      "prior-biased attention)")
        elif dec_y is not None and not train:
            reason = ("dec_y given outside training (the fused kernels force "
                      "labels only in their training form)")
        else:
            _DECODE_ROUTES[key] = "cuda" if enc_h.is_cuda else "plain"
            return speller_apply_fused(params, cfg, enc_h, enc_l, dec_y, tf_rate,
                                       train, draws)
        _warn_fused_fallback(batch, enc_len, reason)
    _DECODE_ROUTES[key] = "scan"
    params = cast_params(params, enc_h.dtype)
    if train:
        if dec_y is None:
            raise ValueError("training decode requires dec_y")
        steps = dec_y.shape[1]
        gold_prev, use_gold, keep1, keep2 = teacher_forcing(params, cfg, dec_y, tf_rate, draws)
    else:
        steps = cfg.CHR_MAX_STEPS
        gold_prev = use_gold = keep1 = keep2 = None
    prior_rows = (block_diagonal_prior(enc_len, steps, device=enc_h.device).T
                  if init_force else None)

    with span("las.speller.operands"):
        cache, state, wgts0 = speller_start(params, cfg, enc_h, enc_l, cache_hook)
    with span("las.speller.decode"):  # the whole loop: no span a step
        if (train and cfg.att_score == "additive" and prior_rows is None
                and cache_hook is None and "final_map" not in params["attention"]):
            # imported here: the Function's forward is speller_step's loop
            from attention_based_e2e_asr_dnn_tpu_torch.models.additive_decode import (
                additive_decode_train)
            return additive_decode_train(params, cfg, cache, state, wgts0, gold_prev,
                                         use_gold, keep1, keep2)
        return speller_loop(params, cfg, cache, state, wgts0, steps, gold_prev, use_gold,
                            keep1, keep2, prior_rows)


def teacher_forcing(params, cfg: SpellerConfig, dec_y: torch.Tensor, tf_rate,
                    draws: Optional[TrainDraws]):
    """A training decode's feeds, ``params`` in the compute dtype: (gold_prev
    (B, L, E), step t's gold embedding of step t - 1; use_gold (L,) bool;
    keep1 / keep2 (L, B, H), the cells' dropout masks scaled by 1 / keep).
    Without ``draws`` the last three are None: no forcing, no dropout."""
    batch, dtype = dec_y.shape[0], params["char_emb"].dtype
    gold_emb = params["char_emb"][dec_y.long()]
    gold_prev = torch.cat([gold_emb.new_zeros(batch, 1, cfg.dec_emb_dim),
                           gold_emb[:, :-1]], dim=1)
    use_gold = keep1 = keep2 = None
    if draws is not None:
        coins = draws.coins.to(gold_prev.device).clone()
        coins[0] = 2.0  # step 0 is never teacher-forced
        use_gold = coins <= tf_rate
        if cfg.dec_lstm_dropout > 0.0:
            keep = 1.0 - cfg.dec_lstm_dropout
            keep1 = draws.m1.to(dtype) / keep
            keep2 = draws.m2.to(dtype) / keep
    return gold_prev, use_gold, keep1, keep2


def speller_loop(params, cfg: SpellerConfig, cache, state: DecodeState, wgts0, steps: int,
                 gold_prev=None, use_gold=None, keep1=None, keep2=None,
                 prior_rows=None) -> SpellerOutput:
    """``steps`` of ``speller_step`` from ``speller_start``'s cache, state
    and weights, with ``teacher_forcing``'s feeds in training and the
    prior's rows under ``init_force``."""
    batch = state.context.shape[0]
    char = torch.full((batch,), cfg.CHR_SOS_IDX, dtype=torch.long,
                      device=state.context.device)
    logits_t, wgts_t = [], []
    for t in range(steps):
        logits, wgts, state = speller_step(
            params, cfg, cache, char, state,
            gold_prev=None if use_gold is None else gold_prev[:, t],
            use_gold=None if use_gold is None else use_gold[t],
            keep1=None if keep1 is None else keep1[t],
            keep2=None if keep2 is None else keep2[t],
            prior_row=None if prior_rows is None else prior_rows[t])
        char = torch.argmax(logits, dim=-1)
        logits_t.append(logits)
        wgts_t.append(wgts[0])
    att_map = torch.stack([wgts0[0]] + wgts_t, dim=1)  # (heads, steps+1, T)
    return SpellerOutput(logits=torch.stack(logits_t, dim=1),
                         att_map=att_map.transpose(-2, -1))


def las_apply(params, cfg: LASConfig, x: torch.Tensor, lx: torch.Tensor,
              dec_y: Optional[torch.Tensor] = None, tf_rate=1.0,
              init_force: bool = False, train: bool = False,
              draws: Optional[TrainDraws] = None,
              generator: Optional[torch.Generator] = None,
              cache_hook=None) -> SpellerOutput:
    """listen -> spell (the JAX ``las_apply``). Eval: (B, T, input_dim)
    features and lengths -> the free-running decode. Training: the
    teacher-forced decode over ``dec_y``, its randomness from ``draws`` or,
    when only a ``generator`` is given, drawn from it. ``cache_hook``: see
    ``speller_apply``."""
    if train and draws is None and generator is not None:
        draws = draw_train_noise(cfg, x.shape[0], dec_y.shape[1], generator, x.device)
    enc_h, enc_l = listener_apply(
        params["listener"], cfg.listener, x, lx, train,
        masks=None if draws is None else draws.listener_masks)
    return speller_apply(params["speller"], cfg.speller, enc_h, enc_l, dec_y,
                         tf_rate, init_force, train, draws, cache_hook)
