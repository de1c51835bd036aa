"""The training decode of a speller whose attention scores additively, as one
autograd Function: the teacher-forced loop of ``models/las.py::speller_step``
forward, its adjoint written out backward.

Under autograd the step loop records some forty nodes a decode step and its
backward walks them one at a time; at Chiu et al.'s widths (B=128, 256 steps)
the host then takes about a second a train step to issue them while the card
idles for half of it, and the step's time follows the host's speed. Here the
forward runs ``speller_step`` itself with autograd off and keeps, in buffers
of all the steps, the fed characters, the decoder's states and contexts and
the attention weights. The adjoint first recomputes each step's operands
from them, one product over all steps each (the cells' inputs and
pre-activations, the queries, the classifier's inputs), then walks the steps
back through the recurrences, the attention (the score's adjoint kernel,
``ops/speller_additive.py``) and the splits only; the gradients of the
classifier's inputs come first, one product over all steps, and those of the
weights last, one product each over all steps and rows (the sum inside the
product in float32, rounded once), as do the values' and the fed-back
embeddings' (one index-add). The keys' gradient is summed over the steps in
float32.

On a card the forward and the adjoint are each captured once a shape as a
CUDA graph (``torch.cuda.CUDAGraph``) and replayed: a decode costs the host
two graph launches and the copies of its operands into the graphs' inputs.
The graphs' buffers hold one pass at a time: a second forward of a shape
before the first one's backward, or one whose backward never comes while its
autograd graph lives, runs eagerly instead. A shape's graphs keep their
memory for good, so a new shape is captured only while the card's free
memory holds twice the largest shape's graphs; past that it runs eagerly.
The kernels' launches count in ``speller_additive.LAUNCHES`` where they are
made: a capture records its launches and makes none, so it takes back what
it counted and each replay adds it again. A replay runs under the span
``las.speller.replay``. CPU tensors run both loops eagerly.

The forward is ``speller_step``'s loop, so its logits are the step loop's
bit for bit; the gradient differs from the step loop's under autograd by
rounding only.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    DecodeState, SpellerConfig, SpellerOutput, speller_step)
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_additive
from attention_based_e2e_asr_dnn_tpu_torch.ops.attention import AttentionCache
from attention_based_e2e_asr_dnn_tpu_torch.ops.speller_additive import additive_scores_backward
from attention_based_e2e_asr_dnn_tpu_torch.utils.profiling import span

REPLAY = "las.speller.replay"


class DecodeInputs(NamedTuple):
    """The decode's differentiable operands, in the compute dtype. Weights
    as ``x @ w`` takes them: ``w1`` (E + P, 4 H1), ``u1`` (H1, 4 H1), ``w2``
    (H1, 4 H2), ``u2`` (H2, 4 H2), ``wq`` (H2, P); ``keys`` (B, Te, heads,
    d_head) and ``values`` (B, heads, Te, d_head), both contiguous;
    ``gold_prev`` (B, steps, E): step t's gold embedding of step t - 1; the
    t = -1 state ``h1``, ``c1``, ``h2``, ``c2`` and context ``ctx``."""
    emb: torch.Tensor
    w1: torch.Tensor
    u1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    u2: torch.Tensor
    b2: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    v: torch.Tensor
    cls_b: torch.Tensor
    keys: torch.Tensor
    values: torch.Tensor
    gold_prev: torch.Tensor
    h1: torch.Tensor
    c1: torch.Tensor
    h2: torch.Tensor
    c2: torch.Tensor
    ctx: torch.Tensor


class DecodeControls(NamedTuple):
    """The decode's other operands: ``mask`` (B, Te) True where padded;
    ``use_gold`` (steps,) bool; ``keep1`` / ``keep2`` (steps, B, H) the
    cells' dropout masks scaled by 1 / keep, or None."""
    mask: torch.Tensor
    use_gold: torch.Tensor
    keep1: Optional[torch.Tensor]
    keep2: Optional[torch.Tensor]


def _forward(x: DecodeInputs, k: DecodeControls, cfg: SpellerConfig):
    """``speller_step``'s loop with autograd off: (logits (B, steps, V),
    sample 0's attention weights (heads, steps, Te), what the adjoint reads:
    the fed characters, the states and contexts of steps -1 .. steps - 1 and
    the attention weights)."""
    batch, steps, _ = x.gold_prev.shape
    params = {"char_emb": x.emb, "cls_b": x.cls_b,
              "cell1": {"w_ih": x.w1, "w_hh": x.u1, "b": x.b1},
              "cell2": {"w_ih": x.w2, "w_hh": x.u2, "b": x.b2},
              "attention": {"query_map": {"w": x.wq, "b": x.bq}, "v": x.v}}
    cache = AttentionCache(keys=x.keys.transpose(1, 2), values=x.values, mask=k.mask)
    state = DecodeState(x.h1, x.c1, x.h2, x.c2, x.ctx)
    new = x.ctx.new_empty
    states = [new((steps + 1,) + tuple(t.shape)) for t in state]
    wgts = new(batch, cfg.att_heads, steps, x.keys.shape[1])
    logits = new(steps, batch, x.emb.shape[0])
    chars = torch.empty((steps, batch), dtype=torch.long, device=x.ctx.device)
    char = torch.full((batch,), cfg.CHR_SOS_IDX, dtype=torch.long, device=x.ctx.device)
    for buf, val in zip(states, state):
        buf[0].copy_(val)
    for t in range(steps):
        chars[t].copy_(char)
        out, w, state = speller_step(
            params, cfg, cache, char, state, gold_prev=x.gold_prev[:, t],
            use_gold=k.use_gold[t], keep1=None if k.keep1 is None else k.keep1[t],
            keep2=None if k.keep2 is None else k.keep2[t])
        for buf, val in zip(states, state):
            buf[t + 1].copy_(val)
        wgts[:, :, t].copy_(w)
        logits[t].copy_(out)
        char = torch.argmax(out, dim=-1)
    saved = dict(zip(("h1s", "c1s", "h2s", "c2s", "ctxs"), states), wgts=wgts, chars=chars)
    return logits.transpose(0, 1), wgts[0], saved


def _cell_adjoint(dh, dc_next, pre, c_prev, c_new, hidden: int):
    """One LSTM cell's adjoint in float32 (``ops/lstm.py::_gates``' gate
    order [i, f, g, o]): (d pre-activation, d carry into the previous
    step)."""
    i = torch.sigmoid(pre[:, :hidden])
    f = torch.sigmoid(pre[:, hidden:2 * hidden])
    g = torch.tanh(pre[:, 2 * hidden:3 * hidden])
    o = torch.sigmoid(pre[:, 3 * hidden:])
    tc = torch.tanh(c_new)
    dc = dc_next + dh * o * (1.0 - tc * tc)
    dpre = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                      dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
    return dpre, dc * f


def _backward(x: DecodeInputs, k: DecodeControls, saved: dict, dlogits: torch.Tensor,
              heads: int):
    """The adjoint of ``_forward``: the gradient of each of ``DecodeInputs``,
    in its dtype."""
    dt = x.ctx.dtype
    acc = torch.promote_types(dt, torch.float32)
    batch, steps, e_dim = x.gold_prev.shape
    h1_dim, h2_dim = x.u1.shape[0], x.u2.shape[0]
    proj = x.wq.shape[1]
    d_head = proj // heads
    h1s, c1s, h2s, c2s, ctxs = (saved[n] for n in ("h1s", "c1s", "h2s", "c2s", "ctxs"))
    wgts, chars = saved["wgts"], saved["chars"]
    # each step's operands as speller_step formed them, one product over all steps
    fed = torch.where(k.use_gold[:, None, None], x.gold_prev.transpose(0, 1), x.emb[chars])
    xs = torch.cat([fed, ctxs[:-1]], dim=-1)                     # (steps, B, E + P)
    pre1s = xs @ x.w1 + h1s[:-1] @ x.u1 + x.b1
    pre2s = h1s[1:] @ x.w2 + h2s[:-1] @ x.u2 + x.b2
    qs = h2s[1:] @ x.wq + x.bq
    decs = torch.cat([qs, ctxs[1:]], dim=-1)                     # (steps, B, 2P)
    dl = dlogits.transpose(0, 1).contiguous().to(dt)              # (steps, B, V)
    ddec = dl @ x.emb                                             # (steps, B, 2P)
    new = x.ctx.new_empty
    dpre1s, dpre2s = new(steps, batch, 4 * h1_dim), new(steps, batch, 4 * h2_dim)
    dqs = new(steps, batch, proj)
    dctxs = new(batch, heads, steps, d_head)
    de_fed = new(steps, batch, e_dim)
    d_gold = new(batch, steps, e_dim)
    zeros = x.ctx.new_zeros
    dkeys = torch.zeros(x.keys.shape, dtype=acc, device=x.keys.device)
    dv = torch.zeros(x.v.shape, dtype=acc, device=x.v.device)
    dh1 = zeros(batch, h1_dim, dtype=acc)
    dc1 = torch.zeros_like(dh1)
    dh2 = zeros(batch, h2_dim, dtype=acc)
    dc2 = torch.zeros_like(dh2)
    dctx = zeros(batch, proj, dtype=acc)
    for t in reversed(range(steps)):
        dctx = dctx + ddec[t, :, proj:]
        dctx_h = dctx.to(dt).reshape(batch, heads, d_head)
        dctxs[:, :, t].copy_(dctx_h)
        w = wgts[:, :, t]
        dw = torch.einsum("bhd,bhtd->bht", dctx_h, x.values).to(acc)
        wf = w.to(acc)
        ds = wf * (dw - (wf * dw).sum(-1, keepdim=True))
        dq, dk, dv_t = additive_scores_backward(qs[t].reshape(batch, heads, d_head),
                                                x.keys, x.v, k.mask, ds.to(dt))
        dkeys += dk
        dv += dv_t
        dqp = (ddec[t, :, :proj].to(acc) + dq.reshape(batch, proj).to(acc)).to(dt)
        dqs[t].copy_(dqp)
        dh2 = dh2 + (dqp @ x.wq.T)
        if k.keep2 is not None:
            dh2 = dh2 * k.keep2[t]
        dpre, dc2 = _cell_adjoint(dh2, dc2, pre2s[t].to(acc), c2s[t].to(acc),
                                  c2s[t + 1].to(acc), h2_dim)
        dpre = dpre.to(dt)
        dpre2s[t].copy_(dpre)
        dh1 = dh1 + (dpre @ x.w2.T)
        dh2 = (dpre @ x.u2.T).to(acc)
        if k.keep1 is not None:
            dh1 = dh1 * k.keep1[t]
        dpre, dc1 = _cell_adjoint(dh1, dc1, pre1s[t].to(acc), c1s[t].to(acc),
                                  c1s[t + 1].to(acc), h1_dim)
        dpre = dpre.to(dt)
        dpre1s[t].copy_(dpre)
        dx = dpre @ x.w1.T
        dh1 = (dpre @ x.u1.T).to(acc)
        dctx = dx[:, e_dim:].to(acc)
        de = dx[:, :e_dim]
        gold = k.use_gold[t]
        d_gold[:, t].copy_(torch.where(gold, de, 0.0))
        de_fed[t].copy_(torch.where(gold, 0.0, de))

    def wgrad(inputs, douts):
        """sum over steps and rows of inputs^T @ douts, one product."""
        return inputs.reshape(-1, inputs.shape[-1]).T @ douts.reshape(-1, douts.shape[-1])

    d_emb = wgrad(dl, decs).to(acc)
    d_emb.index_add_(0, chars.reshape(-1), de_fed.reshape(-1, e_dim).to(acc))
    d_values = torch.matmul(wgts.transpose(-1, -2), dctxs)
    grads = DecodeInputs(
        emb=d_emb, w1=wgrad(xs, dpre1s), u1=wgrad(h1s[:-1], dpre1s),
        b1=dpre1s.to(acc).sum((0, 1)), w2=wgrad(h1s[1:], dpre2s),
        u2=wgrad(h2s[:-1], dpre2s), b2=dpre2s.to(acc).sum((0, 1)),
        wq=wgrad(h2s[1:], dqs), bq=dqs.to(acc).sum((0, 1)), v=dv,
        cls_b=dl.to(acc).sum((0, 1)), keys=dkeys, values=d_values, gold_prev=d_gold,
        h1=dh1, c1=dc1, h2=dh2, c2=dc2, ctx=dctx)
    return DecodeInputs(*(g.to(t.dtype) for g, t in zip(grads, x)))


class _Graphs:
    """One shape's captured forward and adjoint, their input buffers, the
    launches each replay makes, the card memory their pools took, and the
    pass that holds them (a weak reference to its autograd context's token:
    a pass whose autograd graph is gone holds nothing)."""

    def __init__(self, x: DecodeInputs, k: DecodeControls, cfg: SpellerConfig):
        self.cfg = cfg
        self.x = DecodeInputs(*(t.detach().clone() for t in x))
        self.k = DecodeControls(*(None if t is None else t.clone() for t in k))
        self.dlogits = None
        self.fwd = self.bwd = None
        self.out = self.grads = None
        self.fwd_launches = self.bwd_launches = {}
        self.bytes = 0
        self.owner = None

    def busy(self) -> bool:
        return self.owner is not None and self.owner() is not None

    def load(self, x: DecodeInputs, k: DecodeControls) -> None:
        for dst, src in zip(self.x, x):
            dst.copy_(src)
        for dst, src in zip(self.k, k):
            if dst is not None:
                dst.copy_(src)

    def _capture(self, fn):
        """``fn()`` once on a side stream (the libraries' lazy set-up), then
        captured: (the graph, its outputs, the launches it holds)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # as the capture does: its pool's growth alone below
        reserved = torch.cuda.memory_reserved()
        before = dict(speller_additive.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
        self.bytes += torch.cuda.memory_reserved() - reserved
        held = {key: n - before.get(key, 0) for key, n in speller_additive.LAUNCHES.items()}
        speller_additive.LAUNCHES.update(before)  # recorded, not made
        return graph, out, {key: n for key, n in held.items() if n}

    @staticmethod
    def _replay(graph, launches: dict) -> None:
        with span(REPLAY):
            graph.replay()
        for key, n in launches.items():
            speller_additive.LAUNCHES[key] += n

    def forward(self):
        if self.fwd is None:
            self.fwd, self.out, self.fwd_launches = self._capture(
                lambda: _forward(self.x, self.k, self.cfg))
        self._replay(self.fwd, self.fwd_launches)
        logits, wgts0, _ = self.out
        return logits.clone(), wgts0.clone()

    def backward(self, dlogits: torch.Tensor):
        if self.bwd is None:
            self.dlogits = dlogits.detach().clone()
            self.bwd, self.grads, self.bwd_launches = self._capture(
                lambda: _backward(self.x, self.k, self.out[2], self.dlogits,
                                  self.cfg.att_heads))
        else:
            self.dlogits.copy_(dlogits)
        self._replay(self.bwd, self.bwd_launches)
        return [g.clone() for g in self.grads]


_GRAPHS: dict = {}


def _graph_key(x: DecodeInputs, k: DecodeControls, cfg: SpellerConfig):
    return (x.ctx.device, x.ctx.dtype, cfg, k.keep1 is None, k.keep2 is None,
            tuple(tuple(t.shape) for t in x))


def _room(device: torch.device) -> bool:
    """Whether a new shape may be captured: while the card's free memory
    (outside the allocator's cache) holds twice the largest shape's graphs,
    so that the eager passes beside them keep room to grow."""
    held = [g.bytes for key, g in _GRAPHS.items() if key[0] == device]
    return not held or torch.cuda.mem_get_info(device)[0] >= 2 * max(held)


class _Token:
    """Lives as long as a pass's autograd context."""


class _AdditiveDecode(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, k, capture, *inputs):
        x = DecodeInputs(*inputs)
        ctx.cfg, ctx.k, ctx.graphs = cfg, k, None
        if x.ctx.is_cuda and capture:
            key = _graph_key(x, k, cfg)
            graphs = _GRAPHS.get(key)
            if graphs is None and _room(x.ctx.device):
                graphs = _GRAPHS[key] = _Graphs(x, k, cfg)
            if graphs is not None and not graphs.busy():
                graphs.load(x, k)
                logits, wgts0 = graphs.forward()
                ctx.token = _Token()
                graphs.owner = weakref.ref(ctx.token)
                ctx.graphs = graphs
                ctx.mark_non_differentiable(wgts0)
                return logits, wgts0
        logits, wgts0, saved = _forward(x, k, cfg)
        ctx.saved = saved
        ctx.save_for_backward(*inputs)
        ctx.mark_non_differentiable(wgts0)
        return logits, wgts0

    @staticmethod
    def backward(ctx, dlogits, _):
        with span("las.backward.speller"):
            if ctx.graphs is not None:
                grads = ctx.graphs.backward(dlogits)
                ctx.graphs.owner = None
            else:
                x = DecodeInputs(*ctx.saved_tensors)
                grads = _backward(x, ctx.k, ctx.saved, dlogits, ctx.cfg.att_heads)
        return (None, None, None, *grads)


def additive_decode_train(params, cfg: SpellerConfig, cache: AttentionCache,
                          state: DecodeState, wgts0, gold_prev, use_gold=None, keep1=None,
                          keep2=None, capture: bool = True) -> SpellerOutput:
    """The teacher-forced decode of ``models/las.py::speller_apply`` on the
    Function: its operands (``params`` in the compute dtype, as
    ``speller_start`` returns them) -> its output. ``capture``: on a card,
    replay the shape's graphs (False: run the Function eagerly there too)."""
    att = params["attention"]
    steps = gold_prev.shape[1]
    if use_gold is None:
        use_gold = torch.zeros((steps,), dtype=torch.bool, device=gold_prev.device)
    x = DecodeInputs(
        emb=params["char_emb"], w1=params["cell1"]["w_ih"], u1=params["cell1"]["w_hh"],
        b1=params["cell1"]["b"], w2=params["cell2"]["w_ih"], u2=params["cell2"]["w_hh"],
        b2=params["cell2"]["b"], wq=att["query_map"]["w"], bq=att["query_map"]["b"],
        v=att["v"], cls_b=params["cls_b"], keys=cache.keys.transpose(1, 2).contiguous(),
        values=cache.values.contiguous(), gold_prev=gold_prev, h1=state.h1, c1=state.c1,
        h2=state.h2, c2=state.c2, ctx=state.context)
    logits, wgts = _AdditiveDecode.apply(
        cfg, DecodeControls(cache.mask, use_gold, keep1, keep2), capture, *x)
    att_map = torch.cat([wgts0[0][:, None], wgts], dim=1)  # (heads, steps+1, T)
    return SpellerOutput(logits=logits, att_map=att_map.transpose(-2, -1))
