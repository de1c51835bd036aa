"""Listen-Attend-Spell in plain PyTorch, float32 with TF32 off: the yardstick
the benchmark holds the port's outputs to.

Written from the model's equations (the reference repository's
``src/models.py`` as the port's docstrings restate it), not from the port:
gate order [i, f, g, o] with one bias; the (h, c) carry frozen where a frame
is past the row's length and h zero there; the reverse direction walking time
down from a zero carry; locked dropout ``x * keep / (1 - rate)`` with one
mask a row and feature; the pyramid concatenating frame pairs and halving
lengths (floor); keys and values projected once; the decoder's cell 1 over
[embedding of the fed id; context], cell 2 over cell 1's output, each output
times its dropout mask and the dropped value carried; the query, the masked
softmax attention a head scaled by 1/sqrt(d_head), the tied classifier over
[query; context]; the first maximum fed back where a step is not
teacher-forced. The training loss is the masked token-mean cross-entropy,
the update optax's clip-by-global-norm then AdamW with amsgrad.

Every matrix product's operands pass through ``q``: the identity here, and
in the low-precision control a rounding to a narrower float (the gradient
passes straight through). The backward pass goes layer by layer: the
listener's forward is kept only at layer boundaries and each layer is run
again under autograd when its gradient is due, so the reference fits the
card beside nothing else. Imports nothing of the measured program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounding(fmt: Optional[torch.dtype]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operand rounding: identity for None, else a round trip through
    ``fmt`` with the gradient passed straight through."""
    if fmt is None:
        return lambda x: x

    def q(x):
        return x + (x.detach().to(fmt).to(x.dtype) - x.detach())

    return q


@contextlib.contextmanager
def precision(name: Optional[str]):
    """The reference's precision, yielding its operand rounding: None is
    float32 with TF32 off; "tf32" lets the products round their operands to
    TF32 on the card; any other name is a torch dtype the operands are
    rounded to (``float8_e4m3fn``)."""
    no_tf32()
    try:
        if name == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            yield rounding(None)
        else:
            yield rounding(None if name is None else getattr(torch, name))
    finally:
        no_tf32()


def control_precision(compute_dtype: str) -> str:
    """The nearest precision below the configuration's: the control's."""
    return {"float32": "tf32", "bfloat16": "float8_e4m3fn"}[compute_dtype]


# ---------------------------------------------------------------------------
# Listener
# ---------------------------------------------------------------------------

def bilstm(p: Tree, prefix: str, x: torch.Tensor, lengths: torch.Tensor, q) -> torch.Tensor:
    """One bidirectional layer: (B, T, D) -> (B, T, 2H) = [forward, reverse],
    zero at padded frames. Both directions step together, the reverse one
    over time flipped."""
    batch, steps, _ = x.shape
    dirs = [f"{prefix}.fwd", f"{prefix}.bwd"]
    hid = p[f"{dirs[0]}.w_hh"].shape[0]
    xq = q(x)
    xp = [xq @ q(p[f"{d}.w_ih"]) + p[f"{d}.b"] for d in dirs]
    # (T, 2, B, 4H), unbound once: a step's select would give the backward
    # pass a zero tensor of the whole stream each step
    xp = torch.stack([xp[0], xp[1].flip(1)]).permute(2, 0, 1, 3).unbind(0)
    t = torch.arange(steps, device=x.device)
    valid = t[:, None] < lengths[None, :].long()                  # (T, B)
    valid = torch.stack([valid, valid.flip(0)], 1)[..., None]       # (T, 2, B, 1)
    w_hh = torch.stack([q(p[f"{d}.w_hh"]) for d in dirs])          # (2, H, 4H)
    h = x.new_zeros(2, batch, hid)
    c = x.new_zeros(2, batch, hid)
    outs = []
    for s in range(steps):
        pre = torch.baddbmm(xp[s], q(h), w_hh)
        gates = torch.sigmoid(pre)                     # i, f, _, o
        g = torch.tanh(pre[..., 2 * hid:3 * hid])
        c_new = torch.addcmul(gates[..., hid:2 * hid] * c, gates[..., :hid], g)
        h_new = gates[..., 3 * hid:] * torch.tanh(c_new)
        v = valid[s]
        h = torch.where(v, h_new, h)
        c = torch.where(v, c_new, c)
        outs.append(h_new)
    out = torch.stack(outs) * valid.to(x.dtype)        # (T, 2, B, H), zero at pads
    return torch.cat([out[:, 0], out[:, 1].flip(0)], dim=-1).transpose(0, 1)


def listener_layers(model: dict):
    """(parameter prefix, pyramid?, dropout rate) of each listener layer."""
    lc = model["listener_configs"]
    out = []
    for i in range(lc["lstm_layers"]):
        out.append((f"listener.base.{i}", False, lc["mid_dropout"] if i else lc["init_dropout"]))
    n = lc["plstm_layers"]
    for i in range(n):
        out.append((f"listener.pyramid.{i}", True,
                    lc["mid_dropout"] if i < n - 1 else lc["final_dropout"]))
    return out


def listener_layer(p: Tree, layer, x, lengths, mask, q):
    """One layer (with the pyramid's frame pairing first, and its locked
    dropout where ``mask`` is given): returns (y, lengths)."""
    prefix, pyramid, rate = layer
    if pyramid:
        batch, steps, dim = x.shape
        x = x.reshape(batch, steps // 2, 2 * dim)
        lengths = lengths // 2
    y = bilstm(p, prefix, x, lengths, q)
    if mask is not None and rate > 0:
        y = y * mask.to(y.dtype) / (1.0 - rate)
    return y, lengths


# ---------------------------------------------------------------------------
# Speller
# ---------------------------------------------------------------------------

def speller(p: Tree, model: dict, enc: torch.Tensor, enc_l: torch.Tensor, steps: int, q,
            gold: Optional[torch.Tensor] = None,
            use_gold: Optional[torch.Tensor] = None, m1=None, m2=None) -> torch.Tensor:
    """The decode over ``steps`` steps: logits (B, steps, V).

    Step t's input id is ``gold[:, t - 1]`` where ``use_gold[t]``; else the
    first maximum of step t - 1's logits (start-of-sequence 0 at t = 0).
    ``m1`` / ``m2`` (steps, B, H) are the cells' keep masks."""
    sc = model["speller_configs"]
    heads, proj, emb_dim = sc["att_heads"], sc["att_proj_dim"], sc["dec_emb_dim"]
    keep = 1.0 - sc["dec_lstm_dropout"]
    batch, te, _ = enc.shape
    d_head = proj // heads
    scale = 1.0 / math.sqrt(d_head)
    pre = "speller."
    emb = p[pre + "char_emb"]
    encq = q(enc)
    keys = (encq @ q(p[pre + "attention.key_map.w"]) + p[pre + "attention.key_map.b"])
    vals = (encq @ q(p[pre + "attention.value_map.w"]) + p[pre + "attention.value_map.b"])
    keys = q(keys.reshape(batch, te, heads, d_head).transpose(1, 2))   # (B, h, Te, dh)
    vals = q(vals.reshape(batch, te, heads, d_head).transpose(1, 2))
    pad = (torch.arange(te, device=enc.device)[None, :] >= enc_l[:, None].long())[:, None, :]
    w_q, b_q = q(p[pre + "attention.query_map.w"]), p[pre + "attention.query_map.b"]

    def attend(h2):
        query = q(h2) @ w_q + b_q
        scores = torch.einsum("bhd,bhtd->bht", q(query.reshape(batch, heads, d_head)), keys)
        scores = (scores * scale).masked_fill(pad, float("-inf"))
        wgts = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bht,bhtd->bhd", q(wgts), vals).reshape(batch, proj)
        return query, ctx

    def cell(x_terms, h, c, name):
        pre_act = sum(x_terms) + q(h) @ q(p[f"{pre}{name}.w_hh"]) + p[f"{pre}{name}.b"]
        i, f, g, o = pre_act.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    w_ih1 = p[pre + "cell1.w_ih"]
    w_emb1, w_ctx1 = q(w_ih1[:emb_dim]), q(w_ih1[emb_dim:])
    w_ih2 = q(p[pre + "cell2.w_ih"])
    cls_w, cls_b = q(emb).T, p[pre + "cls_b"]
    _, ctx = attend(p[pre + "init_query"].expand(batch, -1))
    h1 = p[pre + "init_h1"].expand(batch, -1)
    c1 = p[pre + "init_c1"].expand(batch, -1)
    h2 = p[pre + "init_h2"].expand(batch, -1)
    c2 = p[pre + "init_c2"].expand(batch, -1)
    prev = torch.zeros(batch, dtype=torch.long, device=enc.device)
    logits_t = []
    for t in range(steps):
        if use_gold is not None and t > 0 and bool(use_gold[t]):
            ids = gold[:, t - 1].long()
        else:
            ids = prev
        h1, c1 = cell([q(emb[ids]) @ w_emb1, q(ctx) @ w_ctx1], h1, c1, "cell1")
        if m1 is not None:
            h1 = h1 * m1[t].to(h1.dtype) / keep
        h2, c2 = cell([q(h1) @ w_ih2], h2, c2, "cell2")
        if m2 is not None:
            h2 = h2 * m2[t].to(h2.dtype) / keep
        query, ctx = attend(h2)
        logits = q(torch.cat([query, ctx], dim=-1)) @ cls_w + cls_b
        prev = torch.argmax(logits.detach(), dim=-1)
        logits_t.append(logits)
    return torch.stack(logits_t, dim=1)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def specaugment(x: torch.Tensor, spec) -> torch.Tensor:
    """One frequency and one time mask shared by the batch: width and unit
    start as drawn, start = unit * (size - width), positions p with start <=
    p < start + width set to 0."""
    _, steps, feats = x.shape

    def keep(size, width, unit):
        start = unit * (size - width)
        pos = torch.arange(size, dtype=torch.float32, device=x.device)
        return ~((pos >= start) & (pos < start + width))

    kf = keep(feats, spec.freq_width.float(), spec.freq_start.float())
    kt = keep(steps, spec.time_width.float(), spec.time_start.float())
    return x * kf[None, None, :] * kt[None, :, None]


def masked_ce(logits: torch.Tensor, y: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, y[..., None].long())[..., 0]
    mask = (torch.arange(y.shape[1], device=y.device)[None, :] < ly[:, None].long()).float()
    return (ce * mask).sum() / mask.sum().clamp(min=1.0)


def loss_and_grads(p: Tree, model: dict, batch, draws, tf_rate: float, q):
    """The training loss of one batch and the gradient of every leaf of
    ``p``. The listener's layers run forward without a graph, keeping their
    inputs; the decode and the loss run under autograd; then each layer is
    run again, last first, and its gradient taken from the one above."""
    layers = listener_layers(model)
    with torch.no_grad():
        x = specaugment(batch.x.float(), draws.specaug)
        inputs, lens = [], []
        h, lengths = x, batch.lx
        for layer, mask in zip(layers, draws.listener_masks):
            inputs.append(h)
            lens.append(lengths)
            h, lengths = listener_layer(p, layer, h, lengths, mask, q)
    names = list(p)
    leaves = {n: p[n].detach().requires_grad_(True) for n in names}
    enc = h.requires_grad_(True)
    sc = model["speller_configs"]
    coins = draws.coins.clone()
    coins[0] = 2.0
    with torch.enable_grad():
        logits = speller(leaves, model, enc, lengths, batch.y.shape[1], q, gold=batch.y,
                         use_gold=(coins <= tf_rate).cpu(), m1=draws.m1,
                         m2=draws.m2 if sc["dec_lstm_dropout"] > 0 else None)
        loss = masked_ce(logits, batch.y, batch.ly)
        spell = [n for n in names if n.startswith("speller.")]
        got = torch.autograd.grad(loss, [leaves[n] for n in spell] + [enc])
    grads = dict(zip(spell, got[:-1]))
    d_out = got[-1]
    del logits, got
    for i in reversed(range(len(layers))):
        layer = layers[i]
        own = [n for n in names if n.startswith(layer[0] + ".")]
        x_in = inputs[i].detach().requires_grad_(i > 0)
        with torch.enable_grad():
            y, _ = listener_layer(leaves, layer, x_in, lens[i], draws.listener_masks[i], q)
            wanted = [leaves[n] for n in own] + ([x_in] if i > 0 else [])
            got = torch.autograd.grad(y, wanted, d_out)
        grads.update(zip(own, got[:len(own)]))
        d_out = got[-1] if i > 0 else None
        del y, got
    return loss.detach(), {n: grads[n] for n in names}


class AdamState:
    """AdamW with amsgrad (optax's order) after clip-by-global-norm."""

    def __init__(self, p: Tree, lr: float, weight_decay: float, grad_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.max_norm = lr, weight_decay, grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {n: torch.zeros_like(v) for n, v in p.items()}
        self.nu = {n: torch.zeros_like(v) for n, v in p.items()}
        self.nu_max = {n: torch.zeros_like(v) for n, v in p.items()}

    @torch.no_grad()
    def step(self, p: Tree, grads: Tree) -> Tree:
        """Updates ``p`` in place; returns the clipped gradient the moments
        took."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        if not bool(norm < self.max_norm):
            grads = {n: g / norm * self.max_norm for n, g in grads.items()}
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for n, g in grads.items():
            self.mu[n] = (1 - self.b1) * g + self.b1 * self.mu[n]
            self.nu[n] = (1 - self.b2) * g * g + self.b2 * self.nu[n]
            self.nu_max[n] = torch.maximum(self.nu_max[n], self.nu[n] / bc2)
            update = (self.mu[n] / bc1) / (torch.sqrt(self.nu_max[n]) + self.eps) + self.wd * p[n]
            p[n] -= self.lr * update
        return grads


def train_steps(p: Tree, model: dict, steps, tf_rate: float, lr: float, opt_cfg: dict,
                grad_norm: float, q=None):
    """Run the training steps ``steps`` ([(batch, draws)]) from ``p`` (updated
    in place). Returns (each step's loss, the first step's clipped gradient
    a leaf)."""
    q = q or rounding(None)
    opt = AdamState(p, lr, opt_cfg.get("weight_decay", 0.0), grad_norm)
    losses, first = [], None
    for batch, draws in steps:
        loss, grads = loss_and_grads(p, model, batch, draws, tf_rate, q)
        clipped = opt.step(p, grads)
        losses.append(float(loss))
        if first is None:
            first = {n: g.clone() for n, g in clipped.items()}
        del grads, clipped
    return losses, first

