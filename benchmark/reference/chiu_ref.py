"""Chiu et al. 2018's LAS in plain PyTorch, float32 with TF32 off: the
yardstick the benchmark holds the port's ``chiu-las`` outputs to.

Written from the paper ("State-of-the-art Speech Recognition With
Sequence-to-Sequence Models", arXiv:1712.01769, sec. 3) and Bahdanau et al.
2015's additive attention, not from the port: each frame of features
stacked with the 3 frames to its left (zeros before the start) and only
every third stacked frame kept, so a row of l frames gives ceil(l / 3); a
listener of bidirectional LSTM layers with no pyramid (``las_ref``'s layer:
gate order [i, f, g, o], the carry frozen past a row's length, the reverse
direction from a zero carry, locked dropout after each layer); an attention
of ``heads`` heads, each scoring encoder frame t by ``v[h] . tanh(q[h] +
k[t, h])`` (keys and values projected once, the query from the decoder's
output each step, no scale), masked softmax, the context of the projected
values; a decoder of two LSTM cells whose output and context feed a
classifier tied to the embedding. Departures from the paper, as the
configuration's ``assumed`` lists them: the values projected per head; the
attention's width 1,024; the tied classifier (``dec_emb_dim`` = 2 x the
attention's width); the port's 30 characters; base-LAS's training settings
(dropout, SpecAugment, teacher forcing at 0.9, masked token-mean
cross-entropy, clip-by-global-norm then AdamW with amsgrad); no label
smoothing, scheduled sampling or MWER.

Every product's operands pass through ``q`` (``las_ref.rounding``), the
additive score's too (the query, the keys and ``v``). Memory: the speller
runs in row blocks of ``ROWS`` rows, each under autograd alone, its loss the
block's share of the batch's token mean; summed over the blocks the
gradient is the whole batch's up to float32 summation order. Whole, the
additive score would keep a (B, heads, Te, d_head) float32 tanh each step,
268 MB at the cell's widths and 256 steps of them. The listener keeps only
its layers' inputs and runs each layer again under autograd when its
gradient is due, as ``las_ref`` does. Imports nothing of the measured
program.
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference import las_ref
from benchmark.reference.las_ref import Tree

ROWS = 32


def stack_frames(x: torch.Tensor, lengths: torch.Tensor, left: int, stride: int):
    """(B, T, F) -> (B, ceil(T / stride), (left + 1) F): output frame k holds
    input frames stride k - left, ..., stride k, oldest first, zero where
    the index is below 0 (or past T); lengths ceil(l / stride)."""
    batch, steps, feats = x.shape
    n_out = -(-steps // stride)
    idx = (torch.arange(n_out, device=x.device)[:, None] * stride
           + torch.arange(-left, 1, device=x.device)[None, :])           # (T', left + 1)
    inside = (idx >= 0) & (idx < steps)
    frames = x[:, idx.clamp(0, steps - 1)] * inside[None, :, :, None].to(x.dtype)
    return frames.reshape(batch, n_out, (left + 1) * feats), -(-lengths.long() // stride)


def speller(p: Tree, model: dict, enc: torch.Tensor, enc_l: torch.Tensor, steps: int, q,
            gold: torch.Tensor, use_gold: torch.Tensor, m1=None, m2=None) -> torch.Tensor:
    """The decode over ``steps`` steps with the additive score: logits (B,
    steps, V). Step t feeds ``gold[:, t - 1]`` where ``use_gold[t]``, else the
    first maximum of step t - 1's logits (0 at t = 0); ``m1`` / ``m2`` (steps,
    B, H) are the cells' keep masks."""
    sc = model["speller_configs"]
    heads, proj, emb_dim = sc["att_heads"], sc["att_proj_dim"], sc["dec_emb_dim"]
    keep = 1.0 - sc["dec_lstm_dropout"]
    batch, te, _ = enc.shape
    d_head = proj // heads
    pre = "speller."
    emb = p[pre + "char_emb"]
    encq = q(enc)
    keys = encq @ q(p[pre + "attention.key_map.w"]) + p[pre + "attention.key_map.b"]
    vals = encq @ q(p[pre + "attention.value_map.w"]) + p[pre + "attention.value_map.b"]
    keys = q(keys.reshape(batch, te, heads, d_head).transpose(1, 2))   # (B, h, Te, dh)
    vals = q(vals.reshape(batch, te, heads, d_head).transpose(1, 2))
    v = q(p[pre + "attention.v"])[None, :, None, :]                      # (1, h, 1, dh)
    pad = (torch.arange(te, device=enc.device)[None, :] >= enc_l[:, None].long())[:, None, :]
    w_q, b_q = q(p[pre + "attention.query_map.w"]), p[pre + "attention.query_map.b"]

    def attend(h2):
        query = q(h2) @ w_q + b_q
        qh = q(query.reshape(batch, heads, d_head))[:, :, None, :]
        scores = (torch.tanh(qh + keys) * v).sum(-1).masked_fill(pad, float("-inf"))
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
        ids = gold[:, t - 1].long() if t > 0 and bool(use_gold[t]) else prev
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


def loss_and_grads(p: Tree, model: dict, batch, draws, tf_rate: float, q):
    """The training loss of one batch and the gradient of every leaf of
    ``p``: the listener forward without a graph, keeping each layer's input;
    the decode and its loss under autograd a row block at a time; then each
    listener layer again, last first, its gradient taken from the one
    above."""
    lc, sc = model["listener_configs"], model["speller_configs"]
    layers = las_ref.listener_layers(model)
    with torch.no_grad():
        x = las_ref.specaugment(batch.x.float(), draws.specaug)
        h, lengths = stack_frames(x, batch.lx, lc["stack_left"], lc["stack_stride"])
        inputs = []
        for layer, mask in zip(layers, draws.listener_masks):
            inputs.append(h)
            h, _ = las_ref.listener_layer(p, layer, h, lengths, mask, q)
    names = list(p)
    spell = [n for n in names if n.startswith("speller.")]
    steps = batch.y.shape[1]
    coins = draws.coins.clone()
    coins[0] = 2.0
    use_gold = (coins <= tf_rate).cpu()
    tokens = (torch.arange(steps, device=h.device)[None, :] < batch.ly[:, None].long()).sum(1)
    n_tok = float(tokens.sum())
    dropped = sc["dec_lstm_dropout"] > 0
    grads = {n: torch.zeros_like(p[n]) for n in spell}
    d_out = torch.zeros_like(h)
    loss = 0.0
    for r0 in range(0, h.shape[0], ROWS):
        r = slice(r0, r0 + ROWS)
        leaves = {n: p[n].detach().requires_grad_(True) for n in spell}
        enc = h[r].detach().requires_grad_(True)
        with torch.enable_grad():
            logits = speller(leaves, model, enc, lengths[r], steps, q, batch.y[r], use_gold,
                             m1=draws.m1[:, r] if dropped else None,
                             m2=draws.m2[:, r] if dropped else None)
            share = las_ref.masked_ce(logits, batch.y[r], batch.ly[r]) * (
                float(tokens[r].sum()) / n_tok)
            got = torch.autograd.grad(share, [leaves[n] for n in spell] + [enc])
        for n, g in zip(spell, got):
            grads[n] += g
        d_out[r] = got[-1]
        loss += float(share.detach())
        del logits, got, share
    leaves = {n: p[n].detach().requires_grad_(True) for n in names if n not in grads}
    for i in reversed(range(len(layers))):
        layer = layers[i]
        own = [n for n in names if n.startswith(layer[0] + ".")]
        x_in = inputs[i].detach().requires_grad_(i > 0)
        with torch.enable_grad():
            y, _ = las_ref.listener_layer(leaves, layer, x_in, lengths, draws.listener_masks[i], q)
            got = torch.autograd.grad(y, [leaves[n] for n in own] + ([x_in] if i > 0 else []),
                                      d_out)
        grads.update(zip(own, got[:len(own)]))
        d_out = got[-1] if i > 0 else None
        del y, got
    return torch.tensor(loss), {n: grads[n] for n in names}


def train_steps(p: Tree, model: dict, steps, tf_rate: float, lr: float, opt_cfg: dict,
                grad_norm: float, q: Optional[object] = None):
    """``las_ref.train_steps`` with this model's loss: each step's loss and
    the first step's clipped gradient a leaf; ``p`` updated in place."""
    q = q or las_ref.rounding(None)
    opt = las_ref.AdamState(p, lr, opt_cfg.get("weight_decay", 0.0), grad_norm)
    losses, first = [], None
    for batch, draws in steps:
        loss, grads = loss_and_grads(p, model, batch, draws, tf_rate, q)
        clipped = opt.step(p, grads)
        losses.append(float(loss))
        if first is None:
            first = {n: g.clone() for n, g in clipped.items()}
        del grads, clipped
    return losses, first
