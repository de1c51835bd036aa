"""Chiu et al. 2018's LAS in plain float32 PyTorch, whole: the yardstick the
CPU tests hold the port's ``chiu-las`` path to (``tests/test_torch_chiu_las.py``).

From the paper ("State-of-the-art Speech Recognition With
Sequence-to-Sequence Models", arXiv:1712.01769, sec. 3):

- front end: each frame stacked with the ``stack_left`` frames to its left,
  zeros before the start, and every ``stack_stride``-th stacked frame kept
  (80 log-mel channels, 3 left, stride 3: 320 inputs at a 30 ms rate); a row
  of l frames gives ceil(l / stride);
- listener: bidirectional LSTM layers, no pyramid; gate order [i, f, g, o]
  with one bias; the carry frozen past a row's length and the output zero
  there; the reverse direction from a zero carry at the row's last frame;
- attention: ``heads`` heads, frame t of head h scored ``v[h] .
  tanh(q[h] + k[t, h])`` (Bahdanau et al. 2015), unscaled; padded frames
  masked before the softmax; the context the weights times the values;
- speller: two LSTM cells, cell 1 over [embedding of the fed id; context],
  cell 2 over cell 1's output; the query projected from cell 2's output;
  logits from [query; context] through the classifier.

Departures from the paper (the configuration's ``assumed``): keys, values and
the query are projected per head by ``key_map``, ``value_map`` and
``query_map``; the classifier is tied to the embedding (so the embedding is
twice the attention's width); the 30 characters of the port's vocabulary;
the training of base-LAS: locked dropout after each listener layer (one mask
a row and feature) and on both cells' outputs (the dropped value carried),
SpecAugment, teacher forcing by one coin a step (step 0 never forced; else
the first maximum of the previous logits fed back), the masked token-mean
cross-entropy; no label smoothing, scheduled sampling or MWER.

Leaves are a flat dict of the port's dotted names. Imports nothing of the
port or of JAX.
"""

from __future__ import annotations

import torch

VOCAB = 30


def stack_frames(x, lengths, left: int, stride: int):
    """(B, T, F) -> (B, ceil(T / stride), (left + 1) F), lengths ceil(l / stride)."""
    batch, steps, feats = x.shape
    n_out = -(-steps // stride)
    padded = torch.cat([x.new_zeros(batch, left, feats), x], dim=1)
    out = torch.stack([padded[:, k * stride:k * stride + left + 1].reshape(batch, -1)
                       for k in range(n_out)], dim=1)
    return out, -(-lengths.long() // stride)


def lstm_direction(p, prefix, x, lengths, reverse: bool):
    """One direction over (B, T, D): (B, T, H), zero at padded frames."""
    batch, steps, _ = x.shape
    hid = p[prefix + ".w_hh"].shape[0]
    h = x.new_zeros(batch, hid)
    c = x.new_zeros(batch, hid)
    out = [None] * steps
    for t in (reversed(range(steps)) if reverse else range(steps)):
        pre = x[:, t] @ p[prefix + ".w_ih"] + h @ p[prefix + ".w_hh"] + p[prefix + ".b"]
        i, f, g, o = pre.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        out[t] = h_new * valid
    return torch.stack(out, dim=1)


def listener(p, model, x, lengths, masks=None):
    """The front end and the BiLSTM stack, locked dropout after each layer
    where ``masks`` (keep masks (B, 1, 2H), one a layer) are given."""
    lc = model["listener_configs"]
    h, lengths = stack_frames(x, lengths, lc["stack_left"], lc["stack_stride"])
    for i in range(lc["lstm_layers"]):
        pre = f"listener.base.{i}"
        h = torch.cat([lstm_direction(p, pre + ".fwd", h, lengths, False),
                       lstm_direction(p, pre + ".bwd", h, lengths, True)], dim=-1)
        if masks is not None and masks[i] is not None:
            rate = lc["mid_dropout"] if i else lc["init_dropout"]
            h = h * masks[i].float() / (1.0 - rate)
    return h, lengths


def speller(p, model, enc, enc_l, steps: int, gold=None, use_gold=None, m1=None, m2=None):
    """Logits (B, steps, V) of the decode; without ``use_gold`` free-running."""
    sc = model["speller_configs"]
    heads, proj, emb_dim = sc["att_heads"], sc["att_proj_dim"], sc["dec_emb_dim"]
    keep = 1.0 - sc["dec_lstm_dropout"]
    batch, te, _ = enc.shape
    d_head = proj // heads
    a = "speller.attention."
    keys = (enc @ p[a + "key_map.w"] + p[a + "key_map.b"]).reshape(batch, te, heads, d_head)
    vals = (enc @ p[a + "value_map.w"] + p[a + "value_map.b"]).reshape(batch, te, heads, d_head)
    pad = torch.arange(te)[None, :, None] >= enc_l[:, None, None]               # (B, Te, 1)

    def attend(h2):
        query = h2 @ p[a + "query_map.w"] + p[a + "query_map.b"]
        qh = query.reshape(batch, 1, heads, d_head)
        scores = (torch.tanh(qh + keys) * p[a + "v"]).sum(-1)                    # (B, Te, h)
        wgts = torch.softmax(scores.masked_fill(pad, float("-inf")), dim=1)
        return query, (wgts[..., None] * vals).sum(1).reshape(batch, proj)

    def cell(x, h, c, name):
        pre = x @ p[f"speller.{name}.w_ih"] + h @ p[f"speller.{name}.w_hh"] + p[f"speller.{name}.b"]
        i, f, g, o = pre.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    emb = p["speller.char_emb"]
    _, ctx = attend(p["speller.init_query"].expand(batch, -1))
    h1, c1 = p["speller.init_h1"].expand(batch, -1), p["speller.init_c1"].expand(batch, -1)
    h2, c2 = p["speller.init_h2"].expand(batch, -1), p["speller.init_c2"].expand(batch, -1)
    prev = torch.zeros(batch, dtype=torch.long)
    out = []
    for t in range(steps):
        ids = gold[:, t - 1].long() if use_gold is not None and t > 0 and bool(use_gold[t]) else prev
        h1, c1 = cell(torch.cat([emb[ids], ctx], dim=-1), h1, c1, "cell1")
        if m1 is not None:
            h1 = h1 * m1[t].float() / keep
        h2, c2 = cell(h1, h2, c2, "cell2")
        if m2 is not None:
            h2 = h2 * m2[t].float() / keep
        query, ctx = attend(h2)
        logits = torch.cat([query, ctx], dim=-1) @ emb.T + p["speller.cls_b"]
        prev = torch.argmax(logits.detach(), dim=-1)
        out.append(logits)
    assert emb_dim == 2 * proj
    return torch.stack(out, dim=1)


def specaugment(x, spec):
    """One frequency and one time mask shared by the batch: start = unit *
    (size - width), positions start <= p < start + width zeroed."""
    _, steps, feats = x.shape

    def keep(size, width, unit):
        start = unit.float() * (size - width.float())
        pos = torch.arange(size, dtype=torch.float32)
        return ~((pos >= start) & (pos < start + width.float()))

    return (x * keep(feats, spec.freq_width, spec.freq_start)[None, None, :]
            * keep(steps, spec.time_width, spec.time_start)[None, :, None])


def masked_ce(logits, y, ly):
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, y[..., None].long())[..., 0]
    mask = (torch.arange(y.shape[1])[None, :] < ly[:, None]).float()
    return (ce * mask).sum() / mask.sum()


def train_loss(p, model, x, lx, y, ly, draws, tf_rate: float):
    """The training loss of one batch under ``draws`` (the port's
    ``TrainDraws``: listener masks, coins, m1, m2, SpecAugment's draws)."""
    x = specaugment(x.float(), draws.specaug)
    enc, enc_l = listener(p, model, x, lx, draws.listener_masks)
    coins = draws.coins.clone()
    coins[0] = 2.0
    logits = speller(p, model, enc, enc_l, y.shape[1], gold=y, use_gold=coins <= tf_rate,
                     m1=draws.m1, m2=draws.m2)
    return masked_ce(logits, y, ly)


def loss_and_grads(p, model, x, lx, y, ly, draws, tf_rate: float):
    """(loss, {leaf: gradient}) in float32."""
    leaves = {n: t.detach().float().requires_grad_(True) for n, t in p.items()}
    loss = train_loss(leaves, model, x, lx, y, ly, draws, tf_rate)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(leaves[n]) if g is None else g
                           for n, g in zip(leaves, grads)}


def eval_logits(p, model, x, lx, steps: int):
    """The free-running greedy decode's logits (B, steps, V)."""
    with torch.no_grad():
        leaves = {n: t.float() for n, t in p.items()}
        enc, enc_l = listener(leaves, model, x.float(), lx)
        return speller(leaves, model, enc, enc_l, steps)
