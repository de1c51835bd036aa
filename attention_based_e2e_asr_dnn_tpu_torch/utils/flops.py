"""Analytic FLOPs model of the LAS compute graph (counterpart of the JAX
``utils/flops.py``): matmul FLOPs (2 x MACs) of the dominant products, the
LSTM gate products, the attention projections, scores and contexts, and the
classifier. Gate math, embeddings and the optimizer are left out (<1% at
these shapes). Feeds the model summary the ``train`` CLI prints, and the
model FLOP utilisation (MFU) of ``tools/bench.py`` and
``tools/profile_step.py``.
"""

from __future__ import annotations

from typing import Optional

import torch


def lstm_layer_flops(batch: int, time: int, in_dim: int, hid: int,
                     bidirectional: bool = True) -> int:
    """Gate-matmul FLOPs of one (Bi)LSTM layer over a padded batch."""
    per_step = 2 * batch * (in_dim + hid) * 4 * hid
    return per_step * time * (2 if bidirectional else 1)


def listener_flops(cfg, batch: int, time: int) -> int:
    """Forward FLOPs of the Listener (base locked stack on the stacked
    frames, then the pyramid)."""
    lc = cfg.listener
    hid = lc.uniform_hid_dim
    enc_out = lc.enc_out_dim
    total = 0
    in_dim = lc.frame_dim
    time = -(-time // lc.stack_stride)
    for _ in range(lc.lstm_layers):
        total += lstm_layer_flops(batch, time, in_dim, hid, lc.bidirectional)
        in_dim = enc_out
    t = time
    for _ in range(lc.plstm_layers):
        t //= 2
        total += lstm_layer_flops(batch, t, 2 * enc_out, hid, lc.bidirectional)
    return total


def speller_flops(cfg, batch: int, dec_steps: int, enc_time: int) -> int:
    """Forward FLOPs of the Speller: K/V precompute + per-step decode."""
    sc = cfg.speller
    proj = sc.att_proj_dim  # total projection width; heads split it
    enc_out = sc.enc_out_dim
    total = 2 * (2 * batch * enc_time * enc_out * proj)  # K/V, once a batch
    q = 2 * batch * sc.dec_lstm_out_dim * proj
    scores = 2 * batch * enc_time * proj
    context = 2 * batch * enc_time * proj
    cell1_in = sc.dec_emb_dim + sc.att_proj_dim
    cell1 = 2 * batch * (cell1_in + sc.dec_lstm_hid_dim) * 4 * sc.dec_lstm_hid_dim
    cell2 = 2 * batch * (sc.dec_lstm_hid_dim + sc.dec_lstm_out_dim) * 4 * sc.dec_lstm_out_dim
    cls = 2 * batch * sc.dec_emb_dim * sc.dec_vocab_size
    return total + dec_steps * (q + scores + context + cell1 + cell2 + cls)


def las_forward_flops(cfg, batch: int, time: int, dec_steps: int) -> int:
    enc_time = time // cfg.listener.time_reduction
    return (listener_flops(cfg, batch, time)
            + speller_flops(cfg, batch, dec_steps, enc_time))


def las_train_step_flops(cfg, batch: int, time: int, label_len: int) -> int:
    """fwd + bwd ~ 3x forward (the usual dense-training approximation)."""
    return 3 * las_forward_flops(cfg, batch, time, dec_steps=label_len)



# peak dense bf16 FLOP/s of a card, by the name torch.cuda.get_device_name
# gives (NVIDIA's data sheet, SXM part, at its 700 W limit)
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def peak_flops_per_chip(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of ``device`` (a ``torch.device`` or a device
    string such as ``"cuda:0"``; default the current card), looked up by the
    name ``torch.cuda.get_device_name`` gives. None for the CPU and for a
    card the table does not name, so that an MFU is never a guess."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return _PEAK_BF16.get(torch.cuda.get_device_name(dev))


def mfu(flops: float, seconds: float, device=None) -> Optional[float]:
    """``flops`` done in ``seconds`` over the device's peak; None where the
    peak is unknown."""
    peak = peak_flops_per_chip(device)
    if peak is None or seconds <= 0:
        return None
    return flops / seconds / peak
