"""The ``chiu`` family: Chiu et al. 2018's LAS (``configs/chiu-las.json``):
80 features a frame stacked with the 3 to their left and cut to every third
frame, a listener of flat BiLSTM layers, an LSTM speller whose attention
scores additively, ``v . tanh(q + k)`` a head, with the leaf
``speller.attention.v``.

The port's route for it: the listener's layer 0 reads 320-wide stacked
frames, more than it projects inside the recurrence, so every layer takes
the x_proj form of #4 and the adjoint #6 (H = 1024); the fused decode
computes dot-product scores only, so the speller runs the step loop, which
launches the additive score's forward (``speller_additive_scores``) once a
decode step and once for the initial query, and its adjoint
(``speller_additive_scores_bwd``) as often. What a family defines: see
``las.py``.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import counts, weights
from benchmark.reference import chiu_ref, las_ref

train_steps = chiu_ref.train_steps
precision = las_ref.precision
control_precision = las_ref.control_precision
FORWARD, ADJOINT = "speller_additive_scores", "speller_additive_scores_bwd"


def stacked(model: dict) -> dict:
    """The model as its listener's layers see it: input frames (left + 1)
    times as wide, and the decode on the step loop (no fused kernels)."""
    lc, sc = model["listener_configs"], model["speller_configs"]
    return {**model,
            "listener_configs": {**lc, "input_dim": lc["input_dim"] * (lc["stack_left"] + 1)},
            "speller_configs": {**sc, "decoder_impl": "scan"}}


def stacked_lengths(model: dict, lx: np.ndarray) -> np.ndarray:
    """Each row's frames after the stacking: ceil(l / stride)."""
    stride = model["listener_configs"]["stack_stride"]
    return -(-np.asarray(lx, np.int64) // stride)


def leaf_specs(model: dict):
    """The ``las`` leaves at the stacked width, then ``speller.attention.v``
    (heads, d_head), uniform +-1/sqrt(d_head) as ``las_init`` draws it."""
    sc = model["speller_configs"]
    heads, d_head = sc["att_heads"], sc["att_proj_dim"] // sc["att_heads"]
    specs = weights.leaf_specs(stacked(model))
    at = 1 + max(i for i, s in enumerate(specs) if s[0].startswith("speller.attention."))
    return specs[:at] + [("speller.attention.v", (heads, d_head), "uniform",
                          1.0 / math.sqrt(d_head))] + specs[at:]


def feature_width(model: dict) -> int:
    return model["listener_configs"]["input_dim"]


def dropout_rates(model: dict) -> list:
    return [rate for _, _, rate in las_ref.listener_layers(model)]


def train_step_flops(model: dict, lx: np.ndarray, ly: np.ndarray) -> float:
    """3 x the forward over the stacked frames; the additive score and the
    context count 2 Te P each a row and step, as the dot product does."""
    return 3 * counts.forward_flops(stacked(model), stacked_lengths(model, lx), ly)


def additive_launches(model: dict, dtype: str, te: int, steps: int,
                      enc_lx: np.ndarray) -> list:
    """The additive score's launches of one train step: its forward and its
    adjoint, each once a decode step and once for the initial query. Bytes:
    the forward reads k at the valid frames, q and v, and writes the scores
    whole; the adjoint reads k at the valid frames, q, v and ds, and writes
    dk whole, dq and dv. Operations: the forward's v . tanh a valid element,
    the adjoint's three products there (dpre, dq's and dv's sums)."""
    e = counts.ELEM[dtype]
    sc = model["speller_configs"]
    proj, heads = sc["att_proj_dim"], sc["att_heads"]
    batch, valid = len(enc_lx), float(np.sum(enc_lx))
    small = batch * proj + proj                        # q, v (and dq, dv)
    fwd = counts.Launch(FORWARD, 2.0 * valid * proj,
                        (valid * proj + small + batch * heads * te) * e, dtype)
    bwd = counts.Launch(ADJOINT, 6.0 * valid * proj,
                        (valid * proj + batch * te * proj + 2 * small + batch * heads * te) * e,
                        dtype)
    return [fwd] * (steps + 1) + [bwd] * (steps + 1)


def train_step_launches(model: dict, dtype: str, t_pad: int, l_pad: int,
                        lx: np.ndarray) -> list:
    """The listener's launches as ``counts`` lists them for the stacked
    input (layer 0 in the x_proj form, frames ceil(l / 3), ``t_pad / 3``
    steps; no #8/#9), then the additive score's."""
    stride = model["listener_configs"]["stack_stride"]
    enc_lx = stacked_lengths(model, lx)
    te = t_pad // stride
    return (counts.train_step_launches(stacked(model), dtype, te, l_pad, enc_lx)
            + additive_launches(model, dtype, te, l_pad, enc_lx))
