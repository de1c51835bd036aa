"""Operations, bytes and peaks: the arithmetic behind the MFU and roofline
metrics, frozen here.

Sources: the model FLOPs follow the port's ``utils/flops.py`` (2 x MACs of
the gate, attention and classifier products), counted over valid frames and,
for a training decode, each row's own label length; training is 3 x the
forward (recomputation not counted). A kernel launch's least time follows
``chip_smoke.py``'s ``bound_ms`` / ``valid_bytes``: the larger of its
operations over the peak of their type and its bytes over the memory
bandwidth, reading each input byte once (of a padded input stream only the
rows at valid frames) and writing each output whole. The peaks are NVIDIA's
H100 SXM data sheet at 700 W (dense): 989.4 TFLOP/s bfloat16 on the tensor
cores, 67 TFLOP/s float32, 3.35 TB/s.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
VOCAB, VOCAB_PADDED = 30, 32
ELEM = {"bfloat16": 2, "float32": 4}
# the widest input the port's listener projects inside the recurrence (its
# ``ops/lstm.py::FUSED_IN_MAX_DIM``); a wider one is projected before it
FUSED_IN_MAX_DIM = 128


class Launch(NamedTuple):
    """One kernel launch: the port's launch counter it bumps, its
    operations and bytes, and the dtype of its operations."""
    counter: str
    flops: float
    nbytes: float
    dtype: str

    def bound_s(self) -> float:
        return max(self.flops / PEAK_FLOPS[self.dtype], self.nbytes / PEAK_BYTES)


def layer_lengths(lx: np.ndarray, plstm_layers: int, lstm_layers: int) -> List[np.ndarray]:
    """Each listener layer's valid frames a row: the base layers at lx, each
    pyramid layer at half the one before (floor)."""
    out, cur = [], np.asarray(lx, np.int64)
    out += [cur] * lstm_layers
    for _ in range(plstm_layers):
        cur = cur // 2
        out.append(cur)
    return out


def _dims(model: dict):
    lc, sc = model["listener_configs"], model["speller_configs"]
    return dict(hid=lc["uniform_hid_dim"], ndir=2 if lc["bidirectional"] else 1,
                d0=lc["input_dim"], nb=lc["lstm_layers"], npy=lc["plstm_layers"],
                proj=sc["att_proj_dim"], heads=sc["att_heads"], emb=sc["dec_emb_dim"],
                h1=sc["dec_lstm_hid_dim"], h2=sc["dec_lstm_out_dim"])


# ---------------------------------------------------------------------------
# Model FLOPs (MFU)
# ---------------------------------------------------------------------------

def forward_flops(model: dict, lx: np.ndarray, dec_steps: np.ndarray) -> float:
    """Forward FLOPs of one batch over its valid frames: the listener's gate
    products a valid frame and direction, the attention keys and values a
    valid encoder frame, and a row's decode steps (``dec_steps`` a row):
    both cells, the query, scores and context over the row's valid encoder
    frames, the tied classifier."""
    d = _dims(model)
    hid, ndir = d["hid"], d["ndir"]
    enc_out = hid * ndir
    total = 0.0
    for i, frames in enumerate(layer_lengths(lx, d["npy"], d["nb"])):
        in_dim = d["d0"] if i == 0 else (enc_out if i < d["nb"] else 2 * enc_out)
        total += 2.0 * frames.sum() * ndir * (in_dim + hid) * 4 * hid
    enc_l = layer_lengths(lx, d["npy"], d["nb"])[-1]
    proj, h1, h2, emb = d["proj"], d["h1"], d["h2"], d["emb"]
    total += 2 * 2.0 * enc_l.sum() * enc_out * proj
    per_step = (2 * (emb + proj + h1) * 4 * h1 + 2 * (h1 + h2) * 4 * h2 + 2 * h2 * proj
                + 2 * 2 * proj * VOCAB)
    steps = np.asarray(dec_steps, np.int64)
    total += float((steps * per_step).sum() + (steps * 4 * proj * enc_l).sum())
    return total


def train_step_flops(model: dict, lx: np.ndarray, ly: np.ndarray) -> float:
    return 3 * forward_flops(model, lx, ly)


# ---------------------------------------------------------------------------
# Kernel launches (rooflines)
# ---------------------------------------------------------------------------

def _lstm_forward(counter, frames, batch, t, in_dim, fused, hid, ndir, train, dt) -> Launch:
    e = ELEM[dt]
    four_h = 4 * hid
    flops = 2.0 * frames * ndir * four_h * (hid + (in_dim if fused else 0))
    width_in = in_dim if fused else ndir * four_h
    nbytes = frames * width_in * e + ndir * hid * four_h * e + batch * 4
    if fused:
        nbytes += ndir * in_dim * four_h * e + ndir * four_h * e
    outs = ndir * hid * (2 if train else 1) + (ndir * four_h if train else 0)  # hs (cs, gates)
    nbytes += batch * t * outs * e
    return Launch(counter, flops, nbytes, dt)


def _lstm_adjoint(counter, frames, batch, t, hid, ndir, with_dw, dt) -> Launch:
    e = ELEM[dt]
    four_h = 4 * hid
    flops = 2.0 * frames * ndir * four_h * hid * (2 if with_dw else 1)
    streams = ndir * four_h + ndir * hid * (3 if with_dw else 2)  # gates, cs, (hs), dy
    nbytes = (frames * streams * e + ndir * hid * four_h * e + batch * 4
              + batch * t * ndir * four_h * e)
    if with_dw:
        nbytes += ndir * hid * four_h * 4
    return Launch(counter, flops, nbytes, dt)


def _speller_cells(d) -> int:
    """MACs a row and step of the products the decode kernels run: cell 1
    over [context; h1] (the embedding is a looked-up row), cell 2, the
    query."""
    proj, h1, h2 = d["proj"], d["h1"], d["h2"]
    return (proj + h1) * 4 * h1 + (h1 + h2) * 4 * h2 + h2 * proj


def _speller_operand_bytes(d, batch, te, e) -> int:
    proj, h1, h2 = d["proj"], d["h1"], d["h2"]
    per_row = 2 * te * proj + te + proj + 2 * h1 + 2 * h2
    weights = (VOCAB_PADDED * 4 * h1 + proj * 4 * h1 + h1 * 4 * h1 + h1 * 4 * h2
               + h2 * 4 * h2 + 4 * h2 + h2 * proj + proj + 2 * proj * VOCAB_PADDED
               + VOCAB_PADDED)
    return (batch * per_row + weights) * e


def _speller_forward(d, batch, te, enc_frames, steps, dt) -> Launch:
    """The decode's training form over ``steps`` teacher-forced steps."""
    e = ELEM[dt]
    proj, h1, h2, heads = d["proj"], d["h1"], d["h2"], d["heads"]
    flops = steps * (2.0 * batch * (_speller_cells(d) + 2 * proj * VOCAB) + 4 * proj * enc_frames)
    nbytes = _speller_operand_bytes(d, batch, te, e)
    nbytes += steps * batch * (VOCAB_PADDED + heads * te) * e + steps * batch * 4  # logits, wgts, ids
    nbytes += steps * batch * 4 * 2                               # forced ids in, fed ids out
    nbytes += steps * batch * (h1 + h2) * e                       # masks
    nbytes += steps * batch * (4 * h1 + 2 * h1 + 4 * h2 + 2 * h2 + proj) * e  # residuals
    return Launch("speller_decode_train", flops, nbytes, dt)


def _speller_adjoint(d, batch, te, enc_frames, steps, dt) -> Launch:
    e = ELEM[dt]
    proj, h1, h2, heads = d["proj"], d["h1"], d["h2"], d["heads"]
    flops = steps * (2.0 * batch * _speller_cells(d) + 4 * proj * enc_frames)
    weights = proj * 4 * h1 + h1 * 4 * h1 + h1 * 4 * h2 + h2 * 4 * h2 + h2 * proj
    ins = (2 * batch * te * proj + weights + batch * (h1 + h2)
           + steps * batch * (4 * h1 + h1 + 4 * h2 + h2 + heads * te + h1 + h2 + 2 * proj))
    outs = steps * batch * (4 * h1 + 4 * h2 + 2 * proj + heads * te)
    nbytes = (ins + outs) * e + batch * (2 * h1 + 2 * h2 + proj) * 4
    return Launch("speller_decode_bwd", flops, nbytes, dt)


def train_step_launches(model: dict, dtype: str, t_pad: int, l_pad: int,
                        lx: np.ndarray) -> List[Launch]:
    """The kernel launches of one train step on a batch, on the route the
    port takes for ``model``: the listener's forward (the training forms;
    under ``remat`` the lean forms first and the training forms again in the
    backward pass; layer 0 in the fused-in form where its input is at most
    ``FUSED_IN_MAX_DIM`` wide, else on a projected input as the other
    layers), each layer's adjoint (with the dW_hh sum up to H = 512, without
    it above), and under ``decoder_impl: pallas`` the decode's training form
    and its adjoint (the scan route's decode launches no kernel of the
    port's). One launch a call: every batch here has at most 128 rows."""
    d = _dims(model)
    hid, ndir = d["hid"], d["ndir"]
    remat = model["listener_configs"].get("remat", False)
    out: List[Launch] = []
    layers = layer_lengths(lx, d["npy"], d["nb"])
    batch = len(lx)
    for i, frames in enumerate(layers):
        fused = i == 0 and d["d0"] <= FUSED_IN_MAX_DIM
        t = t_pad >> max(0, i - d["nb"] + 1)
        n = float(frames.sum())
        in_dim = d["d0"] if fused else 0
        kinds = [False, True] if remat else [True]
        for train in kinds:
            name = ("lstm_scan_fusedin" if fused else "lstm_scan") + ("_train" if train else "")
            out.append(_lstm_forward(name, n, batch, t, in_dim, fused, hid, ndir, train, dtype))
        with_dw = hid <= 512
        out.append(_lstm_adjoint("lstm_bwd_dw" if with_dw else "lstm_bwd", n, batch, t,
                                 hid, ndir, with_dw, dtype))
    if model["speller_configs"].get("decoder_impl", "scan") == "pallas":
        te = t_pad >> d["npy"]
        enc_frames = float(layers[-1].sum())
        out.append(_speller_forward(d, batch, te, enc_frames, l_pad, dtype))
        out.append(_speller_adjoint(d, batch, te, enc_frames, l_pad, dtype))
    return out

