"""The operation and byte counts against hand counts at a tiny shape."""

import numpy as np
import pytest

from benchmark import counts

MODEL = {"listener_configs": {"input_dim": 3, "uniform_hid_dim": 4, "lstm_layers": 1,
                              "plstm_layers": 1, "bidirectional": True},
         "speller_configs": {"att_proj_dim": 2, "att_heads": 1, "dec_emb_dim": 4,
                             "dec_lstm_hid_dim": 4, "dec_lstm_out_dim": 2,
                             "CHR_MAX_STEPS": 5, "decoder_impl": "pallas"}}


def test_forward_flops_by_hand():
    lx, ly = np.array([6, 3]), np.array([2, 1])
    # base layer: 9 valid frames x 2 dirs x 2 x (3 + 4) x 16
    base = 9 * 2 * 2 * 7 * 16
    # pyramid: lengths 3 and 1 -> 4 frames, input 2 x 8 = 16 wide
    pyr = 4 * 2 * 2 * (16 + 4) * 16
    # keys and values over 4 encoder frames of width 8 into 2
    kv = 2 * 2 * 4 * 8 * 2
    per_step = 2 * (4 + 2 + 4) * 16 + 2 * (4 + 2) * 8 + 2 * 2 * 2 + 2 * 4 * counts.VOCAB
    attn = 2 * 4 * 2 * 3 + 1 * 4 * 2 * 1  # steps x 4P x the row's encoder frames
    assert counts.forward_flops(MODEL, lx, ly) == base + pyr + kv + 3 * per_step + attn
    assert counts.train_step_flops(MODEL, lx, ly) == 3 * counts.forward_flops(MODEL, lx, ly)


def test_train_launches_by_hand():
    lx = np.array([6, 3])
    ln = counts.train_step_launches(MODEL, "bfloat16", 8, 4, lx)
    assert [x.counter for x in ln] == ["lstm_scan_fusedin_train", "lstm_bwd_dw", "lstm_scan_train",
                                      "lstm_bwd_dw", "speller_decode_train", "speller_decode_bwd"]
    fwd0 = ln[0]
    assert fwd0.flops == 2 * 9 * 2 * 16 * (4 + 3)
    # x (9 valid frames x 3 x 2 B) + w_hh + lengths + w_ih + b + hs, cs (2 x 8 x 8) + gates (2 x 8 x 32)
    assert fwd0.nbytes == 9 * 3 * 2 + 2 * 4 * 16 * 2 + 2 * 4 + 2 * 3 * 16 * 2 + 2 * 16 * 2 \
        + 2 * 8 * (2 * 8 + 32) * 2
    bwd0 = ln[1]
    assert bwd0.flops == 2 * 9 * 2 * 16 * 4 * 2
    assert bwd0.nbytes == 9 * (32 + 3 * 8) * 2 + 2 * 4 * 16 * 2 + 2 * 4 + 2 * 8 * 32 * 2 + 2 * 4 * 16 * 4
    remat = {**MODEL, "listener_configs": {**MODEL["listener_configs"], "uniform_hid_dim": 1024,
                                           "remat": True}}
    names = [x.counter for x in counts.train_step_launches(remat, "bfloat16", 8, 4, lx)]
    assert names[:3] == ["lstm_scan_fusedin", "lstm_scan_fusedin_train", "lstm_bwd"]


def test_speller_launch_and_bound():
    lx = np.array([6, 3])
    sp = counts.train_step_launches(MODEL, "bfloat16", 8, 4, lx)[-2]
    assert sp.counter == "speller_decode_train"
    cells = (2 + 4) * 16 + (4 + 2) * 8 + 2 * 2
    # 4 label steps x (2 rows x 2 x (cells + the classifier over 2 x 2)) + 4P over the 4 encoder frames
    assert sp.flops == 4 * (2 * 2 * (cells + 2 * 2 * counts.VOCAB) + 4 * 2 * 4)
    assert sp.bound_s() == pytest.approx(max(sp.flops / 989.4e12, sp.nbytes / 3.35e12))
