"""The Rewriter, the sequence-to-sequence corrector of LAS transcripts
(counterpart of the JAX ``models/rewriter.py``).

A character embedding feeds a BiLSTM encoder; the decoder is the speller's
attend-decode machinery (two LSTM cells, cross-attention, the tied
classifier) over the text's encodings, so its config is a
``SpellerConfig`` (``RewriterConfig.speller_config``) and its parameters a
speller tree. The embedding is shared three ways: the encoder's input, the
decoder's input and, transposed, the classifier's weight.

Parameters live in ``Rewriter``, a ``ParamTree`` named by the JAX params
tree's paths (``encoder.<i>.fwd.w_ih``, ..., ``decoder.char_emb``,
``decoder.init_h1``); ``rewriter_from_jax_params`` /
``rewriter_to_jax_params`` carry the whole tree both ways.

``lstm_impl: pallas`` runs the encoder's layers on the LSTM kernels
(``ops/lstm_cuda.py``; an embedding wider than 128 takes ``lstm_scan`` over
the projected input) and ``decoder_impl: pallas`` the decoder on the fused
decode kernels (``ops/speller_cuda.py``), as for the LAS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    ParamTree,
    SpellerConfig,
    SpellerOutput,
    TrainDraws,
    _tree_to_numpy,
    char_embedding_init,
    lstm_layer_init,
    speller_apply,
    speller_init,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.dropout import draw_keep_mask
from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm import locked_lstm_stack_apply


@dataclass(frozen=True)
class RewriterConfig:
    vocab_size: int = 30
    emb_dim: int = 256
    enc_lstm_layers: int = 3
    enc_lstm_hid_dim: int = 256
    enc_dropouts: Sequence[float] = (0.3, 0.3)
    att_proj_dim: int = 128
    att_heads: int = 4
    att_dropout: float = 0.2
    dec_lstm_layers: int = 2  # accepted for parity; the decoder is the 2-cell stack
    dec_lstm_hid_dim: int = 256
    dec_lstm_out_dim: int = 128
    dec_lstm_dropout: float = 0.3
    CHR_PAD_IDX: int = 29
    CHR_MAX_STEPS: int = 600
    CHR_SOS_IDX: int = 0
    legacy_scale: bool = False
    # "pallas": the decoder on the fused decode kernels; "scan": the step loop
    decoder_impl: str = "scan"
    # "pallas": the encoder's layers on the LSTM kernels; "scan": the plain loops
    lstm_impl: str = "scan"

    @property
    def enc_out_dim(self) -> int:
        return 2 * self.enc_lstm_hid_dim  # bidirectional encoder

    def speller_config(self) -> SpellerConfig:
        """The decoder as a ``SpellerConfig``."""
        return SpellerConfig(
            enc_out_dim=self.enc_out_dim,
            att_proj_dim=self.att_proj_dim,
            att_heads=self.att_heads,
            att_dropout=self.att_dropout,
            dec_vocab_size=self.vocab_size,
            dec_emb_dim=self.emb_dim,
            dec_emb_dropout=0.0,
            dec_lstm_hid_dim=self.dec_lstm_hid_dim,
            dec_lstm_out_dim=self.dec_lstm_out_dim,
            dec_lstm_dropout=self.dec_lstm_dropout,
            CHR_MAX_STEPS=self.CHR_MAX_STEPS,
            CHR_PAD_IDX=self.CHR_PAD_IDX,
            CHR_SOS_IDX=self.CHR_SOS_IDX,
            legacy_scale=self.legacy_scale,
            decoder_impl=self.decoder_impl,
        )


class Rewriter(ParamTree):
    """The Rewriter parameter tree ({"encoder": [...], "decoder": ...})."""

    def __init__(self, tree: dict):
        if set(tree) != {"encoder", "decoder"}:
            raise ValueError(f"Rewriter params need exactly encoder and decoder, "
                             f"got {sorted(tree)}")
        super().__init__(tree)


def rewriter_from_jax_params(tree: dict) -> Rewriter:
    """JAX Rewriter params tree (nested dicts/lists of arrays) -> module."""
    return Rewriter(tree)


def rewriter_to_jax_params(module: Rewriter) -> dict:
    """Module -> JAX Rewriter params tree of float32 numpy arrays."""
    return _tree_to_numpy(module)


def rewriter_init(cfg: RewriterConfig, generator: torch.Generator) -> Rewriter:
    """Fresh parameters with the JAX ``rewriter_init`` distributions (those of
    the LAS: uniform LSTMs and linears, a normal embedding with a zero PAD
    row)."""
    sp_cfg = cfg.speller_config()
    hid = cfg.enc_lstm_hid_dim
    encoder = [lstm_layer_init(cfg.emb_dim if i == 0 else 2 * hid, hid, True, generator)
               for i in range(cfg.enc_lstm_layers)]
    emb = char_embedding_init(sp_cfg, generator)
    return Rewriter({"encoder": encoder, "decoder": speller_init(sp_cfg, emb, generator)})


def _param_device(params) -> torch.device:
    return params["decoder"]["char_emb"].device


def rewriter_encode(params, cfg: RewriterConfig, x, lx, compute_dtype=None,
                    train: bool = False, masks: Optional[list] = None):
    """The encoder over char ids: (B, T) ids and lengths, numpy arrays or
    tensors -> (encodings (B, T, 2 H), lengths) on the parameters' device.
    The bfloat16 policy applies at the embedding lookup (the inputs are
    ids). In training with ``masks`` (one (B, 1, 2H) keep mask a layer),
    locked dropout after each layer."""
    dev = _param_device(params)
    x = torch.as_tensor(x).to(dev).long()
    lx = torch.as_tensor(lx).to(dev)
    emb = params["decoder"]["char_emb"]
    if compute_dtype is not None:
        emb = emb.to(compute_dtype)
    train = train and masks is not None
    return locked_lstm_stack_apply(
        params["encoder"], emb[x], lx, bidirectional=True, impl=cfg.lstm_impl,
        init_dropout=float(cfg.enc_dropouts[0]) if train else 0.0,
        mid_dropout=float(cfg.enc_dropouts[-1]) if train else 0.0,
        train=train, masks=masks)


def draw_rewriter_noise(cfg: RewriterConfig, batch: int, steps: int,
                        generator: Optional[torch.Generator], device) -> TrainDraws:
    """Every random number of one Rewriter training pass, from ``generator``
    on ``device`` (the JAX ``rewriter_apply`` draws the same from its key):
    one (B, 1, 2H) locked-dropout keep mask per encoder layer, at
    ``enc_dropouts[0]`` after layer 0 and ``enc_dropouts[-1]`` after the
    rest (None at rate 0); the decoder's ``steps`` teacher-forcing coins; and
    its cells' output masks m1 (L, B, H1) and m2 (L, B, H2) at
    ``dec_lstm_dropout``. No SpecAugment: the inputs are ids."""
    rates = [float(cfg.enc_dropouts[-1] if i else cfg.enc_dropouts[0])
             for i in range(cfg.enc_lstm_layers)]
    masks = [draw_keep_mask((batch, 1, cfg.enc_out_dim), r, generator, device) if r > 0.0
             else None for r in rates]
    coins = torch.rand((steps,), generator=generator, device=device)
    rate = cfg.dec_lstm_dropout
    m1 = m2 = None
    if rate > 0.0:
        m1 = draw_keep_mask((steps, batch, cfg.dec_lstm_hid_dim), rate, generator, device)
        m2 = draw_keep_mask((steps, batch, cfg.dec_lstm_out_dim), rate, generator, device)
    return TrainDraws(masks, coins, m1, m2)


def rewriter_apply(params, cfg: RewriterConfig, x, lx, dec_y: Optional[torch.Tensor] = None,
                   tf_rate=1.0, init_force: bool = False, train: bool = False,
                   compute_dtype=None, draws: Optional[TrainDraws] = None,
                   generator: Optional[torch.Generator] = None) -> SpellerOutput:
    """(B, T) char ids -> the decoder's logits (the JAX ``rewriter_apply``).

    Eval: the free-running decode of ``CHR_MAX_STEPS`` steps. Training
    (``train=True``, ``dec_y`` given): the teacher-forced decode, whose coins
    and dropout masks come from ``draws`` (``listener_masks`` are the
    encoder's, one a layer) or, when only a ``generator`` is given, are drawn
    from it (``draw_rewriter_noise``); with neither there is neither forcing
    nor dropout, as in the JAX package without a key (the gate's forced
    scoring). ``init_force`` is taken for the Trainer's interface and
    unused."""
    del init_force
    if train and draws is None and generator is not None and dec_y is not None:
        draws = draw_rewriter_noise(cfg, int(torch.as_tensor(lx).shape[0]), dec_y.shape[1],
                                    generator, _param_device(params))
    masks = None if draws is None else draws.listener_masks
    enc_h, enc_l = rewriter_encode(params, cfg, x, lx, compute_dtype, train=train, masks=masks)
    if dec_y is not None:
        dec_y = dec_y.to(enc_h.device)
    return speller_apply(params["decoder"], cfg.speller_config(), enc_h, enc_l, dec_y,
                         tf_rate, init_force=False, train=train, draws=draws)
