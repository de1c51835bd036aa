"""Beam search over the attend-spell decoder (counterpart of the JAX
``decoding/beam.py``).

The hypotheses of a batch form one (B * K) super-batch, so the speller's
plain decode step (``models/las.py::speller_step``) runs unchanged; the
encoder's keys and values are projected once and repeated K times.
Finished hypotheses extend only with <eos> at no cost, so a score freezes at
its first <eos>. Each step's tokens and backpointers go into (steps, B, K)
buffers; the best sequence is walked back on the host
(``decoding/select.py``), optionally length-normalised by
``len ** length_alpha``.

As in the JAX package: beam 0 starts live and the others at ``NEG_INF``,
scores are float32 whatever the compute dtype, ``exact_prune`` (with
``length_alpha == 0``) freezes a live hypothesis that falls below a finished
one, a row is force-finished past ``max_len_factor`` characters per encoder
frame, and the loop exits once every hypothesis is finished, the steps not
written keeping PAD tokens and identity parents so that the backtrace walks
through them unchanged. The top K of each row's K x V candidates are taken
by a stable descending sort, so that equal scores keep the lower index
first, as ``jax.lax.top_k`` does (``torch.topk`` promises no order among
ties, and bfloat16 logits tie often).

The step is plain PyTorch: the JAX beam has no Pallas kernel inside either.
The listener in front of it runs on the kernels under ``lstm_impl:
pallas``, and the dev pass's free-running loss decode
(``make_las_eval_beam_step``) on the fused decode kernel under
``decoder_impl: pallas``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.decoding.select import (  # noqa: F401
    backtrace,
    backtrace_all,
    select_best_sequences,
)
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    DecodeState,
    SpellerConfig,
    cast_params,
    listener_apply,
    speller_apply,
    speller_step,
)
from attention_based_e2e_asr_dnn_tpu_torch.parallel.dp import gather_rows, global_ce_metrics
from attention_based_e2e_asr_dnn_tpu_torch.ops.attention import (
    AttentionCache,
    cross_attention_precompute,
    cross_attention_step,
)

NEG_INF = -1e30


@torch.inference_mode()
def _beam_decode(params, cfg: SpellerConfig, enc_h: torch.Tensor, enc_l: torch.Tensor,
                 beam_size: int, max_steps: int, exact_prune: bool = False,
                 max_len_factor: float = 3.0):
    """The beam loop (the JAX ``_beam_decode_scan``). Returns numpy arrays
    (tokens, parents, finished) (steps, B, K) and (scores, finished) (B, K)
    of the last step."""
    batch = enc_h.shape[0]
    K, vocab, dev = beam_size, cfg.dec_vocab_size, enc_h.device
    dtype = enc_h.dtype
    params = cast_params(params, dtype)
    cache1 = cross_attention_precompute(params["attention"], enc_h, enc_l, cfg.att_heads)
    cache = AttentionCache(*(t.repeat_interleave(K, dim=0) for t in cache1))
    bk = batch * K

    def init(name, width):
        return params[name].expand(bk, width)

    context, _, _ = cross_attention_step(params["attention"], cache,
                                         init("init_query", cfg.dec_lstm_out_dim),
                                         cfg.att_heads, cfg.legacy_scale)
    state = DecodeState(init("init_h1", cfg.dec_lstm_hid_dim),
                        init("init_c1", cfg.dec_lstm_hid_dim),
                        init("init_h2", cfg.dec_lstm_out_dim),
                        init("init_c2", cfg.dec_lstm_out_dim), context)
    char = torch.full((bk,), cfg.CHR_SOS_IDX, dtype=torch.long, device=dev)
    # beam 0 live, the others dead, so that step 0 does not pick K copies
    scores = torch.full((batch, K), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((batch, K), dtype=torch.bool, device=dev)
    eos_only = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=dev)
    eos_only[cfg.CHR_PAD_IDX] = 0.0
    row_cap = (max_len_factor * enc_l.to(torch.float32) if max_len_factor > 0
               else torch.full((batch,), float(max_steps), device=dev))
    tokens = torch.full((max_steps, batch, K), cfg.CHR_PAD_IDX, dtype=torch.int32, device=dev)
    parents = torch.arange(K, dtype=torch.int32, device=dev).expand(max_steps, batch, K).clone()
    fin = torch.ones((max_steps, batch, K), dtype=torch.bool, device=dev)

    def gather_beams(x, parent):
        xk = x.reshape(batch, K, -1)
        idx = parent[:, :, None].expand(-1, -1, xk.shape[2])
        return torch.gather(xk, 1, idx).reshape(bk, -1)

    for t in range(max_steps):
        if bool(finished.all()):
            break
        logits, _, state = speller_step(params, cfg, cache, char, state)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(batch, K, vocab)
        logp = torch.where(finished[:, :, None], eos_only, logp)
        flat = (scores[:, :, None] + logp).reshape(batch, K * vocab)
        ordered, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        new_scores, idx = ordered[:, :K], idx[:, :K]
        parent = idx // vocab
        token = idx % vocab
        state = DecodeState(*(gather_beams(x, parent) for x in state))
        finished_new = torch.gather(finished, 1, parent) | (token == cfg.CHR_PAD_IDX)
        finished_new = finished_new | (t + 1 >= row_cap[:, None])
        if exact_prune:
            # log-probabilities only fall, so a live hypothesis below a
            # finished one can never win: freezing it lets the early exit
            # fire as soon as the outcome is decided (the argmax is unchanged)
            best_fin = torch.where(finished_new, new_scores,
                                   torch.full_like(new_scores, NEG_INF)).amax(1, keepdim=True)
            finished_new = finished_new | (new_scores < best_fin)
        tokens[t] = token.to(torch.int32)
        parents[t] = parent.to(torch.int32)
        fin[t] = finished_new
        char = token.reshape(bk)
        scores, finished = new_scores, finished_new
    return (tokens.cpu().numpy(), parents.cpu().numpy(), fin.cpu().numpy(),
            scores.cpu().numpy(), finished.cpu().numpy())


def beam_search(params, cfg: SpellerConfig, enc_h: torch.Tensor, enc_l: torch.Tensor,
                beam_size: int = 8, max_steps: int = 0, length_alpha: float = 0.0,
                max_len_factor: float = 3.0) -> np.ndarray:
    """Beam search over precomputed encodings: (B, max_steps) int32 best
    sequences, PAD after the first <eos>. ``max_len_factor`` 0 disables the
    length cap."""
    max_steps = max_steps or cfg.CHR_MAX_STEPS
    tokens, parents, _, final_scores, _ = _beam_decode(
        params, cfg, enc_h, enc_l, beam_size, max_steps,
        exact_prune=(length_alpha == 0.0), max_len_factor=max_len_factor)
    return select_best_sequences(tokens, parents, final_scores, cfg.CHR_PAD_IDX,
                                 length_alpha, max_steps)


def make_las_beam_step(las_cfg, beam_size: int, length_alpha: float = 0.0,
                       compute_dtype=torch.float32, max_steps: int = 0,
                       max_len_factor: float = 3.0):
    """Beam decode with the greedy step's interface: (params, x, lx) -> ids
    (B, steps) int32 on the CPU. The listener runs once, on the kernels
    under ``lstm_impl: pallas``."""
    steps = max_steps or las_cfg.speller.CHR_MAX_STEPS

    @torch.inference_mode()
    def step(params, x: torch.Tensor, lx: torch.Tensor) -> torch.Tensor:
        if x.is_floating_point():
            x = x.to(compute_dtype)
        enc_h, enc_l = listener_apply(params["listener"], las_cfg.listener, x, lx)
        return torch.from_numpy(beam_search(
            params["speller"], las_cfg.speller, enc_h, enc_l, beam_size=beam_size,
            max_steps=steps, length_alpha=length_alpha, max_len_factor=max_len_factor))

    return step


def make_las_eval_beam_step(las_cfg, beam_size: int, length_alpha: float = 0.0,
                            compute_dtype=torch.float32, max_steps: int = 0,
                            max_len_factor: float = 3.0, mesh=None):
    """The dev pass of a beam run: ``step(params, x, lx, y, ly, want_ids)
    -> (metrics, beam ids | None)``. The listener runs once a batch; its
    encodings feed the free-running loss decode, cut to the label horizon
    (greedy logits at step t depend only on the decoded prefix, so the first
    ``y.shape[1]`` steps equal the full decode's), and the beam search.
    Under ``decoder_impl: pallas`` the loss decode is the fused decode
    kernel's eval form.

    ``mesh`` (a ``parallel.mesh.DataMesh``; the JAX package's data-parallel
    mesh): the step takes the rank's rows; the listener, the loss decode and
    the beam run on them (on the kernels, per rank), the loss is the global
    token mean (the CE sum and the raw token count all-reduced, a rank of
    padding rows adding nothing), and the beam ids are gathered: every rank
    gets the global batch's."""
    from attention_based_e2e_asr_dnn_tpu_torch.training.loss import masked_ce_loss

    steps = max_steps or las_cfg.speller.CHR_MAX_STEPS

    @torch.inference_mode()
    def step(params, x, lx, y, ly, want_ids: bool = True):
        if x.is_floating_point():
            x = x.to(compute_dtype)
        enc_h, enc_l = listener_apply(params["listener"], las_cfg.listener, x, lx)
        n_steps = min(steps, int(y.shape[1]))
        sp_cfg = dataclasses.replace(las_cfg.speller, CHR_MAX_STEPS=n_steps)
        logits = speller_apply(params["speller"], sp_cfg, enc_h, enc_l).logits
        args = (logits[:, :n_steps], y[:, :n_steps], torch.clamp(ly, max=n_steps))
        if mesh is None:
            loss, n_tokens = masked_ce_loss(*args)
            metrics = {"loss": loss, "ppl": torch.exp(loss), "n_tokens": n_tokens}
        else:
            metrics = global_ce_metrics(*args, mesh)
        ids = None
        if want_ids:
            ids = beam_search(
                params["speller"], las_cfg.speller, enc_h, enc_l, beam_size=beam_size,
                max_steps=steps, length_alpha=length_alpha, max_len_factor=max_len_factor)
            if mesh is not None:
                ids = gather_rows(mesh, ids)
            ids = torch.from_numpy(ids)
        return metrics, ids

    return step


def make_rewriter_beam_step(lm_cfg, beam_size: int, length_alpha: float = 0.0,
                            compute_dtype=torch.float32, max_steps: int = 0,
                            max_len_factor: float = 3.0):
    """Beam decode for the Rewriter: (params, x ids, lx) -> ids (B, steps)
    int32 on the CPU; the inputs may be numpy arrays. The encoder takes the
    config's ``lstm_impl`` (the JAX step always runs its scan encoder: the
    same function, rounded differently in bfloat16)."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import rewriter_encode

    steps = max_steps or lm_cfg.CHR_MAX_STEPS
    sp_cfg = lm_cfg.speller_config()

    @torch.inference_mode()
    def step(params, x, lx):
        enc_h, enc_l = rewriter_encode(params, lm_cfg, x, lx, compute_dtype)
        return torch.from_numpy(beam_search(
            params["decoder"], sp_cfg, enc_h, enc_l, beam_size=beam_size,
            max_steps=steps, length_alpha=length_alpha, max_len_factor=max_len_factor))

    return step
