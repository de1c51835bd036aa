"""Forced-decode sequence scoring and the confidence-gated correction
(counterpart of the JAX ``decoding/rescore.py``).

A correction replaces its input only when the model scores it at least
``margin`` average log-probability a character above regenerating the input
verbatim: never worse under the model's own likelihood. The score is a
teacher-forced decode of the candidate (``speller_forced_token_logprobs``),
always forced, with neither coins nor dropout: the plain decode step of
``models/las.py`` in a loop, as the JAX package runs its own plain scan
here. The encoder in front of it takes the config's ``lstm_impl``.

The candidate layouts, the anchor policies, the stacked scoring, the margin
fit and the gate below it are numpy on the host, the JAX module's own code.
The scorers and decode steps they call take numpy arrays or tensors and
return CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    cast_params,
    speller_start,
    speller_step,
)


@torch.inference_mode()
def speller_forced_token_logprobs(params, cfg, enc_h: torch.Tensor, enc_l: torch.Tensor,
                                  cand: torch.Tensor) -> torch.Tensor:
    """Per-position log p(cand[t] | cand[<t], enc) under an always-forced
    decode: (B, L) float32. Position 0 conditions on SOS (the training
    layout); no length masking (callers mask with their own ``lc``)."""
    batch, steps = cand.shape
    cand = cand.long()
    params = cast_params(params, enc_h.dtype)
    cache, state, _ = speller_start(params, cfg, enc_h, enc_l)
    # forced inputs: SOS at t = 0, then cand[t - 1]
    prev = torch.cat([torch.full((batch, 1), cfg.CHR_SOS_IDX, dtype=torch.long,
                                 device=cand.device), cand[:, :-1]], dim=1)
    logits_t = []
    for t in range(steps):
        logits, _, state = speller_step(params, cfg, cache, prev[:, t], state)
        logits_t.append(logits)
    logp = torch.log_softmax(torch.stack(logits_t, dim=1).float(), dim=-1)
    return torch.gather(logp, -1, cand[..., None])[..., 0]


def speller_forced_logprob(params, cfg, enc_h: torch.Tensor, enc_l: torch.Tensor,
                           cand: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    """Average log p(cand | enc) a character under the always-forced decode.

    ``cand`` (B, L) in the training label layout ([SOS, chars..., EOS,
    pad...]); ``lc`` (B,) counts the real positions (SOS and EOS included).
    Returns (B,) float32: the mean over the first ``lc`` positions."""
    steps = cand.shape[1]
    tok_lp = speller_forced_token_logprobs(params, cfg, enc_h, enc_l, cand)
    mask = (torch.arange(steps, device=cand.device)[None, :] < lc[:, None]).float()
    return (tok_lp * mask).sum(dim=1) / torch.clamp(lc, min=1).float()


def make_rewriter_scorer(lm_cfg, compute_dtype=torch.float32):
    """``(params, x, lx, cand, lc) -> (B,) average log-prob a character``,
    a CPU tensor. The encoder runs over the INPUT ids, the forced decode over
    the CANDIDATE, so the scores of the input and of its correction are
    likelihoods of two outputs given the same input."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import rewriter_encode

    sp_cfg = lm_cfg.speller_config()

    @torch.inference_mode()
    def score(params, x, lx, cand, lc) -> torch.Tensor:
        enc_h, enc_l = rewriter_encode(params, lm_cfg, x, lx, compute_dtype)
        dev = enc_h.device
        return speller_forced_logprob(params["decoder"], sp_cfg, enc_h, enc_l,
                                      torch.as_tensor(cand).to(dev),
                                      torch.as_tensor(lc).to(dev)).cpu()

    return score


def make_rewriter_token_scorer(lm_cfg, compute_dtype=torch.float32):
    """``(params, x, lx, cand) -> (B, L) per-token log-probs``, a CPU tensor.
    Scoring the input as its own candidate gives the corrector's confidence
    in each character of it, which picks the anchored rewrite's split."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import rewriter_encode

    sp_cfg = lm_cfg.speller_config()

    @torch.inference_mode()
    def score_tokens(params, x, lx, cand) -> torch.Tensor:
        enc_h, enc_l = rewriter_encode(params, lm_cfg, x, lx, compute_dtype)
        return speller_forced_token_logprobs(params["decoder"], sp_cfg, enc_h, enc_l,
                                             torch.as_tensor(cand).to(enc_h.device)).cpu()

    return score_tokens


def span_anchor_lengths(token_scorer, params, x, lx, conf_tau, fracs):
    """Anchor-length policies for the span-rewrite candidate set.

    Confidence policy ("conf"): score the INPUT as its own forced candidate
    and anchor before the first low-confidence REGION — the per-token
    log-probs smoothed with a W=8 forward moving mean (single bad characters
    are everywhere in a mid-regime input; an isolated dip is not a span
    boundary), first smoothed position under ``log(conf_tau)``, backed off 2
    chars. Fraction policies ("f25"…): fixed fractions of each row's char
    count — measured at the mid-regime operating point, errors concentrate
    in the tail (LAS attention degrades with decode depth), so large
    anchors are strong candidates. Returns [(name, (B,) int32 anchor char
    counts)]; 0 = full rewrite."""
    import numpy as np

    tok_lp = np.asarray(token_scorer(params, x, lx, x))      # (B, W)
    batch, _width = tok_lp.shape
    lx = np.asarray(lx)
    n_chars = np.maximum(lx - 2, 0)                          # minus SOS/EOS
    # candidate position j >= 1 scores char j-1
    char_lp = tok_lp[:, 1:]
    win = 8
    n_cols = char_lp.shape[1]
    char_pos = np.arange(n_cols)[None, :]
    # forward window: smooth[:, i] = mean(char_lp[:, i : i+win]) — a dip
    # must be a REGION starting at i, not a single character. The window is
    # clamped PER ROW to n_chars: positions past the last real char score
    # p(EOS | EOS...) continuations the loss mask never trained, and letting
    # that garbage into the tail windows cut confident endings short.
    csum = np.concatenate(
        [np.zeros((batch, 1)),
         np.cumsum(np.where(char_pos < n_chars[:, None], char_lp, 0.0),
                   axis=1)], axis=1)
    lo = np.arange(n_cols)
    hi = np.minimum(lo[None, :] + win, n_chars[:, None])     # (B, n_cols)
    hi = np.maximum(hi, lo[None, :])                 # empty window past end
    smooth = ((np.take_along_axis(csum, hi, axis=1) - csum[:, lo])
              / np.maximum(hi - lo[None, :], 1))
    low = smooth < np.log(conf_tau)
    low &= char_pos < n_chars[:, None]
    first_bad = np.where(low.any(1), np.maximum(low.argmax(1) - 2, 0),
                         n_chars)
    policies = [("conf", np.minimum(first_bad, n_chars).astype(np.int32))]
    for f in fracs:
        policies.append((f"f{int(round(float(f) * 100)):02d}",
                         (n_chars * float(f)).astype(np.int32)))
    return policies


def span_candidate_families(step_ids, scorer, token_scorer, anchored_step,
                            params, x, lx, conf_tau, fracs, eos_idx: int,
                            sos_idx: int, pad_multiple: int = 32,
                            score_width: int = 0):
    """Every rewrite-candidate family for one batch, scored in ONE stacked
    dispatch: ``"free"`` (the full rewrite passed in as ``step_ids``), the
    prefix-anchored families from :func:`span_anchor_lengths` (``"conf"``,
    ``"fNN"``…), and ``"best"`` (the per-utterance likelihood argmax over
    all of them).

    Returns ``{name: (ids (B, W) int32 training layout, margins (B,))}``
    where ``margins = score(candidate) - score(input)`` under the forced
    scorer — the same quantity the never-worse gate thresholds. Shared by
    lminfer (which FITS the deployed (family, margin) on labeled pairs) and
    serving.Corrector (which applies the fitted policy online).

    ``score_width`` (optional): pad every candidate layout to at least this
    many columns (the JAX package fixes the width so that its compiled
    scorer is not traced again for every batch; here it only sets the
    number of forced steps, whose scores past ``lc`` are masked out)."""
    import numpy as np

    x = np.asarray(x)
    lx = np.asarray(lx)
    batch = x.shape[0]
    anchor_ids = x[:, 1:].astype(np.int32)
    cand = [("free", np.asarray(step_ids))]
    for name, alen in span_anchor_lengths(token_scorer, params, x, lx,
                                          conf_tau, fracs):
        cand.append((name, np.asarray(
            anchored_step(params, x, lx, anchor_ids, alen))))

    min_width = max(x.shape[1], int(score_width))
    layouts = [candidates_to_layout(c, eos_idx, sos_idx, min_width,
                                    pad_multiple) for _, c in cand]
    layouts, c_scores, in_scores = _score_stacked(scorer, params, x, lx,
                                                  layouts, eos_idx)

    fams = {name: (layouts[i][0], c_scores[i] - in_scores)
            for i, (name, _) in enumerate(cand)}
    best = np.argmax(c_scores, axis=0)
    rows = np.arange(batch)
    fams["best"] = (np.stack([layouts[best[b]][0][b] for b in rows]),
                    c_scores[best, rows] - in_scores)
    return fams


def _score_stacked(scorer, params, x, lx, layouts, eos_idx: int):
    """Score N candidate layouts + the input itself in ONE stacked scorer
    call (one encoder pass and one forced decode over N + 1 stacked copies
    of the batch, instead of N + 1 calls of their own).

    ``layouts``: list of (cand (B, W_i), lc (B,)) training-layout pairs.
    Returns ``(layouts_wide, c_scores (N, B), in_scores (B,))`` where every
    returned layout is padded to the common width so per-row gathers
    ("best") and per-family returns stack cleanly. The single shared
    implementation behind :func:`span_candidate_families` and
    :func:`select_among_candidates` — the gate's candidate layout cannot
    drift between them."""
    import numpy as np

    x = np.asarray(x)
    lx = np.asarray(lx)
    batch = x.shape[0]
    n_c = len(layouts)
    width = max(c.shape[1] for c, _ in layouts)
    layouts = [
        (np.pad(c, ((0, 0), (0, width - c.shape[1])),
                constant_values=eos_idx) if c.shape[1] < width else c, lc)
        for c, lc in layouts
    ]
    stacked = np.full(((n_c + 1) * batch, width), eos_idx, np.int32)
    lens = np.zeros(((n_c + 1) * batch,), np.int32)
    for i, (c, lc) in enumerate(layouts):
        stacked[i * batch:(i + 1) * batch] = c
        lens[i * batch:(i + 1) * batch] = lc
    stacked[n_c * batch:, : x.shape[1]] = x          # the input as candidate
    lens[n_c * batch:] = lx
    scores = np.asarray(scorer(
        params, np.concatenate([x] * (n_c + 1), 0),
        np.concatenate([lx] * (n_c + 1), 0), stacked, lens))
    return (layouts, scores[: n_c * batch].reshape(n_c, batch),
            scores[n_c * batch:])


def candidates_to_layout(cand_ids, eos_idx: int, sos_idx: int,
                         min_width: int, pad_multiple: int = 32):
    """Raw decoder output rows (chars then EOS/PAD tail) -> training label
    layout ([SOS, chars..., EOS, EOS-pad...]). Returns (cand (B, W) int32,
    lc (B,) int32); W covers ``min_width`` rounded up to ``pad_multiple``."""
    import numpy as np

    cand_ids = np.asarray(cand_ids)
    batch = cand_ids.shape[0]
    rows, lc = [], np.zeros((batch,), np.int32)
    for b in range(batch):
        row = cand_ids[b]
        stop = np.argmax(row == eos_idx) if (row == eos_idx).any() else len(row)
        trimmed = [t for t in row[:stop].tolist() if t != sos_idx]
        rows.append([sos_idx] + trimmed + [eos_idx])
        lc[b] = len(rows[-1])
    width = max(int(lc.max()), int(min_width))
    width = -(-width // pad_multiple) * pad_multiple
    cand = np.full((batch, width), eos_idx, np.int32)
    for b, row in enumerate(rows):
        cand[b, : len(row)] = row
    return cand, lc


def select_among_candidates(scorer, params, x, lx, cand_ids_list,
                            eos_idx: int, sos_idx: int,
                            pad_multiple: int = 32):
    """Score N rewrite candidates + the input in ONE stacked dispatch and
    pick, per utterance, the candidate the model likes best.

    ``cand_ids_list``: list of (B, steps_i) raw decoder outputs (e.g. the
    full rewrite plus prefix-anchored rewrites at several split policies).
    Returns (best_ids (B, W) int32 in training layout, best_lc (B,),
    margins (B,) = score(best) - score(input)). The never-worse gate then
    applies its (possibly fitted) threshold to ``margins`` exactly as it
    does for the single-candidate chain — candidate sets only widen the
    search, the safety story is unchanged.
    """
    import numpy as np

    x = np.asarray(x)
    lx = np.asarray(lx)
    batch = x.shape[0]

    layouts = [candidates_to_layout(c, eos_idx, sos_idx, x.shape[1],
                                    pad_multiple) for c in cand_ids_list]
    layouts, cand_scores, input_scores = _score_stacked(
        scorer, params, x, lx, layouts, eos_idx)

    best = np.argmax(cand_scores, axis=0)                      # (B,)
    rows = np.arange(batch)
    margins = cand_scores[best, rows] - input_scores
    best_ids = np.stack([layouts[best[b]][0][b] for b in rows])
    best_lc = np.array([layouts[best[b]][1][b] for b in rows], np.int32)
    return best_ids, best_lc, margins


def fit_margin(margins, ld_inputs, ld_corrected):
    """Choose the gate threshold that maximizes total LD improvement on a
    LABELED calibration set: keep a correction iff its score margin exceeds
    the fitted threshold.

    ``margins[i]`` = score(correction_i) - score(input_i);
    ``ld_*[i]`` = Levenshtein distance of each candidate vs gold. Returns
    the threshold (float; ``inf`` when no threshold helps — gate everything
    off). The fitted chain is never-worse ON THE CALIBRATION SET by
    construction; a weak corrector whose likelihood overrates its own
    rewrites (seen at garbage-milestone operating points) gets margined out
    instead of regressing the output.
    """
    import numpy as np

    margins = np.asarray(margins, np.float64)
    if margins.size == 0:       # no calibration pairs -> gate everything off
        return float("inf")     # (never-worse holds trivially)
    gains = np.asarray(ld_inputs, np.float64) - np.asarray(ld_corrected,
                                                           np.float64)
    order = np.argsort(-margins)            # descending margin
    sorted_gains = gains[order]
    kept_margins = margins[order]
    cum = np.cumsum(sorted_gains)           # total gain keeping top-k
    # a strict `m > threshold` gate can only cut between DISTINCT margin
    # values — restrict the argmax to cut points that a threshold can
    # actually realize (tied margins are kept or dropped together)
    achievable = np.ones(margins.size, bool)
    achievable[:-1] = kept_margins[:-1] > kept_margins[1:]
    cand = np.flatnonzero(achievable)
    best_k = int(cand[np.argmax(cum[cand])])
    if cum[best_k] <= 0:
        return float("inf")
    # threshold strictly below the k-th kept margin (and above the next)
    lo = kept_margins[best_k + 1] if best_k + 1 < len(kept_margins) else (
        kept_margins[best_k] - 1.0)
    return float((kept_margins[best_k] + lo) / 2.0)


def gate_corrections(scorer, params, x, lx, corrected_ids, eos_idx: int,
                     sos_idx: int, margin: float = 0.0,
                     pad_multiple: int = 32):
    """Keep a correction only when the model scores it ``margin`` avg
    log-prob/char above regenerating the input — never-worse under the
    model's own likelihood.

    ``x``/``lx``: the batched input prediction ids ([SOS..EOS] layout, padded
    with EOS). ``corrected_ids`` (B, steps): raw decoder argmax/beam output
    (chars then EOS, no leading SOS). Returns (use_correction (B,) bool,
    score_corr, score_input).
    """
    import numpy as np

    x = np.asarray(x)
    lx = np.asarray(lx)
    batch = x.shape[0]

    # corrected candidate in the training label layout: SOS + trimmed + EOS
    cand, lc = candidates_to_layout(corrected_ids, eos_idx, sos_idx,
                                    x.shape[1], pad_multiple)
    width = cand.shape[1]
    x_wide = np.full((batch, width), eos_idx, np.int32)
    x_wide[:, : x.shape[1]] = x

    # ONE stacked call scores both candidates (rows 0..B-1 = the
    # correction, rows B..2B-1 = regenerating the input)
    scores = np.asarray(scorer(
        params,
        np.concatenate([x, x], 0), np.concatenate([lx, lx], 0),
        np.concatenate([cand, x_wide], 0), np.concatenate([lc, lx], 0)))
    score_corr, score_input = scores[:batch], scores[batch:]
    use = score_corr > score_input + margin
    return use, score_corr, score_input


class RewriteChain:
    """The Rewriter's correction of one batch, the chain that ``lminfer`` and
    ``serving.Corrector`` both run: the rewrite step (beam search for
    ``beam_size > 1``, else the early-exit greedy decode, or with
    ``early_stop=False`` the fixed ``CHR_MAX_STEPS`` decode, the fused decode
    kernel under ``decoder_impl: pallas``), then with ``gate`` the forced
    scorer's margin of each rewrite over its input, and with ``span_rewrite``
    the prefix-anchored candidate families instead of the one rewrite.

    ``chain(params, x, lx)`` returns ``{family: (ids (B, W), margins (B,) or
    None)}``: the family ``"rewrite"`` (margins None without the gate), or
    those of :func:`span_candidate_families`. ``score_width`` as there."""

    def __init__(self, lm_cfg, compute_dtype=torch.float32, beam_size: int = 0,
                 length_alpha: float = 0.0, max_len_factor: float = 3.0,
                 early_stop: bool = True, gate: bool = True, span_rewrite: bool = False,
                 span_conf_tau: float = 0.5, span_fracs=(0.25, 0.5, 0.75, 0.9),
                 score_width: int = 0):
        from attention_based_e2e_asr_dnn_tpu_torch.decoding import greedy

        if beam_size > 1:
            from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import (
                make_rewriter_beam_step,
            )

            self.step = make_rewriter_beam_step(
                lm_cfg, beam_size=beam_size, length_alpha=length_alpha,
                compute_dtype=compute_dtype, max_len_factor=max_len_factor)
        elif early_stop:
            self.step = greedy.make_rewriter_greedy_step(
                lm_cfg, compute_dtype=compute_dtype, max_len_factor=max_len_factor)
        else:
            self.step = _fixed_decode_step(lm_cfg, compute_dtype)
        self.scorer = make_rewriter_scorer(lm_cfg, compute_dtype) if gate else None
        self.span = None
        self.families = {"rewrite"}
        if span_rewrite:
            self.span = {
                "anchored_step": greedy.make_rewriter_anchored_step(
                    lm_cfg, compute_dtype=compute_dtype, max_len_factor=max_len_factor),
                "token_scorer": make_rewriter_token_scorer(lm_cfg, compute_dtype),
                "conf_tau": float(span_conf_tau),
                "fracs": [float(f) for f in span_fracs],
            }
            self.families = {"free", "conf", "best"} | {
                f"f{int(round(f * 100)):02d}" for f in self.span["fracs"]}
        self.score_width = score_width

    def check_family(self, family: str, hint: str = "") -> None:
        """Raise ``ValueError`` unless ``family`` is one this chain returns."""
        if family not in self.families:
            raise ValueError(f"span_family {family!r} not one of "
                             f"{sorted(self.families)}{hint}")

    def __call__(self, params, x, lx) -> dict:
        from attention_based_e2e_asr_dnn_tpu_torch.constants import EOS_IDX, SOS_IDX

        ids = np.asarray(self.step(params, x, lx))
        if self.span is not None:
            return span_candidate_families(
                ids, self.scorer, self.span["token_scorer"], self.span["anchored_step"],
                params, x, lx, self.span["conf_tau"], self.span["fracs"], EOS_IDX,
                SOS_IDX, score_width=self.score_width)
        if self.scorer is None:
            return {"rewrite": (ids, None)}
        _, s_corr, s_in = gate_corrections(self.scorer, params, x, lx, ids, EOS_IDX,
                                           SOS_IDX, margin=0.0)
        return {"rewrite": (ids, s_corr - s_in)}


def _fixed_decode_step(lm_cfg, compute_dtype):
    """The fixed ``CHR_MAX_STEPS`` free-running decode: (params, x ids, lx)
    -> ids on the CPU; the inputs may be numpy arrays."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import rewriter_apply
    from attention_based_e2e_asr_dnn_tpu_torch.training.steps import make_infer_step

    infer_step = make_infer_step(
        lambda p, x, lx: rewriter_apply(p, lm_cfg, x, lx, compute_dtype=compute_dtype))

    def step(params, x, lx):
        dev = params["decoder"]["char_emb"].device
        return infer_step(params, torch.as_tensor(x).to(dev), torch.as_tensor(lx).to(dev)).cpu()

    return step
