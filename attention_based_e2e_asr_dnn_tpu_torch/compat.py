"""Reference-checkpoint interop: PyTorch ``state_dict`` <-> the params tree
(the port's own copy of the JAX package's ``compat.py``; same names, same
layout conversions, both directions; ``tools/import_reference_ckpt.py``
drives them).

torch ``nn.LSTM`` weights (4H, D) / (4H, H) are transposed to ``w_ih`` (D, 4H)
/ ``w_hh`` (H, 4H), gate order [i, f, g, o] matches, the two biases fold into
one ``b``; ``nn.Linear`` weights transpose to ``w`` (in, out); the embedding
carries over directly. The reference's created-but-never-applied
``final_map`` is dropped on import, and its unregistered ``init_hiddens``
become zero ``init_h*/c*`` leaves. Export goes back to the reference's
names, loadable with ``load_state_dict(strict=True)``: ``final_map`` as
zeros, ``b`` as ``bias_ih`` beside a zero ``bias_hh``, the ``init_h*/c*``
leaves dropped (with a warning where they are non-zero).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np

__all__ = [
    "load_torch_state_dict",
    "las_params_from_state_dict",
    "rewriter_params_from_state_dict",
    "params_from_state_dict",
    "state_dict_from_las_params",
    "state_dict_from_rewriter_params",
]


def _np(a) -> np.ndarray:
    """torch.Tensor / jax.Array / np.ndarray -> float32-preserving ndarray."""
    if hasattr(a, "detach"):  # torch.Tensor without importing torch
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def load_torch_state_dict(path: str, return_meta: bool = False):
    """Read a reference ``.pt`` checkpoint -> {key: ndarray}.

    Unwraps the trainer payload (``model_state_dict``, src/train.py:352) or
    accepts a bare ``state_dict``. ``weights_only=True`` forbids arbitrary
    unpickling — the file can only yield tensors. With ``return_meta``,
    also returns the payload's scalar bookkeeping (``epoch``/``batch``
    counters, src/train.py:352-360) as a second dict.
    """
    import torch

    loaded = torch.load(path, map_location="cpu", weights_only=True)
    meta: Dict[str, int] = {}
    if isinstance(loaded, dict) and "model_state_dict" in loaded:
        for k in ("epoch", "batch"):
            if isinstance(loaded.get(k), int):
                meta[k] = loaded[k]
        loaded = loaded["model_state_dict"]
    sd = {k: _np(v) for k, v in loaded.items()}
    return (sd, meta) if return_meta else sd


# ---------------------------------------------------------------------------
# primitive converters
# ---------------------------------------------------------------------------


def _lstm_dir_in(sd: Mapping, prefix: str, suffix: str = "") -> dict:
    """torch nn.LSTM(num_layers=1) one direction -> {w_ih, w_hh, b}."""
    return {
        "w_ih": np.ascontiguousarray(_np(sd[f"{prefix}.weight_ih_l0{suffix}"]).T),
        "w_hh": np.ascontiguousarray(_np(sd[f"{prefix}.weight_hh_l0{suffix}"]).T),
        "b": _np(sd[f"{prefix}.bias_ih_l0{suffix}"])
        + _np(sd[f"{prefix}.bias_hh_l0{suffix}"]),
    }


def _lstm_in(sd: Mapping, prefix: str) -> dict:
    """One reference stack layer (bidirectional auto-detected)."""
    if f"{prefix}.weight_ih_l0_reverse" in sd:
        return {
            "fwd": _lstm_dir_in(sd, prefix),
            "bwd": _lstm_dir_in(sd, prefix, "_reverse"),
        }
    return _lstm_dir_in(sd, prefix)


def _stack_in(sd: Mapping, fmt: str) -> list:
    """All ``fmt.format(i)`` layers present in the state_dict, in order."""
    layers = []
    while f"{fmt.format(len(layers))}.weight_ih_l0" in sd:
        layers.append(_lstm_in(sd, fmt.format(len(layers))))
    if not layers:
        raise KeyError(f"no LSTM layers found under '{fmt.format(0)}.*'")
    return layers


def _cell_in(sd: Mapping, prefix: str) -> dict:
    """torch nn.LSTMCell -> {w_ih, w_hh, b} (same gate order/fold as LSTM)."""
    return {
        "w_ih": np.ascontiguousarray(_np(sd[f"{prefix}.weight_ih"]).T),
        "w_hh": np.ascontiguousarray(_np(sd[f"{prefix}.weight_hh"]).T),
        "b": _np(sd[f"{prefix}.bias_ih"]) + _np(sd[f"{prefix}.bias_hh"]),
    }


def _linear_in(sd: Mapping, prefix: str) -> dict:
    return {
        "w": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T),
        "b": _np(sd[f"{prefix}.bias"]),
    }


def _attention_in(sd: Mapping, prefix: str) -> dict:
    """K/V/Q maps; the unused reference ``final_map`` is dropped (see module
    docstring)."""
    return {
        "key_map": _linear_in(sd, f"{prefix}.key_map"),
        "value_map": _linear_in(sd, f"{prefix}.value_map"),
        "query_map": _linear_in(sd, f"{prefix}.query_map"),
    }


def _zeros_like_row(h: int) -> np.ndarray:
    return np.zeros((1, h), dtype=np.float32)


def _speller_in(sd: Mapping, p: dict) -> dict:
    """Shared decoder mapping for Speller (``spell.``) and Rewriter roots."""
    emb = _np(sd[p["emb"]])
    cls_w = _np(sd[p["cls"] + ".weight"])
    if cls_w.shape != emb.shape or not np.array_equal(cls_w, emb):
        raise ValueError(
            f"{p['cls']}.weight is not tied to {p['emb']} — the reference "
            f"ties them (src/models.py:287); refusing a checkpoint whose "
            f"classifier diverged from the embedding"
        )
    cell1 = _cell_in(sd, p["cells"] + ".0")
    cell2 = _cell_in(sd, p["cells"] + ".1")
    hid1 = cell1["w_hh"].shape[0]
    hid2 = cell2["w_hh"].shape[0]
    return {
        "attention": _attention_in(sd, p["att"]),
        "char_emb": emb,
        "cell1": cell1,
        "cell2": cell2,
        "init_query": _np(sd[p["init_query"]]),
        # reference init_hiddens are unregistered zeros (src/models.py:275-281)
        "init_h1": _zeros_like_row(hid1),
        "init_c1": _zeros_like_row(hid1),
        "init_h2": _zeros_like_row(hid2),
        "init_c2": _zeros_like_row(hid2),
        "cls_b": _np(sd[p["cls"] + ".bias"]),
    }


_KNOWN_UNUSED = re.compile(r"(^|\.)(final_map)\.(weight|bias)$")


class _RecordingView(Mapping):
    """Read-through view that records which keys the import actually READ.

    The strict leftover check compares against this record (not a pattern),
    so a state_dict whose layer indices are non-contiguous (e.g. layer 1
    missing from a truncated checkpoint) fails loudly instead of silently
    importing a shallower stack — layer 2's keys were never read.
    """

    def __init__(self, sd: Mapping):
        self._sd = sd
        self.read: set = set()

    def __getitem__(self, k):
        self.read.add(k)
        return self._sd[k]

    def __contains__(self, k):  # membership probes are not consumption
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)


def _check_consumed(view: _RecordingView, model: str) -> None:
    leftover = [k for k in view
                if k not in view.read and not _KNOWN_UNUSED.search(k)]
    if leftover:
        raise KeyError(
            f"{model}: unrecognised state_dict keys {sorted(leftover)[:8]} — "
            f"not a reference {model} checkpoint, or a naming drift this "
            f"importer does not know"
        )


def las_params_from_state_dict(sd: Mapping) -> dict:
    """Reference ``ListenAttendSpell.state_dict()`` -> our ``las_init`` tree.

    Layer counts and bidirectionality are inferred from the keys; no config
    needed. Strict like torch's ``load_state_dict``: any key the import did
    not actually read (unknown names, but also orphaned layers after a gap
    in the layer indices) raises.
    """
    view = _RecordingView(sd)
    params = {
        "listener": {
            "base": _stack_in(view, "listen.base.lstms.{}"),
            "pyramid": _stack_in(view, "listen.pyramid.plstms.{}"),
        },
        "speller": _speller_in(
            view,
            {
                "att": "spell.attention",
                "emb": "spell.char_emb.weight",
                "cells": "spell.lstms.lstms",
                "init_query": "spell.init_query",
                "cls": "spell.cls",
            },
        ),
    }
    _check_consumed(view, "ListenAttendSpell")
    return params


def params_from_state_dict(sd: Mapping):
    """Auto-detect the model family and convert -> ``(params, family)``.

    The reference's two families have disjoint key prefixes
    (``ListenAttendSpell``: ``listen.``/``spell.``, src/models.py:500-527;
    ``Rewriter``: ``enc_lstm.``/``dec_lstm.``, src/lmtrain.py:98-253), so a
    bare state_dict identifies itself. Used by ``load_checkpoint`` to make
    reference ``.pt`` files loadable wherever our ``.ckpt`` is accepted.
    """
    if any(k.startswith("listen.") for k in sd):
        return las_params_from_state_dict(sd), "las"
    if any(k.startswith("enc_lstm.") for k in sd):
        return rewriter_params_from_state_dict(sd), "rewriter"
    raise ValueError(
        "state_dict matches neither reference family (no 'listen.*' or "
        f"'enc_lstm.*' keys; got e.g. {sorted(sd)[:4]})"
    )


def rewriter_params_from_state_dict(sd: Mapping) -> dict:
    """Reference ``Rewriter.state_dict()`` -> our ``rewriter_init`` tree.

    Our decoder IS ``speller_init`` (models/rewriter.py:94); the reference's
    3-way shared embedding maps onto the speller-tree ``char_emb`` leaf.
    """
    view = _RecordingView(sd)
    params = {
        "encoder": _stack_in(view, "enc_lstm.lstms.{}"),
        "decoder": _speller_in(
            view,
            {
                "att": "mha",
                "emb": "char_emb.weight",
                "cells": "dec_lstm.lstms",
                "init_query": "init_query",
                "cls": "cls",
            },
        ),
    }
    _check_consumed(view, "Rewriter")
    return params


# ---------------------------------------------------------------------------
# export: our params -> reference naming (migration back / comparison runs)
# ---------------------------------------------------------------------------


def _lstm_dir_out(out: dict, prefix: str, layer: dict, suffix: str = "") -> None:
    out[f"{prefix}.weight_ih_l0{suffix}"] = np.ascontiguousarray(_np(layer["w_ih"]).T)
    out[f"{prefix}.weight_hh_l0{suffix}"] = np.ascontiguousarray(_np(layer["w_hh"]).T)
    b = _np(layer["b"])
    out[f"{prefix}.bias_ih_l0{suffix}"] = b
    out[f"{prefix}.bias_hh_l0{suffix}"] = np.zeros_like(b)


def _stack_out(out: dict, fmt: str, layers: list) -> None:
    for i, layer in enumerate(layers):
        if "fwd" in layer:
            _lstm_dir_out(out, fmt.format(i), layer["fwd"])
            _lstm_dir_out(out, fmt.format(i), layer["bwd"], "_reverse")
        else:
            _lstm_dir_out(out, fmt.format(i), layer)


def _cell_out(out: dict, prefix: str, cell: dict) -> None:
    out[f"{prefix}.weight_ih"] = np.ascontiguousarray(_np(cell["w_ih"]).T)
    out[f"{prefix}.weight_hh"] = np.ascontiguousarray(_np(cell["w_hh"]).T)
    b = _np(cell["b"])
    out[f"{prefix}.bias_ih"] = b
    out[f"{prefix}.bias_hh"] = np.zeros_like(b)


def _linear_out(out: dict, prefix: str, lin: dict) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(lin["w"]).T)
    out[f"{prefix}.bias"] = _np(lin["b"])


def _speller_out(out: dict, spl: dict, p: dict) -> None:
    att = spl["attention"]
    for name in ("key_map", "value_map", "query_map"):
        _linear_out(out, f"{p['att']}.{name}", att[name])
    if "final_map" in att:
        _linear_out(out, f"{p['att']}.final_map", att["final_map"])
    else:
        # reference creates-but-never-applies final_map; strict load needs it
        proj = _np(att["key_map"]["w"]).shape[1]
        out[f"{p['att']}.final_map.weight"] = np.zeros((proj, proj), np.float32)
        out[f"{p['att']}.final_map.bias"] = np.zeros((proj,), np.float32)
    emb = _np(spl["char_emb"])
    out[p["emb"]] = emb
    out[p["cls"] + ".weight"] = emb  # tied (src/models.py:287)
    out[p["cls"] + ".bias"] = _np(spl["cls_b"])
    _cell_out(out, p["cells"] + ".0", spl["cell1"])
    _cell_out(out, p["cells"] + ".1", spl["cell2"])
    out[p["init_query"]] = _np(spl["init_query"])
    # our trained init_h/c have no registered reference slot — dropped, as
    # the reference model would ignore them (src/models.py:275-281). If they
    # actually trained away from zero, that is information loss: say so.
    nonzero = [n for n in ("init_h1", "init_c1", "init_h2", "init_c2")
               if np.any(_np(spl[n]))]
    if nonzero:
        import warnings

        warnings.warn(
            f"trained initial decoder states {nonzero} are non-zero but "
            f"have no registered slot in the reference model "
            f"(src/models.py:275-281) — they are dropped from the exported "
            f"state_dict; re-importing it resets them to zeros",
            stacklevel=3,
        )


def state_dict_from_las_params(params: dict) -> Dict[str, np.ndarray]:
    """Our LAS tree -> reference-named state_dict (loadable strict=True)."""
    out: Dict[str, np.ndarray] = {}
    _stack_out(out, "listen.base.lstms.{}", params["listener"]["base"])
    _stack_out(out, "listen.pyramid.plstms.{}", params["listener"]["pyramid"])
    _speller_out(
        out,
        params["speller"],
        {
            "att": "spell.attention",
            "emb": "spell.char_emb.weight",
            "cells": "spell.lstms.lstms",
            "init_query": "spell.init_query",
            "cls": "spell.cls",
        },
    )
    return out


def state_dict_from_rewriter_params(params: dict) -> Dict[str, np.ndarray]:
    """Our Rewriter tree -> reference-named state_dict."""
    out: Dict[str, np.ndarray] = {}
    _stack_out(out, "enc_lstm.lstms.{}", params["encoder"])
    _speller_out(
        out,
        params["decoder"],
        {
            "att": "mha",
            "emb": "char_emb.weight",
            "cells": "dec_lstm.lstms",
            "init_query": "init_query",
            "cls": "cls",
        },
    )
    return out
