"""The model's weights, made from the run's seed on the device.

The tree has the layout of the port's parameter module (and of the JAX
params tree): ``listener.base.<i>.{fwd,bwd}.{w_ih,w_hh,b}``,
``listener.pyramid.<i>...``, ``speller.attention.{key_map,value_map,
query_map}.{w,b}``, ``speller.char_emb``, ``speller.cell{1,2}...``,
``speller.init_{query,h1,c1,h2,c2}``, ``speller.cls_b`` (``leaf_specs``, the
``las`` family's leaves). The distributions are ``las_init``'s: uniform
+-1/sqrt(H) for the LSTMs, +-1/sqrt(fan_in) for the linears, a normal
embedding with a zero PAD row, a uniform [0, 1) initial query, zero initial
states and classifier bias. ``make_flat`` draws any family's leaves in two
calls (one uniform buffer, one normal) on the device, float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

VOCAB = 30
PAD_IDX = 29


def leaf_specs(model: dict) -> List[Tuple[str, tuple, str, float]]:
    """(dotted name, shape, kind, scale) of every leaf; kind is "uniform"
    (scaled to +-scale), "unit" (uniform [0, 1)), "normal", "embedding"
    (normal, its row ``PAD_IDX`` zero) or "zeros"."""
    lc, sc = model["listener_configs"], model["speller_configs"]
    hid, mult = lc["uniform_hid_dim"], 2 if lc["bidirectional"] else 1
    enc_out = hid * mult
    dirs = ("fwd", "bwd") if lc["bidirectional"] else ("",)
    specs = []

    def lstm(prefix, in_dim, h):
        k = 1.0 / math.sqrt(h)
        for name, shape in (("w_ih", (in_dim, 4 * h)), ("w_hh", (h, 4 * h)), ("b", (4 * h,))):
            specs.append((f"{prefix}.{name}", shape, "uniform", k))

    def layer(prefix, in_dim):
        for d in dirs:
            lstm(f"{prefix}.{d}" if d else prefix, in_dim, hid)

    for i in range(lc["lstm_layers"]):
        layer(f"listener.base.{i}", lc["input_dim"] if i == 0 else enc_out)
    for i in range(lc["plstm_layers"]):
        layer(f"listener.pyramid.{i}", 2 * enc_out)
    proj, out = sc["att_proj_dim"], sc["dec_lstm_out_dim"]
    h1, emb = sc["dec_lstm_hid_dim"], sc["dec_emb_dim"]
    for name, in_dim in (("key_map", enc_out), ("value_map", enc_out), ("query_map", out)):
        k = 1.0 / math.sqrt(in_dim)
        specs.append((f"speller.attention.{name}.w", (in_dim, proj), "uniform", k))
        specs.append((f"speller.attention.{name}.b", (proj,), "uniform", k))
    specs.append(("speller.char_emb", (VOCAB, emb), "embedding", 1.0))
    lstm("speller.cell1", emb + proj, h1)
    lstm("speller.cell2", h1, out)
    specs.append(("speller.init_query", (1, out), "unit", 1.0))
    for name, width in (("init_h1", h1), ("init_c1", h1), ("init_h2", out), ("init_c2", out)):
        specs.append((f"speller.{name}", (1, width), "zeros", 0.0))
    specs.append(("speller.cls_b", (VOCAB,), "zeros", 0.0))
    return specs


def make_flat(specs: List[Tuple[str, tuple, str, float]], seed: int,
              device) -> Dict[str, torch.Tensor]:
    """{dotted name: float32 tensor on ``device``} of the leaves ``specs`` (a
    family's ``leaf_specs``) drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    n_uni = sum(math.prod(s) for _, s, kind, _ in specs if kind in ("uniform", "unit"))
    n_norm = sum(math.prod(s) for _, s, kind, _ in specs if kind in ("normal", "embedding"))
    uni = torch.rand(n_uni, generator=gen, device=device)
    norm = torch.randn(n_norm, generator=gen, device=device)
    flat, iu, inorm = {}, 0, 0
    for name, shape, kind, k in specs:
        n = math.prod(shape)
        if kind == "uniform":
            leaf = (uni[iu:iu + n] * 2 - 1) * k
            iu += n
        elif kind == "unit":
            leaf = uni[iu:iu + n]
            iu += n
        elif kind in ("normal", "embedding"):
            leaf = norm[inorm:inorm + n].clone()
            inorm += n
        else:
            leaf = torch.zeros(n, device=device)
        flat[name] = leaf.reshape(shape)
        if kind == "embedding":
            flat[name][PAD_IDX] = 0.0
    return flat


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """Dotted names -> nested dicts and lists (numeric keys become list
    positions), the layout the port's parameter module is built from."""
    root: dict = {}
    for name, leaf in flat.items():
        node, parts = root, name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
