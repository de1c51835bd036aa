"""Config system: YAML -> attribute tree with ``configs``-splat semantics
(the port's own copy of the JAX package's ``config.py``).

Nested dicts become attribute objects, except dicts stored under keys ending
in ``configs``, which stay plain dicts so they can be ``**``-splatted into
constructors. The resolved config is snapshotted as ``config.json`` in the
experiment folder and re-read at inference time to rebuild the exact model.
"""

from __future__ import annotations

import json
import os
from typing import Any

import yaml


class Config:
    """Attribute-access view over a (nested) config dict.

    Keys ending in ``configs`` keep their dict value verbatim (splat semantics,
    reference: src/utils.py:31); other dict values recurse into ``Config``.
    """

    def __init__(self, cfg_dict: dict):
        self._raw = cfg_dict
        self.__dict__.update(cfg_dict)
        for key, value in list(self.__dict__.items()):
            if key == "_raw":
                continue
            if not key.endswith("configs") and isinstance(value, dict):
                self.__dict__[key] = Config(value)

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def to_dict(self) -> dict:
        return self._raw

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Config({json.dumps(self._raw, indent=2, default=str)})"


def cfg_float(cfg: Any, key: str, default: float) -> float:
    """Read a float config value, using ``default`` only when the key is absent
    or explicitly null.

    Unlike ``getattr(cfg, key, None) or default``, an explicit ``0`` survives —
    0 is the documented "disable the cap" value for ``max_len_factor``
    (decoding/greedy.py:81, decoding/beam.py:104).
    """
    value = getattr(cfg, key, None)
    return default if value is None else float(value)


def load_yaml(path: str) -> dict:
    with open(path, "r") as fh:
        return yaml.safe_load(fh)


def load_config(path: str) -> Config:
    """Load a YAML (or snapshotted JSON) config file into a Config tree."""
    if path.endswith(".json"):
        with open(path, "r") as fh:
            return Config(json.load(fh))
    return Config(load_yaml(path))


def snapshot_config(cfg_dict: dict, exp_dir: str, name: str = "config.json") -> str:
    """Write the resolved config dict into the experiment folder.

    Parity with the reference snapshot (reference: src/train.py:527); inference
    re-reads this file to reconstruct the exact model (src/infer.py:99).
    """
    os.makedirs(exp_dir, exist_ok=True)
    out_path = os.path.join(exp_dir, name)
    with open(out_path, "w") as fh:
        json.dump(cfg_dict, fh, indent=4, default=str)
    return out_path


def inject_vocab(cfg_dict: dict, vocab: list, vocab_map: dict, sos_key: str = "<sos>",
                 eos_key: str = "<eos>") -> dict:
    """Inject vocab-derived keys into a training config dict.

    Parity with the reference's derived-config injection (reference:
    src/train.py:503-510): vocabulary size + SOS/PAD indices are injected into
    the speller configs and top-level VOCAB/VOCAB_MAP/SOS_IDX/EOS_IDX recorded
    for the inference-time round trip.
    """
    speller = cfg_dict["model"]["configs"].setdefault("speller_configs", {})
    speller["dec_vocab_size"] = len(vocab)
    speller["CHR_SOS_IDX"] = vocab_map[sos_key]
    speller["CHR_PAD_IDX"] = vocab_map[eos_key]
    cfg_dict["VOCAB"] = list(vocab)
    cfg_dict["VOCAB_MAP"] = dict(vocab_map)
    cfg_dict["EOS_IDX"] = vocab_map[eos_key]
    cfg_dict["SOS_IDX"] = vocab_map[sos_key]
    return cfg_dict
