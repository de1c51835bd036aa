"""The ``.ckpt`` checkpoint format, read and written without JAX
(counterpart of the JAX ``training/checkpoints.py``).

A ``.ckpt`` is an npz archive: ``__record__`` holds a JSON record
(``meta``, ``params_tree`` — the params tree with ``"@i"`` placeholders —
and ``n_opt_leaves``), ``p{i}`` the params leaves and ``o{i}`` the flat
optimizer-state leaves. Loading never executes code from the file. Files
written by either package load in the other.

Reference PyTorch ``.pt`` checkpoints load through the reference package's
``compat`` converters (``weights_only=True``). The JAX package's legacy
pickle checkpoints are not read here.

``CheckpointManager`` is the Trainer's policy, the JAX package's: a save on
any new best of dev loss, dev LD or dev perplexity under a composite tag
(``min-loss-ld-ppl-epoch[N].ckpt``), at most ``max_savings`` of them kept
(the oldest goes first), and a milestone copy every tenth epoch.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import List, Optional

import numpy as np


def _as_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # torch.Tensor
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _encode_tree(tree, leaves: list):
    """Nested dicts/lists -> JSON skeleton with '@i' leaf placeholders."""
    if isinstance(tree, dict):
        return {k: _encode_tree(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_encode_tree(v, leaves) for v in tree]
    leaves.append(_as_numpy(tree))
    return f"@{len(leaves) - 1}"


def _decode_tree(skel, leaves: dict):
    if isinstance(skel, dict):
        return {k: _decode_tree(v, leaves) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_decode_tree(v, leaves) for v in skel]
    return leaves[skel]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def save_checkpoint(path: str, payload: dict) -> str:
    """Save ``payload``: ``params`` (a tree of numpy arrays or tensors),
    optional ``opt_state`` (a flat list of leaves), the rest as metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, meta = {}, {}
    params_skel, n_opt = None, 0
    for key, value in payload.items():
        if key == "params" and value is not None:
            leaves: list = []
            params_skel = _encode_tree(value, leaves)
            arrays.update({f"p{i}": leaf for i, leaf in enumerate(leaves)})
        elif key == "opt_state" and value is not None:
            n_opt = len(value)
            arrays.update({f"o{i}": _as_numpy(leaf) for i, leaf in enumerate(value)})
        else:
            meta[key] = value
    record = {"meta": meta, "params_tree": params_skel, "n_opt_leaves": n_opt}
    arrays["__record__"] = np.frombuffer(
        json.dumps(record, default=float).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    return path


def _load_torch_checkpoint(path: str) -> dict:
    """Reference ``.pt`` -> params-only payload via ``compat``."""
    from attention_based_e2e_asr_dnn_tpu_torch import compat

    sd, meta = compat.load_torch_state_dict(path, return_meta=True)
    params, family = compat.params_from_state_dict(sd)
    out = {"params": params, "opt_state": None, "torch_import": family}
    out.update(meta)
    return out


def load_checkpoint(path: str) -> dict:
    """Load a ``.ckpt`` (or a reference ``.pt``). ``params`` comes back as a
    tree of numpy arrays, ``opt_state`` as a flat leaf list or None."""
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: not an npz checkpoint or a zip-format "
                         f"torch checkpoint")
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
    if "__record__.npy" not in names:
        if any(n.rsplit("/", 1)[-1] == "data.pkl" for n in names):
            return _load_torch_checkpoint(path)
        raise ValueError(f"{path}: zip archive is neither an npz checkpoint "
                         f"(no __record__) nor a torch checkpoint (no data.pkl)")
    with np.load(path, allow_pickle=False) as z:
        record = json.loads(bytes(z["__record__"]).decode("utf-8"))
        out = dict(record["meta"])
        if record["params_tree"] is not None:
            n_params = sum(1 for k in z.files if k.startswith("p"))
            leaves = {f"@{i}": z[f"p{i}"] for i in range(n_params)}
            out["params"] = _decode_tree(record["params_tree"], leaves)
        out["opt_state"] = ([z[f"o{i}"] for i in range(record["n_opt_leaves"])]
                            if record["n_opt_leaves"] else None)
    return out


def list_best_checkpoints(ckpt_dir: str) -> List[str]:
    """Best-tag checkpoint filenames (``min-*.ckpt``, reference
    ``min-*.pt``) in a ckpts/ folder, name-sorted; a ``.pt`` whose
    same-stem ``.ckpt`` exists is skipped."""
    names = [f for f in os.listdir(ckpt_dir)
             if f.startswith("min") and f.endswith((".ckpt", ".pt"))]
    ckpt_stems = {os.path.splitext(f)[0] for f in names if f.endswith(".ckpt")}
    return sorted(f for f in names if f.endswith(".ckpt")
                  or os.path.splitext(f)[0] not in ckpt_stems)


def average_checkpoints(paths: List[str]) -> dict:
    """Uniform parameter average over checkpoints (float64 sum, float32 out)."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    for p in paths:
        params = load_checkpoint(p)["params"]
        if acc is None:
            acc = _tree_map(lambda a: np.asarray(a, np.float64) / len(paths), params)
        else:
            acc = _tree_map(lambda a, b: a + np.asarray(b, np.float64) / len(paths),
                            acc, params)
    return {"params": _tree_map(lambda a: np.asarray(a, np.float32), acc)}


class CheckpointManager:
    """Best/milestone checkpoint policy (reference: src/train.py:321-368).
    ``write=False`` (a data-parallel rank other than 0) keeps the policy's
    state, the same on every rank, and writes nothing."""

    def __init__(self, ckpt_dir: str, milestone_dir: Optional[str] = None,
                 max_savings: int = 3, write: bool = True):
        self.write = write
        self.ckpt_dir = ckpt_dir
        self.milestone_dir = milestone_dir
        self.max_savings = max_savings
        self.saved_files: List[str] = []  # exact basenames, eviction order
        self.min_loss = float("inf")
        self.min_ld = float("inf")
        self.min_ppl = float("inf")
        if not write:
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        if milestone_dir:
            os.makedirs(milestone_dir, exist_ok=True)

    def reset_best(self) -> None:
        self.min_loss = self.min_ld = self.min_ppl = float("inf")
        self.saved_files = []

    def maybe_save(self, epoch: int, dev_loss: float, dev_ld: float,
                   dev_ppl: float, payload) -> Optional[str]:
        """Save on any new best (composite tag) and on 10-epoch milestones.
        ``payload``: the checkpoint dict, or a function that makes it (called
        only where something is written)."""
        tag = "min"
        if dev_loss <= self.min_loss:
            self.min_loss = dev_loss
            tag += "-loss"
        if dev_ld < self.min_ld:
            self.min_ld = dev_ld
            tag += "-ld"
        if dev_ppl <= self.min_ppl:
            self.min_ppl = dev_ppl
            tag += "-ppl"
        is_best = len(tag) > 3
        is_milestone = epoch > 0 and (epoch + 1) % 10 == 0

        saved = None
        made: list = []

        def write(path: str) -> None:
            if self.write:
                if not made:
                    made.append(payload() if callable(payload) else payload)
                save_checkpoint(path, made[0])

        if is_best:
            if len(self.saved_files) >= self.max_savings:
                # by exact basename: a suffix match would also hit the
                # emergency-epoch[N].ckpt crash saves
                evict_path = os.path.join(self.ckpt_dir, self.saved_files.pop(0))
                if self.write and os.path.exists(evict_path):
                    os.remove(evict_path)
            name = f"{tag}-epoch[{epoch}].ckpt"
            saved = os.path.join(self.ckpt_dir, name)
            write(saved)
            self.saved_files.append(name)
        if is_milestone and self.milestone_dir:
            write(os.path.join(self.milestone_dir, f"epoch[{epoch}].ckpt"))
        return saved

    def list_checkpoints(self) -> List[str]:
        return sorted(os.path.join(self.ckpt_dir, f)
                      for f in os.listdir(self.ckpt_dir) if f.endswith(".ckpt"))
