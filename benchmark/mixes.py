"""The one traffic generator: reads a mix (``traffic/<mix>.json``) and a
configuration and makes the run's batches.

Utterance lengths follow the synthetic corpus's generative process (a frozen
copy of ``tools/make_synthetic_data.py::sample_utterance`` of the port: a
number of words from a 50-word lexicon, 4-9 frames a character). They are
drawn from the mix's own ``length_seed``, so every run seed gets the same set
of sizes; an utterance longer than ``max_frames`` is drawn again (a corpus
filtered at that duration). The utterances are sorted by frames and cut into
batches of ``batch_size`` (the mix's, else the configuration's), each padded
to a multiple of the configuration's frame and label pads (the
``BucketBatcher`` policy; a copy of ``tools/bench.py::plan_realistic_batches``
with the label pad a parameter). The run seed draws the features, the labels
and the order in which the batches are stepped, pass after pass.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

N_FEATS = 15
LEXICON = [
    "THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "LAZY", "DOG", "AND",
    "CAT", "RUNS", "FAR", "AWAY", "HOME", "IN", "A", "BIG", "RED", "HOUSE",
    "NEAR", "RIVER", "WITH", "TALL", "TREES", "BIRDS", "SING", "ALL", "DAY",
    "LONG", "WHILE", "WE", "WALK", "DOWN", "OLD", "ROAD", "TO", "TOWN",
    "MARKET", "WHERE", "PEOPLE", "BUY", "FRESH", "BREAD", "IT'S", "GOOD",
    "VERY", "NICE", "WARM", "SUN", "SHINES",
]
LABEL_LO, LABEL_HI, PAD_ID = 1, 29, 29  # label ids drawn from [1, 29); 29 pads


def sample_utterance(rng: np.random.Generator, words_min: int, words_max: int,
                     frames_per_char: tuple):
    """One utterance's text and per-character frame durations (frozen copy
    of the port's ``tools/make_synthetic_data.py::sample_utterance``)."""
    n_words = int(rng.integers(words_min, words_max + 1))
    text = " ".join(rng.choice(LEXICON, size=n_words))
    durations = rng.integers(frames_per_char[0], frames_per_char[1] + 1, size=len(text))
    return text, durations


class Plan(NamedTuple):
    """One batch's shape: padded frames and labels, and each row's frames
    and label length (the characters and the end token)."""
    t_pad: int
    l_pad: int
    lx: np.ndarray
    ly: np.ndarray


def lengths(mix: dict):
    """(frames, label lengths) of the mix's utterances, from its own seed."""
    rng = np.random.default_rng(mix["length_seed"])
    frames, labels = [], []
    while len(frames) < mix["utterances"]:
        text, durations = sample_utterance(rng, *mix["words"], tuple(mix["frames_per_char"]))
        n = int(durations.sum())
        if mix.get("max_frames") and n > mix["max_frames"]:
            continue
        frames.append(n)
        labels.append(len(text) + 1)
    return np.array(frames), np.array(labels)


def batch_size(mix: dict, config: dict) -> int:
    return mix.get("batch_size") or config["batch_size"]


def plan_batches(mix: dict, config: dict) -> List[Plan]:
    """The mix's batches: sorted by frames, ``batch_size`` rows each (a last
    partial batch is dropped), padded to the configuration's multiples."""
    frames, labels = lengths(mix)
    order = np.argsort(frames, kind="stable")
    frames, labels = frames[order], labels[order]
    size = batch_size(mix, config)
    pt, pl = config["pad_time_multiple"], config["pad_label_multiple"]
    plans = []
    for i in range(0, len(frames) - len(frames) % size, size):
        fx, ly = frames[i:i + size], labels[i:i + size]
        plans.append(Plan(int(-(-fx.max() // pt) * pt), int(-(-ly.max() // pl) * pl),
                          fx.astype(np.int32), ly.astype(np.int32)))
    return plans


class Batch(NamedTuple):
    x: torch.Tensor   # (B, T, width) float32, zero at padded frames
    lx: torch.Tensor  # (B,) int32
    y: torch.Tensor   # (B, L) int32, PAD_ID past each row's length
    ly: torch.Tensor  # (B,) int32


def make_batch(plan: Plan, gen: torch.Generator, device, width: int = N_FEATS) -> Batch:
    """Features (``width`` a frame: the family's ``feature_width``) and labels
    of one planned batch, drawn on ``device``."""
    b = len(plan.lx)
    lx = torch.as_tensor(plan.lx, device=device)
    ly = torch.as_tensor(plan.ly, device=device)
    x = torch.randn(b, plan.t_pad, width, generator=gen, device=device)
    x = x * (torch.arange(plan.t_pad, device=device)[None, :, None] < lx[:, None, None])
    y = torch.randint(LABEL_LO, LABEL_HI, (b, plan.l_pad), generator=gen, device=device)
    y = torch.where(torch.arange(plan.l_pad, device=device)[None, :] < ly[:, None], y, PAD_ID)
    return Batch(x, lx, y.to(torch.int32), ly)


def make_batches(plans: List[Plan], seed: int, device, width: int = N_FEATS) -> List[Batch]:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    return [make_batch(p, gen, device, width) for p in plans]


def step_order(n_batches: int, seed: int, n_steps: int) -> List[int]:
    """Batch indices for ``n_steps`` steps: a fresh shuffle of every batch
    each pass, from ``seed``."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    out: List[int] = []
    while len(out) < n_steps:
        out.extend(int(i) for i in rng.permutation(n_batches))
    return out[:n_steps]


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each use of the run seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), stream]).generate_state(1, np.uint64)[0]) % (1 << 63)
