"""Synthetic speech-like dataset generator (reference data layout); the
port's own copy of the repository's ``tools/make_synthetic_data.py``, which
writes the same bytes from the same seed.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.make_synthetic_data --out-dir ./synth-data

Generates utterances in the reference's on-disk layout (``mfcc/*.npy`` +
``transcript/raw/*.npy`` + submission template) with learnable
character-to-feature alignment structure:

  * each character has a fixed random 15-dim "formant" prototype;
  * each character occupies a random 4-9 frame segment (duration variation);
  * frames are the prototype plus white noise (controllable SNR).

A correct LAS implementation trained on this data must drive dev Levenshtein
distance to ~0: it exercises the encoder's time downsampling, monotonic
attention learning, teacher forcing and decoding as real speech does,
without shipping a speech corpus. numpy only. Used by the convergence
harness (``tools/convergence_run.py`` beside this file).
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np

LEXICON = [
    "THE", "QUICK", "BROWN", "FOX", "JUMPS", "OVER", "LAZY", "DOG", "AND",
    "CAT", "RUNS", "FAR", "AWAY", "HOME", "IN", "A", "BIG", "RED", "HOUSE",
    "NEAR", "RIVER", "WITH", "TALL", "TREES", "BIRDS", "SING", "ALL", "DAY",
    "LONG", "WHILE", "WE", "WALK", "DOWN", "OLD", "ROAD", "TO", "TOWN",
    "MARKET", "WHERE", "PEOPLE", "BUY", "FRESH", "BREAD", "IT'S", "GOOD",
    "VERY", "NICE", "WARM", "SUN", "SHINES",
]


def sample_utterance(rng: np.random.Generator, words_min: int = 3,
                     words_max: int = 10,
                     frames_per_char: tuple = (4, 9)):
    """Draw one utterance's text and per-character frame durations: the
    generative process of the synthetic corpus, which ``generate`` below
    renders to features."""
    n_words = int(rng.integers(words_min, words_max + 1))
    text = " ".join(rng.choice(LEXICON, size=n_words))
    durations = rng.integers(frames_per_char[0], frames_per_char[1] + 1,
                             size=len(text))
    return text, durations


def generate(out_dir: str, n_train: int = 2000, n_dev: int = 200,
             n_test: int = 200, words_min: int = 3, words_max: int = 10,
             frames_per_char: tuple = (4, 9), noise: float = 0.3,
             n_feats: int = 15, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    # fixed per-character prototypes shared across splits
    proto_rng = np.random.default_rng(seed + 999)
    prototypes = proto_rng.normal(size=(128, n_feats)).astype(np.float32) * 2.0

    splits = [("train-clean-100", n_train), ("dev-clean", n_dev),
              ("test-clean", n_test)]
    for split, count in splits:
        mfcc_dir = os.path.join(out_dir, split, "mfcc")
        raw_dir = os.path.join(out_dir, split, "transcript", "raw")
        os.makedirs(mfcc_dir, exist_ok=True)
        os.makedirs(raw_dir, exist_ok=True)
        for i in range(count):
            text, durations = sample_utterance(rng, words_min, words_max,
                                               frames_per_char)
            frames = [prototypes[ord(ch) % 128][None, :].repeat(dur, axis=0)
                      for ch, dur in zip(text, durations)]
            feats = np.concatenate(frames, axis=0)
            feats = feats + rng.normal(size=feats.shape).astype(np.float32) * noise
            np.save(os.path.join(mfcc_dir, f"utt{i:05d}.npy"),
                    feats.astype(np.float32))
            np.save(os.path.join(raw_dir, f"utt{i:05d}.npy"),
                    np.array(["<sos>"] + list(text) + ["<eos>"]))
        with open(os.path.join(out_dir, split, "transcript",
                               "random_submission.csv"), "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow(["id", "label"])
            for i in range(count):
                writer.writerow([i, "X"])
        print(f"[{split}] {count} utterances")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="synthetic ASR data generator")
    parser.add_argument("--out-dir", default="./synth-data")
    parser.add_argument("--n-train", type=int, default=2000)
    parser.add_argument("--n-dev", type=int, default=200)
    parser.add_argument("--n-test", type=int, default=200)
    parser.add_argument("--noise", type=float, default=0.3)
    parser.add_argument("--seed", type=int, default=0)
    # long-form knobs: --words 25 45 approximates train-clean-100 scale
    # (~1250 frames / ~180 chars per utterance)
    parser.add_argument("--words", type=int, nargs=2, default=(3, 10),
                        metavar=("MIN", "MAX"))
    args = parser.parse_args()
    generate(args.out_dir, args.n_train, args.n_dev, args.n_test,
             words_min=args.words[0], words_max=args.words[1],
             noise=args.noise, seed=args.seed)
