"""Serving latency and throughput of a trained experiment on one card (the
counterpart of the repository's ``tools/serving_bench.py``): a cold
mixed-length stream, the same stream warm, and per-request latency.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.serving_bench --exp <experiment> [--n 256]

Prints one JSON line:

  ready_s         construct ``Transcriber(auto_warmup=<ladder>)`` and
                  ``wait_ready()``: the largest bucket warm (a deployment
                  gates traffic on this, as on a readiness probe);
  cold_utt_s      utterances/s of the ready server on its first stream of
                  ``--n`` utterances of 200-1536 frames (seeded);
  warm_utt_s      the same stream again, the whole ladder warm;
  cold_warm_accuracy_match  the share of transcripts the two passes agree on;
  p50_ms, p99_ms  per-request latency through ``StreamingTranscriber``
                  (``max_wait_ms=15``), one request at a time, for up to
                  128 requests;
  n, card, power_limit_w.

What "cold" means here: the JAX ``Transcriber`` compiles a program for each
(batch, time bucket), so its cold stream pays compiles. PyTorch compiles no
shape. A cold start on the card is the kernels' libraries built with
``nvcc`` and bound (``cuda_build.build_all``, inside ``ready_s``) and the
first batch of each bucket (allocator, library handles); after
``wait_ready`` the cold and warm passes run the same kernels, and their
rates differ by the host and the allocator only.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.serving import StreamingTranscriber, Transcriber
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import card_and_power, require_device


def make_stream(n: int, n_feats: int, seed: int = 0):
    """Mixed-length utterances spanning several time buckets."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(200, 1537, size=(n,))
    return [rng.normal(size=(int(t), n_feats)).astype(np.float32) * 0.5 for t in lengths]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(exp: str, n: int = 256, batch_size: int = 32, pad_time_multiple: int = 256,
        device: str = "cuda", stream=None) -> dict:
    """The record; ``stream`` replaces ``make_stream(n, ...)``'s utterances."""
    dev = require_device(device, "serving_bench")
    ladder = list(range(pad_time_multiple, 1537, pad_time_multiple))
    t0 = time.perf_counter()
    t = Transcriber(exp, batch_size=batch_size, pad_time_multiple=pad_time_multiple,
                    auto_warmup=ladder, device=device)
    t.wait_ready()
    ready_s = time.perf_counter() - t0

    feats = stream if stream is not None else make_stream(n, t.n_feats)
    n = len(feats)
    t0 = time.perf_counter()
    cold = t.transcribe(feats)
    _sync(dev)
    cold_s = n / (time.perf_counter() - t0)

    t.wait_warm()
    t0 = time.perf_counter()
    warm = t.transcribe(feats)
    _sync(dev)
    warm_s = n / (time.perf_counter() - t0)
    same = sum(a == b for a, b in zip(cold, warm)) / n

    st = StreamingTranscriber(t, max_wait_ms=15.0)
    lat = []
    try:
        for f in feats[:min(n, 128)]:
            s = time.perf_counter()
            st.submit(f).result(timeout=600)
            lat.append((time.perf_counter() - s) * 1e3)
    finally:
        st.close()
    card, power = card_and_power(device)
    return {"ready_s": ready_s, "cold_utt_s": cold_s, "warm_utt_s": warm_s,
            "cold_warm_accuracy_match": same,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "n": n, "card": card, "power_limit_w": power}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="serving latency and throughput on one card")
    ap.add_argument("--exp", required=True)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--pad-time-multiple", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.exp, args.n, args.batch_size, args.pad_time_multiple,
                         args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
