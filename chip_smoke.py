#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (attention_based_e2e_asr_dnn_tpu_torch) once
on one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py

1. The card's name and power limit, the torch / CUDA / nvcc versions, and
   the time to build the kernels from ``csrc/``.
2. Each kernel against its plain PyTorch version on the same CUDA tensors at
   the shapes base-LAS serving gives it (B=32, H=512; listener layer 0 at
   T=1024 with D=15, pyramid layer 1 at T=512 over a 2 x 4H projection),
   both directions in one launch, lengths mixed from 1 to T, float32 and
   bfloat16: max-abs error against a stated tolerance and the median time
   of each (CUDA events).
3. A base-LAS experiment folder (config.json with the base-las model block,
   seeded full-width random parameters in a .ckpt) served on the card
   through ``Transcriber.transcribe`` and ``StreamingTranscriber.submit``,
   with the kernels' launch counters reset just before and read just after.
   Utterances/s, per-batch latency and peak device memory are printed.
4. Parity on one batch: the listener once through the kernels and once
   through the plain functions (``lstm_impl: scan``), then greedy decoding
   of both. float32: encoder outputs within tolerance and identical ids.
   bfloat16: the max error and the share of identical transcripts.

Any failure exits non-zero before the result. The line before the last is
the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 11785
B, H = 32, 512
# float32: the kernel and the plain loop differ only in summation order;
# over 1024 steps that stays near 1e-6. bfloat16: h is rounded to bf16 as
# the dot operand and the output is bf16 (step 2**-8 near 1), so an order
# difference that flips one rounding propagates.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNELS = {
    # name: (T, input width, TPU kernel it replaces)
    "lstm_scan_fusedin": (1024, 15, "attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py:854"),
    "lstm_scan": (512, 2 * 2 * H, "attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py:87"),
}
SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/lstm_scan.cu"
BASE_LAS_MODEL = {
    "listener_configs": {
        "input_dim": 15, "uniform_hid_dim": 512, "lstm_layers": 1,
        "plstm_layers": 3, "bidirectional": True, "init_dropout": 0.3,
        "mid_dropout": 0.3, "final_dropout": 0.35, "lstm_impl": "pallas"},
    "speller_configs": {
        "att_proj_dim": 256, "att_heads": 1, "att_dropout": 0.0,
        "dec_emb_dim": 512, "dec_emb_dropout": 0.0, "dec_lstm_hid_dim": 512,
        "dec_lstm_out_dim": 256, "dec_lstm_dropout": 0.3, "CHR_MAX_STEPS": 600,
        "USE_GREEDY": True, "decoder_impl": "pallas",
        "dec_vocab_size": 30, "CHR_SOS_IDX": 0, "CHR_PAD_IDX": 29},
}
N_UTTS, MIN_FRAMES, MAX_FRAMES = 40, 200, 1500


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_median_ms(torch, fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def environment(torch, card: str) -> float:
    from torch.utils.cpp_extension import CUDA_HOME

    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda

    nvcc = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "--version"],
                          capture_output=True, text=True, check=True).stdout
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}  nvcc: {nvcc.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    lstm_cuda.load_library()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.2f} s ({SOURCE})")
    with open(lstm_cuda.library_path() + ".log") as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    return build_s


def kernel_phase(torch, card: str) -> dict:
    """Each kernel against its plain version; returns the JSON records."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    gen = torch.Generator().manual_seed(SEED)
    records = {}
    for name, (seq_len, in_dim, replaces) in KERNELS.items():
        lengths = torch.randint(1, seq_len + 1, (B,), generator=gen)
        lengths[0], lengths[1] = seq_len, 1
        lengths = lengths.to(torch.int32).cuda()
        k = 1.0 / H ** 0.5
        w_hh32 = ((torch.rand(2, H, 4 * H, generator=gen) * 2 - 1) * k).cuda()
        w_ih32 = ((torch.rand(2, in_dim, 4 * H, generator=gen) * 2 - 1) * k).cuda()
        b32 = ((torch.rand(2, 4 * H, generator=gen) * 2 - 1) * k).cuda()
        x32 = torch.randn(B, seq_len, in_dim, generator=gen).cuda()
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            w_hh = w_hh32.to(dtype)
            x = x32.to(dtype) if name == "lstm_scan_fusedin" else (x32.clamp(-1, 1) * 0.5).to(dtype)
            if name == "lstm_scan_fusedin":
                w_ih, b = w_ih32.to(dtype), b32.to(dtype)
                args = (x, w_ih, b, w_hh, lengths, (False, True))
                kern, plain = lc.lstm_scan_fusedin, lc.lstm_scan_fusedin_plain
            else:
                w_cat = torch.cat([w_ih32[0], w_ih32[1]], dim=1).to(dtype)
                x_proj = torch.matmul(x, w_cat) + torch.cat([b32[0], b32[1]]).to(dtype)
                args = (x_proj, w_hh, lengths, (False, True))
                kern, plain = lc.lstm_scan, lc.lstm_scan_plain
            got = kern(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            torch.cuda.synchronize()
            if got.shape != (B, seq_len, 2 * H) or got.dtype != dtype:
                raise AssertionError(f"{name}: output {tuple(got.shape)} {got.dtype}")
            pads = torch.arange(seq_len, device="cuda")[None, :] >= lengths[:, None].long()
            if pads.any() and got[pads].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: non-zero output at padded frames")
            err = (got.float() - ref.float()).abs().max().item()
            ms = cuda_median_ms(torch, lambda: kern(*args), 20)
            plain_ms = cuda_median_ms(torch, lambda: plain(*args), 3)
            log(f"[{card}] {name} {dtype_name} B={B} T={seq_len} D={in_dim} H={H} 2 dirs: "
                f"max_abs_err {err:.3e} (tol {TOL[dtype_name]:g})  kernel {ms:.3f} ms  "
                f"plain {plain_ms:.3f} ms")
            if not err <= TOL[dtype_name]:
                raise AssertionError(f"{name} {dtype_name}: max_abs_err {err} > {TOL[dtype_name]}")
            if dtype_name == "bfloat16":  # the serving dtype goes into the record
                records[name] = {"name": name, "route": "cuda", "source": SOURCE,
                                 "replaces": replaces, "launches": 0,
                                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return records


def make_experiment(torch, root: str) -> str:
    """A base-LAS experiment folder with seeded full-width random params."""
    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch import EOS_IDX, SOS_IDX, VOCAB
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_config_from_dicts,
        las_init,
        las_to_jax_params,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import save_checkpoint

    cfg = las_config_from_dicts(BASE_LAS_MODEL["listener_configs"],
                                BASE_LAS_MODEL["speller_configs"])
    params = las_to_jax_params(las_init(cfg, torch.Generator().manual_seed(SEED)))
    # non-zero learned initial states, as a trained model has
    rng = np.random.default_rng(SEED)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                             ).astype("float32")
    snap = {"compute_dtype": "bfloat16", "VOCAB": list(VOCAB), "SOS_IDX": SOS_IDX,
            "EOS_IDX": EOS_IDX, "model": {"tag": "base-LAS", "configs": BASE_LAS_MODEL}}
    os.makedirs(os.path.join(root, "ckpts"))
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(snap, fh)
    save_checkpoint(os.path.join(root, "ckpts", "min-loss-ld-ppl-epoch[1].ckpt"),
                    {"params": params, "epoch": 1})
    return root


def serve_phase(torch, card: str, exp: str, feats: list) -> tuple:
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.serving import (
        StreamingTranscriber,
        Transcriber,
    )

    t = Transcriber(exp, batch_size=B, pad_time_multiple=128, device="cuda")
    t.warmup([max(len(f) for f in feats)])
    n_batches = -(-len(feats) // B)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lc.reset_launch_counts()
    t0 = time.perf_counter()
    texts = t.transcribe(feats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(lc.LAUNCHES)
    want = {"lstm_scan_fusedin": n_batches, "lstm_scan": 3 * n_batches}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want} for {n_batches} batches")

    stream = StreamingTranscriber(t, max_wait_ms=50.0)
    try:
        futs = [stream.submit(f) for f in feats[:4]]
        streamed = [f.result(timeout=600) for f in futs]
    finally:
        stream.close()
    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    if len(streamed) != 4 or not all(set(s) <= vocab for s in streamed):
        raise AssertionError("streamed transcripts malformed")
    launches = dict(lc.LAUNCHES)
    if not all(launches[k] > counts[k] for k in launches):
        raise AssertionError(f"streaming ran no kernel: {launches}")
    peak = torch.cuda.max_memory_allocated()
    same = sum(a == b for a, b in zip(streamed, t.transcribe(feats[:4])))
    log(f"[{card}] streamed 4 requests; {same}/4 equal to one direct batch of the same 4")
    if len(texts) != len(feats) or not all(set(s) <= vocab for s in texts):
        raise AssertionError("transcripts malformed")
    log(f"[{card}] serve base-LAS bf16: {len(feats)} utts ({MIN_FRAMES}-{MAX_FRAMES} frames) "
        f"in {n_batches} batches of {B}: {wall:.3f} s, {len(feats) / wall:.2f} utt/s, "
        f"{wall / n_batches * 1e3:.1f} ms/batch, peak device memory "
        f"{peak / 2**20:.1f} MiB; mean transcript {sum(map(len, texts)) / len(texts):.1f} chars")
    log(f"[{card}] launches in the served run: {launches}")
    return t, launches


def parity_phase(torch, card: str, t, feats: list) -> None:
    import dataclasses

    import numpy as np

    from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import greedy_decode_early_stop
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import listener_apply
    from attention_based_e2e_asr_dnn_tpu_torch.serving import pad_to_multiple

    batch = feats[:B]
    t_pad = pad_to_multiple(max(map(len, batch)), 128)
    x = np.zeros((B, t_pad, 15), np.float32)
    for r, f in enumerate(batch):
        x[r, : len(f)] = f
    x = torch.from_numpy(x).cuda()
    lx = torch.tensor([len(f) for f in batch], dtype=torch.int32).cuda()
    kern_cfg = t.cfg.listener
    plain_cfg = dataclasses.replace(kern_cfg, lstm_impl="scan")
    sp = t.params["speller"]
    with torch.inference_mode():
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            enc_k, el = listener_apply(t.params["listener"], kern_cfg, x.to(dtype), lx)
            enc_p, _ = listener_apply(t.params["listener"], plain_cfg, x.to(dtype), lx)
            if not torch.isfinite(enc_k.float()).all():
                raise AssertionError("encoder output not finite")
            err = (enc_k.float() - enc_p.float()).abs().max().item()
            ids_k = greedy_decode_early_stop(sp, t.cfg.speller, enc_k, el)
            ids_p = greedy_decode_early_stop(sp, t.cfg.speller, enc_p, el)
            # ids are PAD after a row's first <eos>: equal rows, equal transcripts
            same = int((ids_k == ids_p).all(dim=1).sum())
            log(f"[{card}] listener kernels vs plain, {dtype_name}: encoder max_abs_err "
                f"{err:.3e}; identical transcripts {same}/{B}")
            if dtype_name == "float32":
                if not err <= TOL["float32"]:
                    raise AssertionError(f"float32 encoder error {err}")
                if not torch.equal(ids_k, ids_p):
                    raise AssertionError("float32 greedy ids differ kernel vs plain")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    try:
        import attention_based_e2e_asr_dnn_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    card = smi

    environment(torch, card)
    records = kernel_phase(torch, card)

    rng = np.random.default_rng(SEED)
    feats = [rng.standard_normal((int(n), 15)).astype(np.float32)
             for n in rng.integers(MIN_FRAMES, MAX_FRAMES + 1, N_UTTS)]
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        exp = make_experiment(torch, os.path.join(root, "exp"))
        t, launches = serve_phase(torch, card, exp, feats)
        parity_phase(torch, card, t, feats)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    for name, n in launches.items():
        records[name]["launches"] = n
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
