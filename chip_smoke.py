#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (attention_based_e2e_asr_dnn_tpu_torch) once
on one NVIDIA card, from the root of a checkout:

    python3 chip_smoke.py

1. The card's name and power limit, the torch / CUDA / nvcc versions, and
   the time to build the kernels from ``csrc/`` (one ``nvcc`` per source,
   all started together).
2. Each LSTM kernel against its plain PyTorch version on the same CUDA
   tensors at the shapes the infer CLI gives it (B=64, two launches of 32
   rows; H=512; listener layer 0 at T=1536 with D=15, pyramid layer 1 at
   T=768 over a 2 x 4H projection), both directions in one launch, lengths
   mixed from 1 to T, float32 and bfloat16: max-abs error against a stated
   tolerance and the median time of each (CUDA events).
3. ``speller_decode`` on the operands the eval decode builds from seeded
   full-width parameters: base-LAS at B=64 and scaled-LAS (H1 1024, 4
   heads) at B=32, Te=192 with lengths mixed from 1 to Te, 600 steps,
   float32 and bfloat16. The plain version forced along the kernel's own
   fed-back ids must agree at every step within the stated tolerance; the
   plain version run free must pick the same ids wherever the top two
   logits are further apart than the tolerance (float32). Median kernel
   time and the plain time.
4. A base-LAS experiment folder (config.json with the base-las model block,
   two seeded full-width random checkpoints) served on the card through
   ``Transcriber.transcribe`` and ``StreamingTranscriber.submit``, with the
   kernels' launch counters reset just before and read just after.
   Utterances/s, per-batch latency and peak device memory are printed.
5. Parity on one batch: the listener once through the kernels and once
   through the plain functions (``lstm_impl: scan``), then greedy decoding
   of both. float32: encoder outputs within tolerance and identical ids.
   bfloat16: the max error and the share of identical transcripts.
6. The ``infer`` CLI in-process on the card over a 128-utterance test set in
   the reference layout, at ``batch_size: 64``, every best checkpoint and
   their average, twice: ``early_stop: true`` (the early-exit greedy decode)
   and ``early_stop: false`` (the fused decode kernel). The CSVs must be
   well-formed and in template order, the decode route ``cuda``, and the
   launch counts those of 64-row batches. Utterances/s, ms per batch and
   peak device memory are printed.

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
# over 1536 steps that stays near 1e-6. bfloat16: h is rounded to bf16 as
# the dot operand and the output is bf16 (step 2**-8 near 1), so an order
# difference that flips one rounding propagates.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# speller_decode forced along its own ids over 600 steps, (logits, attention
# weights). float32: the kernel and the plain loop differ only in summation
# order (measured ~4e-6 on logits of magnitude ~10). bfloat16: the outputs
# are bf16 (one step is 2**-5 at |logit| 4-8, 2**-8 at weights near 1) and
# the carries are rounded to bf16 each step, so an order difference that
# flips one rounding propagates; two steps of the largest logits' and of
# weights near 1.
SPELLER_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.25, 2.0 ** -7)}
KERNELS = {
    # name: (T, input width, TPU kernel it replaces); T as infer pads the
    # longest utterance (1500 frames to a multiple of 256), halved by the pyramid
    "lstm_scan_fusedin": (1536, 15, "attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py:854"),
    "lstm_scan": (768, 2 * 2 * H, "attention_based_e2e_asr_dnn_tpu/ops/lstm_pallas.py:87"),
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
N_TEST_UTTS, INFER_BATCH = 128, 64

SPELLER_SOURCE = "attention_based_e2e_asr_dnn_tpu_torch/csrc/speller_decode.cu"
SPELLER_REPLACES = "attention_based_e2e_asr_dnn_tpu/ops/speller_pallas.py:90"
# speller_decode at the main path's shapes: base-LAS as infer runs it
# (batch_size 64) and scaled-LAS (configs/scaled-las.yml: H1 1024, 4 heads
# of 64) at B=32; encoder length 192 (1536 frames / 8), 600 steps
SPELLER_CASES = {
    # name: (speller config changes, listener width, batch)
    "base-LAS": ({}, 512, 64),
    "scaled-LAS": ({"dec_lstm_hid_dim": 1024, "att_heads": 4}, 1024, 32),
}
TE_DEC = 192


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
    from concurrent.futures import ThreadPoolExecutor

    from torch.utils.cpp_extension import CUDA_HOME

    from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build, lstm_cuda, speller_cuda

    nvcc = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "--version"],
                          capture_output=True, text=True, check=True).stdout
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}  nvcc: {nvcc.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    modules = (lstm_cuda, speller_cuda)
    with ThreadPoolExecutor(len(modules)) as pool:  # one nvcc per source
        libs = list(pool.map(cuda_build.build_library, [m.SOURCE for m in modules]))
    for m in modules:
        m.load_library()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.2f} s ({SOURCE}, {SPELLER_SOURCE})")
    for so in libs:
        with open(so + ".log") as fh:
            for line in fh:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {os.path.basename(so)}: {line.strip()}")
    return build_s


def kernel_phase(torch, card: str) -> dict:
    """Each kernel against its plain version at the infer CLI's batch (two
    launches of 32 rows a call); returns the JSON records."""
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc

    gen = torch.Generator().manual_seed(SEED)
    records = {}
    B = INFER_BATCH
    for name, (seq_len, in_dim, replaces) in KERNELS.items():
        lengths = torch.randint(1, seq_len + 1, (B,), generator=gen)
        lengths[0], lengths[1] = seq_len, 1
        lengths[-2], lengths[-1] = 1, seq_len  # both extremes in the second launch too
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
            before = lc.LAUNCHES[name]
            got = kern(*args)
            torch.cuda.synchronize()
            if lc.LAUNCHES[name] - before != 2:
                raise AssertionError(f"{name}: B={B} took {lc.LAUNCHES[name] - before} "
                                     f"launches, not 2 of 32 rows")
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


def speller_kernel_phase(torch, card: str) -> dict:
    """speller_decode against its plain version on the operands the main path
    builds (random full-width parameters, encoder lengths mixed from 1 to
    Te): the plain version forced along the kernel's own fed-back ids must
    give the same logits and weights at every step; the plain version run
    free must pick the same ids wherever the top two logits are further
    apart than the tolerance (float32). Returns the JSON record."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
        las_config_from_dicts,
        las_init,
    )
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    gen = torch.Generator().manual_seed(SEED)
    record = None
    for case, (changes, width, batch) in SPELLER_CASES.items():
        cfg = las_config_from_dicts(
            {**BASE_LAS_MODEL["listener_configs"], "uniform_hid_dim": width},
            {**BASE_LAS_MODEL["speller_configs"], **changes})
        params = las_init(cfg, gen)["speller"].cuda()
        spl = cfg.speller
        vocab = spl.dec_vocab_size
        lengths = torch.randint(1, TE_DEC + 1, (batch,), generator=gen)
        lengths[0], lengths[1] = TE_DEC, 1
        enc = torch.randn(batch, TE_DEC, cfg.listener.enc_out_dim, generator=gen) * 0.5
        enc[torch.arange(TE_DEC)[None, :] >= lengths[:, None]] = 0.0
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            with torch.inference_mode():
                operands, _ = sc.decode_operands(params, spl, enc.to(dtype).cuda(),
                                                 lengths.cuda())
                opts = sc.decode_options(spl)
                logits, wgts, ids = sc.speller_decode(*operands, **opts)
                torch.cuda.synchronize()
                forced = torch.cat([torch.full_like(ids[:1], -1), ids[:-1]]).contiguous()
                p_logits, p_wgts, p_ids = sc.speller_decode_plain(*operands, **opts,
                                                                  forced=forced)
                _, _, free_ids = sc.speller_decode_plain(*operands, **opts)
                torch.cuda.synchronize()
                ms = cuda_median_ms(torch, lambda: sc.speller_decode(*operands, **opts), 10)
                plain_ms = cuda_median_ms(
                    torch, lambda: sc.speller_decode_plain(*operands, **opts), 1)
            shape = (spl.CHR_MAX_STEPS, batch)
            if ids.shape != shape or logits.shape != (*shape, operands[8].shape[0]):
                raise AssertionError(f"speller_decode {case}: outputs {tuple(ids.shape)}, "
                                     f"{tuple(logits.shape)}")
            if not torch.isfinite(logits[..., :vocab].float()).all():
                raise AssertionError(f"speller_decode {case} {dtype_name}: logits not finite")
            err = (logits[..., :vocab].float() - p_logits[..., :vocab].float()).abs().max().item()
            w_err = (wgts.float() - p_wgts.float()).abs().max().item()
            tol, w_tol = SPELLER_TOL[dtype_name]
            # rows whose free-run ids differ: the top-two gap of the plain
            # logits where they first differ (identical inputs up to there)
            gaps = []
            for r in torch.nonzero((free_ids != ids).any(0)).flatten().tolist():
                t0 = int(torch.nonzero(free_ids[:, r] != ids[:, r])[0])
                top2 = p_logits[t0, r].float().topk(2).values
                gaps.append((top2[0] - top2[1]).item())
            same = batch - len(gaps)
            forced_same = int((p_ids == ids).all(0).sum())
            log(f"[{card}] speller_decode {case} {dtype_name} B={batch} Te={TE_DEC} "
                f"T={spl.CHR_MAX_STEPS} H1={spl.dec_lstm_hid_dim} heads={spl.att_heads}: "
                f"forced logits max_abs_err {err:.3e} (tol {tol:g}), weights {w_err:.3e} "
                f"(tol {w_tol:g}); "
                f"forced-run argmax equal in {forced_same}/{batch} rows; free run identical "
                f"ids in {same}/{batch} rows (top-two gaps where not: "
                f"{[round(g, 6) for g in gaps]}); kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
            if not (err <= tol and w_err <= w_tol):
                raise AssertionError(f"speller_decode {case} {dtype_name}: errors {err}, "
                                     f"{w_err} above {tol}, {w_tol}")
            if dtype_name == "float32" and any(g > tol for g in gaps):
                raise AssertionError(f"speller_decode {case}: free-run ids differ where the "
                                     f"top two logits are {max(gaps)} apart")
            if case == "base-LAS" and dtype_name == "bfloat16":  # the infer path's
                record = {"name": "speller_decode", "route": "cuda",
                          "source": SPELLER_SOURCE, "replaces": SPELLER_REPLACES,
                          "launches": 0, "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms}
    return record


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
    snap = {"TRN_FOLDER": "data/train-clean-100", "compute_dtype": "bfloat16",
            "VOCAB": list(VOCAB), "SOS_IDX": SOS_IDX, "EOS_IDX": EOS_IDX,
            "model": {"tag": "base-LAS", "configs": BASE_LAS_MODEL}}
    os.makedirs(os.path.join(root, "ckpts"))
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(snap, fh)
    rng = np.random.default_rng(SEED)
    for epoch in (1, 2):
        params = las_to_jax_params(las_init(cfg, torch.Generator().manual_seed(SEED + epoch)))
        # non-zero learned initial states, as a trained model has
        for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
            params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                                 ).astype("float32")
        save_checkpoint(os.path.join(root, "ckpts", f"min-loss-ld-ppl-epoch[{epoch}].ckpt"),
                        {"params": params, "epoch": epoch})
    return root


def make_test_set(root: str, rng) -> str:
    """A test set in the reference layout: mfcc/*.npy and the submission
    template transcript/random_submission.csv."""
    import numpy as np

    for sub in ("mfcc", "transcript"):
        os.makedirs(os.path.join(root, sub))
    for i, n in enumerate(rng.integers(MIN_FRAMES, MAX_FRAMES + 1, N_TEST_UTTS)):
        np.save(os.path.join(root, "mfcc", f"utt{i:04d}.npy"),
                rng.standard_normal((int(n), 15)).astype(np.float32))
    with open(os.path.join(root, "transcript", "random_submission.csv"), "w") as fh:
        fh.write("id,label\n" + "".join(f"{i},X\n" for i in range(N_TEST_UTTS)))
    return root


def infer_phase(torch, card: str, exp: str, data: str, work: str) -> dict:
    """The port's infer CLI on the card, early_stop true then false; returns
    the launches of both runs."""
    from attention_based_e2e_asr_dnn_tpu_torch import infer
    from attention_based_e2e_asr_dnn_tpu_torch.models import las
    from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
    from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc

    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    n_batches = -(-N_TEST_UTTS // INFER_BATCH)
    n_ckpts = 3  # two best checkpoints and their average
    launches = {"lstm_scan_fusedin": 0, "lstm_scan": 0, "speller_decode": 0}
    for early_stop in (True, False):
        cfg_path = os.path.join(work, f"infer-{early_stop}.yml")
        with open(cfg_path, "w") as fh:
            fh.write(f"SOME_FOLDER: {data}\nexp_folder: {exp}\nbatch_size: {INFER_BATCH}\n"
                     f"pad_time_multiple: 256\nrun_all: true\nepoch_num: null\n"
                     f"run_avg: true\nearly_stop: {str(early_stop).lower()}\n")
        las._DECODE_ROUTES.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lc.reset_launch_counts()
        sc.reset_launch_counts()
        t0 = time.perf_counter()
        infer.main(infer.build_argparser().parse_args(["-c", cfg_path, "--device", "cuda"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {**lc.LAUNCHES, **sc.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        routes = las.decode_route_report()
        want = {"lstm_scan_fusedin": 2 * n_batches * n_ckpts,  # 64 rows: 2 launches
                "lstm_scan": 3 * 2 * n_batches * n_ckpts,
                "speller_decode": 0 if early_stop else n_batches * n_ckpts}
        if counts != want:
            raise AssertionError(f"infer early_stop={early_stop}: launches {counts} != {want}")
        if not early_stop and (not routes or set(routes.values()) != {"cuda"}):
            raise AssertionError(f"infer early_stop=false: decode routes {routes}")
        for name in ("min-loss-ld-ppl-epoch[1]", "min-loss-ld-ppl-epoch[2]", "avg-all"):
            with open(os.path.join(exp, "preds", f"{name}-tst.csv")) as fh:
                lines = fh.read().split("\n")
            rows = [ln.split(",", 1) for ln in lines[1:-1]]
            if (lines[0] != "id,label" or lines[-1] != "" or
                    [r[0] for r in rows] != [str(i) for i in range(N_TEST_UTTS)] or
                    not all(len(r) == 2 and set(r[1]) <= vocab for r in rows)):
                raise AssertionError(f"infer early_stop={early_stop}: {name}-tst.csv malformed")
        decoded = N_TEST_UTTS * n_ckpts
        log(f"[{card}] infer base-LAS bf16 early_stop={str(early_stop).lower()}: {decoded} "
            f"utts ({MIN_FRAMES}-{MAX_FRAMES} frames; {n_ckpts} checkpoints x {n_batches} "
            f"batches of {INFER_BATCH}) in {wall:.3f} s (whole CLI run), "
            f"{decoded / wall:.2f} utt/s, {wall / (n_batches * n_ckpts) * 1e3:.1f} ms/batch, "
            f"peak device memory {peak / 2**20:.1f} MiB; routes {routes}; launches {counts}")
        for k in launches:
            launches[k] += counts[k]
    return launches


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
    from attention_based_e2e_asr_dnn_tpu_torch.data.batching import pad_to_multiple

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
    records["speller_decode"] = speller_kernel_phase(torch, card)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        exp = make_experiment(torch, os.path.join(root, "exp"))
        t, launches = serve_phase(torch, card, exp, feats)
        parity_phase(torch, card, t, feats)
        data = make_test_set(os.path.join(root, "test-clean"), rng)
        infer_launches = infer_phase(torch, card, exp, data, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    # launches in the main-path runs: serving, then infer early_stop true/false
    for name in records:
        records[name]["launches"] = launches.get(name, 0) + infer_launches[name]
        if records[name]["launches"] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
