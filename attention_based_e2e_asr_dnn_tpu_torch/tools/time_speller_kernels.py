"""Time the fused speller kernels of ``ops/speller_cuda.py`` on the card at
the main paths' shapes and print one JSON line.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.time_speller_kernels \
        [--reps 10] [--eval-only] [--dtypes bfloat16,float32] \
        [--forms eval,train,bwd] [--rewriter]

Shapes: encoder length 192 with lengths mixed from 1 to 192, at two decoder
widths: base-LAS (proj 256, 1 head, H1 512, H2 256) and scaled-LAS (H1 1024,
4 heads of 64). ``speller_decode`` (form ``eval``) as the infer CLI runs it,
600 steps, at B=64 (scaled-LAS: B=32, as ``chip_smoke.py`` runs it); and,
where the tree has them, ``speller_decode_train`` (``train``) and
``speller_decode_bwd`` (``bwd``) as a train step runs them (192 steps,
dropout 0.3, forced and free steps mixed) at B=128, 64 and 32 (scaled-LAS:
128 and 32), which says how much of a step grows with the rows. Times are
CUDA-event medians of ``--reps`` calls after one warm-up call. The line
names the card and its power limit, so two trees can be compared within one
run on one card (copy this tool into the other tree: it times only what that
tree has). Run them in turns, each in several fresh processes
(``--eval-only`` keeps a process short): the float32 ``speller_decode``
settles into one of two speeds a process.

``--rewriter`` times instead the eval form at the Rewriter's decoder widths
as ``lminfer`` runs it (``configs/rewriter.yml``: H1 256, H2 128, P 128, 1
head; ``configs/lm-infer.yml``'s batch of 256; an encoder of 608 frames,
lines of 100-600 characters with <sos> and <eos>; 600 steps), in
``--dtypes``, with its launches.
"""

from __future__ import annotations

import argparse
import json

import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_config_from_dicts, las_init
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import (
    median_ms,
    require_device,
    smi_name_and_power,
)

TE, TRAIN_STEPS = 192, 192
LISTENER = {"input_dim": 15, "uniform_hid_dim": 512, "plstm_layers": 3}
SPELLER = {"att_proj_dim": 256, "att_heads": 1, "dec_emb_dim": 512, "dec_lstm_hid_dim": 512,
           "dec_lstm_out_dim": 256, "dec_lstm_dropout": 0.3, "CHR_MAX_STEPS": 600}
# width: (speller config changes, listener width, eval batch, train batches)
WIDTHS = {
    "base-LAS": ({}, 512, 64, (64, 128, 32)),
    "scaled-LAS": ({"dec_lstm_hid_dim": 1024, "att_heads": 4}, 1024, 32, (128, 32)),
}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


REWRITER_SPELLER = {"att_proj_dim": 128, "att_heads": 1, "dec_emb_dim": 256,
                    "dec_lstm_hid_dim": 256, "dec_lstm_out_dim": 128}


def rewriter_ms(dtypes: str, reps: int) -> dict:
    """The eval form at the Rewriter's decoder widths, B=256, Te=608, 600
    steps, in each of ``dtypes``; with the launches of one call."""
    cfg = las_config_from_dicts({**LISTENER, "uniform_hid_dim": 256},
                                {**SPELLER, **REWRITER_SPELLER})
    gen = torch.Generator().manual_seed(0)
    params = las_init(cfg, gen)["speller"].cuda()
    batch, te = 256, 608
    lengths = torch.randint(102, 603, (batch,), generator=gen)
    lengths[0] = 602
    enc = torch.randn(batch, te, 512, generator=gen) * 0.5
    enc[torch.arange(te)[None, :] >= lengths[:, None]] = 0.0
    out = {"shape": f"B={batch} Te={te} H1 256 H2 128 P 128 T=600",
           "frames": int(lengths.sum()), "ms": {}, "launches": {}}
    for dtype_name in dtypes.split(","):
        with torch.no_grad():
            operands, _ = sc.decode_operands(params, cfg.speller,
                                             enc.to(DTYPES[dtype_name]).cuda(), lengths.cuda())
            opts = sc.decode_options(cfg.speller)
            sc.reset_launch_counts()
            sc.speller_decode(*operands, **opts)
            out["launches"][dtype_name] = sc.LAUNCHES["speller_decode"]
            out["ms"][f"speller_decode {dtype_name}"] = median_ms(
                lambda: sc.speller_decode(*operands, **opts), reps)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--eval-only", action="store_true",
                        help="time speller_decode alone, twice (on operands allocated anew)")
    parser.add_argument("--dtypes", default="bfloat16,float32")
    parser.add_argument("--forms", default="eval,train,bwd")
    parser.add_argument("--rewriter", action="store_true",
                        help="time the eval form at lminfer's widths and batch")
    args = parser.parse_args()
    reps = args.reps
    forms = set(args.forms.split(","))
    require_device("cuda", "time_speller_kernels")
    card = smi_name_and_power()
    if args.rewriter:
        print(json.dumps({"card": card, "reps": reps, **rewriter_ms(args.dtypes, reps)}))
        return
    gen = torch.Generator().manual_seed(0)
    out = {"card": card, "reps": reps, "ms": {}}
    for width, (changes, listener_width, eval_batch, train_batches) in WIDTHS.items():
        cfg = las_config_from_dicts({**LISTENER, "uniform_hid_dim": listener_width},
                                    {**SPELLER, **changes})
        spl = cfg.speller
        params = las_init(cfg, gen)["speller"].cuda()
        batches = (eval_batch,) if args.eval_only else tuple(dict.fromkeys(
            ((eval_batch,) if "eval" in forms else ()) + train_batches))
        for dtype_name in args.dtypes.split(","):
            dtype = DTYPES[dtype_name]
            for batch in batches:
                lengths = torch.randint(1, TE + 1, (batch,), generator=gen)
                lengths[0], lengths[1] = TE, 1
                enc = torch.randn(batch, TE, cfg.listener.enc_out_dim, generator=gen) * 0.5
                with torch.no_grad():
                    operands, _ = sc.decode_operands(params, spl, enc.to(dtype).cuda(),
                                                     lengths.cuda())
                    opts = sc.decode_options(spl)
                    key = f"{width} {dtype_name} B={batch}"
                    if batch == eval_batch and (args.eval_only or "eval" in forms):
                        out["ms"][f"speller_decode {key} T={opts['steps']}"] = median_ms(
                            lambda: sc.speller_decode(*operands, **opts), reps)
                    if args.eval_only:
                        # once more on operands allocated anew beside the first: does
                        # the speed belong to the process or to where the tensors lie
                        again, _ = sc.decode_operands(params, spl, enc.to(dtype).cuda(),
                                                      lengths.cuda())
                        out["ms"][f"speller_decode {key} T={opts['steps']} anew"] = median_ms(
                            lambda: sc.speller_decode(*again, **opts), reps)
                    if (args.eval_only or batch not in train_batches
                            or not forms & {"train", "bwd"}
                            or not hasattr(sc, "speller_decode_bwd")):
                        continue
                    opts["steps"] = TRAIN_STEPS
                    forced = torch.randint(0, spl.dec_vocab_size, (TRAIN_STEPS, batch),
                                           generator=gen, dtype=torch.int32)
                    forced[torch.rand(TRAIN_STEPS, generator=gen) > 0.9] = -1
                    forced[0] = -1
                    keep = 1.0 - spl.dec_lstm_dropout
                    m1, m2 = (((torch.rand(TRAIN_STEPS, batch, h, generator=gen) < keep)
                               .to(dtype) / keep).cuda()
                              for h in (spl.dec_lstm_hid_dim, spl.dec_lstm_out_dim))
                    run = lambda: sc.speller_decode_train(  # noqa: E731
                        *operands, **opts, forced=forced.cuda(), m1=m1, m2=m2)
                    _, wgts, _, saved = run()
                    if "train" in forms:
                        out["ms"][f"speller_decode_train {key} T={TRAIN_STEPS}"] = median_ms(
                            run, reps)
                    if "bwd" not in forms:
                        continue
                    k, v, _, _, _, c10, _, c20, _, wc1, whh1, wih2, whh2, _, wq = operands[:15]
                    _, gates1, c1, _, gates2, c2, _, _ = saved
                    dqup, dctxup = ((torch.randn(TRAIN_STEPS, batch, spl.att_proj_dim,
                                                 generator=gen) * 0.1).to("cuda", dtype)
                                    for _ in range(2))
                    out["ms"][f"speller_decode_bwd {key} T={TRAIN_STEPS}"] = median_ms(
                        lambda: sc.speller_decode_bwd(
                            k, v, wc1, whh1, wih2, whh2, wq, c10, c20, gates1, c1, gates2, c2,
                            wgts, m1, m2, dqup, dctxup, None, heads=opts["heads"],
                            scale=opts["scale"]), reps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
