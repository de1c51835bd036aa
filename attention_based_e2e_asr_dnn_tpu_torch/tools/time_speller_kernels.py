"""Time the fused speller kernels of ``ops/speller_cuda.py`` on the card at
the main paths' shapes and print one JSON line.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.time_speller_kernels \
        [--reps 10] [--eval-only]

Shapes: the base-LAS decoder (proj 256, 1 head, H1 512, H2 256), encoder
length 192 with lengths mixed from 1 to 192, bfloat16 and float32:
``speller_decode`` as the infer CLI runs it (B=64, 600 steps), and, where the
tree has them, ``speller_decode_train`` and ``speller_decode_bwd`` as a train
step runs them (192 steps, dropout 0.3, forced and free steps mixed) at B=128
and at B=64 and B=32, which says whether the adjoint should take the batch
whole or in row chunks. Times are CUDA-event medians of ``--reps`` calls
after one warm-up call. The line names the card and its power limit, so two
trees can be compared within one run on one card. Run them in turns, each
in several fresh processes (``--eval-only`` keeps a process short): the
float32 ``speller_decode`` settles into one of two speeds a process.
"""

from __future__ import annotations

import argparse
import json

import torch

from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_config_from_dicts, las_init
from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda as sc
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import median_ms, require_card

TE, TRAIN_STEPS = 192, 192
LISTENER = {"input_dim": 15, "uniform_hid_dim": 512, "plstm_layers": 3}
SPELLER = {"att_proj_dim": 256, "att_heads": 1, "dec_emb_dim": 512, "dec_lstm_hid_dim": 512,
           "dec_lstm_out_dim": 256, "dec_lstm_dropout": 0.3, "CHR_MAX_STEPS": 600}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--eval-only", action="store_true",
                        help="time speller_decode alone, in both dtypes")
    args = parser.parse_args()
    reps = args.reps
    card = require_card("time_speller_kernels")
    gen = torch.Generator().manual_seed(0)
    cfg = las_config_from_dicts(LISTENER, SPELLER)
    spl = cfg.speller
    params = las_init(cfg, gen)["speller"].cuda()
    out = {"card": card, "reps": reps, "ms": {}}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for batch in (64,) if args.eval_only else (64, 128, 32):
            lengths = torch.randint(1, TE + 1, (batch,), generator=gen)
            lengths[0], lengths[1] = TE, 1
            enc = torch.randn(batch, TE, cfg.listener.enc_out_dim, generator=gen) * 0.5
            with torch.no_grad():
                operands, _ = sc.decode_operands(params, spl, enc.to(dtype).cuda(),
                                                 lengths.cuda())
                opts = sc.decode_options(spl)
                key = f"{dtype_name} B={batch}"
                if batch == 64:
                    out["ms"][f"speller_decode {key} T={opts['steps']}"] = median_ms(
                        lambda: sc.speller_decode(*operands, **opts), reps)
                if args.eval_only:
                    # once more on operands allocated anew beside the first: does
                    # the speed belong to the process or to where the tensors lie
                    again, _ = sc.decode_operands(params, spl, enc.to(dtype).cuda(),
                                                  lengths.cuda())
                    out["ms"][f"speller_decode {key} T={opts['steps']} anew"] = median_ms(
                        lambda: sc.speller_decode(*again, **opts), reps)
                if args.eval_only or not hasattr(sc, "speller_decode_bwd"):
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
                out["ms"][f"speller_decode_train {key} T={TRAIN_STEPS}"] = median_ms(run, reps)
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
