"""Time the LSTM kernels of ``ops/lstm_cuda.py`` on the card at the main
paths' shapes and print one JSON line.

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.time_lstm_kernels \
        [--reps 20] [--hidden 512] [--forms lstm_bwd,lstm_bwd_dw] [--rewriter]

Shapes: ``--hidden`` 512 (base-LAS) or 1024 (scaled-LAS), bfloat16 and
float32; the serve, infer and train batches (B=32, 64 and 128: layer 0 at
T=1536 with D=15, layer 1 at T=768 over a 2 x 4H projection) for the lean
forward kernels, and the train batch (B=128) for the training forward and
the adjoints where the tree has them: ``lstm_bwd_dw`` up to H=512,
``lstm_bwd`` at every width, and the outside dW_hh product beside it (up to
H=512 also ``lstm_bwd`` and ``dw_hh_outside`` timed together as one figure,
the route that would replace ``lstm_bwd_dw`` there);
``lstm_scan_cs`` and, up to H=512, ``bilstm_scan_fused`` (over the same
projection laid out as (T, 2, B, 4H)) beside ``lstm_scan``. Times are
CUDA-event medians of ``--reps`` calls after one warm-up call, each call all
the launches its wrapper makes (bfloat16: one per 128 rows, both directions,
the adjoint too; float32: one per 32 rows, and a direction at H=1024). The line names the
card and its power limit, so two trees can be compared within one run on one
card (run them in turns: parent, change, change, parent). ``--forms`` times
only the named wrappers (and, with ``lstm_bwd``, the outside product).

``--rewriter`` times instead the float32 ``lstm_scan`` at the Rewriter
encoder's layer as ``lminfer`` runs it (``configs/rewriter.yml``: H=256, both
directions; ``configs/lm-infer.yml``'s batch of 256; T=608, lines of 100-600
characters with <sos> and <eos>; layer 0's projection of the 256-wide
embedding), its launches, and beside it cuDNN's float32 LSTM through
``nn.LSTM`` on the packed batch with TF32 off (the yardstick; the port never
calls it).
"""

from __future__ import annotations

import argparse
import json

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda as lc
from attention_based_e2e_asr_dnn_tpu_torch.tools.timing import (
    median_ms,
    require_device,
    smi_name_and_power,
)

FORMS = ("lstm_scan_fusedin", "lstm_scan", "lstm_scan_fusedin_train", "lstm_scan_train",
         "lstm_scan_cs", "bilstm_scan_fused", "lstm_bwd_dw", "lstm_bwd")


def rewriter_ms(reps: int) -> dict:
    """The float32 ``lstm_scan`` and cuDNN's float32 LSTM (TF32 off) at the
    Rewriter encoder's layer 0 in ``lminfer``: B=256, T=608, H=256, D=256."""
    from torch.nn.utils.rnn import pack_padded_sequence

    batch, seq_len, hidden, in_dim = 256, 608, 256, 256
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    lengths = torch.randint(102, 603, (batch,), generator=gen)
    lengths[0] = 602
    k = hidden ** -0.5
    x = torch.randn(batch, seq_len, in_dim, generator=gen).to("cuda")
    x[torch.arange(seq_len)[None, :] >= lengths[:, None]] = 0.0
    w_ih = ((torch.rand(in_dim, 2 * 4 * hidden, generator=gen) * 2 - 1) * k).cuda()
    w_hh = ((torch.rand(2, hidden, 4 * hidden, generator=gen) * 2 - 1) * k).cuda()
    x_proj = x @ w_ih
    lengths = lengths.to(torch.int32).cuda()
    rev = (False, True)
    with torch.no_grad():
        lc.reset_launch_counts()
        lc.lstm_scan(x_proj, w_hh, lengths, rev)
        launches = lc.LAUNCHES["lstm_scan"]
        ms = median_ms(lambda: lc.lstm_scan(x_proj, w_hh, lengths, rev), reps)
        lstm = torch.nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=True).cuda()
        packed = pack_padded_sequence(x, lengths.cpu().long(), batch_first=True,
                                      enforce_sorted=False)
        cudnn_ms = median_ms(lambda: lstm(packed), reps)
    return {"shape": f"float32 B={batch} T={seq_len} H={hidden} D={in_dim} 2 dirs",
            "frames": int(lengths.sum()), "ms": {"lstm_scan": ms, "nn.LSTM (cuDNN, TF32 off)":
                                                 cudnn_ms},
            "launches": launches}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--hidden", type=int, default=512)
    parser.add_argument("--forms", default=",".join(FORMS),
                        help="comma-separated wrappers to time (default: all)")
    parser.add_argument("--rewriter", action="store_true",
                        help="time the float32 lstm_scan at lminfer's shapes, and cuDNN")
    cli = parser.parse_args()
    reps, H = cli.reps, cli.hidden
    require_device("cuda", "time_lstm_kernels")
    card = smi_name_and_power()
    if cli.rewriter:
        print(json.dumps({"card": card, "reps": reps, **rewriter_ms(reps)}))
        return
    wanted = set(cli.forms.split(","))
    # the wrappers this tree has, of those wanted
    fn = {name: getattr(lc, name, None) if name in wanted else None for name in FORMS}
    gen = torch.Generator().manual_seed(0)
    k = H ** -0.5
    rev = (False, True)
    out = {"card": card, "reps": reps, "hidden": H, "ms": {}}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        w_hh = ((torch.rand(2, H, 4 * H, generator=gen) * 2 - 1) * k).to("cuda", dtype)
        w_ih = ((torch.rand(2, 15, 4 * H, generator=gen) * 2 - 1) * k).to("cuda", dtype)
        b = ((torch.rand(2, 4 * H, generator=gen) * 2 - 1) * k).to("cuda", dtype)
        for batch in (32, 64, 128):
            for name, seq_len in (("fusedin", 1536), ("scan", 768)):
                lengths = torch.randint(1, seq_len + 1, (batch,), generator=gen)
                lengths[::32], lengths[1::32] = seq_len, 1
                lengths = lengths.to(torch.int32).cuda()
                if name == "fusedin":
                    args = (torch.randn(batch, seq_len, 15, generator=gen).to("cuda", dtype),
                            w_ih, b, w_hh)
                    lean, train = "lstm_scan_fusedin", "lstm_scan_fusedin_train"
                else:
                    args = ((torch.rand(batch, seq_len, 2 * 4 * H, generator=gen) - 0.5)
                            .to("cuda", dtype), w_hh)
                    lean, train = "lstm_scan", "lstm_scan_train"
                key = f"{dtype_name} B={batch} T={seq_len}"
                if fn[lean] is not None:
                    with torch.no_grad():
                        out["ms"][f"{lean} {key}"] = median_ms(
                            lambda: fn[lean](*args, lengths, rev), reps)
                if name == "scan" and fn["lstm_scan_cs"] is not None:
                    with torch.no_grad():
                        out["ms"][f"lstm_scan_cs {key}"] = median_ms(
                            lambda: fn["lstm_scan_cs"](*args, lengths, rev), reps)
                        if H <= 512 and fn["bilstm_scan_fused"] is not None:
                            xp = torch.stack(args[0].split(4 * H, dim=-1), 0).permute(
                                2, 0, 1, 3).contiguous()
                            out["ms"][f"bilstm_scan_fused {key}"] = median_ms(
                                lambda: fn["bilstm_scan_fused"](xp, w_hh, lengths), reps)
                            del xp
                adjoints = fn["lstm_bwd_dw"] is not None or fn["lstm_bwd"] is not None
                if batch == 128 and (fn[train] is not None or adjoints):
                    # the training forward's streams are the adjoints' inputs
                    hs, cs, gates = getattr(lc, train)(*args, lengths, rev)
                    dy = torch.randn(hs.shape, generator=gen).to("cuda", dtype)
                    if fn[train] is not None:
                        out["ms"][f"{train} {key}"] = median_ms(
                            lambda: fn[train](*args, lengths, rev), reps)
                    if H <= 512 and fn["lstm_bwd_dw"] is not None:
                        out["ms"][f"lstm_bwd_dw {key}"] = median_ms(
                            lambda: lc.lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, rev), reps)
                    if fn["lstm_bwd"] is not None:
                        dpre = lc.lstm_bwd(gates, cs, dy, w_hh, lengths, rev)
                        out["ms"][f"lstm_bwd {key}"] = median_ms(
                            lambda: lc.lstm_bwd(gates, cs, dy, w_hh, lengths, rev), reps)
                        out["ms"][f"dw_hh_outside {key}"] = median_ms(
                            lambda: lc.dw_hh_outside(hs, dpre, rev), reps)
                        if H <= 512:
                            out["ms"][f"lstm_bwd+dw_hh_outside {key}"] = median_ms(
                                lambda: lc.dw_hh_outside(
                                    hs, lc.lstm_bwd(gates, cs, dy, w_hh, lengths, rev), rev),
                                reps)
                        del dpre
                    del hs, cs, gates, dy
    print(json.dumps(out))


if __name__ == "__main__":
    main()
