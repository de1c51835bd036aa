"""Move checkpoints between the reference (PyTorch) and this package (the
counterpart of the repository's ``tools/import_reference_ckpt.py``).

Import a reference ``.pt`` (``src/train.py:352``'s payload or a bare
state_dict) into the data-only ``.ckpt`` format that ``infer``, ``lminfer``
and a resumed ``train`` read, in either package::

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.import_reference_ckpt \\
        las min-loss-epoch[42].pt -o las.ckpt
    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.import_reference_ckpt \\
        rewriter lm.pt -o lm.ckpt

Export back to the reference's names (``load_state_dict(strict=True)``)::

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.import_reference_ckpt \\
        las ours.ckpt -o ref.pt --export

The ``.ckpt`` written is the JAX tool's, byte for byte: the same params
tree, written by ``training/checkpoints.py``'s ``save_checkpoint`` with the
same metadata. No device is involved.
"""

from __future__ import annotations

import argparse
import sys

import torch

from attention_based_e2e_asr_dnn_tpu_torch import compat
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import (
    load_checkpoint,
    save_checkpoint,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="reference .pt <-> this package's .ckpt")
    ap.add_argument("model", choices=["las", "rewriter"])
    ap.add_argument("input", help=".pt (import) or .ckpt (with --export)")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--export", action="store_true",
                    help="the other way: a .ckpt -> a reference-named .pt")
    args = ap.parse_args(argv)
    if args.export:
        params = load_checkpoint(args.input)["params"]
        to_sd = (compat.state_dict_from_las_params if args.model == "las"
                 else compat.state_dict_from_rewriter_params)
        sd = {k: torch.from_numpy(v.copy()) for k, v in to_sd(params).items()}
        torch.save({"model_state_dict": sd}, args.output)
        print(f"exported {len(sd)} tensors -> {args.output}")
    else:
        sd = compat.load_torch_state_dict(args.input)
        from_sd = (compat.las_params_from_state_dict if args.model == "las"
                   else compat.rewriter_params_from_state_dict)
        save_checkpoint(args.output, {"params": from_sd(sd), "epoch": 0,
                                      "source": f"reference:{args.input}"})
        print(f"imported {len(sd)} tensors -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
