"""Serve a trained experiment, or exported artifacts, over HTTP
(counterpart of the JAX package's ``tools/serve_http.py``).

    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.serve_http \\
        experiments/<run> --port 8080 [--batch-size 32] \\
        [--warmup 256 512 1024 1536] [--beam-size 8] \\
        [--corrector lm_experiments/<run> [--corrector-margin M] \\
         [--corrector-span-family best]] [--device cuda]
    python -m attention_based_e2e_asr_dnn_tpu_torch.tools.serve_http \\
        --artifact las-b8-t512.tlas [--artifact las-b8-t1536.tlas] \\
        [--corrector-artifact corrector-b8-t608.tlas [--corrector-margin M]] \\
        [--warmup] [--device cuda]

Gates traffic on readiness when a warmup ladder is given: the server binds
first, ``/healthz`` answers at once, and ``/readyz`` turns 200 when the
kernels are built and the ladder's largest bucket has run one batch; POST
``/v1/transcribe`` afterwards. ``--device`` (default ``cuda``) names where
the model runs; ``cuda`` without a card fails. ``--corrector`` passes every
transcript through the gated Rewriter of that LM experiment
(``serving.Corrector``); its ``--corrector-*`` flags without it are refused,
as the JAX tool refuses them.

``--artifact`` (repeatable, one a decode bucket) serves artifacts written by
``export.py`` through ``export.ArtifactTranscriber`` instead of an
experiment folder, ``--corrector-artifact`` a corrector artifact after
them; a bare ``--warmup`` warms every bucket before ``/readyz`` turns 200.
The experiment-only flags are refused there, as the JAX tool refuses them.

The flags are the JAX tool's. ``--data-parallel N`` splits each decode
batch over the first N cards (``serving.Transcriber(data_parallel=N)``); an
artifact's split is fixed at export, so the flag is refused in ``--artifact``
mode, as the JAX tool refuses it.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("exp_folder", nargs="?", default=None)
    ap.add_argument("--artifact", action="append", default=None,
                    help="serve from exported artifact bucket(s) (export.py)")
    ap.add_argument("--corrector-artifact", default=None,
                    help="corrector artifact for gated auto-correction (--artifact mode)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--average", action="store_true")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--pad-time-multiple", type=int, default=128)
    ap.add_argument("--beam-size", type=int, default=0)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    ap.add_argument("--warmup", type=int, nargs="*", default=None,
                    help="bucket ladder (frame counts) to warm before ready")
    ap.add_argument("--corrector", default=None,
                    help="LM experiment folder for gated auto-correction")
    ap.add_argument("--corrector-margin", type=float, default=0.0,
                    help="the gate's margin (fit it with lminfer "
                         "confidence_margin: auto)")
    ap.add_argument("--corrector-span-family", default=None,
                    help="enable span rewrites and threshold this family "
                         "(free, conf, best or fNN)")
    ap.add_argument("--corrector-span-conf-tau", type=float, default=0.5,
                    help="the confidence policy's threshold (as calibrated)")
    ap.add_argument("--corrector-span-fracs", type=float, nargs="+",
                    default=[0.25, 0.5, 0.75, 0.9],
                    help="the fraction anchors (as calibrated)")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda, cuda:N or cpu")
    return ap


def artifact_flag_errors(args) -> list:
    """The experiment-only flags given in ``--artifact`` mode (refused, as
    the JAX tool refuses them: beam and checkpoint are fixed at export)."""
    ignored = [flag for flag, val in [
        ("--corrector", args.corrector),
        ("--corrector-span-family",
         args.corrector_span_family if not args.corrector_artifact else None),
        ("--corrector-margin", args.corrector_margin if not args.corrector_artifact else None),
        ("--corrector-span-conf-tau",
         args.corrector_span_conf_tau if args.corrector_span_conf_tau != 0.5 else None),
        ("--corrector-span-fracs",
         args.corrector_span_fracs if args.corrector_span_fracs != [0.25, 0.5, 0.75, 0.9]
         else None),
        ("--checkpoint", args.checkpoint),
        ("--average", args.average or None),
        ("--beam-size", args.beam_size or None),
        ("--batch-size", args.batch_size if args.batch_size != 32 else None),
        ("--pad-time-multiple",
         args.pad_time_multiple if args.pad_time_multiple != 128 else None),
        ("--data-parallel", args.data_parallel if args.data_parallel != 1 else None),
    ] if val]
    if args.warmup:  # frame counts mean something in experiment mode only
        ignored.append("--warmup <values>")
    return ignored


def start(args):
    """Build the Transcriber (or ``ArtifactTranscriber``) and the bound,
    started server for ``args``."""
    from attention_based_e2e_asr_dnn_tpu_torch.server import AsrHttpServer
    from attention_based_e2e_asr_dnn_tpu_torch.serving import Corrector, Transcriber

    if args.artifact:
        from attention_based_e2e_asr_dnn_tpu_torch.export import (
            ArtifactTranscriber,
            ExportedCorrector,
        )

        corrector = (ExportedCorrector(args.corrector_artifact, device=args.device)
                     if args.corrector_artifact else None)
        transcriber = ArtifactTranscriber(args.artifact, corrector=corrector,
                                          margin=args.corrector_margin,
                                          span_family=args.corrector_span_family,
                                          device=args.device)
        if args.warmup is not None:  # background: the server binds first
            transcriber.warmup(background=True)
        server = AsrHttpServer(transcriber, host=args.host, port=args.port,
                               max_wait_ms=args.max_wait_ms).start()
        return transcriber, server
    corrector = None
    if args.corrector:
        span = args.corrector_span_family
        # tau and fracs as lminfer calibrated with them: other values would
        # serve another candidate set than the fitted policy was chosen over
        corrector = Corrector(args.corrector, confidence_margin=args.corrector_margin,
                              span_rewrite=span is not None, span_family=span or "best",
                              span_conf_tau=args.corrector_span_conf_tau,
                              span_fracs=tuple(args.corrector_span_fracs),
                              device=args.device)
    transcriber = Transcriber(
        args.exp_folder,
        checkpoint=args.checkpoint,
        average=args.average,
        beam_size=args.beam_size,
        batch_size=args.batch_size,
        pad_time_multiple=args.pad_time_multiple,
        auto_warmup=args.warmup,
        data_parallel=args.data_parallel,
        corrector=corrector,
        device=args.device,
    )
    # bind FIRST: /healthz answers during warmup and /readyz gates traffic
    # (a readiness probe that cannot connect looks like a dead process)
    server = AsrHttpServer(transcriber, host=args.host, port=args.port,
                           max_wait_ms=args.max_wait_ms).start()
    return transcriber, server


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    if bool(args.exp_folder) == bool(args.artifact):
        ap.error("give exactly one of: an experiment folder, or --artifact")
    if args.artifact:
        ignored = artifact_flag_errors(args)
        if ignored:
            ap.error(f"{', '.join(ignored)} appl{'y' if len(ignored) > 1 else 'ies'} to "
                     f"experiment-folder serving, not --artifact mode (use "
                     f"--corrector-artifact for artifact correction; beam and "
                     f"checkpoint are fixed at export)")
    elif args.corrector_artifact:
        ap.error("--corrector-artifact applies to --artifact mode; use --corrector "
                 "<lm_experiment> here")
    elif args.corrector is None and (args.corrector_span_family is not None
                                     or args.corrector_margin):
        # without a corrector these flags would serve no correction at all
        ap.error("--corrector-span-family/--corrector-margin need "
                 "--corrector <lm_experiment> in experiment mode")
    if args.exp_folder and args.warmup == []:
        ap.error("--warmup needs at least one bucket frame count "
                 "(e.g. --warmup 512 1024)")
    transcriber, server = start(args)
    print(f"listening on {server.host}:{server.port}"
          + (" (readiness gated on warmup via /readyz)"
             if args.warmup is not None else ""), flush=True)
    if args.warmup is not None:
        def announce():
            try:
                transcriber.wait_ready()
                print("ready: kernels built, the warm-up run", flush=True)
            except RuntimeError as exc:
                print(f"warmup FAILED: {exc}", flush=True)

        threading.Thread(target=announce, daemon=True).start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
