"""Deployment export: one decode bucket of a trained model in one file
(counterpart of the JAX ``export.py``).

The JAX package's ``.tlas`` artifact holds a StableHLO program, which
PyTorch can neither write nor run. This package's artifact is a format of
its own, ``tpu-las-torch-export-v1``:

  * one npz archive, data-only: it loads with ``allow_pickle=False`` and
    executes no code from the file;
  * the parameter leaves ``p{i}`` in the checkpoints' tree encoding
    (``training/checkpoints.py``), int8 leaves of ``quantize.quantize_tree``
    allowed;
  * ``__record__``, a JSON record of ``meta`` and ``params_tree``. ``meta``
    holds ``format``, ``kind`` (``las`` or ``rewriter``), the bucket
    (``batch``, ``t_pad``, and for the LAS ``input_dim``), the vocabulary
    contract (``vocab``, ``sos_idx``, ``eos_idx``, ``pad_idx``), the decode
    (``compute_dtype``, ``beam_size``, ``length_alpha``, ``max_len_factor``,
    ``max_steps``), ``quantize`` (``int8`` or ``none``), for a corrector
    ``gate``, ``score_width`` and with span rewriting ``span_conf_tau`` and
    ``span_fracs``; and ``model``, the model's config, from which the
    loader rebuilds the model with no experiment folder.

The loader rebuilds the model from ``model`` and runs this package's own
decode steps, on the kernels where the config names a ``pallas`` tier: a
served artifact runs the same kernels on the same weights as the
``Transcriber`` of its experiment. A file of the other package's format
is refused with a ``ValueError`` that names both formats.

``ExportedDecoder`` (features in, transcripts out), ``ExportedCorrector``
(texts in, gated rewrites out, through ``decoding/rescore.py``'s
``RewriteChain``) and ``ArtifactTranscriber`` (the ``Transcriber``
surface over one artifact a bucket, for ``server.AsrHttpServer``) take
``device`` (default ``cuda``; ``cuda`` without a card raises). The JAX
``platforms`` argument has no meaning here and is not taken.
``data_parallel > 1`` (a batch divisible by it, the JAX check) is recorded in
``meta``; the loader then decodes each batch split over that many cards
(``parallel/split.py``, as ``serving.Transcriber(data_parallel=n)`` does) and
raises the JAX message where fewer are visible. The format holds no compiled
program, so nothing else about such an artifact differs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.ops.precision import compute_dtype as _dtype
from attention_based_e2e_asr_dnn_tpu_torch.parallel import split
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import _decode_tree, _encode_tree
from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import ids_to_str

_FORMAT = "tpu-las-torch-export-v1"
_JAX_FORMAT = "tpu-las-export-v1"  # the JAX package's StableHLO artifacts


def _dtype_name(compute_dtype) -> str:
    return str(_dtype(compute_dtype) if isinstance(compute_dtype, str)
               else compute_dtype).replace("torch.", "")


def _quantized(params, quantize: Optional[str]):
    if quantize is None:
        return params
    if quantize != "int8":
        raise ValueError(f"quantize={quantize!r}: only 'int8' is supported")
    from attention_based_e2e_asr_dnn_tpu_torch.quantize import quantize_tree

    return quantize_tree(params)


def _decode_meta(compute_dtype, beam_size, length_alpha, max_len_factor, max_steps,
                 quantize) -> dict:
    return {"compute_dtype": _dtype_name(compute_dtype), "beam_size": int(beam_size),
            "length_alpha": float(length_alpha), "max_len_factor": float(max_len_factor),
            "max_steps": int(max_steps), "quantize": quantize or "none"}


def export_las_decoder(params, las_cfg, batch: int, t_pad: int, *, vocab: Sequence[str],
                       sos_idx: int, eos_idx: int, pad_idx: int, compute_dtype="float32",
                       beam_size: int = 0, length_alpha: float = 0.0,
                       max_len_factor: float = 3.0, data_parallel: int = 1,
                       quantize: Optional[str] = None) -> dict:
    """The artifact dict of one (batch, t_pad) decode bucket of a LAS:
    ``beam_size > 1`` decodes by beam search, else by the early-stop greedy
    decode. ``params``: the JAX params tree of numpy arrays (a checkpoint's,
    or ``models.las.las_to_jax_params`` of a module); ``las_cfg``:
    ``models.las.LASConfig``."""
    if data_parallel > 1 and batch % data_parallel:
        raise ValueError(f"batch {batch} not divisible by data_parallel {data_parallel}")
    meta = {
        "format": _FORMAT, "kind": "las", "batch": int(batch), "t_pad": int(t_pad),
        "input_dim": int(las_cfg.listener.input_dim), "vocab": list(vocab),
        "sos_idx": int(sos_idx), "eos_idx": int(eos_idx), "pad_idx": int(pad_idx),
        **_decode_meta(compute_dtype, beam_size, length_alpha, max_len_factor,
                       las_cfg.speller.CHR_MAX_STEPS, quantize),
        "data_parallel": int(data_parallel),
        "model": dataclasses.asdict(las_cfg),
    }
    return {"meta": meta, "params": _quantized(params, quantize)}


def export_rewriter_corrector(params, lm_cfg, batch: int, t_pad: int, *, vocab: Sequence[str],
                              sos_idx: int, eos_idx: int, pad_idx: int,
                              compute_dtype="float32", beam_size: int = 0,
                              length_alpha: float = 0.0, max_len_factor: float = 3.0,
                              gate: bool = True, span_rewrite: bool = False,
                              span_conf_tau: float = 0.5,
                              span_fracs: Sequence[float] = (0.25, 0.5, 0.75, 0.9),
                              quantize: Optional[str] = None) -> dict:
    """The artifact dict of the Rewriter's correction chain: text ids of
    width ``t_pad`` (SOS and EOS included, a multiple of 32) in, rewrites
    out; ``gate`` keeps the forced scorer's margin a runtime knob of
    ``ExportedCorrector.correct``, ``span_rewrite`` (with ``gate``) the
    prefix-anchored candidates. ``score_width`` covers the longest rewrite,
    ``CHR_MAX_STEPS`` + 2, so that the gate scores the whole string it
    returns."""
    if t_pad % 32:
        raise ValueError(f"t_pad {t_pad} must be a multiple of 32 (the gate's candidate "
                         f"pad granularity, decoding/rescore.py::gate_corrections)")
    if span_rewrite and not gate:
        raise ValueError("span_rewrite requires gate=True (candidate selection uses "
                         "the gate's scorer)")
    meta = {
        "format": _FORMAT, "kind": "rewriter", "batch": int(batch), "t_pad": int(t_pad),
        "vocab": list(vocab), "sos_idx": int(sos_idx), "eos_idx": int(eos_idx),
        "pad_idx": int(pad_idx),
        **_decode_meta(compute_dtype, beam_size, length_alpha, max_len_factor,
                       lm_cfg.CHR_MAX_STEPS, quantize),
        "gate": bool(gate), "span_rewrite": bool(span_rewrite),
        "model": dataclasses.asdict(lm_cfg),
    }
    if gate:
        meta["score_width"] = -(-max(t_pad, lm_cfg.CHR_MAX_STEPS + 2) // 32) * 32
    if span_rewrite:
        meta["span_conf_tau"] = float(span_conf_tau)
        meta["span_fracs"] = [float(f) for f in span_fracs]
    return {"meta": meta, "params": _quantized(params, quantize)}


def save_artifact(path: str, artifact: dict) -> str:
    """Write the artifact as one npz: the param leaves and the record."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves: list = []
    skel = _encode_tree(artifact["params"], leaves)
    arrays = {f"p{i}": leaf for i, leaf in enumerate(leaves)}
    record = {"meta": artifact["meta"], "params_tree": skel}
    arrays["__record__"] = np.frombuffer(json.dumps(record).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    return path


def load_artifact(path: str) -> tuple:
    """(meta, params tree of numpy arrays, dequantized) of an artifact of this
    package's format; the JAX package's refused with a ``ValueError``."""
    with np.load(path, allow_pickle=False) as z:
        record = json.loads(bytes(z["__record__"]).decode("utf-8"))
        fmt = record["meta"].get("format")
        if fmt != _FORMAT or "__mlir__" in z.files:
            raise ValueError(
                f"{path}: format {fmt!r} is not this package's {_FORMAT!r} "
                f"(a {_JAX_FORMAT!r} artifact holds a StableHLO program for the JAX "
                f"package's ExportedDecoder; export again with this package's export)")
        n = sum(1 for k in z.files if k.startswith("p"))
        params = _decode_tree(record["params_tree"], {f"@{i}": z[f"p{i}"] for i in range(n)})
    if record["meta"].get("quantize", "none") != "none":
        from attention_based_e2e_asr_dnn_tpu_torch.quantize import dequantize_tree

        params = dequantize_tree(params)
    return record["meta"], params


def _device(device: str, who: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device={device!r}): no CUDA device here; "
                           f"pass device='cpu' to run on the CPU")
    return dev


class ExportedDecoder:
    """Run a LAS artifact: features in, transcripts out. One instance
    serves its one bucket: shorter inputs are padded up, longer ones and
    more utterances than ``batch`` are refused."""

    _KIND = "las"
    _split = None  # a data_parallel artifact's RowSplit

    def __init__(self, path: str, device: str = "cuda"):
        self.device = _device(device, type(self).__name__)
        self.meta, params = load_artifact(path)
        kind = self.meta.get("kind", "las")
        if kind != self._KIND:
            loaders = {"las": "ExportedDecoder", "rewriter": "ExportedCorrector"}
            raise ValueError(f"{path}: artifact kind {kind!r}: use "
                             f"{loaders.get(kind, 'a matching loader')} for it, "
                             f"not {type(self).__name__}")
        self.compute_dtype = _dtype(self.meta["compute_dtype"])
        self._build(params)

    def _build(self, params) -> None:
        from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import make_las_beam_step
        from attention_based_e2e_asr_dnn_tpu_torch.decoding.greedy import make_las_greedy_step
        from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
            LASConfig,
            ListenerConfig,
            SpellerConfig,
            las_from_jax_params,
        )

        m = self.meta
        cfg = LASConfig(ListenerConfig(**m["model"]["listener"]),
                        SpellerConfig(**m["model"]["speller"]))
        cuda_build.build_for(self.device, cfg.listener.lstm_impl, cfg.speller.decoder_impl)
        self.params = las_from_jax_params(params).to(self.device)
        if m["beam_size"] > 1:
            self._step = make_las_beam_step(
                cfg, beam_size=m["beam_size"], length_alpha=m["length_alpha"],
                compute_dtype=self.compute_dtype, max_len_factor=m["max_len_factor"])
        else:
            self._step = make_las_greedy_step(cfg, compute_dtype=self.compute_dtype,
                                              max_len_factor=m["max_len_factor"])
        n = int(m.get("data_parallel", 1))
        self._split = (split.RowSplit(self._step, self.params, split.dp_devices(self.device, n))
                       if n > 1 else None)

    def decode_ids(self, x: np.ndarray, lx: np.ndarray) -> np.ndarray:
        """(batch, t_pad, input_dim) float32, (batch,) int32 -> int32 ids."""
        if self._split is not None:
            return np.asarray(self._split(np.asarray(x, np.float32), np.asarray(lx, np.int32)),
                              np.int32)
        ids = self._step(self.params, torch.as_tensor(np.asarray(x)).to(self.device),
                         torch.as_tensor(np.asarray(lx)).to(self.device))
        return np.asarray(ids.cpu().numpy() if torch.is_tensor(ids) else ids, np.int32)

    def transcribe(self, features: Sequence[np.ndarray]) -> List[str]:
        """Pad a list of (T_i, input_dim) MFCC arrays into the bucket and
        decode. len(features) <= batch; T_i <= t_pad."""
        m = self.meta
        if len(features) > m["batch"]:
            raise ValueError(f"{len(features)} utterances > exported batch {m['batch']}")
        x = np.zeros((m["batch"], m["t_pad"], m["input_dim"]), np.float32)
        lx = np.ones((m["batch"],), np.int32)  # dummy rows: length 1
        for i, f in enumerate(features):
            f = np.asarray(f, np.float32)
            if f.shape[0] > m["t_pad"]:
                raise ValueError(f"utterance {i}: {f.shape[0]} frames > exported "
                                 f"t_pad {m['t_pad']}")
            if f.shape[1] != m["input_dim"]:
                raise ValueError(f"utterance {i}: feature dim {f.shape[1]} != "
                                 f"{m['input_dim']}")
            x[i, : f.shape[0]] = f
            lx[i] = f.shape[0]
        ids = self.decode_ids(x, lx)
        return [self._detok(ids[i]) for i in range(len(features))]

    def _detok(self, row) -> str:
        m = self.meta
        return ids_to_str(row, m["vocab"], m["sos_idx"], m["eos_idx"])


class ExportedCorrector(ExportedDecoder):
    """Run a Rewriter artifact: texts in, gated corrections out (the
    ``serving.Corrector`` chain: rewrite each text and, where the artifact
    carries the gate, keep a rewrite only when the model scores it
    ``margin`` average log-probability a character above regenerating the
    input, ``margin`` a runtime knob)."""

    _KIND = "rewriter"

    def _build(self, params) -> None:
        from attention_based_e2e_asr_dnn_tpu_torch.decoding.rescore import RewriteChain
        from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import (
            RewriterConfig,
            rewriter_from_jax_params,
        )

        m = self.meta
        cfg = dict(m["model"])
        cfg["enc_dropouts"] = tuple(cfg["enc_dropouts"])
        lm_cfg = RewriterConfig(**cfg)
        cuda_build.build_for(self.device, lm_cfg.lstm_impl, lm_cfg.decoder_impl)
        self.params = rewriter_from_jax_params(params).to(self.device)
        self.chain = RewriteChain(
            lm_cfg, self.compute_dtype, beam_size=m["beam_size"],
            length_alpha=m["length_alpha"], max_len_factor=m["max_len_factor"],
            gate=m["gate"], span_rewrite=m.get("span_rewrite", False),
            span_conf_tau=m.get("span_conf_tau", 0.5),
            span_fracs=m.get("span_fracs", (0.25, 0.5, 0.75, 0.9)),
            score_width=m.get("score_width", 0))
        self._step = self.chain.step
        self.has_span = self.chain.span is not None

    def transcribe(self, features):  # features are audio-side; not here
        raise TypeError("rewriter artifacts correct TEXT: use .correct(texts); "
                        ".transcribe() is the LAS ExportedDecoder API")

    def correct(self, texts: Sequence[str], margin: float = 0.0, on_overflow: str = "raise",
                span_family: Optional[str] = None) -> List[str]:
        """``on_overflow``: a text longer than the exported width raises
        ("raise") or keeps its input uncorrected ("passthrough", what a
        serving chain wants: skipping a correction is never worse).
        ``span_family``: the fitted span-rewrite family the gate thresholds
        (``"free"``, ``"conf"``, ``"best"`` or an ``"fNN"`` anchor); needs an
        artifact exported with ``span_rewrite=True``."""
        from attention_based_e2e_asr_dnn_tpu_torch.decoding.rescore import (
            gate_corrections,
            span_candidate_families,
        )

        if on_overflow not in ("raise", "passthrough"):
            raise ValueError(f"on_overflow={on_overflow!r}")
        if margin != 0.0 and self.chain.scorer is None:
            raise ValueError("margin set but this artifact was exported with gate=False "
                             "(no scorer): every rewrite would be applied "
                             "unconditionally; export again with the gate")
        if span_family is not None:
            if not self.has_span:
                raise ValueError("span_family set but this artifact carries no span "
                                 "programs: export again with span_rewrite=True")
            self.chain.check_family(span_family)
        m = self.meta
        vm = {c: i for i, c in enumerate(m["vocab"])}
        sos, eos = m["sos_idx"], m["eos_idx"]
        B, W = m["batch"], m["t_pad"]
        ids, passthrough = [], set()
        for i, t in enumerate(texts):
            row = [sos] + [vm[c] for c in t if c in vm] + [eos]
            if len(row) > W:
                if on_overflow == "raise":
                    raise ValueError(f"text {i}: {len(row)} ids > exported t_pad {W}")
                passthrough.add(i)
                row = [sos, eos]  # a dummy; its result is discarded
            ids.append(row)
        out: List[str] = [""] * len(texts)
        for start in range(0, len(texts), B):
            rows = ids[start:start + B]
            x = np.full((B, W), eos, np.int32)
            lx = np.ones((B,), np.int32)  # dummy rows: length 1
            for r, row in enumerate(rows):
                x[r, : len(row)] = row
                lx[r] = len(row)
            dec = self.decode_ids(x, lx)
            use = None
            if span_family is not None:
                span = self.chain.span
                fams = span_candidate_families(
                    dec, self.chain.scorer, span["token_scorer"], span["anchored_step"],
                    self.params, x, lx, span["conf_tau"], span["fracs"], eos, sos,
                    score_width=m["score_width"])
                dec, margins = fams[span_family]
                use = margins > margin
            elif self.chain.scorer is not None:
                # the input rows widened to the scorer's width, which covers
                # the longest [SOS..EOS] rewrite: the gate scores the whole
                # string it returns (the JAX artifact's static scorer width)
                x_gate = np.full((B, m["score_width"]), eos, np.int32)
                x_gate[:, :W] = x
                use, _, _ = gate_corrections(self.chain.scorer, self.params, x_gate, lx, dec,
                                             eos, sos, margin=margin)
            for r in range(len(rows)):
                if start + r in passthrough:
                    out[start + r] = texts[start + r]
                    continue
                keep = bool(use[r]) if use is not None else True
                out[start + r] = self._detok(dec[r]) if keep else texts[start + r]
        return out


class ArtifactTranscriber:
    """``serving.Transcriber``'s surface over LAS artifacts, one a decode
    bucket (one checkpoint, several (batch, t_pad)): each utterance goes to
    the smallest bucket it fits, and the HTTP server
    (``tools/serve_http.py --artifact``) serves from them:

        python -m attention_based_e2e_asr_dnn_tpu_torch.tools.serve_http \\
            --artifact las-b8-t512.tlas --port 8080
    """

    def __init__(self, artifact_paths: Sequence[str],
                 corrector: Optional[ExportedCorrector] = None, margin: float = 0.0,
                 span_family: Optional[str] = None, device: str = "cuda"):
        if isinstance(artifact_paths, (str, os.PathLike)):
            artifact_paths = [artifact_paths]
        self.buckets = sorted((ExportedDecoder(p, device=device) for p in artifact_paths),
                              key=lambda d: d.meta["t_pad"])
        if not self.buckets:
            raise ValueError("no artifacts given")
        dims = {d.meta["input_dim"] for d in self.buckets}
        if len(dims) != 1:
            raise ValueError(f"artifacts disagree on input_dim: {dims}")
        # buckets of different models would transcribe an utterance with
        # whichever checkpoint its length routes to
        contracts = {(tuple(d.meta["vocab"]), d.meta["sos_idx"], d.meta["eos_idx"],
                      d.meta["pad_idx"]) for d in self.buckets}
        if len(contracts) != 1:
            raise ValueError("artifacts disagree on vocab/special ids: they were exported "
                             "from different models")
        if corrector is not None:
            cm = corrector.meta
            if (tuple(cm["vocab"]), cm["sos_idx"], cm["eos_idx"],
                    cm["pad_idx"]) not in contracts:
                raise ValueError("corrector artifact's vocab/special ids do not match the "
                                 "decode artifacts: it was exported from a different "
                                 "vocabulary")
            if margin != 0.0 and not cm.get("gate", False):
                raise ValueError("corrector-margin set but the corrector artifact was "
                                 "exported with gate=False (no scorer): the margin would "
                                 "be silently ignored")
            if span_family is not None and not corrector.has_span:
                raise ValueError("span_family set but the corrector artifact carries no "
                                 "span programs: export again with span_rewrite=True")
        elif span_family is not None:
            raise ValueError("span_family needs a corrector artifact")
        self.corrector = corrector
        self.margin = margin
        self.span_family = span_family
        self.n_feats = self.buckets[0].meta["input_dim"]
        self.vocab = self.buckets[0].meta["vocab"]
        self.batch_size = max(d.meta["batch"] for d in self.buckets)
        self.bucket_t_pads = [d.meta["t_pad"] for d in self.buckets]
        # exported buckets cap the input: the HTTP layer answers an overlong
        # request with 400 instead of failing a whole batch
        self.max_frames = self.bucket_t_pads[-1]
        self.pad_time_multiple = None  # no rounding granularity: see bucket_t_pads
        self._warmup_lock = threading.Lock()
        self._warmup_requested = False
        self._warmup_bg: Optional[threading.Thread] = None
        self._ready_evt = threading.Event()
        self._warmup_error: Optional[BaseException] = None

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """True once a requested warm-up has run every bucket (and the
        corrector); True at once when none was requested; raises
        ``RuntimeError`` if it failed."""
        if not self._warmup_requested:
            return True
        got = self._ready_evt.wait(timeout)
        if self._warmup_error is not None:
            raise RuntimeError("artifact warmup failed") from self._warmup_error
        return got

    def warmup(self, background: bool = False):
        """One dummy batch through every bucket and the corrector's chain, so
        that no first request pays the cold start. ``background=True``
        returns the thread at once; gate traffic on ``wait_ready``. Calling
        it again retries a failed warm-up; one in flight is joined, not
        duplicated."""

        def _run():
            try:
                for d in self.buckets:
                    m = d.meta
                    d.decode_ids(np.zeros((m["batch"], m["t_pad"], m["input_dim"]),
                                          np.float32), np.ones((m["batch"],), np.int32))
                if self.corrector is not None:
                    self.corrector.correct(["A"], margin=self.margin,
                                           span_family=self.span_family)
            except BaseException as exc:  # noqa: BLE001 - raised again in wait_ready
                self._warmup_error = exc
            finally:
                self._ready_evt.set()

        with self._warmup_lock:
            if self._warmup_bg is not None and self._warmup_bg.is_alive():
                thread, fresh = self._warmup_bg, False
            else:
                self._ready_evt.clear()
                self._warmup_error = None
                self._warmup_requested = True
                fresh = True
                thread = None
                if background:
                    self._warmup_bg = thread = threading.Thread(target=_run, daemon=True)
                    thread.start()
        if background:
            return thread
        if fresh:
            _run()
        else:
            self._ready_evt.wait()
        if self._warmup_error is not None:
            raise RuntimeError("artifact warmup failed") from self._warmup_error

    def _route(self, n_frames: int) -> ExportedDecoder:
        for d in self.buckets:
            if n_frames <= d.meta["t_pad"]:
                return d
        raise ValueError(f"utterance of {n_frames} frames exceeds the largest exported "
                         f"bucket t_pad {self.buckets[-1].meta['t_pad']}")

    def transcribe(self, features: Sequence[np.ndarray]) -> List[str]:
        out: List[Optional[str]] = [None] * len(features)
        groups: dict = {}
        for i, f in enumerate(features):
            f = np.asarray(f, np.float32)
            groups.setdefault(self._route(f.shape[0]), []).append((i, f))
        for dec, items in groups.items():
            bsz = dec.meta["batch"]
            for start in range(0, len(items), bsz):
                chunk = items[start:start + bsz]
                for (i, _), text in zip(chunk, dec.transcribe([f for _, f in chunk])):
                    out[i] = text
        assert all(t is not None for t in out)
        if self.corrector is not None:
            out = self.corrector.correct(out, margin=self.margin, on_overflow="passthrough",
                                         span_family=self.span_family)
        return out  # type: ignore[return-value]


def export_from_experiment(exp_folder: str, out_path: str, batch: int = 8, t_pad: int = 512,
                           checkpoint: Optional[str] = None, average: bool = False,
                           beam_size: int = 0, length_alpha: float = 0.0,
                           max_len_factor: float = 3.0, data_parallel: int = 1,
                           quantize: Optional[str] = None) -> str:
    """A LAS experiment's config.json and best (or averaged, or named)
    checkpoint -> one artifact, loaded as ``serving.Transcriber`` loads it."""
    from attention_based_e2e_asr_dnn_tpu_torch.models.las import las_config_from_dicts
    from attention_based_e2e_asr_dnn_tpu_torch.serving import load_experiment

    snap, payload = load_experiment(exp_folder, checkpoint, average)
    model = snap["model"]["configs"]
    las_cfg = las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    artifact = export_las_decoder(
        payload["params"], las_cfg, batch, t_pad, vocab=snap["VOCAB"],
        sos_idx=snap["SOS_IDX"], eos_idx=snap["EOS_IDX"],
        pad_idx=snap.get("PAD_IDX", snap["EOS_IDX"]),
        compute_dtype=snap.get("compute_dtype", "float32"), beam_size=beam_size,
        length_alpha=length_alpha, max_len_factor=max_len_factor,
        data_parallel=data_parallel, quantize=quantize)
    return save_artifact(out_path, artifact)


def export_corrector_from_experiment(exp_folder: str, out_path: str, batch: int = 8,
                                     t_pad: int = 512, checkpoint: Optional[str] = None,
                                     average: bool = False, beam_size: int = 0,
                                     length_alpha: float = 0.0, max_len_factor: float = 3.0,
                                     gate: bool = True, span_rewrite: bool = False,
                                     span_conf_tau: float = 0.5,
                                     span_fracs: Sequence[float] = (0.25, 0.5, 0.75, 0.9),
                                     quantize: Optional[str] = None) -> str:
    """A Rewriter experiment -> one correction artifact; the vocabulary is
    the shared constants table, as ``serving.Corrector`` resolves it.
    ``span_conf_tau`` / ``span_fracs`` must be those ``lminfer`` calibrated
    with: they name the families the fitted ``span_family`` points into."""
    from attention_based_e2e_asr_dnn_tpu_torch import constants
    from attention_based_e2e_asr_dnn_tpu_torch.models.rewriter import RewriterConfig
    from attention_based_e2e_asr_dnn_tpu_torch.serving import load_experiment

    snap, payload = load_experiment(exp_folder, checkpoint, average)
    lm_cfg = RewriterConfig(**snap["model"]["configs"])
    artifact = export_rewriter_corrector(
        payload["params"], lm_cfg, batch, t_pad, vocab=constants.VOCAB,
        sos_idx=constants.SOS_IDX, eos_idx=constants.EOS_IDX, pad_idx=constants.PAD_IDX,
        compute_dtype=snap.get("compute_dtype", "float32"), beam_size=beam_size,
        length_alpha=length_alpha, max_len_factor=max_len_factor, gate=gate,
        span_rewrite=span_rewrite, span_conf_tau=span_conf_tau, span_fracs=span_fracs,
        quantize=quantize)
    return save_artifact(out_path, artifact)
