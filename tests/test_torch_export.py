"""PyTorch port, deployment export (``export.py``, ``quantize.py``) against
the JAX package's on one toy LAS experiment and one toy Rewriter
experiment, in float32 on the CPU: the port's artifact and the JAX
package's StableHLO artifact, exported from the same checkpoint, decode
the same ids (greedy and beam) and correct to the same strings; inside the
port an artifact gives its ``Transcriber``'s and ``Corrector``'s output;
the JAX test cases that mean something here (padding, rejects, routing,
the kinds, the gateless and the span corrector, the CLI hooks, serving);
and the port's ``quantize.py`` held to its original. Both kernel tiers are
configured, so the port runs their plain versions; the JAX artifacts,
exported for the CPU, run its scan paths (exact in float32 against them,
tests/test_torch_infer.py)."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu import export as jexport
from attention_based_e2e_asr_dnn_tpu import quantize as jquantize
from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch import export as texport
from attention_based_e2e_asr_dnn_tpu_torch import quantize as tquantize
from attention_based_e2e_asr_dnn_tpu_torch import serving as tserving
from attention_based_e2e_asr_dnn_tpu_torch import train as ttrain
from attention_based_e2e_asr_dnn_tpu_torch.config import Config
from attention_based_e2e_asr_dnn_tpu_torch.tools import serve_http as cli

from test_torch_infer import toy  # noqa: F401  (the fixture)
from test_torch_lminfer import make_lm_experiment
from test_torch_server import _post

torch.set_num_threads(1)

BATCH, T_PAD, LM_T_PAD = 4, 32, 32
TEXTS = ["THE CAT SAT", "A DOG RAN ON A MAT", "IT'S THE MAT", "ON", "CAT DOG", "RAN"]


def _features(n, seed=3, longest=T_PAD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(5, longest + 1)), 15)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def arts(toy, tmp_path_factory):  # noqa: F811
    """Both packages' artifacts of the toy LAS (greedy, beam 3) and of a
    toy Rewriter (the gated corrector), each exported once."""
    _, _, exp = toy
    root = str(tmp_path_factory.mktemp("arts"))
    lm = make_lm_experiment(os.path.join(root, "lm"))
    out = {"exp": exp, "lm": lm, "root": root}
    for name, beam in (("greedy", 0), ("beam", 3)):
        out[f"jax_{name}"] = jexport.export_from_experiment(
            exp, os.path.join(root, f"jax-{name}.tlas"), batch=BATCH, t_pad=T_PAD,
            beam_size=beam, platforms=("cpu",))
        out[name] = texport.export_from_experiment(
            exp, os.path.join(root, f"{name}.tlas"), batch=BATCH, t_pad=T_PAD, beam_size=beam)
    out["jax_corrector"] = jexport.export_corrector_from_experiment(
        lm, os.path.join(root, "jax-corrector.tlas"), batch=BATCH, t_pad=LM_T_PAD,
        platforms=("cpu",))
    out["corrector"] = texport.export_corrector_from_experiment(
        lm, os.path.join(root, "corrector.tlas"), batch=BATCH, t_pad=LM_T_PAD)
    return out


# ---------------------------------------------------------------------------
# quantize.py, the copy
# ---------------------------------------------------------------------------

def test_quantize_copy_matches_the_original():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((96, 64)).astype(np.float32),
            "layers": [{"w_ih": rng.standard_normal((70, 80)).astype(np.float32),
                        "b": rng.standard_normal((80,)).astype(np.float32)}],
            "zero": np.zeros((64, 64), np.float32), "ids": np.arange(5000).reshape(50, 100)}
    ours, ref = tquantize.quantize_tree(tree), jquantize.quantize_tree(tree)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tquantize.is_quantized_leaf(ours["w"]) and not tquantize.is_quantized_leaf(ours["ids"])
    for a, b in zip(jax.tree.leaves(tquantize.dequantize_tree(ours)),
                    jax.tree.leaves(jquantize.dequantize_tree(ref))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tquantize.quantized_nbytes(ours) == jquantize.quantized_nbytes(ref)
    single = tquantize.quantize_array(tree["w"])
    np.testing.assert_array_equal(single[tquantize.QKEY],
                                  jquantize.quantize_array(tree["w"])[jquantize.QKEY])


# ---------------------------------------------------------------------------
# Across packages: one checkpoint, two artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["greedy", "beam"])
def test_las_artifact_decodes_the_jax_artifacts_ids(arts, name):
    ours = texport.ExportedDecoder(arts[name], device="cpu")
    ref = jexport.ExportedDecoder(arts[f"jax_{name}"])
    feats = _features(BATCH)
    x = np.zeros((BATCH, T_PAD, 15), np.float32)
    lx = np.array([len(f) for f in feats], np.int32)
    for i, f in enumerate(feats):
        x[i, : len(f)] = f
    np.testing.assert_array_equal(ours.decode_ids(x, lx), np.asarray(ref.decode_ids(x, lx)))
    assert ours.transcribe(feats[:3]) == ref.transcribe(feats[:3])
    for key in ("batch", "t_pad", "input_dim", "vocab", "sos_idx", "eos_idx", "pad_idx",
                "compute_dtype", "beam_size", "length_alpha", "max_steps", "quantize"):
        assert ours.meta[key] == ref.meta[key], key
    assert ours.meta["format"] == "tpu-las-torch-export-v1" != ref.meta["format"]


def test_corrector_artifact_corrects_as_the_jax_artifact(arts):
    ours = texport.ExportedCorrector(arts["corrector"], device="cpu")
    ref = jexport.ExportedCorrector(arts["jax_corrector"])
    for margin in (0.0, -1.0, 0.5):
        assert ours.correct(TEXTS, margin=margin) == ref.correct(TEXTS, margin=margin)
    assert ours.meta["score_width"] == ref.meta["score_width"]
    assert ours.meta["gate"] is ref.meta["gate"] is True


def test_each_package_refuses_the_others_artifact(arts):
    with pytest.raises(ValueError, match="tpu-las-export-v1.*tpu-las-torch-export-v1|"
                                         "tpu-las-torch-export-v1.*tpu-las-export-v1"):
        texport.ExportedDecoder(arts["jax_greedy"], device="cpu")
    with pytest.raises(ValueError, match="not a tpu-las-export-v1 artifact"):
        jexport.ExportedDecoder(arts["greedy"])


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,beam", [("greedy", 0), ("beam", 3)])
def test_artifact_transcriber_gives_the_transcribers_text(arts, name, beam):
    feats = _features(7, seed=4)
    ours = texport.ArtifactTranscriber([arts[name]], device="cpu")
    direct = tserving.Transcriber(arts["exp"], batch_size=BATCH, pad_time_multiple=T_PAD,
                                  beam_size=beam, device="cpu")
    assert ours.transcribe(feats) == direct.transcribe(feats)
    assert (ours.batch_size, ours.max_frames, ours.n_feats) == (BATCH, T_PAD, 15)


@pytest.mark.parametrize("gate,margin", [(True, 0.0), (True, 0.3), (False, 0.0)],
                         ids=["gate", "gate-margin", "gateless"])
def test_corrector_artifact_gives_the_correctors_text(arts, tmp_path, gate, margin):
    path = arts["corrector"] if gate else texport.export_corrector_from_experiment(
        arts["lm"], str(tmp_path / "gateless.tlas"), batch=BATCH, t_pad=LM_T_PAD, gate=False)
    ours = texport.ExportedCorrector(path, device="cpu")
    direct = tserving.Corrector(arts["lm"], beam_size=0, batch_size=BATCH,
                                confidence_margin=margin, gate=gate, device="cpu")
    assert ours.correct(TEXTS, margin=margin) == direct.correct(TEXTS)
    if not gate:
        with pytest.raises(ValueError, match="gate=False"):
            ours.correct(TEXTS, margin=0.1)


def test_span_corrector_artifact_gives_the_correctors_text(arts, tmp_path):
    path = texport.export_corrector_from_experiment(
        arts["lm"], str(tmp_path / "span.tlas"), batch=BATCH, t_pad=LM_T_PAD,
        span_rewrite=True)
    ours = texport.ExportedCorrector(path, device="cpu")
    for family, margin in (("best", 0.0), ("conf", -0.5)):
        direct = tserving.Corrector(arts["lm"], beam_size=0, batch_size=BATCH,
                                    confidence_margin=margin, span_rewrite=True,
                                    span_family=family, device="cpu")
        assert ours.correct(TEXTS, margin=margin, span_family=family) == \
            direct.correct(TEXTS)
    with pytest.raises(ValueError, match="span_family 'f33'"):
        ours.correct(TEXTS, span_family="f33")
    plain = texport.ExportedCorrector(arts["corrector"], device="cpu")
    with pytest.raises(ValueError, match="no span programs"):
        plain.correct(TEXTS, span_family="best")
    with pytest.raises(ValueError, match="span_rewrite requires gate"):
        texport.export_corrector_from_experiment(arts["lm"], str(tmp_path / "x.tlas"),
                                                 gate=False, span_rewrite=True)


def test_padding_detokenising_and_rejects(arts):
    dec = texport.ExportedDecoder(arts["greedy"], device="cpu")
    feats = _features(2)
    one = dec.transcribe(feats[:1])
    assert len(one) == 1 and isinstance(one[0], str)
    assert dec.transcribe(feats)[0] == one[0]  # a row does not see the others
    ids = dec.decode_ids(np.zeros((BATCH, T_PAD, 15), np.float32), np.ones(BATCH, np.int32))
    assert ids.dtype == np.int32 and ids.shape[0] == BATCH
    assert dec._detok(np.array([constants.SOS_IDX, 1, 2, constants.EOS_IDX, 3])) == \
        constants.VOCAB[1] + constants.VOCAB[2]
    with pytest.raises(ValueError, match="frames > exported t_pad"):
        dec.transcribe([np.zeros((T_PAD + 1, 15), np.float32)])
    with pytest.raises(ValueError, match="utterances > exported batch"):
        dec.transcribe(_features(BATCH + 1))
    with pytest.raises(ValueError, match="feature dim"):
        dec.transcribe([np.zeros((5, 14), np.float32)])
    corr = texport.ExportedCorrector(arts["corrector"], device="cpu")
    long_text = "A" * LM_T_PAD
    with pytest.raises(ValueError, match="ids > exported t_pad"):
        corr.correct([long_text])
    assert corr.correct([long_text, "CAT"], on_overflow="passthrough")[0] == long_text


def test_kind_guards(arts):
    with pytest.raises(ValueError, match="use ExportedCorrector"):
        texport.ExportedDecoder(arts["corrector"], device="cpu")
    with pytest.raises(ValueError, match="use ExportedDecoder"):
        texport.ExportedCorrector(arts["greedy"], device="cpu")
    with pytest.raises(TypeError, match="correct TEXT"):
        texport.ExportedCorrector(arts["corrector"], device="cpu").transcribe([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            texport.ExportedDecoder(arts["greedy"])  # the default device is the card


def test_routing_by_length_and_the_vocabulary_contract(arts, tmp_path):
    short = texport.export_from_experiment(arts["exp"], str(tmp_path / "t16.tlas"),
                                           batch=2, t_pad=16)
    art = texport.ArtifactTranscriber([arts["greedy"], short], device="cpu")
    assert art.bucket_t_pads == [16, T_PAD] and art.batch_size == BATCH
    assert art._route(16).meta["t_pad"] == 16 and art._route(17).meta["t_pad"] == T_PAD
    with pytest.raises(ValueError, match="exceeds the largest exported bucket"):
        art._route(T_PAD + 1)
    feats = _features(5, seed=9)
    single = texport.ArtifactTranscriber([arts["greedy"]], device="cpu")
    assert art.transcribe(feats) == single.transcribe(feats)
    # a bucket of another vocabulary
    with np.load(short, allow_pickle=False) as z:
        arrays = dict(z)
    record = json.loads(bytes(arrays["__record__"]).decode())
    record["meta"]["vocab"] = record["meta"]["vocab"][::-1]
    arrays["__record__"] = np.frombuffer(json.dumps(record).encode(), np.uint8)
    other = str(tmp_path / "other.tlas")
    with open(other, "wb") as fh:
        np.savez(fh, **arrays)
    with pytest.raises(ValueError, match="disagree on vocab"):
        texport.ArtifactTranscriber([arts["greedy"], other], device="cpu")
    with pytest.raises(ValueError, match="span_family needs a corrector"):
        texport.ArtifactTranscriber([arts["greedy"]], span_family="best", device="cpu")
    corr = texport.ExportedCorrector(arts["corrector"], device="cpu")
    with_corr = texport.ArtifactTranscriber([arts["greedy"]], corrector=corr, device="cpu")
    assert with_corr.transcribe(feats) == corr.correct(single.transcribe(feats),
                                                       on_overflow="passthrough")
    with pytest.raises(ValueError, match="no span programs"):
        texport.ArtifactTranscriber([arts["greedy"]], corrector=corr, span_family="best",
                                    device="cpu")


def test_warmup_and_readiness(arts):
    art = texport.ArtifactTranscriber([arts["greedy"]], device="cpu")
    assert art.wait_ready(timeout=0)  # no warm-up asked for: ready at once
    art.warmup(background=True).join(timeout=60)
    assert art.wait_ready(timeout=0)
    art.warmup()  # inline, again
    assert art.wait_ready(timeout=0)


def test_int8_artifact_reports_its_agreement(arts, tmp_path):
    """The int8 artifact's ids are reported against the float32 one's, not
    demanded equal (the JAX package's ``--check`` does the same)."""
    q = texport.export_from_experiment(arts["exp"], str(tmp_path / "q.tlas"), batch=BATCH,
                                       t_pad=T_PAD, quantize="int8")
    dec, ref = (texport.ExportedDecoder(p, device="cpu") for p in (q, arts["greedy"]))
    assert dec.meta["quantize"] == "int8"
    feats = _features(BATCH)
    x = np.zeros((BATCH, T_PAD, 15), np.float32)
    for i, f in enumerate(feats):
        x[i, : len(f)] = f
    lx = np.array([len(f) for f in feats], np.int32)
    a, b = dec.decode_ids(x, lx), ref.decode_ids(x, lx)
    assert a.shape == b.shape
    print(f"int8 artifact: {float((a == b).mean()):.3f} of ids agree with float32")
    with pytest.raises(ValueError, match="only 'int8'"):
        texport.export_from_experiment(arts["exp"], str(tmp_path / "q4.tlas"), quantize="int4")
    # data_parallel: the JAX divisibility check, then the split recorded; a
    # loader without two devices raises the JAX message
    with pytest.raises(ValueError, match="batch 3 not divisible by data_parallel 2"):
        texport.export_from_experiment(arts["exp"], str(tmp_path / "dp.tlas"), batch=3,
                                       data_parallel=2)
    dp_path = texport.export_from_experiment(arts["exp"], str(tmp_path / "dp.tlas"),
                                             data_parallel=2)
    assert texport.load_artifact(dp_path)[0]["data_parallel"] == 2
    with pytest.raises(ValueError, match="data_parallel=2 but only 1 devices visible"):
        texport.ExportedDecoder(dp_path, device="cpu")


# ---------------------------------------------------------------------------
# The hooks and serving
# ---------------------------------------------------------------------------

def test_export_hooks_write_loadable_artifacts(arts, tmp_path, capsys):
    """The ``export_artifact`` hook of both CLIs on a trained experiment's
    folder; a failure warns and does not raise."""
    from attention_based_e2e_asr_dnn_tpu_torch import lmtrain as tlmtrain

    exp = str(tmp_path / "exp")
    shutil.copytree(arts["exp"], exp)
    ttrain.export_hook(Config({"export_artifact": {"batch": 2, "t_pad": 16}}), exp)
    dec = texport.ExportedDecoder(os.path.join(exp, "artifacts", "las-b2-t16.tlas"),
                                  device="cpu")
    assert (dec.meta["batch"], dec.meta["t_pad"]) == (2, 16)
    lm = str(tmp_path / "lm")
    shutil.copytree(arts["lm"], lm)
    tlmtrain.export_hook(Config({"export_artifact": {"batch": 2, "t_pad": 32}}), lm)
    corr = texport.ExportedCorrector(os.path.join(lm, "artifacts", "corrector-b2-t32.tlas"),
                                     device="cpu")
    assert corr.meta["gate"] is True and isinstance(corr.correct(["HI"])[0], str)
    ttrain.export_hook(Config({"export_artifact": {"batch": 2, "t_pad": 16}}),
                       str(tmp_path / "missing"))
    assert "WARNING: export_artifact failed" in capsys.readouterr().err


def test_train_cli_writes_a_loadable_artifact(tmp_path):
    """The ``train`` CLI with an ``export_artifact`` block: after training,
    ``<experiment>/artifacts/las-b2-t64.tlas``, which transcribes with the
    model and bucket it records."""
    from test_torch_trainer import _cli_config

    from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data

    corpus = str(tmp_path / "corpus")
    make_synthetic_data.generate(corpus, n_train=8, n_dev=4, n_test=4, words_min=2,
                                 words_max=3, seed=1)
    path = _cli_config(corpus, tmp_path / "exp", epochs=1,
                       export_artifact={"batch": 2, "t_pad": 64})
    trainer = ttrain.main(ttrain.build_argparser().parse_args(["-c", path, "--device", "cpu"]))
    art = os.path.join(trainer.saving_dir, "artifacts", "las-b2-t64.tlas")
    dec = texport.ExportedDecoder(art, device="cpu")
    assert (dec.meta["batch"], dec.meta["t_pad"], dec.meta["kind"]) == (2, 64, "las")
    assert dec.meta["model"]["listener"]["remat"] is True
    assert all(isinstance(t, str) for t in dec.transcribe(_features(2, longest=64)))


def test_serve_http_serves_artifacts(arts):
    args = cli.build_argparser().parse_args(
        ["--artifact", arts["greedy"], "--corrector-artifact", arts["corrector"],
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--warmup"])
    art, srv = cli.start(args)
    try:
        assert art.wait_ready(timeout=120)
        feats = _features(3, seed=6)
        code, body = _post(f"http://127.0.0.1:{srv.port}/v1/transcribe",
                           {"instances": [{"features": f.tolist()} for f in feats]})
        direct = texport.ArtifactTranscriber(
            [arts["greedy"]], corrector=texport.ExportedCorrector(arts["corrector"],
                                                                  device="cpu"),
            device="cpu")
        assert code == 200 and body["transcripts"] == direct.transcribe(feats)
        code, body = _post(f"http://127.0.0.1:{srv.port}/v1/transcribe",
                           {"features": np.zeros((T_PAD + 8, 15)).tolist()})
        assert code == 400
    finally:
        srv.close()


@pytest.mark.parametrize("argv", [
    ["--artifact", "a.tlas", "--beam-size", "4"],
    ["--artifact", "a.tlas", "--corrector", "lm"],
    ["--artifact", "a.tlas", "--warmup", "512"],
    ["exp", "--artifact", "a.tlas"],
    ["exp", "--corrector-artifact", "c.tlas"],
], ids=["beam", "corrector", "warmup-values", "both-modes", "corrector-artifact-alone"])
def test_serve_http_refuses_flags_of_the_other_mode(argv):
    with pytest.raises(SystemExit):
        cli.main([*argv, "--device", "cpu"])


def test_serve_http_artifact_flag_repeats():
    args = cli.build_argparser().parse_args(["--artifact", "a", "--artifact", "b"])
    assert args.artifact == ["a", "b"] and args.exp_folder is None
    assert cli.artifact_flag_errors(args) == []
