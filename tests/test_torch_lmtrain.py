"""PyTorch port, the Rewriter's training (``lmtrain.py``,
``models/rewriter.py::draw_rewriter_noise``) against the JAX package's on
one toy corpus, in float32 on the CPU: the two ``lmtrain`` CLIs from the
same parameters (epoch losses, dev LD, the folders they write), each
package's ``lminfer`` on the other's folder, a checkpoint resumed across
the packages both ways, one train step with dropout on against the JAX
step with its draws replayed, and what the CLI refuses. The port trains
with both kernel tiers configured (their plain versions under the autograd
Functions); the JAX CLI with its scan paths (equal in float32,
tests/test_torch_train_las.py)."""

import argparse
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu import lminfer as jlminfer
from attention_based_e2e_asr_dnn_tpu import lmtrain as jlmtrain
from attention_based_e2e_asr_dnn_tpu.data.batching import BucketBatcher as JBatcher
from attention_based_e2e_asr_dnn_tpu.data.datasets import LmTrainDevDataset as JLmDataset
from attention_based_e2e_asr_dnn_tpu.models import rewriter as jrw
from attention_based_e2e_asr_dnn_tpu.training import optim as joptim
from attention_based_e2e_asr_dnn_tpu.training import steps as jsteps
from attention_based_e2e_asr_dnn_tpu_torch import constants
from attention_based_e2e_asr_dnn_tpu_torch import lminfer as tlminfer
from attention_based_e2e_asr_dnn_tpu_torch import lmtrain as tlmtrain
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import BucketBatcher
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import LmTrainDevDataset
from attention_based_e2e_asr_dnn_tpu_torch.export import ExportedCorrector
from attention_based_e2e_asr_dnn_tpu_torch.models import rewriter as trw
from attention_based_e2e_asr_dnn_tpu_torch.models.las import TrainDraws
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training import steps as tsteps

torch.set_num_threads(1)

WORDS = ["THE", "CAT", "SAT", "ON", "A", "MAT", "IT'S", "DOG", "RAN", "HOME"]
MODEL = dict(emb_dim=16, enc_lstm_layers=2, enc_lstm_hid_dim=8, enc_dropouts=[0.0, 0.0],
             att_proj_dim=8, att_heads=1, att_dropout=0.0, dec_lstm_layers=2,
             dec_lstm_hid_dim=16, dec_lstm_out_dim=8, dec_lstm_dropout=0.0, CHR_MAX_STEPS=20)
KERNELS = {"lstm_impl": "pallas", "decoder_impl": "pallas"}
LOSS_TOL = dict(atol=2e-4, rtol=2e-4)  # float32 losses, summed in another order


def _corpus(root, n_train=12, n_dev=6, seed=0):
    """Gold transcripts (``.npy`` character arrays) and LAS-like predictions
    (one character in five replaced by Q) for train and dev."""
    rng = np.random.default_rng(seed)
    out = {}
    for split, n in (("trn", n_train), ("dev", n_dev)):
        trans = os.path.join(root, split, "transcript")
        os.makedirs(trans)
        preds = []
        for i in range(n):
            gold = " ".join(rng.choice(WORDS, int(rng.integers(1, 4))))
            np.save(os.path.join(trans, f"{i:03d}.npy"), np.array(list(gold)))
            preds.append("".join("Q" if j % 5 == 3 else c for j, c in enumerate(gold)))
        pred = os.path.join(root, split, "pred.txt")
        with open(pred, "w") as fh:
            fh.write("\n".join(preds) + "\n")
        out[split] = (trans, pred)
    return out


def _config(corpus, exp, model=None, **extra):
    cfg = {
        "TRN_FOLDER": corpus["trn"][0], "DEV_FOLDER": corpus["dev"][0],
        "TRN_PRED_DIR": corpus["trn"][1], "DEV_PRED_DIR": corpus["dev"][1],
        "EXP_FOLDER": exp, "seed": 3, "epochs": 3, "batch_size": 4, "accu_grad": 1,
        "grad_norm": 5.0, "eval_ld_interval": 1, "tf_rate": 1.0, "max_savings": 2,
        "init_force": False, "compute_dtype": "float32", "pad_label_multiple": 8,
        "wandb": {"use": False},
        "finetune": {"use": False, "reinit_lr": False, "checkpoint": None},
        "model": {"tag": "lm-toy", "configs": {**MODEL, **(model or {})}},
        "optimizer": {"name": "adamw", "configs": {"lr": 0.003}},
        "batch_scheduler": {"use": False, "configs": {}},
        "epoch_scheduler": {"use": False},
        "tf_rate_scheduler": {"use": False, "configs": {}},
        "dropout_scheduler": {"use": False, "configs": {}},
        **extra,
    }
    os.makedirs(exp, exist_ok=True)
    path = os.path.join(exp, "lm.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def _params(seed=0):
    """Seeded Rewriter parameters (the JAX init, non-zero learned states)."""
    cfg = jrw.RewriterConfig(**{**MODEL, "enc_dropouts": (0.0, 0.0)})
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          jrw.rewriter_init(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["decoder"][key] = rng.uniform(-0.5, 0.5, params["decoder"][key].shape
                                             ).astype(np.float32)
    return params


def _run(side, cfg_path, params=None):
    """One CLI run; with ``params`` both packages start from them."""
    with pytest.MonkeyPatch.context() as mp:
        if params is not None:
            mp.setattr(jlmtrain, "rewriter_init",
                       lambda rng, cfg: jax.tree.map(jnp.asarray, params))
            mp.setattr(tlmtrain, "rewriter_init",
                       lambda cfg, gen: trw.rewriter_from_jax_params(params))
        if side == "jax":
            return jlmtrain.main(argparse.Namespace(config_file=cfg_path))
        return tlmtrain.main(tlmtrain.build_argparser().parse_args(
            ["-c", cfg_path, "--device", "cpu"]))


def _folder(exp_root):
    (run,) = [os.path.join(exp_root, d) for d in os.listdir(exp_root)
              if os.path.isdir(os.path.join(exp_root, d))]
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two CLIs, three epochs each from the same parameters; the port's
    with the kernel tiers and an ``export_artifact`` block."""
    root = str(tmp_path_factory.mktemp("lmtrain"))
    corpus = _corpus(root)
    params = _params()
    out = {"root": root, "corpus": corpus}
    for side in ("jax", "port"):
        exp = os.path.join(root, f"exp-{side}")
        extra = ({"export_artifact": {"batch": 2, "t_pad": 32}} if side == "port" else {})
        cfg = _config(corpus, exp, KERNELS if side == "port" else None, **extra)
        trainer = _run(side, cfg, params)
        out[side] = {"trainer": trainer, "folder": _folder(exp),
                     "train": dict(trainer.train_history), "dev": dict(trainer.dev_history)}
    return out


def test_lmtrain_cli_matches_the_jax_cli(runs):
    """Per-epoch train and dev losses within 2e-4, the dev LD equal, the
    same checkpoints kept, the same experiment folder."""
    ours, ref = runs["port"], runs["jax"]
    for split in ("train", "dev"):
        for key in ("loss", "ppl"):
            np.testing.assert_allclose(ours[split][key], ref[split][key], **LOSS_TOL,
                                       err_msg=f"{split} {key}")
    np.testing.assert_allclose(ours["dev"]["ld"], ref["dev"]["ld"], atol=1e-9)
    assert len(ours["train"]["loss"]) == 3 and ours["train"]["loss"][-1] < ours["train"]["loss"][0]
    names = {side: sorted(os.listdir(os.path.join(runs[side]["folder"], "ckpts")))
             for side in ("jax", "port")}
    assert names["port"] == names["jax"] and names["port"]
    for side in ("jax", "port"):
        folder = runs[side]["folder"]
        assert os.path.exists(os.path.join(folder, "log.json"))
        with open(os.path.join(folder, "config.json")) as fh:
            snap = json.load(fh)
        assert snap["VOCAB"] == list(constants.VOCAB) and snap["EOS_IDX"] == constants.EOS_IDX
        assert snap["model"]["configs"]["CHR_PAD_IDX"] == constants.EOS_IDX
    with open(os.path.join(runs["port"]["folder"], "log.json")) as fh:
        log = json.load(fh)
    with open(os.path.join(runs["jax"]["folder"], "log.json")) as fh:
        ref_log = json.load(fh)
    assert type(ref_log) is type(log) and len(ref_log) == len(log)


def test_lm_batches_are_the_jax_batches(runs):
    """The id inputs padded with EOS (``label_pad_id``), the labels, the
    lengths and the shuffled order, byte for byte."""
    trans, pred = runs["corpus"]["trn"]
    ours = BucketBatcher(LmTrainDevDataset(trans, pred, constants.VOCAB_MAP), 4,
                         pad_time_multiple=8, pad_label_multiple=8,
                         label_pad_id=constants.EOS_IDX, shuffle=True, seed=3)
    ref = JBatcher(JLmDataset(trans, pred, constants.VOCAB_MAP), 4, pad_time_multiple=8,
                   pad_label_multiple=8, label_pad_id=constants.EOS_IDX, shuffle=True, seed=3)
    for epoch in (0, 1):
        for a, b in zip(ours.epoch(epoch), ref.epoch(epoch), strict=True):
            for key in ("x", "lx", "y", "ly", "indices"):
                x, y = getattr(a, key), getattr(b, key)
                assert x.dtype == y.dtype and np.array_equal(x, y), key


def _lminfer_csv(side, folder, runs, tmp_path):
    trans, pred = runs["corpus"]["dev"]
    copy = shutil.copytree(folder, str(tmp_path / f"{side}-{os.path.basename(folder)}"))
    cfg = {"TST_DIR": pred, "TST_FOLDER": str(tmp_path / "no-template"), "exp_folder": copy,
           "batch_size": 4, "run_all": True, "epoch_num": None, "run_avg": False}
    path = str(tmp_path / f"{side}.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    if side == "jax":
        jlminfer.main(argparse.Namespace(config_file=path))
    else:
        tlminfer.main(tlminfer.build_argparser().parse_args(["-c", path, "--device", "cpu"]))
    out = {os.path.basename(f): open(f, "rb").read()
           for f in sorted(glob.glob(os.path.join(copy, "ckpts", "*-pred.csv")))}
    assert out
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_lminfer_reads_the_other_packages_folder(runs, tmp_path, writer):
    """Both packages' ``lminfer`` on the folder one CLI wrote: the same
    corrected lines, byte for byte."""
    folder = runs[writer]["folder"]
    assert _lminfer_csv("port", folder, runs, tmp_path) == \
        _lminfer_csv("jax", folder, runs, tmp_path)


def test_checkpoint_resumes_across_packages(runs, tmp_path):
    """The port resumes the JAX run's last checkpoint and the JAX CLI the
    port's (``finetune``): the two resumed runs agree as the first ones
    did."""
    hist = {}
    for side, other in (("port", "jax"), ("jax", "port")):
        ckpts = os.path.join(runs[other]["folder"], "ckpts")
        last = sorted(os.listdir(ckpts),
                      key=lambda f: int(f.split("epoch[")[1].split("]")[0]))[-1]
        exp = str(tmp_path / f"resume-{side}")
        cfg = _config(runs["corpus"], exp, KERNELS if side == "port" else None, epochs=4,
                      finetune={"use": True, "reinit_lr": False,
                                "checkpoint": os.path.join(ckpts, last)})
        trainer = _run(side, cfg)
        hist[side] = dict(trainer.train_history)
    assert len(hist["port"]["loss"]) == len(hist["jax"]["loss"]) > 3
    np.testing.assert_allclose(hist["port"]["loss"], hist["jax"]["loss"], **LOSS_TOL)


def test_export_hook_writes_a_loadable_corrector(runs):
    path = os.path.join(runs["port"]["folder"], "artifacts", "corrector-b2-t32.tlas")
    corr = ExportedCorrector(path, device="cpu")
    assert corr.meta["gate"] is True and corr.meta["batch"] == 2
    assert corr.meta["model"]["lstm_impl"] == "pallas"
    assert all(isinstance(s, str) for s in corr.correct(["THE CAT", "A DOG"]))


# ---------------------------------------------------------------------------
# One train step with dropout on, the JAX draws replayed
# ---------------------------------------------------------------------------

DROP = {**MODEL, "enc_dropouts": (0.3, 0.25), "dec_lstm_dropout": 0.3}
B, T, L = 5, 16, 12
LX = np.array([16, 9, 3, 12, 16], np.int32)
LY = np.array([12, 7, 2, 10, 12], np.int32)
OPT = {"lr": 3e-3, "weight_decay": 5e-6, "amsgrad": True}


def replay_rewriter_draws(model_rng, cfg, batch, steps) -> TrainDraws:
    """The draws of the JAX ``rewriter_apply(train=True)`` under
    ``model_rng``, by the JAX package's own key splits (rewriter.py:118;
    ops/lstm.py's locked stack; las.py's speller: coins and the cells'
    masks)."""
    rng_enc, rng_dec = jax.random.split(model_rng)
    masks = []
    rng = rng_enc
    for i in range(cfg.enc_lstm_layers):
        rate = cfg.enc_dropouts[-1] if i else cfg.enc_dropouts[0]
        if rate > 0.0:
            rng, sub = jax.random.split(rng)
            masks.append(np.asarray(jax.random.bernoulli(
                sub, 1.0 - rate, (batch, 1, 2 * cfg.enc_lstm_hid_dim))))
        else:
            masks.append(None)
    _, coin_rng, drop_rng = jax.random.split(rng_dec, 3)
    coins = np.asarray(jax.random.uniform(coin_rng, (steps,)))
    m1 = m2 = None
    if cfg.dec_lstm_dropout > 0.0:
        keep = 1.0 - cfg.dec_lstm_dropout
        pairs = [jax.random.split(k) for k in jax.random.split(drop_rng, steps)]
        m1 = np.stack([np.asarray(jax.random.bernoulli(r1, keep, (batch, cfg.dec_lstm_hid_dim)))
                       for r1, _ in pairs])
        m2 = np.stack([np.asarray(jax.random.bernoulli(r2, keep, (batch, cfg.dec_lstm_out_dim)))
                       for _, r2 in pairs])
    as_t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return TrainDraws([as_t(m) for m in masks], as_t(coins), as_t(m1), as_t(m2))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 29, (B, T)).astype(np.int32)
    x[:, 0] = constants.SOS_IDX
    x[np.arange(T)[None, :] >= LX[:, None]] = constants.EOS_IDX
    y = rng.integers(1, 29, (B, L)).astype(np.int32)
    y[np.arange(L)[None, :] >= LY[:, None]] = constants.EOS_IDX
    return x, y


# bfloat16: the two packages round at other places, and a flipped rounding
# moves a loss of ~3.4 by a bf16 step of it or two
STEP_TOL = {"float32": dict(atol=2e-5, rtol=0), "bfloat16": dict(atol=2 * 2.0 ** -6, rtol=0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_train_step_with_dropout_matches_jax(dtype):
    """Encoder and decoder dropout and teacher forcing at 0.5 on: the loss,
    the gradient norm and (float32) every updated parameter of one AdamW
    step, the port fed the draws the JAX step takes from its key."""
    j_cfg = jrw.RewriterConfig(**DROP)
    t_cfg = trw.RewriterConfig(**{**DROP, **KERNELS})
    params = _params(1)
    x, y = _batch()
    j_dtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    t_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx = joptim.build_optimizer("adamw", OPT, grad_norm=5.0)
    j_apply = jlmtrain.make_rewriter_apply_factory(j_cfg, compute_dtype=j_dtype)(1.0)
    j_step = jsteps.make_train_step(j_apply, tx, compute_dtype=j_dtype, donate=False)
    j_state = jsteps.create_train_state(jax.tree.map(jnp.asarray, params), tx,
                                        jax.random.key(7))
    opt = toptim.build_optimizer("adamw", OPT, grad_norm=5.0)
    t_apply = tlmtrain.make_rewriter_apply_factory(t_cfg, compute_dtype=t_dtype)(1.0)
    t_step = tsteps.make_train_step(t_apply, opt, compute_dtype=t_dtype)
    state = tsteps.create_train_state(trw.rewriter_from_jax_params(params), opt, device="cpu")
    _, _, model_rng = jax.random.split(j_state.rng, 3)
    draws = replay_rewriter_draws(model_rng, j_cfg, B, L)
    j_state, j_metrics, _ = j_step(j_state, jnp.asarray(x), jnp.asarray(LX), jnp.asarray(y),
                                   jnp.asarray(LY), 0.5, 3e-3)
    args = [torch.from_numpy(a) for a in (x, LX, y, LY)]
    state, metrics, _ = t_step(state, *args, 0.5, 3e-3, draws=draws)
    tol = STEP_TOL[dtype]
    np.testing.assert_allclose(float(metrics["loss"]), float(j_metrics["loss"]), **tol)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               atol=tol["atol"] * 10 if dtype == "bfloat16" else 2e-5,
                               rtol=0.05 if dtype == "bfloat16" else 1e-4)
    if dtype == "float32":
        ours = trw.rewriter_to_jax_params(state.params)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree.leaves(jax.tree.map(np.asarray, j_state.params))):
            # the keys' bias: a shift of every key moves all scores alike, so
            # its gradient is rounding noise that Adam scales to ~lr
            atol = 2 * OPT["lr"] if "key_map" in str(path) and "'b'" in str(path) else 2e-5
            np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4, err_msg=str(path))
    # and without the draws the noise comes from the state's generator:
    # dropout on, so a second step's loss is not the no-dropout loss
    no_drop = trw.rewriter_apply(state.params, t_cfg, args[0], args[1], args[2], train=True)
    drawn = t_apply(state.params, args[0], args[1], dec_y=args[2], tf_rate=1.0, train=True,
                    generator=torch.Generator().manual_seed(0))
    assert not torch.equal(no_drop.logits, drawn.logits)


def test_draw_rewriter_noise_shapes_and_rates():
    cfg = trw.RewriterConfig(**{**DROP, "enc_dropouts": (0.3, 0.25), "emb_dim": 16})
    gen = torch.Generator().manual_seed(0)
    drawn = trw.draw_rewriter_noise(cfg, 64, 40, gen, "cpu")
    replayed = replay_rewriter_draws(jax.random.key(0), jrw.RewriterConfig(**DROP), 64, 40)
    assert len(drawn.listener_masks) == len(replayed.listener_masks) == 2
    for a, b in zip(drawn.listener_masks + [drawn.coins, drawn.m1, drawn.m2],
                    replayed.listener_masks + [replayed.coins, replayed.m1, replayed.m2]):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert drawn.listener_masks[0].shape == (64, 1, 16) and drawn.m1.shape == (40, 64, 16)
    assert drawn.m2.shape == (40, 64, 8) and drawn.specaug is None
    assert abs(drawn.listener_masks[0].float().mean().item() - 0.7) < 0.08
    assert abs(drawn.listener_masks[1].float().mean().item() - 0.75) < 0.08
    assert abs(drawn.m1.float().mean().item() - 0.7) < 0.02
    assert 0.0 <= float(drawn.coins.min()) and float(drawn.coins.max()) < 1.0
    none = trw.draw_rewriter_noise(trw.RewriterConfig(**MODEL), 4, 6, gen, "cpu")
    assert none.listener_masks == [None, None] and none.m1 is None and none.m2 is None
    # the same generator state gives the same draws
    a = trw.draw_rewriter_noise(cfg, 4, 6, torch.Generator().manual_seed(5), "cpu")
    b = trw.draw_rewriter_noise(cfg, 4, 6, torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.listener_masks + [a.coins, a.m1],
                                                 b.listener_masks + [b.coins, b.m1]))


def test_scale_dropouts_and_the_vocab_injection():
    cfg = trw.RewriterConfig(**DROP)
    half = tlmtrain.scale_rewriter_dropouts(cfg, 0.5)
    ref = jlmtrain.scale_rewriter_dropouts(jrw.RewriterConfig(**DROP), 0.5)
    assert (half.enc_dropouts, half.att_dropout, half.dec_lstm_dropout) == \
        (ref.enc_dropouts, ref.att_dropout, ref.dec_lstm_dropout)
    assert tlmtrain.scale_rewriter_dropouts(cfg, 1.0) is cfg
    base = {"model": {"configs": {}}}
    assert tlmtrain.inject_lm_vocab(json.loads(json.dumps(base))) == \
        jlmtrain.inject_lm_vocab(json.loads(json.dumps(base)))


# ---------------------------------------------------------------------------
# What the CLI refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parallel,model,exc,match", [
    ({"use": True, "pipeline": 2}, None, ValueError, "pipeline is LAS-only"),
    ({"use": True, "sequence": 2}, None, ValueError, "sequence is LAS-only"),
    ({"use": True, "model": 2}, KERNELS, ValueError,
     "tensor parallelism.*lstm_impl and decoder_impl is 'pallas'"),
    # data parallelism is ported (tests/test_torch_dp_cli.py trains it): three
    # ranks cannot split a batch of 4, and the spawned ranks say so
    ({"use": True, "data": 3}, None, RuntimeError,
     "batch dim 4 not divisible by data-parallel degree 3"),
    # tensor parallelism trains on the scan loops (tests/test_torch_tp.py);
    # a batch its grid's rows cannot split raises the JAX message
    ({"use": True, "model": 2, "data": 3}, None, ValueError,
     "batch dim 4 not divisible by data-parallel degree 3"),
], ids=["pipeline", "sequence", "tensor-parallel-kernels", "data", "tensor-parallel-scan"])
def test_parallel_settings_raise(tmp_path, parallel, model, exc, match):
    corpus = _corpus(str(tmp_path / "c"), n_train=4, n_dev=2)
    cfg = _config(corpus, str(tmp_path / "exp"), model, parallel=parallel)
    with pytest.raises(exc, match=match):
        tlmtrain.main(tlmtrain.build_argparser().parse_args(["-c", cfg, "--device", "cpu"]))


def test_cli_without_a_card_raises(tmp_path):
    assert tlmtrain.build_argparser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        corpus = _corpus(str(tmp_path / "c"), n_train=4, n_dev=2)
        cfg = _config(corpus, str(tmp_path / "exp"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlmtrain.main(tlmtrain.build_argparser().parse_args(["-c", cfg]))

