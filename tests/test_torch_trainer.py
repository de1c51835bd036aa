"""PyTorch port, the Trainer, the ``train`` CLI and what they stand on, against
the JAX package: ``CheckpointManager`` on one sequence of epochs, the
optimizer state's flat leaves in the JAX order, the utilities the CLI
prints, the port's ``Trainer`` against the JAX ``Trainer`` on a tiny
generated corpus (float32, dropout and SpecAugment off, tf_rate 1.0, so that
no random draw enters), resume, checkpoints loaded across the packages both
ways, the CLI end to end on the CPU into the port's ``infer``, and the
Trainer's parallel arguments."""

import filecmp
import glob
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu import constants as jconstants
from attention_based_e2e_asr_dnn_tpu.config import Config as JConfig
from attention_based_e2e_asr_dnn_tpu.data.batching import BucketBatcher as JBatcher
from attention_based_e2e_asr_dnn_tpu.data.datasets import AsrTrainDevDataset as JDataset
from attention_based_e2e_asr_dnn_tpu.models import las as jlas
from attention_based_e2e_asr_dnn_tpu.training import checkpoints as jckpt
from attention_based_e2e_asr_dnn_tpu.training import optim as joptim
from attention_based_e2e_asr_dnn_tpu.training.trainer import Trainer as JTrainer
from attention_based_e2e_asr_dnn_tpu.utils import flops as jflops
from attention_based_e2e_asr_dnn_tpu.utils import summary as jsummary
from attention_based_e2e_asr_dnn_tpu_torch import infer as tinfer
from attention_based_e2e_asr_dnn_tpu_torch import train as ttrain
from attention_based_e2e_asr_dnn_tpu_torch.config import Config
from attention_based_e2e_asr_dnn_tpu_torch.data.batching import (
    BucketBatcher,
    ThreadedPrefetcher,
)
from attention_based_e2e_asr_dnn_tpu_torch.data.datasets import AsrTrainDevDataset
from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.tools import convergence_run, make_synthetic_data
from attention_based_e2e_asr_dnn_tpu_torch.training import checkpoints as tckpt
from attention_based_e2e_asr_dnn_tpu_torch.training import optim as toptim
from attention_based_e2e_asr_dnn_tpu_torch.training.trainer import Trainer
from attention_based_e2e_asr_dnn_tpu_torch.utils import flops as tflops
from attention_based_e2e_asr_dnn_tpu_torch.utils import logging as tlogging
from attention_based_e2e_asr_dnn_tpu_torch.utils import summary as tsummary

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

SEQUENCES = {
    # (dev loss, dev LD, dev ppl) an epoch
    "improving": [(3.0, 90.0, 20.0), (2.5, 80.0, 12.0), (2.0, 40.0, 7.0), (1.5, 10.0, 4.0)],
    "mixed": [(3.0, 90.0, 20.0), (3.1, 85.0, 22.0), (3.2, 95.0, 25.0), (2.9, 85.0, 18.0),
              (2.9, 70.0, 18.0)],
    "milestones": [(3.0 - 0.01 * e if e % 3 else 3.5, 90.0 - e if e % 4 else 99.0, 20.0)
                   for e in range(21)],
}


@pytest.mark.parametrize("case", list(SEQUENCES))
@pytest.mark.parametrize("max_savings", [1, 2, 3])
def test_checkpoint_manager_keeps_the_jax_files(tmp_path, case, max_savings):
    """The same sequence of (epoch, loss, LD, ppl) through both managers: the
    same return values, files kept and milestones, and the files load in the
    other package."""
    payload = {"params": {"w": np.arange(3, dtype=np.float32)}, "opt_state": None}
    managers = {}
    for name, mod in (("jax", jckpt), ("port", tckpt)):
        root = tmp_path / name
        managers[name] = mod.CheckpointManager(str(root / "ckpts"), str(root / "milestones"),
                                               max_savings=max_savings)
        # a crash save must survive the eviction
        mod.save_checkpoint(str(root / "ckpts" / "emergency-epoch[0].ckpt"), payload)
    for epoch, (loss, ld, ppl) in enumerate(SEQUENCES[case]):
        saved = {name: m.maybe_save(epoch, loss, ld, ppl, {**payload, "epoch": epoch})
                 for name, m in managers.items()}
        assert (saved["jax"] is None) == (saved["port"] is None)
        if saved["jax"]:
            assert os.path.basename(saved["jax"]) == os.path.basename(saved["port"])
    j, p = managers["jax"], managers["port"]
    assert p.saved_files == j.saved_files and len(p.saved_files) <= max_savings
    assert (p.min_loss, p.min_ld, p.min_ppl) == (j.min_loss, j.min_ld, j.min_ppl)
    names = lambda paths: [os.path.basename(f) for f in paths]  # noqa: E731
    assert names(p.list_checkpoints()) == names(j.list_checkpoints())
    assert "emergency-epoch[0].ckpt" in names(p.list_checkpoints())
    assert (sorted(os.listdir(tmp_path / "port" / "milestones"))
            == sorted(os.listdir(tmp_path / "jax" / "milestones")))
    assert jckpt.load_checkpoint(p.list_checkpoints()[-1])["epoch"] == \
        tckpt.load_checkpoint(j.list_checkpoints()[-1])["epoch"]
    p.reset_best()
    assert p.saved_files == [] and p.min_ld == float("inf")


# ---------------------------------------------------------------------------
# The optimizer state as the JAX package's flat leaves
# ---------------------------------------------------------------------------

TINY = jlas.LASConfig(
    listener=jlas.ListenerConfig(input_dim=15, uniform_hid_dim=8, lstm_layers=1,
                                 plstm_layers=1, init_dropout=0.0, mid_dropout=0.0,
                                 final_dropout=0.0),
    speller=jlas.SpellerConfig(enc_out_dim=16, att_proj_dim=8, att_heads=1,
                               dec_vocab_size=30, dec_emb_dim=16, dec_lstm_hid_dim=8,
                               dec_lstm_out_dim=8, dec_lstm_dropout=0.0, CHR_MAX_STEPS=40),
)
T_TINY = tlas.LASConfig(
    listener=tlas.ListenerConfig(**{**TINY.listener.__dict__, "lstm_impl": "pallas"}),
    speller=tlas.SpellerConfig(**TINY.speller.__dict__))


def _tiny_params(seed=0):
    return jax.tree.map(np.asarray, jlas.las_init(jax.random.key(seed), TINY))


OPTIMIZERS = {
    "adamw-amsgrad": ("adamw", {"lr": 1e-3, "weight_decay": 5e-6, "amsgrad": True}, 1),
    "adam": ("adam", {"lr": 1e-3}, 1),
    "sgd-momentum": ("sgd", {"lr": 1e-2, "momentum": 0.9}, 1),
    "sgd": ("sgd", {"lr": 1e-2}, 1),
    "adamw-accum2": ("adamw", {"lr": 1e-3, "amsgrad": True}, 2),
}


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_leaves_follow_the_jax_order(case):
    """After three updates on the same gradients, the port's state as flat
    leaves equals ``jax.tree_util.tree_leaves`` of the optax state leaf by
    leaf (order, shape, dtype kind; float32 values to 1e-6), and comes back
    from the leaves unchanged."""
    name, configs, accum = OPTIMIZERS[case]
    params = _tiny_params()
    module = tlas.las_from_jax_params(params)
    tx = joptim.build_optimizer(name, configs, grad_norm=5.0, accum_steps=accum)
    opt = toptim.build_optimizer(name, configs, grad_norm=5.0, accum_steps=accum)
    j_params, j_state = jax.tree.map(jnp.asarray, params), None
    j_state = tx.init(j_params)
    state = opt.init(module.parameters())
    rng = np.random.default_rng(1)
    names = [n for n, _ in module.named_parameters()]
    for _ in range(3):
        g_tree = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        _, j_state = tx.update(jax.tree.map(jnp.asarray, g_tree), j_state, j_params)
        grads = [torch.from_numpy(toptim._tree_get(g_tree, n)) for n in names]
        _, state = opt.update(grads, state, list(module.parameters()), configs["lr"])
    want = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(j_state)]
    got = toptim.opt_state_to_leaves(module, state, configs["lr"])
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, i
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=f"leaf {i}")
    back = toptim.opt_state_from_leaves(module, got, opt.init(module.parameters()))
    for a, b in zip(toptim.opt_state_to_leaves(module, back, configs["lr"]), got):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="optimizer leaves"):
        toptim.opt_state_from_leaves(module, got[:-1], opt.init(module.parameters()))


# ---------------------------------------------------------------------------
# What the CLI prints, and the small pieces
# ---------------------------------------------------------------------------

def test_model_summary_and_flops_match_jax():
    params = _tiny_params()
    module = tlas.las_from_jax_params(params)
    assert tsummary.model_summary(module, "tiny") == jsummary.model_summary(params, "tiny")
    for fn, args in (("listener_flops", (4, 64)), ("speller_flops", (4, 12, 32)),
                     ("las_forward_flops", (4, 64, 12)), ("las_train_step_flops", (4, 64, 12))):
        assert getattr(tflops, fn)(T_TINY, *args) == getattr(jflops, fn)(TINY, *args)
    assert tflops.lstm_layer_flops(2, 3, 4, 5) == jflops.lstm_layer_flops(2, 3, 4, 5)
    ours = tsummary.shape_flop_summary(module, T_TINY, batch=4, time_steps=64, label_len=12)
    ref = jsummary.shape_flop_summary(jax.tree.map(jnp.asarray, params), TINY, batch=4,
                                      time_steps=64, label_len=12)
    # the same table (the last line speaks of each package's decode routes)
    assert ours.splitlines()[:8] == ref.splitlines()[:8]


def test_shape_summary_raises_on_a_wiring_mistake():
    params = _tiny_params()
    params["speller"]["cell2"]["w_ih"] = np.zeros((9, 32), np.float32)
    with pytest.raises(ValueError, match="speller.cell2.w_ih"):
        tsummary.shape_flop_summary(tlas.las_from_jax_params(params), T_TINY, 4, 64, 12)
    with pytest.raises(ValueError, match="no multiple of 2"):
        tsummary.shape_flop_summary(tlas.las_from_jax_params(_tiny_params()), T_TINY, 4, 63, 12)


@pytest.mark.parametrize("name", ["base-las", "scaled-las"])
def test_flops_model_at_the_published_widths(name):
    """The analytic model at the widths of the repo's configs (integers, so
    equal): the listener's share of a train step is what the summary prints."""
    model = yaml.safe_load(open(os.path.join(REPO, "configs", f"{name}.yml")))["model"]["configs"]
    ours = tlas.las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    ref = jlas.las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    assert tflops.listener_flops(ours, 128, 1536) == jflops.listener_flops(ref, 128, 1536)
    assert tflops.speller_flops(ours, 128, 192, 192) == jflops.speller_flops(ref, 128, 192, 192)
    assert (tflops.las_train_step_flops(ours, 128, 1536, 192)
            == 3 * (tflops.listener_flops(ours, 128, 1536)
                    + tflops.speller_flops(ours, 128, 192, 192)))


def test_logging_folder_and_log_json(tmp_path):
    folder = tlogging.experiment_folder(str(tmp_path), "run")
    assert sorted(os.listdir(folder)) == ["ckpts", "imgs", "preds"]
    tlogging.dump_log_json(os.path.join(folder, "log.json"), {"loss": [1.0]}, {"ld": [2.0]})
    assert json.load(open(os.path.join(folder, "log.json"))) == [{"loss": [1.0]}, {"ld": [2.0]}]
    logger = tlogging.MetricLogger(use_wandb=False)
    logger.log({"a": 1})
    logger.finish()
    assert logger.run_name is None


def test_prefetcher_keeps_order_raises_and_closes():
    assert list(ThreadedPrefetcher(iter(range(20)), depth=3)) == list(range(20))

    def broken():
        yield 1
        raise RuntimeError("boom")

    pf = ThreadedPrefetcher(broken(), depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    pf = ThreadedPrefetcher(iter(range(1000)), depth=1)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()


def test_generator_copy_writes_the_same_bytes(tmp_path):
    """The port's copy of the corpus generator against the repository's
    ``tools/make_synthetic_data.py``: every file byte for byte."""
    root = _root_tool("make_synthetic_data")
    kw = dict(n_train=6, n_dev=3, n_test=3, words_min=2, words_max=4, seed=5)
    root.generate(str(tmp_path / "a"), **kw)
    make_synthetic_data.generate(str(tmp_path / "b"), **kw)
    files = sorted(os.path.relpath(f, tmp_path / "a") for f in
                   glob.glob(str(tmp_path / "a" / "**" / "*.*"), recursive=True))
    assert len(files) == 2 * 12 + 3
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b", files,
                                               shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == len(files)
    assert make_synthetic_data.LEXICON == root.LEXICON


def test_convergence_harness_copy_builds_the_same_config():
    root = _root_tool("convergence_run")
    assert convergence_run.ARCHS == root.ARCHS
    for arch in root.ARCHS:
        args = ("/d", "/e", 20, 32, arch, "pallas", "pallas", 120, False, 0.002)
        assert convergence_run.make_config(*args) == root.make_config(*args)


# ---------------------------------------------------------------------------
# Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

TRN = {
    "seed": 3, "epochs": 3, "batch_size": 8, "accu_grad": 1, "grad_norm": 5.0,
    "init_force": False, "tf_rate": 1.0, "max_savings": 2, "use_specaug": False,
    "eval_ld_interval": 1, "prefetch_depth": 2,
    "optimizer": {"name": "adamw", "configs": {"lr": 5e-3, "weight_decay": 1e-6,
                                               "amsgrad": True}},
    "batch_scheduler": {"use": True, "configs": {"warmup_epochs": 1, "min_lr": 1e-4}},
    "epoch_scheduler": {"use": True},
    "tf_rate_scheduler": {"use": True, "configs": {"factor": 0.1, "interval": 0,
                                                   "lowest": 0.7}},
    "dropout_scheduler": {"use": False, "configs": {}},
    "finetune": {"use": False},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic_data.generate(str(root), n_train=24, n_dev=8, n_test=8, words_min=2,
                                 words_max=3, seed=1)
    return str(root)


def _batchers(corpus, dataset_cls, batcher_cls):
    vocab_map = jconstants.VOCAB_MAP
    sets = [dataset_cls(std_dir=os.path.join(corpus, split), label_to_idx=vocab_map,
                        keep_tags=True) for split in ("train-clean-100", "dev-clean")]
    trn = batcher_cls(sets[0], 8, 64, 32, label_pad_id=29, shuffle=True, seed=3)
    dev = batcher_cls(sets[1], 8, 64, 32, label_pad_id=29)
    return trn, dev


def _jax_trainer(corpus, folder, extra=None, **kwargs):
    def make_apply(scale):
        def apply_fn(params, rng, x, lx, dec_y=None, tf_rate=1.0, init_force=False,
                     train=False):
            return jlas.las_apply(params, TINY, rng, x, lx, dec_y, tf_rate, init_force, train,
                                  unroll=1)
        return apply_fn

    trn, dev = _batchers(corpus, JDataset, JBatcher)
    return JTrainer(init_fn=lambda rng: jlas.las_init(jax.random.key(0), TINY),
                    make_apply=make_apply, trn_batcher=trn, dev_batcher=dev,
                    trncfgs=JConfig({**TRN, **(extra or {})}), saving_dir=str(folder),
                    milestone_dir=str(folder / "milestones"), sos_idx=0, eos_idx=29,
                    **kwargs)


def _port_trainer(corpus, folder, extra=None, **kwargs):
    trn, dev = _batchers(corpus, AsrTrainDevDataset, BucketBatcher)
    return Trainer(init_fn=lambda generator: tlas.las_from_jax_params(_tiny_params()),
                   make_apply=ttrain.make_las_apply_factory(T_TINY), trn_batcher=trn,
                   dev_batcher=dev, trncfgs=Config({**TRN, **(extra or {})}),
                   saving_dir=str(folder), milestone_dir=str(folder / "milestones"),
                   sos_idx=0, eos_idx=29, device="cpu", **kwargs)


def _record(trainer):
    copy = lambda hist: {k: list(v) for k, v in hist.items()}  # noqa: E731
    return {"train": copy(trainer.train_history), "dev": copy(trainer.dev_history),
            "lr": trainer.current_lr, "tf": trainer.tf_rate, "epoch": trainer.epoch,
            "batch": trainer.batch,
            "ckpts": sorted(os.listdir(os.path.join(trainer.saving_dir, "ckpts")))}


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """Both Trainers from the same parameters: two epochs, a save, a third
    epoch; the lr and tf_rate after every epoch."""
    out = {}
    for name, build in (("jax", _jax_trainer), ("port", _port_trainer)):
        folder = tmp_path_factory.mktemp(name)
        trainer = build(corpus, folder)
        trace = []
        for epochs in (1, 2):
            trainer.train_eval(epochs)
            trace.append((trainer.current_lr, trainer.tf_rate))
        saved = trainer.save(str(folder / "after-two.ckpt"))
        at_two = _record(trainer)
        trainer.train_eval(3)
        trace.append((trainer.current_lr, trainer.tf_rate))
        out[name] = {"trainer": trainer, "saved": saved, "at_two": at_two,
                     "final": _record(trainer), "trace": trace}
    return out


# float32 on both sides, nothing random: per-epoch means of losses that agree
# to ~1e-6 a step, after Adam's division by a small sqrt(nu) over 9 updates
LOSS_TOL = dict(atol=2e-4, rtol=2e-4)


def _assert_records_close(ours, ref, ld_atol=1e-6):
    for split, keys in (("train", ("loss", "ppl")), ("dev", ("loss", "ppl"))):
        for key in keys:
            np.testing.assert_allclose(ours[split][key], ref[split][key], **LOSS_TOL,
                                       err_msg=f"{split} {key}")
    # the dev LD is a count of edits over greedy ids: equal where the ids are
    np.testing.assert_allclose(ours["dev"]["ld"], ref["dev"]["ld"], atol=ld_atol)
    assert (ours["epoch"], ours["batch"], ours["ckpts"]) == (ref["epoch"], ref["batch"],
                                                             ref["ckpts"])
    np.testing.assert_allclose([ours["lr"], ours["tf"]], [ref["lr"], ref["tf"]], rtol=1e-12)


def test_trainer_matches_jax_trainer(runs):
    """Per-epoch train loss, dev loss, dev LD, the lr and tf_rate trajectories
    (cosine warm-up a batch, plateau an epoch, the tf scheduler) and the
    checkpoints kept."""
    _assert_records_close(runs["port"]["at_two"], runs["jax"]["at_two"])
    _assert_records_close(runs["port"]["final"], runs["jax"]["final"])
    np.testing.assert_allclose(runs["port"]["trace"], runs["jax"]["trace"], rtol=1e-12)
    final = runs["port"]["final"]
    assert final["epoch"] == 3 and final["batch"] == 9 and len(final["dev"]["ld"]) == 3
    assert final["train"]["loss"][-1] < final["train"]["loss"][0]
    assert len([f for f in final["ckpts"] if f.startswith("min")]) <= 2
    trainer = runs["port"]["trainer"]
    assert len(trainer.epoch_seconds) == len(trainer.train_seconds) == 3
    assert all(t >= a + b - 1e-6 for t, a, b in zip(trainer.epoch_seconds,
                                                     trainer.train_seconds,
                                                     trainer.eval_seconds))


def test_resume_equals_the_uninterrupted_run(runs, corpus, tmp_path):
    """A fresh port Trainer resumed (``finetune``) from the save after two
    epochs runs the third to the very numbers of the uninterrupted run: the
    parameters, the optimizer state, the counters and every scheduler's state
    come back."""
    resumed = _port_trainer(corpus, tmp_path, {"finetune": {
        "use": True, "checkpoint": runs["port"]["saved"], "reinit_lr": False}})
    assert (resumed.epoch, resumed.batch) == (2, 6)
    assert resumed.current_lr == runs["port"]["at_two"]["lr"]
    assert resumed.tf_rate == runs["port"]["at_two"]["tf"]
    assert int(resumed.state.opt_state.count) == 6 == resumed.state.step
    resumed.train_eval(3)
    final = runs["port"]["final"]
    assert resumed.train_history == final["train"] and resumed.dev_history == final["dev"]
    assert (resumed.current_lr, resumed.tf_rate) == (final["lr"], final["tf"])
    for a, b in zip(resumed.state.params.parameters(),
                    runs["port"]["trainer"].state.params.parameters()):
        assert torch.equal(a, b)
    reinit = _port_trainer(corpus, tmp_path / "reinit", {"finetune": {
        "use": True, "checkpoint": runs["port"]["saved"], "reinit_lr": True}})
    assert reinit.current_lr == TRN["optimizer"]["configs"]["lr"]


@pytest.mark.parametrize("source", ["jax", "port"])
def test_checkpoints_load_across_packages(runs, corpus, tmp_path, source):
    """A checkpoint of one package's ``Trainer.save`` resumes the other's
    Trainer: parameters, the optimizer leaves, the histories, the schedulers'
    state, tf_rate, current_lr; its third epoch lands where the writer's did."""
    build = _port_trainer if source == "jax" else _jax_trainer
    other = build(corpus, tmp_path)
    other.load(runs[source]["saved"])
    at_two = runs[source]["at_two"]
    assert (other.epoch, other.batch) == (2, 6)
    assert (other.current_lr, other.tf_rate) == (at_two["lr"], at_two["tf"])
    assert other.dev_history == at_two["dev"] and other.train_history == at_two["train"]
    loaded = (tckpt if source == "jax" else jckpt).load_checkpoint(runs[source]["saved"])
    assert loaded["schedulers"]["batch"] == {"step_count": 6}
    assert loaded["schedulers"]["epoch"]["num_bad"] == other.epoch_scheduler.num_bad
    n_params = len(jax.tree.leaves(_tiny_params()))
    assert loaded["dropout_scale"] == 1.0 and len(loaded["opt_state"]) == 3 + 3 * n_params
    other.train_eval(3)
    ref = runs[source]["final"]
    got = _record(other)
    got["ckpts"] = ref["ckpts"]  # the reader's folder holds only its third epoch's save
    _assert_records_close(got, ref)


def test_feed_dtype_resident_data_and_inline_feed(corpus, tmp_path):
    """``device_resident_data`` and ``prefetch_depth: 0`` feed the same
    batches as the two-stage prefetch; ``feed_dtype`` picks the wire dtype."""
    base = _port_trainer(corpus, tmp_path / "a", {"epochs": 1})
    # unshuffled: the resident feed draws its own batch order when shuffling
    base.trn_batcher.shuffle = False
    base.train_eval(1)
    for n, extra in enumerate(({"device_resident_data": True}, {"prefetch_depth": 0})):
        other = _port_trainer(corpus, tmp_path / str(n), {"epochs": 1, **extra})
        other.trn_batcher.shuffle = False
        other.train_eval(1)
        assert other.train_history == base.train_history
        assert other.dev_history == base.dev_history
    assert base.feed_dtype is None
    bf = Trainer(init_fn=lambda g: tlas.las_from_jax_params(_tiny_params()),
                 make_apply=ttrain.make_las_apply_factory(T_TINY), trn_batcher=base.trn_batcher,
                 dev_batcher=base.dev_batcher, trncfgs=Config(TRN), saving_dir=str(tmp_path / "b"),
                 compute_dtype=torch.bfloat16, device="cpu")
    assert bf.feed_dtype == torch.bfloat16
    item = next(iter(bf._prepared_batches(bf.trn_batcher.epoch(0))))
    assert item[0][0].dtype == torch.bfloat16 and item[0][2].dtype == torch.int32
    assert item[0][2].shape[1] == 31  # <sos> stripped from 32 label columns
    with pytest.raises(ValueError, match="feed_dtype"):
        _port_trainer(corpus, tmp_path / "c", {"feed_dtype": "float16"})


def test_crash_save_and_ld_interval(corpus, tmp_path):
    trainer = _port_trainer(corpus, tmp_path, {"eval_ld_interval": 2})
    trainer.train_eval(2)
    assert trainer.dev_history["ld"][1] == trainer.dev_history["ld"][0]

    def broken(*args, **kwargs):
        raise RuntimeError("device lost")

    trainer.train_step = broken
    with pytest.raises(RuntimeError, match="device lost"):
        trainer.train_eval(3)
    crash = os.path.join(str(tmp_path), "ckpts", "emergency-epoch[2].ckpt")
    assert tckpt.load_checkpoint(crash)["epoch"] == 2
    assert "emergency-epoch[2].ckpt" not in tckpt.list_best_checkpoints(
        os.path.join(str(tmp_path), "ckpts"))


# ---------------------------------------------------------------------------
# The parallel arguments: each builds its Trainer; an unknown one raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["shard_batch", "shard_state", "pipeline", "dp_mesh"])
def test_trainer_arguments_not_ported_raise(corpus, tmp_path, name):
    trn, dev = _batchers(corpus, AsrTrainDevDataset, BucketBatcher)
    kwargs = dict(init_fn=None, make_apply=None, trn_batcher=trn, dev_batcher=dev,
                  trncfgs=Config(TRN), saving_dir=str(tmp_path), device="cpu")
    if name == "dp_mesh":
        # ported (tests/test_torch_dp_cli.py): a one-rank mesh trains as one
        # process does, on the mesh's device, its batchers sharded
        from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as tmesh

        mesh = tmesh.make_mesh(1, device="cpu")
        try:
            trainer = Trainer(**{**kwargs, "init_fn": lambda g: tlas.las_from_jax_params(
                _tiny_params()), "make_apply": ttrain.make_las_apply_factory(T_TINY),
                "device": "cuda"}, dp_mesh=mesh)
            assert trainer.device == mesh.device
            # a one-rank mesh's rows: the whole batch
            assert trn.shard == slice(0, trn.batch_size)
            assert dev.shard == slice(0, dev.batch_size)
            assert trainer.is_writer
        finally:
            tmesh.close_mesh()
        return
    # ported: a grid's shard_batch and shard_state, and the pipeline, build
    # on the CPU (their steps: tests/test_torch_tp.py, test_torch_pipeline.py)
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import mesh as tmesh
    from attention_based_e2e_asr_dnn_tpu_torch.parallel import pipeline as tpipe

    grid = tmesh.make_mesh_2d(2, 2, devices=["cpu"] * 4)
    scan = tlas.LASConfig(listener=tlas.ListenerConfig(**{**T_TINY.listener.__dict__,
                                                          "lstm_impl": "scan"}),
                          speller=T_TINY.speller)
    given = {"shard_batch": tmesh.shard_batch_fn(grid),
             "shard_state": lambda s: tmesh.shard_train_state(s, grid),
             "pipeline": {"cfg": scan, "n_microbatches": 2, "devices": ["cpu"] * 2}}[name]
    trainer = Trainer(**{**kwargs, "init_fn": lambda g: tlas.las_from_jax_params(
        _tiny_params()), "make_apply": ttrain.make_las_apply_factory(scan)}, **{name: given})
    if name == "pipeline":
        assert isinstance(trainer.state, tpipe.PipelineState)
        assert trainer.tx.grad_norm == 1e30 and trainer.tx.accum_steps == 1
    else:
        assert isinstance(trainer.state.params, tmesh.GridParams)
        assert bool(trainer.state.params.sharded_names()) == (name == "shard_state")
    with pytest.raises(TypeError, match="unexpected keyword argument"):
        Trainer(**kwargs, no_such_argument=1)


def test_trainer_eval_beam_step_matches_jax(corpus, tmp_path):
    """``eval_beam_step``: the dev pass takes its loss from the free-running
    decode and its LD from beam search over one listener pass. One epoch of
    each Trainer from the same parameters: the same dev loss and beam LD."""
    from attention_based_e2e_asr_dnn_tpu.decoding.beam import make_las_eval_beam_step as j_step
    from attention_based_e2e_asr_dnn_tpu_torch.decoding.beam import (
        make_las_eval_beam_step as t_step,
    )

    records = {}
    for name, build, step in (("jax", _jax_trainer, j_step(TINY, 4, length_alpha=0.5)),
                              ("port", _port_trainer, t_step(T_TINY, 4, length_alpha=0.5))):
        folder = tmp_path / name
        folder.mkdir()
        trainer = build(corpus, folder, eval_beam_step=step)
        trainer.train_eval(1)
        records[name] = _record(trainer)
    _assert_records_close(records["port"], records["jax"])
    assert records["port"]["dev"]["ld"][0] > 0


def test_trainer_profile_block_and_missing_card_raise(corpus, tmp_path):
    trn, dev = _batchers(corpus, AsrTrainDevDataset, BucketBatcher)
    kwargs = dict(init_fn=None, make_apply=None, trn_batcher=trn, dev_batcher=dev,
                  saving_dir=str(tmp_path))
    # the profile block is ported (tests/test_torch_profile.py): it builds
    profiled = Trainer(init_fn=lambda g: tlas.las_from_jax_params(_tiny_params()),
                       make_apply=ttrain.make_las_apply_factory(T_TINY),
                       **{k: v for k, v in kwargs.items() if k not in ("init_fn", "make_apply")},
                       trncfgs=Config({**TRN, "profile": {"use": True}}), device="cpu")
    assert profiled.trncfgs.profile.use
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(**kwargs, trncfgs=Config(TRN))  # the default device is the card


def _cli_config(corpus, exp, **extra):
    cfg = convergence_run.make_config(corpus, str(exp), 2, batch_size=8, arch="scaled",
                                      lstm_impl="pallas", decoder_impl="pallas", max_steps=32)
    # the scaled-LAS block at toy widths: 4 heads, remat, both kernel tiers
    cfg["model"]["configs"]["listener_configs"].update(uniform_hid_dim=32, plstm_layers=2)
    cfg["model"]["configs"]["speller_configs"].update(
        att_proj_dim=32, dec_emb_dim=64, dec_lstm_hid_dim=32, dec_lstm_out_dim=32)
    cfg.update(pad_time_multiple=64, compute_dtype="float32", **extra)
    path = os.path.join(str(exp), "train.yml")
    os.makedirs(str(exp), exist_ok=True)
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


@pytest.mark.parametrize("extra,exc,match", [
    ({"parallel": {"use": True, "data": 4, "sequence": 2}}, ValueError,
     "sequence requires the scan implementations"),
    ({"parallel": {"use": True, "data": None, "model": 2}}, ValueError,
     "tensor parallelism.*lstm_impl and speller_configs.decoder_impl is 'pallas'"),
])
def test_cli_settings_not_ported_raise(corpus, tmp_path, extra, exc, match):
    path = _cli_config(corpus, tmp_path, **extra)
    with pytest.raises(exc, match=match):
        ttrain.main(ttrain.build_argparser().parse_args(["-c", path, "--device", "cpu"]))


def test_cli_with_eval_beam_size_takes_the_beam_dev_ld(corpus, tmp_path):
    """``eval_beam_size: 4`` wires the beam's eval step into the Trainer: the
    epoch's dev LD is the beam's over the dev batches, recomputed here from
    the trained parameters."""
    from attention_based_e2e_asr_dnn_tpu_torch.utils.levenshtein import batch_levenshtein

    path = _cli_config(corpus, tmp_path / "exp", eval_beam_size=4, length_alpha=0.5, epochs=1)
    trainer = ttrain.main(ttrain.build_argparser().parse_args(["-c", path, "--device", "cpu"]))
    assert trainer.eval_beam_step is not None
    lds = []
    for bt in trainer.dev_batcher.epoch(0):
        args = [torch.from_numpy(a) for a in (bt.x, bt.lx, bt.y, bt.ly)]
        _, ids = trainer.eval_beam_step(trainer.state.params, *args)
        real = bt.indices >= 0
        lds.append(batch_levenshtein(ids.numpy()[real], bt.y[real], bt.ly[real], 0, 29))
    assert trainer.dev_history["ld"] == [pytest.approx(float(np.mean(lds)), abs=1e-9)]


def test_cli_without_a_card_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    path = _cli_config(corpus, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(ttrain.build_argparser().parse_args(["-c", path]))
    assert ttrain.build_argparser().parse_args([]).device == "cuda"


def test_scaled_las_yaml_trips_the_tensor_parallel_check():
    """``configs/scaled-las.yml`` as committed asks for ``parallel.model: 2``
    with both kernel tiers: the JAX CLI's ``ValueError``, here too."""
    cfg = Config(yaml.safe_load(open(os.path.join(REPO, "configs", "scaled-las.yml"))))
    las_cfg = tlas.las_config_from_dicts(cfg.model.configs["listener_configs"],
                                         cfg.model.configs["speller_configs"])
    assert las_cfg.listener.remat and las_cfg.listener.uniform_hid_dim == 1024
    with pytest.raises(ValueError, match="model=2"):
        ttrain.check_ported(cfg, las_cfg)


# ---------------------------------------------------------------------------
# The CLI end to end
# ---------------------------------------------------------------------------

def test_train_cli_end_to_end_into_infer(corpus, tmp_path, capsys):
    """``train --device cpu`` on the generated corpus with the scaled-LAS
    block at toy widths (remat, 4 heads, both kernel tiers on their plain
    versions), a resumed run from its checkpoint, then the port's ``infer``
    from the experiment folder it wrote."""
    path = _cli_config(corpus, tmp_path / "exp")
    tlas.reset_decode_routes()
    trainer = ttrain.main(ttrain.build_argparser().parse_args(["-c", path, "--device", "cpu"]))
    folder = trainer.saving_dir
    assert sorted(os.listdir(folder)) == ["ckpts", "config.json", "imgs", "log.json", "preds"]
    log = json.load(open(os.path.join(folder, "log.json")))
    assert log == [trainer.train_history, trainer.dev_history]
    assert len(log[0]["loss"]) == 2 and log[0]["loss"][1] < log[0]["loss"][0]
    assert all(np.isfinite(v) for v in log[1]["loss"] + log[1]["ld"])
    snap = json.load(open(os.path.join(folder, "config.json")))
    assert snap["VOCAB"] == jconstants.VOCAB and snap["EOS_IDX"] == 29
    assert snap["model"]["configs"]["listener_configs"]["remat"] is True
    ckpts = tckpt.list_best_checkpoints(os.path.join(folder, "ckpts"))
    assert ckpts and ckpts == [os.path.basename(f) for f in trainer.ckpt.list_checkpoints()]
    assert os.path.isdir(os.path.join(str(tmp_path / "exp"), "milestones"))
    out = capsys.readouterr().out
    assert "parameters (" in out and "train step (fwd+bwd~3x)" in out and "[epoch 1]" in out
    assert set(tlas.decode_route_report().values()) == {"plain"}

    last = os.path.join(folder, "ckpts", ckpts[-1])
    saved = tckpt.load_checkpoint(last)
    resume = _cli_config(corpus, tmp_path / "exp2", epochs=saved["epoch"] + 1,
                         finetune={"use": True, "reinit_lr": False, "checkpoint": last})
    resumed = ttrain.main(ttrain.build_argparser().parse_args(["-c", resume, "--device", "cpu"]))
    assert resumed.epoch == saved["epoch"] + 1
    assert len(resumed.train_history["loss"]) == len(saved["train_loss"]) + 1
    assert f"at epoch[{saved['epoch']}]" in capsys.readouterr().out

    infer_yml = os.path.join(str(tmp_path), "infer.yml")
    with open(infer_yml, "w") as fh:
        yaml.safe_dump({"SOME_FOLDER": os.path.join(corpus, "test-clean"),
                        "exp_folder": folder, "batch_size": 8, "pad_time_multiple": 64,
                        "run_all": True, "epoch_num": None, "run_avg": True,
                        "early_stop": False}, fh)
    tinfer.main(tinfer.build_argparser().parse_args(["-c", infer_yml, "--device", "cpu"]))
    vocab = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")
    for name in [os.path.splitext(c)[0] for c in ckpts] + ["avg-all"]:
        lines = open(os.path.join(folder, "preds", f"{name}-tst.csv")).read().split("\n")
        rows = [ln.split(",", 1) for ln in lines[1:-1]]
        assert lines[0] == "id,label" and [r[0] for r in rows] == [str(i) for i in range(8)]
        assert all(set(r[1]) <= vocab for r in rows)


def test_convergence_harness_runs_on_the_cpu(corpus, tmp_path, capsys):
    """The port's convergence harness drives the port's CLI: one epoch of
    the small architecture on the tiny corpus, the verdict's JSON line."""
    capsys.readouterr()
    code = convergence_run.main(["--data-dir", corpus, "--exp-dir", str(tmp_path / "e"),
                                 "--epochs", "1", "--batch-size", "8", "--arch", "small",
                                 "--device", "cpu", "--max-steps", "32", "--target-ld", "1000"])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert code == 0 and verdict["converged"] and verdict["device"] == "cpu"
    assert len(verdict["dev_ld_history"]) == len(verdict["train_seconds"]) == 1
