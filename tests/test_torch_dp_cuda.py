"""PyTorch port, data parallelism across two cards: ``Transcriber(
data_parallel=2)`` and a ``data_parallel=2`` artifact decode over ``cuda:0``
and ``cuda:1`` (the parameters copied to the second card, the caller's
module left on the first) with the transcripts of ``data_parallel=1``, and
the ``train`` CLI trains with ``parallel: {use: true, data: 2}``, two ranks
on two cards over NCCL. At base-LAS widths on both kernel tiers, random
weights from a seed. Needs two CUDA devices; the CPU tests hold the same
entry points over ``[cpu, cpu]`` (``tests/test_torch_dp_cli.py``).

    python -m pytest tests/test_torch_dp_cuda.py -m cuda --noconftest -q
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from attention_based_e2e_asr_dnn_tpu_torch import EOS_IDX, SOS_IDX, VOCAB
from attention_based_e2e_asr_dnn_tpu_torch import export, serving, train
from attention_based_e2e_asr_dnn_tpu_torch.models.las import (
    las_config_from_dicts,
    las_init,
    las_to_jax_params,
)
from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data
from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import save_checkpoint

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available() or torch.cuda.device_count() < 2,
                       reason="needs two CUDA devices"),
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 15
BATCH = 8


def _base_las() -> dict:
    with open(os.path.join(REPO, "configs", "base-las.yml")) as fh:
        return yaml.safe_load(fh)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """A base-LAS experiment folder with seeded random parameters."""
    root = str(tmp_path_factory.mktemp("exp"))
    model = _base_las()["model"]["configs"]
    cfg = las_config_from_dicts(model["listener_configs"], model["speller_configs"])
    params = las_to_jax_params(las_init(cfg, torch.Generator().manual_seed(SEED)))
    rng = np.random.default_rng(SEED)
    for key in ("init_h1", "init_c1", "init_h2", "init_c2"):
        params["speller"][key] = rng.uniform(-0.5, 0.5, params["speller"][key].shape
                                             ).astype(np.float32)
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump({"compute_dtype": "bfloat16", "VOCAB": list(VOCAB), "SOS_IDX": SOS_IDX,
                   "EOS_IDX": EOS_IDX, "model": {"tag": "base-LAS", "configs": model}}, fh)
    save_checkpoint(os.path.join(root, "ckpts", "min-loss-epoch[1].ckpt"),
                    {"params": params, "epoch": 1})
    return root


def _features(n: int):
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal((int(rng.integers(100, 500)), 15)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("beam", [0, 4], ids=["greedy", "beam"])
def test_transcriber_splits_over_two_cards(experiment, beam):
    feats = _features(2 * BATCH + 3)
    one = serving.Transcriber(experiment, batch_size=BATCH, pad_time_multiple=256,
                              beam_size=beam, device="cuda")
    two = serving.Transcriber(experiment, batch_size=BATCH, pad_time_multiple=256,
                              beam_size=beam, data_parallel=2, device="cuda")
    cards = [{p.device for p in params.parameters()} for params in two._split.params]
    assert cards == [{torch.device("cuda", 0)}, {torch.device("cuda", 1)}]
    assert two._split.params[0] is two.params
    assert two.transcribe(feats) == one.transcribe(feats)


def test_data_parallel_artifact_splits_over_two_cards(experiment, tmp_path):
    feats = _features(BATCH + 5)
    paths = [export.export_from_experiment(experiment, str(tmp_path / f"a{n}.tlas"),
                                           batch=BATCH, t_pad=512, data_parallel=n)
             for n in (1, 2)]
    a1, a2 = (export.ArtifactTranscriber([p], device="cuda") for p in paths)
    split = a2.buckets[0]._split
    assert split is not None
    assert next(split.params[1].parameters()).device == torch.device("cuda", 1)
    assert a2.transcribe(feats) == a1.transcribe(feats)


def test_train_cli_trains_on_two_cards_over_nccl(tmp_path, capfd):
    corpus = str(tmp_path / "corpus")
    make_synthetic_data.generate(corpus, n_train=64, n_dev=32, n_test=8, seed=SEED)
    cfg = _base_las()
    cfg.update(batch_size=16, epochs=1, parallel={"use": True, "data": 2},
               TRN_FOLDER=os.path.join(corpus, "train-clean-100"),
               DEV_FOLDER=os.path.join(corpus, "dev-clean"),
               TST_FOLDER=os.path.join(corpus, "test-clean"),
               EXP_FOLDER=str(tmp_path / "experiments"), MST_FOLDER=str(tmp_path / "mst"))
    path = str(tmp_path / "train-dp.yml")
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    summary = train.main(train.build_argparser().parse_args(["-c", path]))
    said = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[parallel]")]
    assert said == ["[parallel] data-parallel mesh over 2 devices (nccl: one process a rank, "
                    "per-rank batch shards, explicit all_reduce)"]
    losses = summary.train_history["loss"] + summary.dev_history["loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.exists(os.path.join(summary.saving_dir, "log.json"))
    assert os.listdir(os.path.join(summary.saving_dir, "ckpts"))
