"""PyTorch port, standing alone: every module of the port imports in a
process where ``jax`` and the JAX package cannot be imported, and the port's
own copies of ``constants``, ``config``, ``utils.levenshtein`` and ``compat``
give what the JAX package's originals give."""

import importlib
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import attention_based_e2e_asr_dnn_tpu_torch as port
from attention_based_e2e_asr_dnn_tpu import compat as jcompat
from attention_based_e2e_asr_dnn_tpu import config as jconfig
from attention_based_e2e_asr_dnn_tpu import constants as jconstants
from attention_based_e2e_asr_dnn_tpu_torch import compat, config, constants
from attention_based_e2e_asr_dnn_tpu_torch.utils import levenshtein as lev

# the JAX package's ``utils`` re-exports a function of the same name
jlev = importlib.import_module("attention_based_e2e_asr_dnn_tpu.utils.levenshtein")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PORT_DIR], port.__name__ + "."))


def test_every_module_imports_without_jax():
    """A child process blocks ``jax``, ``jaxlib``, ``optax`` and the JAX
    package in ``sys.modules`` (an import of a blocked name raises), imports
    every module of the port and reports what it loaded."""
    modules = _port_modules()
    assert len(modules) >= 25 and f"{port.__name__}.training.steps" in modules
    assert {f"{port.__name__}.{m}" for m in ("data.lazy", "data.native_loader", "server",
                                             "tools.serve_http", "decoding.select",
                                             "decoding.beam", "decoding.rescore",
                                             "models.rewriter", "lminfer", "dev",
                                             "utils.profiling", "tools.bench",
                                             "tools.profile_step",
                                             "tools.import_reference_ckpt",
                                             "tools.export_serving", "tools.serving_bench",
                                             "tools.full_recipe_run", "tools.chain_refit",
                                             "tools.best_effort_eval", "parallel",
                                             "parallel.mesh", "parallel.multihost",
                                             "parallel.dp", "parallel.split",
                                             "tools.dp_probe", "parallel.grid",
                                             "parallel.sequence", "parallel.pipeline",
                                             "tools.fullscale_run",
                                             "tools.speller_control",
                                             "ops.shards")} <= set(modules)
    code = (
        "import importlib, json, sys\n"
        "for name in ('jax', 'jaxlib', 'optax', 'attention_based_e2e_asr_dnn_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"names = {modules!r}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'attention_based_e2e_asr_dnn_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "print(json.dumps({'imported': len(names), 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report == {"imported": len(modules), "bad": []}


def test_no_source_line_imports_the_jax_package():
    pattern = "attention_based_e2e_asr_dnn_tpu"
    hits = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                stripped = line.strip()
                if not stripped.startswith(("import ", "from ")):
                    continue
                words = stripped.replace(",", " ").split()
                if any(w == "jax" or w.startswith("jax.") or w == pattern
                       or w.startswith(pattern + ".") for w in words):
                    hits.append(f"{path}:{n}: {stripped}")
    assert hits == []


def test_dev_copy_is_the_original():
    """The port's ``dev.py`` is the JAX package's but for its docstring."""
    import ast

    def body(path):
        tree = ast.parse(open(path).read())
        return ast.dump(ast.Module(body=tree.body[1:], type_ignores=[]))

    ours = os.path.join(PORT_DIR, "dev.py")
    ref = os.path.join(REPO, "attention_based_e2e_asr_dnn_tpu", "dev.py")
    assert body(ours) == body(ref)


def test_constants_match():
    for name in ("VOCAB", "VOCAB_MAP", "SOS_IDX", "EOS_IDX", "PAD_IDX", "VOCAB_SIZE"):
        assert getattr(constants, name) == getattr(jconstants, name)
    assert port.VOCAB is constants.VOCAB


@pytest.mark.parametrize("seed", [0, 1])
def test_levenshtein_matches(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 30, (7, 15)).astype(np.int32)
    gold = rng.integers(1, 29, (7, 12)).astype(np.int32)
    lens = rng.integers(1, 13, 7).astype(np.int32)
    assert lev.batch_levenshtein(pred, gold, lens, 0, 29) == \
        jlev.batch_levenshtein(pred, gold, lens, 0, 29)
    for row in pred:
        assert lev.ids_to_str(row, constants.VOCAB, 0, 29) == \
            jlev.ids_to_str(row, jconstants.VOCAB, 0, 29)
        assert lev._trim_ids(row, 0, 29) == jlev._trim_ids(row, 0, 29)
    a, b = list(pred[0]), list(gold[0])
    assert lev.levenshtein(a, b) == jlev.levenshtein(a, b)
    assert lev.levenshtein([], b) == len(b)


def test_load_config_matches(tmp_path):
    text = ("exp_folder: exps/a\nmax_len_factor: 0\nmodel:\n  tag: base-LAS\n  configs:\n"
            "    listener_configs: {input_dim: 15, uniform_hid_dim: 512}\n"
            "trainer:\n  epochs: 3\n  optimizer_configs: {lr: 0.001}\n")
    yml = tmp_path / "c.yml"
    yml.write_text(text)
    ours, ref = config.load_config(str(yml)), jconfig.load_config(str(yml))
    assert ours.to_dict() == ref.to_dict()
    assert ours.model.tag == "base-LAS" and isinstance(ours.model.configs, dict)
    assert ours.trainer.epochs == 3 and ours.trainer.optimizer_configs == {"lr": 0.001}
    assert "model" in ours and ours.get("nope", 5) == 5
    assert config.cfg_float(ours, "max_len_factor", 1.5) == \
        jconfig.cfg_float(ref, "max_len_factor", 1.5) == 0.0
    assert config.cfg_float(ours, "absent", 1.5) == 1.5
    snap = config.snapshot_config(ours.to_dict(), str(tmp_path / "exp"))
    assert config.load_config(snap).to_dict() == json.loads(open(snap).read())
    injected = config.inject_vocab({"model": {"configs": {}}}, constants.VOCAB,
                                   constants.VOCAB_MAP)
    assert injected == jconfig.inject_vocab({"model": {"configs": {}}}, jconstants.VOCAB,
                                            jconstants.VOCAB_MAP)


def _reference_state_dict(seed=0):
    """A reference-named LAS state_dict from torch modules (1 base BiLSTM,
    2 pyramid BiLSTMs, tied embedding and classifier)."""
    torch.manual_seed(seed)
    sd = {}

    def put(prefix, module):
        sd.update({f"{prefix}.{k}": v.detach() for k, v in module.state_dict().items()})

    put("listen.base.lstms.0", torch.nn.LSTM(5, 8, bidirectional=True))
    for i in range(2):
        put(f"listen.pyramid.plstms.{i}", torch.nn.LSTM(32, 8, bidirectional=True))
    for name, (i, o) in {"key_map": (16, 6), "value_map": (16, 6), "query_map": (4, 6),
                         "final_map": (6, 6)}.items():
        put(f"spell.attention.{name}", torch.nn.Linear(i, o))
    emb = torch.nn.Embedding(30, 12)
    put("spell.char_emb", emb)
    put("spell.lstms.lstms.0", torch.nn.LSTMCell(18, 10))
    put("spell.lstms.lstms.1", torch.nn.LSTMCell(10, 4))
    sd["spell.init_query"] = torch.rand(1, 4)
    sd["spell.cls.weight"] = emb.weight.detach()
    sd["spell.cls.bias"] = torch.randn(30)
    return sd


def test_params_from_state_dict_matches(tmp_path):
    import jax

    sd = _reference_state_dict()
    ours, family = compat.params_from_state_dict(sd)
    ref, ref_family = jcompat.params_from_state_dict(sd)
    assert family == ref_family == "las"
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # the strict leftover check and the tied-classifier check came along
    with pytest.raises(KeyError, match="unrecognised state_dict keys"):
        compat.las_params_from_state_dict({**sd, "spell.extra.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="not tied"):
        compat.las_params_from_state_dict({**sd, "spell.cls.weight": torch.zeros(30, 12)})
    with pytest.raises(ValueError, match="neither reference family"):
        compat.params_from_state_dict({"foo": torch.zeros(1)})
    # a .pt file on disk, through the port's checkpoint loader
    from attention_based_e2e_asr_dnn_tpu_torch.training.checkpoints import load_checkpoint

    path = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": sd, "epoch": 4}, path)
    loaded, meta = compat.load_torch_state_dict(path, return_meta=True)
    assert meta == {"epoch": 4} and set(loaded) == set(sd)
    payload = load_checkpoint(path)
    assert payload["torch_import"] == "las" and payload["epoch"] == 4
    for a, b in zip(jax.tree.leaves(payload["params"]), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
