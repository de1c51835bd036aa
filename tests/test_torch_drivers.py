"""PyTorch port, the repository's two remaining drivers in the port's
``tools/``: ``fullscale_run`` (its config key by key against the JAX tool's,
and a one-epoch run through the port's ``train`` CLI on the CPU) and
``speller_control`` (each stripped variant's outputs against the JAX tool's
``make_variant`` at toy widths in float32, the FLOP formulas against the JAX
tool's own lines, and a toy run of the whole tool). Neither tool writes a
file unless ``--out`` names one."""

import ast
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.models import las as tlas
from attention_based_e2e_asr_dnn_tpu_torch.tools import fullscale_run as tfull
from attention_based_e2e_asr_dnn_tpu_torch.tools import make_synthetic_data
from attention_based_e2e_asr_dnn_tpu_torch.tools import speller_control as tctl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
TOY = dict(B=4, TE=16, L=6, H1=32, H2=16, PROJ=16, EMB=32, HEADS=2)


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_control(tmp_path_factory):
    """The JAX ``tools/speller_control.py``; importing it turns on JAX's
    persistent compilation cache, which is pointed into a temporary folder
    here and switched back off afterwards."""
    old_dir = jax.config.jax_compilation_cache_dir
    old_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_LAS_COMPILE_CACHE", str(tmp_path_factory.mktemp("jax-cache")))
        mod = _root_tool("speller_control")
    yield mod
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_secs)


@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("epochs", [2, 150])
def test_fullscale_config_is_the_jax_tools(tmp_path, mode, epochs):
    jtool = _root_tool("fullscale_run")
    args = (str(tmp_path / "data"), str(tmp_path / "exp"), epochs, mode, 128, 544, 416)
    want, got = jtool.fullscale_config(*args), tfull.fullscale_config(*args)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert got["device_resident_data"] == (mode == "resident")


def test_fullscale_run_trains_through_the_port_cli(tmp_path, capsys):
    """One epoch at a toy batch on the CPU (``init_force``: the speller on
    the scan loop, the listener's kernels through their plain versions):
    the JSON line's keys, finite numbers, the label cap from the corpus,
    and no file outside the work folder unless ``--out`` asks."""
    data = str(tmp_path / "data")
    make_synthetic_data.generate(data, n_train=8, n_dev=4, n_test=4, words_min=1,
                                 words_max=2, seed=1)
    work = str(tmp_path / "work")
    out = str(tmp_path / "record" / "fullscale.json")
    result = tfull.main(["--data-dir", data, "--epochs", "1", "--batch-size", "4",
                         "--device", "cpu", "--mode", "streamed", "--work-dir", work,
                         "--out", out])
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith('{"mode"')][0])
    for key in ("train_utt_s", "epoch_utt_s_end_to_end", "steady_train_seconds_median",
                "steady_epoch_seconds_median", "best_dev_ld", "chr_max_steps", "card"):
        assert key in line
    assert not any(k.endswith("_history") for k in line)
    assert np.isfinite(result["best_dev_ld"]) and np.isfinite(result["train_loss_history"]).all()
    longest = max(tfull.max_label_chars(data, s) for s in ("train-clean-100", "dev-clean"))
    assert result["chr_max_steps"] == int(np.ceil((longest - 1) / 32) * 32)
    with open(out) as fh:
        assert json.load(fh)["dev_ld_history"] == result["dev_ld_history"]
    assert tfull.build_argparser().parse_args(["--data-dir", "d"]).out is None
    assert tfull.build_argparser().parse_args(["--data-dir", "d"]).device == "cuda"


def _toy_jax(jax_control, monkeypatch):
    for name, value in TOY.items():
        monkeypatch.setattr(jax_control, name, value)
    monkeypatch.setattr(jax_control, "DTYPE", jnp.float32)
    return jax_control.scaled_cfg("scan")


@pytest.mark.parametrize("variant", ["full", "noattn", "cells"])
def test_speller_control_variants_match_jax(jax_control, monkeypatch, variant):
    """Each variant's teacher-forced loop at toy widths in float32 from the
    same parameters and inputs as the JAX tool's ``make_variant``: the
    outputs, and the gradient norm the tool times."""
    jcfg = _toy_jax(jax_control, monkeypatch)
    params = jax.tree.map(np.asarray, jax_control.las_init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    t = TOY
    enc_h = rng.normal(size=(t["B"], t["TE"], 2 * t["H1"])).astype(np.float32)
    enc_l = np.full((t["B"],), t["TE"], np.int32)
    y = rng.integers(0, 30, size=(t["B"], t["L"])).astype(np.int32)
    run = jax_control.make_variant(variant, jax.tree.map(jnp.asarray, params), jcfg)
    want = np.asarray(run(jnp.asarray(enc_h), jnp.asarray(enc_l), jnp.asarray(y)))

    def j_norm(sp):
        out = jax_control.make_variant(variant, {"speller": sp}, jcfg)(
            jnp.asarray(enc_h), jnp.asarray(enc_l), jnp.asarray(y))
        return jnp.sum(out.astype(jnp.float32))

    j_grads = jax.grad(j_norm)(jax.tree.map(jnp.asarray, params["speller"]))
    j_gnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(j_grads))))

    tcfg = tctl.scaled_cfg("scan", t["H1"], t["H2"], t["PROJ"], t["EMB"], t["HEADS"])
    sp = tlas.las_from_jax_params(params)["speller"]
    fn = tctl.make_variant(variant, tcfg, torch.float32)
    got = fn(sp, torch.from_numpy(enc_h), torch.from_numpy(enc_l), torch.from_numpy(y))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    grads = torch.autograd.grad(got.sum(), list(sp.parameters()), allow_unused=True)
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in grads if g is not None)))
    np.testing.assert_allclose(norm, j_gnorm, rtol=1e-5)


def test_speller_control_flops_are_the_jax_formulas():
    """``make_flops`` against the ``cell1`` / ``cell2`` / ``attn`` / ``cls``
    lines of the JAX tool's ``main``, read from its source and evaluated at
    its widths and at toy ones."""
    with open(os.path.join(REPO, "tools", "speller_control.py")) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    lines = {n.targets[0].id: ast.unparse(n.value) for n in ast.walk(main)
             if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
             and n.targets[0].id in ("cell1", "cell2", "attn", "cls")}
    assert set(lines) == {"cell1", "cell2", "attn", "cls"}
    for widths in ({"B": 128, "TE": 192, "L": 192, "H1": 1024, "H2": 256, "PROJ": 256,
                    "EMB": 512, "V": 30}, {**TOY, "V": 30}):
        env = dict(widths)
        for name in ("cell1", "cell2", "attn", "cls"):
            env[name] = eval(lines[name], {}, env)  # noqa: S307 - the JAX tool's own lines
        got = tctl.make_flops(widths["B"], widths["TE"], widths["L"], widths["H1"],
                              widths["H2"], widths["PROJ"], widths["EMB"], widths["V"])
        assert got["full"] == env["cell1"] + env["cell2"] + env["attn"] + env["cls"]
        assert got["noattn"] == env["cell1"] + env["cell2"] + env["cls"]
        assert got["cells"] == env["cell1"] + env["cell2"]
        assert got["attn_only"] == env["attn"] and got["cls"] == env["cls"]
    assert (tctl.B, tctl.TE, tctl.L, tctl.H1, tctl.H2, tctl.PROJ, tctl.EMB, tctl.HEADS) == \
        (128, 192, 192, 1024, 256, 256, 512, 4)


def test_speller_control_runs_at_toy_widths(tmp_path, capsys):
    """The whole tool on the CPU at toy widths (the fused tier through the
    kernels' plain versions): every wall, no MFU without a card's peak, and
    ``--out`` the only file written."""
    toy = dict(batch=4, te=16, steps=6, h1=32, h2=16, proj=16, emb=32, heads=2)
    results = tctl.run("cpu", steps=1, windows=1, widths=toy)
    want = {f"{v}_{k}" for v in tctl.VARIANTS for k in ("fwd", "fwdbwd")}
    want |= {"attn_only_fwd", "cls_batched", "pallas_fwd", "pallas_fwdbwd"}
    assert set(results["walls_ms"]) == want
    assert all(v > 0 for v in results["walls_ms"].values())
    assert results["peak_flops"] is None and set(results["mfu"].values()) == {None}
    assert tctl.build_argparser().parse_args([]).out is None
    assert tctl.build_argparser().parse_args([]).device == "cuda"
