"""PyTorch port, the launch plan of the bfloat16 fused speller decode
(``ops/speller_cuda.py::plan_decode_tc``): which cooperative launches a call
takes on a card of a given number of SMs, the columns each block owns in
each product, the ring's stages and the shared memory a block needs; and
which source each dtype takes. Pure Python: no card, no kernel."""

import itertools

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda

SMS = 132  # an H100's
SMEM_LIMIT = 232448  # the shared memory a block may use on it
# (P, heads, H1, H2): base-LAS, scaled-LAS and the card tests' widths
WIDTHS = {"base-LAS": (256, 1, 512, 256), "scaled-LAS": (256, 4, 1024, 256),
          "card tests, 1 head": (64, 1, 128, 64), "card tests, 2 heads": (64, 2, 128, 64)}


def _plan(batch, width="base-LAS", te=192, vp=32, sms=SMS, smem_optin=SMEM_LIMIT):
    proj, heads, h1, h2 = WIDTHS[width] if isinstance(width, str) else width
    return speller_cuda.plan_decode_tc(batch, te, proj, heads, h1, h2, vp, sms, smem_optin)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("batch", [1, 64, 128])
def test_one_launch_up_to_128_rows(width, batch):
    plan = _plan(batch, width)
    assert [(ln.r0, ln.r1) for ln in plan.launches] == [(0, batch)]


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("batch,spans", [(130, [(0, 128), (128, 130)]),
                                         (256, [(0, 128), (128, 256)])])
def test_past_128_rows_a_launch_a_span(width, batch, spans):
    plan = _plan(batch, width)
    assert [(ln.r0, ln.r1) for ln in plan.launches] == spans


@pytest.mark.parametrize("batch", [1, 5, 63, 64, 65, 127, 128, 129, 300, 513])
def test_every_row_is_in_one_launch(batch):
    plan = _plan(batch)
    rows = [r for ln in plan.launches for r in range(ln.r0, ln.r1)]
    assert rows == list(range(batch))
    assert all(ln.r1 - ln.r0 <= 128 for ln in plan.launches)


@pytest.mark.parametrize("width,blocks,units1,query_blocks", [
    ("base-LAS", 128, 4, 32), ("scaled-LAS", 128, 8, 32),
    ("card tests, 1 head", 32, 4, 8), ("card tests, 2 heads", 32, 4, 8)])
def test_blocks_and_columns_of_each_phase(width, blocks, units1, query_blocks):
    plan = _plan(64, width)
    assert (plan.blocks, plan.units1, plan.units2, plan.query_blocks) == (
        blocks, units1, 2, query_blocks)
    assert plan.cols == {"cell1": 4 * units1, "cell2": 8, "query": 8}
    # wgmma's N: a multiple of 8 in every product
    assert all(n % 8 == 0 and 8 <= n <= 256 for n in plan.cols.values())
    # the blocks cover both cells' units and the query's columns exactly once
    proj, _, h1, h2 = WIDTHS[width]
    assert plan.blocks * plan.units1 == h1 and plan.blocks * plan.units2 == h2
    assert plan.query_blocks * plan.cols["query"] == proj <= plan.blocks * 8
    assert plan.blocks <= SMS


@pytest.mark.parametrize("width,te,batch", itertools.product(
    list(WIDTHS), (192, 896), (1, 64, 128, 130)))
def test_shared_memory_fits(width, te, batch):
    plan = _plan(batch, width, te=te)
    for ln in plan.launches:
        assert ln.smem <= SMEM_LIMIT
        assert 4 <= ln.stages <= 8


def test_shared_memory_bytes():
    align, bars = 1024, 128
    # base-LAS, 64 rows: cell 1 (512 + 256 + 64) / 64 = 13 tiles of 16
    # columns, cell 2 12 tiles of 8, the query 4 tiles of 8; the gate tile
    # 128 x 24 fp32; the attention's buffers (2 x 256 + 8 x 32 + 256 x 8 +
    # 192 floats); the ring's eight 64-row stages
    weights = 13 * 16 * 128 + 12 * 8 * 128 + 4 * 8 * 128
    att = (2 * 256 + 8 * 32 + 256 * 8 + 192) * 4
    smem, stages = speller_cuda.decode_tc_smem_bytes(64, 192, 256, 1, 512, 256)
    assert (smem, stages) == (align + weights + 128 * 24 * 4 + att + bars + 8 * 64 * 128, 8)
    # scaled-LAS, 128 rows, Te = 896, 4 heads: 21 tiles of 32 columns; the
    # ring what is left of the limit in 128-row stages
    weights = 21 * 32 * 128 + 20 * 8 * 128 + 4 * 8 * 128
    att = (2 * 256 + 8 * 32 + 256 * 8 + 4 * 896) * 4
    fixed = align + weights + 128 * 40 * 4 + att + bars
    smem, stages = speller_cuda.decode_tc_smem_bytes(128, 896, 256, 4, 1024, 256)
    assert stages == (SMEM_LIMIT - fixed) // (128 * 128) == 4
    assert smem == fixed + 4 * 128 * 128


@pytest.mark.parametrize("shape,match", [
    ((64, 192, 256, 1, 512, 256, 32, SMS, SMEM_LIMIT), None),
    ((0, 192, 256, 1, 512, 256, 32, SMS, SMEM_LIMIT), "batch 0"),
    ((8, 192, 256, 1, 480, 256, 32, SMS, SMEM_LIMIT), "multiples of 64"),
    ((8, 192, 96, 1, 512, 256, 32, SMS, SMEM_LIMIT), "multiples of 64"),
    ((8, 192, 256, 1, 1024, 512, 32, SMS, SMEM_LIMIT), "H2 512 above 256"),
    ((8, 192, 256, 1, 512, 256, 32, 100, SMEM_LIMIT), "H2 256 above 200"),
    ((8, 192, 256, 1, 2048, 256, 32, SMS, SMEM_LIMIT), r"H1 / \(H2 / 2\) = 2048 / 128"),
    ((8, 192, 256, 1, 64, 128, 32, SMS, SMEM_LIMIT), r"H1 / \(H2 / 2\) = 64 / 64"),
    ((8, 192, 1024, 1, 256, 128, 32, SMS, SMEM_LIMIT), "P 1024 above 8 x 64"),
    ((8, 192, 256, 3, 512, 256, 32, SMS, SMEM_LIMIT), "head width"),
    ((8, 192, 256, 64, 512, 256, 32, SMS, SMEM_LIMIT), "head width"),
    ((8, 192, 256, 1, 512, 256, 40, SMS, SMEM_LIMIT), "padded vocabulary 40"),
    ((8, 40000, 256, 1, 512, 256, 32, SMS, SMEM_LIMIT), "device's limit"),
    ((8, 192, 256, 1, 512, 256, 32, SMS, 100000), "device's limit is 100000"),
])
def test_refused_shapes_raise(shape, match):
    if match is None:
        speller_cuda.plan_decode_tc(*shape)
        return
    with pytest.raises(ValueError, match=match):
        speller_cuda.plan_decode_tc(*shape)


def test_limits_mirror_the_source():
    """The plan's constants are the source's (the card test reads them from
    the built library; here from the source's text)."""
    with open(speller_cuda.TC_SOURCE) as fh:
        text = fh.read()
    for key, name in (("rows", "DT_ROWS"), ("max_grid", "DT_MAX_GRID"),
                      ("units2", "DT_UNITS2"), ("kc", "DT_KC"), ("sel", "DT_SEL"),
                      ("qcols", "DT_QCOLS"), ("vmax", "DT_VMAX"),
                      ("max_stages", "DT_MAX_STAGES"), ("min_stages", "DT_MIN_STAGES")):
        assert f"constexpr int {name} = {speller_cuda.TC_LIMITS[key]};" in text, name
    for units in speller_cuda.TC_UNITS1:
        assert f"dt_launch<true, {units}>" in text and f"dt_launch<false, {units}>" in text


# the decode's operands at the card tests' widths, on the CPU (no card: the
# routing is read, never launched)
def _operands(dtype, batch=2, te=8, proj=64, h1=128, h2=64, vp=32):
    shapes = [(batch, te, proj), (batch, te, proj), (batch, te), (batch, proj),
              (batch, h1), (batch, h1), (batch, h2), (batch, h2), (vp, 4 * h1),
              (proj, 4 * h1), (h1, 4 * h1), (h1, 4 * h2), (h2, 4 * h2), (4 * h2,),
              (h2, proj), (proj,), (2 * proj, vp), (vp,)]
    return [torch.zeros(s, dtype=dtype) for s in shapes]


class _Routed(Exception):
    pass


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "_launch_tc"),
                                         (torch.float32, "kernel_limits")])
def test_bf16_takes_the_tensor_core_source_and_fp32_the_old_one(monkeypatch, dtype, route,
                                                                train):
    """Past the operand checks, bfloat16 goes to ``_launch_tc`` (the new
    source) and float32 to the float32 source's limits and launch; nothing
    is launched here (the operands pass as CUDA tensors)."""
    def routed(*args, **kwargs):
        raise _Routed(route)

    monkeypatch.setattr(speller_cuda, route, routed)
    monkeypatch.setattr(speller_cuda, "_check_operands", lambda *args: None)
    ops = _operands(dtype)
    opts = {"heads": 1, "scale": 0.125, "sos_idx": 0, "steps": 3}
    with pytest.raises(_Routed, match=route):
        speller_cuda._launch(*ops, opts["heads"], opts["scale"], opts["sos_idx"],
                             opts["steps"], None, train=train)


def test_sources_are_built_and_bound():
    """``build_all`` builds every source of the module and binds each one's
    library: the new source among them."""
    assert speller_cuda.TC_SOURCE in speller_cuda.SOURCES
    assert speller_cuda.TC_SOURCE.endswith("csrc/speller_decode_tc.cu")
    assert speller_cuda.load_tc_library in speller_cuda.LOADERS
    assert len(speller_cuda.LOADERS) == len(speller_cuda.SOURCES)
