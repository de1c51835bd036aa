"""PyTorch port, the launch plans of the bfloat16 fused speller decode
(``ops/speller_cuda.py::plan_decode_tc``) and of its adjoint
(``plan_decode_bwd_tc``), and of the float32 forward (``plan_decode_f32``)
and adjoint (``plan_decode_bwd_f32``): which cooperative launches a call
takes on a card of a given number of SMs, the columns each block owns in each
product, the ring's stages and the shared memory a block needs; and which
source each dtype takes. Pure Python: no card, no kernel."""

import itertools

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import speller_cuda

SMS = 132  # an H100's
SMEM_LIMIT = 232448  # the shared memory a block may use on it
# (P, heads, H1, H2): base-LAS, scaled-LAS and the card tests' widths
WIDTHS = {"base-LAS": (256, 1, 512, 256), "scaled-LAS": (256, 4, 1024, 256),
          "card tests, 1 head": (64, 1, 128, 64), "card tests, 2 heads": (64, 2, 128, 64)}
# model blocks the reference's fused decoder takes that the narrower
# geometry (2 cell-2 units a block, H1 / (H2 / 2) cell-1 units) refused, each
# on base-LAS's other widths (P 256, 1 head, H1 512, H2 256)
WIDENED = {"dec_lstm_out_dim 512": (256, 1, 512, 512),
           "dec_lstm_hid_dim 128, dec_lstm_out_dim 256": (256, 1, 128, 256),
           "dec_lstm_hid_dim 1024, dec_lstm_out_dim 128": (256, 1, 1024, 128),
           "att_proj_dim 1024, dec_lstm_out_dim 128": (1024, 1, 512, 128)}


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


@pytest.mark.parametrize("width,blocks,units1,units2,query_blocks", [
    ("base-LAS", 128, 4, 2, 32), ("scaled-LAS", 128, 8, 2, 32),
    ("card tests, 1 head", 64, 2, 1, 8), ("card tests, 2 heads", 64, 2, 1, 8),
    ("dec_lstm_out_dim 512", 128, 4, 4, 32),
    ("dec_lstm_hid_dim 128, dec_lstm_out_dim 256", 128, 1, 2, 32),
    ("dec_lstm_hid_dim 1024, dec_lstm_out_dim 128", 128, 8, 1, 32),
    ("att_proj_dim 1024, dec_lstm_out_dim 128", 128, 4, 1, 128)])
def test_blocks_and_columns_of_each_phase(width, blocks, units1, units2, query_blocks):
    proj, heads, h1, h2 = {**WIDTHS, **WIDENED}[width]
    plan = _plan(64, (proj, heads, h1, h2))
    assert (plan.blocks, plan.units1, plan.units2, plan.query_blocks) == (
        blocks, units1, units2, query_blocks)
    # four gate columns a unit, rounded up to wgmma's multiple of 8
    assert plan.cols == {"cell1": 8 * ((units1 + 1) // 2), "cell2": 8 * ((units2 + 1) // 2),
                         "query": 8}
    assert all(n % 8 == 0 and 8 <= n <= 256 for n in plan.cols.values())
    # the blocks cover both cells' units and the query's columns exactly once
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
    smem, stages = speller_cuda.decode_tc_smem_bytes(64, 192, 256, 1, 512, 256, 128)
    assert (smem, stages) == (align + weights + 128 * 24 * 4 + att + bars + 8 * 64 * 128, 8)
    # scaled-LAS, 128 rows, Te = 896, 4 heads: 21 tiles of 32 columns; the
    # ring what is left of the limit in 128-row stages
    weights = 21 * 32 * 128 + 20 * 8 * 128 + 4 * 8 * 128
    att = (2 * 256 + 8 * 32 + 256 * 8 + 4 * 896) * 4
    fixed = align + weights + 128 * 40 * 4 + att + bars
    smem, stages = speller_cuda.decode_tc_smem_bytes(128, 896, 256, 4, 1024, 256, 128)
    assert stages == (SMEM_LIMIT - fixed) // (128 * 128) == 4
    assert smem == fixed + 4 * 128 * 128
    # H1 128, H2 512 (1 and 4 units a block): cell 1 N 8 (4 zero columns),
    # cell 2 N 16, the gate tile as wide as cell 2's
    weights = 7 * 8 * 128 + 10 * 16 * 128 + 8 * 8 * 128
    att = (2 * 256 + 8 * 32 + 256 * 8 + 192) * 4
    smem, stages = speller_cuda.decode_tc_smem_bytes(64, 192, 256, 1, 128, 512, 128)
    assert (smem, stages) == (align + weights + 128 * 24 * 4 + att + bars + 8 * 64 * 128, 8)


@pytest.mark.parametrize("shape,match", [
    ((64, 192, 256, 1, 512, 256, 32, SMS, SMEM_LIMIT), None),
    ((0, 192, 256, 1, 512, 256, 32, SMS, SMEM_LIMIT), "batch 0"),
    ((8, 192, 256, 1, 480, 256, 32, SMS, SMEM_LIMIT), "multiples of 64"),
    ((8, 192, 96, 1, 512, 256, 32, SMS, SMEM_LIMIT), "multiples of 64"),
    # the narrower geometry refused these five; the widened one takes four
    ((8, 192, 256, 1, 1024, 512, 32, SMS, SMEM_LIMIT), None),
    ((8, 192, 256, 1, 512, 256, 32, 100, SMEM_LIMIT), None),
    ((8, 192, 256, 1, 2048, 256, 32, SMS, SMEM_LIMIT), "H1 2048 above 1024"),
    ((8, 192, 256, 1, 64, 128, 32, SMS, SMEM_LIMIT), None),
    ((8, 192, 1024, 1, 256, 128, 32, SMS, SMEM_LIMIT), None),
    ((8, 192, 256, 3, 512, 256, 32, SMS, SMEM_LIMIT), "head width"),
    ((8, 192, 256, 64, 512, 256, 32, SMS, SMEM_LIMIT), "head width"),
    ((8, 192, 256, 1, 512, 256, 40, SMS, SMEM_LIMIT), "padded vocabulary 40"),
    ((8, 40000, 256, 1, 512, 256, 32, SMS, SMEM_LIMIT), "device's limit"),
    ((8, 192, 256, 1, 512, 256, 32, SMS, 100000), "device's limit is 100000"),
    # the widened geometry's limits: at most 8 cell-1 and 4 cell-2 units a
    # block, 8 query columns a block, the shared memory (H1 1024 with H2 512
    # and P 1024: the resident weight tiles leave no room for four stages
    # even of 64 rows, so cell 1's weights stream through the ring; H1 1024,
    # H2 512, P 256 at 128 rows takes 64-row spans)
    ((8, 192, 256, 1, 512, 1024, 32, SMS, SMEM_LIMIT), "H2 1024 above 512"),
    ((8, 192, 256, 1, 512, 512, 32, 100, SMEM_LIMIT), "H2 512 above 256"),
    ((8, 192, 1024, 1, 256, 128, 32, 100, SMEM_LIMIT), "P 1024 above 8 x 64"),
    ((128, 192, 1024, 1, 1024, 512, 32, SMS, SMEM_LIMIT), None),
    # a block wider than the kernel takes in any form, and one whose
    # attention buffers leave no room even for the streamed form's stages
    ((8, 192, 256, 1, 512, 640, 32, SMS, SMEM_LIMIT), "H2 640 above 512"),
    ((128, 40000, 1024, 1, 1024, 512, 32, SMS, SMEM_LIMIT), "needs .* device's limit"),
])
def test_refused_shapes_raise(shape, match):
    if match is None:
        speller_cuda.plan_decode_tc(*shape)
        return
    with pytest.raises(ValueError, match=match):
        speller_cuda.plan_decode_tc(*shape)


def _span_classes():
    """The decoder blocks of multiples of 128 the reference takes (H1 up to
    1024, H2 up to 512, P up to 1024; 1 or 4 heads) at Te 192 whose resident
    weight tiles leave too little room for the ring's stages of 128 rows:
    those that fit four stages of 64 rows, and those whose resident tiles fit
    at no batch (the streamed form takes them)."""
    fit64, never = [], []
    for h1, h2, proj, heads in itertools.product(range(128, 1025, 128), range(128, 513, 128),
                                                 range(128, 1025, 128), (1, 4)):
        blocks = speller_cuda.tc_blocks(h1, h2, SMS)
        at = {rows: speller_cuda.decode_tc_smem_bytes(rows, 192, proj, heads, h1, h2, blocks)
              for rows in (128, 64)}
        if at[128][1] >= 4 and at[128][0] <= SMEM_LIMIT:
            continue
        (fit64 if at[64][1] >= 4 else never).append((proj, heads, h1, h2))
    return fit64, never


FIT_64_ROWS, NEVER_FIT = _span_classes()


def test_span_classes_are_counted():
    assert (len(FIT_64_ROWS), len(NEVER_FIT)) == (61, 26)
    assert {(1024, 1, 768, 384), (512, 1, 1024, 512), (1024, 1, 1024, 256)} <= set(FIT_64_ROWS)
    assert {(1024, 1, 1024, 512), (768, 1, 896, 512), (640, 4, 1024, 384)} <= set(NEVER_FIT)


@pytest.mark.parametrize("width", FIT_64_ROWS, ids=str)
def test_wide_blocks_take_64_row_spans(width):
    """Where a 128-row span does not fit the ring's four stages, the batch
    goes in 64-row spans, each its own launch; narrower blocks keep 128."""
    plan = _plan(128, width)
    assert [(ln.r0, ln.r1) for ln in plan.launches] == [(0, 64), (64, 128)]
    assert all(ln.stages >= 4 and ln.smem <= SMEM_LIMIT for ln in plan.launches)
    assert [(ln.r0, ln.r1) for ln in _plan(130, width).launches] == \
        [(0, 64), (64, 128), (128, 130)]
    assert [(ln.r0, ln.r1) for ln in _plan(64, width).launches] == [(0, 64)]


@pytest.mark.parametrize("width", NEVER_FIT, ids=str)
def test_blocks_too_wide_for_any_span_raise(width):
    """The resident weight tiles with the fixed buffers leave no room for
    four stages even of 64 rows: cell 1's weights stream through the ring,
    whose stages then fit a 128-row span, at every batch (each of these
    blocks raised the shared-memory ValueError before the streamed form)."""
    for batch, spans in ((32, [(0, 32)]), (64, [(0, 64)]), (128, [(0, 128)]),
                         (130, [(0, 128), (128, 130)])):
        plan = _plan(batch, width)
        assert plan.streamed
        assert [(ln.r0, ln.r1) for ln in plan.launches] == spans
        assert all(4 <= ln.stages <= 8 and ln.smem <= SMEM_LIMIT for ln in plan.launches)
        assert (plan.cols["cell1"] // 8, plan.cols["cell2"] // 8) in speller_cuda.STREAM_NC


def test_blocks_that_fit_resident_keep_their_form():
    """Every block of the reference's range whose resident tiles fit keeps
    the resident form at every batch; the streamed form only where they do
    not, and its 128-row stages leave the ring 6 to 8 stages."""
    for h1, h2, proj, heads in itertools.product(range(128, 1025, 128), range(128, 513, 128),
                                                 range(128, 1025, 128), (1, 4)):
        for batch in (64, 128):
            plan = _plan(batch, (proj, heads, h1, h2))
            assert plan.streamed == ((proj, heads, h1, h2) in NEVER_FIT)
            if plan.streamed and batch == 128:
                assert 6 <= plan.launches[0].stages <= 8


def test_streamed_shared_memory_bytes():
    """H1 1024, H2 512, P 1024, 4 heads, 128 rows: no cell-1 tile; cell 2
    24 tiles of 16 columns, the query 8 of 8; the gate tile 128 x 40 fp32;
    each stage 128 x 64 inputs and 32 x 64 weights of bf16."""
    align, bars = 1024, 128
    weights = 24 * 16 * 128 + 8 * 8 * 128
    att = (2 * 1024 + 8 * 32 + 256 * 8 + 4 * 192) * 4
    fixed = align + weights + 128 * 40 * 4 + att + bars
    stage = 128 * 128 + 32 * 128
    smem, stages = speller_cuda.decode_tc_smem_bytes(128, 192, 1024, 4, 1024, 512, 128, True)
    assert stages == (SMEM_LIMIT - fixed) // stage == 6
    assert smem == fixed + 6 * stage
    resident = speller_cuda.decode_tc_smem_bytes(128, 192, 1024, 4, 1024, 512, 128)
    assert resident[1] == 0  # the cell-1 tile alone: 33 x 32 x 128 bytes


def test_stream_weights_hold_the_resident_tiles_columns():
    """Row g N1 + n of the streamed weights is block g's product column n
    over [h1; ctx; one-hot] (``put`` in the source: gate n % 4 of unit n //
    4), zeros for a unit slot past U1 and for the one-hot's rows past Vp."""
    gen = torch.Generator().manual_seed(0)
    h1, proj, vp, blocks = 192, 64, 5, 64  # U1 = 3: N1 = 16, slot 3 empty
    whh1, wc1, embw1 = (torch.randn(r, 4 * h1, generator=gen) for r in (h1, proj, vp))
    w = speller_cuda.stream_weights(whh1, wc1, embw1, blocks)
    assert w.shape == (blocks * 16, h1 + proj + 64) and w.is_contiguous()
    full = torch.cat([whh1, wc1, embw1])
    for g in (0, 17, blocks - 1):
        for n in range(16):
            row = w[g * 16 + n]
            unit, gate = n // 4, n % 4
            if unit >= 3:
                assert not row.any()
                continue
            col = gate * h1 + g * 3 + unit
            assert torch.equal(row[: h1 + proj + vp], full[:, col])
            assert not row[h1 + proj + vp:].any()


def test_limits_mirror_the_source():
    """The plan's constants are the source's (the card test reads them from
    the built library; here from the source's text)."""
    with open(speller_cuda.TC_SOURCE) as fh:
        text = fh.read()
    for key, name in (("rows", "DT_ROWS"), ("max_grid", "DT_MAX_GRID"),
                      ("max_units1", "DT_MAX_UNITS1"), ("max_units2", "DT_MAX_UNITS2"),
                      ("kc", "DT_KC"), ("sel", "DT_SEL"),
                      ("qcols", "DT_QCOLS"), ("vmax", "DT_VMAX"),
                      ("max_stages", "DT_MAX_STAGES"), ("min_stages", "DT_MIN_STAGES")):
        assert f"constexpr int {name} = {speller_cuda.TC_LIMITS[key]};" in text, name
    # an instantiation for every (N1 / 8, N2 / 8) the unit limits reach
    lim = speller_cuda.TC_LIMITS
    for nc1 in range(1, (lim["max_units1"] + 1) // 2 + 1):
        for nc2 in range(1, (lim["max_units2"] + 1) // 2 + 1):
            assert f"DT_CASE(TR, {nc1}, {nc2})" in text, (nc1, nc2)
    # and for the pairs the streamed form serves
    for nc1, nc2 in speller_cuda.STREAM_NC:
        assert f"DT_SCASE(TR, {nc1}, {nc2})" in text, (nc1, nc2)


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


# -- the bfloat16 adjoint (csrc/speller_bwd_tc.cu, plan_decode_bwd_tc) -------

def _bwd_plan(batch, width="base-LAS", te=192, sms=SMS, smem_optin=SMEM_LIMIT):
    proj, heads, h1, h2 = {**WIDTHS, **WIDENED}[width] if isinstance(width, str) else width
    return speller_cuda.plan_decode_bwd_tc(batch, te, proj, heads, h1, h2, sms, smem_optin)


@pytest.mark.parametrize("width,max_groups,phase_blocks,phase_cols", [
    # base-LAS: 64 + 32 + 32 groups, one a block
    ("base-LAS", 1, {"b": 32, "c": 96, "d": 96}, {"b": 8, "c": 8, "d": 8}),
    # scaled-LAS: 128 + 32 + 32 groups; blocks 0-31 also own a cell-2 group,
    # 32-63 a context group
    ("scaled-LAS", 2, {"b": 32, "c": 128, "d": 128}, {"b": 8, "c": 16, "d": 16}),
    ("card tests, 2 heads", 1, {"b": 8, "c": 24, "d": 24}, {"b": 8, "c": 8, "d": 8}),
    ("dec_lstm_out_dim 512", 2, {"b": 64, "c": 128, "d": 64}, {"b": 8, "c": 8, "d": 16}),
    ("dec_lstm_hid_dim 128, dec_lstm_out_dim 256", 1, {"b": 32, "c": 48, "d": 48},
     {"b": 8, "c": 8, "d": 8}),
    ("dec_lstm_hid_dim 1024, dec_lstm_out_dim 128", 2, {"b": 16, "c": 128, "d": 128},
     {"b": 8, "c": 16, "d": 16}),
    ("att_proj_dim 1024, dec_lstm_out_dim 128", 2, {"b": 16, "c": 80, "d": 128},
     {"b": 8, "c": 8, "d": 16})])
def test_bwd_blocks_and_columns_of_each_phase(width, max_groups, phase_blocks, phase_cols):
    plan = _bwd_plan(128, width)
    assert plan.blocks == 128 and plan.max_groups == max_groups
    assert plan.phase_blocks == phase_blocks and plan.phase_cols == phase_cols
    # every unit of each cell and every context column in exactly one
    # group of 8, every group on one block, at most 4 a block (N <= 32)
    proj, _, h1, h2 = {**WIDTHS, **WIDENED}[width]
    owned = sorted(g for groups in plan.groups for g in groups)
    assert owned == sorted([("cell1", u) for u in range(0, h1, 8)]
                           + [("cell2", u) for u in range(0, h2, 8)]
                           + [("ctx", p) for p in range(0, proj, 8)])
    assert all(len(g) <= 4 for g in plan.groups) and len(plan.groups) == plan.blocks


def test_bwd_groups_go_round_robin():
    groups = speller_cuda.bwd_tc_groups(1024, 256, 256, 128)
    assert groups[0] == [("cell1", 0), ("cell2", 0)]
    assert groups[31] == [("cell1", 248), ("cell2", 248)]
    assert groups[32] == [("cell1", 256), ("ctx", 0)]
    assert groups[127] == [("cell1", 1016)]


@pytest.mark.parametrize("batch,spans", [(1, [(0, 1)]), (128, [(0, 128)]),
                                         (200, [(0, 128), (128, 200)])])
def test_bwd_a_launch_a_128_row_span(batch, spans):
    plan = _bwd_plan(batch)
    assert [(ln.r0, ln.r1) for ln in plan.launches] == spans


def test_bwd_shared_memory_bytes():
    align, bars = 1024, 128
    # base-LAS, 128 rows, one group a block: the product tile 128 x (8 + 8)
    # fp32; d_ctx, the group sums (256 x 8) and dw (1 x 192) fp32; the ring's
    # eight stages of a 128-row input box and 8 weight rows, 64 k each
    fixed = align + 128 * 16 * 4 + (256 + 256 * 8 + 192) * 4 + bars
    smem, stages = speller_cuda.decode_bwd_tc_smem_bytes(128, 192, 256, 1, 1)
    assert (smem, stages) == (fixed + 8 * (128 * 128 + 8 * 128), 8)
    # scaled-LAS, 32 rows (a 64-row box), two groups, 4 heads
    fixed = align + 128 * 24 * 4 + (256 + 256 * 8 + 4 * 192) * 4 + bars
    smem, stages = speller_cuda.decode_bwd_tc_smem_bytes(32, 192, 256, 4, 2)
    assert (smem, stages) == (fixed + 8 * (64 * 128 + 16 * 128), 8)
    # a long encoder: the ring takes what is left
    smem, stages = speller_cuda.decode_bwd_tc_smem_bytes(128, 20000, 256, 2, 2)
    fixed = align + 128 * 24 * 4 + (256 + 256 * 8 + 2 * 20000) * 4 + bars
    assert stages == (SMEM_LIMIT - fixed) // (128 * 128 + 16 * 128) == 2
    assert smem == fixed + 2 * (128 * 128 + 16 * 128) <= SMEM_LIMIT


@pytest.mark.parametrize("shape,match", [
    ((64, 192, 256, 1, 512, 256, SMS, SMEM_LIMIT), None),
    ((0, 192, 256, 1, 512, 256, SMS, SMEM_LIMIT), "batch 0"),
    ((8, 192, 256, 1, 480, 256, SMS, SMEM_LIMIT), "multiples of 64"),
    ((8, 192, 96, 1, 512, 256, SMS, SMEM_LIMIT), "multiples of 64"),
    ((8, 192, 1024, 1, 2048, 1088, SMS, SMEM_LIMIT), r"H1 \+ H2 \+ P = 4160 above 4096"),
    ((8, 192, 1024, 1, 1024, 512, 64, SMEM_LIMIT), r"H1 \+ H2 \+ P = 2560 above 2048"),
    ((8, 192, 256, 3, 512, 256, SMS, SMEM_LIMIT), "head width"),
    ((8, 192, 2112, 1, 64, 64, SMS, SMEM_LIMIT), "P 2112 above 2048"),
    ((8, 60000, 256, 1, 512, 256, SMS, SMEM_LIMIT), "device's limit"),
    ((8, 192, 256, 1, 512, 256, SMS, 40000), "device's limit is 40000"),
])
def test_bwd_refused_shapes_raise(shape, match):
    if match is None:
        speller_cuda.plan_decode_bwd_tc(*shape)
        return
    with pytest.raises(ValueError, match=match):
        speller_cuda.plan_decode_bwd_tc(*shape)


@pytest.mark.parametrize("batch", [64, 128])
@pytest.mark.parametrize("heads", [1, 4])
def test_bwd_plan_takes_every_shape_the_forward_takes(batch, heads):
    """Over the multiples of 128 the reference takes (H1 128..1024, H2
    128..512, P 128..1024): wherever the widened bf16 forward plans a call,
    the bf16 adjoint plans it too; where the forward refuses, only for its
    shared memory."""
    taken = 0
    for h1, h2, proj in itertools.product(range(128, 1025, 128), range(128, 513, 128),
                                          (128, 256, 512, 1024)):
        shape = (batch, 192, proj, heads, h1, h2)
        try:
            speller_cuda.plan_decode_tc(*shape, 32, SMS, SMEM_LIMIT)
        except ValueError as exc:
            assert "shared memory" in str(exc), (shape, str(exc))
            continue
        plan = speller_cuda.plan_decode_bwd_tc(*shape, SMS, SMEM_LIMIT)
        assert all(ln.smem <= SMEM_LIMIT for ln in plan.launches)
        taken += 1
    assert taken >= 96  # most of the 128 shapes


def test_bwd_limits_mirror_the_source():
    """The adjoint plan's constants are the source's (the card test reads
    them from the built library; here from the source's text)."""
    with open(speller_cuda.BWD_TC_SOURCE) as fh:
        text = fh.read()
    for key, name in (("rows", "DB_ROWS"), ("max_grid", "DB_MAX_GRID"), ("kc", "DB_KC"),
                      ("gcols", "DB_GCOLS"), ("max_groups", "DB_MAX_GROUPS"),
                      ("max_stages", "DB_MAX_STAGES"), ("min_stages", "DB_MIN_STAGES")):
        assert f"constexpr int {name} = {speller_cuda.BWD_TC_LIMITS[key]};" in text, name
    assert "grid.sync" not in text and "cooperative_groups" not in text


def _bwd_operands(dtype, batch=2, te=8, proj=64, h1=128, h2=64, steps=3, heads=1):
    shapes = [(batch, te, proj), (batch, te, proj), (proj, 4 * h1), (h1, 4 * h1),
              (h1, 4 * h2), (h2, 4 * h2), (h2, proj), (batch, h1), (batch, h2),
              (steps, batch, 4 * h1), (steps, batch, h1), (steps, batch, 4 * h2),
              (steps, batch, h2), (steps, batch, heads, te)]
    return ([torch.zeros(s, dtype=dtype) for s in shapes] + [None, None]
            + [torch.zeros(steps, batch, proj, dtype=dtype)] * 2 + [None])


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "_launch_bwd_tc"),
                                         (torch.float32, "bwd_kernel_limits")])
def test_bwd_bf16_takes_the_tensor_core_source_and_fp32_the_old_one(monkeypatch, dtype, route):
    """Past the operand checks, a bfloat16 adjoint goes to ``_launch_bwd_tc``
    (the tensor-core source) and float32 to ``csrc/speller_bwd.cu``: its
    limits (the card's SMs and shared memory), the plan of
    ``plan_decode_bwd_f32`` on them, then its library; nothing is launched
    here."""
    def routed(*args, **kwargs):
        raise _Routed(route)

    planned = []
    if dtype == torch.float32:
        real_plan = speller_cuda.plan_decode_bwd_f32
        monkeypatch.setattr(speller_cuda, "bwd_kernel_limits", lambda device: {
            "sms": SMS, "smem_optin": SMEM_LIMIT})
        monkeypatch.setattr(speller_cuda, "plan_decode_bwd_f32",
                            lambda *a, **k: planned.append(real_plan(*a, **k)) or planned[-1])
        monkeypatch.setattr(speller_cuda, "load_bwd_library", routed)
    else:
        monkeypatch.setattr(speller_cuda, route, routed)
    monkeypatch.setattr(speller_cuda, "_check_operands", lambda *args: None)
    with pytest.raises(_Routed, match=route):
        speller_cuda._launch_bwd(*_bwd_operands(dtype), 1, 0.125)
    if dtype == torch.float32:
        assert planned == [real_plan(2, 8, 64, 1, 128, 64, SMS, SMEM_LIMIT)]


def test_bwd_source_is_built_and_bound():
    assert speller_cuda.BWD_TC_SOURCE in speller_cuda.SOURCES
    assert speller_cuda.BWD_TC_SOURCE.endswith("csrc/speller_bwd_tc.cu")
    assert speller_cuda.load_bwd_tc_library in speller_cuda.LOADERS
    with open(speller_cuda.BWD_SOURCE) as fh:  # float32 only there now
        assert "launch<__nv_bfloat16>" not in fh.read()


# ---------------------------------------------------------------------------
# The float32 forward's plan (``plan_decode_f32``, csrc/speller_decode.cu)
# ---------------------------------------------------------------------------

def _earlier_grid(h1, h2, proj, max_grid=128):
    """The blocks of the earlier float32 kernels' launch: the largest power
    of two up to ``max_grid`` that divides both cells' widths and the
    projection width."""
    grid = max_grid
    while grid > 1 and (h1 % grid or h2 % grid or proj % grid):
        grid //= 2
    return grid


def _earlier_f32_takes(batch, te, proj, heads, h1, h2, vp):
    """Whether the earlier float32 forward (128 blocks at most, each owning
    1, 2, 4 or 8 of each cell's units and query columns, every block walking
    every row) took a shape: its checks and its shared memory, mirrored."""
    grid = _earlier_grid(h1, h2, proj)
    if any(n % 8 or n // grid not in (1, 2, 4, 8) for n in (h1, h2, proj)):
        return False
    if proj % heads or (proj // heads) % 8 or proj > 1024 or vp > 32:
        return False
    weights = (4 * (h1 // grid) * (proj + h1) + 4 * (h2 // grid) * (h1 + h2)
               + proj // grid * h2) * 4
    return -(-weights // 16) * 16 + (2 * proj + 256 + 1024 + heads * te) * 4 <= SMEM_LIMIT


# (H1, H2, P) the earlier float32 forward took at some heads and length; it
# took none of (768, 384, P), (1024, 512, P), (640, 128, P) or P 1024 below
# H1 256
EARLIER_F32_WIDTHS = [(h1, h2, p) for h1, h2 in ((64, 64), (128, 64), (256, 128), (512, 256))
                      for p in (64, 128, 256, 512)] + [
    (256, 128, 1024), (512, 256, 1024), (1024, 256, 128), (1024, 256, 256)]


@pytest.mark.parametrize("h1,h2,proj", EARLIER_F32_WIDTHS)
def test_f32_plan_takes_every_shape_the_earlier_kernel_took(h1, h2, proj):
    """Every shape the earlier float32 forward took, over heads, encoder
    lengths up to its shared-memory limit and batches of 1-300, the plan
    takes: one launch, every block resident, within the limit."""
    taken = 0
    for heads, te, batch in itertools.product((1, 2, 4, 8), (1, 37, 192, 608, 4096, 20000),
                                              (1, 5, 64, 256, 300)):
        if not _earlier_f32_takes(batch, te, proj, heads, h1, h2, 32):
            continue
        taken += 1
        plan = speller_cuda.plan_decode_f32(batch, te, proj, heads, h1, h2, 32, SMS,
                                            SMEM_LIMIT)
        assert plan.blocks == plan.col_groups * plan.row_groups <= 128
        assert plan.rows * plan.row_groups >= batch and plan.smem <= SMEM_LIMIT
        assert plan.smem == speller_cuda.decode_f32_smem_bytes(
            te, proj, heads, h1, h2, plan.col_groups, plan.sub, plan.stages, plan.att_rows)
    assert taken


@pytest.mark.parametrize("kwargs,match", [
    ({"h1": 100}, "H1 100, H2 128 and P 128 must be multiples of 8"),
    ({"heads": 3}, "head width P / heads = 128 / 3"),
    ({"heads": 32}, "head width P / heads = 128 / 32"),
    ({"proj": 2048, "h1": 256}, "P 2048 above 1024"),
    ({"vp": 33}, "padded vocabulary 33 must be at most 32"),
    ({"te": 60000}, "shared memory a block at the least .* the device's limit is 232448"),
    ({"batch": 0}, "batch 0 and encoder length 608 must be at least 1"),
])
def test_f32_plan_raises_naming_the_limit(kwargs, match):
    args = {"batch": 256, "te": 608, "proj": 128, "heads": 1, "h1": 256, "h2": 128, "vp": 32}
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        speller_cuda.plan_decode_f32(args["batch"], args["te"], args["proj"], args["heads"],
                                     args["h1"], args["h2"], args["vp"], SMS, SMEM_LIMIT)


def test_f32_plan_at_the_rewriter_widths():
    """lminfer's batch of 256 at the Rewriter's decoder widths: 16 column
    groups x 8 row groups of 32 rows, the products in one sub-tile, two
    attention rows a block at once."""
    plan = speller_cuda.plan_decode_f32(256, 608, 128, 1, 256, 128, 32, SMS, SMEM_LIMIT)
    assert (plan.blocks, plan.col_groups, plan.row_groups, plan.rows, plan.sub,
            plan.att_rows) == (128, 16, 8, 32, 32, 2)
    assert plan.smem <= SMEM_LIMIT


def test_f32_shared_memory_bytes():
    # 16 column groups: 16 cell-1 units over K 384, 8 cell-2 units over K 384,
    # 8 query columns over 128; the region the larger of the ring (3 stages
    # of 32 rows x 132) and the attention (2 rows of q, ctx, partials,
    # scores, and 1024 group sums)
    weights = 4 * 16 * 384 + 4 * 8 * 384 + 8 * 128
    attn = 2 * (2 * 128 + 256 + 608) + 1024
    assert speller_cuda.decode_f32_smem_bytes(608, 128, 1, 256, 128, 16, 32, 3, 2) == 4 * (
        weights + max(3 * 32 * 132, attn))
    # one query column a block: the earlier kernel's columns, the region the
    # attention's
    assert speller_cuda.decode_f32_smem_bytes(8, 128, 1, 128, 128, 128, 8, 1, 1) == 4 * (
        4 * 1 * 256 + 4 * 1 * 256 + 1 * 128 + 2 * 128 + 256 + 8 + 1024)


def test_f32_limits_mirror_the_source():
    """The plan's constants are the float32 source's (the card test reads
    them from the built library; here from the source's text)."""
    with open(speller_cuda.SOURCE) as fh:
        text = fh.read()
    for key, name in (("max_grid", "DF_MAX_GRID"), ("nthreads", "DF_THREADS"),
                      ("vmax", "DF_VMAX"), ("rt", "DF_RT"), ("kc", "DF_KC"),
                      ("pad", "DF_PAD"), ("max_stages", "DF_MAX_STAGES"),
                      ("att_rows", "DF_ATT_ROWS")):
        assert f"constexpr int {name} = {speller_cuda.F32_LIMITS[key]};" in text, name


# ---------------------------------------------------------------------------
# The float32 adjoint's plan (``plan_decode_bwd_f32``, csrc/speller_bwd.cu)
# ---------------------------------------------------------------------------

def _earlier_f32_bwd_takes(batch, te, proj, heads, h1, h2):
    """Whether the earlier float32 adjoint (the largest power-of-two grid up
    to 128 dividing H1, H2 and P, each block owning 1, 2, 4 or 8 of each
    cell's units and context columns, every block walking every row) took a
    shape: its checks (``_check_geometry``) and its shared memory
    (``smem_bytes``: the weight rows, then d_ctx, 1024 floats of group sums
    and dw and w of every head), mirrored."""
    grid = _earlier_grid(h1, h2, proj)
    if any(n % 8 or n // grid not in (1, 2, 4, 8) for n in (h1, h2, proj)):
        return False
    if proj % heads or (proj // heads) % 8 or proj > 1024:
        return False
    u1, u2, nq = h1 // grid, h2 // grid, proj // grid
    weights = ((u1 + nq) * 4 * h1 + (u1 + u2) * 4 * h2 + u2 * proj) * 4
    return -(-weights // 16) * 16 + (proj + 1024 + 2 * heads * te) * 4 <= SMEM_LIMIT


def _check_bwd_f32_plan(plan, batch, te, proj, heads, h1, h2):
    """The plan is a geometry the source takes (geometry_ok mirrored) and
    fits the card."""
    lim = speller_cuda.BWD_F32_LIMITS
    assert plan.blocks == plan.col_groups * plan.row_groups <= min(lim["max_grid"], SMS)
    assert not (h1 % plan.col_groups or h2 % plan.col_groups or proj % plan.col_groups)
    assert plan.rows * plan.row_groups >= batch > plan.rows * (plan.row_groups - 1)
    assert plan.sub % 8 == 0 and 8 <= plan.sub <= lim["max_box_rows"]
    assert 1 <= plan.boxes <= lim["max_boxes"] and 1 <= plan.stages <= lim["max_stages"]
    assert 1 <= plan.ks <= lim["max_ks"] and plan.att_groups >= 1
    for cols, _ in speller_cuda._bwd_f32_phases(proj, h1, h2, plan.col_groups):
        assert speller_cuda.bwd_f32_tiling(plan.sub, cols, 1, 1)[2] <= lim["nthreads"]
    assert plan.smem == speller_cuda.decode_bwd_f32_smem_bytes(
        te, proj, heads, h1, h2, plan.col_groups, plan.sub, plan.boxes, plan.stages, plan.ks,
        plan.att_groups, plan.stream) <= SMEM_LIMIT


@pytest.mark.parametrize("h1,h2,proj", EARLIER_F32_WIDTHS)
def test_bwd_f32_plan_takes_every_shape_the_earlier_adjoint_took(h1, h2, proj):
    """Every shape the earlier float32 adjoint took, over heads, encoder
    lengths up to its shared-memory limit and batches, the plan takes: one
    launch, every block resident, within the limit."""
    taken = 0
    for heads, te, batch in itertools.product((1, 2, 4, 8), (1, 37, 192, 640, 4096, 20000),
                                              (1, 5, 64, 300)):
        if not _earlier_f32_bwd_takes(batch, te, proj, heads, h1, h2):
            continue
        taken += 1
        plan = speller_cuda.plan_decode_bwd_f32(batch, te, proj, heads, h1, h2, SMS, SMEM_LIMIT)
        _check_bwd_f32_plan(plan, batch, te, proj, heads, h1, h2)
    assert taken


# (H1, H2, P) the float32 forward takes at some heads, length and batch: the
# earlier ones, the card tests', base- and scaled-LAS's, the Rewriter's, and
# blocks the earlier adjoint refused (5 units a block at (640, 128, 256); 6
# and 3 at (768, 384, P); 3 at (384, 128, 256))
F32_BWD_WIDTHS = sorted(set(EARLIER_F32_WIDTHS + [
    (128, 64, 64), (512, 256, 256), (1024, 256, 256), (256, 128, 128), (640, 128, 256),
    (768, 384, 256), (768, 384, 512), (384, 128, 256), (512, 512, 256)]))


@pytest.mark.parametrize("h1,h2,proj", F32_BWD_WIDTHS)
def test_bwd_f32_plan_takes_every_shape_the_forward_takes(h1, h2, proj):
    """Wherever the float32 forward plans a call, over heads, encoder
    lengths and batches, the float32 adjoint plans it too."""
    taken = 0
    for heads, te, batch in itertools.product((1, 2, 4), (1, 192, 700, 1024, 4096, 20000),
                                              (1, 8, 64, 300)):
        if (proj // heads) % 8:
            continue
        try:
            speller_cuda.plan_decode_f32(batch, te, proj, heads, h1, h2, 32, SMS, SMEM_LIMIT)
        except ValueError:
            continue
        taken += 1
        plan = speller_cuda.plan_decode_bwd_f32(batch, te, proj, heads, h1, h2, SMS, SMEM_LIMIT)
        _check_bwd_f32_plan(plan, batch, te, proj, heads, h1, h2)
    assert taken


@pytest.mark.parametrize("shape", [
    (8, 192, 256, 1, 640, 128),   # 5 cell-1 units a block on the earlier grid of 128
    (8, 700, 256, 4, 1024, 256),  # scaled-LAS past the earlier adjoint's shared memory
    (8, 1024, 256, 4, 1024, 256),
    (32, 704, 256, 4, 1024, 256)])
def test_bwd_f32_plan_takes_shapes_the_earlier_adjoint_refused(shape):
    batch, te, proj, heads, h1, h2 = shape
    assert not _earlier_f32_bwd_takes(*shape)
    speller_cuda.plan_decode_f32(*shape, 32, SMS, SMEM_LIMIT)  # the forward takes it
    plan = speller_cuda.plan_decode_bwd_f32(*shape, SMS, SMEM_LIMIT)
    _check_bwd_f32_plan(plan, batch, te, proj, heads, h1, h2)


@pytest.mark.parametrize("kwargs,match", [
    ({"h1": 100}, "H1 100, H2 128 and P 128 must be multiples of 8"),
    ({"heads": 3}, "head width P / heads = 128 / 3"),
    ({"heads": 32}, "head width P / heads = 128 / 32"),
    ({"proj": 2048, "h1": 256}, "head width 2048 above 1024"),
    ({"te": 60000}, "shared memory a block at the least .* the device's limit is 232448"),
    ({"te": 608, "smem_optin": 12000}, "the device's limit is 12000"),
    ({"batch": 0}, "batch 0 and encoder length 608 must be at least 1"),
])
def test_bwd_f32_plan_raises_naming_the_limit(kwargs, match):
    args = {"batch": 64, "te": 608, "proj": 128, "heads": 1, "h1": 256, "h2": 128,
            "smem_optin": SMEM_LIMIT}
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        speller_cuda.plan_decode_bwd_f32(args["batch"], args["te"], args["proj"], args["heads"],
                                         args["h1"], args["h2"], SMS, args["smem_optin"])


# the plans the A/B calls measured on an H100 (PERF.md): (batch, P, heads, H1,
# H2) at Te 192 -> (blocks, CG, RG, rows, sub-tile, boxes, stages, k slices,
# (d)'s weights streamed); base-LAS B=128 and scaled-LAS B=32 are the main
# path's
MEASURED_BWD_F32_PLANS = {
    "base-LAS B=128": ((128, 256, 1, 512, 256), (128, 32, 4, 32, 32, 1, 3, 16, 1)),
    "base-LAS B=64": ((64, 256, 1, 512, 256), (128, 32, 4, 16, 16, 2, 2, 16, 1)),
    "base-LAS B=32": ((32, 256, 1, 512, 256), (128, 64, 2, 16, 16, 2, 4, 16, 0)),
    "scaled-LAS B=128": ((128, 256, 4, 1024, 256), (128, 64, 2, 64, 64, 1, 2, 16, 1)),
    "scaled-LAS B=32": ((32, 256, 4, 1024, 256), (128, 64, 2, 16, 16, 2, 2, 16, 1)),
}


@pytest.mark.parametrize("shape", list(MEASURED_BWD_F32_PLANS))
def test_bwd_f32_plan_at_the_measured_shapes(shape):
    (batch, proj, heads, h1, h2), want = MEASURED_BWD_F32_PLANS[shape]
    plan = speller_cuda.plan_decode_bwd_f32(batch, 192, proj, heads, h1, h2, SMS, SMEM_LIMIT)
    assert (plan.blocks, plan.col_groups, plan.row_groups, plan.rows, plan.sub, plan.boxes,
            plan.stages, plan.ks, plan.stream) == want
    _check_bwd_f32_plan(plan, batch, 192, proj, heads, h1, h2)


@pytest.mark.parametrize("shape,sms,blocks", [
    ((128, 192, 256, 1, 512, 256), SMS, 128),  # base-LAS: at most 128
    ((128, 192, 256, 1, 512, 256), 64, 64),    # at most the SMs
    ((1, 192, 256, 1, 512, 256), SMS, 128),    # one row: 128 column groups
    ((1, 37, 48, 1, 64, 32), SMS, 16),         # one row: 16 column groups divide P 48
    ((64, 37, 48, 1, 64, 32), SMS, 128),      # 16 column groups x 8 row groups
])
def test_bwd_f32_plan_takes_the_most_blocks(shape, sms, blocks):
    plan = speller_cuda.plan_decode_bwd_f32(*shape, sms, SMEM_LIMIT)
    assert plan.blocks == blocks


def test_bwd_f32_plan_takes_the_least_feed_at_the_most_blocks():
    """At base-LAS B=32 two splits of 128 blocks fit with the widest ring:
    64 x 2 row groups of 16 rows, (d)'s weights resident (16 rows x 3328
    floats a step into a block), and 32 x 4 of 8 rows, (d)'s 24 weight rows
    streamed (8 x 3328 + 24 x 2048); the first reads fewer bytes."""
    plan = speller_cuda.plan_decode_bwd_f32(32, 192, 256, 1, 512, 256, SMS, SMEM_LIMIT)
    assert (plan.col_groups, plan.stream) == (64, 0)
    assert 16 * 3328 < 8 * 3328 + 24 * 2048
    for cg, sub, stream in ((64, 16, 0), (32, 8, 1)):
        ks, ring, boxes, _, _, _ = speller_cuda._bwd_f32_inner(192, 256, 1, 512, 256, cg, sub,
                                                                stream, SMEM_LIMIT)
        assert (ks, ring, boxes) == (16, 0, 2)


def test_bwd_f32_shared_memory_bytes():
    # base-LAS, 32 column groups: 16 cell-1, 8 cell-2 units and 8 context
    # columns a block; 32-row sub-tiles, 3 stages of 2 boxes (128 k each, rows
    # of 132 floats), (d)'s 16 + 8 weight rows streamed a box, 8 k slices, 4
    # attention groups
    weights = 8 * 256 + 24 * 4 * 256
    att = 256 + 192 + 4 * 256 + 8
    # the partial tiles of the widest phase: (c) and (d), 24 columns of 8 x 4
    # tiles over 32 rows, 24 tiles, 8 k slices (10 would fill the threads)
    red = 8 * 32 * 24
    assert speller_cuda.bwd_f32_tiling(32, 24, 8, 32) == (4, 8, 24, 8)
    assert speller_cuda.bwd_f32_tiling(32, 24, 16, 32) == (4, 8, 24, 10)
    ring = 3 * 2 * (32 + 16 + 8) * 132 * 4
    assert speller_cuda.decode_bwd_f32_smem_bytes(192, 256, 1, 512, 256, 32, 32, 2, 3, 8, 4,
                                                  1) == 128 + ring + 3 * 16 + 4 * (
        weights + max(att, red))
    # the same with (d)'s weight rows resident
    weights += 24 * 4 * 512
    assert speller_cuda.decode_bwd_f32_smem_bytes(192, 256, 1, 512, 256, 32, 32, 2, 1, 8, 4,
                                                  0) == 128 + 2 * 32 * 132 * 4 + 16 + 4 * (
        weights + max(att, red))
    # scaled-LAS, 4 heads of 64: the attention's groups cap at 256 / 16 slices
    assert speller_cuda._bwd_att_groups(256, 4, 256) == 16
    # a phase with few columns: (b)'s 8 cell-2 units make 8 tiles of 8 x 4
    # on 32 rows, the k slices up to 16 and the stage's pieces
    assert speller_cuda.bwd_f32_tiling(32, 8, 16, 32) == (4, 8, 8, 16)
    assert speller_cuda.bwd_f32_tiling(32, 8, 16, 2) == (4, 8, 8, 2)
    # 10 columns take tiles 2 wide; 1024 columns over 8 rows fill the threads
    assert speller_cuda.bwd_f32_tiling(16, 10, 16, 32) == (2, 8, 10, 16)
    assert speller_cuda.bwd_f32_tiling(8, 1024, 16, 32)[:3] == (4, 8, 256)


def test_bwd_f32_limits_mirror_the_source():
    """The plan's constants are the float32 adjoint source's (the card test
    reads them from the built library; here from the source's text)."""
    with open(speller_cuda.BWD_SOURCE) as fh:
        text = fh.read()
    for key, name in (("max_grid", "DA_MAX_GRID"), ("nthreads", "DA_CONSUMERS"),
                      ("box_k", "DA_BOX_K"), ("max_boxes", "DA_MAX_BOXES"),
                      ("max_stages", "DA_MAX_STAGES"), ("max_ks", "DA_MAX_KS"),
                      ("max_box_rows", "DA_MAX_BOX_ROWS"), ("align", "DA_ALIGN")):
        assert f"constexpr int {name} = {speller_cuda.BWD_F32_LIMITS[key]};" in text, name
    assert "constexpr int DA_LDX = DA_BOX_K + 4;" in text
    assert speller_cuda.BWD_F32_LIMITS["ldx"] == speller_cuda.BWD_F32_LIMITS["box_k"] + 4
    assert "grid.sync" not in text and "cooperative_groups" not in text
