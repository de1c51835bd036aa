"""PyTorch port, the launch plan of the forward LSTM recurrence
(``ops/lstm_cuda.py::plan_launches``): which cooperative launches a
(dtype, batch, H, directions) layer takes on a card of a given number of SMs,
with the units a block and the shared memory each block needs. Pure Python:
no card, no kernel."""

import itertools
import os
import re

import pytest
import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import lstm_cuda

SMS = 132  # an H100's
SMEM_LIMIT = 232448  # the shared memory a block may use on it
# every hidden size the wrappers take
WIDTHS = [h for h in range(32, 1025, 32) if h <= 512 or h % 64 == 0]


def _spans(plan):
    return [(ln.r0, ln.r1, ln.d0, ln.nd) for ln in plan]


@pytest.mark.parametrize("hidden,batch,in_dim", [
    (512, 96, 15), (512, 96, 0), (512, 128, 15), (512, 128, 0),   # base-LAS
    (1024, 128, 15), (1024, 128, 0),                              # scaled-LAS
])
def test_bf16_main_path_is_one_launch_with_both_directions(hidden, batch, in_dim):
    plan = lstm_cuda.plan_launches("k", torch.bfloat16, batch, hidden, 2, SMS, in_dim)
    assert _spans(plan) == [(0, batch, 0, 2)]
    (ln,) = plan
    assert ln.units == (8 if hidden <= 512 else 16)
    assert ln.blocks == 128 <= SMS


def test_bf16_batch_past_128_rows_takes_a_second_launch():
    plan = lstm_cuda.plan_launches("k", torch.bfloat16, 129, 1024, 2, SMS)
    assert _spans(plan) == [(0, 128, 0, 2), (128, 129, 0, 2)]


# the float32 forward (csrc/lstm_scan_body.cuh): blocks of R rows x U units
@pytest.mark.parametrize("batch,hidden,ndir", [
    (5, 64, 2), (40, 512, 2), (128, 512, 2), (128, 1024, 2), (129, 768, 2), (64, 1024, 1),
    (256, 256, 2), (300, 256, 2), (1, 32, 1), (2000, 64, 2)])
def test_fp32_plan_holds_every_row_in_whole_row_groups(batch, hidden, ndir):
    plan = lstm_cuda.plan_launches("k", torch.float32, batch, hidden, ndir, SMS)
    cells = [(r, d) for ln in plan for r in range(ln.r0, ln.r1)
             for d in range(ln.d0, ln.d0 + ln.nd)]
    assert sorted(cells) == list(itertools.product(range(batch), range(ndir)))
    for ln in plan:
        threads = ln.rows // lstm_cuda._F32_RT * ln.units
        groups = -(-(ln.r1 - ln.r0) // ln.rows)
        assert hidden % ln.units == 0 and ln.rows % lstm_cuda._F32_RT == 0
        assert threads % 32 == 0 and 32 <= threads <= 256
        assert ln.blocks == ln.nd * hidden // ln.units * groups <= SMS
        assert 1 <= ln.stages <= 4 and ln.smem <= SMEM_LIMIT
        assert ln.smem == lstm_cuda.f32_smem_bytes(hidden, ln.units, ln.rows, ln.stages)
    # launches one after another only where the card cannot hold the rows:
    # all but the last of a direction group are full
    spans = sorted({(ln.r0, ln.r1) for ln in plan})
    assert all(r1 - r0 == spans[0][1] - spans[0][0] for r0, r1 in spans[:-1])


@pytest.mark.parametrize("batch", [1, 2, 5, 8, 31, 33, 64, 96, 100, 128, 129, 200, 256, 300])
@pytest.mark.parametrize("hidden", [32, 64, 128, 256, 384, 512, 640, 768, 1024])
@pytest.mark.parametrize("ndir", [1, 2])
def test_fp32_every_row_and_direction_is_in_one_launch(batch, hidden, ndir):
    """B 1-300, H 32-1024: every (row, direction) in exactly one launch,
    no launch past the card's SMs or the shared memory a block may use."""
    plan = lstm_cuda.plan_launches("k", torch.float32, batch, hidden, ndir, SMS)
    cells = [(r, d) for ln in plan for r in range(ln.r0, ln.r1)
             for d in range(ln.d0, ln.d0 + ln.nd)]
    assert sorted(cells) == list(itertools.product(range(batch), range(ndir)))
    assert all(ln.blocks <= SMS and ln.smem <= SMEM_LIMIT for ln in plan)
    # both directions share a launch wherever their blocks fit: up to H=512
    if hidden <= 512:
        assert all(ln.nd == ndir for ln in plan)


@pytest.mark.parametrize("batch,hidden,in_dim", [
    (256, 256, 0), (256, 256, 128), (64, 512, 15), (64, 512, 0), (128, 512, 15),
    (128, 512, 0), (96, 512, 15)])
def test_fp32_main_path_batches_are_one_launch(batch, hidden, in_dim):
    """The Rewriter's lminfer layer (B=256, H=256) and the listener's
    batches up to H=512: one launch of every row and both directions."""
    plan = lstm_cuda.plan_launches("k", torch.float32, batch, hidden, 2, SMS, in_dim)
    assert _spans(plan) == [(0, batch, 0, 2)]


def test_fp32_rewriter_layer_is_128_blocks_of_64_rows_by_16_units():
    (ln,) = lstm_cuda.plan_launches("k", torch.float32, 256, 256, 2, SMS)
    assert (ln.rows, ln.units, ln.blocks, ln.stages) == (64, 16, 128, 4)


@pytest.mark.parametrize("hidden", [768, 1024])
def test_fp32_splits_directions_only_past_the_card(hidden):
    """H=1024 (2 x 128 blocks at 8 units) takes a launch a direction; a
    narrower card splits where a wider one does not."""
    plan = lstm_cuda.plan_launches("k", torch.float32, 128, hidden, 2, SMS)
    assert {(ln.d0, ln.nd) for ln in plan} == ({(0, 1), (1, 1)} if hidden == 1024 else {(0, 2)})
    assert {(ln.d0, ln.nd) for ln in lstm_cuda.plan_launches(
        "k", torch.float32, 128, 512, 2, 60)} == {(0, 1), (1, 1)}


@pytest.mark.parametrize("batch", [8, 32, 128, 256])
@pytest.mark.parametrize("hidden", [64, 256, 512])
def test_fp32_bilstm_keeps_both_directions_in_each_launch(batch, hidden):
    """#7 (``bilstm_scan_fused``) takes both directions in one launch up to
    H=512: the plan never splits them there."""
    plan = lstm_cuda.plan_launches("bilstm_scan_fused", torch.float32, batch, hidden, 2, SMS)
    assert all((ln.d0, ln.nd) == (0, 2) for ln in plan)


def test_fp32_shared_memory_bytes():
    # W_hh 256 x 16 units x 4 gates fp32, four stages of 64 rows x (64 + 4)
    assert lstm_cuda.f32_smem_bytes(256, 16, 64, 4) == 4 * (256 * 64 + 4 * 64 * 68)
    # the fused input: W_ih 15 x 64, the bias 64, x_t 15 x 64 rows
    assert lstm_cuda.f32_smem_bytes(512, 16, 64, 4, 15) == 4 * (
        512 * 64 + 4 * 64 * 68 + 15 * 64 + 64 + 15 * 64)


def test_fp32_constants_mirror_the_source():
    """The plan's constants are the float32 body's (read from its text)."""
    with open(os.path.join(os.path.dirname(lstm_cuda.SOURCE), "lstm_scan_body.cuh")) as fh:
        text = fh.read()
    for name, value in (("F32_RT", lstm_cuda._F32_RT),
                        ("F32_MAX_THREADS", lstm_cuda._F32_MAX_THREADS),
                        ("F32_KC", lstm_cuda._F32_KC),
                        ("F32_MAX_STAGES", lstm_cuda._F32_MAX_STAGES),
                        ("F32_PAD", lstm_cuda._F32_PAD)):
        assert re.search(rf"constexpr int {name} = {value};", text), name


@pytest.mark.parametrize("dtype,batch,hidden,ndir,sms", [
    (torch.bfloat16, 1, 32, 1, SMS), (torch.bfloat16, 257, 512, 2, SMS),
    (torch.bfloat16, 300, 1024, 2, 100), (torch.float32, 97, 1024, 2, SMS),
    (torch.float32, 33, 256, 2, SMS), (torch.bfloat16, 40, 640, 2, SMS)])
def test_every_row_and_direction_is_in_one_launch(dtype, batch, hidden, ndir, sms):
    plan = lstm_cuda.plan_launches("k", dtype, batch, hidden, ndir, sms)
    cells = [(r, d) for ln in plan for r in range(ln.r0, ln.r1)
             for d in range(ln.d0, ln.d0 + ln.nd)]
    assert sorted(cells) == list(itertools.product(range(batch), range(ndir)))
    assert all(ln.blocks <= sms for ln in plan)


def test_bf16_splits_directions_only_where_the_blocks_do_not_fit():
    # 2 x 64 blocks on a card of 100 SMs: a launch a direction
    plan = lstm_cuda.plan_launches("k", torch.bfloat16, 128, 1024, 2, 100)
    assert _spans(plan) == [(0, 128, 0, 1), (0, 128, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shared_memory_fits_at_every_width(dtype):
    for hidden, in_dim in itertools.product(WIDTHS, (0, 15, 128)):
        for ln in lstm_cuda.plan_launches("k", dtype, 128, hidden, 2, SMS, in_dim):
            assert ln.smem <= SMEM_LIMIT, (hidden, in_dim, ln)


def test_bf16_shared_memory_bytes():
    stage, align = 128 * 64 * 2, 1024
    # W_hh 1024 x 64 bf16, W_ih 15 (or 128) x 64 bf16 and the bias; the ring:
    # four 128-row stages, its most
    assert lstm_cuda.tc_smem_bytes(1024, 16, 15) == align + 131072 + 4 * stage + 1920 + 256
    assert lstm_cuda.tc_smem_bytes(1024, 16, 128) == align + 131072 + 4 * stage + 16384 + 256
    assert lstm_cuda.tc_smem_bytes(512, 8) == align + 32768 + 4 * stage
    # H = 32: one (half-empty) chunk; the ring three stages, more than the
    # 128 x 40 fp32 reduction tile
    assert lstm_cuda.tc_smem_bytes(32, 8) == align + 32 * 128 + 3 * stage
    # the reduction tile at 16 units, 128 x 72 fp32, is less than three stages
    assert lstm_cuda.tc_smem_bytes(64, 16) == align + 64 * 128 + 3 * stage


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hidden,in_dim,match", [
    (0, 0, "hidden 0 must be a multiple of 32"),
    (48, 0, "hidden 48 must be a multiple of 32"),
    (544, 0, "hidden 544 above 512 must be a multiple of 64 and at most 1024"),
    (1088, 0, "hidden 1088 above 512 must be a multiple of 64 and at most 1024"),
    (64, 129, "in_dim 129 > 128"),
])
def test_refused_shapes_raise(dtype, hidden, in_dim, match):
    with pytest.raises(ValueError, match=match):
        lstm_cuda.plan_launches("k", dtype, 8, hidden, 2, SMS, in_dim)



# ---------------------------------------------------------------------------
# The adjoint's plan (``plan_bwd_launches``): ``lstm_bwd`` (with_dw False)
# and ``lstm_bwd_dw`` (with_dw True)
# ---------------------------------------------------------------------------

def _bwd_bf16_geometry(batch, hidden):
    """(row groups, units a block) of the bfloat16 adjoint at two directions
    on 132 SMs: past 64 rows up to H=512 two row groups, 8 units where their
    2 x 2 x H / 8 blocks fit (H <= 256), else 16; otherwise one group of
    the forward's units."""
    if batch > 64 and hidden <= 512:
        return 2, (8 if 2 * 2 * hidden // 8 <= SMS else 16)
    return 1, lstm_cuda.tc_units(hidden)


@pytest.mark.parametrize("hidden,with_dw", [
    (64, False), (64, True), (512, False), (512, True), (768, False), (1024, False)])
@pytest.mark.parametrize("batch", [5, 64, 96, 128])
def test_bwd_bf16_is_one_launch_with_every_direction(hidden, with_dw, batch):
    plan = lstm_cuda.plan_bwd_launches("k", torch.bfloat16, batch, hidden, 2, SMS, with_dw)
    assert _spans(plan) == [(0, batch, 0, 2)]
    (ln,) = plan
    groups, units = _bwd_bf16_geometry(batch, hidden)
    assert (ln.groups, ln.units) == (groups, units)
    assert ln.blocks == groups * 2 * hidden // ln.units <= SMS


@pytest.mark.parametrize("rows,groups", [
    (96, [(0, 48), (48, 96)]), (128, [(0, 64), (64, 128)]), (65, [(0, 33), (33, 65)]),
    (66, [(0, 33), (33, 66)]), (64, [(0, 64)]), (33, [(0, 33)]), (1, [(0, 1)])])
def test_bwd_bf16_row_groups_are_balanced(rows, groups):
    (ln,) = lstm_cuda.plan_bwd_launches("k", torch.bfloat16, rows, 512, 2, SMS, True)
    assert lstm_cuda.bwd_tc_row_groups(rows, ln.groups) == groups
    # the block's shared memory is sized for the larger group's rows
    longest = max(r1 - r0 for r0, r1 in groups)
    assert ln.smem == lstm_cuda.bwd_tc_smem_bytes(longest, 512, ln.units, True)


@pytest.mark.parametrize("sms", [SMS, 128, 100, 60])
@pytest.mark.parametrize("ndir", [1, 2])
@pytest.mark.parametrize("with_dw", [False, True])
def test_bwd_bf16_row_group_launches_fit_the_card(sms, ndir, with_dw):
    """Every launch's blocks fit the SMs and its shared memory the limit; a
    launch of two row groups holds every direction, and each group at most
    64 rows."""
    for hidden in WIDTHS:
        if with_dw and hidden > 512:
            continue
        for batch in (1, 33, 64, 65, 96, 127, 128, 129, 200, 256):
            try:
                plan = lstm_cuda.plan_bwd_launches("k", torch.bfloat16, batch, hidden, ndir, sms,
                                                   with_dw)
            except ValueError:  # refused where the parent refused: too few SMs
                per_dir = hidden // lstm_cuda.tc_units(hidden)
                assert per_dir > sms or (with_dw and ndir * per_dir > sms)
                continue
            for ln in plan:
                assert ln.blocks == ln.groups * ln.nd * hidden // ln.units <= sms
                assert ln.smem <= SMEM_LIMIT, (hidden, batch, ln)
                assert ln.groups in (1, 2)
                longest = -(-(ln.r1 - ln.r0) // ln.groups)
                # the kernel sums dW_hh only in chains of at most 64 rows
                assert not with_dw or longest <= 64
                if ln.groups == 2:
                    assert ln.nd == ndir and hidden <= 512
                    assert all(r1 - r0 <= 64 for r0, r1 in
                               lstm_cuda.bwd_tc_row_groups(ln.r1 - ln.r0, ln.groups))


def _parent_bwd_bf16_plan(batch, hidden, ndir, sms, with_dw):
    """The bfloat16 adjoint's plan before row groups, where the mechanism
    does not engage: ``tc_units`` units, one group, all directions in one
    launch where they fit, else one a direction (None: refused)."""
    units = lstm_cuda.tc_units(hidden)
    if ndir * hidden // units <= sms:
        dirs = [(0, ndir)]
    elif hidden // units <= sms and not with_dw:
        dirs = [(d, 1) for d in range(ndir)]
    else:
        return None
    return [lstm_cuda.Launch(r0, r1, d0, nd, units, nd * hidden // units,
                             lstm_cuda.bwd_tc_smem_bytes(r1 - r0, hidden, units, with_dw))
            for r0, r1 in lstm_cuda.row_chunks(batch, 128) for d0, nd in dirs]


@pytest.mark.parametrize("sms", [SMS, 100, 60])
@pytest.mark.parametrize("with_dw", [False, True])
def test_bwd_bf16_keeps_the_parent_plan_where_it_bypasses_row_groups(sms, with_dw):
    """Up to 64 rows and above H=512 the plan is the parent's launch for
    launch; past 64 rows it takes every shape the parent took."""
    for hidden in WIDTHS:
        if with_dw and hidden > 512:
            continue
        for batch in (1, 5, 24, 33, 48, 64, 65, 96, 128):
            want = _parent_bwd_bf16_plan(batch, hidden, 2, sms, with_dw)
            try:
                got = lstm_cuda.plan_bwd_launches("k", torch.bfloat16, batch, hidden, 2, sms,
                                                  with_dw)
            except ValueError:
                got = None
            if batch <= 64 or hidden > 512:
                assert got == want, (hidden, batch)
            else:
                assert want is None or got is not None, (hidden, batch)


@pytest.mark.parametrize("dtype,batch,hidden", [
    (torch.bfloat16, 64, 512), (torch.bfloat16, 48, 512), (torch.bfloat16, 24, 512),
    (torch.bfloat16, 64, 256), (torch.bfloat16, 96, 768), (torch.bfloat16, 128, 1024),
    (torch.float32, 96, 512), (torch.float32, 128, 512), (torch.float32, 128, 256)])
def test_bwd_one_row_group_where_rows_width_or_dtype_bypass_it(dtype, batch, hidden):
    for with_dw in (False, True) if hidden <= 512 else (False,):
        plan = lstm_cuda.plan_bwd_launches("k", dtype, batch, hidden, 2, SMS, with_dw)
        assert [ln.groups for ln in plan] == [1] * len(plan)


@pytest.mark.parametrize("hidden,with_dw", [(512, False), (512, True), (1024, False)])
def test_bwd_bf16_batch_past_128_rows_takes_a_second_launch(hidden, with_dw):
    plan = lstm_cuda.plan_bwd_launches("k", torch.bfloat16, 129, hidden, 2, SMS, with_dw)
    assert _spans(plan) == [(0, 128, 0, 2), (128, 129, 0, 2)]
    # the one-row launch stages 64-row tiles: less shared memory than 128 rows
    assert plan[1].smem < plan[0].smem


# the float32 adjoint (csrc/lstm_bwd.cu): blocks of R rows x U units
@pytest.mark.parametrize("with_dw", [False, True])
@pytest.mark.parametrize("batch", [40, 64, 96, 128])
def test_bwd_fp32_main_path_is_one_launch_of_both_directions(batch, with_dw):
    """base-LAS's listener (H=512) at the train batch and the parity step's:
    one launch of every row and both directions, with and without dW_hh."""
    plan = lstm_cuda.plan_bwd_launches("k", torch.float32, batch, 512, 2, SMS, with_dw)
    assert _spans(plan) == [(0, batch, 0, 2)]


@pytest.mark.parametrize("with_dw", [False, True])
def test_bwd_fp32_train_batch_is_128_blocks_of_64_rows_by_16_units(with_dw):
    (ln,) = lstm_cuda.plan_bwd_launches("k", torch.float32, 128, 512, 2, SMS, with_dw)
    assert (ln.rows, ln.units, ln.blocks, ln.stages, ln.chunk) == (64, 16, 128, 3, 128)


@pytest.mark.parametrize("with_dw", [False, True])
@pytest.mark.parametrize("batch,hidden", [(128, 256), (40, 512)])
def test_bwd_fp32_one_launch_takes_the_most_blocks(batch, hidden, with_dw):
    """Of the one-launch plans of 16 units a block, the one with the most
    blocks, i.e. the fewest rows a block: 128 blocks of 32 rows, not 64 of 64
    (at H=256, B=128 they ran the adjoint 1.2-1.4x faster on the card)."""
    (ln,) = lstm_cuda.plan_bwd_launches("k", torch.float32, batch, hidden, 2, SMS, with_dw)
    assert (ln.rows, ln.units, ln.blocks) == (32, 16, 128)


@pytest.mark.parametrize("batch", [32, 96, 128])
@pytest.mark.parametrize("ndir", [1, 2])
def test_bwd_fp32_wide_is_one_launch_a_direction_of_every_row(batch, ndir):
    """H=1024: 8 units a block by shared memory, so a direction fills the
    card; each launch holds every row."""
    plan = lstm_cuda.plan_bwd_launches("k", torch.float32, batch, 1024, ndir, SMS, False)
    assert _spans(plan) == [(0, batch, d, 1) for d in range(ndir)]
    assert all(ln.units == 8 and ln.blocks <= SMS for ln in plan)
    if batch > 64:
        assert plan[0].rows == 128


@pytest.mark.parametrize("batch", [1, 2, 5, 8, 31, 33, 64, 96, 100, 128, 129, 200, 256, 300])
@pytest.mark.parametrize("hidden", [32, 64, 128, 256, 384, 512, 640, 768, 1024])
@pytest.mark.parametrize("ndir", [1, 2])
def test_bwd_fp32_every_row_and_direction_is_in_one_launch(batch, hidden, ndir):
    """B 1-300, H 32-1024, with dW_hh up to H=512: every (row, direction)
    in exactly one launch, whole row groups, blocks no more than the SMs,
    shared memory within what a block may use and as the source computes
    it, and launches one after another only where the card cannot hold the
    rows."""
    for with_dw in (False, True) if hidden <= 512 else (False,):
        plan = lstm_cuda.plan_bwd_launches("k", torch.float32, batch, hidden, ndir, SMS,
                                           with_dw)
        cells = [(r, d) for ln in plan for r in range(ln.r0, ln.r1)
                 for d in range(ln.d0, ln.d0 + ln.nd)]
        assert sorted(cells) == list(itertools.product(range(batch), range(ndir)))
        for ln in plan:
            threads = ln.rows * ln.units // 4
            groups = -(-(ln.r1 - ln.r0) // ln.rows)
            assert threads == lstm_cuda._b32_threads(ln.rows, ln.units)
            assert ln.units in (8, 16) and hidden % ln.units == 0
            assert ln.rows % lstm_cuda._B32_RT == 0 and threads % 32 == 0
            assert 32 <= threads <= 256
            assert ln.blocks == ln.nd * hidden // ln.units * groups <= SMS
            assert 2 <= ln.stages <= 6 and ln.smem <= SMEM_LIMIT
            assert ln.chunk in (64, 128) and 4 * hidden % ln.chunk == 0
            assert ln.smem == lstm_cuda.f32_bwd_smem_bytes(hidden, ln.units, ln.rows,
                                                           ln.stages, ln.chunk, with_dw)
            if with_dw:
                assert ln.nd == ndir
                assert lstm_cuda._b32_dw_stages(hidden, ln.units, ln.rows, ln.stages,
                                                ln.chunk) >= 2
        spans = sorted({(ln.r0, ln.r1) for ln in plan})
        assert all(r1 - r0 == spans[0][1] - spans[0][0] for r0, r1 in spans[:-1])


@pytest.mark.parametrize("sms", [SMS, 100, 60])
@pytest.mark.parametrize("with_dw", [False, True])
def test_bwd_fp32_plan_takes_every_shape_the_parent_took(sms, with_dw):
    """The earlier float32 plan (32 rows and 8 units a block) took every
    width the wrappers take where H / 8 blocks fit the SMs, and with dW_hh
    H <= 512 with all ndir x H / 8 blocks in one launch; the plan takes each
    of those shapes."""
    for hidden, ndir, batch in itertools.product(WIDTHS, (1, 2), (1, 33, 128, 300)):
        took = hidden // 8 <= sms and (not with_dw or (hidden <= 512 and ndir * hidden // 8 <= sms))
        if took:
            assert lstm_cuda.plan_bwd_launches("k", torch.float32, batch, hidden, ndir, sms,
                                               with_dw)


def test_bwd_fp32_dw_refuses_split_directions():
    # 2 x 32 blocks of 16 units at H=512 do not fit 60 SMs: lstm_bwd splits,
    # lstm_bwd_dw raises
    plan = lstm_cuda.plan_bwd_launches("k", torch.float32, 8, 512, 2, 60, False)
    assert {(ln.d0, ln.nd) for ln in plan} == {(0, 1), (1, 1)}
    with pytest.raises(ValueError, match="all directions in one launch"):
        lstm_cuda.plan_bwd_launches("k", torch.float32, 8, 512, 2, 60, True)


def test_bwd_fp32_shared_memory_bytes():
    # H=512, 16 units: the rings' bookkeeping (64 floats), W_hh rows 16 x
    # (2048 + 4), three stages of 64 rows x 128, the order of the 64 rows and
    # their lengths
    assert lstm_cuda.f32_bwd_smem_bytes(512, 16, 64, 3, 128, False) == 4 * (
        64 + 16 * 2052 + 3 * 64 * 128 + 2 * 64)
    # with dW_hh the product after the loop fits the same memory: 96 ints of
    # stage counts and six stages of 16 pairs x (512 + 64)
    assert lstm_cuda.f32_bwd_smem_bytes(512, 16, 64, 3, 128, True) == 4 * (
        64 + 16 * 2052 + 3 * 64 * 128 + 2 * 64)
    assert lstm_cuda._b32_dw_stages(512, 16, 64, 3, 128) == 6
    assert lstm_cuda._b32_dw_stages(512, 16, 64, 4, 64) == 5
    # H=1024, 8 units: three stages of 128 rows x 64
    assert lstm_cuda.f32_bwd_smem_bytes(1024, 8, 128, 3, 64, False) == 4 * (
        64 + 8 * 4100 + 3 * 128 * 64 + 2 * 128)
    # H=32, 16 units, 8 rows: the time loop's memory, 64 + 16 x 132 + 2 x 8 x
    # 64 + 16 floats, holds 32 ints of stage counts and two dW stages of 16 x 96
    assert lstm_cuda.f32_bwd_smem_bytes(32, 16, 8, 2, 64, True) == 4 * (
        64 + 16 * 132 + 2 * 8 * 64 + 16)
    assert lstm_cuda._b32_dw_stages(32, 16, 8, 2, 64) == 2


def test_bwd_fp32_takes_128_column_stages_where_they_fit():
    """Fewer, wider ring stages a step ran faster on the card: 128 columns
    wherever two stages of them fit beside W_hh's rows (H=512), else 64
    (H=1024, whose 128-row stages of 128 columns leave room for one)."""
    (ln,) = lstm_cuda.plan_bwd_launches("k", torch.float32, 128, 512, 2, SMS, False)
    assert ln.chunk == 128
    assert {ln.chunk for ln in lstm_cuda.plan_bwd_launches(
        "k", torch.float32, 128, 1024, 2, SMS, False)} == {64}
    assert lstm_cuda.f32_bwd_smem_bytes(1024, 8, 128, 2, 128, False) > SMEM_LIMIT


def test_bwd_fp32_constants_mirror_the_source():
    """The plan's constants are the float32 adjoint's (read from its text)."""
    with open(lstm_cuda.BWD_SOURCE) as fh:
        text = fh.read()
    for name in ("RT", "UT", "KS", "MAX_THREADS", "KC", "MAX_STAGES", "BOX_ROWS", "WPAD",
                 "DW_PAIRS"):
        value = getattr(lstm_cuda, f"_B32_{name}")
        assert re.search(rf"constexpr int B32_{name} = {value};", text), name
    assert re.search(rf"constexpr int B32_HEAD_FLOATS = {lstm_cuda._B32_HEAD_FLOATS};", text)
    # a lane keeps four cells of its tile after the sums
    assert lstm_cuda._B32_RT * lstm_cuda._B32_UT // lstm_cuda._B32_KS == 4


@pytest.mark.parametrize("dtype,batch,hidden,ndir,sms,with_dw", [
    (torch.bfloat16, 1, 32, 1, SMS, True), (torch.bfloat16, 257, 512, 2, SMS, True),
    (torch.bfloat16, 300, 1024, 2, 100, False), (torch.float32, 97, 1024, 2, SMS, False),
    (torch.float32, 33, 256, 2, SMS, True), (torch.bfloat16, 40, 640, 2, SMS, False)])
def test_bwd_every_row_and_direction_is_in_one_launch(dtype, batch, hidden, ndir, sms, with_dw):
    plan = lstm_cuda.plan_bwd_launches("k", dtype, batch, hidden, ndir, sms, with_dw)
    cells = [(r, d) for ln in plan for r in range(ln.r0, ln.r1)
             for d in range(ln.d0, ln.d0 + ln.nd)]
    assert sorted(cells) == list(itertools.product(range(batch), range(ndir)))
    # bfloat16: up to 128 rows a launch; float32: the row groups of R rows
    # that the SMs hold beside the launch's directions
    assert all(ln.blocks <= sms and ln.r1 - ln.r0 <= (
        128 if dtype == torch.bfloat16
        else ln.rows * max(1, sms // (ln.nd * hidden // ln.units))) for ln in plan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_dw", [False, True])
def test_bwd_shared_memory_fits_at_every_width(dtype, with_dw):
    for hidden in WIDTHS:
        if with_dw and hidden > 512:
            continue
        for batch in (1, 64, 65, 128):
            for ln in lstm_cuda.plan_bwd_launches("k", dtype, batch, hidden, 2, SMS, with_dw):
                assert ln.smem <= SMEM_LIMIT, (hidden, batch, ln)


def test_bwd_bf16_shared_memory_bytes():
    align, bars = 1024, 96
    stage128, stage64 = 128 * 128 * 2, 64 * 128 * 2
    # H=1024, 16 units: W_hh rows 16 x 4096 bf16; three 128-row stages fit
    assert lstm_cuda.bwd_tc_smem_bytes(128, 1024, 16, False) == (
        align + 131072 + 3 * stage128 + bars)
    # up to 64 rows: 64-row stages, five fit, and the 64 x 16 fp32 reduction tile
    assert lstm_cuda.bwd_tc_smem_bytes(64, 1024, 16, False) == (
        align + 131072 + 5 * stage64 + 4096 + bars)
    # H=512, 8 units, with dW_hh: the 128 x 8 hs tile; five stages beside it
    assert lstm_cuda.bwd_tc_smem_bytes(128, 512, 8, True) == (
        align + 32768 + 5 * stage128 + 2048 + bars)
    assert lstm_cuda.bwd_tc_smem_bytes(128, 512, 8, False) == (
        align + 32768 + 6 * stage128 + bars)
    # H=32: one stage a step, so one stage
    assert lstm_cuda.bwd_tc_smem_bytes(5, 32, 8, True) == (
        align + 2048 + stage64 + 1024 + 2048 + bars)
    # a row group of 64 rows at H=512, 16 units, with dW_hh: W_hh rows 16 x
    # 2048 bf16, six 64-row stages, the 64 x 16 hs tile and the 64 x 16 fp32
    # reduction tile
    assert lstm_cuda.bwd_tc_smem_bytes(64, 512, 16, True) == (
        align + 65536 + 6 * stage64 + 2048 + 4096 + bars)
    assert lstm_cuda.bwd_tc_smem_bytes(48, 512, 16, False) == (
        align + 65536 + 6 * stage64 + 4096 + bars)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hidden,with_dw,match", [
    (768, True, "hidden 768: the adjoint with dW_hh in the kernel takes H <= 512.*lstm_bwd's"),
    (1024, True, "hidden 1024: the adjoint with dW_hh in the kernel takes H <= 512.*lstm_bwd's"),
    (48, False, "hidden 48 must be a multiple of 32"),
    (48, True, "hidden 48 must be a multiple of 32"),
    (544, False, "hidden 544 above 512 must be a multiple of 64 and at most 1024"),
    (1088, False, "hidden 1088 above 512 must be a multiple of 64 and at most 1024"),
])
def test_bwd_refused_shapes_raise(dtype, hidden, with_dw, match):
    with pytest.raises(ValueError, match=match):
        lstm_cuda.plan_bwd_launches("k", dtype, 8, hidden, 2, SMS, with_dw)


def test_bwd_dw_refuses_split_directions():
    # 2 x 64 blocks at H=512 do not fit 100 SMs: lstm_bwd splits, lstm_bwd_dw raises
    plan = lstm_cuda.plan_bwd_launches("k", torch.bfloat16, 8, 512, 2, 100, False)
    assert _spans(plan) == [(0, 8, 0, 1), (0, 8, 1, 1)]
    with pytest.raises(ValueError, match="all directions in one launch"):
        lstm_cuda.plan_bwd_launches("k", torch.bfloat16, 8, 512, 2, 100, True)
