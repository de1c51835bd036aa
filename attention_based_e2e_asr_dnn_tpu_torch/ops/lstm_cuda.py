"""LSTM-recurrence kernels for Hopper (counterpart of the JAX
``ops/lstm_pallas.py``), with their plain versions and the autograd
Functions that join them.

The forward recurrence has two bodies: ``csrc/lstm_scan_tc_body.cuh`` for
bfloat16 (the recurrent dot on tensor cores, ``wgmma``), instantiated by
``csrc/lstm_scan_tc.cu`` and ``csrc/lstm_scan_tc_streams.cu``, and
``csrc/lstm_scan_body.cuh`` for float32 (CUDA-core FMAs, which keep float32's
tolerance), instantiated by ``csrc/lstm_scan.cu`` and
``csrc/lstm_scan_streams.cu``. Each wrapper takes either dtype and routes by
it. ``lstm_scan.cu`` / ``lstm_scan_tc.cu`` hold the forms with compile-time
switches for the input projection and the training streams:

  ``lstm_scan``          replaces ``_lstm_scan_nocs_kernel``
                         (lstm_pallas.py:87, via ``_forward_pallas`` with
                         ``with_cs=False``): the recurrence over a
                         precomputed ``x @ W_ih + b``;
  ``lstm_scan_fusedin``  replaces ``_lstm_scan_fusedin_kernel``
                         (lstm_pallas.py:854, via ``_fusedin_call`` with
                         ``train=False``): the same with the narrow input
                         projection (in_dim <= 128) done in the kernel;
  ``lstm_scan_train``,   replace ``_lstm_scan_train_kernel`` (lstm_pallas.py
  ``lstm_scan_fusedin_train``  :239, via ``_forward_pallas_train``) and
                         ``_fusedin_call`` with ``train=True``: the two above
                         with two more output streams, the carry ``cs`` (the
                         frozen carry at padded frames) and the activated
                         gates [i, f, g, o] in the stream dtype.

``csrc/lstm_scan_streams.cu`` / ``csrc/lstm_scan_tc_streams.cu`` hold two
further forms of that recurrence:

  ``lstm_scan_cs``       replaces ``_lstm_scan_kernel`` with ``with_cs=True``
                         (lstm_pallas.py:98, via ``_forward_pallas``):
                         ``lstm_scan`` with the carry stream ``cs`` beside hs
                         and no gates;
  ``bilstm_scan_fused``  replaces ``_bilstm_scan_kernel`` (lstm_pallas.py:1063,
                         via ``_forward_pallas_bi``): both directions in one
                         launch over xp (T, 2, B, 4H) with direction 1 flipped
                         in time, hs the carry itself (frozen at padded
                         frames, not zero) and cs, both (T, 2, B, H).
                         ``bilstm_apply_fused`` is the layer op on it (the JAX
                         ``bilstm_apply_pallas_fused``), and
                         ``_BilstmScanFused`` its gradient: the gates are
                         recomputed from (xp, hs) for all frames at once, then
                         ``lstm_bwd`` and ``dw_hh_outside``. The kernel takes
                         lengths, so only prefix masks (the op builds no
                         other), any batch of at least one row, and H <= 512:
                         a wider layer raises and is ``bilstm_apply_kernel``'s.

The adjoint has two bodies too: ``csrc/lstm_bwd_tc.cu`` for bfloat16 (both
products on tensor cores, the exchanged dpre streamed by TMA; body
``csrc/lstm_bwd_tc_body.cuh``) and ``csrc/lstm_bwd.cu`` for float32
(CUDA-core FMAs), each in two forms of one kernel:

  ``lstm_bwd_dw``        replaces ``_lstm_bwd_dw_kernel`` (lstm_pallas.py:382,
                         via ``_backward_pallas_dw``): the adjoint recurrence
                         in the opposite time order, ``dh_prev = dpre @
                         W_hh^T`` and the ``dW_hh`` sum inside the kernel;
                         H <= 512;
  ``lstm_bwd``           replaces ``_lstm_bwd_kernel`` (lstm_pallas.py:311,
                         via ``_backward_pallas``): the same recurrence
                         without the ``dW_hh`` sum, the route of wider layers
                         (H up to 1024). ``dw_hh_outside`` then forms
                         ``dW_hh`` as one ``torch.mm`` a direction over the
                         streamed hs and dpre, outside any kernel, as the JAX
                         package's ``_dw_outside_einsum`` does.

Each launch runs the whole time loop of one layer with the carry on chip;
the sources' headers say what bounds them and how they are laid out.
``plan_launches`` and ``plan_bwd_launches`` (pure, functions of dtype, B, H,
directions and SMs) say which launches a forward and an adjoint call make.
bfloat16: up to 128 batch rows and both directions in one launch at every
width up to H = 1024 (8 hidden units a block up to H = 512, 16 above: at most
128 blocks); a wider batch takes one launch per 128 rows. The float32
forward: blocks of R rows x U units (``_plan_f32``: R = 64, U = 16 at H =
256, B = 256), every row group and both directions in one launch up to the
card's SMs, more launches only for a batch the card cannot hold at once.
The float32 adjoint likewise (``_plan_bwd_f32``): blocks of R rows x U
units (R = 64, U = 16 at H = 512, B = 128: one launch of 128 blocks for both
directions; U = 8, R = 128 at H = 1024, one launch a direction), each row
group's partial ``dW_hh`` summed in a fixed order. A float32 layer whose
directions together need more blocks than the card has SMs (H = 1024: 2 x
128) takes one launch a direction (``_direction_groups``). Limits, checked
by the wrappers: H a multiple of 32 up to 512, a multiple of 64 from there
to 1024, the shared memory a block may use, ``lstm_bwd_dw`` only up to H =
512, ``bilstm_scan_fused`` only up to H = 512.
Each wrapper runs its plain PyTorch version for a CPU tensor, launches the
kernel for a CUDA tensor or raises, and counts its launches in ``LAUNCHES``.

``lstm_scan`` and ``lstm_scan_fusedin`` are differentiable: where a gradient
is wanted they go through a ``torch.autograd.Function`` whose forward is the
training kernel and whose backward is ``lstm_bwd_dw`` up to H = 512 and
``lstm_bwd`` plus ``dw_hh_outside`` for a wider layer (``_adjoint``, the JAX
``_adjoint_with_dw``'s routing); otherwise they launch the lean kernels, which
write neither ``cs`` nor the gates.

The libraries are built with ``nvcc`` at first use into ``_build/``
(``ops/cuda_build.py``, or all side by side by ``build_all``) and bound with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, NamedTuple, Sequence, Tuple

import torch

from attention_based_e2e_asr_dnn_tpu_torch.ops import cuda_build
from attention_based_e2e_asr_dnn_tpu_torch.ops.lstm import (
    FUSED_IN_MAX_DIM,
    directions_apply,
)
from attention_based_e2e_asr_dnn_tpu_torch.ops.masking import length_mask

SOURCE = os.path.join(cuda_build.CSRC, "lstm_scan.cu")
STREAMS_SOURCE = os.path.join(cuda_build.CSRC, "lstm_scan_streams.cu")
TC_SOURCE = os.path.join(cuda_build.CSRC, "lstm_scan_tc.cu")
TC_STREAMS_SOURCE = os.path.join(cuda_build.CSRC, "lstm_scan_tc_streams.cu")
BWD_SOURCE = os.path.join(cuda_build.CSRC, "lstm_bwd.cu")
BWD_TC_SOURCE = os.path.join(cuda_build.CSRC, "lstm_bwd_tc.cu")
SOURCES = (SOURCE, STREAMS_SOURCE, TC_SOURCE, TC_STREAMS_SOURCE, BWD_SOURCE, BWD_TC_SOURCE)

# the bfloat16 forward's and adjoint's hidden units a block up to H = 512
# (twice that above)
_TC_UNITS = 8
# the float32 forward's (csrc/lstm_scan_body.cuh): batch rows a thread
# carries, threads a block at most, columns of h a ring stage, the ring's
# most stages, a staged row's padding; the units a block the plan tries
_F32_RT = 4
_F32_MAX_THREADS = 256
_F32_KC = 64
_F32_MAX_STAGES = 4
_F32_PAD = 4
_F32_UNITS = (8, 16, 32, 64)
# the bfloat16 forward's (csrc/lstm_scan_tc_body.cuh): batch rows a launch,
# columns of h a ring stage, rows of the reduction tile, the tiles' alignment
_TC_ROWS = 128
_TC_KC = 64
_TC_RED_ROWS = 128
_TC_ALIGN = 1024
_TC_MAX_STAGES = 4
# the float32 adjoint's (csrc/lstm_bwd.cu): batch rows and hidden units of a
# thread's product tile, lanes that split its k range, threads a block at
# most, a narrow ring stage's columns (a plan's stages hold 1 or 2 x that),
# the ring's most stages, the rows of a TMA box of dpre at most, the padding
# of a unit's W_hh row, the (row, frame) pairs a dW stage holds, the floats
# of the rings' bookkeeping (mbarriers and counters); the units a block the
# plan tries
_B32_RT = 8
_B32_UT = 8
_B32_KS = 16
_B32_MAX_THREADS = 256
_B32_KC = 64
_B32_MAX_STAGES = 6
_B32_BOX_ROWS = 64
_B32_WPAD = 4
_B32_DW_PAIRS = 16
_B32_HEAD_FLOATS = 64
_B32_UNITS = (8, 16)
# the bfloat16 adjoint's (csrc/lstm_bwd_tc_body.cuh): columns of dpre a ring
# stage holds, its most stages, the mbarriers' bytes
_BT_SC = 128
_BT_MAX_STAGES = 6
_BT_BAR_BYTES = 2 * _BT_MAX_STAGES * 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# widest hidden size of the adjoint with dW_hh in the kernel (the JAX package's
# in-kernel-dW route ends there too, lstm_pallas.py:550; WIDE_FROM in
# csrc/lstm_common.cuh); the widest layer of any kernel; and the shared memory
# a block may use on the card
_BWD_DW_MAX_HIDDEN = 512
_MAX_HIDDEN = 1024
_SMEM_LIMIT = 232448

# launches of each kernel since the last reset
LAUNCHES = {"lstm_scan": 0, "lstm_scan_fusedin": 0, "lstm_scan_train": 0,
            "lstm_scan_fusedin_train": 0, "lstm_bwd_dw": 0, "lstm_bwd": 0,
            "lstm_scan_cs": 0, "bilstm_scan_fused": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

_i, _ll, _p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# the forward's C arguments before the stream: lstm_scan_launch's ...
_SCAN_ARGS = [_i, _i, _i, _i, _i, _i, _i, _i, _i,  # dtype fused train ndir rev B T D H
              _p, _ll, _ll, _ll,                   # x and its strides
              _p, _p, _p, _p,                      # w_ih bias w_hh lengths
              _p, _ll, _ll, _ll,                   # out and its strides
              _p, _p,                              # exchange buffer, cs
              _p, _ll, _ll, _ll]                   # gates and its strides
# ... and lstm_scan_streams_launch's
_STREAMS_ARGS = [_i, _i, _i, _i, _i, _i, _i,       # dtype bi ndir rev B T H
                 _p, _ll, _ll, _ll,                # x and its strides
                 _p, _p,                           # w_hh lengths
                 _p, _ll, _ll, _ll,                # out and its strides
                 _p, _p]                           # exchange buffer, cs
# the bfloat16 entries add the plan's units a block and the per-direction
# counters; the float32 entries the plan's units and rows a block, the ring's
# stages and the counters of each direction and row group
_TC_ARGS = [_i, _p]
_F32_ARGS = [_i, _i, _i, _p]


def _bind(source: str, entry: str, argtypes) -> ctypes.CDLL:
    """Build ``source`` (once per source version) and bind its C entry
    point, which takes ``argtypes`` and then the stream."""
    lib = ctypes.CDLL(cuda_build.build_library(source))
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes) + [_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """``csrc/lstm_scan.cu``: the float32 lean and training forms."""
    return _bind(SOURCE, "lstm_scan_launch", _SCAN_ARGS + _F32_ARGS)


@functools.lru_cache(maxsize=None)
def load_streams_library() -> ctypes.CDLL:
    """``csrc/lstm_scan_streams.cu``: the float32 hs + cs and fused
    bidirectional forms."""
    return _bind(STREAMS_SOURCE, "lstm_scan_streams_launch", _STREAMS_ARGS + _F32_ARGS)


@functools.lru_cache(maxsize=None)
def load_tc_library() -> ctypes.CDLL:
    """``csrc/lstm_scan_tc.cu``: the bfloat16 lean and training forms."""
    return _bind(TC_SOURCE, "lstm_scan_tc_launch", _SCAN_ARGS + _TC_ARGS)


@functools.lru_cache(maxsize=None)
def load_tc_streams_library() -> ctypes.CDLL:
    """``csrc/lstm_scan_tc_streams.cu``: the bfloat16 hs + cs and fused
    bidirectional forms."""
    return _bind(TC_STREAMS_SOURCE, "lstm_scan_tc_streams_launch", _STREAMS_ARGS + _TC_ARGS)


@functools.lru_cache(maxsize=None)
def load_bwd_library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """``csrc/lstm_bwd.cu``: the float32 adjoint, both forms (``defines``:
    an instrumented build's macros, as ``tools/trace_lstm_bwd.py`` asks)."""
    lib = ctypes.CDLL(cuda_build.build_library(BWD_SOURCE, defines))
    fn = lib.lstm_bwd_f32_launch
    fn.argtypes = [_i, _i, _i, _i, _i, _i, _i, _i,  # with_dw ndir rev dir0 grid_dirs B T H
                   _p, _p, _p, _p, _p, _p,          # gates cs hs dy w_hh lengths
                   _p, _p, _p,                      # dpre xbuf dw
                   _i, _i, _i, _i, _p, _p]          # units rows stages chunk, counters, stream
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_bwd_tc_library() -> ctypes.CDLL:
    """``csrc/lstm_bwd_tc.cu``: the bfloat16 adjoint, both forms."""
    return _bind(BWD_TC_SOURCE, "lstm_bwd_tc_launch",
                 [_i, _i, _i, _i, _i, _i, _i, _i,   # with_dw ndir rev dir0 grid_dirs B T H
                  _p, _p, _p, _p, _p, _p,           # gates cs hs dy w_hh lengths
                  _p, _p, _p, _i, _p])              # dpre xbuf dw, units, counters


LOADERS = (load_library, load_streams_library, load_tc_library, load_tc_streams_library,
           load_bwd_library, load_bwd_tc_library)


def row_chunks(batch: int, rows: int = 32) -> List[Tuple[int, int]]:
    """[start, end) row ranges of at most ``rows`` rows covering ``batch``."""
    return [(r0, min(r0 + rows, batch)) for r0 in range(0, batch, rows)]


def _direction_groups(name: str, ndir: int, hidden: int, sms: int,
                      units: int = _TC_UNITS) -> List[Tuple[int, int]]:
    """(first direction, count) of each launch: all directions in one
    cooperative launch where their ``ndir * H / units`` blocks are
    co-resident at one block an SM, else one launch a direction; raises
    where one direction alone does not fit."""
    if ndir * hidden // units <= sms:
        return [(0, ndir)]
    if hidden // units <= sms:
        return [(d, 1) for d in range(ndir)]
    raise ValueError(f"{name}: H={hidden} needs {hidden // units} co-resident "
                     f"blocks a direction, the card has {sms} SMs")


def _check_smem(name: str, hidden: int, smem: int) -> None:
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: hidden {hidden} needs {smem} bytes of shared "
                         f"memory a block, the card allows {_SMEM_LIMIT}")


def _check_hidden(name: str, hidden: int) -> None:
    """The widths every LSTM kernel takes."""
    if hidden % 32 != 0 or hidden < 32:
        raise ValueError(f"{name}: hidden {hidden} must be a multiple of 32")
    if hidden > _BWD_DW_MAX_HIDDEN and (hidden % 64 != 0 or hidden > _MAX_HIDDEN):
        raise ValueError(f"{name}: hidden {hidden} above {_BWD_DW_MAX_HIDDEN} must be "
                         f"a multiple of 64 and at most {_MAX_HIDDEN}")


def tc_units(hidden: int) -> int:
    """Hidden units a block of the bfloat16 forward takes: 8 up to H = 512,
    16 above, so that a direction needs at most 64 blocks and both fit one
    launch on a card of 128 SMs or more."""
    return _TC_UNITS if hidden <= _BWD_DW_MAX_HIDDEN else 2 * _TC_UNITS


def tc_smem_bytes(hidden: int, units: int, in_dim: int = 0) -> int:
    """Shared memory a block of the bfloat16 forward uses
    (``tc_smem_bytes`` in csrc/lstm_scan_tc_body.cuh): W_hh's 4U columns as
    bf16 in 64-wide k-chunks; under the fused input W_ih's columns (bf16) and
    the bias (fp32); the ring of h stages in what is left of the card's
    limit, whole 128-row stages of 64 columns, at most four and two more
    than h has chunks, at least the reduction tile it doubles as; and the slack
    that puts the swizzled tiles on a 1024-byte boundary."""
    n = 4 * units
    chunks = -(-hidden // _TC_KC)
    w = chunks * n * 128
    inputs = in_dim * n * 2 + n * 4 if in_dim else 0
    stage = _TC_ROWS * _TC_KC * 2
    room = max(_SMEM_LIMIT - _TC_ALIGN - w - inputs, 0) // stage
    ring = max(min(room, chunks + 2, _TC_MAX_STAGES) * stage, _TC_RED_ROWS * (n + 8) * 4)
    return _TC_ALIGN + w + ring + inputs


def f32_smem_bytes(hidden: int, units: int, rows: int, stages: int, in_dim: int = 0) -> int:
    """Shared memory a block of the float32 forward uses (``f32_smem_bytes``
    in csrc/lstm_scan_body.cuh): W_hh's 4U columns as fp32, the ring of
    ``stages`` stages of ``rows`` rows x 64 columns of h (rows padded by 4
    floats); under the fused input W_ih's columns, the bias and x_t's
    rows."""
    floats = hidden * units * 4 + stages * rows * (_F32_KC + _F32_PAD)
    if in_dim:
        floats += in_dim * units * 4 + units * 4 + in_dim * rows
    return 4 * floats


class Launch(NamedTuple):
    """One cooperative launch of the forward recurrence or of its adjoint."""
    r0: int      # first batch row
    r1: int      # one past the last
    d0: int      # first direction
    nd: int      # directions
    units: int   # hidden units a block
    blocks: int
    smem: int    # shared memory a block, bytes
    rows: int = 0    # float32: batch rows a block (its row group)
    stages: int = 0  # float32: the ring's stages
    chunk: int = 0   # float32 adjoint: columns of dpre a ring stage holds


def _f32_candidates(hidden: int, in_dim: int):
    """(units, rows, stages, smem) of every float32 forward block that takes
    ``hidden``: U dividing H, R a multiple of 4 with (R / 4) x U threads a
    multiple of 32 up to 256, and the most ring stages (up to four, at least
    two where h has two chunks) that fit the shared memory a block may use."""
    chunks = -(-hidden // _F32_KC)
    for units in _F32_UNITS:
        if hidden % units:
            continue
        rows = _F32_RT
        while rows // _F32_RT * units <= _F32_MAX_THREADS:
            threads = rows // _F32_RT * units
            if threads % 32 == 0:
                for stages in range(min(_F32_MAX_STAGES, chunks), min(2, chunks) - 1, -1):
                    smem = f32_smem_bytes(hidden, units, rows, stages, in_dim)
                    if smem <= _SMEM_LIMIT:
                        yield units, rows, stages, smem
                        break
            rows *= 2


def _f32_step_us(units: int, rows: int, hidden: int) -> float:
    """A rough time of one step of a float32 forward launch, to rank plans:
    the block's R x 4U x H FMAs at 32 a clock for each of its warps up to
    four (an SM's four schedulers) at 1.7 GHz, plus ~2 us that every step
    pays whatever its size (the wait for h, the first chunk's latency, the
    gates)."""
    warps = rows // _F32_RT * units // 32
    return rows * 4 * units * hidden / (32 * min(warps, 4)) / 1.7e3 + 2.0


def _plan_f32(name: str, batch: int, hidden: int, ndir: int, sms: int,
              in_dim: int) -> List[Launch]:
    """The float32 forward's launches: of the blocks ``_f32_candidates``
    gives, the plan whose launches x ``_f32_step_us`` (launches run one after
    another) is least, then the fewest launches, the fewest blocks, and 16
    units a block nearest. A launch holds every row group of R rows and
    every direction the card's SMs hold at once, one block an SM."""
    best = None
    for units, rows, stages, smem in _f32_candidates(hidden, in_dim):
        try:
            groups = _direction_groups(name, ndir, hidden, sms, units)
        except ValueError:
            continue
        per_group = groups[0][1] * hidden // units  # blocks of one row group
        row_groups = max(1, sms // per_group)
        span = row_groups * rows
        plan = [Launch(r0, min(r0 + span, batch), d0, nd, units,
                       nd * hidden // units * -(-(min(r0 + span, batch) - r0) // rows),
                       smem, rows, stages)
                for r0 in range(0, batch, span) for d0, nd in groups]
        key = (round(len(plan) * _f32_step_us(units, rows, hidden), 6), len(plan),
               max(ln.blocks for ln in plan), abs(units.bit_length() - 5))
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"{name}: hidden {hidden}, in_dim {in_dim}: no float32 block fits "
                         f"{_SMEM_LIMIT} bytes of shared memory on {sms} SMs")
    return best[1]


def plan_launches(name: str, dtype: torch.dtype, batch: int, hidden: int, ndir: int,
                  sms: int, in_dim: int = 0) -> List[Launch]:
    """The launches of the forward recurrence for a (batch, H, ndir) layer on
    a card of ``sms`` SMs; ``in_dim`` > 0 for the fused input projection.

    bfloat16 (the tensor-core body): up to 128 rows a launch, ``tc_units``
    units a block, all directions in one launch wherever their blocks fit
    the SMs. float32 (the CUDA-core body, ``_plan_f32``): blocks of R rows x
    U units, every row group and both directions in one launch wherever the
    SMs hold them (B=256 at H=256: one launch of 128 blocks); a launch a
    direction where both do not fit. Every (row, direction) is in exactly one
    launch. Raises a ``ValueError`` naming the limit for a width or a
    shared-memory need the kernels do not take."""
    _check_hidden(name, hidden)
    if in_dim > FUSED_IN_MAX_DIM:
        raise ValueError(f"{name}: in_dim {in_dim} > {FUSED_IN_MAX_DIM}")
    if dtype != torch.bfloat16:
        return _plan_f32(name, batch, hidden, ndir, sms, in_dim)
    units = tc_units(hidden)
    smem = tc_smem_bytes(hidden, units, in_dim)
    _check_smem(name, hidden, smem)
    groups = _direction_groups(name, ndir, hidden, sms, units)
    return [Launch(r0, r1, d0, nd, units, nd * hidden // units, smem)
            for r0, r1 in row_chunks(batch, _TC_ROWS) for d0, nd in groups]


def bwd_tc_smem_bytes(rows: int, hidden: int, units: int, with_dw: bool) -> int:
    """Shared memory a block of the bfloat16 adjoint uses in a launch of
    ``rows`` rows (``bt_smem_bytes`` in csrc/lstm_bwd_tc_body.cuh): W_hh's U
    rows as bf16; the ring, whole stages of the rows rounded up to 64 (64 or
    128) x 128 columns of dpre, in what is left of the card's limit, at most
    six and at most the stages of one step (4H / 128); with dW_hh the hs_t
    tile (rows x U bf16); up to 64 rows the reduction tile (64 x U fp32); the
    mbarriers; and the slack that puts the swizzled tiles on a 1024-byte
    boundary. At least one stage: a layer that leaves no room for one needs
    more than the limit."""
    box = 128 if rows > 64 else 64
    stage = box * _BT_SC * 2
    fixed = (_TC_ALIGN + 4 * hidden // 64 * units * 128
             + (box // 64 * units * 128 if with_dw else 0)
             + (0 if rows > 64 else 64 * units * 4) + _BT_BAR_BYTES)
    stages = min(max(_SMEM_LIMIT - fixed, 0) // stage, _BT_MAX_STAGES, 4 * hidden // _BT_SC)
    return fixed + max(stages, 1) * stage


def f32_bwd_smem_bytes(hidden: int, units: int, rows: int, stages: int, chunk: int,
                       with_dw: bool) -> int:
    """Shared memory a block of the float32 adjoint uses (``b32_smem_bytes``
    in csrc/lstm_bwd.cu): the rings' bookkeeping (64 floats); the time
    loop's W_hh rows of the U units, each 4H + 4 floats, the ring of
    ``stages`` stages of R rows x ``chunk`` floats of dpre, and the row
    group's order by length (2R ints); with dW_hh at least what the product
    after the loop needs in the same memory, the rows' stage counts (R + 1
    ints rounded up to 32) and two stages of 16 (row, frame) pairs x (H + 4U)
    floats."""
    floats = (_B32_HEAD_FLOATS + units * (4 * hidden + _B32_WPAD)
              + stages * rows * chunk + 2 * rows)
    if with_dw:
        floats = max(floats, _B32_HEAD_FLOATS + _b32_pre_floats(rows)
                     + 2 * _B32_DW_PAIRS * (hidden + 4 * units))
    return 4 * floats


def _b32_pre_floats(rows: int) -> int:
    """The row's dW stage counts, R + 1 ints rounded up to 128 bytes."""
    return (rows + 32) & ~31


def _b32_dw_stages(hidden: int, units: int, rows: int, stages: int, chunk: int) -> int:
    """The dW ring's stages (``b32_dw_stages``): as many as the block's
    memory holds beside the stage counts, at most 6."""
    room = (f32_bwd_smem_bytes(hidden, units, rows, stages, chunk, True) // 4
            - _B32_HEAD_FLOATS - _b32_pre_floats(rows))
    return min(room // (_B32_DW_PAIRS * (hidden + 4 * units)), _B32_MAX_STAGES)


def _b32_threads(rows: int, units: int) -> int:
    """Threads a block of the float32 adjoint: (R / 8) x (U / 8) tiles of 16
    lanes, R x U / 4 (``b32_threads``)."""
    return rows // _B32_RT * (units // _B32_UT) * _B32_KS


def _bwd_f32_candidates(hidden: int, with_dw: bool):
    """(units, rows, stages, chunk, smem) of every float32 adjoint block that
    takes ``hidden``: U of 8 or 16 dividing H, R a power of two from 8 with R
    x U / 4 threads a multiple of 32 up to 256, ring stages of 128 or 64
    columns, and for each the most stages (two to six) that fit the shared
    memory a block may use."""
    for units in _B32_UNITS:
        if hidden % units:
            continue
        rows = _B32_RT
        while _b32_threads(rows, units) <= _B32_MAX_THREADS:
            for chunk in (2 * _B32_KC, _B32_KC) if _b32_threads(rows, units) % 32 == 0 else ():
                for stages in range(min(_B32_MAX_STAGES, 4 * hidden // chunk), 1, -1):
                    smem = f32_bwd_smem_bytes(hidden, units, rows, stages, chunk, with_dw)
                    if smem <= _SMEM_LIMIT and (not with_dw or _b32_dw_stages(
                            hidden, units, rows, stages, chunk) >= 2):
                        yield units, rows, stages, chunk, smem
                        break
            rows *= 2


def _plan_bwd_f32(name: str, batch: int, hidden: int, ndir: int, sms: int,
                  with_dw: bool) -> List[Launch]:
    """The float32 adjoint's launches: of the blocks ``_bwd_f32_candidates``
    gives, the plan of the fewest launches, then of 16 units a block nearest,
    then of the most blocks, i.e. the fewest rows a block (on an H100 at
    H=256, B=128, 128 blocks of 32 rows ran ``lstm_bwd_dw`` 1.4x and
    ``lstm_bwd`` 1.2x faster than 64 blocks of 64, ``tools/time_lstm_kernels.py
    --hidden 256``); the first candidate of those (128-column stages before
    64). A launch holds every row group of R rows and every direction the
    card's SMs hold at once, one block an SM; with dW_hh only plans with every
    direction in one launch. Raises where no block fits."""
    best = None
    for units, rows, stages, chunk, smem in _bwd_f32_candidates(hidden, with_dw):
        try:
            groups = _direction_groups(name, ndir, hidden, sms, units)
        except ValueError:
            continue
        if with_dw and len(groups) > 1:
            continue
        per_group = groups[0][1] * hidden // units  # blocks of one row group
        row_groups = max(1, sms // per_group)
        span = row_groups * rows
        plan = [Launch(r0, min(r0 + span, batch), d0, nd, units,
                       nd * hidden // units * -(-(min(r0 + span, batch) - r0) // rows),
                       smem, rows, stages, chunk)
                for r0 in range(0, batch, span) for d0, nd in groups]
        key = (len(plan), abs(units.bit_length() - 5), -max(ln.blocks for ln in plan))
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        if with_dw:
            raise _dw_limit_error(name, ndir, hidden)
        raise ValueError(f"{name}: hidden {hidden}: no float32 adjoint block fits "
                         f"{_SMEM_LIMIT} bytes of shared memory on {sms} SMs")
    return best[1]


def _dw_limit_error(name: str, ndir: int, hidden: int) -> ValueError:
    return ValueError(
        f"{name}: {ndir} x hidden {hidden}: the adjoint with dW_hh in the kernel takes "
        f"H <= {_BWD_DW_MAX_HIDDEN} with all directions in one launch; a wider layer is "
        f"lstm_bwd's, with dw_hh_outside for dW_hh")


def plan_bwd_launches(name: str, dtype: torch.dtype, batch: int, hidden: int, ndir: int,
                      sms: int, with_dw: bool) -> List[Launch]:
    """The launches of the adjoint recurrence (``with_dw``: ``lstm_bwd_dw``,
    else ``lstm_bwd``) for a (batch, H, ndir) layer on a card of ``sms`` SMs.

    bfloat16 (the tensor-core body): up to 128 rows a launch, ``tc_units``
    units a block, all directions in one launch wherever their blocks fit
    the SMs. float32 (the CUDA-core body, ``_plan_bwd_f32``): blocks of R
    rows x U units, every row group and both directions in one launch
    wherever the SMs hold them (B=128 at H=512: one launch of 128 blocks, R
    = 64, U = 16), a launch a direction where both do not fit (H=1024: U = 8,
    R = 128), more launches only for a batch the card cannot hold at once.
    Every (row, direction) is in exactly one launch. The adjoint with dW_hh
    takes H <= 512 with all directions in one launch. Raises a
    ``ValueError`` naming the limit for a width or a shared-memory need the
    kernels do not take."""
    _check_hidden(name, hidden)
    if with_dw and hidden > _BWD_DW_MAX_HIDDEN:
        raise _dw_limit_error(name, ndir, hidden)
    if dtype != torch.bfloat16:
        return _plan_bwd_f32(name, batch, hidden, ndir, sms, with_dw)
    units = tc_units(hidden)
    groups = _direction_groups(name, ndir, hidden, sms, units)
    if with_dw and len(groups) > 1:
        raise _dw_limit_error(name, ndir, hidden)
    plan = []
    for r0, r1 in row_chunks(batch, _TC_ROWS):
        smem = bwd_tc_smem_bytes(r1 - r0, hidden, units, with_dw)
        _check_smem(name, hidden, smem)
        plan += [Launch(r0, r1, d0, nd, units, nd * hidden // units, smem) for d0, nd in groups]
    return plan


def _check_recurrence(name: str, ref: torch.Tensor, tensors, w_hh: torch.Tensor,
                      lengths: torch.Tensor, reverse: Tuple[bool, ...]):
    """The checks every kernel shares; returns (ndir, hidden, the card's
    SMs)."""
    if not ref.is_cuda:
        raise ValueError(f"{name}: kernel needs CUDA tensors, got {ref.device}")
    dtype = ref.dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != ref.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: all operands must be contiguous "
                             f"{dtype} on {ref.device}")
    ndir, hidden, four_h = w_hh.shape
    if four_h != 4 * hidden or len(reverse) != ndir:
        raise ValueError(f"{name}: w_hh {tuple(w_hh.shape)} must be "
                         f"(ndir, H, 4H) with one reverse flag per direction")
    if ref.shape[0] < 1:
        raise ValueError(f"{name}: empty batch")
    if ref.shape[1] < 1:
        raise ValueError(f"{name}: empty time axis")
    _check_hidden(name, hidden)
    sms = torch.cuda.get_device_properties(ref.device).multi_processor_count
    if lengths.shape != (ref.shape[0],):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} != "
                         f"({ref.shape[0]},)")
    return ndir, hidden, sms


def _forward_call(plan: List[Launch], name: str, dtype: torch.dtype, hidden: int, device,
                  call) -> None:
    """Run ``plan``: for each launch an exchange buffer (2, nd, rows, H) (in
    float32 its rows padded to whole row groups) and zeroed counters (nd in
    bfloat16, one a direction and row group in float32); ``call(launch,
    hbuf, extra, stream)`` makes the C call, ``extra`` being the entry's
    geometry and counters: (units, counters) in bfloat16, (units, rows,
    stages, counters) in float32. Counts the launches."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for ln in plan:
            rows = ln.r1 - ln.r0
            if dtype == torch.bfloat16:
                sync = torch.zeros(ln.nd, dtype=torch.int32, device=device)
                extra = (ln.units, sync.data_ptr())
            else:
                groups = -(-rows // ln.rows)
                rows = groups * ln.rows
                sync = torch.zeros(ln.nd * groups, dtype=torch.int32, device=device)
                extra = (ln.units, ln.rows, ln.stages, sync.data_ptr())
            hbuf = torch.empty(2, ln.nd, rows, hidden, dtype=dtype, device=device)
            err = call(ln, hbuf.data_ptr(), extra, stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError {err}")
            LAUNCHES[name] += 1


def _launch(name: str, fused: bool, train: bool, x: torch.Tensor, w_ih, b,
            w_hh: torch.Tensor, lengths: torch.Tensor,
            reverse: Tuple[bool, ...]):
    """Check shapes and launch the forward kernel as ``plan_launches`` plans
    it. Returns hs (B, T, ndir * H), and with ``train`` also cs (same shape)
    and gates (B, T, ndir * 4H)."""
    ndir, hidden, sms = _check_recurrence(
        name, x, [x, w_hh] + ([w_ih, b] if fused else []), w_hh, lengths, reverse)
    dtype, four_h = x.dtype, 4 * hidden
    batch, seq_len = x.shape[0], x.shape[1]
    in_dim = x.shape[2] if fused else 0
    if fused:
        if w_ih.shape != (ndir, in_dim, four_h) or b.shape != (ndir, four_h):
            raise ValueError(f"{name}: w_ih/b shapes {tuple(w_ih.shape)}, "
                             f"{tuple(b.shape)} do not match")
        x_strides = (0, seq_len * in_dim, in_dim)
    else:
        if x.shape[2] != ndir * four_h:
            raise ValueError(f"{name}: x_proj width {x.shape[2]} != "
                             f"{ndir} x 4H")
        x_strides = (four_h, seq_len * ndir * four_h, ndir * four_h)
    plan = plan_launches(name, dtype, batch, hidden, ndir, sms, in_dim)

    tc = dtype == torch.bfloat16
    fn = load_tc_library().lstm_scan_tc_launch if tc else load_library().lstm_scan_launch
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty(batch, seq_len, ndir * hidden, dtype=dtype, device=x.device)
    cs = torch.empty_like(out) if train else None
    gates = (torch.empty(batch, seq_len, ndir * four_h, dtype=dtype, device=x.device)
             if train else None)
    size = x.element_size()

    def call(ln, hbuf, extra, stream):
        # a launch sees its rows as rows 0.. and its directions as directions
        # 0.. of tensors that start at its first row and direction
        r0, r1, d0, nd = ln.r0, ln.r1, ln.d0, ln.nd
        rev_bits = sum(1 << d for d in range(nd) if reverse[d0 + d])
        return fn(
            _DTYPE_CODES[dtype], int(fused), int(train), nd, rev_bits,
            r1 - r0, seq_len, in_dim, hidden,
            x[r0:r1].data_ptr() + d0 * x_strides[0] * size, *x_strides,
            w_ih[d0].data_ptr() if fused else None,
            b[d0].data_ptr() if fused else None,
            w_hh[d0].data_ptr(), lengths[r0:r1].data_ptr(),
            out[r0:r1].data_ptr() + d0 * hidden * size,
            hidden, seq_len * ndir * hidden, ndir * hidden,
            hbuf,
            cs[r0:r1].data_ptr() + d0 * hidden * size if train else None,
            gates[r0:r1].data_ptr() + d0 * four_h * size if train else None,
            four_h, seq_len * ndir * four_h, ndir * four_h, *extra, stream)

    _forward_call(plan, name, dtype, hidden, x.device, call)
    return (out, cs, gates) if train else out


def _launch_streams(name: str, bi: bool, x: torch.Tensor, w_hh: torch.Tensor,
                    lengths: torch.Tensor, reverse: Tuple[bool, ...]):
    """Check shapes and launch a form of ``csrc/lstm_scan_streams.cu`` (float32)
    or ``csrc/lstm_scan_tc_streams.cu`` (bfloat16) as ``plan_launches`` plans
    it. ``bi``: x is xp (T, 2, B, 4H) and the outputs are (T, 2, B, H), both
    directions in every launch; else x is x_proj (B, T, ndir * 4H) and the
    outputs (B, T, ndir * H). Returns (hs, cs)."""
    if x.dim() != (4 if bi else 3):
        raise ValueError(f"{name}: input {tuple(x.shape)} must have "
                         f"{'(T, 2, B, 4H)' if bi else '(B, T, ndir x 4H)'} axes")
    by_row = x.permute(2, 0, 1, 3) if bi else x  # batch first, then time
    ndir, hidden, sms = _check_recurrence(name, by_row, [x, w_hh], w_hh, lengths, reverse)
    dtype, four_h = x.dtype, 4 * hidden
    batch, seq_len = by_row.shape[0], by_row.shape[1]
    if bi:
        if x.shape[1] != 2 or x.shape[3] != four_h or ndir != 2:
            raise ValueError(f"{name}: xp {tuple(x.shape)} must be (T, 2, B, 4H) for "
                             f"w_hh {tuple(w_hh.shape)}")
        plan = plan_launches(name, dtype, batch, hidden, ndir, sms)
        if hidden > _BWD_DW_MAX_HIDDEN or len({(ln.d0, ln.nd) for ln in plan}) > 1:
            raise ValueError(
                f"{name}: hidden {hidden}: both directions in one launch are taken up to "
                f"H = {_BWD_DW_MAX_HIDDEN}; a wider layer is bilstm_apply_kernel's, a "
                f"launch a direction in float32")
        x_strides = (batch * four_h, four_h, 2 * batch * four_h)
        o_strides = (batch * hidden, hidden, 2 * batch * hidden)
        out = torch.empty(seq_len, 2, batch, hidden, dtype=dtype, device=x.device)
    else:
        if x.shape[2] != ndir * four_h:
            raise ValueError(f"{name}: x_proj {tuple(x.shape)} must be (B, T, {ndir} x 4H)")
        plan = plan_launches(name, dtype, batch, hidden, ndir, sms)
        x_strides = (four_h, seq_len * ndir * four_h, ndir * four_h)
        o_strides = (hidden, seq_len * ndir * hidden, ndir * hidden)
        out = torch.empty(batch, seq_len, ndir * hidden, dtype=dtype, device=x.device)

    tc = dtype == torch.bfloat16
    fn = (load_tc_streams_library().lstm_scan_tc_streams_launch if tc
          else load_streams_library().lstm_scan_streams_launch)
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    cs = torch.empty_like(out)
    size = x.element_size()

    def call(ln, hbuf, extra, stream):
        # a launch sees rows r0.. as rows 0.. and its directions as directions
        # 0..: both are offsets of whole strides
        r0, r1, d0, nd = ln.r0, ln.r1, ln.d0, ln.nd
        rev_bits = sum(1 << d for d in range(nd) if reverse[d0 + d])
        x_off = (r0 * x_strides[1] + d0 * x_strides[0]) * size
        o_off = (r0 * o_strides[1] + d0 * o_strides[0]) * size
        return fn(_DTYPE_CODES[dtype], int(bi), nd, rev_bits, r1 - r0, seq_len, hidden,
                  x.data_ptr() + x_off, *x_strides, w_hh[d0].data_ptr(),
                  lengths[r0:r1].data_ptr(), out.data_ptr() + o_off, *o_strides,
                  hbuf, cs.data_ptr() + o_off, *extra, stream)

    _forward_call(plan, name, dtype, hidden, x.device, call)
    return out, cs


def _launch_adjoint(name: str, with_dw: bool, gates: torch.Tensor, cs: torch.Tensor, hs,
                    dy: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
                    reverse: Tuple[bool, ...]):
    """Check shapes and launch the adjoint as ``plan_bwd_launches`` plans it:
    bfloat16 on the tensor-core body (csrc/lstm_bwd_tc.cu), float32 on the
    CUDA-core body (csrc/lstm_bwd.cu). Returns dpre (B, T, ndir * 4H) and,
    ``with_dw``, d_whh (ndir, H, 4H) float32: the partial sums of the
    launches (bfloat16) or of the row groups (float32) added in row order
    (runs repeat bit for bit)."""
    ndir, hidden, sms = _check_recurrence(
        name, gates, [gates, cs, dy, w_hh] + ([hs] if with_dw else []), w_hh, lengths, reverse)
    streams = {"cs": cs, "dy": dy, **({"hs": hs} if with_dw else {})}
    _check_stream_shapes(name, gates, streams, ndir, hidden)
    batch, seq_len = gates.shape[0], gates.shape[1]
    plan = plan_bwd_launches(name, gates.dtype, batch, hidden, ndir, sms, with_dw)

    tc = gates.dtype == torch.bfloat16
    lib = load_bwd_tc_library() if tc else load_bwd_library()
    lengths = lengths.to(device=gates.device, dtype=torch.int32).contiguous()
    dpre = torch.empty_like(gates)
    # a launch's partial dW_hh: bfloat16 one a launch, float32 one a row group
    # (with dW_hh every launch holds every direction: one span each)
    parts = [-(-(ln.r1 - ln.r0) // ln.rows) if ln.rows else 1 for ln in plan]
    dw_parts = (torch.empty(sum(parts), ndir, hidden, 4 * hidden, dtype=torch.float32,
                            device=gates.device) if with_dw else None)
    rev_bits = sum(1 << d for d, r in enumerate(reverse) if r)
    with torch.cuda.device(gates.device):
        stream = torch.cuda.current_stream().cuda_stream
        for n, ln in enumerate(plan):
            r0, r1 = ln.r0, ln.r1
            rows = (gates[r0:r1].data_ptr(), cs[r0:r1].data_ptr())
            h_ptr = hs[r0:r1].data_ptr() if with_dw else None
            tail = (dy[r0:r1].data_ptr(), w_hh.data_ptr(), lengths[r0:r1].data_ptr(),
                    dpre[r0:r1].data_ptr())
            dw_ptr = dw_parts[sum(parts[:n])].data_ptr() if with_dw else None
            # the exchange: each step's dpre, double-buffered, a direction's rows
            # compact (float32: padded to whole row groups)
            xbuf = torch.empty(2, ln.nd, parts[n] * ln.rows if ln.rows else r1 - r0,
                               4 * hidden, dtype=gates.dtype, device=gates.device)
            sync = torch.zeros(ln.nd * parts[n], dtype=torch.int32, device=gates.device)
            if tc:
                err = lib.lstm_bwd_tc_launch(int(with_dw), ndir, rev_bits, ln.d0, ln.nd,
                                             r1 - r0, seq_len, hidden, *rows, h_ptr, *tail,
                                             xbuf.data_ptr(), dw_ptr, ln.units, sync.data_ptr(),
                                             stream)
            else:
                err = lib.lstm_bwd_f32_launch(int(with_dw), ndir, rev_bits, ln.d0, ln.nd,
                                              r1 - r0, seq_len, hidden, *rows, h_ptr, *tail,
                                              xbuf.data_ptr(), dw_ptr, ln.units, ln.rows,
                                              ln.stages, ln.chunk, sync.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed with cudaError {err}")
            LAUNCHES[name] += 1
    if not with_dw:
        return dpre
    d_whh = dw_parts[0]
    for n in range(1, dw_parts.shape[0]):  # a fixed order: runs repeat bit for bit
        d_whh = d_whh + dw_parts[n]
    return dpre, d_whh


def _launch_bwd(gates, cs, hs, dy, w_hh, lengths, reverse):
    """``lstm_bwd_dw`` on the card: (dpre, d_whh float32)."""
    return _launch_adjoint("lstm_bwd_dw", True, gates, cs, hs, dy, w_hh, lengths, reverse)


def _check_stream_shapes(name: str, gates: torch.Tensor, streams: dict, ndir: int,
                         hidden: int) -> None:
    batch, seq_len = gates.shape[0], gates.shape[1]
    if gates.shape != (batch, seq_len, ndir * 4 * hidden):
        raise ValueError(f"{name}: gates {tuple(gates.shape)} != (B, T, {ndir} x 4H)")
    for label, t in streams.items():
        if t.shape != (batch, seq_len, ndir * hidden):
            raise ValueError(f"{name}: {label} {tuple(t.shape)} != (B, T, {ndir} x H)")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _scan_plain(pre_x: torch.Tensor, w_hh: torch.Tensor, valid: torch.Tensor,
                reverse: bool, train: bool = False, zero_pads: bool = True):
    """One direction's recurrence in float32 over pre_x (B, T, 4H) float32;
    w_hh (H, 4H) in the weight dtype; ``valid`` (B, T) bool, any mask. Returns
    hs (B, T, H) float32, zero at padded frames or, without ``zero_pads``, the
    frozen carry there; and with ``train`` also cs (B, T, H) and the activated
    gates (B, T, 4H), zero at padded frames, both float32 (the caller rounds
    them to the stream dtype)."""
    batch, seq_len, _ = pre_x.shape
    hidden = w_hh.shape[0]
    w = w_hh.float()
    h = pre_x.new_zeros(batch, hidden)
    c = pre_x.new_zeros(batch, hidden)
    hs, cs, gates = [None] * seq_len, [None] * seq_len, [None] * seq_len
    steps = range(seq_len - 1, -1, -1) if reverse else range(seq_len)
    for t in steps:
        pre = pre_x[:, t] + h.to(w_hh.dtype).float() @ w
        act = torch.cat([torch.sigmoid(pre[:, :2 * hidden]),
                         torch.tanh(pre[:, 2 * hidden:3 * hidden]),
                         torch.sigmoid(pre[:, 3 * hidden:])], dim=-1)
        c_new = act[:, hidden:2 * hidden] * c + act[:, :hidden] * act[:, 2 * hidden:3 * hidden]
        h_new = act[:, 3 * hidden:] * torch.tanh(c_new)
        m = valid[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        hs[t] = torch.where(m, h_new, 0.0) if zero_pads else h
        if train:
            cs[t] = c
            gates[t] = torch.where(m, act, 0.0)
    hs = torch.stack(hs, dim=1)
    if train:
        return hs, torch.stack(cs, dim=1), torch.stack(gates, dim=1)
    return hs


def _directions_plain(pre_x_of, w_hh, lengths, seq_len, reverse, dtype, train):
    """Run ``_scan_plain`` per direction over ``pre_x_of(d)`` and join the
    directions side by side in ``dtype``."""
    valid = length_mask(lengths, seq_len)
    outs = [_scan_plain(pre_x_of(d), w_hh[d], valid, rev, train)
            for d, rev in enumerate(reverse)]
    if not train:
        return torch.cat(outs, dim=-1).to(dtype)
    return tuple(torch.cat([o[i] for o in outs], dim=-1).to(dtype) for i in range(3))


def lstm_scan_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    lengths: torch.Tensor,
                    reverse: Sequence[bool]) -> torch.Tensor:
    """Plain version of ``lstm_scan``."""
    four_h = w_hh.shape[2]
    return _directions_plain(
        lambda d: x_proj[..., d * four_h:(d + 1) * four_h].float(), w_hh, lengths,
        x_proj.shape[1], reverse, x_proj.dtype, train=False)


def lstm_scan_fusedin_plain(x: torch.Tensor, w_ih: torch.Tensor,
                            b: torch.Tensor, w_hh: torch.Tensor,
                            lengths: torch.Tensor,
                            reverse: Sequence[bool]) -> torch.Tensor:
    """Plain version of ``lstm_scan_fusedin``: the input projection in
    float32, ``(x @ W_ih + b) + h @ W_hh`` as the Pallas kernel sums it."""
    return _directions_plain(
        lambda d: x.float() @ w_ih[d].float() + b[d].float(), w_hh, lengths,
        x.shape[1], reverse, x.dtype, train=False)


def lstm_scan_train_plain(x_proj, w_hh, lengths, reverse):
    """Plain version of ``lstm_scan_train``: (hs, cs, gates) in x_proj's
    dtype, gates (B, T, ndir * 4H) with each direction's [i, f, g, o] side by
    side."""
    four_h = w_hh.shape[2]
    return _directions_plain(
        lambda d: x_proj[..., d * four_h:(d + 1) * four_h].float(), w_hh, lengths,
        x_proj.shape[1], reverse, x_proj.dtype, train=True)


def lstm_scan_cs_plain(x_proj, w_hh, lengths, reverse):
    """Plain version of ``lstm_scan_cs``: ``lstm_scan_train_plain`` without
    its gates."""
    return lstm_scan_train_plain(x_proj, w_hh, lengths, reverse)[:2]


def bilstm_scan_fused_plain(xp: torch.Tensor, w_hh: torch.Tensor,
                            lengths: torch.Tensor):
    """Plain version of ``bilstm_scan_fused``: both streams walked ascending,
    direction 1 under the flipped mask (its padded frames first); hs is the
    carry h, frozen at padded frames; (hs, cs), each (T, 2, B, H) in xp's
    dtype."""
    valid = length_mask(lengths, xp.shape[0])
    outs = [_scan_plain(xp[:, d].transpose(0, 1).float(), w_hh[d],
                        valid.flip(1) if d else valid, False, train=True, zero_pads=False)
            for d in range(2)]
    return tuple(torch.stack([o[i].transpose(0, 1) for o in outs], dim=1).to(xp.dtype)
                 for i in range(2))


def lstm_scan_fusedin_train_plain(x, w_ih, b, w_hh, lengths, reverse):
    """Plain version of ``lstm_scan_fusedin_train``."""
    return _directions_plain(
        lambda d: x.float() @ w_ih[d].float() + b[d].float(), w_hh, lengths,
        x.shape[1], reverse, x.dtype, train=True)


def lstm_bwd_dw_plain(gates: torch.Tensor, cs: torch.Tensor, hs: torch.Tensor,
                      dy: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
                      reverse: Sequence[bool]):
    """Plain version of ``lstm_bwd_dw``: the adjoint recurrence written out,
    one step at a time in the order opposite to the forward scan, with the
    kernel's roundings (saved streams and dpre in the stream dtype, the
    rounded dpre as the operand of both products, float32 sums and carries).
    Not autograd through the forward loop, which would round nowhere."""
    return _bwd_plain(gates, cs, hs, dy, w_hh, lengths, reverse)


def lstm_bwd_plain(gates: torch.Tensor, cs: torch.Tensor, dy: torch.Tensor,
                   w_hh: torch.Tensor, lengths: torch.Tensor,
                   reverse: Sequence[bool]) -> torch.Tensor:
    """Plain version of ``lstm_bwd``: the same loop as ``lstm_bwd_dw_plain``
    without the ``dW_hh`` sum; dpre is rounded to the stream dtype before it
    is the operand of ``dpre @ W_hh^T``, as the Pallas kernel rounds it
    (lstm_pallas.py:358)."""
    return _bwd_plain(gates, cs, None, dy, w_hh, lengths, reverse)


def _bwd_plain(gates, cs, hs, dy, w_hh, lengths, reverse):
    """The adjoint loop; with ``hs`` it also sums dW_hh and returns (dpre,
    d_whh), without it dpre alone."""
    dtype = gates.dtype
    ndir, hidden, four_h = w_hh.shape
    batch, seq_len = gates.shape[0], gates.shape[1]
    valid = length_mask(lengths, seq_len)
    dpre = torch.zeros_like(gates)
    d_whh = torch.zeros(ndir, hidden, four_h, dtype=torch.float32, device=gates.device)
    for d, rev in enumerate(reverse):
        wt = w_hh[d].float().T                      # (4H, H)
        g_d = gates[..., d * four_h:(d + 1) * four_h]
        cs_d, dy_d = (t[..., d * hidden:(d + 1) * hidden] for t in (cs, dy))
        dh = torch.zeros(batch, hidden, dtype=torch.float32, device=gates.device)
        dc = torch.zeros_like(dh)
        for t in (range(seq_len) if rev else range(seq_len - 1, -1, -1)):
            t_prev = t + 1 if rev else t - 1        # the forward scan's previous frame
            has_prev = 0 <= t_prev < seq_len
            i, f, g, o = g_d[:, t].float().split(hidden, dim=-1)
            c_t = cs_d[:, t].float()
            c_p = cs_d[:, t_prev].float() if has_prev else torch.zeros_like(c_t)
            m = valid[:, t, None]
            tanh_ct = torch.tanh(c_t)
            dh_total = torch.where(m, dy_d[:, t].float(), 0.0) + dh
            dc_total = dc + dh_total * o * (1.0 - tanh_ct * tanh_ct)
            step = torch.cat([dc_total * g * i * (1.0 - i),
                              dc_total * c_p * f * (1.0 - f),
                              dc_total * i * (1.0 - g * g),
                              dh_total * tanh_ct * o * (1.0 - o)], dim=-1)
            step = torch.where(m, step, 0.0).to(dtype)
            dpre[:, t, d * four_h:(d + 1) * four_h] = step
            step = step.float()
            if has_prev and hs is not None:
                d_whh[d] += hs[:, t_prev, d * hidden:(d + 1) * hidden].float().T @ step
            dh = torch.where(m, step @ wt, dh_total)
            dc = torch.where(m, dc_total * f, dc)
    return dpre if hs is None else (dpre, d_whh)


def dw_hh_outside(hs: torch.Tensor, dpre: torch.Tensor,
                  reverse: Sequence[bool]) -> torch.Tensor:
    """dW_hh from the streamed hs (B, T, ndir * H) and dpre (B, T, ndir * 4H)
    as one product a direction over all B x (T - 1) rows, outside any kernel
    (the JAX ``_dw_outside_einsum``, sliced form: the scan's first frame pairs
    with h = 0 and is left out). Operands in the stream dtype, float32 sums,
    (ndir, H, 4H) float32."""
    ndir = len(reverse)
    hidden, four_h = hs.shape[2] // ndir, dpre.shape[2] // ndir
    out = []
    for d, rev in enumerate(reverse):
        h_d = hs[..., d * hidden:(d + 1) * hidden]
        p_d = dpre[..., d * four_h:(d + 1) * four_h]
        # the scan-previous frame of t is t + 1 in a descending scan, else t - 1
        h_d, p_d = (h_d[:, 1:], p_d[:, :-1]) if rev else (h_d[:, :-1], p_d[:, 1:])
        out.append(_mm_f32(h_d.reshape(-1, hidden).T, p_d.reshape(-1, four_h)))
    return torch.stack(out)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with operands in their own dtype, float32 sums and a float32
    result."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # the CPU has no mixed-precision product: the same sums in float32
    return torch.mm(a.float(), b.float())


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def lstm_scan_train(x_proj, w_hh, lengths, reverse):
    """The training forward over a precomputed projection: ``lstm_scan``'s
    arguments -> (hs, cs, gates). hs as ``lstm_scan`` gives it; cs (B, T,
    ndir * H) the carry c after each frame, the frozen carry at padded
    frames; gates (B, T, ndir * 4H) the activated [i, f, g, o] of each
    direction, zero at padded frames; all in x_proj's dtype."""
    if x_proj.device.type == "cpu":
        return lstm_scan_train_plain(x_proj, w_hh, lengths, reverse)
    return _launch("lstm_scan_train", False, True, x_proj, None, None, w_hh,
                   lengths, tuple(reverse))


def lstm_scan_fusedin_train(x, w_ih, b, w_hh, lengths, reverse):
    """The training forward with the input projection in the kernel:
    ``lstm_scan_fusedin``'s arguments -> (hs, cs, gates)."""
    if x.device.type == "cpu":
        return lstm_scan_fusedin_train_plain(x, w_ih, b, w_hh, lengths, reverse)
    return _launch("lstm_scan_fusedin_train", True, True, x, w_ih, b, w_hh,
                   lengths, tuple(reverse))


def lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, reverse):
    """The adjoint recurrence with dW_hh: the training forward's streams
    (gates, cs, hs), the gradient dy of hs (B, T, ndir * H) in the stream
    dtype, w_hh (ndir, H, 4H), lengths, the forward's ``reverse`` flags ->
    (dpre (B, T, ndir * 4H) in the stream dtype, the gradient of the
    pre-activations, zero at padded frames; d_whh (ndir, H, 4H) float32)."""
    if gates.device.type == "cpu":
        return lstm_bwd_dw_plain(gates, cs, hs, dy, w_hh, lengths, reverse)
    return _launch_bwd(gates, cs, hs, dy, w_hh, lengths, tuple(reverse))


def lstm_bwd(gates, cs, dy, w_hh, lengths, reverse) -> torch.Tensor:
    """The adjoint recurrence without dW_hh, for layers up to H = 1024:
    ``lstm_bwd_dw``'s arguments less hs -> dpre (B, T, ndir * 4H) in the
    stream dtype. ``dw_hh_outside(hs, dpre, reverse)`` gives dW_hh."""
    if gates.device.type == "cpu":
        return lstm_bwd_plain(gates, cs, dy, w_hh, lengths, reverse)
    return _launch_adjoint("lstm_bwd", False, gates, cs, None, dy, w_hh, lengths,
                           tuple(reverse))


def lstm_scan_cs(x_proj: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
                 reverse: Sequence[bool]):
    """``lstm_scan`` with the carry stream: ``lstm_scan``'s arguments ->
    (hs, cs), hs as ``lstm_scan`` gives it bit for bit, cs (B, T, ndir * H)
    as ``lstm_scan_train`` gives it (the carry c after each frame, frozen at
    padded frames), in x_proj's dtype. Not differentiable."""
    if x_proj.device.type == "cpu":
        return lstm_scan_cs_plain(x_proj, w_hh, lengths, reverse)
    return _launch_streams("lstm_scan_cs", False, x_proj, w_hh, lengths, tuple(reverse))


def bilstm_scan_fused(xp: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor):
    """Both directions of a BiLSTM layer in one launch (a launch per 128 rows
    in bfloat16; in float32 every row the card holds at once).

    xp (T, 2, B, 4H): each direction's ``x @ W_ih + b``, direction 1 flipped
    in time as a whole (so a row's padded frames come first in it); w_hh
    (2, H, 4H); lengths (B,). Returns (hs, cs), each (T, 2, B, H) in xp's
    dtype and in the streams' own time order: the carries h and c after each
    frame, frozen at padded frames (direction 0 holds the row's last valid h
    and c there, direction 1 zeros). Not differentiable: ``_BilstmScanFused``
    is. H <= 512 on the card."""
    if xp.device.type == "cpu":
        return bilstm_scan_fused_plain(xp, w_hh, lengths)
    return _launch_streams("bilstm_scan_fused", True, xp, w_hh, lengths, (False, False))


def _adjoint(gates, cs, hs, dy, w_hh, lengths, reverse):
    """(dpre, d_whh float32), routed by width as the JAX ``_adjoint_with_dw``
    routes: up to H = 512 the kernel that sums dW_hh itself, wider the kernel
    without it and the outside product."""
    if w_hh.shape[1] <= _BWD_DW_MAX_HIDDEN:
        return lstm_bwd_dw(gates, cs, hs, dy, w_hh, lengths, reverse)
    dpre = lstm_bwd(gates, cs, dy, w_hh, lengths, reverse)
    return dpre, dw_hh_outside(hs, dpre, reverse)


class _LstmScan(torch.autograd.Function):
    """``lstm_scan`` under autograd (the JAX ``pallas_lstm_scan`` custom
    VJP): forward the training kernel, backward the adjoint kernel of the
    layer's width (``_adjoint``)."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, lengths, reverse):
        hs, cs, gates = lstm_scan_train(x_proj, w_hh, lengths, reverse)
        ctx.save_for_backward(w_hh, lengths, hs, cs, gates)
        ctx.reverse = reverse
        return hs

    @staticmethod
    def backward(ctx, d_hs):
        w_hh, lengths, hs, cs, gates = ctx.saved_tensors
        dpre, d_whh = _adjoint(gates, cs, hs, d_hs.to(gates.dtype).contiguous(),
                               w_hh, lengths, ctx.reverse)
        return dpre, d_whh.to(w_hh.dtype), None, None


class _LstmScanFusedin(torch.autograd.Function):
    """``lstm_scan_fusedin`` under autograd (the JAX
    ``pallas_lstm_scan_fusedin`` custom VJP). The gradients of the input
    projection are plain products over the streamed dpre, outside any kernel
    as in the JAX package: one direction at a time, float32 sums, results in
    the stream dtype."""

    @staticmethod
    def forward(ctx, x, w_ih, b, w_hh, lengths, reverse):
        hs, cs, gates = lstm_scan_fusedin_train(x, w_ih, b, w_hh, lengths, reverse)
        ctx.save_for_backward(x, w_ih, w_hh, lengths, hs, cs, gates)
        ctx.reverse = reverse
        return hs

    @staticmethod
    def backward(ctx, d_hs):
        x, w_ih, w_hh, lengths, hs, cs, gates = ctx.saved_tensors
        dtype = gates.dtype
        dpre, d_whh = _adjoint(gates, cs, hs, d_hs.to(dtype).contiguous(),
                               w_hh, lengths, ctx.reverse)
        ndir, in_dim, four_h = w_ih.shape
        x2 = x.reshape(-1, in_dim)
        d_x, d_wih, d_b = None, [], []
        for d in range(ndir):
            dp = dpre[..., d * four_h:(d + 1) * four_h].reshape(-1, four_h)
            d_wih.append(x2.T @ dp)
            d_b.append(dp.sum(0, dtype=torch.float32).to(dtype))
            if ctx.needs_input_grad[0]:
                part = (dp @ w_ih[d].T).reshape(x.shape)
                d_x = part if d_x is None else d_x + part
        return (d_x, torch.stack(d_wih), torch.stack(d_b), d_whh.to(w_hh.dtype),
                None, None)


def _streams_to_natural(t: torch.Tensor) -> torch.Tensor:
    """(T, 2, B, W) in the fused kernel's layout -> (B, T, 2W) with both
    directions in natural time, side by side (the other kernels' layout)."""
    return torch.cat([t[:, 0], t[:, 1].flip(0)], dim=-1).transpose(0, 1).contiguous()


def _natural_to_streams(t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_streams_to_natural``."""
    width = t.shape[2] // 2
    by_time = t.transpose(0, 1)
    return torch.stack([by_time[..., :width], by_time[..., width:].flip(0)], dim=1)


class _BilstmScanFused(torch.autograd.Function):
    """``bilstm_scan_fused`` under autograd (the JAX ``pallas_bilstm_scan``
    custom VJP): (xp, w_hh, lengths) -> hs, differentiable in xp and w_hh.

    The forward saves (xp, hs, cs) and no gates, as the JAX one does. The
    backward recomputes the pre-activations of every frame at once (hs is
    saved, so ``xp + h_prev @ W_hh`` is one product a direction and nothing
    is sequential), activates them in float32, rounds them to the stream
    dtype and zeroes them at padded frames: the gates stream of the training
    forward. Then the adjoint recurrence is ``lstm_bwd`` and dW_hh is
    ``dw_hh_outside``, on the streams brought into natural time, where
    direction 1 is an ordinary descending direction. A cotangent on hs at one
    of direction 0's padded frames belongs to the frozen carry and so to the
    row's last valid frame: it is added there before the launch (``lstm_bwd``
    ignores cotangents at padded frames); one at direction 1's padded frames
    meets the constant zero carry and is dropped."""

    @staticmethod
    def forward(ctx, xp, w_hh, lengths):
        hs, cs = bilstm_scan_fused(xp, w_hh, lengths)
        ctx.save_for_backward(xp, w_hh, lengths, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, d_hs):
        xp, w_hh, lengths, hs, cs = ctx.saved_tensors
        dtype, (seq_len, _, batch, four_h) = xp.dtype, xp.shape
        hidden = four_h // 4
        reverse = (False, True)
        xp_n, hs_n, cs_n = (_streams_to_natural(t) for t in (xp, hs, cs))
        valid = length_mask(lengths, seq_len)

        # direction 0's cotangents at padded frames, onto the last valid frame
        dy = _streams_to_natural(d_hs.float())
        tail = torch.where(valid[:, :, None], 0.0, dy[..., :hidden]).sum(1)
        last = (lengths.long() - 1).clamp(min=0)
        rows = torch.arange(batch, device=dy.device)
        dy[rows, last, :hidden] += torch.where((lengths > 0)[:, None], tail, 0.0)
        dy = dy.to(dtype)

        # the gates of every frame from the saved hs: the scan-previous frame
        # of t is t - 1 for direction 0 and t + 1 for direction 1
        zero = hs_n.new_zeros(batch, 1, hidden)
        gates = []
        for d in range(2):
            h_d = hs_n[..., d * hidden:(d + 1) * hidden]
            h_prev = (torch.cat([h_d[:, 1:], zero], dim=1) if d
                      else torch.cat([zero, h_d[:, :-1]], dim=1))
            pre = (xp_n[..., d * four_h:(d + 1) * four_h].float()
                   + _mm_f32(h_prev.reshape(-1, hidden), w_hh[d]).view(batch, seq_len, four_h))
            act = torch.cat([torch.sigmoid(pre[..., :2 * hidden]),
                             torch.tanh(pre[..., 2 * hidden:3 * hidden]),
                             torch.sigmoid(pre[..., 3 * hidden:])], dim=-1)
            gates.append(torch.where(valid[:, :, None], act, 0.0).to(dtype))
        gates = torch.cat(gates, dim=-1)

        dpre = lstm_bwd(gates, cs_n, dy, w_hh, lengths, reverse)
        d_whh = dw_hh_outside(hs_n, dpre, reverse)
        return _natural_to_streams(dpre), d_whh.to(w_hh.dtype), None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor,
              reverse: Sequence[bool]) -> torch.Tensor:
    """LSTM recurrence over a precomputed projection, one or more directions.

    x_proj (B, T, ndir * 4H) = ``x @ W_ih + b`` of each direction side by
    side; w_hh (ndir, H, 4H); lengths (B,); ``reverse[d]`` walks direction d
    in descending time. Returns (B, T, ndir * H), zero at padded frames, in
    x_proj's dtype. Differentiable in x_proj and w_hh."""
    if _wants_grad(x_proj, w_hh):
        return _LstmScan.apply(x_proj, w_hh, lengths, tuple(reverse))
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh, lengths, reverse)
    return _launch("lstm_scan", False, False, x_proj, None, None, w_hh, lengths,
                   tuple(reverse))


def lstm_scan_fusedin(x: torch.Tensor, w_ih: torch.Tensor, b: torch.Tensor,
                      w_hh: torch.Tensor, lengths: torch.Tensor,
                      reverse: Sequence[bool]) -> torch.Tensor:
    """LSTM recurrence with the input projection in the kernel.

    x (B, T, D) with D <= 128, shared by the directions; w_ih (ndir, D, 4H);
    b (ndir, 4H); w_hh (ndir, H, 4H). Otherwise as ``lstm_scan``.
    Differentiable in x, w_ih, b and w_hh."""
    if _wants_grad(x, w_ih, b, w_hh):
        return _LstmScanFusedin.apply(x, w_ih, b, w_hh, lengths, tuple(reverse))
    if x.device.type == "cpu":
        return lstm_scan_fusedin_plain(x, w_ih, b, w_hh, lengths, reverse)
    return _launch("lstm_scan_fusedin", True, False, x, w_ih, b, w_hh, lengths,
                   tuple(reverse))


def lstm_apply_kernel(params, x: torch.Tensor, lengths: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """``lstm_apply_pallas``'s contract on the kernels: (B, T, D) ->
    (B, T, H), zero at pads; in_dim <= 128 takes the fused-input kernel."""
    return directions_apply([params], x, lengths, (reverse,),
                            lstm_scan_fusedin, lstm_scan)


def bilstm_apply_kernel(params, x: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """``bilstm_apply_pallas``'s contract, both directions in one launch:
    (B, T, D) -> (B, T, 2H) = [fwd, bwd]."""
    return directions_apply([params["fwd"], params["bwd"]], x, lengths,
                            (False, True), lstm_scan_fusedin, lstm_scan)


def bilstm_apply_fused(params, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``bilstm_apply_pallas_fused``'s contract: (B, T, D) -> (B, T, 2H) =
    [fwd, bwd], zero at padded frames, on the fused bidirectional kernel.

    One product projects the input for both directions (W_ih concatenated on
    the output axis); direction 1's projection is flipped in time and both are
    laid out as (T, 2, B, 4H); ``bilstm_scan_fused`` runs the recurrence;
    direction 1's states are flipped back, and the padded frames, where the
    kernel leaves the frozen carry, are zeroed. Differentiable in x and the
    parameters (``_BilstmScanFused``). The JAX package keeps this op beside
    ``bilstm_apply_pallas`` as the small-batch variant and routes no config
    key to it; neither does this package."""
    dtype = x.dtype
    seq_len = x.shape[1]
    fwd, bwd = params["fwd"], params["bwd"]
    four_h = 4 * fwd["w_hh"].shape[0]
    w_ih = torch.cat([fwd["w_ih"], bwd["w_ih"]], dim=1).to(dtype)
    b = torch.cat([fwd["b"], bwd["b"]]).to(dtype)
    xp_cat = torch.matmul(x, w_ih) + b
    xp = torch.stack([xp_cat[..., :four_h], xp_cat[..., four_h:].flip(1)], dim=0)
    xp = xp.permute(2, 0, 1, 3).contiguous()                       # (T, 2, B, 4H)
    w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]]).to(dtype)
    if _wants_grad(xp, w_hh):
        hs = _BilstmScanFused.apply(xp, w_hh, lengths)
    else:
        hs, _ = bilstm_scan_fused(xp, w_hh, lengths)
    h_fwd = hs[:, 0].transpose(0, 1)                                # (B, T, H)
    h_bwd = hs[:, 1].transpose(0, 1).flip(1)
    valid = length_mask(lengths, seq_len)
    return torch.cat([h_fwd, h_bwd], dim=-1) * valid[:, :, None].to(dtype)
