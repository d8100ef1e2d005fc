"""The launch plans of kernels B1 (``ops/conv_bn.py`` ``_plan``) and B3
(``ops/quant_ops.py`` ``_plan``), which the wrappers size their scratch
by and whose tile id the C entries take, on the CPU: at every shape of
the ResNet-50 step and of the int8 serving path, and at ragged shapes,
the grid covers each output element exactly once, the scratch holds
every partial sum, transposed weight and quantized row the kernels
touch, the grid fills the H100's SMs where the tiles allow it, and the
tile constants hard-coded in the CUDA sources agree with Python's."""

import os
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import conv_bn, quant_ops
from paddle_tpu_torch.probes import conv_bn as b1_probe
from paddle_tpu_torch.probes import int8 as b3_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
SMS = 132

# B1: (N, C, O, H, W) of the ResNet-50 step at batch 256, and ragged
# shapes: pixel tiles across images with P % 4 != 0 and == 0, C off the
# 16-deep stages, O off the tiles
B1_PATH = [(256, c, o, h, h) for c, o, h in (
    (64, 64, 56), (64, 256, 56), (256, 64, 56), (512, 128, 28),
    (128, 512, 28), (1024, 256, 14), (256, 1024, 14), (2048, 512, 7),
    (512, 2048, 7))]
B1_RAGGED = [(3, 37, 19, 5, 7), (2, 5, 130, 1, 1), (7, 96, 40, 9, 11),
             (5, 72, 136, 6, 6), (9, 130, 200, 7, 7), (1, 1, 1, 1, 1)]
# B3: (m, k, n) of the int8 session (decode m 8, prefill windows padded
# to the buckets 128 and 512, the LM head at m 8 and 1), and ragged
B3_PATH = [(m, k, n) for m in (8, 128, 512)
           for k, n in ((2048, 2048), (2048, 8192), (8192, 2048))] \
    + [(8, 2048, 32768), (1, 2048, 32768)]
B3_RAGGED = [(3, 200, 72), (5, 37, 19), (17, 100, 33), (16, 64, 64),
             (600, 130, 1000), (1000, 130, 2001)]
# (tile id, tile table) per B1 launch: the plan's own, each tile of the
# source, and the probe's sweep, built with its tile in place of tile 0
B1_FORCED = [(None, conv_bn.B1_TILES)] \
    + [(t, conv_bn.B1_TILES) for t in range(len(conv_bn.B1_TILES))] \
    + [(0, (tile,) + conv_bn.B1_TILES[1:])
       for tile in b1_probe.TILES.values()]
B3_FORCED = [(t, quant_ops.PREFILL_TILES)
             for t in range(len(quant_ops.PREFILL_TILES))] \
    + [(0, (tile,) + quant_ops.PREFILL_TILES[1:])
       for tile, _ in b3_probe.TILES.values()]


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _int_const(text, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))


def _tile_table(text, name):
    body = re.search(r"constexpr int %s\[\]\[2\] = \{(.*?)\};" % name, text,
                     re.S).group(1)
    return tuple((int(a), int(b))
                 for a, b in re.findall(r"\{(\d+), (\d+)\}", body))


def _covers_once(blocks, rows, cols, bm, bn):
    """Every (row, col) of a rows x cols output lies in exactly one of the
    bm x bn ``blocks`` [(block_row, block_col)]: the blocks are distinct
    (so their tiles are disjoint) and their clipped areas add up to the
    output's."""
    blocks = np.asarray(blocks, dtype=np.int64)
    assert len(np.unique(blocks, axis=0)) == len(blocks)
    assert blocks.min() >= 0
    r0, c0 = blocks[:, 0] * bm, blocks[:, 1] * bn
    assert (r0 < rows).all() and (c0 < cols).all()
    area = (np.minimum(r0 + bm, rows) - r0) * (np.minimum(c0 + bn, cols) - c0)
    assert int(area.sum()) == rows * cols


@pytest.mark.parametrize("shape", B1_PATH + B1_RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("forced", B1_FORCED,
                         ids=lambda f: "%s-%s" % (f[0], f[1][0]))
def test_b1_plan_covers_each_output_once_and_sizes_its_scratch(shape, forced):
    n, c, o, h, w = shape
    p, r = h * w, n * h * w
    tile, tiles = forced
    plan = conv_bn._plan(n, c, p, o, tile=tile, tiles=tiles)
    assert (plan.bm, plan.bn) == tiles[plan.tile]
    if tile is not None:
        assert plan.tile == tile
    # CTA id -> (channel tile, pixel tile) as the kernel derives them
    o_tiles = -(-o // plan.bm)
    ids = np.arange(plan.ctas, dtype=np.int64)
    _covers_once(np.stack([ids % o_tiles, ids // o_tiles], 1), o, r,
                 plan.bm, plan.bn)
    assert plan.ctas == o_tiles * plan.p_tiles
    # the partial sums: one row of O per pixel tile, every pixel tile
    assert plan.p_tiles == -(-r // plan.bn)
    assert (ids // o_tiles).max() == plan.p_tiles - 1
    # the transposed weight: the k loop reads c_pad rows, each channel
    # tile bm columns from o0 = tile * bm, all inside [c_pad, o_pad]
    assert plan.c_pad >= c and plan.c_pad % conv_bn.B1_BK == 0
    assert plan.c_pad - c < conv_bn.B1_BK
    assert o_tiles * plan.bm <= plan.o_pad
    assert plan.o_pad % conv_bn.B1_O_ALIGN == 0
    assert plan.o_pad % plan.bm == 0
    # the wrapper's scratch is the plan's
    wt, part = conv_bn._scratch(torch.empty(0), o, plan)
    assert tuple(wt.shape) == (plan.c_pad, plan.o_pad)
    assert tuple(part.shape) == (2, plan.p_tiles, o)


@pytest.mark.parametrize("shape", B1_PATH, ids=lambda s: "x".join(map(str, s)))
def test_b1_plan_tile_and_grid_at_path_shapes(shape):
    """O <= 64 takes 64 x 128, wider O 128 x 64; every path shape gives
    more CTAs than the card has SMs."""
    n, c, o, h, w = shape
    plan = conv_bn._plan(n, c, h * w, o)
    assert (plan.bm, plan.bn) == ((64, 128) if o <= 64 else (128, 64))
    assert plan.ctas >= SMS


@pytest.mark.parametrize("shape", B3_PATH + B3_RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_b3_plan_covers_each_output_once_and_sizes_its_scratch(shape):
    m, k, n = shape
    plan = quant_ops._plan(m, k, n)
    gx, gy = plan.grid
    blocks = [(by, bx) for by in range(gy) for bx in range(gx)]
    _covers_once(blocks, m, n, plan.bm, plan.bn)
    if m <= quant_ops.DECODE_MAX_M:
        assert plan.tile == -1 and plan.scratch_bytes == 0
        return
    assert (plan.bm, plan.bn) == quant_ops.PREFILL_TILES[plan.tile]
    # the quantize pass writes m_pad rows of k_pad bytes, then m_pad
    # scales; the GEMM's CTAs read rows < gy * bm and k tiles < k_pad
    assert plan.m_pad == gy * plan.bm and plan.m_pad - m < plan.bm
    assert plan.k_pad >= k and plan.k_pad % quant_ops.PREFILL_BK == 0
    assert plan.k_pad - k < quant_ops.PREFILL_BK
    assert plan.scratch_bytes == plan.m_pad * plan.k_pad + 4 * plan.m_pad
    # the scales start 16-byte aligned after the int8 rows
    assert (plan.m_pad * plan.k_pad) % 16 == 0


@pytest.mark.parametrize("shape", [s for s in B3_PATH if s[0] > 16],
                         ids=lambda s: "x".join(map(str, s)))
def test_b3_prefill_tile_fills_the_card_where_the_tiles_allow(shape):
    """The plan's grid reaches PREFILL_MIN_CTAS (128 of the 132 SMs)
    wherever some prefill tile's grid does, with 64 x 128 tiles there,
    and otherwise takes the tile with the most CTAs."""
    m, k, n = shape
    plan = quant_ops._plan(m, k, n)
    ctas = plan.grid[0] * plan.grid[1]
    most = max(-(-m // bm) * -(-n // bn) for bm, bn in
               quant_ops.PREFILL_TILES)
    if most >= quant_ops.PREFILL_MIN_CTAS:
        assert ctas >= quant_ops.PREFILL_MIN_CTAS
        assert (plan.bm, plan.bn) == (64, 128) or ctas == most
    else:
        assert ctas == most
    assert quant_ops.PREFILL_MIN_CTAS <= SMS


def test_b3_forced_tiles_cover_the_output():
    """Each tile of the source and of the probe's sweep, forced."""
    for tile, tiles in B3_FORCED:
        for m, k, n in [(128, 2048, 2048), (17, 100, 33), (5, 37, 19),
                        (1000, 130, 2001)]:
            plan = quant_ops._plan(m, k, n, tile=tile, tiles=tiles)
            assert plan.tile == tile
            assert (plan.bm, plan.bn) == tiles[tile]
            assert plan.grid[1] * plan.bm == plan.m_pad >= m
            assert plan.grid[0] * plan.bn >= n
            assert plan.scratch_bytes == plan.m_pad * plan.k_pad \
                + 4 * plan.m_pad


@pytest.mark.parametrize("edits, tiles, stem, table", [
    (b1_probe.TILE_SWEEP, b1_probe.TILES, "conv_bn_stats.cu", "kTiles"),
    (b3_probe.TILE_SWEEP, {k: v[0] for k, v in b3_probe.TILES.items()},
     "int8_matmul.cu", "kPrefillTiles"),
    (b3_probe.VARIANTS, {}, "int8_matmul.cu", "kPrefillTiles")],
    ids=["b1-tiles", "b3-tiles", "b3-variants"])
def test_probe_edits_apply_to_the_source(edits, tiles, stem, table):
    """Every text the probes' edited builds replace is in the source, and
    each swept tile's build has that tile as tile 0 of its table."""
    source = _source(stem)
    for name, pairs in edits.items():
        text = source
        for old, new in pairs:
            assert old in text, (name, old)
            text = text.replace(old, new)
        want = tiles.get(name, _tile_table(source, table)[0])
        assert _tile_table(text, table)[0] == want


def test_cuda_tile_constants_agree_with_the_plans():
    b1 = _source("conv_bn_stats.cu")
    assert _tile_table(b1, "kTiles") == conv_bn.B1_TILES
    assert _int_const(b1, "kBK") == conv_bn.B1_BK
    assert _int_const(b1, "kOAlign") == conv_bn.B1_O_ALIGN
    assert _int_const(b1, "kT1BN") == conv_bn.T1_TILE
    b3 = _source("int8_matmul.cu")
    assert _tile_table(b3, "kPrefillTiles") == quant_ops.PREFILL_TILES
    assert _int_const(b3, "kPBK") == quant_ops.PREFILL_BK
