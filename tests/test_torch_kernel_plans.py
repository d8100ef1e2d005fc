"""The launch plans of kernels B1 (``ops/conv_bn.py`` ``_plan``), T1
(``ops/conv_bn.py`` ``_t1_plan``), B3 (``ops/quant_ops.py`` ``_plan``)
and B4 and B5 (``ops/flash_attention.py`` ``_split_plan``,
``_paged_plan``), which the wrappers size their scratch by and whose
tile id, split count, chunk and grid the C entries take, on the CPU: at
every shape of the ResNet-50 step and of the int8 serving path, and at
ragged shapes, the grid covers each output element (B3 at decode: each
row, column and k) exactly once, B4's and B5's work items cover each
live row of each (slot, head) exactly once, the scratch holds every
partial sum, transposed weight and quantized row the kernels touch, B4's
counters sit in a buffer of their own, the grid fills the H100's SMs
where the tiles allow it, the constants hard-coded in the CUDA sources
agree with Python's, and a changed header makes the libraries of the
sources that include it stale."""

import ctypes
import os
import re
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _build, conv_bn, quant_ops
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.probes import conv_bn as b1_probe
from paddle_tpu_torch.probes import decode as b5_probe
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
    if m <= quant_ops.DECODE_MAX_M:
        # a decode CTA (column tile bx, k chunk by) covers all m rows
        assert plan.tile == -1 and plan.m_pad >= m
        _decode_covers_each_row_column_and_k_once(m, k, n, plan)
        return
    blocks = [(by, bx) for by in range(gy) for bx in range(gx)]
    _covers_once(blocks, m, n, plan.bm, plan.bn)
    assert (plan.bm, plan.bn) == quant_ops.PREFILL_TILES[plan.tile]
    # the quantize pass writes m_pad rows of k_pad bytes, then m_pad
    # scales; the GEMM's CTAs read rows < gy * bm and k tiles < k_pad
    assert plan.m_pad == gy * plan.bm and plan.m_pad - m < plan.bm
    assert plan.k_pad >= k and plan.k_pad % quant_ops.PREFILL_BK == 0
    assert plan.k_pad - k < quant_ops.PREFILL_BK
    assert plan.scratch_bytes == plan.m_pad * plan.k_pad + 4 * plan.m_pad
    # the scales start 16-byte aligned after the int8 rows
    assert (plan.m_pad * plan.k_pad) % 16 == 0


def _decode_covers_each_row_column_and_k_once(m, k, n, plan):
    """B3's decode launch as the kernel walks it: CTA (column tile, k
    chunk), its 4 warps' 64-row parts of each 256-row sub-stage, masked
    at the chunk's end; every (column, k) once, all m rows in each CTA;
    at most DECODE_MAX_SPLITS chunks (one cluster); and the scratch as
    the C entry lays it out."""
    tiles, splits = plan.grid
    assert (plan.bm, plan.bn) == (plan.m_pad, quant_ops.DECODE_BN)
    assert plan.m_pad == (8 if m <= 8 else 16)
    assert plan.splits == splits and plan.kc == quant_ops._decode_kc(k,
                                                                     splits)
    assert plan.kc % quant_ops.DECODE_STAGE_K == 0
    assert plan.kc <= quant_ops.DECODE_MAX_KC
    assert splits <= quant_ops.DECODE_MAX_SPLITS
    hits = np.zeros(k, np.int64)
    for j in range(splits):
        k0 = j * plan.kc
        kend = min(k0 + plan.kc, k)
        assert k0 < kend, "an empty chunk"
        nsub = -(-(kend - k0) // quant_ops.DECODE_STAGE_K)
        for sub in range(nsub):
            for warp in range(4):
                lo = k0 + sub * quant_ops.DECODE_STAGE_K + warp * 64
                hits[lo:min(lo + 64, kend)] += 1
    assert (hits == 1).all()
    cols = np.zeros(n, np.int64)
    for bx in range(tiles):
        cols[bx * plan.bn:(bx + 1) * plan.bn] += 1
    assert (cols == 1).all() and (tiles - 1) * plan.bn < n
    # xq [m_pad, k_pad] (every chunk's x slice in bounds), the scales
    assert plan.k_pad == splits * plan.kc >= k
    assert plan.scratch_bytes == plan.m_pad * plan.k_pad + 4 * plan.m_pad
    assert (plan.m_pad * plan.k_pad) % 16 == 0


@pytest.mark.parametrize("splits", b3_probe.SPLITS + (3, 7, 16))
@pytest.mark.parametrize("shape", [s for s in B3_PATH if s[0] <= 16]
                         + [(3, 1000, 2001), (16, 8200, 130), (1, 1, 1),
                            (16, 257, 16), (8, 16384, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_b3_decode_forced_splits_cover_k_once(shape, splits):
    """Each split count the probe sweeps (and others), where its chunks
    fit DECODE_MAX_KC rows and a cluster: no chunk empty, the count the
    C entry derives from the chunk."""
    m, k, n = shape
    try:
        plan = quant_ops._plan(m, k, n, splits=splits)
    except ValueError:
        stages = -(-k // quant_ops.DECODE_STAGE_K)
        used = -(-stages // -(-stages // splits))
        assert used > quant_ops.DECODE_MAX_SPLITS or \
            -(-stages // splits) * quant_ops.DECODE_STAGE_K \
            > quant_ops.DECODE_MAX_KC
        return
    assert plan.splits <= splits
    assert -(-k // plan.kc) == plan.splits
    _decode_covers_each_row_column_and_k_once(m, k, n, plan)


@pytest.mark.parametrize("shape", [s for s in B3_PATH if s[0] <= 16],
                         ids=lambda s: "x".join(map(str, s)))
def test_b3_decode_grid_fills_the_card(shape):
    """Two CTAs for each of the 132 SMs at every decode shape of the
    path: 512 at (8, 2048, 2048), where one CTA a 16 x 32 tile gave 64;
    a k past DECODE_MAX_SPLITS chunks takes a prefill tile."""
    m, k, n = shape
    plan = quant_ops._plan(m, k, n)
    assert plan.grid[0] * plan.grid[1] >= quant_ops.DECODE_MIN_CTAS == 2 * SMS
    assert plan.tile == -1
    if shape == (8, 2048, 2048):
        assert plan.grid == (64, 8) and plan.kc == 256
    big = quant_ops.DECODE_MAX_SPLITS * quant_ops.DECODE_MAX_KC
    assert quant_ops._plan(m, big, n).tile == -1
    assert quant_ops._plan(m, big + 1, n).tile >= 0


def _b5_rows(lens, heads, plan, bs, mb, d, itemsize):
    """{(slot, head, row): visits} as B4's and B5's split body walks its
    work items (``bs * mb`` logical rows a slot: B5's table, B4's cache
    width): CTA b takes items b, b + ctas, ... of (chunk, slot, head),
    chunk-major, skipping a chunk past its slot's length; an item is
    split over the CTA's warps in batches of SPLIT_LOADS[dtype]
    warp-wide loads of 32 / (lanes a row) rows."""
    rows_a_load = 32 // (d // (16 // itemsize))
    warps = fa.SPLIT_WARPS
    rb = rows_a_load * fa.SPLIT_LOADS[{4: torch.float32,
                                       2: torch.bfloat16}[itemsize]]
    slots = len(lens)
    live = [min(max(n, 0), mb * bs) for n in lens]
    items = plan.max_chunks * slots * heads
    seen = {}
    for b in range(plan.ctas):
        for item in range(b, items, plan.ctas):
            j, s, h = (item // (slots * heads), item // heads % slots,
                       item % heads)
            c0 = j * plan.chunk
            c1 = min(c0 + plan.chunk, live[s])
            for warp in range(warps):
                for base in range(c0 + warp * rb, c1, warps * rb):
                    for r in range(rb):
                        if base + r < c1:
                            key = (s, h, base + r)
                            seen[key] = seen.get(key, 0) + 1
    return seen, live


@pytest.mark.parametrize("cfg", [
    dict(heads=2, d=64, bs=8, mb=6, itemsize=4, chunk=None, ctas=None),
    dict(heads=2, d=128, bs=3, mb=9, itemsize=2, chunk=5, ctas=7),
    dict(heads=4, d=64, bs=1, mb=40, itemsize=2, chunk=16, ctas=3),
    dict(heads=2, d=128, bs=16, mb=4, itemsize=4, chunk=24, ctas=None)],
    ids=lambda c: "d%d-bs%d-%s" % (c["d"], c["bs"], c["chunk"]))
def test_b5_plan_covers_each_live_row_once(cfg):
    """At every length 1 .. MB * BS (beside a slot at the full width
    and one at 1), each live row of each (slot, head) is read by exactly
    one lane group of one warp of one item, and no row past a length."""
    heads, d, bs, mb = cfg["heads"], cfg["d"], cfg["bs"], cfg["mb"]
    plan = fa._paged_plan(3, heads, d, bs, mb, chunk=cfg["chunk"],
                          ctas=cfg["ctas"])
    assert plan.max_chunks == -(-mb * bs // plan.chunk)
    assert plan.scratch_bytes == 4 * (2 + d) * 3 * heads * plan.max_chunks
    for n in range(1, mb * bs + 1):
        lens = [n, mb * bs, 1]
        seen, live = _b5_rows(lens, heads, plan, bs, mb, d, cfg["itemsize"])
        want = {(s, h, c): 1 for s, length in enumerate(live)
                for h in range(heads) for c in range(length)}
        assert seen == want, n
        # every chunk's partial has its slot in the scratch
        assert all(-(-length // plan.chunk) <= plan.max_chunks
                   for length in live)


def test_b5_plan_at_the_path():
    """The paged cell (8 slots, 16 heads of 128, BS 16, 64 blocks):
    128-row chunks (two batches of a head's 8 warps in f32, one in bf16),
    a CTA for each of the 1024 items: a grid that depends on no length;
    in f32 and bf16, at the plan's grid and at each of the probe's grid
    sizes, each live row is read once."""
    plan = fa._paged_plan(8, 16, 128, 16, 64)
    assert (plan.chunk, plan.max_chunks) == (128, 8)
    assert plan.ctas == 8 * 8 * 16 <= fa.SPLIT_MAX_CTAS
    lens = [259, 331, 531, 259, 131, 1, 1, 1]
    for itemsize in (4, 2):
        for ctas in (None,) + b5_probe.PAGED_CTAS:
            plan = fa._paged_plan(8, 16, 128, 16, 64, ctas=ctas)
            seen, live = _b5_rows(lens, 16, plan, 16, 64, 128, itemsize)
            assert seen == {(s, h, c): 1 for s, n in enumerate(live)
                            for h in range(16) for c in range(n)}


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
    t1 = _source("conv1x1_bn_relu.cu")
    assert (_int_const(t1, "kT1BM"), _int_const(t1, "kT1BN")) == \
        conv_bn.T1_TILE
    # the probe's T1 tile sweep: each edited build has its tile
    for name, edits in b1_probe.T1_TILE_SWEEP.items():
        text = t1
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        assert (_int_const(text, "kT1BM"), _int_const(text, "kT1BN")) == \
            b1_probe.T1_TILES[name]
    for name, edits in b1_probe.T1_VARIANTS.items():
        for old, _ in edits:
            assert old in t1, (name, old)
    b3 = _source("int8_matmul.cu")
    assert _tile_table(b3, "kPrefillTiles") == quant_ops.PREFILL_TILES
    assert _int_const(b3, "kPBK") == quant_ops.PREFILL_BK


def test_cuda_decode_constants_agree_with_the_plans():
    """B3's decode tile, sub-stage and chunk limit, and B5's warps and
    loads in flight, as the plans assume them."""
    b3 = _source("int8_matmul.cu")
    assert _int_const(b3, "kDecodeBN") == quant_ops.DECODE_BN
    assert _int_const(b3, "kDecodeStageK") == quant_ops.DECODE_STAGE_K
    assert _int_const(b3, "kDecodeMaxKC") == quant_ops.DECODE_MAX_KC
    assert _int_const(b3, "kDecodeMaxSplits") == quant_ops.DECODE_MAX_SPLITS
    # a sub-stage is 64 rows for each warp
    assert _int_const(b3, "kDecodeWarps") * 64 == quant_ops.DECODE_STAGE_K
    # B4's and B5's shared body: its warps and its loads in flight for
    # each cache dtype, which both sources include
    body = _source("decode_split.cuh")
    assert _int_const(body, "kWarps") == fa.SPLIT_WARPS
    assert _int_const(body, "kLoadsF32") == fa.SPLIT_LOADS[torch.float32]
    assert _int_const(body, "kLoadsBF16") == fa.SPLIT_LOADS[torch.bfloat16]
    for stem in ("decode_attention", "decode_attention_paged"):
        assert os.path.join(CSRC, "decode_split.cuh") in _build.sources(stem)
        assert "kLoads" not in _source(stem + ".cu").replace(
            "Pack<T>::kLoads", "")


def test_b5_probe_edits_apply_to_the_source():
    """Each build of the decode probe applies to B4's and to B5's sources
    (the edits fall on the body they share), and each but ``current``
    changes them; ``f32-loads-4`` and ``bf16-loads-8`` swap the loads in
    flight of one dtype."""
    for stem in ("decode_attention", "decode_attention_paged"):
        source = "".join(_source(os.path.basename(p))
                         for p in _build.sources(stem))
        for name, pairs in b5_probe.BUILDS.items():
            text = source
            for old, new in pairs:
                assert old in text, (name, old)
                text = text.replace(old, new)
            assert (text == source) == (name == "current"), name
    body = _source("decode_split.cuh")
    for name, const, want in (("f32-loads-4", "kLoadsF32", 4),
                              ("bf16-loads-8", "kLoadsBF16", 8)):
        text = body
        for old, new in b5_probe.BUILDS[name]:
            text = text.replace(old, new)
        assert _int_const(text, const) == want


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_c_entry_signatures_agree_with_their_argtypes(name):
    """Each C entry point's parameters in its source, pointer or int, in
    the order and number of the argtypes ctypes calls it with."""
    stem, argtypes = _build.ENTRY_POINTS[name]
    source = _source(stem + ".cu")
    sig = re.search(r'extern "C" int %s\(([^)]*)\)' % name, source)
    assert sig, name
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in sig.group(1).split(",")]
    assert kinds == list(argtypes)


def test_scratch_is_reused_by_a_thread_and_never_shared_between_threads():
    """One thread's calls on one stream reuse one buffer, which grows to
    the largest request; another thread on the same stream gets its own,
    so two threads' launches never write each other's scratch."""
    dev = torch.device("cpu")
    a = _build.scratch(dev, 7, 64)
    assert _build.scratch(dev, 7, 32) is a
    assert _build.scratch(dev, 8, 32) is not a
    grown = _build.scratch(dev, 7, 128)
    assert grown.numel() >= 128 and _build.scratch(dev, 7, 64) is grown
    seen = []
    worker = threading.Thread(
        target=lambda: seen.append(_build.scratch(dev, 7, 64)))
    worker.start()
    worker.join()
    assert seen[0] is not grown and seen[0].numel() >= 64


@pytest.mark.parametrize("cfg", [
    dict(s=8, heads=16, d=128, c=1024, itemsize=4),
    dict(s=8, heads=16, d=128, c=1024, itemsize=2),
    dict(s=3, heads=4, d=64, c=300, itemsize=4),
    dict(s=2, heads=2, d=64, c=1, itemsize=2)],
    ids=lambda c: "s%d-c%d-%d" % (c["s"], c["c"], c["itemsize"]))
def test_b4_plan_grid_scratch_and_counters(cfg):
    """B4's plan is a function of the shapes alone (the grid never reads
    a length); at every length up to C its items read each live row of
    each (slot, head) once; the scratch holds (m, l, acc) for every
    (slot, head, chunk), and the counters are one int32 a (slot, head),
    in a zeroed buffer of their own, never the scratch other kernels
    share."""
    s, heads, d, c = cfg["s"], cfg["heads"], cfg["d"], cfg["c"]
    plan = fa._split_plan(s, heads, d, c)
    assert plan.chunk == fa.SPLIT_CHUNK
    assert plan.max_chunks == -(-c // plan.chunk)
    assert plan.ctas == min(s * heads * plan.max_chunks, fa.SPLIT_MAX_CTAS)
    assert plan.scratch_bytes == 4 * (2 + d) * s * heads * plan.max_chunks
    assert plan.counters == s * heads
    # B5 over a table of the same width plans the same split
    assert fa._paged_plan(s, heads, d, 1, c) == plan
    for n in sorted({1, plan.chunk - 1, plan.chunk, plan.chunk + 1, c // 2,
                     c} & set(range(1, c + 1))):
        lens = [n] + [c] * (s > 1) + [1] * max(s - 2, 0)
        seen, live = _b5_rows(lens, heads, plan, c, 1, d, cfg["itemsize"])
        assert seen == {(si, h, r): 1 for si, m in enumerate(live)
                        for h in range(heads) for r in range(m)}, n
    dev = torch.device("cpu")
    counters = _build.counters(dev, 11, plan.counters)
    scratch = _build.scratch(dev, 11, plan.scratch_bytes)
    assert counters.dtype == torch.int32 and not counters.any()
    assert counters.numel() >= plan.counters
    assert counters.untyped_storage().data_ptr() != \
        scratch.untyped_storage().data_ptr()
    assert _build.counters(dev, 11, plan.counters) is counters


@pytest.mark.parametrize("shape", [(802816, 64, 256), (200704, 128, 512),
                                   (50176, 256, 1024), (1000, 72, 136),
                                   (333, 37, 21), (700, 600, 264), (1, 8, 8),
                                   (129, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_t1_plan_covers_each_output_once(shape):
    """At T1's tile and each the probe sweeps: the CTAs' row tiles and
    each CTA's column tiles cover every (row, column) of y once, and
    there is one partial sum of each column per row tile (the CTA's), so
    the sums' buffer has row_tiles rows."""
    r, c, o = shape
    assert conv_bn._t1_plan(r, c, o)[:2] == conv_bn.T1_TILE
    for tile in b1_probe.T1_TILES.values():
        plan = conv_bn._t1_plan(r, c, o, tile=tile)
        assert (plan.bm, plan.bn) == tile
        assert plan.row_tiles == -(-r // plan.bm)
        assert plan.o_tiles == -(-o // plan.bn)
        if r * o <= 10 ** 6:
            blocks = [(i, j) for i in range(plan.row_tiles)
                      for j in range(plan.o_tiles)]
            _covers_once(blocks, r, o, plan.bm, plan.bn)
        # each row lies in exactly one row tile: one partial a row tile
        assert (plan.row_tiles - 1) * plan.bm < r <= plan.row_tiles * plan.bm


def test_a_changed_header_makes_its_libraries_stale(tmp_path, monkeypatch):
    """In a scratch CSRC and BUILD: two sources include one header (one
    through another header), a third includes none; with every library
    newer than its sources none is stale, and touching the shared header
    makes exactly the two that include it stale."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "shared.cuh").write_text("#pragma once\n")
    (csrc / "inner.cuh").write_text('#pragma once\n#include "shared.cuh"\n')
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "shared.cuh"\n')
    (csrc / "b.cu").write_text('  #  include "inner.cuh"\n')
    (csrc / "c.cu").write_text("#include <cstdint>\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(build))
    assert sorted(os.path.basename(p) for p in _build.sources("b")) == \
        ["b.cu", "inner.cuh", "shared.cuh"]
    assert all(_build._stale(stem) for stem in "abc")    # not built yet
    for stem in "abc":
        (build / ("lib%s.so" % stem)).write_bytes(b"")
        os.utime(build / ("lib%s.so" % stem), (2000, 2000))
    for f in csrc.iterdir():
        os.utime(f, (1000, 1000))
    assert not any(_build._stale(stem) for stem in "abc")
    os.utime(csrc / "shared.cuh", (3000, 3000))
    assert [_build._stale(stem) for stem in "abc"] == [True, True, False]
