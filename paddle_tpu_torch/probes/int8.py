"""Kernel B3 (``csrc/int8_matmul.cu``) on the card: its design variants,
its decode split counts, its prefill tiles, and the host time of one
launch.

    python3 -m paddle_tpu_torch.probes.int8 [variants] [splits] [tiles] [host]

``variants`` builds the kernel's source and edited copies of it, each
with one decision undone or changed, and times every build at the path's
decode shapes on a cold L2 (calls taken in turn over copies of the
weight, ``probes.common.cold_calls``) and warm, and at one prefill shape
warm, with the count of output elements that differ from the plain
version:

* ``current``: the source as it is;
* ``no-pdl``: the split-K launch not a programmatic dependent of the
  quantize launch, so its weight loads wait for that launch to end;
* ``one-launch``: no quantize launch; each split-K CTA copies its chunk
  of x (f32), takes its rows' maxima, the cluster's through distributed
  shared memory, and quantizes its chunk itself;
* ``warps-split-k``: the earlier decode kernel
  (``probes/int8_decode_warps.cuh``): one CTA per 16 x 32 output tile
  whose 8 warps split k, with the amax and quantize fused in;
* timings of parts, with wrong results: ``no-division`` (x * scale in
  place of x / scale: the IEEE divisions' price), ``gemv-only`` (no
  quantize launch), ``quantize-only`` (no split-K launch) and
  ``no-cluster-reduce`` (each CTA writes its own chunk's sums: the
  cluster's barriers and distributed shared memory adds).

``splits`` times the source at each decode shape with each split count
of ``SPLITS`` (``quant_ops._plan(..., splits=)``; counts whose chunks
would pass ``DECODE_MAX_KC`` rows are skipped), cold and warm.

``tiles`` runs each prefill tile of the source
(``quant_ops.PREFILL_TILES``) and each of ``TILES``, built in edited
copies of it, at each prefill shape of the path (m 128 and 512), and
times each between CUDA events over queued calls and by the profiler
(``probes.common``), beside the tile ``quant_ops._plan`` picks, with the
count of output elements that differ from the plain version.

``host`` times the host side of the pieces of one B3 call, and the f32
``torch.matmul`` that B3 replaces, on the path's decode shape (the C
entry's two launches beside the one launch of the earlier decode kernel
and of ``one-launch``), and of a
prefill call (its plan, its scratch, the C entry's two launches).

Builds go to ``build/probe/`` inside the package. Needs one CUDA card
and ``nvcc``.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build, nn_ops, quant_ops
from .common import (build_edited, cold_calls, cuda_ms, device_ms,
                     host_us)

_HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_HERE, "int8_decode_warps.cuh")) as _f:
    _WARPS_SPLIT_K = _f.read()
# (old, new) source edits per variant; each old text must be present
_ONE_LAUNCH_X = """  __shared__ float s_amax[MR];
  {
    // the chunk's f32 rows, its rows' maxima, the cluster's through
    // distributed shared memory, then the chunk quantized (rows past m,
    // columns past the chunk, as 0)
    const auto* xf = reinterpret_cast<const float*>(xq);
    float* xc = reinterpret_cast<float*>(sx + MR * xrow);
    const int kn = kend - k0;
    for (int i = tid; i < m * kn; i += NT)
      xc[(i / kn) * kc + i % kn] =
          xf[static_cast<size_t>(i / kn) * k + k0 + i % kn];
    __syncthreads();
    for (int r = warp; r < MR; r += kDecodeWarps) {
      float amax = 0.f;
      if (r < m)
        for (int c = lane; c < kn; c += 32)
          amax = fmaxf(amax, fabsf(xc[r * kc + c]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (lane == 0) s_amax[r] = amax;
    }
    // the first barrier's wait, then a barrier for the maxima
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    if (tid < MR) {
      float part[kDecodeMaxSplits];
#pragma unroll
      for (int j = 0; j < kDecodeMaxSplits; ++j)
        part[j] = j < splits ? cluster.map_shared_rank(s_amax, j)[tid] : 0.f;
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < kDecodeMaxSplits; ++j) amax = fmaxf(amax, part[j]);
      s_scale[tid] = amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
    }
    __syncthreads();
    for (int i = tid; i < MR * (kc / 4); i += NT) {
      const int r = i / (kc / 4), c = 4 * (i % (kc / 4));
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = r < m && c + j < kn ? xc[r * kc + c + j] : 0.f;
      reinterpret_cast<uint32_t*>(sx + r * xrow)[c / 4] =
          r < m ? quant4(v, s_scale[r]) : 0u;
    }
  }
  __syncthreads();"""
_DECODE_X = """  griddep_wait();
  for (int i = tid; i < MR * (kc / 16); i += NT) {
    const int r = i / (kc / 16), ch = i % (kc / 16);
    cp_async16(sx + r * xrow + 16 * ch,
               xq + static_cast<size_t>(r) * k_pad + k0 + 16 * ch);
  }
  if (tid < MR) s_scale[tid] = xs[tid];
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();"""
_QUANTIZE_LAUNCH = """    quantize_rows_kernel<<<m_pad, 256, 0, st>>>(
        xf, reinterpret_cast<uint32_t*>(xq), xs, m, k, k_pad, k % 4 == 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (m_pad == 8)"""
VARIANTS = {
    "current": (),
    "no-pdl": (("cfg.numAttrs = 2;", "cfg.numAttrs = 1;"),),
    "one-launch": (
        (_DECODE_X, _ONE_LAUNCH_X),
        ("cfg.dynamicSmemBytes = static_cast<size_t>(MR) * (kc + 16);",
         "cfg.dynamicSmemBytes = static_cast<size_t>(MR) * (kc + 16) "
         "+ 4 * m * kc;"),
        ("      MR * (kDecodeMaxKC + 16));",
         "      MR * (kDecodeMaxKC + 16) + 4 * MR * kDecodeMaxKC);"),
        ("cfg.numAttrs = 2;", "cfg.numAttrs = 1;"),
        (_QUANTIZE_LAUNCH, "    if (m_pad == 8)"),
        ("return launch_decode<8>(xq,",
         "return launch_decode<8>(reinterpret_cast<const int8_t*>(xf),"),
        ("return launch_decode<16>(xq,",
         "return launch_decode<16>(reinterpret_cast<const int8_t*>(xf),"),
        # the sums' exchange a third barrier later: no CTA leaves while
        # another may read its maxima
        ("  __syncthreads();\n  cluster_wait();\n  if (split > 0) {",
         "  __syncthreads();\n  cluster_arrive();\n  cluster_wait();\n"
         "  if (split > 0) {")),
    "warps-split-k": (
        ("// ------------------------------------------------------------ "
         "decode\n", _WARPS_SPLIT_K + "\n"),
        ("  if (tile < 0) {\n",
         "  if (tile < 0) return launch<1, 1, 8>(xf, wq, sf, of, m, k, n, st);"
         "\n  if (tile < 0) {\n")),
    "no-division": (("rintf(__fdiv_rn(v[i], scale))", "rintf(v[i] * scale)"),),
    "gemv-only": ((_QUANTIZE_LAUNCH, "    if (m_pad == 8)"),),
    "quantize-only": ((_QUANTIZE_LAUNCH, _QUANTIZE_LAUNCH.replace(
        "    if (m_pad == 8)", "    return 0;\n    if (m_pad == 8)")),),
    "no-cluster-reduce": (
        ("  // chunk adds into them; its wait comes after the MMAs\n"
         "  cluster_arrive();\n",
         "  // chunk adds into them; its wait comes after the MMAs\n"),
        ("""  __syncthreads();
  cluster_wait();
  if (split > 0) {
    int* acc0 = cluster.map_shared_rank(&s_acc[0][0], 0);
    for (int e = tid; e < m * kDecodeBN; e += NT)
      atomicAdd(acc0 + e, (&s_acc[0][0])[e]);
  }
  cluster_arrive();
  if (split > 0) return;""", "  __syncthreads();"),
        ("  cluster_wait();\n#pragma unroll\n  for (int i = 0; i < kOut;",
         "#pragma unroll\n  for (int i = 0; i < kOut;")),
}
# tiles the C entry does not instantiate, each built in place of its
# tile 0 (64 x 128): name -> ((BM, BN), the warp layout WM, WN, MT, NTL)
TILES = {"128x128": ((128, 128), "2, 4, 4, 4"),
         "128x64": ((128, 64), "2, 2, 4, 4"),
         "64x64": ((64, 64), "2, 2, 2, 4")}
TILE_SWEEP = {"current": ()}
TILE_SWEEP.update(
    (name, (("kPrefillTiles[][2] = {{64, 128},",
             "kPrefillTiles[][2] = {{%d, %d}," % tile),
            ("launch_prefill<0, 2, 4, 2, 4>(",
             "launch_prefill<0, %s>(" % warps)))
    for name, (tile, warps) in TILES.items())
# decode (m 8, each layer's four (2048, 2048) products, the FFN pair and
# the LM head) and the LM head at prefill (m 1)
DECODE_SHAPES = ((8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048),
                 (8, 2048, 32768), (1, 2048, 32768))
SPLITS = (1, 2, 4, 8)
# B3 launches of one decode step per shape: 12 layers
PER_STEP = {(8, 2048, 2048): 48, (8, 2048, 8192): 12, (8, 8192, 2048): 12,
            (8, 2048, 32768): 1}
# the prefill products of the path: windows padded to the buckets
PREFILL_SHAPES = tuple((m, k, n) for m in (128, 512)
                       for k, n in ((2048, 2048), (2048, 8192),
                                    (8192, 2048)))


def launcher(fn, x, wq, ws, out, plan, name):
    """A call of a ctypes ``int8_matmul`` by ``plan``, its scratch made
    once here, zeroed (the `gemv-only` timing reads its x from it
    unwritten)."""
    m, k = x.shape
    n = wq.shape[1]
    scratch = torch.zeros(max(plan.scratch_bytes, 1), dtype=torch.uint8,
                          device=x.device)
    st = _build.stream(x.device)

    def call():
        _build.check(fn(x.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                        out.data_ptr(), scratch.data_ptr(), m, k, n,
                        plan.tile, plan.splits, st), name)
    return call


def quantized(rng, k, n):
    """A normal(0, 0.02) weight quantized as arming does, on the card."""
    from ..serving.quant import quantize_array
    w = rng.standard_normal((k, n), dtype=np.float32) * np.float32(0.02)
    q, s = quantize_array(w, 1)
    return torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()


def both_clocks(fn, x, wq, ws, plan, name):
    """(cold ms, warm ms, differing elements) of ``fn`` by ``plan``: cold
    over copies of the weight and scales (``cold_calls``)."""
    m, k = x.shape
    n = wq.shape[1]
    want = quant_ops.int8_matmul_plain(x, wq, ws)
    out = torch.empty((m, n), device="cuda")
    call = launcher(fn, x, wq, ws, out, plan, name)
    call()
    torch.cuda.synchronize()
    differ = int((out != want).sum())
    cold = cuda_ms(cold_calls(
        lambda: launcher(fn, x, wq.clone(), ws.clone(),
                         torch.empty((m, n), device="cuda"), plan, name),
        k * n))
    return cold, cuda_ms(call), differ


def probe_variants(rng):
    fns = build_edited("int8_matmul", "int8_matmul", VARIANTS)
    step = {name: [0.0, 0.0] for name in fns}
    for m, k, n in DECODE_SHAPES + PREFILL_SHAPES[4:5]:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        x = x.cuda()
        x[m // 2] = 0.0
        wq, ws = quantized(rng, k, n)
        parts = []
        for name, fn in fns.items():
            cold, warm, differ = both_clocks(fn, x, wq, ws,
                                             quant_ops._plan(m, k, n), name)
            per = PER_STEP.get((m, k, n), 0)
            step[name][0] += cold * per
            step[name][1] += warm * per
            parts.append("%s cold %.4f ms, warm %.4f ms (%d differ)"
                         % (name, cold, warm, differ))
        print("[variants] m=%d k=%d n=%d: %s" % (m, k, n, "; ".join(parts)))
    print("[variants] B3 device time of one decode step (73 products), "
          "cold (warm): %s" % "; ".join(
              "%s %.3f ms (%.3f)" % (name, c, w)
              for name, (c, w) in step.items()))


def probe_splits(rng):
    fn = _build.entry("int8_matmul")
    for m, k, n in DECODE_SHAPES[:4]:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        x = x.cuda()
        wq, ws = quantized(rng, k, n)
        parts = []
        for splits in SPLITS:
            try:
                plan = quant_ops._plan(m, k, n, splits=splits)
            except ValueError:
                parts.append("%d: n/a" % splits)
                continue
            cold, warm, differ = both_clocks(fn, x, wq, ws, plan,
                                             "int8_matmul")
            parts.append("%d (%d CTAs, chunk %d): cold %.4f ms, warm %.4f "
                         "ms, %d differ" % (plan.splits, plan.grid[0] *
                                            plan.grid[1], plan.kc, cold,
                                            warm, differ))
        print("[splits] m=%d k=%d n=%d (plan: %d): %s"
              % (m, k, n, quant_ops._plan(m, k, n).splits, "; ".join(parts)))


def probe_tiles(rng):
    fns = build_edited("int8_matmul", "int8_matmul", TILE_SWEEP)
    for m, k, n in PREFILL_SHAPES:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        x = x.cuda()
        wq, ws = quantized(rng, k, n)
        want = quant_ops.int8_matmul_plain(x, wq, ws)
        parts = []
        runs = [(fns["current"], tile, quant_ops.PREFILL_TILES)
                for tile in range(len(quant_ops.PREFILL_TILES))]
        runs += [(fns[name], 0, (bm_bn,) + quant_ops.PREFILL_TILES[1:])
                 for name, (bm_bn, _) in TILES.items()]
        for fn, tile, tiles in runs:
            plan = quant_ops._plan(m, k, n, tile=tile, tiles=tiles)
            out = torch.empty((m, n), device="cuda")
            call = launcher(fn, x, wq, ws, out, plan, "int8_matmul")
            call()
            torch.cuda.synchronize()
            differ = int((out != want).sum())
            parts.append("%dx%d (%d CTAs) events %.4f ms, profiler %.4f ms, "
                         "%d differ" % (plan.bm, plan.bn,
                                        plan.grid[0] * plan.grid[1],
                                        cuda_ms(call), device_ms(call),
                                        differ))
        chosen = quant_ops._plan(m, k, n)
        print("[tiles] m=%d k=%d n=%d (plan: %dx%d): %s"
              % (m, k, n, chosen.bm, chosen.bn, "; ".join(parts)))


def probe_host(rng):
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.from_numpy(rng.standard_normal((8, 1, 2048),
                                             dtype=np.float32)).cuda()
    x2 = x.reshape(8, 2048)
    wq, ws = quantized(rng, 2048, 2048)
    w32 = wq.float() * ws[None, :]
    out = torch.empty((8, 2048), device="cuda")
    fn = _build.entry("int8_matmul")
    # the earlier decode kernel's one launch and the fused split-K
    # design's, for the host cost of the split-K path's two
    old = build_edited("int8_matmul", "int8_matmul",
                       {name: VARIANTS[name]
                        for name in ("warps-split-k", "one-launch")})
    st = _build.stream(dev)
    plan = quant_ops._plan(8, 2048, 2048)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device="cuda")
    xp = torch.from_numpy(rng.standard_normal((512, 2048),
                                              dtype=np.float32)).cuda()
    pre = quant_ops._plan(512, 2048, 2048)
    outp = torch.empty((512, 2048), device="cuda")
    scratch_p = torch.empty(pre.scratch_bytes, dtype=torch.uint8,
                            device="cuda")
    cases = (
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("_build.stream(dev)", lambda: _build.stream(dev)),
        ("torch.empty [8, 2048]",
         lambda: torch.empty((8, 2048), dtype=torch.float32, device=dev)),
        ("ctypes call and launches alone", lambda: fn(
            x2.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), 8, 2048, 2048, plan.tile, plan.splits, st)),
        ("ctypes call, warps-split-k's one launch", lambda: old[
            "warps-split-k"](x2.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                             out.data_ptr(), scratch.data_ptr(), 8, 2048,
                             2048, -1, 1, st)),
        ("ctypes call, one-launch's one launch", lambda: old[
            "one-launch"](x2.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                          out.data_ptr(), scratch.data_ptr(), 8, 2048, 2048,
                          plan.tile, plan.splits, st)),
        ("_build.scratch(dev, stream, %d)" % plan.scratch_bytes,
         lambda: _build.scratch(dev, st, plan.scratch_bytes)),
        ("quant_matmul_2d [8, 2048] x [2048, 2048]",
         lambda: quant_ops.quant_matmul_2d(x2, wq, ws)),
        ("nn_ops.mul int8 [8, 1, 2048]", lambda: nn_ops.mul(x, wq, ws)),
        ("torch.matmul f32 [8, 1, 2048]", lambda: torch.matmul(x, w32)),
        ("quant_ops._plan(512, 2048, 2048)",
         lambda: quant_ops._plan(512, 2048, 2048)),
        ("torch.empty prefill scratch (%d bytes)" % pre.scratch_bytes,
         lambda: torch.empty(pre.scratch_bytes, dtype=torch.uint8,
                             device=dev)),
        ("ctypes call, prefill [512, 2048] x [2048, 2048]", lambda: fn(
            xp.data_ptr(), wq.data_ptr(), ws.data_ptr(), outp.data_ptr(),
            scratch_p.data_ptr(), 512, 2048, 2048, pre.tile, pre.splits,
            st)),
        ("quant_matmul_2d [512, 2048] x [2048, 2048]",
         lambda: quant_ops.quant_matmul_2d(xp, wq, ws)),
        ("torch.matmul f32 [512, 2048] x [2048, 2048]",
         lambda: torch.matmul(xp, w32)),
    )
    for name, f in cases:
        print("[host] %-44s %7.2f us per call" % (name, host_us(f)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*",
                    choices=["variants", "splits", "tiles", "host"],
                    help="default: all four")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("[device] %s" % smi)
    rng = np.random.default_rng(args.seed)
    _build.build(["int8_matmul"])
    probes = {"variants": probe_variants, "splits": probe_splits,
              "tiles": probe_tiles, "host": probe_host}
    for probe in args.probes or list(probes):
        probes[probe](rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
