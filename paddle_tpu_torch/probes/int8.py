"""Kernel B3 (``csrc/int8_matmul.cu``) on the card: its design variants,
and the host time of one launch.

    python3 -m paddle_tpu_torch.probes.int8 [variants] [host]

``variants`` builds the kernel's source and edited copies of it, each
with one decision undone or changed, and times every build at the path's
decode and prefill shapes (profiler kernel durations), with the count of
output elements that differ from the plain version:

* ``current``: the source as it is;
* ``divide-all-rows``: a decode tile's rows past m are quantized too,
  rather than stored as 0 without a division;
* ``first-full-width``: as ``divide-all-rows``, and the decode CTA's
  warps also meet at a block-wide barrier every k tile, with the amax
  loop unrolled 4 — the design of the first full-width run;
* ``no-division``: x * scale in place of x / scale; wrong results,
  timed to price the IEEE divisions;
* ``decode-64-columns``: decode CTAs of 64 columns and 4 k groups
  instead of 32 columns and 8.

``host`` times the host side of the pieces of one B3 launch, and the f32
``torch.matmul`` that B3 replaces, on the path's decode shape.

Builds go to ``build/probe/`` inside the package. Needs one CUDA card
and ``nvcc``.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import _build, nn_ops, quant_ops

# (old, new) source edits per variant; each old text must be present
_UNSKIP = ("(WK == 1 || row0 + r < m)\n" + " " * 31
           + "? quant4(xa[i], s_scale[r]) : 0u", "quant4(xa[i], s_scale[r])")
VARIANTS = {
    "current": (),
    "divide-all-rows": (_UNSKIP,),
    "first-full-width": (
        _UNSKIP,
        ("if constexpr (GT == 32) __syncwarp(); else __syncthreads();",
         "__syncthreads();"),
        ("#pragma unroll 8\n        for (int c = lane; c < k / 4;",
         "#pragma unroll 4\n        for (int c = lane; c < k / 4;")),
    "no-division": (("rintf(__fdiv_rn(v[i], scale))", "rintf(v[i] * scale)"),),
    "decode-64-columns": (("launch<1, 1, 8>(", "launch<1, 2, 4>("),),
}
# decode (m 8, each layer's four (2048, 2048) products, the FFN pair and
# the LM head), the LM head at prefill (m 1) and one prefill FFN product
SHAPES = ((8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048),
          (8, 2048, 32768), (1, 2048, 32768), (512, 2048, 8192))
# B3 launches of one decode step per shape: 12 layers
PER_STEP = {(8, 2048, 2048): 48, (8, 2048, 8192): 12, (8, 8192, 2048): 12,
            (8, 2048, 32768): 1}


def device_ms(fn, iters=20):
    """Mean summed device time of ``fn()``'s kernels, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us:
        raise RuntimeError("the profiler saw no device time")
    return us / iters / 1e3


def build_variants():
    """{variant: ctypes int8_matmul} built in parallel from edited
    copies of the source."""
    with open(os.path.join(_build.CSRC, "int8_matmul.cu")) as f:
        source = f.read()
    out_dir = os.path.join(_build.BUILD, "probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError("variant %s: %r is not in the source"
                                   % (name, old))
            text = text.replace(old, new)
        src = os.path.join(out_dir, name + ".cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, "lib%s.so" % name)
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        fn = ctypes.CDLL(lib).int8_matmul
        fn.argtypes = list(_build.ENTRY_POINTS["int8_matmul"][1])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def quantized(rng, k, n):
    """A normal(0, 0.02) weight quantized as arming does, on the card."""
    from ..serving.quant import quantize_array
    w = rng.standard_normal((k, n), dtype=np.float32) * np.float32(0.02)
    q, s = quantize_array(w, 1)
    return torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()


def probe_variants(rng):
    fns = build_variants()
    step = {name: 0.0 for name in fns}
    for m, k, n in SHAPES:
        x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        x = x.cuda()
        wq, ws = quantized(rng, k, n)
        want = quant_ops.int8_matmul_plain(x, wq, ws)
        parts = []
        for name, fn in fns.items():
            out = torch.empty((m, n), device="cuda")
            st = _build.stream(x.device)

            def call():
                _build.check(fn(x.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                                out.data_ptr(), m, k, n, st), name)

            call()
            torch.cuda.synchronize()
            ms = device_ms(call)
            step[name] += ms * PER_STEP.get((m, k, n), 0)
            parts.append("%s %.4f ms (%d differ)"
                         % (name, ms, int((out != want).sum())))
        print("[variants] m=%d k=%d n=%d: %s" % (m, k, n, "; ".join(parts)))
    print("[variants] B3 device time of one decode step (73 products): %s"
          % "; ".join("%s %.3f ms" % kv for kv in step.items()))


def host_us(fn, n=2000):
    """Mean host time of one ``fn()`` call in microseconds, without
    waiting for the device."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def probe_host(rng):
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.from_numpy(rng.standard_normal((8, 1, 2048),
                                             dtype=np.float32)).cuda()
    x2 = x.reshape(8, 2048)
    wq, ws = quantized(rng, 2048, 2048)
    w32 = wq.float() * ws[None, :]
    out = torch.empty((8, 2048), device="cuda")
    fn = _build.entry("int8_matmul")
    st = _build.stream(dev)
    cases = (
        ("torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("_build.stream(dev)", lambda: _build.stream(dev)),
        ("torch.empty [8, 2048]",
         lambda: torch.empty((8, 2048), dtype=torch.float32, device=dev)),
        ("ctypes call and launch alone", lambda: fn(
            x2.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
            8, 2048, 2048, st)),
        ("quant_matmul_2d [8, 2048] x [2048, 2048]",
         lambda: quant_ops.quant_matmul_2d(x2, wq, ws)),
        ("nn_ops.mul int8 [8, 1, 2048]", lambda: nn_ops.mul(x, wq, ws)),
        ("torch.matmul f32 [8, 1, 2048]", lambda: torch.matmul(x, w32)),
    )
    for name, f in cases:
        print("[host] %-44s %7.2f us per call" % (name, host_us(f)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probes", nargs="*", choices=["variants", "host"],
                    help="default: both")
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
    for probe in args.probes or ["variants", "host"]:
        {"variants": probe_variants, "host": probe_host}[probe](rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
