"""Square matmul throughput in bf16, int8 and fp8 (reference
``tools/quant_matmul_probe.py``).

    python3 -m paddle_tpu_torch.probes.quant_matmul [--device cpu]

Each product is timed inside a chain of ``n_iter`` (32) products whose
whole output, narrowed back to the input dtype, is the next right-hand
side (so no product is dead and they run one after another): bf16 with
float32 sums (``torch.mm(..., out_dtype=torch.float32)``), int8 with
int32 sums (``torch._int_mm``; the next operand is ``out & 127``), fp8
e4m3 and e5m2 with float32 sums (``torch._scaled_mm`` at scale 1); the
int8 and fp8 chains keep the transposed operand on the card, the
right-hand side column major as the library's fast layout wants it; the
next operand is ``out * 1e-2`` in the input dtype. Device
time of a chain (``probes/common.py`` ``cuda_ms``, 3 chains after one)
over ``n_iter``; m 4096 and 8192 on the card. A dtype the card refuses
is printed as FAILED with its error, as the reference does. On the CPU
the plain route (products of the values widened to float32 or int64),
m 64 and 128, chains of 4. Operands: ``RandomState(0)``, int8 uniform
in [-127, 127), the others N(0, 0.01) rounded to the dtype. Each line is
one JSON object, with TFLOP/s (TOP/s for int8) and the share of the
H100's data-sheet peak (bf16 989, int8 1979, fp8 1979 dense). The
chain's time includes each product's narrowing passes (the reference's
XLA fuses them into the product, the eager library does not), so the
product alone is timed too, on the chain's operands in its layout
(``product_ms``, ``product_tflops``, ``product_pct_of_peak``).
"""

import argparse
import json
import sys

import numpy as np
import torch

from .common import BF16_FLOPS, FP8_FLOPS, INT8_OPS, probe_device, probe_ms

DTYPES = (("bf16", torch.bfloat16, BF16_FLOPS),
          ("int8", torch.int8, INT8_OPS),
          ("fp8_e4m3", torch.float8_e4m3fn, FP8_FLOPS),
          ("fp8_e5m2", torch.float8_e5m2, FP8_FLOPS))
CARD = dict(ms=(4096, 8192), n_iter=32, reps=3)
CPU = dict(ms=(64, 128), n_iter=4, reps=1)


def operands(m, dtype, device):
    """(a, b) of the reference's draws for ``dtype``."""
    rs = np.random.RandomState(0)
    if dtype == torch.int8:
        a = rs.randint(-127, 127, (m, m)).astype(np.int8)
        b = rs.randint(-127, 127, (m, m)).astype(np.int8)
        return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    a = (rs.randn(m, m) * 0.1).astype(np.float32)
    b = (rs.randn(m, m) * 0.1).astype(np.float32)
    return (torch.from_numpy(a).to(device).to(dtype),
            torch.from_numpy(b).to(device).to(dtype))


def _product(a, b):
    """a @ b with wide sums: int32 for int8, float32 otherwise (see
    :func:`chain` for the layout of an int8 or fp8 product's ``b``)."""
    if a.dtype == torch.int8:
        return torch._int_mm(a, b)
    if a.device.type != "cuda":
        return a.float() @ b.float()
    if a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    one = torch.ones((), device=a.device)
    return torch._scaled_mm(a, b, scale_a=one, scale_b=one,
                            out_dtype=torch.float32)


def _narrow(out, dtype):
    if dtype == torch.int8:
        return (out & 127).to(torch.int8)
    return (out * 1e-2).to(dtype)


def _transposed(a):
    """Whether ``a``'s chain runs transposed: int8 and fp8 on the card,
    outᵀ = bᵀ aᵀ, bᵀ row major and aᵀ a column-major view of a (the
    layout cuBLASLt's int8 and fp8 products take); outᵀ row major is out
    column major, as the next product takes it."""
    return a.device.type == "cuda" and a.dtype != torch.bfloat16


def chain(a, b, n_iter):
    """The right-hand side after ``n_iter`` products (the reference's
    ``_chain`` returns its [0, 0] element)."""
    if _transposed(a):
        bt = b.t().contiguous()
        for _ in range(n_iter):
            bt = _narrow(_product(bt, a.t()), a.dtype)
        return bt.t()
    for _ in range(n_iter):
        b = _narrow(_product(a, b), a.dtype)
    return b


def bench(m, dtype, device, n_iter, reps):
    """(ms a product in the chain, ms a product alone): the chain's time
    over ``n_iter``, and one product's on the chain's first operands in
    its layout, without the narrowing passes."""
    a, b = operands(m, dtype, device)
    ms = probe_ms(lambda: chain(a, b, n_iter), device, iters=reps,
                  warmup=1) / n_iter
    lhs, rhs = (b.t().contiguous(), a.t()) if _transposed(a) else (a, b)
    alone = probe_ms(lambda: _product(lhs, rhs), device,
                     iters=reps * n_iter, warmup=1)
    return ms, alone


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    cfg = CARD if device.type == "cuda" else CPU
    for m in cfg["ms"]:
        for name, dtype, peak in DTYPES:
            row = {"m": m, "dtype": name}
            try:
                ms, alone = bench(m, dtype, device, cfg["n_iter"],
                                  cfg["reps"])
                tf, tf_alone = 2 * m ** 3 / ms / 1e9, 2 * m ** 3 / alone / 1e9
                row.update(ms=ms, tflops=tf,
                           pct_of_peak=100 * tf * 1e12 / peak,
                           product_ms=alone, product_tflops=tf_alone,
                           product_pct_of_peak=100 * tf_alone * 1e12 / peak)
            except (RuntimeError, TypeError, ValueError,
                    NotImplementedError) as exc:
                row["FAILED"] = str(exc).split("\n")[0][:160]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
