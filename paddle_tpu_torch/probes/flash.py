"""The transformer LM's training step and kernel B2 on the card, and the
block-size sweep T2 (reference ``tools/transformer_mfu_probe.py``).

    python3 -m paddle_tpu_torch.probes.flash --mode step [--batch B --seqlen T]
    python3 -m paddle_tpu_torch.probes.flash --mode kernel
    python3 -m paddle_tpu_torch.probes.flash --mode sweep
    python3 -m paddle_tpu_torch.probes.flash --mode configs

* ``step``: the bench's LM training step (``bench.py``
  ``bench_transformer_lm`` at the accelerator's widths: vocab 32768,
  d_model 2048, 16 heads, d_ff 8192, 12 layers) under the ``amp`` flag
  (bfloat16) with ``Adam(1e-4)``, tokens and labels one seeded draw;
  warm-up steps, then the mean of timed steps ended by a synchronize.
  Prints ms, tokens/s, MFU at the bf16 tensor-core peak and the loss, and
  the FLOP reckoning (6N + 6LTd a token, ``bench.py``'s) in place of the
  reference's XLA cost analysis.
* ``kernel``: B2's bf16 forward at the path's tile, and the forward +
  backward of ``flash_attention``, at the bench's attention shape
  [8, 16, 1024, 128], causal (profiler kernel durations).
* ``sweep``: B2's bf16 forward at every tile of ``SWEEP_TILES``, with its
  largest difference from the plain version; a tile that fails to launch
  prints an error entry and the sweep goes on.
* ``configs``: ``step`` at the reference probe's five (batch, T) pairs.

Each line is one JSON object. Needs one CUDA card and ``nvcc``.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .. import config, optimizer, trainer
from ..models.transformer import TransformerLM
from ..ops import _build
from ..ops import flash_attention as fa
from ..place import resolve_device
from .common import BF16_FLOPS, device_ms
from .common import FLAGSHIP_LM as FLAGSHIP

CONFIGS = ((8, 1024), (4, 2048), (2, 4096), (6, 1536), (12, 1024))


def flops_per_token(n_params, num_layers, seqlen, d_model):
    """6N for the forward, backward and update matmuls plus 6 L T d for
    causal attention (``bench.py``, PaLM's appendix B convention)."""
    return 6.0 * n_params + 6.0 * num_layers * seqlen * d_model


def build_lm(seqlen, seed=0, cfg=FLAGSHIP, device="cuda"):
    """The LM with its parameters from ``seed`` on the device, and
    ``Adam(1e-4)`` over them (it computes under the ``amp`` flag as it
    is at each step)."""
    model = TransformerLM(max_len=seqlen, device=device, **cfg)
    model.reset_parameters(seed)
    return model, optimizer.Adam(model.reference_parameters(), 1e-4)


def bench_step(batch, seqlen, steps=8, warmup=2, seed=0):
    model, opt = build_lm(seqlen, seed)
    vocab = FLAGSHIP["vocab_size"]
    rs = np.random.RandomState(seed)
    ids = torch.from_numpy(rs.randint(2, vocab, (batch, seqlen))).cuda()
    n_params = sum(p.numel() for p in model.reference_parameters().values())
    out = {"batch": batch, "T": seqlen, "flash": True, "n_params": n_params}
    config.set_flags(amp="bfloat16")
    try:
        for _ in range(warmup):
            loss, _ = trainer.train_step(model, opt, ids, ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, _ = trainer.train_step(model, opt, ids, ids)
        final = float(loss)           # the read synchronizes
        dt = (time.perf_counter() - t0) / steps
    except torch.cuda.OutOfMemoryError as exc:
        out["err"] = str(exc)[:200]
        return out
    finally:
        config.set_flags(amp=None)
        del model, opt
        torch.cuda.empty_cache()
    tok_s = batch * seqlen / dt
    fpt = flops_per_token(n_params, FLAGSHIP["num_layers"], seqlen,
                          FLAGSHIP["d_model"])
    out.update(ms=round(dt * 1e3, 2), tok_s=round(tok_s),
               mfu=round(tok_s * fpt / BF16_FLOPS, 4), loss=round(final, 4),
               tflop_per_step=round(fpt * batch * seqlen / 1e12, 2),
               flops_per_token=fpt)
    return out


def _qkv(b=8, h=16, t=1024, d=128, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(b, h, t, d, device="cuda", generator=gen).bfloat16()
            for _ in range(3)]


def bench_kernel(block_q, block_k, bwd=False, causal=True, n_iter=8):
    """B2 bf16 at [8, 16, 1024, 128]: the forward at the tile, or (bwd)
    the differentiable forward at the path's tile and the backward of the
    sum of squares of its output."""
    q, k, v = _qkv()
    out = {"block_q": block_q, "block_k": block_k, "bwd": bwd}
    try:
        if bwd:
            qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

            def fn():
                o = fa.flash_attention(qg, kg, vg, causal=causal)
                (o.float() ** 2).sum().backward()
        else:
            def fn():
                fa.flash_attention_tile(q, k, v, block_q, block_k, causal)
            got = fa.flash_attention_tile(q, k, v, block_q, block_k, causal)
            want = fa.flash_attention_plain(q, k, v, causal)
            out["max_abs_err"] = float((got.float() - want.float())
                                       .abs().max())
        out["ms"] = round(device_ms(fn, n_iter), 4)
    except (RuntimeError, ValueError) as exc:
        out["err"] = str(exc).splitlines()[0][:160]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="step",
                    choices=["step", "kernel", "sweep", "configs"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print("[device] %s" % smi, flush=True)
    _build.build(["flash_attention"])
    if args.mode == "step":
        print(json.dumps(bench_step(args.batch, args.seqlen, seed=args.seed)),
              flush=True)
    elif args.mode == "configs":
        for b, t in CONFIGS:
            print(json.dumps(bench_step(b, t, seed=args.seed)), flush=True)
    elif args.mode == "kernel":
        for bwd in (False, True):
            print(json.dumps(bench_kernel(*fa.PATH_TILES[128], bwd=bwd)),
                  flush=True)
    else:
        for bq, bk in fa.SWEEP_TILES:
            print(json.dumps(bench_kernel(bq, bk)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
