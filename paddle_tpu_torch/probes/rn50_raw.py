"""A framework-free ResNet-50 training step: the step's upper bound
(reference ``tools/rn50_raw_jax.py``).

    python3 -m paddle_tpu_torch.probes.rn50_raw [batch] [--device cpu]

ResNet-50 written in plain ``torch`` and ``torch.nn.functional``, no
Program and no Executor: bfloat16 activations (each convolution takes
its weight cast to bfloat16), batch norms from float32 moments of the
bfloat16 input applied in bfloat16, float32 parameters, the loss in
float32, gradients by autograd and momentum 0.9 at lr 0.1. Parameters
are the reference's ``init_params(RandomState(0))`` draws in its order;
images and labels come next from that stream. If the executor's step
matches this one, the step is what the card gives this model eagerly.

On the card the reference's size (batch 256 at 224², 20 steps after one);
on the CPU, where the reference has none, batch 4 at 64², 2 steps. Prints
one JSON line under the reference's keys: ``raw_jax_ms_per_step`` keeps
its name for this plain step; ``ca_gb`` and ``ca_tflops`` are reckoned
from the layer list (``reckon``: ``probes/common.py`` ``program_work``'s
rule) where the reference reads XLA's cost analysis; ``mfu`` is its 12.3
G multiply-adds an image over the H100's bf16 FLOP/s peak, about half the
step's FLOP utilization, which ``mfu_reckoned`` gives.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from .common import BF16_FLOPS, launch_counts, launches_since, probe_device

STAGES = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]
CARD = dict(batch=256, res=224, steps=20)
CPU = dict(batch=4, res=64, steps=2)
GMAC_PER_IMAGE = 12.3


def conv(x, w, stride=1, pad=None):
    kh = w.shape[2]
    p = (kh - 1) // 2 if pad is None else pad
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=p)


def bn(x, g, b):
    xf = x.float()
    m = xf.mean(dim=(0, 2, 3))
    v = (xf * xf).mean(dim=(0, 2, 3)) - m * m
    inv = torch.rsqrt(v + 1e-5)
    a = (inv * g).reshape(1, -1, 1, 1).to(x.dtype)
    c = (b - m * inv * g).reshape(1, -1, 1, 1).to(x.dtype)
    return x * a + c


def bottleneck(x, p, stride):
    short = x
    if "ws" in p:
        short = bn(conv(x, p["ws"], stride, 0), p["gs"], p["bs"])
    h = torch.relu(bn(conv(x, p["w1"], stride, 0), p["g1"], p["b1"]))
    h = torch.relu(bn(conv(h, p["w2"], 1, 1), p["g2"], p["b2"]))
    h = bn(conv(h, p["w3"], 1, 0), p["g3"], p["b3"])
    return torch.relu(short + h)


def init_params(rs, device="cpu"):
    """The reference's parameters from ``rs``, drawn in its order, as
    float32 tensors on ``device``: {name: tensor or [block dicts]}."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    def w(*shape):
        fan = np.prod(shape[1:])
        return t(rs.randn(*shape) * np.sqrt(2.0 / fan))

    def ones(n):
        return t(np.ones(n))

    def zeros(n):
        return t(np.zeros(n))
    params = {"stem": {"w": w(64, 3, 7, 7), "g": ones(64), "b": zeros(64)}}
    cin = 64
    for si, (ch, n, _) in enumerate(STAGES):
        blocks = []
        for bi in range(n):
            p = {"w1": w(ch, cin, 1, 1), "g1": ones(ch), "b1": zeros(ch),
                 "w2": w(ch, ch, 3, 3), "g2": ones(ch), "b2": zeros(ch),
                 "w3": w(ch * 4, ch, 1, 1), "g3": ones(ch * 4),
                 "b3": zeros(ch * 4)}
            if bi == 0:
                p.update({"ws": w(ch * 4, cin, 1, 1), "gs": ones(ch * 4),
                          "bs": zeros(ch * 4)})
            blocks.append(p)
            cin = ch * 4
        params["s%d" % si] = blocks
    params["fc_w"] = (w(1000, 2048).T / 10).contiguous()
    params["fc_b"] = zeros(1000)
    return params


def leaves(params):
    """[(path, tensor)] of every parameter, in a fixed order."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, torch.Tensor):
            out.append((k, v))
        elif isinstance(v, dict):
            out += [("%s.%s" % (k, n), v[n]) for n in sorted(v)]
        else:
            out += [("%s.%d.%s" % (k, i, n), b[n])
                    for i, b in enumerate(v) for n in sorted(b)]
    return out


def forward(params, img, label, act_dtype=torch.bfloat16):
    """The mean cross entropy of ``img``'s logits at ``label``, the
    activations in ``act_dtype``."""
    x = img.to(act_dtype)
    st = params["stem"]
    x = torch.relu(bn(conv(x, st["w"], 2, 3), st["g"], st["b"]))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for si, (_, n, stride) in enumerate(STAGES):
        for bi in range(n):
            x = bottleneck(x, params["s%d" % si][bi],
                           stride if bi == 0 else 1)
    x = x.float().mean(dim=(2, 3))
    logits = x @ params["fc_w"] + params["fc_b"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, label.long()).mean()


def train_step(params, vel, img, label, act_dtype=torch.bfloat16):
    """One step: the loss, and params and vel updated in place
    (v = 0.9 v + g, p -= 0.1 v)."""
    ps = [p for _, p in leaves(params)]
    for p in ps:
        p.requires_grad_(True)
    loss = forward(params, img, label, act_dtype)
    grads = torch.autograd.grad(loss, ps)
    with torch.no_grad():
        for p, g, (_, v) in zip(ps, grads, leaves(vel)):
            v.mul_(0.9).add_(g)
            p.sub_(0.1 * v)
    for p in ps:
        p.requires_grad_(False)
    return loss.detach()


def zeros_like(params):
    if isinstance(params, torch.Tensor):
        return torch.zeros_like(params)
    if isinstance(params, dict):
        return {k: zeros_like(v) for k, v in params.items()}
    return [zeros_like(v) for v in params]


def reckon(batch, res):
    """(FLOPs, bytes) of one step by the layer list: 3x the forward's
    convolution and fc FLOPs; each parameter read and written with its
    gradient and velocity (24 B), each convolution, fc and pool output
    written forward and read backward (8 B an element)."""
    flops = acts = 0
    side = res

    def conv_out(cin, cout, k, stride, pad=None):
        nonlocal flops, acts, side
        p = (k - 1) // 2 if pad is None else pad
        side = (side + 2 * p - k) // stride + 1
        numel = batch * cout * side * side
        flops += 2 * numel * cin * k * k
        acts += numel
    conv_out(3, 64, 7, 2, 3)
    side = (side + 2 - 3) // 2 + 1
    acts += batch * 64 * side * side          # the max pool
    cin = 64
    params = 64 * 3 * 49 + 2 * 64
    for ch, n, stride in STAGES:
        for bi in range(n):
            s = stride if bi == 0 else 1
            base = side
            conv_out(cin, ch, 1, s, 0)
            conv_out(ch, ch, 3, 1, 1)
            conv_out(ch, ch * 4, 1, 1, 0)
            params += cin * ch + ch * ch * 9 + ch * ch * 4 + 2 * (6 * ch)
            if bi == 0:
                out = side
                side = base
                conv_out(cin, ch * 4, 1, s, 0)
                side = out
                params += cin * ch * 4 + 2 * ch * 4
            cin = ch * 4
    acts += batch * 2048                      # the average pool
    flops += 2 * batch * 2048 * 1000
    acts += batch * 1000
    params += 2048 * 1000 + 1000
    return 3 * flops, 24 * params + 8 * acts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probe_device(args.device)
    if device is None:
        return 1
    cfg = CARD if device.type == "cuda" else CPU
    batch = args.batch or cfg["batch"]
    res, steps = cfg["res"], cfg["steps"]
    rs = np.random.RandomState(0)
    params = init_params(rs, device)
    vel = zeros_like(params)
    img = torch.from_numpy(rs.randn(batch, 3, res, res).astype(np.float32)
                           ).to(device)
    label = torch.from_numpy(rs.randint(0, 1000, (batch, 1)).astype(
        np.int32)).to(device)
    before = launch_counts()
    loss = train_step(params, vel, img, label)
    first = float(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = train_step(params, vel, img, label)
    lv = float(loss)
    dt = (time.perf_counter() - t0) / steps
    flops, nbytes = reckon(batch, res)
    out = {"raw_jax_ms_per_step": dt * 1e3, "img_per_sec": batch / dt,
           "mfu": batch / dt * GMAC_PER_IMAGE * 1e9 / BF16_FLOPS,
           "ca_gb": nbytes / 1e9, "ca_tflops": flops / 1e12,
           "loss": lv, "first_loss": first, "batch": batch, "res": res,
           "steps": steps, "mfu_reckoned": flops / dt / BF16_FLOPS}
    if device.type == "cuda":
        out["peak_allocated_gb"] = torch.cuda.max_memory_allocated(
            device) / 1e9
    print(json.dumps(out), flush=True)
    print(json.dumps({"probe": "launches", **launches_since(before)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
