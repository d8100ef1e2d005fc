"""The measurement probes of ``paddle_tpu_torch.probes`` (``pipeline``,
``mfu``, ``rn50_raw``, ``layout``, ``quant_matmul``) against the
reference probes of ``tools/``, loaded from their paths, on the CPU at
small sizes, both sides on the same seeded numpy inputs and weights.
The reference's startup programs are not compiled: their initializers
are drawn in numpy (``numpy_startup``) into the scope the reference
probe reads.

Also: every probe refuses to run without CUDA unless given
``--device cpu``; ``program_work`` and the H100's peaks exist once,
in ``probes/common.py``, with ``chip_smoke.py`` importing them, and the
raw ResNet-50's layer-list reckoning is the program's."""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.models import resnet as ref_resnet
from paddle_tpu.trainer import Trainer as RefTrainer
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch.probes import (common, layout, mfu, pipeline,
                                     quant_matmul, rn50_raw)
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PROBES = ("pipeline", "mfu", "rn50_raw", "layout", "quant_matmul", "trace",
          "paged_cache", "generate", "decode_policy")
# f32 training steps of the same program in both packages: the
# convolutions and batch norms sum in other orders, so the losses of a
# few steps agree to ~1e-6 relative; held to 1e-4
F32_LOSS_RTOL = 1e-4


def ref_probe(name):
    """The reference probe ``tools/<name>.py`` as a module."""
    path = os.path.join(ROOT, "tools", name + ".py")
    spec = importlib.util.spec_from_file_location("_ref_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numpy_startup(startup, scope, seed=3):
    """The startup program's initializers drawn in numpy into ``scope``
    (``gaussian_random``, ``uniform_random``, ``fill_constant``,
    ``assign_value``) and the dropout key: the reference's executor would
    compile the startup first."""
    rs = np.random.RandomState(seed)
    for op in startup.global_block().ops:
        a = op.attrs
        shape, dtype = tuple(a["shape"]), np.dtype(a["dtype"])
        if op.type == "gaussian_random":
            v = rs.normal(a["mean"], a["std"], shape)
        elif op.type == "uniform_random":
            v = rs.uniform(a["min"], a["max"], shape)
        elif op.type == "assign_value":
            v = np.asarray(a["values"]).reshape(shape)
        else:
            assert op.type == "fill_constant", op.type
            v = np.full(shape, a["value"])
        scope.set_var(op.outputs["Out"][0], v.astype(dtype))
    scope.set_var("@RNG_STATE@", np.array([0, seed], np.uint32))


_INIT_OPS = {"gaussian_random", "uniform_random", "fill_constant",
             "assign_value"}


@pytest.fixture
def fast_startup(monkeypatch):
    """The reference ``Executor.run`` of a startup program (initializer
    ops only) draws them in numpy into the run's scope instead of
    compiling them."""
    real = ptpu.Executor.run

    def run(self, program=None, *args, **kwargs):
        ops = program.global_block().ops if program is not None else ()
        if ops and all(op.type in _INIT_OPS for op in ops):
            numpy_startup(program, kwargs.get("scope") or ptpu.global_scope())
            return []
        return real(self, program, *args, **kwargs)
    monkeypatch.setattr(ptpu.Executor, "run", run)


@pytest.fixture
def flags():
    """Both packages' config flags restored after the test."""
    ref, port = dict(ptpu.config._flags), dict(port_config._flags)
    yield
    ptpu.config.set_flags(**{k: v for k, v in ref.items()
                             if ptpu.config._flags.get(k) != v})
    port_config.set_flags(**{k: v for k, v in port.items()
                             if port_config._flags.get(k) != v})


def _named(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.var_names()}


def _load(pscope, named):
    for n, v in named.items():
        if n != "@RNG_STATE@":
            pscope.set_var(n, torch.tensor(np.array(v)))


@pytest.mark.parametrize("name", PROBES)
def test_main_without_cuda_returns_nonzero(name, monkeypatch, capsys):
    """No run falls back to the CPU on its own: without CUDA and without
    ``--device cpu`` every probe says so and exits nonzero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("paddle_tpu_torch.probes." + name)
    assert mod.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_program_work_and_peaks_live_once():
    """``chip_smoke.py`` takes ``program_work``, the peaks and the card
    line from ``probes/common.py``; the figures are the ones it printed
    before (ResNet-50 at 224², batch 256, computed by its own copy of
    the function); the raw ResNet-50's reckoning from its layer list is
    the program's, here and at the CPU size."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_shared", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.program_work is common.program_work
    assert cs.card_line is common.card_line
    assert (cs.HBM_BYTES_PER_S, cs.F32_FLOPS, cs.BF16_FLOPS, cs.INT8_OPS) \
        == (3.35e12, 67e12, 989e12, 1979e12)
    for batch, res, want in ((256, 224, (5925846908928, 22713107392)),
                             (4, 64, None)):
        main, startup = pc.Program(), pc.Program()
        with pc.unique_name.guard(), pc.program_guard(main, startup):
            img = mfu.layers.data("img", shape=[3, res, res])
            label = mfu.layers.data("label", shape=[1], dtype="int64")
            loss, _, _ = mfu.resnet.resnet_imagenet(img, label, depth=50)
            mfu.optimizer.Momentum(0.1, 0.9).minimize(loss, startup)
        flops, nbytes, params = common.program_work(main, batch)
        assert params == 25557032
        if want is not None:
            assert (flops, nbytes) == want
        assert rn50_raw.reckon(batch, res) == (flops, nbytes)


def _pipeline_feeds(batches, steps):
    """The feeds of the probe's steps in order: the resident batch (one
    warm step, ``steps`` read back, a chain of ``steps``), then the
    staged pass's ``steps`` batches."""
    return [batches[0]] * (1 + 2 * steps) + \
        [batches[i % len(batches)] for i in range(steps)]


def _ref_pipeline_steps(cfg, feeds):
    """The reference ``Trainer`` on the probe's program at f32 (amp off)
    over ``feeds``: [(scope before the step, loss)]."""
    main, startup = ptpu.Program(), ptpu.Program()
    with ptpu.unique_name.guard(), ptpu.program_guard(main, startup):
        img = ref_layers.data("img", shape=[3, cfg["res"], cfg["res"]])
        label = ref_layers.data("label", shape=[1], dtype="int64")
        loss, _, _ = ref_resnet.resnet_cifar10(img, label, depth=cfg["depth"],
                                               class_dim=pipeline.CLASSES)
        ptpu.optimizer.Momentum(learning_rate=pipeline.LR,
                                momentum=pipeline.MOMENTUM).minimize(
            loss, startup_program=startup)
    scope = ptpu.Scope()
    out = []
    with ptpu.scope_guard(scope):
        numpy_startup(startup, scope)
        tr = RefTrainer(loss, main_program=main, startup_program=startup,
                        async_metrics=True)
        tr._initialized = True
        for feed in feeds:
            before = {n: np.array(v) for n, v in _named(scope).items()}
            out.append((before, float(np.asarray(
                tr._train_feed(feed)["loss"]))))
    return out


def test_pipeline_losses_match_the_reference_trainer(flags):
    """The probe's steps at the CPU size and f32 (ResNet-20, batch 4,
    Momentum(0.1, 0.9)) against the reference ``Trainer`` on the same
    program: each step of the probe's sequence (``compute_only``'s
    resident steps, then ``staged_pass``'s) from the reference's weights
    before it gives the reference's loss within 1e-4 relative; and the
    probe's own run from the same start follows the reference's losses
    within 1e-4 over its first 4 steps. Later steps of the two runs part
    by about ten times a step (measured: 7e-5 relative at step 4, 2e-3
    at 5): lr 0.1 on batch 4 of 1000 classes memorizes the batch, and
    the rounding of two summation orders grows through the steps, so the
    run's later losses are held only to be finite. The stage times
    cover each staged batch."""
    cfg = pipeline.sizes(CPU)
    n = cfg["steps"]
    batches = pipeline.host_batches(cfg)
    feeds = _pipeline_feeds(batches, n)
    ref = _ref_pipeline_steps(cfg, feeds)
    port_config.set_flags(amp=None, fused_conv_bn=False)
    tr, _, _ = pipeline.build(cfg, CPU)
    pscope = pc.Scope()
    with pc.scope_guard(pscope):
        tr._initialized = True
        for feed, (state, want) in zip(feeds, ref):
            _load(pscope, state)
            got = float(tr._train_feed({k: torch.from_numpy(v)
                                        for k, v in feed.items()})["loss"])
            np.testing.assert_allclose(got, want, rtol=F32_LOSS_RTOL)
        _load(pscope, ref[0][0])
        row, compute = pipeline.compute_only(tr, batches[0], n, CPU)
        staged, staged_losses = pipeline.staged_pass(tr, batches, n, CPU)
    np.testing.assert_allclose(compute[:4], [w for _, w in ref[:4]],
                               rtol=F32_LOSS_RTOL)
    assert len(compute) == n + 2 and len(staged_losses) == n
    assert np.isfinite(compute + staged_losses).all()
    assert staged["steps"] == n and row["steps"] == n
    assert staged["h2d_ms"]["max"] >= 0.0
    assert staged["arena_ms"]["min"] >= 0.0


def test_mfu_steps_match_the_reference_executor(fast_startup, flags):
    """The probe's ResNet program (``build_step`` / ``run_steps``) at f32
    against the reference probe's ``build_step`` (ResNet-18 at 64², batch
    2: the same ``RandomState(0)`` feed), run by the reference executor
    from the same weights: the last loss of 1 warm-up and 2 timed steps
    within 1e-4 relative; the reckoning is the program's."""
    ref = ref_probe("mfu_probe")
    batch, depth, res = 2, 18, 64
    with ptpu.unique_name.guard():
        exe, main, _, loss, feed = ref.build_step(batch, depth, False,
                                                  steps_img=res)
    init = _named(ptpu.global_scope())
    want = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss])[0]))
            for _ in range(3)]
    port_config.set_flags(amp=None, fused_conv_bn=False)
    pexe, pscope, pmain, _, ploss, pfeed = mfu.build_step(
        batch, depth, False, CPU, res=res)
    for k, v in feed.items():
        np.testing.assert_array_equal(pfeed[k].numpy(), np.asarray(v))
    _load(pscope, init)
    _, last = mfu.run_steps(pexe, pscope, pmain, ploss, pfeed, 2, 1)
    np.testing.assert_allclose(last, want[-1], rtol=F32_LOSS_RTOL)
    flops, nbytes, _ = common.program_work(pmain, batch)
    assert flops > 0 and nbytes > 0


def _tree(params):
    """{dotted path: array} of a reference parameter tree."""
    import jax
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def test_rn50_raw_step_matches_the_reference(monkeypatch):
    """One step of the plain-torch ResNet-50 against the reference's
    ``train_step`` from its ``init_params(RandomState(0))`` at 128²,
    batch 2, where the last stage's batch norms see 32 values each (at
    32² and 64² they see 4 and 16, and the statistics of so few values
    amplify rounding). The parameters are the reference's draws exactly.

    Float32 activations (the reference's forward with its bfloat16 cast
    made float32): the loss within 1e-5 relative, and each parameter's
    gradient within 0.12 of the reference's ``jax.grad`` in norm
    relative to the reference's. A float32 gradient of this
    He-initialized 50-layer net is itself no better than a few percent:
    measured against the port's float64 gradient, the port's float32 one
    lies 3.1-4.6% away per tensor and the reference's 5.1-6.8%, and the
    two float32 ones 7.7% at most (median 6.0%); 0.12 is the sum of the
    two distances with room. A wrong gradient (a sign, a factor of two,
    a missing path) is off by 50% or more.

    Bfloat16 (the probe's step): the loss within 2^-7 relative (one
    bfloat16 step), and the update is the rule exactly: with the
    velocity at 0, v1 = g and p1 = p0 - 0.1 g for the gradient ``g`` the
    step took (read from its ``torch.autograd.grad`` call). So a step
    that leaves the parameters where they were, or takes another rate,
    fails."""
    import types

    import jax
    import jax.numpy as jnp
    ref = ref_probe("rn50_raw_jax")
    batch, res = 2, 128
    rs = np.random.RandomState(0)
    params = ref.init_params(rs)
    img = rs.randn(batch, 3, res, res).astype(np.float32)
    label = rs.randint(0, 1000, (batch, 1)).astype(np.int32)
    vel = jax.tree.map(jnp.zeros_like, params)
    _, _, ref_loss = ref.train_step(params, vel, jnp.asarray(img),
                                    jnp.asarray(label))
    f32 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                   if not k.startswith("__")})
    f32.bfloat16 = jnp.float32
    monkeypatch.setattr(ref, "jnp", f32)
    ref_f32_loss, ref_g = jax.jit(jax.value_and_grad(ref.forward))(
        params, jnp.asarray(img), jnp.asarray(label))
    p0, ref_g = _tree(params), _tree(ref_g)
    pp = rn50_raw.init_params(np.random.RandomState(0))
    names = [k for k, _ in rn50_raw.leaves(pp)]
    assert sorted(names) == sorted(p0)
    for k, v in rn50_raw.leaves(pp):
        np.testing.assert_array_equal(v.numpy(), p0[k])
    ti, tl = torch.from_numpy(img), torch.from_numpy(label)
    f32 = rn50_raw.init_params(np.random.RandomState(0))
    ps = [p.requires_grad_() for _, p in rn50_raw.leaves(f32)]
    f32_loss = rn50_raw.forward(f32, ti, tl, torch.float32)
    g_f32 = torch.autograd.grad(f32_loss, ps)
    np.testing.assert_allclose(float(f32_loss.detach()),
                               float(ref_f32_loss), rtol=1e-5)
    for k, g in zip(names, g_f32):
        want = ref_g[k]
        rel = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
        assert rel <= 0.12, (k, rel)

    took = []
    real_grad = torch.autograd.grad

    def recording(*args, **kw):
        out = real_grad(*args, **kw)
        took.append(out)
        return out
    monkeypatch.setattr(torch.autograd, "grad", recording)
    vel = rn50_raw.zeros_like(pp)
    loss = rn50_raw.train_step(pp, vel, ti, tl)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2 ** -7)
    (g_bf16,) = took
    for (k, p), (_, v), g in zip(rn50_raw.leaves(pp), rn50_raw.leaves(vel),
                                 g_bf16):
        assert float(g.abs().max()) > 0, k
        assert torch.equal(v, g), k
        assert torch.equal(p, torch.tensor(p0[k]) - 0.1 * g), k


def test_layout_stack_matches_the_reference_conv_stack(monkeypatch):
    """The 8-deep conv + ReLU stack at [2, 8, 10, 10], f32: NCHW and
    channels-last within 1e-5 of max|out| of each other and of the
    reference's ``conv_stack`` function in its NCHW and NHWC forms (its
    jitted ``f``, taken from the call to its timer) on the same numpy
    input; the weights scaled by 1/sqrt(9 C) keep the stack's values
    O(1)."""
    ref = ref_probe("layout_probe")
    fns = {}

    def grab(fn, *args, iters=10):
        fns[len(fns)] = fn
        return 1.0
    import jax
    import jax.numpy as jnp
    monkeypatch.setattr(ref, "timeit", grab)
    # its own [256, 256, 28, 28] inputs are not used: a small draw
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.zeros((1,) * len(shape),
                                                            dtype))
    ref.conv_stack("NCHW", jnp.float32)
    ref.conv_stack("NHWC", jnp.float32)
    rs = np.random.RandomState(1)
    b, c, h, w = 2, 8, 10, 10
    x = rs.randn(b, c, h, w).astype(np.float32)
    wt = (rs.randn(c, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32)
    want = np.asarray(fns[0](x, wt))
    want_nhwc = np.asarray(fns[1](x.transpose(0, 2, 3, 1),
                                  wt.transpose(2, 3, 1, 0)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(want_nhwc.transpose(0, 3, 1, 2), want,
                               atol=1e-5 * scale, rtol=0)
    tx, tw = torch.from_numpy(x), torch.from_numpy(wt)
    for fmt in layout.LAYOUTS.values():
        got = layout.stack(tx.contiguous(memory_format=fmt),
                           tw.contiguous(memory_format=fmt))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * scale,
                                   rtol=0)
    x0, w0 = layout.inputs("NCHW", torch.float32, (b, c, h, w), CPU)
    x1, w1 = layout.inputs("NHWC", torch.float32, (b, c, h, w), CPU)
    assert torch.equal(x0, x1) and torch.equal(w0, w1)
    assert x1.is_contiguous(memory_format=torch.channels_last)


def test_quant_matmul_chains_match_the_reference():
    """At m 64 on the plain CPU route: the int8 chain equals exact
    integer arithmetic element for element and the reference's ``_chain``
    (its [0, 0] element) at 1-3 products; bf16 and fp8 after one and two
    products within one step of the dtype (2^-7, 2^-3 and 2^-2 relative
    for bf16, e4m3 and e5m2) of the reference's [0, 0]: both sum exact
    products of the narrow values in float32, in other orders, and round
    to the dtype."""
    import jax.numpy as jnp
    ref = ref_probe("quant_matmul_probe")
    m = 64
    a, b = quant_matmul.operands(m, torch.int8, CPU)
    an, bn = a.numpy().astype(np.int64), b.numpy().astype(np.int64)
    rs = np.random.RandomState(0)
    ra = rs.randint(-127, 127, (m, m)).astype(np.int8)
    rb = rs.randint(-127, 127, (m, m)).astype(np.int8)
    np.testing.assert_array_equal(a.numpy(), ra)
    np.testing.assert_array_equal(b.numpy(), rb)
    for n in (1, 2, 3):
        want = bn
        for _ in range(n):
            want = ((an @ want) & 127).astype(np.int64)
        got = quant_matmul.chain(a, b, n).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int8))
        assert int(ref._chain(ra, rb, n, jnp.int32, jnp.int8)) == got[0, 0]
    steps = {torch.bfloat16: (jnp.bfloat16, 2 ** -7),
             torch.float8_e4m3fn: (jnp.float8_e4m3fn, 2 ** -3),
             torch.float8_e5m2: (jnp.float8_e5m2, 2 ** -2)}
    for dtype, (jdt, tol) in steps.items():
        a, b = quant_matmul.operands(m, dtype, CPU)
        ja = jnp.asarray(a.float().numpy()).astype(jdt)
        jb = jnp.asarray(b.float().numpy()).astype(jdt)
        for n in (1, 2):
            got = float(quant_matmul.chain(a, b, n)[0, 0].float())
            want = float(ref._chain(ja, jb, n, jnp.float32, jdt)
                         .astype(jnp.float32))
            assert abs(got - want) <= tol * abs(want) + 1e-30, \
                (dtype, n, got, want)
