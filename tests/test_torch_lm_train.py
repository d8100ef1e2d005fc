"""The port's transformer LM training path (``models/transformer.py``
``TransformerLM`` and ``transformer_lm``, ``layers/attention.py``,
``amp.py``, ``optimizer.Adam``, ``trainer.train_step``, ``io``) against
the reference's program from the same weights: the reference's scope
after its startup program (parameters, Adam's accumulators,
``learning_rate_0``, and ``@RNG_STATE@``, which the loader drops) is
carried into the port by name with
``io.params_from_jax(named, model=lm, optimizer=adam)``; both then train
three Adam steps on the same tokens, as ``bench.py`` feeds them (labels
the same draw as the tokens). The net is
``tests/test_pallas_attention.py``'s: vocab 100, d_model 64, 2 heads,
d_ff 128, 2 layers, T 128, batch 4, the reference's flash attention on
(its Pallas kernel interpreted).

Tolerances:
* amp off: losses to rtol 1e-5 and the first step's gradients to 1e-4 of
  each tensor's norm (float32 through two layers, sums in other orders).
  Parameters after three steps: Adam's first step moves an element by
  lr * sign(g) wherever |g| >> epsilon, so an element whose gradient is
  near 0 can land up to 2 lr away, and each step moves an element by at
  most about lr. Every element is held within 2 lr per step, and 99% of
  each tensor's elements within 1e-3 lr.
* amp on (bf16 products, f32 master weights): losses to 1e-2 relative,
  parameters within 2 lr per step everywhere and 90% of the elements
  within 0.1 lr (a product rounded to bf16 flips the sign of small
  gradients more often).
* In both, every parameter and accumulator stays float32 and the loss is
  float32 (``tests/test_amp.py``).

``optimizer_ops.adam`` equals the reference's ``adam`` op over three
steps to 1 ulp, and ``Adam.accumulators()`` names equal the reference's
scope names."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.core import registry
from paddle_tpu.core.framework import RNG_STATE_VAR
from paddle_tpu.models import transformer as ref_tf
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch import trainer
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import flash_attention as port_attn
from paddle_tpu_torch.ops import optimizer_ops
from paddle_tpu_torch.serving import GenerationSession
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NET = dict(vocab_size=100, d_model=64, num_heads=2, d_ff=128, num_layers=2)
T, B, LR, STEPS = 128, 4, 1e-3, 3


def _feeds():
    rs = np.random.RandomState(0)
    ids = rs.randint(2, NET["vocab_size"], (B, T)).astype("int64")
    return ids, ids


def _reference(amp, steps=STEPS):
    """(state after startup, losses, first-step gradients by name, state
    after ``steps`` steps) of the reference program."""
    ptpu.config.set_flags(flash_attention=True, amp=amp)
    try:
        with ptpu.unique_name.guard():
            main, startup = ptpu.Program(), ptpu.Program()
            main.random_seed = startup.random_seed = 21
            with ptpu.program_guard(main, startup):
                toks = layers.data("toks", shape=[T], dtype="int64")
                lbls = layers.data("lbls", shape=[T], dtype="int64")
                loss, _ = ref_tf.transformer_lm(toks, lbls, **NET)
                _, params_grads = ptpu.optimizer.Adam(
                    learning_rate=LR).minimize(loss, startup_program=startup)
        grads = [g.name for _, g in params_grads]
        exe = ptpu.Executor()
        scope = ptpu.Scope()
        toks_v, lbls_v = _feeds()
        losses, first = [], None
        with ptpu.scope_guard(scope):
            exe.run(startup)
            before = _state(scope)
            for i in range(steps):
                outs = exe.run(main, feed={"toks": toks_v, "lbls": lbls_v},
                               fetch_list=[loss] + (grads if i == 0 else []),
                               return_numpy=False)
                assert outs[0].dtype == jnp.float32
                losses.append(float(np.asarray(outs[0])))
                if i == 0:
                    first = {g[:-len("@GRAD")]: np.asarray(v)
                             for g, v in zip(grads, outs[1:])}
            after = _state(scope)
    finally:
        ptpu.config.set_flags(flash_attention=False, amp=None)
    return before, losses, first, after


def _state(scope):
    """The scope's variables, its random-number state included (the port
    drops it on load)."""
    return {n: np.array(scope.find_var(n)) for n in scope.var_names()
            if not n.startswith("@") or n == RNG_STATE_VAR}


def _port(before, amp, steps=STEPS):
    """The port's LM and Adam loaded from ``before``, trained ``steps``
    steps on the CPU with the ``amp`` flag set for the steps (the model
    reads it at each call): (losses, first-step gradients, state
    after)."""
    model = port_tf.TransformerLM(max_len=T, device="cpu", **NET)
    opt = port_opt.Adam(model.reference_parameters(), 0.5)
    port_io.params_from_jax(before, model=model, optimizer=opt)
    assert opt.learning_rate == np.float32(LR)
    toks, lbls = (torch.from_numpy(a) for a in _feeds())
    before_launches = port_attn.flash_attention.launches
    losses, first = [], None
    port_config.set_flags(amp=amp)
    try:
        for i in range(steps):
            loss, logits = trainer.train_step(model, opt, toks, lbls)
            assert loss.dtype == torch.float32
            assert logits.dtype == (torch.bfloat16 if amp
                                    else torch.float32)
            losses.append(float(loss))
            if i == 0:
                first = {n: p.grad.detach().numpy().copy()
                         for n, p in model.reference_parameters().items()}
    finally:
        port_config.set_flags(amp=None)
    assert port_attn.flash_attention.launches == before_launches
    state = {n: t.detach().numpy()
             for n, t in model.reference_tensors().items()}
    state.update({n: t.numpy() for n, t in opt.accumulators().items()})
    for n, t in list(model.reference_tensors().items()) + \
            list(opt.accumulators().items()):
        assert t.dtype == torch.float32, n
    return losses, first, state


@pytest.fixture(scope="module")
def runs():
    """The reference and the port, amp off and on (built once: each
    reference program takes seconds to trace)."""
    out = {}
    for amp in (None, "bfloat16"):
        before, ref_losses, ref_grads, ref_after = _reference(amp)
        port_losses, port_grads, port_after = _port(before, amp)
        out[amp] = dict(before=before, ref=(ref_losses, ref_grads, ref_after),
                        port=(port_losses, port_grads, port_after))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_scope_names_are_the_models_and_adams(runs):
    before = runs[None]["before"]
    model = port_tf.TransformerLM(max_len=T, device="cpu", **NET)
    opt = port_opt.Adam(model.reference_parameters())
    names = set(model.reference_tensors()) | set(opt.accumulators())
    assert names | {port_opt.LR_NAME, RNG_STATE_VAR} == set(before)
    for n, t in opt.accumulators().items():
        assert tuple(t.shape) == before[n].shape, n
        if "_pow_acc_" in n:
            assert float(t) == float(before[n][0]), n


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_losses_match_reference(runs, amp):
    ref_losses, port_losses = runs[amp]["ref"][0], runs[amp]["port"][0]
    rtol = 1e-5 if amp is None else 1e-2
    np.testing.assert_allclose(port_losses, ref_losses, rtol=rtol)
    assert port_losses[-1] < port_losses[0]


def test_first_step_gradients_match_reference(runs):
    ref_grads, port_grads = runs[None]["ref"][1], runs[None]["port"][1]
    assert set(ref_grads) == set(port_grads)
    worst = max(ref_grads, key=lambda n: _rel(port_grads[n], ref_grads[n]))
    assert _rel(port_grads[worst], ref_grads[worst]) <= 1e-4, worst


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_parameters_after_steps_within_lr_bound(runs, amp):
    ref_after, port_after = runs[amp]["ref"][2], runs[amp]["port"][2]
    near, share = (1e-3, 0.99) if amp is None else (0.1, 0.90)
    model = port_tf.TransformerLM(max_len=T, device="cpu", **NET)
    for name in model.reference_tensors():
        diff = np.abs(port_after[name].astype(np.float64) - ref_after[name])
        assert diff.max() <= 2 * LR * STEPS, (name, diff.max())
        assert np.mean(diff <= near * LR) >= share, (name, np.mean(
            diff <= near * LR))


def test_accumulators_after_steps(runs):
    """Beta powers exactly; moments to 1e-3 of their norm (amp off)."""
    ref_after, port_after = runs[None]["ref"][2], runs[None]["port"][2]
    for name, want in ref_after.items():
        if "_pow_acc_" in name:
            np.testing.assert_array_equal(port_after[name], want)
        elif "_moment" in name:
            assert _rel(port_after[name], want) <= 1e-3, name


def _ref_adam(p, g, m, v, b1p, b2p, lr, attrs):
    op = types.SimpleNamespace(type="adam", attrs=attrs, outputs={})
    vals = {"Param": [p], "Grad": [g], "Moment1": [m], "Moment2": [v],
            "Beta1Pow": [b1p], "Beta2Pow": [b2p], "LearningRate": [lr]}
    out = registry.get_op_def("adam").compute(registry.ExecContext(op, vals))
    return [out[k] for k in ("ParamOut", "Moment1Out", "Moment2Out",
                             "Beta1PowOut", "Beta2PowOut")]


@pytest.mark.parametrize("attrs", [{}, dict(beta1=0.8, beta2=0.99,
                                            epsilon=1e-6)])
def test_adam_op_matches_reference_over_three_steps(attrs):
    rs = np.random.RandomState(1)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    p = rs.standard_normal((7, 5)).astype(np.float32)
    ref = [jnp.asarray(p), jnp.zeros((7, 5)), jnp.zeros((7, 5)),
           jnp.full((1,), b1, jnp.float32), jnp.full((1,), b2, jnp.float32)]
    port = [torch.from_numpy(np.asarray(x, np.float32).copy()) for x in ref]
    lr = np.float32([3e-3])
    for _ in range(3):
        g = rs.standard_normal((7, 5)).astype(np.float32)
        g[0, 0] = 0.0                       # an element with no gradient
        ref = _ref_adam(*ref[:1], jnp.asarray(g), *ref[1:],
                        jnp.asarray(lr), attrs)
        optimizer_ops.adam(port[0], torch.from_numpy(g), *port[1:],
                           float(lr[0]), b1, b2, attrs.get("epsilon", 1e-8))
    for want, got in zip(ref, port):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2.4e-7, atol=1e-12)


def test_lm_forward_dropout_and_ring_raise():
    with pytest.raises(NotImplementedError, match="per-op key split"):
        port_tf.TransformerLM(max_len=8, device="cpu", dropout_prob=0.1,
                              **NET)
    # ring_axis no longer raises: without a strategy whose mesh has the
    # axis the layers attend as usual, so the loss is the plain model's
    from paddle_tpu_torch import parallel
    ring = port_tf.TransformerLM(max_len=8, device="cpu", ring_axis="sp",
                                 **NET)
    plain = port_tf.TransformerLM(max_len=8, device="cpu", **NET)
    ring.reset_parameters(1)
    plain.reset_parameters(1)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, NET["vocab_size"], (2, 8)))
    want = plain(toks, toks)[0]
    assert torch.equal(ring(toks, toks)[0], want)
    # a one-rank "sp" axis: ring attention over one block
    prev = parallel.set_current_strategy(parallel.DistStrategy(
        parallel.make_mesh({"sp": 1})))
    try:
        got = ring(toks, toks)[0]
    finally:
        parallel.set_current_strategy(prev)
    assert abs(float(got) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))


def test_length_masked_loss_and_amp_serving_refused():
    model = port_tf.TransformerLM(max_len=16, device="cpu", **NET)
    model.reset_parameters(3)
    rs = np.random.RandomState(2)
    toks = torch.from_numpy(rs.randint(2, 100, (3, 16)))
    length = torch.tensor([16, 5, 9])
    loss, logits = port_tf.transformer_lm(model, toks, toks, length)
    per_tok = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 100), toks.reshape(-1), reduction="none")
    mask = torch.arange(16)[None, :] < length[:, None]
    torch.testing.assert_close(loss, per_tok.reshape(3, 16)[mask].mean())
    # the flag is read at each generation call and session build: a model
    # that trained under amp serves once the flag is off
    model.allocate_cache(1, 16)
    port_config.set_flags(amp="bfloat16")
    try:
        with pytest.raises(NotImplementedError, match="amp"):
            model.prefill(toks[:1], 4, 0)
        with pytest.raises(NotImplementedError, match="amp"):
            model.decode(toks[:1, :1], torch.tensor([4], dtype=torch.int32))
        spec = port_tf.transformer_lm_session(max_len=16, device="cpu",
                                              **NET)
        with pytest.raises(NotImplementedError, match="amp"):
            GenerationSession(spec, model.reference_tensors())
    finally:
        port_config.set_flags(amp=None)
    with torch.no_grad():
        want = model(toks[:1])[0, 3]
    got = model.prefill(toks[:1], 4, 0)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _reference_forward_runs(flags):
    """The reference's LM program (forward and loss, no optimizer) from
    its startup, run once under each ``amp`` flag value of ``flags`` on
    one executor and scope, the flag set before each run as a user sets
    it: (the scope after startup, [(loss, logits) per run])."""
    ptpu.config.set_flags(flash_attention=True)
    try:
        with ptpu.unique_name.guard():
            main, startup = ptpu.Program(), ptpu.Program()
            main.random_seed = startup.random_seed = 21
            with ptpu.program_guard(main, startup):
                toks = layers.data("toks", shape=[T], dtype="int64")
                lbls = layers.data("lbls", shape=[T], dtype="int64")
                loss, logits = ref_tf.transformer_lm(toks, lbls, **NET)
        exe = ptpu.Executor()
        scope = ptpu.Scope()
        toks_v, lbls_v = _feeds()
        runs = []
        with ptpu.scope_guard(scope):
            exe.run(startup)
            before = _state(scope)
            for amp in flags:
                ptpu.config.set_flags(amp=amp)
                out = exe.run(main, feed={"toks": toks_v, "lbls": lbls_v},
                              fetch_list=[loss, logits], return_numpy=False)
                runs.append((float(np.asarray(out[0])),
                             np.asarray(out[1].astype(jnp.float32)),
                             str(out[1].dtype)))
    finally:
        ptpu.config.set_flags(flash_attention=False, amp=None)
    return before, runs


def test_amp_flag_read_at_each_call_like_the_reference():
    """One port model follows the ``amp`` flag call by call (off, on,
    off), as the reference's executor reads it at each run of one
    program and scope: each forward and loss matches the reference's run
    under the same flag (losses to the amp case's tolerances; logits
    float32 or bfloat16 as the reference's are, within 1e-4 of their
    magnitude amp off and 2^-5 amp on, a few bf16 steps through two
    layers of bf16 products summed in other orders)."""
    flags = (None, "bfloat16", None)
    before, ref_runs = _reference_forward_runs(flags)
    model = port_tf.TransformerLM(max_len=T, device="cpu", **NET)
    port_io.params_from_jax(before, model=model)
    toks, lbls = (torch.from_numpy(a) for a in _feeds())
    got = []
    try:
        for amp in flags:
            port_config.set_flags(amp=amp)
            with torch.no_grad():
                loss, logits = model(toks, lbls)
            got.append((float(loss), logits))
    finally:
        port_config.set_flags(amp=None)
    for amp, (ref_loss, ref_logits, ref_dtype), (loss, logits) in zip(
            flags, ref_runs, got):
        assert ref_dtype == ("bfloat16" if amp else "float32")
        assert logits.dtype == (torch.bfloat16 if amp else torch.float32)
        np.testing.assert_allclose(loss, ref_loss,
                                   rtol=1e-2 if amp else 1e-5)
        tol = (2.0 ** -5 if amp else 1e-4) * np.abs(ref_logits).max()
        assert np.abs(logits.float().numpy() - ref_logits).max() <= tol
    # off, on, off: the two runs without amp agree exactly, the amp run
    # differs from them
    assert got[0][0] == got[2][0]
    assert torch.equal(got[0][1], got[2][1])
    assert not torch.equal(got[0][1], got[1][1].float())
