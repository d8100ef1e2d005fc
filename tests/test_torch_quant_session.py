"""int8 weight compute end to end: the reference's GenerationSession
with ``serving_quant_compute`` on and the port's, over the same weights
(saved with ``paddle_tpu.io.save_params``, read back by
``paddle_tpu_torch.io.load_params``).

The reference's arming quantizes its scope in place, so every int8
reference session gets its own copy of the scope. Everything compared
is exact: armed names, int8 weights and scales (bitwise) and greedy
tokens, dense and paged. The reference runs with ``flash_attention`` on
(its Pallas kernels interpreted on the CPU); the port takes its plain
versions on CPU tensors. The int8-vs-f32 agreement gate (>= 0.95 of
greedy tokens) is the reference's own (``tests/test_quant_compute.py``).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models.transformer import (transformer_lm,
                                           transformer_lm_session)
from paddle_tpu.serving import GenerationSession
from paddle_tpu.serving import quant as ref_quant
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import quant_ops as port_q
from paddle_tpu_torch.serving import generation as port_gen
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V, MAXLEN = 29, 12
KW = dict(d_model=16, num_heads=2, d_ff=32, num_layers=2)
BOS, EOS = 0, 1
BUCKETS, BS = (4, 8), 4
PROMPTS = ([2, 3], [4, 5, 6, 7, 8], [9, 3, 2], [BOS, 5, 7],
           [2, 3, 4, 5, 6, 7, 8], [2, 3, 4, 5, 6, 9])
NEW = 8


@pytest.fixture(autouse=True)
def _flags():
    prev = ptpu.config.get_flag("flash_attention")
    ptpu.config.set_flags(flash_attention=True)
    yield
    ptpu.config.set_flags(flash_attention=prev, serving_quant_compute=False)
    port_config.set_flags(serving_quant_compute=False)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Randomized LM weights, saved by the reference and read back by the
    port: {name: np.ndarray}."""
    with ptpu.unique_name.guard():
        main, startup = ptpu.Program(), ptpu.Program()
        with ptpu.program_guard(main, startup):
            toks = layers.data("toks", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            lbls = layers.data("lbls", shape=[1, MAXLEN], dtype="int64",
                               append_batch_size=False)
            transformer_lm(toks, lbls, vocab_size=V, is_test=True, **KW)
    exe = ptpu.Executor()
    scope = ptpu.Scope()
    with ptpu.scope_guard(scope):
        exe.run(startup)
    rs = np.random.RandomState(7)
    for n in sorted(scope.var_names()):
        cur = np.asarray(scope.find_var(n))
        scope.set_var(n, rs.standard_normal(cur.shape).astype(cur.dtype))
    d = str(tmp_path_factory.mktemp("lm_params"))
    ptpu.io.save_params(exe, d, main_program=main, scope=scope)
    return port_io.load_params(d)


def _scope(named):
    """A fresh reference scope holding a copy of the weights."""
    scope = ptpu.Scope()
    for name, val in named.items():
        scope.set_var(name, np.array(val))
    return scope


def _ref_session(named, quant, paged):
    ptpu.config.set_flags(serving_quant_compute=quant)
    try:
        spec = transformer_lm_session(
            V, max_len=MAXLEN, slots=2, cache_len=MAXLEN,
            prompt_buckets=BUCKETS, bos_id=BOS, eos_id=EOS, paged=paged,
            block_size=BS, prefix_cache=paged, **KW)
        return GenerationSession(spec, scope=_scope(named))
    finally:
        ptpu.config.set_flags(serving_quant_compute=False)


def _port_session(params, paged, arm_quant=None, device="cpu"):
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=2, cache_len=MAXLEN,
        prompt_buckets=BUCKETS, eos_id=EOS, device=device, paged=paged,
        block_size=BS, prefix_cache=paged, **KW)
    return port_gen.GenerationSession(
        spec, port_io.params_from_jax(params, device=device),
        arm_quant=arm_quant)


def _tokens(sess):
    return [[int(t) for t in sess.generate(list(p), max_new_tokens=NEW,
                                           eos_id=-1)] for p in PROMPTS]


def _armed_scope(sess):
    """{name: array} of an armed reference session's scope: every
    parameter, the int8 weights and their ``@quant.scale`` arrays."""
    names = [n for n in sess.scope.var_names()
             if not n.startswith("kv_session")]
    return {n: np.asarray(sess.scope.find_var(n)) for n in names}


def test_armed_names_equal_reference_selection(weights):
    ref = _ref_session(weights, quant=True, paged=True)
    port = _port_session(weights, paged=True, arm_quant=True)
    want = port_tf.lm_mul_weight_names(KW["num_layers"])
    assert len(want) == 6 * KW["num_layers"] + 1
    assert ref._quant_armed == want
    assert port._quant_armed == want
    # the reference's own selection over its prefill and decode programs
    progs = list(ref.spec.prefill_programs.values()) + [
        ref.spec.decode_program]
    selected = {}
    for prog in progs:
        selected.update(ref_quant.select_compute_vars(prog))
    assert sorted(selected) == want and set(selected.values()) == {1}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_weights_and_scales_bitwise(weights, paged):
    ref = _ref_session(weights, quant=True, paged=paged)
    port = _port_session(weights, paged=paged, arm_quant=True)
    armed = _armed_scope(ref)
    for name in port._quant_armed:
        w, s = port.model.mul_weight(name)
        assert w.dtype == torch.int8 and armed[name].dtype == np.int8
        assert np.array_equal(w.numpy(), armed[name])
        assert np.array_equal(s.numpy(),
                              armed[port_q.scale_var_name(name)])
    # no float32 copy of an armed weight: every other parameter is one
    # of the float32 names
    f32 = {n for n, p in port.model.named_parameters()
           if p.dtype == torch.float32}
    assert len(f32) == len(port_tf.lm_param_names(2)) - len(port._quant_armed)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_tokens_equal_reference_int8(weights, paged):
    want = _tokens(_ref_session(weights, quant=True, paged=paged))
    port = _port_session(weights, paged=paged, arm_quant=True)
    assert _tokens(port) == want
    assert port_q.quant_matmul_2d.launches == 0          # CPU: plain


def test_int8_agrees_with_f32_on_95_percent(weights):
    t32 = _tokens(_port_session(weights, paged=True, arm_quant=False))
    t8 = _tokens(_port_session(weights, paged=True, arm_quant=True))
    flat32 = [t for toks in t32 for t in toks]
    flat8 = [t for toks in t8 for t in toks]
    agree = np.mean([a == b for a, b in zip(flat32, flat8)])
    assert agree >= 0.95, (agree, t32, t8)


@pytest.mark.parametrize("arm", [None, True])
def test_armed_reference_scope_serves_unchanged(weights, arm):
    """An int8 scope from the reference loads through params_from_jax as
    it is (no second quantization) and gives the same tokens."""
    ref = _ref_session(weights, quant=True, paged=True)
    want = _tokens(ref)
    armed = _armed_scope(ref)
    assert any(n.endswith("@quant.scale") for n in armed)
    port = _port_session(armed, paged=True, arm_quant=arm)
    for name in port_tf.lm_mul_weight_names(2):
        assert np.array_equal(port.model.mul_weight(name)[0].numpy(),
                              armed[name])
    assert port._quant_armed == \
        (port_tf.lm_mul_weight_names(2) if arm else [])
    assert _tokens(port) == want


def test_arm_quant_false_keeps_f32_and_flag_read_at_construction(weights):
    port_config.set_flags(serving_quant_compute=True)
    armed = _port_session(weights, paged=True)               # flag read
    kept = _port_session(weights, paged=True, arm_quant=False)
    port_config.set_flags(serving_quant_compute=False)
    assert armed._quant_armed and not kept._quant_armed
    assert all(p.dtype == torch.float32 for p in kept.model.parameters())
    # flipping the flag after construction changes nothing
    assert _tokens(armed) == _tokens(
        _port_session(weights, paged=True, arm_quant=True))
    assert _tokens(kept) == _tokens(
        _port_session(weights, paged=True, arm_quant=False))
    assert armed.model.mul_weight("lm_head.w")[0].dtype == torch.int8
    # arming again is idempotent: nothing is quantized a second time
    w0 = armed.model.mul_weight("lm_head.w")[0]
    from paddle_tpu_torch.serving import quant as port_quant
    assert port_quant.arm_quant_compute(armed.model) == armed._quant_armed
    assert armed.model.mul_weight("lm_head.w")[0] is w0


@pytest.mark.parametrize("edit", ["scale_alone", "int8_alone",
                                  "scale_of_bias", "int8_embedding"])
def test_params_from_jax_rejects_unpaired_quant_names(weights, edit):
    named = dict(weights)
    q, s = ref_quant.quantize_array(named["mha_0.o.w"], 1)
    if edit == "scale_alone":
        named["mha_0.o.w@quant.scale"] = s
    elif edit == "int8_alone":
        named["mha_0.o.w"] = q
    elif edit == "scale_of_bias":
        named["enc_0.ffn1.b@quant.scale"] = np.ones(1, np.float32)
    else:
        named["tok_embedding"] = named["tok_embedding"].astype(np.int8)
    with pytest.raises(ValueError, match="missing|unknown"):
        port_io.params_from_jax(named, device="cpu")
