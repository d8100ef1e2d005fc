"""bfloat16 K/V caches (``generation_kv_dtype``): the reference's
GenerationSession and the port's over the same weights, the session
builder's dtype rule, the pool-size repair, and the bf16 decode and
prefill attention against the reference's.

Greedy tokens must be identical, dense and paged with the prefix cache.
The plain B4 and B5 versions on bf16 caches are held to atol = rtol =
1e-5 against ``_decode_reference`` / ``_decode_paged_reference`` and
the interpreted Pallas kernels: the same upcast inputs and float32
math, sums in another order. The paged prefill op is held to the same
tolerance against the reference's op. Cache writes round float32 to
bfloat16 half to even in both packages, so the caches must be equal
exactly."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu.models.transformer import (transformer_lm,
                                           transformer_lm_session)
from paddle_tpu.ops import pallas_attention as ref_pa
from paddle_tpu.serving import GenerationSession
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch.models import transformer as port_tf
from paddle_tpu_torch.ops import flash_attention as port_fa
from paddle_tpu_torch.ops import generation_ops
from paddle_tpu_torch.serving import generation as port_gen
from test_torch_generation_ops import _run_one_op
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V, MAXLEN, CACHE = 29, 12, 16
KW = dict(d_model=16, num_heads=2, d_ff=32, num_layers=2)
BOS, EOS = 0, 1
BUCKETS, BS = (4, 8), 4
# ragged prompts crossing block edges, then shared prefixes
PROMPTS = ([BOS], [BOS, 5, 7], [2, 3, 4, 5, 6], [2, 3, 4, 5, 6, 7, 8],
           [2, 3, 4, 5, 6, 7, 8], [2, 3, 4, 5, 6, 9], [9, 8, 7, 6, 5, 4])
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _flags():
    prev = ptpu.config.get_flag("flash_attention")
    ptpu.config.set_flags(flash_attention=True)
    yield
    ptpu.config.set_flags(flash_attention=prev, generation_kv_dtype=None)
    port_config.set_flags(generation_kv_dtype=None)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Randomized LM weights in a reference scope, saved and read back by
    the port: (scope, {name: np.ndarray})."""
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
    return scope, port_io.load_params(d)


def _ref_session(scope, paged, kv_dtype="bfloat16"):
    ptpu.config.set_flags(generation_kv_dtype=kv_dtype)
    try:
        spec = transformer_lm_session(
            V, max_len=MAXLEN, slots=3, cache_len=CACHE,
            prompt_buckets=BUCKETS, bos_id=BOS, eos_id=EOS, paged=paged,
            block_size=BS, prefix_cache=paged, **KW)
    finally:
        ptpu.config.set_flags(generation_kv_dtype=None)
    return GenerationSession(spec, scope=scope)


def _port_session(named, paged, dtype="bfloat16"):
    spec = port_tf.transformer_lm_session(
        V, max_len=MAXLEN, slots=3, cache_len=CACHE,
        prompt_buckets=BUCKETS, eos_id=EOS, device="cpu", paged=paged,
        block_size=BS, prefix_cache=paged, dtype=dtype, **KW)
    return port_gen.GenerationSession(
        spec, port_io.params_from_jax(named, device="cpu"))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_bf16_greedy_tokens_equal_reference(weights, paged):
    scope, named = weights
    ref, port = _ref_session(scope, paged), _port_session(named, paged)
    assert str(ref.spec.cache_vars[0][2]) == "bfloat16"
    assert port.model.caches[0][0].dtype == torch.bfloat16
    outs = []
    for prompt in PROMPTS:
        want = [int(t) for t in ref.generate(prompt, eos_id=-1)]
        got = port.generate(prompt, eos_id=-1)
        assert got == want, prompt
        outs.append(tuple(got))
    assert len(set(outs)) > 3
    if paged:
        assert port.prefill_log == ref.prefill_log
        assert port.prefix_stats()["hits"] == ref.prefix_stats()["hits"] > 0
        port.check_pool_invariant()
    assert port_fa.decode_attention.launches == 0          # CPU: plain
    assert port_fa.decode_attention_paged.launches == 0


def test_bytes_per_block_halves(weights):
    """The repair: bytes_per_block follows the pools' element size, as
    the reference's does."""
    scope, named = weights
    stats = {}
    for dtype in ("float32", "bfloat16"):
        port = _port_session(named, True, dtype)
        ref = _ref_session(scope, True, kv_dtype=dtype)
        stats[dtype] = port.pool_stats()["bytes_per_block"]
        assert stats[dtype] == ref.pool_stats()["bytes_per_block"]
        port.close()
    assert stats["float32"] == BS * KW["d_model"] * 4 * 2 * KW["num_layers"]
    assert stats["float32"] == 2 * stats["bfloat16"]


@pytest.mark.parametrize("flag,explicit,want", [
    (None, "float32", "float32"),
    ("bfloat16", "float32", "bfloat16"),    # the flag fills the default
    ("bfloat16", "float16", "float16"),     # an explicit dtype wins
    (None, "bfloat16", "bfloat16"),
])
def test_dtype_rule_matches_reference(flag, explicit, want):
    ptpu.config.set_flags(generation_kv_dtype=flag)
    port_config.set_flags(generation_kv_dtype=flag)
    kw = dict(max_len=MAXLEN, slots=2, cache_len=MAXLEN,
              prompt_buckets=(4,), dtype=explicit, **KW)
    ref = transformer_lm_session(V, **kw)
    port = port_tf.transformer_lm_session(V, device="cpu", **kw)
    assert str(ref.cache_vars[0][2]) == port.dtype == want
    assert port_tf.kv_dtype(port.dtype) == getattr(torch, want)
    with pytest.raises(ValueError, match="floating"):
        port_tf.transformer_lm_session(V, device="cpu",
                                       **dict(kw, dtype="int8"))


def _bf16(rs, shape):
    """Standard-normal values rounded to bfloat16: (ml_dtypes array for
    JAX, torch bfloat16 tensor), the same numbers."""
    a = rs.standard_normal(shape).astype(ml_dtypes.bfloat16)
    return a, torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def test_decode_plain_on_bf16_cache_matches_reference():
    rs = np.random.RandomState(0)
    s, h, d, c = 3, 2, 8, 20
    q = rs.standard_normal((s, h * d)).astype(np.float32)
    kj, kt = _bf16(rs, (s, c, h * d))
    vj, vt = _bf16(rs, (s, c, h * d))
    lengths = np.array([1, 9, 20], np.int32)
    got = port_fa.decode_attention(torch.from_numpy(q), kt, vt,
                                   torch.from_numpy(lengths), h).numpy()
    kh = jnp.asarray(kj).reshape(s, c, h, d).transpose(0, 2, 1, 3)
    vh = jnp.asarray(vj).reshape(s, c, h, d).transpose(0, 2, 1, 3)
    kernel = np.asarray(ref_pa.decode_attention(
        jnp.asarray(q).reshape(s, h, d), kh, vh, jnp.asarray(lengths),
        interpret=True)).reshape(s, h * d)
    np.testing.assert_allclose(got, kernel, **TOL)
    plain = np.asarray(ref_pa._decode_reference(
        jnp.asarray(q).reshape(s * h, 1, d), kh.reshape(s * h, c, d),
        vh.reshape(s * h, c, d), jnp.repeat(jnp.asarray(lengths), h)))
    np.testing.assert_allclose(got, plain.reshape(s, h * d), **TOL)


def test_decode_paged_plain_on_bf16_pool_matches_reference():
    rs = np.random.RandomState(1)
    s, h, d, nb, bs, mb = 4, 2, 8, 12, 4, 4
    q = rs.standard_normal((s, 1, h * d)).astype(np.float32)
    kj, kt = _bf16(rs, (nb, bs, h * d))
    vj, vt = _bf16(rs, (nb, bs, h * d))
    lengths = np.array([1, 4, 5, 16], np.int32)
    tables = np.full((s, mb), nb, np.int32)
    perm = iter(rs.permutation(nb))
    for si, n in enumerate(lengths):
        for j in range(-(-int(n) // bs)):
            tables[si, j] = next(perm)
    got = port_fa.decode_attention_paged(
        torch.from_numpy(q[:, 0]), kt, vt, torch.from_numpy(lengths),
        torch.from_numpy(tables), h).numpy()
    args = (jnp.asarray(q), jnp.asarray(kj), jnp.asarray(vj),
            jnp.asarray(lengths), jnp.asarray(tables), h)
    kernel = np.asarray(ref_pa.decode_attention_paged(*args,
                                                      interpret=True))
    np.testing.assert_allclose(got, kernel[:, 0], **TOL)
    plain = np.asarray(ref_pa._decode_paged_reference(*args))
    np.testing.assert_allclose(got, plain[:, 0], **TOL)


@pytest.mark.parametrize("hist,length,bucket", [(0, 5, 8), (6, 3, 4)])
def test_prefill_paged_on_bf16_pool_matches_reference(hist, length, bucket):
    nb, bs, h, hd, mb = 9, 4, 2, 8, 4
    rs = np.random.RandomState(hist * 10 + length)
    q = rs.standard_normal((1, bucket, h * hd)).astype(np.float32)
    kj, kt = _bf16(rs, (nb, bs, h * hd))
    vj, vt = _bf16(rs, (nb, bs, h * hd))
    live = -(-(hist + length) // bs)
    table = np.full(mb, nb, np.int32)
    table[:live] = rs.permutation(nb)[:live]
    want = _run_one_op("multihead_attention_prefill_paged",
                       {"Q": q, "CacheK": kj, "CacheV": vj, "Table": table,
                        "Hist": np.array([hist], np.int32),
                        "Len": np.array([length], np.int32)},
                       {"num_heads": h}, out_shape=q.shape)
    sink = torch.zeros((1, bs, h * hd), dtype=torch.bfloat16)
    got = generation_ops.multihead_attention_prefill_paged(
        torch.from_numpy(q), torch.cat([kt, sink]), torch.cat([vt, sink]),
        torch.from_numpy(table), hist, h)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_cache_writes_round_like_the_reference():
    """kv_cache_write_paged into a bf16 pool rounds the f32 rows half to
    even, bit for bit as the reference's op does."""
    nb, bs, d = 5, 4, 6
    rs = np.random.RandomState(3)
    pj, pt = _bf16(rs, (nb, bs, d))
    new = rs.standard_normal((1, 6, d)).astype(np.float32)
    table = np.array([3, 1, 4], np.int32)
    want = _run_one_op("kv_cache_write_paged",
                       {"Cache": pj, "New": new, "Table": table,
                        "Hist": np.array([2], np.int32),
                        "Len": np.array([5], np.int32)}, {}, cache="Cache")
    got = torch.cat([pt, torch.zeros((1, bs, d), dtype=torch.bfloat16)])
    generation_ops.kv_cache_write_paged(got, torch.from_numpy(new),
                                        torch.from_numpy(table), 2, 5)
    assert np.array_equal(got[:nb].float().numpy(),
                          np.asarray(want).astype(np.float32))


def test_decode_wrappers_check_the_cache_pair():
    q = torch.zeros(2, 128)
    f32 = torch.zeros(2, 4, 128)
    bf = f32.to(torch.bfloat16)
    assert port_fa._check_decode_inputs(q, f32, f32) == "f32"
    assert port_fa._check_decode_inputs(q, bf, bf) == "bf16"
    for k, v in ((f32, bf), (bf, f32), (f32.half(), f32.half())):
        with pytest.raises(ValueError, match="both"):
            port_fa._check_decode_inputs(q, k, v)
    with pytest.raises(ValueError, match="q must be"):
        port_fa._check_decode_inputs(q.to(torch.bfloat16), bf, bf)
