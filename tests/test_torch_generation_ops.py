"""The port's KV-cache and attention ops against the reference's ops,
each run through a one-op reference program.

Tolerances: the cache writes are copies, so they must be equal exactly;
the attention ops are float32 with atol = rtol = 1e-5 (same math, sums
in another order). The reference runs with ``flash_attention`` on, its
Pallas kernels in interpret mode, which is the configuration the port
reproduces."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu_torch.ops import attention_ops, generation_ops

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _flash_on():
    prev = ptpu.config.get_flag("flash_attention")
    ptpu.config.set_flags(flash_attention=True)
    yield
    ptpu.config.set_flags(flash_attention=prev)


def _run_one_op(op_type, inputs, attrs, out_shape=None, cache=None):
    """Run one reference op. ``inputs`` maps slot -> np array; a slot
    named in ``cache`` is a persistable variable updated in place (the
    op's Out aliases it), otherwise Out is fetched."""
    main, startup = ptpu.Program(), ptpu.Program()
    scope = ptpu.Scope()
    feed = {}
    with ptpu.program_guard(main, startup):
        block = main.global_block()
        names = {}
        for slot, val in inputs.items():
            if slot == cache:
                block.create_var(name="cache", shape=val.shape,
                                 persistable=True, stop_gradient=True)
                scope.set_var("cache", jnp.asarray(val))
                names[slot] = "cache"
            else:
                var = layers.data(slot.lower(), shape=list(val.shape),
                                  dtype=str(val.dtype),
                                  append_batch_size=False)
                feed[var.name] = val
                names[slot] = var.name
        if cache is None:
            out = block.create_var(name="out", shape=out_shape)
            out_name = out.name
        else:
            out_name = "cache"
        block.append_op(type=op_type,
                        inputs={k: [v] for k, v in names.items()},
                        outputs={"Out": [out_name]}, attrs=attrs)
    exe = ptpu.Executor()
    fetched = exe.run(main, feed=feed,
                      fetch_list=[] if cache else [out_name], scope=scope)
    if cache is not None:
        return np.asarray(scope.find_var("cache"))
    return np.asarray(fetched[0])


def test_kv_cache_write_slot_matches_reference():
    rs = np.random.RandomState(0)
    cache = rs.standard_normal((3, 8, 4)).astype(np.float32)
    new = rs.standard_normal((1, 5, 4)).astype(np.float32)
    for slot in (1, 7):   # 7 is out of range: both clamp to the last slot
        want = _run_one_op("kv_cache_write_slot",
                           {"Cache": cache, "New": new,
                            "Slot": np.array([slot], np.int32)}, {},
                           cache="Cache")
        got = torch.from_numpy(cache.copy())
        generation_ops.kv_cache_write_slot(got, torch.from_numpy(new), slot)
        np.testing.assert_array_equal(got.numpy(), want)


def test_kv_cache_append_matches_reference():
    rs = np.random.RandomState(1)
    cache = rs.standard_normal((4, 8, 4)).astype(np.float32)
    new = rs.standard_normal((4, 1, 4)).astype(np.float32)
    pos = np.array([5, 0, 7, 11], np.int32)   # 11 clamps to row 7
    want = _run_one_op("kv_cache_append",
                       {"Cache": cache, "New": new, "Pos": pos}, {},
                       cache="Cache")
    got = torch.from_numpy(cache.copy())
    generation_ops.kv_cache_append(got, torch.from_numpy(new),
                                   torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,pos", [(16, (0, 5, 15)), (64, (63, 1, 30))])
def test_multihead_attention_decode_matches_reference(c, pos):
    rs = np.random.RandomState(c)
    s, h, d = len(pos), 2, 8
    q = rs.standard_normal((s, 1, h * d)).astype(np.float32)
    ck = rs.standard_normal((s, c, h * d)).astype(np.float32)
    cv = rs.standard_normal((s, c, h * d)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want = _run_one_op("multihead_attention_decode",
                       {"Q": q, "CacheK": ck, "CacheV": cv, "Pos": pos},
                       {"num_heads": h}, out_shape=q.shape)
    got = generation_ops.multihead_attention_decode(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(pos), h)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t,key_len", [(8, 5), (128, 77), (16, None)])
def test_multihead_attention_prefill_matches_reference(t, key_len):
    """The prefill attention: causal, KeyLength masking the padded
    prompt tail (segment ids inside the flash path)."""
    rs = np.random.RandomState(t)
    h, d = 2, 8
    q, k, v = (rs.standard_normal((1, t, h * d)).astype(np.float32)
               for _ in range(3))
    inputs = {"Q": q, "K": k, "V": v}
    if key_len is not None:
        inputs["KeyLength"] = np.array([key_len], np.int32)
    want = _run_one_op("multihead_attention", inputs,
                       {"num_heads": h, "causal": True, "ring_axis": None},
                       out_shape=q.shape)
    got = attention_ops.multihead_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h,
        causal=True,
        key_length=None if key_len is None
        else torch.tensor([key_len], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_multihead_attention_dense_branch_matches_reference():
    """Queries and keys of different lengths take the dense branch."""
    rs = np.random.RandomState(4)
    h, d = 2, 8
    q = rs.standard_normal((2, 3, h * d)).astype(np.float32)
    k = rs.standard_normal((2, 7, h * d)).astype(np.float32)
    v = rs.standard_normal((2, 7, h * d)).astype(np.float32)
    klen = np.array([7, 4], np.int32)
    want = _run_one_op("multihead_attention",
                       {"Q": q, "K": k, "V": v, "KeyLength": klen},
                       {"num_heads": h, "causal": False, "ring_axis": None},
                       out_shape=q.shape)
    got = attention_ops.multihead_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h,
        key_length=torch.from_numpy(klen))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
