"""The op types of the cached generation programs in the port's registry,
each in a one-op program that both packages build (their front ends'
``data`` layers and ``append_op``) and run (their executors), on the same
seeded numpy inputs. The reference runs with its ``flash_attention``
flag on, its Pallas kernels interpreted; the port on the CPU, where the
decode attentions take kernels B4's and B5's plain versions.

* The one-op programs serialize byte-identical (the output shapes and
  dtypes each package infers, the port on ``meta`` tensors, included).
* ``kv_cache_write_slot``, ``kv_cache_append``, ``kv_cache_write_paged``,
  ``kv_cache_append_paged`` and ``kv_block_copy``: the caches after the
  run bitwise the reference's (a paged pool's first NB blocks: the port's
  storage holds a sink block past them), written in place (the scope's
  tensor is the one it held before), and under ``nonfinite_guard`` a run
  whose float fetch is not finite leaves them as they were, as in the
  reference.
* ``multihead_attention_decode``, ``multihead_attention_decode_paged``,
  ``multihead_attention_prefill_paged``: within 1e-6 of max|out|; in a
  program tagged as the speculative verify, the paged prefill attention
  is the W decode queries of B5's route, within 1e-6 of the reference's
  prefill attention.
* ``decode_sample`` (mask on and off) and ``decode_verify`` (greedy and
  sampled): tokens and accept counts exact.
* ``transpose``, ``gather``, ``slice`` and ``arg_max``: bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ptpu
from paddle_tpu import layers as ref_layers
from paddle_tpu.core import serialization as ref_ser
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch import core as pc
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch.core import serialization as port_ser
from paddle_tpu_torch.ops import generation_ops

NB, BS, D, H, S = 6, 4, 8, 2, 3


@pytest.fixture(autouse=True)
def _flags():
    prev = ptpu.config.get_flag("flash_attention")
    ptpu.config.set_flags(flash_attention=True)
    yield
    ptpu.config.set_flags(flash_attention=prev, nonfinite_guard=False)
    port_config.set_flags(nonfinite_guard=False)


def _build(pkg, op_type, inputs, attrs, caches, outs):
    """A one-op program of ``pkg`` ("ref" or "port"): feeds for the
    inputs, persistable variables (declared with the reference's shape)
    for the slots in ``caches``, the outputs ``outs`` (a cache op's
    ``Out`` names its cache). Returns (program, {slot: var name})."""
    fw = ptpu if pkg == "ref" else pc
    layers = ref_layers if pkg == "ref" else port_layers
    main = fw.Program()
    with fw.unique_name.guard(), fw.program_guard(main, fw.Program()):
        block = main.global_block()
        names = {}
        for slot, val in inputs.items():
            if slot in caches:
                names[slot] = "cache_" + slot.lower()
                block.create_var(name=names[slot], shape=val.shape,
                                 dtype=str(val.dtype), persistable=True,
                                 stop_gradient=True)
            else:
                names[slot] = layers.data(
                    slot.lower(), shape=list(val.shape),
                    dtype=str(val.dtype), append_batch_size=False).name
        out_names = {}
        for slot in outs:
            if slot == "Out" and "Cache" in caches:
                out_names[slot] = names["Cache"]
            else:
                out_names[slot] = block.create_var(
                    name="out_" + slot.lower()).name
        block.append_op(type=op_type,
                        inputs={k: [v] for k, v in names.items()},
                        outputs={k: [v] for k, v in out_names.items()},
                        attrs=attrs)
    return main, names, out_names


_DENSE_OPS = ("kv_cache_write_slot", "kv_cache_append",
              "multihead_attention_decode")


def _run_pkg(pkg, op_type, inputs, attrs, caches, outs, fetch, tag):
    """One package's run: (program, {fetched slot: array}, {cache slot:
    array after the run}, scope, {slot: var name}, {cache slot: the
    tensor the scope held before})."""
    main, names, out_names = _build(pkg, op_type, inputs, attrs, caches,
                                    outs)
    feed = {names[k]: v for k, v in inputs.items() if k not in caches}
    slots = list(fetch) if fetch is not None else \
        [s for s in outs if out_names[s] not in names.values()]
    fetch_names = [out_names.get(s, names.get(s)) for s in slots]
    if pkg == "ref":
        scope = ptpu.Scope()
        for k in caches:
            scope.set_var(names[k], jnp.asarray(inputs[k]))
        got = ptpu.Executor().run(main, feed=feed, fetch_list=fetch_names,
                                  scope=scope)
        after = {k: np.asarray(scope.find_var(names[k])) for k in caches}
        held = None
    else:
        if tag:
            setattr(main, tag, True)
        scope = pc.Scope()
        for k in caches:
            val = inputs[k]
            if op_type not in _DENSE_OPS:
                # the paged storage: a sink block past the pool
                val = np.concatenate([val, np.zeros_like(val[:1])])
            scope.set_var(names[k], torch.from_numpy(val.copy()))
        held = {k: scope.find_var(names[k]) for k in caches}
        got = pc.Executor(device="cpu").run(main, feed=feed,
                                            fetch_list=fetch_names,
                                            scope=scope)
        after = {k: scope.find_var(names[k]).numpy()[:inputs[k].shape[0]]
                 for k in caches}
    out = dict(zip(slots, [np.asarray(g) for g in got]))
    return main, out, after, (scope, names, held)


def _run(op_type, inputs, attrs=None, caches=(), outs=("Out",),
         fetch=None, tag=None):
    """Both packages' runs of the one-op program, after checking that
    they serialize alike: (reference outputs, reference caches after,
    port outputs, port caches after, (port scope, names, held))."""
    args = (op_type, inputs, attrs or {}, caches, outs, fetch, tag)
    ref_main, ref_out, ref_after, _ = _run_pkg("ref", *args)
    port_main, port_out, port_after, state = _run_pkg("port", *args)
    assert port_ser.program_to_dict(port_main) == \
        ref_ser.program_to_dict(ref_main)
    return ref_out, ref_after, port_out, port_after, state


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pool(rs, dtype=np.float32):
    return rs.standard_normal((NB, BS, D)).astype(dtype)


def _cache_cases():
    rs = np.random.RandomState(0)
    dense = rs.standard_normal((S, 12, D)).astype(np.float32)
    table = np.array([[2, 0, 5], [4, NB, NB], [1, 3, NB]], np.int32)
    return {
        "write_slot": ("kv_cache_write_slot", {
            "Cache": dense, "New": rs.standard_normal((1, 5, D)).astype(
                np.float32), "Slot": np.array([1], np.int32)}),
        "append": ("kv_cache_append", {
            "Cache": dense, "New": rs.standard_normal((S, 1, D)).astype(
                np.float32), "Pos": np.array([0, 11, 4], np.int32)}),
        "write_paged": ("kv_cache_write_paged", {
            "Cache": _pool(rs), "New": rs.standard_normal((1, 8, D)).astype(
                np.float32), "Table": np.array([3, 1, 4], np.int32),
            "Hist": np.array([2], np.int32), "Len": np.array([6], np.int32)}),
        "append_paged": ("kv_cache_append_paged", {
            "Cache": _pool(rs), "New": rs.standard_normal((S, 1, D)).astype(
                np.float32), "Pos": np.array([5, 2, 9], np.int32),
            "Table": table}),
        "block_copy": ("kv_block_copy", {
            "Cache": _pool(rs), "Src": np.array([4], np.int32),
            "Dst": np.array([1], np.int32)}),
    }


@pytest.mark.parametrize("case", sorted(_cache_cases()))
def test_cache_ops_bitwise_and_in_place(case):
    op_type, inputs = _cache_cases()[case]
    _, ref_after, _, port_after, (scope, names, held) = _run(
        op_type, inputs, caches=("Cache",))
    np.testing.assert_array_equal(port_after["Cache"], ref_after["Cache"])
    assert not np.array_equal(ref_after["Cache"], inputs["Cache"])
    # written in place: the scope holds the tensor it held before
    assert scope.find_var(names["Cache"]) is held["Cache"]


@pytest.mark.parametrize("case", ["write_slot", "append_paged"])
def test_cache_ops_keep_the_caches_of_a_poisoned_run(case):
    """``nonfinite_guard`` with a non-finite float fetch (the New rows,
    NaN here): both packages leave the cache as it was; with the guard
    off both write the NaN rows."""
    op_type, inputs = _cache_cases()[case]
    inputs = dict(inputs, New=np.full_like(inputs["New"], np.nan))
    for guard in (True, False):
        ptpu.config.set_flags(nonfinite_guard=guard)
        port_config.set_flags(nonfinite_guard=guard)
        _, ref_after, _, port_after, _ = _run(
            op_type, inputs, caches=("Cache",), fetch=("New",))
        np.testing.assert_array_equal(port_after["Cache"],
                                      ref_after["Cache"])
        assert np.array_equal(ref_after["Cache"], inputs["Cache"]) == guard


def _attention_cases():
    rs = np.random.RandomState(1)
    dense_k = rs.standard_normal((S, 12, D)).astype(np.float32)
    dense_v = rs.standard_normal((S, 12, D)).astype(np.float32)
    table = np.array([[2, 0, 5], [4, NB, NB], [1, 3, NB]], np.int32)
    return {
        "decode": ("multihead_attention_decode", {
            "Q": rs.standard_normal((S, 1, D)).astype(np.float32),
            "CacheK": dense_k, "CacheV": dense_v,
            "Pos": np.array([0, 11, 6], np.int32)}),
        "decode_paged": ("multihead_attention_decode_paged", {
            "Q": rs.standard_normal((S, 1, D)).astype(np.float32),
            "CacheK": _pool(rs), "CacheV": _pool(rs),
            "Pos": np.array([9, 3, 7], np.int32), "Table": table}),
        "prefill_paged": ("multihead_attention_prefill_paged", {
            "Q": rs.standard_normal((1, 8, D)).astype(np.float32),
            "CacheK": _pool(rs), "CacheV": _pool(rs),
            "Table": np.array([3, 1, 4], np.int32),
            "Hist": np.array([2], np.int32),
            "Len": np.array([8], np.int32)}),
    }


@pytest.mark.parametrize("case", sorted(_attention_cases()) + ["verify"])
def test_attention_ops_within_1e6(case):
    op_type, inputs = _attention_cases()[
        "prefill_paged" if case == "verify" else case]
    ref_out, _, port_out, _, _ = _run(
        op_type, inputs, {"num_heads": H}, caches=("CacheK", "CacheV"),
        tag=generation_ops.VERIFY_TAG if case == "verify" else None)
    assert port_out["Out"].shape == ref_out["Out"].shape
    assert _rel(port_out["Out"], ref_out["Out"]) <= 1e-6
    if case == "verify":
        # the tagged program's rows are B5's decode queries, bitwise
        storage = [torch.from_numpy(np.concatenate(
            [inputs[k], np.zeros_like(inputs[k][:1])]))
            for k in ("CacheK", "CacheV")]
        want = generation_ops.multihead_attention_verify_paged(
            torch.from_numpy(inputs["Q"]), *storage,
            torch.from_numpy(inputs["Table"]), 2, H)
        np.testing.assert_array_equal(port_out["Out"], want.numpy())


@pytest.mark.parametrize("sampled,masked", [(True, False), (True, True),
                                            (False, True)])
def test_decode_sample_and_arg_max_tokens_exact(sampled, masked):
    rs = np.random.RandomState(2)
    logits = (rs.standard_normal((5, 29)) * 3).astype(np.float32)
    mask = np.where(rs.rand(5, 29) < 0.4, -1e30, 0.0).astype(np.float32)
    if sampled:
        inputs = {"Logits": logits,
                  "Seed": np.array([7, 1234, 5, 7, 99], np.int64),
                  "Step": np.array([3, 9, 0, 4, 17], np.int32)}
        if masked:
            inputs["Mask"] = mask
        ref_out, _, port_out, _, _ = _run(
            "decode_sample", inputs,
            {"temperature": 0.8, "top_k": 9, "top_p": 0.9})
    else:
        ref_out, _, port_out, _, _ = _run("arg_max", {"X": logits + mask},
                                          {"axis": -1})
    np.testing.assert_array_equal(port_out["Out"], ref_out["Out"])


@pytest.mark.parametrize("kind", ["greedy", "sample"])
def test_decode_verify_tokens_and_accept_exact(kind):
    rs = np.random.RandomState(3)
    w = 4
    logits = (rs.standard_normal((1, w, 29)) * 3).astype(np.float32)
    # a window whose first two drafts are the greedy choices
    best = logits[0].argmax(-1)
    window = np.array([[5, best[0], best[1], 3]], np.int64)
    inputs = {"Logits": logits, "Window": window,
              "Seed": np.array([77], np.int64),
              "Hist": np.array([6], np.int32)}
    ref_out, _, port_out, _, _ = _run(
        "decode_verify", inputs,
        {"kind": kind, "temperature": 0.8, "top_k": 0, "top_p": 1.0},
        outs=("Tokens", "Accept"))
    for slot in ("Tokens", "Accept"):
        np.testing.assert_array_equal(port_out[slot], ref_out[slot])
    if kind == "greedy":
        assert int(port_out["Accept"][0]) == 2


@pytest.mark.parametrize("op_type,attrs,slot", [
    ("transpose", {"axis": [1, 0, 2]}, "X"),
    ("slice", {"axes": [0], "starts": [0], "ends": [3]}, "Input"),
    ("gather", {}, "X")])
def test_tensor_ops_bitwise(op_type, attrs, slot):
    rs = np.random.RandomState(4)
    inputs = {slot: rs.standard_normal((4, 5, 6)).astype(np.float32)}
    if op_type == "gather":
        inputs["Index"] = np.array([3, 0, 3], np.int32)
    ref_out, _, port_out, _, _ = _run(op_type, inputs, attrs)
    np.testing.assert_array_equal(port_out["Out"], ref_out["Out"])
