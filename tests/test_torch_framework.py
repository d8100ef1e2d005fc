"""The port's program IR (``paddle_tpu_torch/core/{enforce,unique_name,
scope,framework,registry}.py``) against the reference's: generated
names, the scope, enforce, the dtype policy, Program/Block building, and
shape inference. The port infers an op's output shapes by running its
torch compute on meta tensors, the reference by ``jax.eval_shape``; for
every op of the ResNet program, with -1 (unknown batch) dimensions, the
shapes and dtypes must be the reference's. Kernel B1's wrapper takes its
plain version for meta tensors, so the fused op infers too."""

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu.core import enforce as ref_enforce
from paddle_tpu.core import registry as ref_registry
from paddle_tpu.core import unique_name as ref_unique_name
from paddle_tpu.core.framework import convert_dtype as ref_convert_dtype
from paddle_tpu_torch import core as pc
from paddle_tpu_torch.core import enforce, registry, unique_name
from paddle_tpu_torch.core.framework import (BFLOAT16, convert_dtype,
                                             dtype_name, torch_dtype)
from paddle_tpu_torch.ops import conv_bn
from paddle_tpu_torch.probes.op_cases import RNN_OPS, TAIL_OPS
from test_torch_ops_cases import SLICE_OPS


def test_unique_names_follow_the_reference():
    prefixes = ["fc", "conv2d", "fc", "batch_norm", "fc.w", "conv2d"]
    with unique_name.guard(), ref_unique_name.guard():
        ours = [unique_name.generate(p) for p in prefixes]
        theirs = [ref_unique_name.generate(p) for p in prefixes]
        with unique_name.guard():
            assert unique_name.generate("fc") == "fc_0"
        # the guard restores the counters it found
        assert unique_name.generate("fc") == "fc_2"
    assert ours == theirs == ["fc_0", "conv2d_0", "fc_1", "batch_norm_0",
                              "fc.w_0", "conv2d_1"]


def test_scope_and_guard():
    s = pc.Scope()
    s.set_var("a", torch.ones(2))
    assert s.has_var("a") and not s.has_var("b") and s.var_names() == ["a"]
    assert s.find_var("b") is None
    with pc.scope_guard(s):
        assert pc.global_scope() is s
    assert pc.global_scope() is not s
    s.erase("a")
    s.erase("a")
    assert not s.has_var("a")
    s.set_var("b", 1)
    s.clear()
    assert s.var_names() == []


def test_enforce_names_the_call_site():
    for mod in (enforce, ref_enforce):
        with pytest.raises(mod.EnforceNotMet) as ei:
            mod.enforce_eq(1, 2)
        assert "expected 1 == 2" in str(ei.value)
        assert "test_torch_framework.py" in ei.value.site
        assert mod.enforce_not_none(3) == 3
        with pytest.raises(RuntimeError, match="x is 0"):
            mod.enforce_gt(0, 0, "x is %d", 0)


@pytest.mark.parametrize("dtype", [None, "float", "double", "int", "long",
                                   "int64", "float64", "uint64", "bool",
                                   "int8", "float16", np.float64, "half",
                                   "bfloat16"])
def test_convert_dtype_demotes_as_the_reference(dtype):
    ours, theirs = convert_dtype(dtype), ref_convert_dtype(dtype)
    assert dtype_name(ours) == np.dtype(theirs).name \
        if theirs is not ref_convert_dtype("bfloat16") else ours is BFLOAT16


def test_convert_dtype_takes_torch_dtypes():
    assert convert_dtype(torch.int64) == np.dtype("int32")
    assert convert_dtype(torch.float64) == np.dtype("float32")
    assert convert_dtype(torch.bfloat16) is BFLOAT16
    assert torch_dtype("int64") == torch.int32
    assert torch_dtype(BFLOAT16) == torch.bfloat16


def test_program_and_block_building():
    for pkg in (pc, ptpu):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            assert pkg.default_main_program() is main
            assert pkg.default_startup_program() is startup
            g = main.global_block()
            x = g.create_var(name="x", shape=[-1, 3], dtype="int64")
            sub = main.create_block()
            assert main.current_block() is sub and sub.parent is g
            assert sub.var("x") is x and sub.has_var("x")
            w = sub.create_parameter(name="w", shape=[3], dtype="float32")
            assert "w" in g.vars and w.persistable and w.trainable
            with pytest.raises(ValueError, match="already exists"):
                g.create_var(name="x")
            main.rollback()
            assert main.current_block() is g
            with pytest.raises(KeyError):
                g.var("nope")
            assert [p.name for p in main.all_parameters()] == ["w"]
        assert pkg.default_main_program() is not main
        assert x.shape == (-1, 3) and np.dtype(x.dtype) == np.int32
        assert repr(x) == "Variable(x, shape=(-1, 3), dtype=int32)"
        v0 = main._version
        g.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["x"]},
                    infer_shape=False)
        assert main._version == v0 + 1 and x.op is g.ops[0]


def test_the_port_registers_the_slice():
    assert registry.registered_ops() == sorted([
        "conv2d", "pool2d", "batch_norm", "conv2d_bn", "mul", "sum", "mean",
        "elementwise_add", "relu", "softmax", "softmax_with_cross_entropy",
        "accuracy", "top_k", "reshape", "fill_constant", "fill_like", "sgd",
        "momentum", "adam", "gaussian_random", "uniform_random",
        "recompute_block",
        # the transformer LM's program and int8 matmul
        "layer_norm", "lookup_table", "gelu", "multihead_attention",
        "dropout", "matmul", "elementwise_mul", "elementwise_div",
        "reduce_sum", "sequence_mask",
        # the cached generation programs
        "kv_cache_write_slot", "kv_cache_append", "kv_cache_write_paged",
        "kv_cache_append_paged", "kv_block_copy",
        "multihead_attention_decode", "multihead_attention_decode_paged",
        "multihead_attention_prefill_paged", "decode_sample",
        "decode_verify", "transpose", "gather", "slice", "arg_max",
        # the distribution slice's sparse and distributed lookups
        "lookup_table_dist", "lookup_table_dist_grad",
        "lookup_table_sparse_grad"] +
        # the LeNet-5/MNIST slice's op library, the RNN and seq2seq slice's,
        # the op tail's
        SLICE_OPS + RNN_OPS + TAIL_OPS)
    with pytest.raises(NotImplementedError, match="no op registered"):
        registry.get_op_def("lstm")


F, I, I32 = "float32", "int64", "int32"
# op -> ({slot: [(shape, dtype), ...]}, attrs, {slot: n outputs})
SHAPE_CASES = {
    "conv2d": ({"Input": [((-1, 3, 9, 7), F)], "Filter": [((8, 3, 3, 3), F)]},
               {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 1],
                "groups": 1}, {"Output": 1}),
    "pool2d": ({"X": [((-1, 4, 9, 9), F)]},
               {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1],
                "pooling_type": "max", "global_pooling": False,
                "ceil_mode": False, "exclusive": True}, {"Out": 1}),
    "batch_norm": ({"X": [((-1, 4, 5, 5), F)], "Scale": [((4,), F)],
                    "Bias": [((4,), F)], "Mean": [((4,), F)],
                    "Variance": [((4,), F)]},
                   {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
                    "data_layout": "NCHW"},
                   {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
                    "SavedVariance": 1}),
    "conv2d_bn": ({"Input": [((-1, 4, 6, 6), F)],
                   "Filter": [((8, 4, 1, 1), F)], "Scale": [((8,), F)],
                   "Bias": [((8,), F)], "Mean": [((8,), F)],
                   "Variance": [((8,), F)]},
                  {"strides": [1, 1], "paddings": [0, 0],
                   "dilations": [1, 1], "groups": 1, "momentum": 0.9,
                   "epsilon": 1e-5, "is_test": False},
                  {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
                   "SavedVariance": 1}),
    "mul": ({"X": [((-1, 2, 3), F)], "Y": [((6, 5), F)]},
            {"x_num_col_dims": 1, "y_num_col_dims": 1}, {"Out": 1}),
    "sum": ({"X": [((-1, 4), F), ((-1, 4), F), ((-1, 4), F)]}, {},
            {"Out": 1}),
    "mean": ({"X": [((-1, 4), F)]}, {}, {"Out": 1}),
    "elementwise_add": ({"X": [((-1, 4, 3, 3), F)], "Y": [((4,), F)]},
                        {"axis": 1}, {"Out": 1}),
    "relu": ({"X": [((-1, 4), F)]}, {}, {"Out": 1}),
    "softmax": ({"X": [((-1, 10), F)]}, {}, {"Out": 1}),
    "softmax_with_cross_entropy": (
        {"Logits": [((-1, 10), F)], "Label": [((-1, 1), I)]},
        {"soft_label": False}, {"Softmax": 1, "Loss": 1}),
    "accuracy": ({"Indices": [((-1, 2), I)], "Label": [((-1, 1), I)]}, {},
                 {"Accuracy": 1, "Correct": 1, "Total": 1}),
    "top_k": ({"X": [((-1, 10), F)]}, {"k": 3}, {"Out": 1, "Indices": 1}),
    "reshape": ({"X": [((-1, 4, 1, 1), F)]}, {"shape": [-1, 4]},
                {"Out": 1}),
    "fill_like": ({"X": [((-1, 3), F)]}, {"value": 1.0}, {"Out": 1}),
    "layer_norm": ({"X": [((-1, 5, 8), F)], "Scale": [((8,), F)],
                    "Bias": [((8,), F)]},
                   {"epsilon": 1e-5, "begin_norm_axis": 2},
                   {"Y": 1, "Mean": 1, "Variance": 1}),
    "lookup_table": ({"W": [((11, 6), F)], "Ids": [((-1, 5, 1), I)]},
                     {"padding_idx": None, "is_sparse": False,
                      "keep_dims": False}, {"Out": 1}),
    "gelu": ({"X": [((-1, 4), F)]}, {}, {"Out": 1}),
    "lookup_table_dist": ({"W": [((64, 6), F)], "Ids": [((-1, 5), I)]},
                          {"padding_idx": None, "vocab_size": 50,
                           "padded_vocab": 64, "keep_dims": False},
                          {"Out": 1}),
    "lookup_table_dist_grad": ({"OutGrad": [((-1, 5, 6), F)],
                                "Ids": [((-1, 5), I)]},
                               {"padding_idx": None, "vocab_size": 50,
                                "padded_vocab": 64},
                               {"Rows": 1, "Values": 1}),
    "lookup_table_sparse_grad": ({"OutGrad": [((-1, 5, 6), F)],
                                  "Ids": [((-1, 5), I)]},
                                 {"padding_idx": 3, "vocab_size": 50},
                                 {"Rows": 1, "Values": 1}),
    "multihead_attention": ({"Q": [((-1, 16, 64), F)],
                             "K": [((-1, 16, 64), F)],
                             "V": [((-1, 16, 64), F)]},
                            {"num_heads": 2, "causal": True,
                             "ring_axis": None}, {"Out": 1}),
    "dropout": ({"X": [((-1, 4, 3), F)]},
                {"dropout_prob": 0.1, "is_test": False},
                {"Out": 1, "Mask": 1}),
    "matmul": ({"X": [((-1, 4, 6), F)], "Y": [((3, 6), F)]},
               {"transpose_X": False, "transpose_Y": True, "alpha": 0.5},
               {"Out": 1}),
    "elementwise_mul": ({"X": [((-1, 4, 3), F)], "Y": [((4,), F)]},
                        {"axis": 1}, {"Out": 1}),
    "elementwise_div": ({"X": [((-1, 4), F)], "Y": [((-1, 4), F)]},
                        {"axis": -1}, {"Out": 1}),
    "reduce_sum": ({"X": [((-1, 4, 5), F)]},
                   {"dim": None, "keep_dim": False, "reduce_all": True},
                   {"Out": 1}),
    "sequence_mask": ({"Length": [((-1, 1), I)]},
                      {"maxlen": 7, "dtype": "float32"}, {"Out": 1}),
    # the cached generation programs: dense caches [S, C, D], paged pools
    # [NB, BS, D] as the programs declare them
    "kv_cache_write_slot": ({"Cache": [((3, 12, 8), F)],
                             "New": [((1, 5, 8), F)],
                             "Slot": [((1,), I32)]}, {}, {"Out": 1}),
    "kv_cache_append": ({"Cache": [((3, 12, 8), F)], "New": [((3, 1, 8), F)],
                         "Pos": [((3,), I32)]}, {}, {"Out": 1}),
    "kv_cache_write_paged": ({"Cache": [((6, 4, 8), F)],
                              "New": [((1, 8, 8), F)],
                              "Table": [((3,), I32)], "Hist": [((1,), I32)],
                              "Len": [((1,), I32)]}, {}, {"Out": 1}),
    "kv_cache_append_paged": ({"Cache": [((6, 4, 8), F)],
                               "New": [((3, 1, 8), F)],
                               "Pos": [((3,), I32)],
                               "Table": [((3, 3), I32)]}, {}, {"Out": 1}),
    "kv_block_copy": ({"Cache": [((6, 4, 8), F)], "Src": [((1,), I32)],
                       "Dst": [((1,), I32)]}, {}, {"Out": 1}),
    "multihead_attention_decode": (
        {"Q": [((3, 1, 8), F)], "CacheK": [((3, 12, 8), F)],
         "CacheV": [((3, 12, 8), F)], "Pos": [((3,), I32)]},
        {"num_heads": 2}, {"Out": 1}),
    "multihead_attention_decode_paged": (
        {"Q": [((3, 1, 8), F)], "CacheK": [((6, 4, 8), F)],
         "CacheV": [((6, 4, 8), F)], "Pos": [((3,), I32)],
         "Table": [((3, 3), I32)]}, {"num_heads": 2}, {"Out": 1}),
    "multihead_attention_prefill_paged": (
        {"Q": [((1, 8, 8), F)], "CacheK": [((6, 4, 8), F)],
         "CacheV": [((6, 4, 8), F)], "Table": [((3,), I32)],
         "Hist": [((1,), I32)], "Len": [((1,), I32)]},
        {"num_heads": 2}, {"Out": 1}),
    "decode_sample": ({"Logits": [((5, 29), F)], "Seed": [((5,), I)],
                       "Step": [((5,), I32)]},
                      {"temperature": 0.8, "top_k": 4, "top_p": 0.9},
                      {"Out": 1}),
    "decode_verify": ({"Logits": [((1, 4, 29), F)], "Window": [((1, 4), I)],
                       "Seed": [((1,), I)], "Hist": [((1,), I32)]},
                      {"kind": "greedy", "temperature": 1.0, "top_k": 0,
                       "top_p": 1.0}, {"Tokens": 1, "Accept": 1}),
    "transpose": ({"X": [((-1, 4, 5), F)]}, {"axis": [1, 0, 2]}, {"Out": 1}),
    "gather": ({"X": [((7, 5), F)], "Index": [((3,), I32)]}, {}, {"Out": 1}),
    "slice": ({"Input": [((9, 6), F)]},
              {"axes": [0], "starts": [0], "ends": [4]}, {"Out": 1}),
    "arg_max": ({"X": [((-1, 10), F)]}, {"axis": -1}, {"Out": 1}),
    "sgd": ({"Param": [((4, 3), F)], "Grad": [((4, 3), F)],
             "LearningRate": [((1,), F)]}, {}, {"ParamOut": 1}),
    "momentum": ({"Param": [((4, 3), F)], "Grad": [((4, 3), F)],
                  "Velocity": [((4, 3), F)], "LearningRate": [((1,), F)]},
                 {"mu": 0.9, "use_nesterov": False},
                 {"ParamOut": 1, "VelocityOut": 1}),
    "adam": ({"Param": [((4, 3), F)], "Grad": [((4, 3), F)],
              "Moment1": [((4, 3), F)], "Moment2": [((4, 3), F)],
              "Beta1Pow": [((1,), F)], "Beta2Pow": [((1,), F)],
              "LearningRate": [((1,), F)]}, {},
             {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1,
              "Beta1PowOut": 1, "Beta2PowOut": 1}),
}
# shapes come from attrs or a sub-block: neither package runs their
# compute at build time
SKIPPED = ("fill_constant", "gaussian_random", "uniform_random",
           "recompute_block")


def _infer(pkg, op_type):
    inputs, attrs, outputs = SHAPE_CASES[op_type]
    main = pkg.Program()
    block = main.global_block()
    ins = {}
    for slot, specs in inputs.items():
        ins[slot] = []
        for i, (shape, dtype) in enumerate(specs):
            name = "%s_%d" % (slot, i)
            block.create_var(name=name, shape=shape, dtype=dtype)
            ins[slot].append(name)
    outs = {slot: ["out_%s_%d" % (slot, i) for i in range(n)]
            for slot, n in outputs.items()}
    for names in outs.values():
        for name in names:
            block.create_var(name=name)
    block.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)
    return {n: (block.var(n).shape, dtype_name(block.var(n).dtype)
                if pkg is pc else np.dtype(block.var(n).dtype).name)
            for names in outs.values() for n in names}


def test_shape_cases_cover_the_slice():
    """Every op type's build-time shapes are checked against the
    reference's: here, or for the LeNet-5/MNIST slice's op library case
    by case in ``test_torch_ops_forward.py``, or for the RNN and seq2seq
    slice's in its files (``RNN_CASES`` case by case, the sub-block ops
    through programs that serialize as the reference's), and for the op
    tail's in its files (``TAIL_CASES`` case by case)."""
    assert sorted(set(SHAPE_CASES) | set(SKIPPED) | set(SLICE_OPS) |
                  set(RNN_OPS) | set(TAIL_OPS)) == registry.registered_ops()


@pytest.mark.parametrize("op_type", sorted(SHAPE_CASES))
def test_infer_shape_equals_reference(op_type):
    ours = _infer(pc, op_type)
    assert ours == _infer(ptpu, op_type)
    assert all(s is not None for s, _ in ours.values())


@pytest.mark.parametrize("op_type", SKIPPED)
def test_ops_without_shape_inference_are_the_reference_ones(op_type):
    assert registry.get_op_def(op_type).skip_eval_shape
    assert ref_registry.get_op_def(op_type).skip_eval_shape


def test_b1_wrapper_takes_the_plain_version_on_meta_tensors():
    """Shape inference hands the fused op meta tensors: B1's wrapper must
    answer with shapes, not refuse the device or count a launch."""
    before = conv_bn.conv_bn_stats_1x1.launches
    x = torch.empty(8191, 16, 5, 5, device="meta")
    w = torch.empty(32, 16, 1, 1, device="meta")
    y, s, ss = conv_bn.conv_bn_stats_1x1(x, w)
    assert y.is_meta and tuple(y.shape) == (8191, 32, 5, 5)
    assert tuple(s.shape) == tuple(ss.shape) == (32,)
    y2, _, _ = conv_bn.ConvBnStats.apply(x, w, 1, 0, 1, 1)
    assert tuple(y2.shape) == (8191, 32, 5, 5)
    assert conv_bn.conv_bn_stats_1x1.launches == before
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        conv_bn.conv_bn_stats_1x1(torch.empty(1, 16, 2, 2), w)


def test_failed_inference_names_the_op():
    main = pc.Program()
    block = main.global_block()
    block.create_var(name="a", shape=[-1, 3], dtype="float32")
    block.create_var(name="b", shape=[4, 5], dtype="float32")
    block.create_var(name="o")
    with pytest.raises(RuntimeError, match="shape inference failed for op "
                                           "'mul'"):
        block.append_op("mul", inputs={"X": ["a"], "Y": ["b"]},
                        outputs={"Out": ["o"]})
