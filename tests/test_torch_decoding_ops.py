"""The port's decode-policy ops (``paddle_tpu_torch/ops/decoding_ops.py``)
against the reference's ``decode_sample`` and ``decode_verify`` ops
(``paddle_tpu/ops/decoding_ops.py``), run as the reference's serving
programs run them: through its executor, jitted, on the CPU.

The same seeded logits, seeds and steps go to both, and the tokens must
be equal (tolerance: none). The logits carry ties on purpose (rows with
repeated values, a tied top-k boundary) and mask rows. Softmax, cumsum
and ``log`` round differently in XLA and torch, by an ulp or so; a token
could differ only where a perturbed logit or a top-p keep boundary lies
within such an ulp of its rival, which the seeded data here does not
contain (the tests would show it as a differing token).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as ptpu
from paddle_tpu import layers
from paddle_tpu_torch.ops import decoding_ops as port_d
from paddle_tpu_torch.ops import random_ops as port_r
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

V = 29
ROWS = 24

# (temperature, top_k, top_p): each filter alone, together, degenerate
GRID = [(1.0, 0, 1.0), (0.8, 0, 1.0), (1.7, 0, 1.0), (1.0, 5, 1.0),
        (0.8, 1, 1.0), (1.0, 0, 0.9), (0.8, 0, 0.5), (1.0, 0, 1e-6),
        (0.8, 5, 0.9), (1.3, 12, 0.7), (1.0, 28, 0.95), (0.8, 29, 0.99)]


def _run_prog(build, feeds):
    main, startup = ptpu.Program(), ptpu.Program()
    with ptpu.unique_name.guard(), ptpu.program_guard(main, startup):
        fetch = build()
    return ptpu.Executor().run(main, feed=feeds, fetch_list=list(fetch),
                               scope=ptpu.Scope())


def _inputs(seed, masked):
    """[ROWS, V] logits with ties, seeds, steps and an optional mask."""
    rs = np.random.RandomState(seed)
    lg = (2.0 * rs.standard_normal((ROWS, V))).astype(np.float32)
    lg[1] = lg[0]                       # two rows, one distribution
    lg[2, ::2] = 1.5                    # many tied logits in a row
    lg[3] = np.round(lg[3])             # ties at the top-k boundary
    lg[4] = 0.0                         # a flat row
    seeds = rs.randint(0, 2 ** 31, ROWS).astype(np.int64)
    seeds[1] = seeds[0]
    steps = rs.randint(0, 1024, ROWS).astype(np.int32)
    steps[1] = steps[0]
    mask = None
    if masked:
        mask = np.where(rs.rand(ROWS, V) < 0.6, -1e30, 0.0).astype(
            np.float32)
        mask[np.arange(ROWS), rs.randint(0, V, ROWS)] = 0.0
    return lg, seeds, steps, mask


def _ref_sample(lg, seeds, steps, mask, **attrs):
    def build():
        x = layers.data("lg", shape=list(lg.shape), dtype="float32",
                        append_batch_size=False)
        sd = layers.data("sd", shape=[ROWS], dtype="int64",
                         append_batch_size=False)
        st = layers.data("st", shape=[ROWS], dtype="int32",
                         append_batch_size=False)
        mk = None
        if mask is not None:
            mk = layers.data("mk", shape=list(mask.shape), dtype="float32",
                             append_batch_size=False)
        return [layers.decode_sample(x, sd, st, mask=mk, **attrs)]
    feeds = {"lg": lg, "sd": seeds, "st": steps}
    if mask is not None:
        feeds["mk"] = mask
    out, = _run_prog(build, feeds)
    return np.asarray(out).astype(np.int64)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("temperature,top_k,top_p", GRID)
def test_sample_tokens_equal_reference(temperature, top_k, top_p, masked):
    lg, seeds, steps, mask = _inputs(GRID.index(
        (temperature, top_k, top_p)), masked)
    attrs = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    want = _ref_sample(lg, seeds, steps, mask, **attrs)
    got = port_d.decode_sample(
        torch.from_numpy(lg), torch.from_numpy(seeds),
        torch.from_numpy(steps),
        None if mask is None else torch.from_numpy(mask), **attrs)
    np.testing.assert_array_equal(got.numpy(), want)
    if mask is not None:
        assert (mask[np.arange(ROWS), want] == 0.0).all()
    # the sessions' route: the keys derived first (on the host), then
    # sample_from_keys on the masked logits
    keys = port_r.decoding_key(torch.from_numpy(seeds),
                               torch.from_numpy(steps))
    masked_lg = lg if mask is None else lg + mask
    got = port_d.sample_from_keys(torch.from_numpy(masked_lg), keys, **attrs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_from_logits_is_a_pure_function_of_seed_and_step():
    lg, seeds, steps, _ = _inputs(99, False)
    args = (torch.from_numpy(lg), torch.from_numpy(seeds),
            torch.from_numpy(steps))
    a = port_d.sample_from_logits(*args, temperature=0.8)
    b = port_d.sample_from_logits(*args, temperature=0.8)
    assert torch.equal(a, b)
    assert a[0] == a[1]     # equal rows, equal (seed, step)
    many = port_d.sample_from_logits(
        torch.from_numpy(np.repeat(lg[:1] / 4, 64, 0)),
        torch.full((64,), 5), torch.arange(64))
    assert len(set(many.tolist())) > 1


def _ref_verify(logits, window, seed, hist, **attrs):
    w = len(window)

    def build():
        lg = layers.data("lg", shape=[1, w, V], dtype="float32",
                         append_batch_size=False)
        wd = layers.data("wd", shape=[w], dtype="int64",
                         append_batch_size=False)
        sd = layers.data("sd", shape=[1], dtype="int64",
                         append_batch_size=False)
        hs = layers.data("hs", shape=[1], dtype="int32",
                         append_batch_size=False)
        return list(layers.decode_verify(lg, wd, sd, hs, **attrs))
    toks, accept = _run_prog(build, {
        "lg": logits.reshape(1, w, V).astype(np.float32),
        "wd": np.asarray(window, np.int64),
        "sd": np.asarray([seed], np.int64),
        "hs": np.asarray([hist], np.int32)})
    return np.asarray(toks).astype(np.int64).tolist(), \
        int(np.asarray(accept).reshape(-1)[0])


VERIFY_ATTRS = {"greedy": dict(kind="greedy"),
                "sample": dict(kind="sample", temperature=0.8, top_k=5,
                               top_p=0.9)}


@pytest.mark.parametrize("kind", sorted(VERIFY_ATTRS))
@pytest.mark.parametrize("accept", ["full", "partial", "zero"])
def test_verify_tokens_and_accept_equal_reference(kind, accept):
    """Full accept: the drafts are the target's own tokens; partial: the
    second draft differs; zero: the first does. The windows are built
    from the reference's own tokens for that window."""
    rs = np.random.RandomState(11)
    w, seed, hist = 5, 1234567, 37
    logits = (3.0 * rs.standard_normal((w, V))).astype(np.float32)
    attrs = VERIFY_ATTRS[kind]
    target, _ = _ref_verify(logits, [0] * w, seed, hist, **attrs)
    window = [int(rs.randint(V))] + target[:w - 1]
    if accept == "partial":
        window[2] = (window[2] + 1) % V
    elif accept == "zero":
        window[1] = (window[1] + 1) % V
    want_toks, want_accept = _ref_verify(logits, window, seed, hist,
                                         **attrs)
    toks, got_accept = port_d.decode_verify(
        torch.from_numpy(logits), torch.tensor(window), seed, hist,
        **attrs)
    assert toks.tolist() == want_toks
    assert got_accept == want_accept == \
        {"full": w - 1, "partial": 1, "zero": 0}[accept]
