"""The port's differentiable ``flash_attention`` (forward: kernel B2's plain
version on the CPU; backward: the reference's chunked recompute
``_flash_bwd`` in torch ops) against ``jax.vjp`` of the reference's
``flash_attention`` with its Pallas kernel interpreted.

Tolerances, each against the largest magnitude of the reference's tensor:
* float32: 1e-5 for the output and the gradients (the same f32 arithmetic,
  sums in another order).
* bfloat16 through the chunked backward: one bf16 rounding step (an ulp,
  2^-7 of the magnitude; both sides compute in f32 and round nearly the
  same f32 value, and an order of sums can move it across one rounding
  boundary).
* bfloat16 at a T with no aligned chunk (the autograd of ``_reference``,
  whose probabilities and products are bf16 on both sides): two steps,
  2^-6 (the two frameworks round the intermediate bf16 products and their
  cotangents in other places).

The ragged-T forward in bf16 is a difference by design (ROADMAP Queue C):
the reference falls back to ``_reference``, which rounds the probabilities
to bf16; the port keeps them f32 at every T, as the reference's kernel
does at an aligned T."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as ref_attn
from paddle_tpu_torch.ops import flash_attention as port_attn
from test_torch_ops_cases import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF16_STEP = 2.0 ** -7
TOL = {"float32": 1e-5, "bfloat16": BF16_STEP}
RAGGED_BF16_TOL = 2 * BF16_STEP


def _inputs(seed, b, h, t, d, dtype, lengths):
    """q, k, v, the cotangent and segment ids as torch tensors of
    ``dtype`` and the same values as numpy arrays (bf16 values are exact
    in f32)."""
    rs = np.random.RandomState(seed)
    tens = [torch.from_numpy(rs.standard_normal((b, h, t, d))
                             .astype(np.float32)).to(getattr(torch, dtype))
            for _ in range(4)]
    seg = None if lengths is None else (
        np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return tens, [x.float().numpy() for x in tens], seg


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _reference_vjp(arrs, seg, causal, block_q, dtype):
    q, k, v, g = (_jax(a, dtype) for a in arrs)
    s = None if seg is None else jnp.asarray(seg)

    def f(q_, k_, v_):
        return ref_attn.flash_attention(q_, k_, v_, causal=causal,
                                        segment_ids=s, block_q=block_q,
                                        interpret=True)

    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in (out,) + vjp(g)]


def _port(tens, seg, causal, block_q):
    q, k, v, g = (x.clone().requires_grad_(i < 3) for i, x in enumerate(tens))
    before = port_attn.flash_attention.launches
    out = port_attn.flash_attention(
        q, k, v, causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        block_q=block_q)
    out.backward(g)
    assert port_attn.flash_attention.launches == before  # plain version
    assert all(x.grad.dtype == q.dtype for x in (q, k, v))
    return [x.detach().float().numpy() for x in (out, q.grad, k.grad, v.grad)]


def _close(got, want, tol, what):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, (what, name, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,lengths,t,block_q,chunk", [
    (True, None, 512, 256, 256),        # two chunks of 256
    (True, (384, 70), 384, 256, 192),   # segment ids, two chunks of 192
    (True, (256, 100), 256, 128, 128),  # segment ids, two chunks of 128
    (False, (256, 1), 256, 256, 256),   # one live key in a row, one chunk
    (False, None, 16, 16, 16),          # block_q 16: one chunk of 16
    (True, None, 64, 16, 0),            # block_q 16 < T: no chunk >= 128
])
def test_gradients_match_reference_vjp(dtype, causal, lengths, t, block_q,
                                       chunk):
    assert port_attn._block_size(t, block_q) == chunk
    tens, arrs, seg = _inputs(t + block_q, 2, 2, t, 16, dtype, lengths)
    want = _reference_vjp(arrs, seg, causal, block_q, dtype)
    got = _port(tens, seg, causal, block_q)
    _close(got, want, TOL[dtype], (dtype, causal, lengths, t, block_q))
    if lengths is not None:
        for bi, n in enumerate(lengths):
            # padded query rows: zero output and zero dq
            assert not got[0][bi, :, n:].any()
            assert not got[1][bi, :, n:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,lengths", [(100, None), (100, (100, 37))])
def test_ragged_t_backward_is_reference_autograd(dtype, t, lengths):
    """T = 100 has no aligned chunk: both take the autograd of
    ``_reference`` over the whole sequence."""
    tens, arrs, seg = _inputs(7, 2, 2, t, 16, dtype, lengths)
    want = _reference_vjp(arrs, seg, True, 256, dtype)
    got = _port(tens, seg, True, 256)
    tol = RAGGED_BF16_TOL if dtype == "bfloat16" else TOL[dtype]
    # the forward differs by design in bf16 (p kept f32): gradients only
    _close(got[1:], want[1:], tol, (dtype, t, lengths))


def test_bf16_forward_at_aligned_t_matches_reference_kernel():
    tens, arrs, seg = _inputs(3, 2, 4, 256, 64, "bfloat16", (256, 90))
    want = np.asarray(ref_attn.flash_attention(
        *(_jax(a, "bfloat16") for a in arrs[:3]), causal=True,
        segment_ids=jnp.asarray(seg), interpret=True).astype(jnp.float32))
    got = port_attn.flash_attention(*tens[:3], causal=True,
                                    segment_ids=torch.from_numpy(seg))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_STEP * np.abs(want).max()


def test_bf16_ragged_t_forward_difference_by_design():
    """At T = 100 the reference's bf16 forward is its ``_reference`` with
    the probabilities rounded to bf16; the port computes the kernel's
    promotion (p f32) there too: it equals the reference's ``_reference``
    over the f32-upcast inputs rounded once to bf16, and differs from the
    reference's own bf16 result."""
    tens, arrs, _ = _inputs(11, 2, 2, 100, 16, "bfloat16", None)
    ref_bf16 = np.asarray(ref_attn.flash_attention(
        *(_jax(a, "bfloat16") for a in arrs[:3]), causal=True,
        interpret=True).astype(jnp.float32))
    b, h, t, d = arrs[0].shape
    promoted = ref_attn._reference(
        *(jnp.asarray(a.reshape(b * h, t, d)) for a in arrs[:3]), True)
    promoted = np.asarray(promoted.astype(jnp.bfloat16)
                          .astype(jnp.float32)).reshape(b, h, t, d)
    got = port_attn.flash_attention(*tens[:3], causal=True).float().numpy()
    scale = np.abs(promoted).max()
    assert np.abs(got - promoted).max() <= BF16_STEP * scale
    assert np.abs(ref_bf16 - promoted).max() > 0


def test_block_size_matches_reference():
    for t in (16, 48, 100, 128, 256, 384, 768, 777, 1024, 1280, 4096):
        for cap in (16, 32, 256, 512):
            for align in (16, 128):
                assert port_attn._block_size(t, cap, align) == \
                    ref_attn._block_size(t, cap, align), (t, cap, align)


def test_tile_entry_plain_on_cpu_and_checks():
    tens, _, _ = _inputs(5, 1, 2, 64, 128, "bfloat16", None)
    want = port_attn.flash_attention_plain(*tens[:3], True)
    before = port_attn.flash_attention_tile.launches
    got = port_attn.flash_attention_tile(*tens[:3], 128, 32, causal=True)
    assert port_attn.flash_attention_tile.launches == before
    assert torch.equal(got, want)
    assert port_attn.PATH_TILES[128] in port_attn.SWEEP_TILES
    assert len(port_attn.SWEEP_TILES) == 9
    with pytest.raises(ValueError, match="dtypes differ"):
        port_attn.flash_attention(tens[0], tens[1].float(), tens[2])


def _counting_einsum(monkeypatch):
    """Wrap torch.einsum; returns the list of (equation, key width) of
    every product the backward's chunks run: the keys are axis 1 of the
    second operand of "bqd,bkd->bqk" and axis 2 of the first operand of
    the products that contract over them."""
    calls = []
    real = torch.einsum

    def einsum(eq, *ops):
        keys = ops[1].shape[1] if eq == "bqd,bkd->bqk" else ops[0].shape[2]
        calls.append((eq, keys))
        return real(eq, *ops)

    monkeypatch.setattr(torch, "einsum", einsum)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("t,block_q", [(512, 128), (384, 192), (512, 256)])
def test_causal_chunks_read_only_keys_up_to_the_diagonal(
        monkeypatch, dtype, padded, t, block_q):
    """Under causal, chunk i's five products see exactly (i + 1) bq keys
    (the keys past them carry p = 0 and ds = 0), and the gradients still
    match ``jax.vjp`` of the reference, whose scan reads every key, at
    the tolerances above, with and without segment ids and padded
    rows."""
    lengths = (t, t // 3) if padded else None
    tens, arrs, seg = _inputs(t + block_q + padded, 2, 2, t, 16, dtype,
                              lengths)
    want = _reference_vjp(arrs, seg, True, block_q, dtype)
    calls = _counting_einsum(monkeypatch)
    got = _port(tens, seg, True, block_q)
    monkeypatch.undo()
    n = t // block_q
    # the forward's plain version reads all T keys twice, then the chunks
    widths = [w for _, w in calls]
    assert widths == [t, t] + [(i + 1) * block_q for i in range(n)
                               for _ in range(5)]
    _close(got, want, TOL[dtype], (dtype, padded, t, block_q))
    if lengths is not None:
        assert not got[0][1, :, lengths[1]:].any()
        assert not got[1][1, :, lengths[1]:].any()


def test_non_causal_chunks_read_every_key(monkeypatch):
    tens, _, _ = _inputs(9, 1, 2, 256, 16, "float32", None)
    calls = _counting_einsum(monkeypatch)
    _port(tens, None, False, 128)
    assert [w for _, w in calls] == [256] * (2 + 10)


def _plain_p_bf16(q, k, v, causal, seg=None):
    """The plain version with the kernel's one change on the card: the
    unnormalized probabilities exp(s - max) rounded to bf16 before the PV
    product (the reference kernel's bf16 MXU pass), the row sums and the
    division in f32. [B, H, T, D] f32 inputs, f32 output."""
    b, h, t, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool)
    if causal:
        mask = mask.tril()
    mask = mask[None, None]
    if seg is not None:
        mask = mask & ((seg[:, None, :, None] == seg[:, None, None, :])
                       & (seg[:, None, None, :] != 0))
    s = torch.where(mask, s, port_attn._NEG)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v)
    return out / p.sum(-1, keepdim=True).clamp_min(1e-30)


@pytest.mark.parametrize("shape,causal,lengths", [
    ((2, 4, 256, 64), True, (256, 90)),
    ((2, 2, 100, 16), True, None),
    ((1, 2, 512, 128), False, None),
])
def test_p_rounded_to_bf16_stays_within_one_bf16_step(shape, causal,
                                                      lengths):
    """The bf16 kernel rounds p to bf16 for its PV product on the tensor
    cores, where the plain version (and the reference's interpreted
    kernel) keep p f32: at the test shapes the two differ by less than
    one bf16 step of the output's magnitude, the tolerance the card's
    check holds the kernel to."""
    tens, _, seg = _inputs(sum(shape), *shape, "bfloat16", lengths)
    q, k, v = (x.float() for x in tens[:3])
    seg_t = None if seg is None else torch.from_numpy(seg)
    want = port_attn.flash_attention_plain(q, k, v, causal, seg_t)
    got = _plain_p_bf16(q, k, v, causal, seg_t)
    err = float((got - want).abs().max())
    assert 0 < err <= BF16_STEP * float(want.abs().max())
