"""The port's decode-policy objects (``paddle_tpu_torch/serving/
decoding``) against the reference's (``paddle_tpu/serving/decoding``):
the same validation, the same flag resolution, fingerprints string-equal
(the fleet tier journals them), and DFA constraints with equal mask
tables, transitions and dead states. All host-side and exact."""

import itertools

import numpy as np
import pytest

import paddle_tpu as ptpu
from paddle_tpu.serving import decoding as ref_dec
from paddle_tpu.serving.decoding.policy import \
    GREEDY_FINGERPRINT as REF_GREEDY
from paddle_tpu_torch import config as port_config
from paddle_tpu_torch.serving import decoding as port_dec
from paddle_tpu_torch.serving.decoding.policy import \
    GREEDY_FINGERPRINT as PORT_GREEDY

DFA = {0: {2: 1, 3: 0, 7: 2}, 1: {4: 2, 5: 1}, 2: {1: 2, 6: 0}, 3: {}}
FLAGS = dict(decode_policy="greedy", decode_temperature=1.0, decode_top_k=0,
             decode_top_p=1.0, decode_speculate_k=0,
             decode_draft_model=None, decode_constraint=None)


def _make(pkg, kw):
    """``pkg``'s policy of the knobs ``kw``, with that package's DFA where
    ``kw`` names one."""
    kw = dict(kw)
    if kw.get("constraint") == "dfa":
        kw["constraint"] = pkg.DFAConstraint(DFA)
    return pkg.DecodePolicy(**kw)


def _both(kw):
    return _make(ref_dec, kw), _make(port_dec, kw)


INVALID = [dict(kind="beam"), dict(kind="sample", temperature=0.0),
           dict(kind="sample", temperature=-1.0), dict(top_k=-1),
           dict(top_p=0.0), dict(top_p=1.5), dict(speculate_k=-1),
           dict(constraint="dfa", speculate_k=2),
           dict(draft=dict(num_layers=1))]


@pytest.mark.parametrize("kw", INVALID, ids=[str(k) for k in INVALID])
def test_invalid_combinations_raise_as_in_the_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        _make(ref_dec, kw)
    with pytest.raises(ValueError) as port_err:
        _make(port_dec, kw)
    assert str(port_err.value) == str(ref_err.value)


def test_from_flags_none_at_defaults_and_reads_the_knobs():
    assert port_config.get_flag("decode_policy") == "greedy"
    for name, value in FLAGS.items():
        assert port_config.get_flag(name) == ptpu.config.get_flag(name) \
            == value
    assert port_dec.DecodePolicy.from_flags() is None
    knobs = dict(decode_policy="sample", decode_temperature=0.7,
                 decode_top_k=5, decode_top_p=0.9, decode_speculate_k=3)
    port_config.set_flags(**knobs)
    ptpu.config.set_flags(**knobs)
    try:
        port = port_dec.DecodePolicy.from_flags()
        ref = ref_dec.DecodePolicy.from_flags()
        assert (port.kind, port.temperature, port.top_k, port.top_p,
                port.speculate_k) == ("sample", 0.7, 5, 0.9, 3)
        assert port.fingerprint() == ref.fingerprint()
    finally:
        port_config.set_flags(**FLAGS)
        ptpu.config.set_flags(**FLAGS)
    assert port_dec.DecodePolicy.from_flags() is None


GRID = [dict(kind=k, temperature=t, top_k=tk, top_p=tp, speculate_k=sk)
        for k, t, tk, tp, sk in itertools.product(
            ("greedy", "sample"), (1.0, 0.8, 0.7000001), (0, 50),
            (1.0, 0.95), (0, 4))]
GRID += [dict(constraint="dfa"), dict(kind="sample", temperature=0.8,
                                      constraint="dfa"),
         dict(speculate_k=2, draft=dict(num_layers=2))]


@pytest.mark.parametrize("kw", GRID, ids=[str(k) for k in GRID])
def test_fingerprint_string_equal(kw):
    ref, port = _both(kw)
    assert port.fingerprint() == ref.fingerprint()
    assert repr(port) == repr(ref)
    assert port.sampled == ref.sampled


def test_greedy_fingerprints_and_mint_seed():
    assert PORT_GREEDY == REF_GREEDY == "greedy"
    assert port_dec.DecodePolicy(speculate_k=3).fingerprint() == PORT_GREEDY
    for _ in range(200):
        assert 0 <= port_dec.mint_seed() < 2 ** 31


def test_dfa_tables_transitions_and_dead_states_equal():
    ref, port = ref_dec.DFAConstraint(DFA), port_dec.DFAConstraint(DFA)
    assert port.digest() == ref.digest()
    assert port.num_states == ref.num_states
    for v in (8, 29):
        np.testing.assert_array_equal(port.mask_table(v), ref.mask_table(v))
        assert port.mask_table(v).dtype == np.float32
    for s in range(4):
        assert port.dead(s) == ref.dead(s)
        assert port.state_index(s) == ref.state_index(s)
        for tok in range(8):
            try:
                want = ref.advance(s, tok)
            except ValueError as exc:
                with pytest.raises(ValueError, match=str(exc)):
                    port.advance(s, tok)
                continue
            assert port.advance(s, tok) == want
    journal = [2, 5, 4, 1, 6, 7]
    assert port.advance_many(port.start, journal) == \
        ref.advance_many(ref.start, journal)
    with pytest.raises(ValueError):
        port.mask_table(4)      # token 7 >= vocab 4
    err = port_dec.ConstraintDeadEnd(3, 9)
    assert isinstance(err, ValueError)
    assert str(err) == str(ref_dec.ConstraintDeadEnd(3, 9))


def test_digest_tracks_the_grammar():
    a = port_dec.DFAConstraint({0: {2: 1}, 1: {3: 1}})
    b = port_dec.DFAConstraint({0: {2: 1}, 1: {4: 1}})
    assert a.digest() != b.digest()
    assert a.digest() == ref_dec.DFAConstraint({0: {2: 1},
                                                1: {3: 1}}).digest()
