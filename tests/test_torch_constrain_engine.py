"""Port parity: the grammar-constrained engine against JAX's, and JAX's
in-engine contracts (tests/test_serving_constrained.py) on the port.

Both engines run JAX's constrained test's model (vocab 256, 2 layers,
d 32, max_len 64, float32, greedy unless stated) from one JAX
`init_params` tree converted with `params_from_numpy`, the JAX one on a
1x1 mesh through its plain reference paths (DL4JTPU_FLASH unset), each
loop against the same loop of the other's (`[sync]`, `[pipelined]`).
Tokens exactly. One seed where JAX's file sweeps three: the cases do
not differ by seed.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from deeplearning4j_tpu_torch.serving.constrain import (  # noqa: E402
    ConstraintError, compile_grammar)

FIELDS = dict(vocab_size=256, d_model=32, n_heads=4, n_layers=2, max_len=64)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
V = FIELDS["vocab_size"]
RX = "[ab]{1,5}"
BOOL_SCHEMA = {"type": "json_schema", "schema": {
    "type": "object", "properties": {"ok": {"type": "boolean"}}}}
LOOPS = pytest.mark.parametrize("pipeline", [False, True],
                                ids=["sync", "pipelined"])


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.delenv("DL4JTPU_FLASH", raising=False)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(MeshSpec(data=1, model=1))


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _prompt(t0=6, seed=0):
    """JAX's constrained test's prompts."""
    return (np.arange(t0, dtype=np.int32) * (seed + 3)) % 50


def _port(tparams, **kw):
    base = dict(decode_chunk=2, max_new_tokens=8)
    base.update(kw)
    return teng.InferenceEngine(TCFG, tparams, teng.EngineConfig(**base),
                                device="cpu")


def _gen(h):
    return h.result()[h.prompt.shape[0]:]


def _serve(eng, reqs):
    """reqs [(prompt, max_new, constrain)] submitted, then drained."""
    hs = [eng.submit(p, max_new_tokens=m, constrain=c) for p, m, c in reqs]
    eng.run_pending()
    assert all(h.status == "completed" for h in hs)
    return [_gen(h) for h in hs]


def _walk(g, toks, start=0):
    """The grammar state after ``toks`` from ``start``; every token must
    be legal."""
    st = start
    for t in toks:
        assert g.legal(st, int(t)), (st, int(t))
        st = g.advance(st, int(t))
    return st


# the traffic of the engine parity tests: JAX's two RX requests, one
# under the boolean schema and one unconstrained sharing their slots
def _traffic():
    return [(_prompt(seed=0), 8, RX), (_prompt(seed=1), 8, RX),
            (_prompt(8, 2), 8, BOOL_SCHEMA), (_prompt(7, 3), 8, None)]


@LOOPS
@pytest.mark.parametrize("arm", [
    dict(),
    dict(prefill_chunk=4),
    dict(spec_decode=True, spec_k=2, draft="self", spec_adaptive=False),
    dict(paged=True, page_size=8, spec_decode=True, spec_k=2, draft="self",
         spec_adaptive=False),
], ids=["plain", "chunked", "spec", "paged_spec"])
def test_constrained_engine_matches_jax(mesh1, jparams, tparams, arm,
                                        pipeline):
    """The arms of JAX's test_constrained_matrix_token_identical_3_seeds:
    the port's constrained engine emits JAX's tokens in the same loop,
    with the terminal completions and requests counted."""
    jcfg = jeng.EngineConfig(decode_chunk=2, max_new_tokens=8,
                             backoff_base_s=0.0, pipeline=pipeline, **arm)
    want = _serve(jeng.InferenceEngine(JCFG, mesh1, jparams, jcfg),
                  _traffic())
    eng = _port(tparams, pipeline=pipeline, **arm)
    got = _serve(eng, _traffic())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    c = eng.counts
    assert c["constrained_requests"] == 3
    assert c["constrained_grammar_compiles"] == 2
    assert c["constrained_terminal"] == sum(
        1 for g, (_, _, spec) in zip(got, _traffic())
        if spec == RX and g.shape[0] < 8) and c["constrained_illegal"] == 0
    assert eng.drained() and not eng._cseed_pending


# ---------------------------------------------------------------------------
# JAX's in-engine contracts on the port
# ---------------------------------------------------------------------------

def test_every_token_legal_and_terminal_stops(tparams):
    """Each emitted token is legal in the state the host replays, and
    ``[ab]{1,5}`` ends accepting at 5 tokens (< max_new_tokens): one
    terminal completion, one constrained request."""
    g = compile_grammar(RX, V)
    eng = _port(tparams)
    h = eng.submit(_prompt(), max_new_tokens=8, constrain=RX)
    eng.run_pending()
    assert h.status == teng.RequestStatus.COMPLETED
    toks = _gen(h)
    assert g.accepts(_walk(g, toks)) and toks.shape[0] == 5
    assert eng.counts["constrained_terminal"] == 1
    assert eng.counts["constrained_requests"] == 1


@pytest.mark.parametrize("spec,keys", [
    (BOOL_SCHEMA, {"ok"}),
    ({"type": "json_schema", "schema": {"type": "object", "properties": {
        "status": {"enum": ["ok", "retry", "dead"]},
        "attempts": {"type": "integer"}, "fatal": {"type": "boolean"}}}},
     {"status", "attempts", "fatal"}),
], ids=["bool", "flagship"])
def test_json_schema_output_parses(tparams, spec, keys):
    """A json_schema constraint yields text json.loads accepts, with the
    declared properties."""
    eng = _port(tparams, max_new_tokens=56, decode_chunk=8)
    h = eng.submit(_prompt(), max_new_tokens=56, constrain=spec)
    eng.run_pending()
    doc = json.loads(bytes(int(t) for t in _gen(h)).decode())
    assert set(doc) == keys
    assert eng.counts["constrained_terminal"] == 1


def test_constrain_off_engine_makes_no_masked_program(tparams):
    """An engine that never sees a constraint makes only the unmasked
    programs (no ``_c`` key) and counts nothing constrained; its tokens
    equal those of an engine made after a constrained one ran."""
    def run():
        eng = _port(tparams)
        hs = [eng.submit(_prompt(6 + 2 * (i % 2), i), max_new_tokens=6)
              for i in range(3)]
        eng.run_pending()
        return eng, [h.result() for h in hs]

    eng, want = run()
    assert eng._programs and not any(k.endswith("_c")
                                      for k, _ in eng._programs)
    assert not eng._constrain_active and eng._ctab is None
    assert all(v == 0 for k, v in eng.counts.items()
               if k.startswith("constrained_"))
    other = _port(tparams)
    other.submit(_prompt(), constrain=RX)
    other.run_pending()
    _, got = run()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_unconstrained_coresident_tokens_unchanged(tparams):
    """An unconstrained request sharing slots with a constrained one on a
    constraint-active engine (the masked programs, row 0) emits the
    tokens of a plain engine."""
    plain = _port(tparams)
    hp = plain.submit(_prompt(), max_new_tokens=8)
    plain.run_pending()
    mixed = _port(tparams)
    hc = mixed.submit(_prompt(8, 1), max_new_tokens=8, constrain=RX)
    hu = mixed.submit(_prompt(), max_new_tokens=8)
    mixed.run_pending()
    assert hc.status == teng.RequestStatus.COMPLETED
    np.testing.assert_array_equal(hu.result(), hp.result())


@LOOPS
def test_mixed_grammars_share_slots_no_new_program(tparams, pipeline):
    """Two grammars and unconstrained traffic sharing 2 slots, after one
    warm round: no program key is added, the second grammar's tokens are
    legal and accepted, and the table's device tensors are the ones the
    warm round used (a new grammar rewrites them in place)."""
    rx2 = "[cd]{2,6}"
    eng = _port(tparams, max_batch_size=2, pipeline=pipeline)
    warm = eng.submit(_prompt(), max_new_tokens=8, constrain=RX)
    eng.run_pending()
    assert warm.status == teng.RequestStatus.COMPLETED
    keys = set(eng._programs)
    dev = eng._ctab.device(eng.device)
    hs = [eng.submit(_prompt(seed=i), max_new_tokens=8,
                     constrain=(RX if i % 2 else rx2)) for i in range(3)]
    hs.append(eng.submit(_prompt(), max_new_tokens=8))
    eng.run_pending()
    assert all(h.status == teng.RequestStatus.COMPLETED for h in hs)
    assert set(eng._programs) == keys
    again = eng._ctab.device(eng.device)
    assert again[0] is dev[0] and again[1] is dev[1]
    g2 = compile_grammar(rx2, V)
    assert g2.accepts(_walk(g2, _gen(hs[0])))
    assert eng.counts["constrained_grammar_compiles"] == 2
    assert eng.counts["constrained_table_rows"] == eng._ctab.rows_used > 1


def test_oversize_rejected_with_documented_bound(tparams):
    """A grammar over the table bound is rejected at submit (compile-time
    bound, then a full table at acquire); a small one still serves."""
    eng = _port(tparams, constrain_state_cap=4)
    with pytest.raises(ConstraintError, match="constrain_state_cap") as ei:
        eng.submit(_prompt(), constrain="[ab]{1,64}")
    assert ei.value.reason == "oversize" and "5120 bytes" in str(ei.value)
    h = eng.submit(_prompt(), max_new_tokens=4, constrain="[ab]{1,2}")
    # the table holds 3 rows: [ab]{1,2} takes 1..2 (3 states, so row 3)
    # and [cd]{1,2}'s 3 states do not fit while h holds its rows
    with pytest.raises(ConstraintError, match="overflow") as ei:
        eng.submit(_prompt(), constrain="[cd]{1,2}")
    assert ei.value.reason == "oversize"
    eng.run_pending()
    assert h.status == teng.RequestStatus.COMPLETED
    assert eng.counts["constrained_rejected_oversize"] == 2
    assert eng.counts["constrained_requests"] == 1
    # released: the full table resets for the next grammar
    h2 = eng.submit(_prompt(), max_new_tokens=4, constrain="[cd]{1,2}")
    eng.run_pending()
    assert set(bytes(_gen(h2).tolist())) <= set(b"cd")


def test_invalid_unsupported_and_empty_rejected(tparams):
    """Typed rejections at submit, counted by reason; nothing admitted."""
    eng = _port(tparams)
    for bad, reason in ((r"(?=a)b", "unsupported"), (r"a+?", "unsupported"),
                        ({"type": "regex", "pattern": "ab", "consumed": 9},
                         "invalid"), (42, "invalid")):
        with pytest.raises(ConstraintError) as ei:
            eng.submit(_prompt(), constrain=bad)
        assert ei.value.reason == reason
    with pytest.raises(ConstraintError, match="zero tokens") as ei:
        eng.submit(np.array([97], np.int32),
                   constrain={"type": "regex", "pattern": "a",
                              "consumed": 1})
    assert ei.value.reason == "empty"
    c = eng.counts
    assert (c["constrained_rejected_unsupported"],
            c["constrained_rejected_invalid"],
            c["constrained_rejected_empty"]) == (2, 2, 1)
    assert c["constrained_requests"] == 0 and not eng._queue


def test_consumed_prompt_tail_is_replayed(tparams):
    """``consumed`` counts prompt-tail tokens the grammar already read: a
    prompt ending "ab" with consumed=2 under ``[ab]{1,5}`` leaves 3
    tokens, and an illegal tail is rejected at submit."""
    eng = _port(tparams)
    p = np.concatenate([_prompt(), np.array([97, 98], np.int32)])
    h = eng.submit(p, max_new_tokens=8,
                   constrain={"type": "regex", "pattern": RX,
                              "consumed": 2})
    eng.run_pending()
    g = compile_grammar(RX, V)
    assert g.is_terminal(_walk(g, _gen(h), g.replay([97, 98])))
    assert _gen(h).shape[0] == 3
    with pytest.raises(ConstraintError) as ei:
        eng.submit(_prompt(), constrain={"type": "regex", "pattern": RX,
                                         "consumed": 2})
    assert ei.value.reason == "invalid"


@pytest.mark.parametrize("arm", [
    dict(paged=True, page_size=8),
    dict(prefill_chunk=4),
    dict(kv_quantize="int8", paged=True, page_size=8),
    dict(temperature=0.8, top_k=40),
], ids=["paged", "chunked", "int8_paged", "sampled"])
def test_constrained_arm_matches_sync(tparams, arm):
    """Pipelined arms against the constrained synchronous engine of the
    same KV mode and sampling, token for token (JAX's
    test_constrained_int8_kv_matches_int8_sync among them): terminating
    and never-terminating grammars, float32. The sampled arm draws under
    the mask at temperature 0.8, top-k 40: every token legal."""
    base = {k: arm[k] for k in ("kv_quantize", "temperature", "top_k")
            if k in arm}
    reqs = [(_prompt(seed=0), 8, RX), (_prompt(seed=1), 8, "[ab]+"),
            (_prompt(8, 2), 8, None), (_prompt(5, 3), 8, RX),
            (_prompt(9, 4), 8, "[ab]+")]
    want = _serve(_port(tparams, pipeline=False, max_batch_size=2,
                        decode_chunk=4, **base), reqs)
    got = _serve(_port(tparams, max_batch_size=2, decode_chunk=4, **arm),
                 reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for toks, (_, _, spec) in zip(got, reqs):
        if spec is not None:
            assert set(bytes(toks.tolist())) <= set(b"ab")
            g = compile_grammar(spec, V)
            assert g.accepts(_walk(g, toks))


def test_constrained_moe_engine_matches_jax(mesh1):
    """An MoE config (4 experts, capacity 1.25: a decode step's cap is one
    token an expert) under the parity traffic's grammars, synchronous
    loop: the port's tokens equal JAX's, every one legal."""
    moe = {**FIELDS, "n_experts": 4}
    jp = jtf.init_params(jtf.TransformerConfig(**moe), jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    want = _serve(jeng.InferenceEngine(
        jtf.TransformerConfig(**moe), mesh1, jp, jeng.EngineConfig(
            decode_chunk=2, max_new_tokens=8, backoff_base_s=0.0,
            pipeline=False)), _traffic())
    eng = teng.InferenceEngine(
        ttf.TransformerConfig(**moe), tp, teng.EngineConfig(
            decode_chunk=2, max_new_tokens=8, pipeline=False), device="cpu")
    got = _serve(eng, _traffic())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.counts["constrained_requests"] == 3
    assert eng.counts["constrained_illegal"] == 0
