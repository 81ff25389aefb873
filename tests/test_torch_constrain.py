"""Port parity: grammar-constrained decoding, the grammars and the masked
slot programs against JAX's.

The grammar compiler is a copy (`deeplearning4j_tpu_torch/serving/
constrain.py`): its tables must equal JAX's array for array, and its
rejections carry JAX's reasons. The masked programs (``constrain=True``
of every maker) run on the CPU against JAX's on a 1x1 mesh through its
plain reference paths (DL4JTPU_FLASH unset), both sides holding one JAX
`init_params` tree (`params_from_numpy`) and a two-grammar
`ConstraintTable` built on each side from the same grammars (equal
before any program runs). The model is JAX's constrained test's
(tests/test_serving_constrained.py: vocab 256, so the byte token map
covers every id; float32, greedy). Tolerances: tokens, first tokens and
the returned DFA states exactly; float32 caches 1e-5 (a paged pool's
scratch page 0 excluded); the int8 pool as tests/test_torch_quant_serving.py
holds it (values within 1), its float32 row scales to 2e-6 relative (the
K/V rows' products sum in other orders, a few ulps apart: 1.02e-6 was
seen at this width).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel import serving as jsv  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import constrain as jcon  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.parallel import serving as tsv  # noqa: E402
from deeplearning4j_tpu_torch.serving import constrain as tcon  # noqa
from deeplearning4j_tpu_torch.serving.paging import pages_for  # noqa: E402

FIELDS = dict(vocab_size=256, d_model=32, n_heads=4, n_layers=2, max_len=64)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
V = FIELDS["vocab_size"]
NS = 4
PS = 8
CAP = 128
CACHE = dict(rtol=0, atol=1e-5)
KEY = jax.random.PRNGKey(0)
RX = "[ab]{1,5}"
# the flagship's constrained bench schema (benchmarks/flagship.py:1479)
SCHEMA = {"type": "json_schema", "schema": {
    "type": "object",
    "properties": {"status": {"enum": ["ok", "retry", "dead"]},
                   "attempts": {"type": "integer"},
                   "fatal": {"type": "boolean"}}}}


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


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, V, size=(n,)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the grammars and the table against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    RX, "[ab]+", r"\d{2,4}-[a-f]?x", r"(foo|ba[rz])+\.", r"[^\n]{0,3}z",
    r"\x41\w\s\W", "(?:yes|no|maybe)", SCHEMA,
    {"type": "json_schema", "schema": {"type": "object", "properties": {
        "ok": {"type": "boolean"}}}},
], ids=["bounded", "plus", "digits", "alternation", "negated_class",
        "escapes", "group", "flagship_schema", "bool_schema"])
def test_compiled_grammar_matches_jax(spec):
    """The port's compile_grammar equals JAX's: allow, trans, accept and
    terminal, array for array, and the same normalized spec."""
    jg = jcon.compile_grammar(spec, V)
    tg = tcon.compile_grammar(spec, V)
    assert tg.key == jg.key and tg.spec == jg.spec
    assert tg.num_states == jg.num_states
    for name in ("allow", "trans", "accept", "terminal"):
        t, j = getattr(tg, name), getattr(jg, name)
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert tcon.schema_to_regex(SCHEMA["schema"]) == \
        jcon.schema_to_regex(SCHEMA["schema"])


@pytest.mark.parametrize("spec,reason,kw", [
    (r"(?=a)b", "unsupported", {}), (r"a+?", "unsupported", {}),
    (r"^ab$", "unsupported", {}),
    ({"type": "json_schema", "schema": {"anyOf": [{"type": "null"}]}},
     "unsupported", {}),
    ({"type": "grammar", "text": "x"}, "unsupported", {}),
    (42, "invalid", {}), ("a(b", "invalid", {}), ("[z-a]", "invalid", {}),
    ({"type": "regex", "pattern": "ab", "consumed": -1}, "invalid", {}),
    ("[ab]{1,64}", "oversize", dict(state_cap=4)),
], ids=["lookahead", "lazy", "anchors", "anyof", "type", "not_a_spec",
        "unclosed", "range", "consumed", "oversize"])
def test_constraint_errors_match_jax(spec, reason, kw):
    """Each rejection is a ConstraintError with JAX's reason (and the
    oversize one names the documented bound)."""
    with pytest.raises(jcon.ConstraintError) as je:
        jcon.compile_grammar(spec, V, **kw)
    with pytest.raises(tcon.ConstraintError) as te:
        tcon.compile_grammar(spec, V, **kw)
    assert te.value.reason == je.value.reason == reason
    assert str(te.value) == str(je.value)
    if reason == "oversize":
        assert "constrain_state_cap" in str(te.value)


def test_grammar_walk_and_empty_match_jax():
    """replay / legal / terminal agree on a committed prefix, and the
    "empty" case the engine rejects (a grammar already terminal after
    its consumed tail) is terminal on both sides."""
    jg, tg = jcon.compile_grammar("a", V), tcon.compile_grammar("a", V)
    assert tg.is_terminal(tg.replay([97])) and jg.is_terminal(
        jg.replay([97]))
    g = tcon.compile_grammar(RX, V)
    st = g.replay(list(b"abab"))
    assert g.accepts(st) and not g.is_terminal(st)
    assert g.is_terminal(g.advance(st, ord("a")))
    with pytest.raises(tcon.ConstraintError):
        g.advance(st, ord("c"))


def _tables(cap=CAP):
    """(JAX table, port table, row bases) with RX and SCHEMA acquired in
    that order on each side."""
    jt, tt = jcon.ConstraintTable(cap, V), tcon.ConstraintTable(cap, V)
    bases = []
    for spec in (RX, SCHEMA):
        jb = jt.acquire(jcon.compile_grammar(spec, V))
        assert tt.acquire(tcon.compile_grammar(spec, V)) == jb
        bases.append(jb)
    return jt, tt, bases


def test_constraint_table_matches_jax_and_rewrites_in_place():
    """The two tables are equal array for array; the port's device copy
    equals them, and a grammar acquired later rewrites the SAME device
    tensors (captured graphs read them by address). A table whose
    grammars are all released resets wholesale on the next acquire that
    needs room, as JAX's does; one that is full raises oversize."""
    jt, tt, bases = _tables()
    np.testing.assert_array_equal(tt.allow, jt.allow)
    np.testing.assert_array_equal(tt.trans, jt.trans)
    assert tt.rows_used == jt.rows_used and tt.bound_bytes() == CAP * V * 5
    dev = tt.device("cpu")
    assert dev is tt.device("cpu")
    np.testing.assert_array_equal(dev[0].numpy(), tt.allow)
    np.testing.assert_array_equal(dev[1].numpy(), tt.trans)
    g3 = tcon.compile_grammar("[cd]{2,6}", V)
    tt.acquire(g3)
    again = tt.device("cpu")
    assert again is dev and again[0] is dev[0] and again[1] is dev[1]
    np.testing.assert_array_equal(dev[1].numpy(), tt.trans)
    assert dev[0][bases[0] + 0, ord("a")] and \
        not dev[0][bases[0] + 0, ord("c")]
    # full: every grammar referenced, no room for a 60-state one
    big = tcon.compile_grammar("[ab]{1,59}", V)
    jbig = jcon.compile_grammar("[ab]{1,59}", V)
    with pytest.raises(tcon.ConstraintError) as te:
        tt.acquire(big)
    jt.acquire(jcon.compile_grammar("[cd]{2,6}", V))
    with pytest.raises(jcon.ConstraintError) as je:
        jt.acquire(jbig)
    assert te.value.reason == je.value.reason == "oversize"
    # released: the next acquire resets the table and takes row 1 on
    for spec in (RX, SCHEMA):
        tt.release(tcon.compile_grammar(spec, V).key)
        jt.release(jcon.compile_grammar(spec, V).key)
    tt.release(g3.key)
    jt.release(g3.key)
    assert tt.acquire(big) == jt.acquire(jbig) == 1
    np.testing.assert_array_equal(tt.trans, jt.trans)
    np.testing.assert_array_equal(tt.device("cpu")[1].numpy(), tt.trans)


# ---------------------------------------------------------------------------
# the masked programs against JAX's
# ---------------------------------------------------------------------------

class _Pair:
    """One pool on each side, their DFA-state vectors and the two-grammar
    table; ``call`` runs one masked program on both and compares."""

    def __init__(self, mesh1, jparams, tparams, paged=False, kv_mode=None):
        self.jp = jsv.shard_serving_params(jparams, JCFG, mesh1)
        self.tp = tparams
        self.mesh, self.kv_mode = mesh1, kv_mode
        self.paged, self.quant = paged, kv_mode is not None
        jt, tt, self.bases = _tables()
        self.jtab = (jnp.asarray(jt.allow), jnp.asarray(jt.trans))
        self.ttab = tt.device("cpu")
        self.grammars = [tcon.compile_grammar(s, V) for s in (RX, SCHEMA)]
        if paged:
            self.mp = pages_for(FIELDS["max_len"], PS)
            self.npg = NS * self.mp + 1
            self.bt = (1 + np.arange(NS * self.mp, dtype=np.int32)
                       ).reshape(NS, self.mp)
            self.j = list(jsv.init_paged_state(JCFG, mesh1, NS, PS,
                                               self.npg, kv_mode=kv_mode))
            self.t = list(tsv.init_paged_state(TCFG, NS, PS, self.npg,
                                               "cpu", kv_mode=kv_mode))
        else:
            self.j = list(jsv.init_slot_state(JCFG, mesh1, NS,
                                              kv_mode=kv_mode))
            self.t = list(tsv.init_slot_state(TCFG, NS, "cpu",
                                              kv_mode=kv_mode))
        self.jc = jnp.zeros((NS,), jnp.int32)
        self.tc = torch.zeros((NS,), dtype=torch.int32)

    def seeds(self, rows):
        """{slot: table row} -> (cseed, cseedval)."""
        cseed = np.zeros((NS,), bool)
        val = np.zeros((NS,), np.int32)
        for i, r in rows.items():
            cseed[i], val[i] = True, r
        return cseed, val

    def call(self, jfn, tfn, args, rows=None, spec=False):
        """Both programs on (pool, *args, table, states, seeds of
        ``rows``); pools, outputs and states compared; returns the
        outputs past the pool as numpy."""
        cseed, val = self.seeds(rows or {})
        jlead = (self.jp, self.jp) if spec else (self.jp,)
        tlead = (self.tp, self.tp) if spec else (self.tp,)
        jout = jfn(*jlead, *self.j, *(jnp.asarray(a) for a in args),
                   *self.jtab, self.jc, jnp.asarray(cseed),
                   jnp.asarray(val), KEY)
        tout = tfn(*tlead, *self.t, *(torch.from_numpy(a) for a in args),
                   *self.ttab, self.tc, torch.from_numpy(cseed),
                   torch.from_numpy(val), 0)
        n = len(self.t)
        assert len(tout) == len(jout) and tout[-1] is self.tc
        for i, (t, j) in enumerate(zip(tout[:n], jout[:n])):
            assert t is self.t[i]          # updated in place
            self._check(i, t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(self.tc.numpy(), np.asarray(jout[-1]),
                                      err_msg="cstate")
        for t, j in zip(tout[n:-1], jout[n:-1]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        self.j, self.jc = list(jout[:n]), jout[-1]
        return [t.numpy() for t in tout[n:-1]]

    def _check(self, i, t, j):
        n = len(self.t)
        if i >= n - 2:                                  # pos, tok
            np.testing.assert_array_equal(t, j)
            return
        if self.paged:
            t, j = t[:, 1:], j[:, 1:]
        if not self.quant:
            np.testing.assert_allclose(t, j, **CACHE)
        elif i >= 2:                                    # the scale planes
            np.testing.assert_allclose(t, j, rtol=2e-6, atol=0)
        else:
            d = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert d.max() <= 1 and np.mean(d != 0) <= 1e-3

    def legal(self, row, toks):
        """Whether ``toks`` (-1 ends them) walk from table row ``row``
        through allowed cells; returns the row reached."""
        allow, trans = (x.numpy() for x in self.ttab)
        for t in toks:
            if t < 0:
                break
            assert allow[row, t], (row, t)
            row = int(trans[row, t])
        return row


def _admit(pair, tb, lens, seed=20):
    """A masked one-shot prefill admitting slots ``lens`` {slot: n}, each
    seeded (slot 0 and 3: RX, slot 1: SCHEMA, slot 2: unconstrained)."""
    starts = {0: pair.bases[0], 1: pair.bases[1], 2: 0, 3: pair.bases[0]}
    if pair.paged:
        args = [pair.bt, np.zeros((NS, tb), np.int32),
                np.zeros((NS,), np.int32), np.zeros((NS,), np.int32)]
        toks, n = args[1], args[2]
        jfn = jsv.make_paged_prefill(JCFG, pair.mesh, tb, NS, PS, pair.mp,
                                     pair.npg, kv_mode=pair.kv_mode,
                                     constrain=True)
        tfn = tsv.make_paged_prefill(TCFG, tb, NS, PS, pair.mp, pair.npg,
                                     kv_mode=pair.kv_mode, constrain=True)
    else:
        args = [np.zeros((NS, tb), np.int32), np.zeros((NS,), np.int32)]
        toks, n = args
        jfn = jsv.make_continuous_prefill(JCFG, pair.mesh, tb, NS,
                                          kv_mode=pair.kv_mode,
                                          constrain=True)
        tfn = tsv.make_continuous_prefill(TCFG, tb, NS,
                                          kv_mode=pair.kv_mode,
                                          constrain=True)
    for i, k in lens.items():
        toks[i, :k] = _prompt(k, seed + i)
        n[i] = k
    rows = {i: starts[i] for i in lens}
    (first,) = pair.call(jfn, tfn, args, rows)
    assert (first[n == 0] == -1).all()
    for i in lens:
        pair.legal(rows[i], first[i:i + 1])
    return rows


def _chunk_calls(prompts, begin, c, last_only=True):
    """The calls that prefill ``prompts`` {slot: tokens} in chunks of c,
    slot i joining at call begin[i]: [(toks, clen, start, last)]."""
    done = {i: 0 for i in prompts}
    calls, n = [], 0
    while any(done[i] < p.shape[0] for i, p in prompts.items()):
        toks = np.zeros((NS, c), np.int32)
        clen, start = np.zeros((NS,), np.int32), np.zeros((NS,), np.int32)
        last = np.zeros((NS,), bool)
        for i, p in prompts.items():
            if n < begin[i] or done[i] >= p.shape[0]:
                continue
            k = min(c, p.shape[0] - done[i])
            toks[i, :k] = p[done[i]:done[i] + k]
            clen[i], start[i] = k, done[i]
            done[i] += k
            last[i] = done[i] >= p.shape[0]
        calls.append((toks, clen, start, last))
        n += 1
    return calls


@pytest.mark.parametrize("case", [
    "prefill", "decode", "spec", "decode_int8", "spec_int8",
    "chunked_prefill", "paged_prefill", "paged_chunked_prefill",
    "paged_decode", "paged_spec"])
def test_masked_program_matches_jax(mesh1, jparams, tparams, case):
    """Each maker's constrain=True program against JAX's on the same
    weights, pool, two-grammar table and seeds: slot 0 and 3 under
    ``[ab]{1,5}``, slot 1 under the flagship schema, slot 2 on the
    all-allow row 0. Decode and spec run after a masked prefill: an
    inactive slot, budgets ending mid-chunk or mid-window, a poisoned
    draft, and slot 3 reseeded mid-stream to its grammar's start. Every
    token a constrained slot emits is legal under the host's table."""
    kv_mode = "int8" if case.endswith("int8") else None
    paged = case.startswith("paged")
    pair = _Pair(mesh1, jparams, tparams, paged=paged, kv_mode=kv_mode)
    geo = (PS, pair.mp, pair.npg) if paged else ()
    lens = {0: 5, 1: 12, 2: 9, 3: 20}
    if case in ("prefill", "paged_prefill"):
        # two admission waves: the second's seeds leave the first's
        # states alone
        _admit(pair, 32, {0: 5, 2: 9})
        before = pair.tc.clone()
        _admit(pair, 32, {1: 12, 3: 20}, seed=30)
        assert pair.tc[0] == before[0] and pair.tc[2] == before[2]
        return
    if "chunked" in case:
        c = 5
        prompts = {i: _prompt(k, 20 + i) for i, k in lens.items()}
        calls = _chunk_calls(prompts, {0: 0, 1: 0, 2: 1, 3: 2}, c)
        jfn = (jsv.make_paged_chunked_prefill(JCFG, mesh1, c, NS, *geo,
                                              constrain=True) if paged else
               jsv.make_chunked_prefill(JCFG, mesh1, c, NS, constrain=True))
        tfn = (tsv.make_paged_chunked_prefill(TCFG, c, NS, *geo,
                                              constrain=True) if paged else
               tsv.make_chunked_prefill(TCFG, c, NS, constrain=True))
        rows = {0: pair.bases[0], 1: pair.bases[1], 2: 0, 3: pair.bases[0]}
        for n, call in enumerate(calls):
            args = ([pair.bt] if paged else []) + list(call)
            # every seed rides the first call, before slots 2 and 3 join
            (first,) = pair.call(jfn, tfn, args, rows if n == 0 else None)
            assert (first[~call[3]] == -1).all()
            for i in np.nonzero(call[3])[0]:
                pair.legal(rows[i], first[i:i + 1])
        return
    rows = _admit(pair, 32, lens)
    spec = case.endswith(("spec", "spec_int8"))
    active = np.array([True, True, True, False])
    if spec:
        k = 4
        jfn = (jsv.make_paged_speculative_decode(JCFG, mesh1, k, NS, *geo,
                                                 constrain=True) if paged
               else jsv.make_speculative_decode(JCFG, mesh1, k, NS,
                                                kv_mode=kv_mode,
                                                constrain=True))
        tfn = (tsv.make_paged_speculative_decode(TCFG, k, NS, *geo,
                                                 constrain=True) if paged
               else tsv.make_speculative_decode(TCFG, k, NS,
                                                kv_mode=kv_mode,
                                                constrain=True))
        steps = [(active, np.array([10, 2, 10, 10], np.int32),
                  np.array([0, 0, 1, 0], bool), None),
                 (np.ones(NS, bool), np.array([10, 10, 10, 10], np.int32),
                  np.zeros(NS, bool), {3: pair.bases[0]})]
    else:
        jfn = (jsv.make_paged_decode(JCFG, mesh1, 4, NS, *geo,
                                     constrain=True) if paged
               else jsv.make_continuous_decode(JCFG, mesh1, 4, NS,
                                               kv_mode=kv_mode,
                                               constrain=True))
        tfn = (tsv.make_paged_decode(TCFG, 4, NS, *geo, constrain=True)
               if paged else
               tsv.make_continuous_decode(TCFG, 4, NS, kv_mode=kv_mode,
                                          constrain=True))
        steps = [(active, np.array([4, 2, 4, 3], np.int32), None, None),
                 (np.ones(NS, bool), np.array([4, 4, 4, 4], np.int32),
                  None, {3: pair.bases[0]})]
    # the host's walk of every slot from its seat row
    host = {i: pair.legal(rows[i], [int(pair.t[-1][i])]) for i in rows}
    for act, rem, poison, reseed in steps:
        if reseed:
            host.update(reseed)
        args = ([pair.bt] if paged else []) + [act, rem] + (
            [poison] if spec else [])
        out = pair.call(jfn, tfn, args, reseed, spec=spec)
        toks = out[0]
        assert (toks[~act] == -1).all()
        for i in range(NS):
            if act[i]:
                host[i] = pair.legal(host[i], toks[i])
        if spec:
            assert (out[1][~act] == 0).all()
    assert pair.tc.tolist() == [host[i] for i in range(NS)]
