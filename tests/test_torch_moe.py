"""Port parity: the mixture-of-experts MLP and the paths that run it.

The port's `moe_mlp` (models/transformer.py) is held to JAX's `moe_mlp`
and to its slot programs' `_local_moe_mlp` (parallel/serving.py, one
data rank) on the same seeded numpy inputs, then the model's forward and
`generate`, each slot program of an MoE config and the engine on four
pools in both loops against JAX's on a 1x1 mesh (DL4JTPU_FLASH unset:
JAX's plain attention paths, as in tests/test_torch_serving.py). The
gradients, the train step and quantization of an MoE tree are held in
tests/test_torch_{train,quant}.py. The JAX side's paged programs are built
with shard_map's replication check off (`_jax_moe_programs`): on this
JAX version the check cannot infer that `_local_moe_mlp`'s all_gather
over the one-rank 'data' axis is replicated and refuses them; the check
is static, so the values are the same either way.

Tolerances: `moe_mlp` in float32 within 1e-6 + 1e-6 |want|: the two
sides' tanh (XLA's CPU approximation, torch's) differ in the last bits,
which after the second expert product reaches a few ulp of outputs above
1, past 1e-6 alone; bfloat16 outputs within one bf16 rounding of that;
the index form against the dense GShard einsum form written in torch:
bit-equal (each token's einsum sums one non-zero term); logits 1e-4,
caches 1e-5; tokens exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel import serving as jsv  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.parallel import serving as tsv  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from deeplearning4j_tpu_torch.serving.paging import pages_for  # noqa

FIELDS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_len=96,
              n_experts=4)
NS = 4
D, E = FIELDS["d_model"], FIELDS["n_experts"]
CACHE = dict(rtol=0, atol=1e-5)
LOGITS = dict(rtol=0, atol=1e-4)


def _cfgs(cf):
    f = {**FIELDS, "capacity_factor": cf}
    return jtf.TransformerConfig(**f), ttf.TransformerConfig(**f)


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.delenv("DL4JTPU_FLASH", raising=False)


@pytest.fixture
def _jax_moe_programs(monkeypatch):
    """JAX's slot programs built with shard_map's replication check off
    (see the module docstring); undone after the test."""
    checked = jsv.shard_map

    def unchecked(*args, **kw):
        return checked(*args, **{**kw, "check_rep": False})

    monkeypatch.setattr(jsv, "shard_map", unchecked)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(MeshSpec(data=1, model=1))


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(_cfgs(1.25)[0], jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab_size"], size=(n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# the MLP itself
# ---------------------------------------------------------------------------

def _mlp_inputs(skew: bool, seed: int = 0, b: int = 3, t: int = 16):
    """h [b, t, D] (a layer norm's scale) and layer 0's router, We1, We2
    of a JAX init; ``skew`` pulls the router toward expert 0, so that
    expert overflows at every capacity below E."""
    jp = jtf.init_params(_cfgs(1.25)[0], jax.random.PRNGKey(seed))
    p = {k: np.array(jp["blocks"][k][0]) for k in ("router", "We1", "We2")}
    if skew:
        p["router"][:, 0] += 0.6
    h = np.random.default_rng(seed + 1).standard_normal(
        (b, t, D)).astype(np.float32)
    return h, p


def _port_mlp(h, p, tcfg, valid=None):
    return ttf.moe_mlp(torch.from_numpy(h),
                       {k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                       valid=None if valid is None
                       else torch.from_numpy(valid))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skew", [False, True], ids=["router", "skewed"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_moe_mlp_matches_jax(cf, skew, dtype):
    """JAX's moe_mlp on the same h and weights: float32 within 1e-6 +
    1e-6 |want| (see the module docstring), and
    the tokens it drops (exact zeros) the same; bfloat16 h (upcast, the
    experts in float32, the output rounded to bf16) within one bf16
    rounding of the float32 agreement."""
    jcfg, tcfg = _cfgs(cf)
    h, p = _mlp_inputs(skew)
    if dtype == "bfloat16":
        hj = jnp.asarray(h, jnp.bfloat16)
        ht = torch.from_numpy(h).to(torch.bfloat16)
    else:
        hj, ht = jnp.asarray(h), torch.from_numpy(h)
    want = np.asarray(jtf.moe_mlp(hj, {k: jnp.asarray(v)
                                       for k, v in p.items()}, jcfg)
                      ).astype(np.float32)
    got = ttf.moe_mlp(ht, {k: torch.from_numpy(v) for k, v in p.items()},
                      tcfg).float().numpy()
    dropped = ~want.any(axis=-1)
    np.testing.assert_array_equal(~got.any(axis=-1), dropped)
    cap = max(1, int(cf * h.shape[0] * h.shape[1] / E))
    if cap * E < h.shape[0] * h.shape[1] or skew and cf < E:
        assert dropped.any()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)


def _jax_local_moe(mesh1, jcfg, h, p, valid):
    """JAX's slot-program MoE (`_local_moe_mlp`, dp = 1) inside shard_map
    on the 1x1 mesh, as its programs call it."""
    from jax.experimental.shard_map import shard_map
    n = h.shape[0] * h.shape[1]

    def body(x, pp, v):
        return jsv._local_moe_mlp(x, pp, jcfg, 1, valid=v)

    f = shard_map(body, mesh=mesh1, in_specs=(P(), P(), P()),
                  out_specs=P(), check_rep=False)
    return np.asarray(f(jnp.asarray(h.reshape(n, D)),
                        {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(valid.reshape(n)))).reshape(h.shape)


def _pad_mask(b, t, seed):
    """[b, t] bool: each row valid up to a random length (some rows
    empty), as a bucket-padded prefill's ``t < plen``."""
    lens = np.random.default_rng(seed).integers(0, t + 1, size=b)
    lens[0] = t
    return np.arange(t)[None, :] < lens[:, None]


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_valid_mask_matches_jax_local_moe(mesh1, cf, seed):
    """With a pad mask the port's moe_mlp equals JAX's `_local_moe_mlp`
    at one data rank within 1e-6 + 1e-6 |want|: masked rows take no
    place and give 0, the cap still counts them."""
    jcfg, tcfg = _cfgs(cf)
    h, p = _mlp_inputs(skew=True, seed=seed, b=4, t=12)
    valid = _pad_mask(4, 12, seed)
    want = _jax_local_moe(mesh1, jcfg, h, p, valid)
    got = _port_mlp(h, p, tcfg, valid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[~valid].any()


def _gshard_reference(h, p, cfg, valid=None):
    """The reference's dense dispatch / combine einsums, in torch."""
    b, t, d = h.shape
    x = h.reshape(b * t, d).float()
    n, e = x.shape[0], cfg.n_experts
    gates = torch.softmax(x @ p["router"], dim=-1)
    expert = torch.argmax(gates, dim=-1)
    prob = torch.gather(gates, 1, expert[:, None])[:, 0]
    cap = max(1, int(cfg.capacity_factor * n / e))
    onehot = torch.nn.functional.one_hot(expert, e).float()
    if valid is not None:
        onehot = onehot * valid.reshape(n, 1).float()
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    keep = (pos >= 0) & (pos < cap)
    posc = torch.clamp(pos, 0, cap - 1).long()
    disp = (torch.nn.functional.one_hot(posc, cap).float()
            * keep[..., None].float() * onehot[..., None])
    xin = torch.einsum("nec,nd->ecd", disp, x)
    z = torch.nn.functional.gelu(
        torch.einsum("ecd,edf->ecf", xin, p["We1"]), approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", z, p["We2"])
    y = torch.einsum("nec,ecd->nd", disp * prob[:, None, None], out)
    return y.to(h.dtype).reshape(b, t, d)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "padded"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_index_form_equals_einsum_form(cf, masked):
    """The index form (scatter to [E*cap + 1, D], two batched products,
    gather) is bit-equal to the GShard einsums in float32."""
    _, tcfg = _cfgs(cf)
    h, p = _mlp_inputs(skew=True, seed=5, b=4, t=12)
    valid = torch.from_numpy(_pad_mask(4, 12, 5)) if masked else None
    ht = torch.from_numpy(h)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    got = ttf.moe_mlp(ht, pt, tcfg, valid=valid)
    assert torch.equal(got, _gshard_reference(ht, pt, tcfg, valid))


def test_backward_is_deterministic_and_routes_through_prob():
    """Two backward passes of a drop-heavy call are bit-equal; the router
    gets a gradient (through each kept token's gate only), dropped tokens
    none from the experts, and a drop-free capacity gives the same
    outputs to the kept tokens."""
    _, tcfg = _cfgs(0.5)
    h, p = _mlp_inputs(skew=True, seed=6)

    def grads():
        ht = torch.from_numpy(h).requires_grad_()
        pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        y = ttf.moe_mlp(ht, pt, tcfg)
        (y * torch.linspace(-1, 1, D)).sum().backward()
        return y.detach(), ht.grad, {k: v.grad for k, v in pt.items()}

    y1, gh1, gp1 = grads()
    y2, gh2, gp2 = grads()
    assert torch.equal(y1, y2) and torch.equal(gh1, gh2)
    assert all(torch.equal(gp1[k], gp2[k]) for k in gp1)
    dropped = ~y1.reshape(-1, D).any(dim=-1)
    assert dropped.any() and gp1["router"].abs().sum() > 0
    # a dropped token's input gradient is 0 (its gate multiplies 0)
    assert not gh1.reshape(-1, D)[dropped].any()
    _, wide = _cfgs(8.0)
    y_wide = ttf.moe_mlp(torch.from_numpy(h),
                         {k: torch.from_numpy(v) for k, v in p.items()},
                         wide).reshape(-1, D)
    assert torch.equal(y_wide[~dropped], y1.reshape(-1, D)[~dropped])


# ---------------------------------------------------------------------------
# the model: forward, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_forward_and_generate_match_jax(jparams, tparams, cf):
    """Logits within 1e-4 and greedy `generate` (prefill N = B*T0, each
    decode step N = B) token-exact against JAX's."""
    jcfg, tcfg = _cfgs(cf)
    toks = np.stack([_prompt(12, s) for s in range(3)])
    want = np.asarray(jtf.forward(jcfg, jparams, jnp.asarray(toks)))
    got = ttf.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGITS)
    jgen = jtf.generate(jcfg, jparams, jnp.asarray(toks), 10,
                        jax.random.PRNGKey(0), temperature=0.0)
    tgen = ttf.generate(tcfg, tparams, torch.from_numpy(toks), 10,
                        temperature=0.0)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(jgen))


def test_init_params_has_the_reference_moe_layout():
    """router [L, D, E], We1 [L, E, D, F], We2 [L, E, F, D] in place of
    W1 / b1 / W2 / b2, as JAX's init lays them out."""
    jcfg, tcfg = _cfgs(1.25)
    want = jtf.init_params(jcfg, jax.random.PRNGKey(0))["blocks"]
    got = ttf.init_params(tcfg, seed=0, device="cpu")["blocks"]
    assert got.keys() == want.keys()
    assert all(tuple(got[k].shape) == want[k].shape for k in want)


# ---------------------------------------------------------------------------
# the slot programs against JAX's
# ---------------------------------------------------------------------------

def _assert_state(tstate, jstate, paged=False):
    for i, (t, j) in enumerate(zip(tstate, jstate)):
        t, j = t.numpy(), np.asarray(j)
        if i < 2:
            if paged:      # the scratch page: written in no defined order
                t, j = t[:, 1:], j[:, 1:]
            np.testing.assert_allclose(t, j, **CACHE)
        else:
            np.testing.assert_array_equal(t, j)


def _call(jfn, tfn, jstate, tstate, sparams, tparams, *args, paged=False):
    key = jax.random.PRNGKey(0)
    *jstate, jout = jfn(sparams, *jstate, *(jnp.asarray(a) for a in args),
                        key)
    *tstate, tout = tfn(tparams, *tstate,
                        *(torch.from_numpy(a) for a in args), 0)
    _assert_state(tstate, jstate, paged)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    return jstate, tstate, tout.numpy()


def _pool(prefixes, tb):
    prompts = np.zeros((NS, tb), np.int32)
    plen = np.zeros((NS,), np.int32)
    for i, p in prefixes.items():
        prompts[i, :p.shape[0]] = p
        plen[i] = p.shape[0]
    return prompts, plen


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_slot_prefill_and_decode_match_jax(mesh1, jparams, tparams, cf):
    """Two admission waves (pad rows and passing-through slots masked out
    of routing, N = Ns * Tb), then a decode chunk (N = Ns, every slot
    routed, one inactive and two running out of budget mid-chunk):
    caches 1e-5, every int output exactly."""
    jcfg, tcfg = _cfgs(cf)
    sparams = jsv.shard_serving_params(jparams, jcfg, mesh1)
    jstate = tuple(jsv.init_slot_state(jcfg, mesh1, NS))
    tstate = tsv.init_slot_state(tcfg, NS, "cpu")
    for wave in ({0: _prompt(5, 1), 2: _prompt(12, 2)},
                 {1: _prompt(16, 3), 3: _prompt(9, 4)}):
        jstate, tstate, _ = _call(
            jsv.make_continuous_prefill(jcfg, mesh1, 16, NS),
            tsv.make_continuous_prefill(tcfg, 16, NS), jstate, tstate,
            sparams, tparams, *_pool(wave, 16))
    active = np.array([True, True, True, False])
    rem = np.array([4, 2, 1, 3], np.int32)
    _, _, toks = _call(jsv.make_continuous_decode(jcfg, mesh1, 4, NS),
                       tsv.make_continuous_decode(tcfg, 4, NS), jstate,
                       tstate, sparams, tparams, active, rem)
    assert (toks[3] == -1).all() and (toks[2, 1:] == -1).all()


def test_pad_rows_claim_no_capacity(mesh1, jparams, tparams, monkeypatch):
    """A prefill whose bucket is mostly pad: JAX's program, which masks
    pad rows out of routing, equals the port's; the port with the mask
    dropped (pads routed) gives other caches, so the mask is what the
    comparison holds."""
    jcfg, tcfg = _cfgs(0.5)
    sparams = jsv.shard_serving_params(jparams, jcfg, mesh1)
    prompts, plen = _pool({0: _prompt(10, 7), 2: _prompt(3, 8)}, 32)
    jstate = tuple(jsv.init_slot_state(jcfg, mesh1, NS))
    tstate = tsv.init_slot_state(tcfg, NS, "cpu")
    _, tstate, _ = _call(jsv.make_continuous_prefill(jcfg, mesh1, 32, NS),
                         tsv.make_continuous_prefill(tcfg, 32, NS), jstate,
                         tstate, sparams, tparams, prompts, plen)
    moe = tsv.moe_mlp
    monkeypatch.setattr(tsv, "moe_mlp",
                        lambda x, p, cfg, valid=None: moe(x, p, cfg))
    routed = tsv.init_slot_state(tcfg, NS, "cpu")
    tsv.make_continuous_prefill(tcfg, 32, NS)(
        tparams, *routed, torch.from_numpy(prompts),
        torch.from_numpy(plen), 0)
    assert not torch.allclose(routed[0], tstate[0], rtol=0, atol=1e-3)


def _chunks(prompts, c):
    """(toks, clen, start, last) calls prefilling ``prompts`` {slot:
    tokens} in chunks of c, every slot from the first call."""
    done = {i: 0 for i in prompts}
    calls = []
    while any(done[i] < p.shape[0] for i, p in prompts.items()):
        toks = np.zeros((NS, c), np.int32)
        clen, start = np.zeros((NS,), np.int32), np.zeros((NS,), np.int32)
        last = np.zeros((NS,), bool)
        for i, p in prompts.items():
            k = min(c, p.shape[0] - done[i])
            if k <= 0:
                continue
            toks[i, :k] = p[done[i]:done[i] + k]
            clen[i], start[i] = k, done[i]
            done[i] += k
            last[i] = done[i] == p.shape[0]
        calls.append((toks, clen, start, last))
    return calls


CHUNKED = {0: _prompt(21, 1), 2: _prompt(10, 2), 3: _prompt(30, 3)}


def test_chunked_prefill_matches_jax(mesh1, jparams, tparams):
    """Three prompts in chunks of 8 (N = Ns * C a call, rows past clen
    masked out of routing): caches 1e-5, pos, tok and first exactly."""
    jcfg, tcfg = _cfgs(0.5)
    sparams = jsv.shard_serving_params(jparams, jcfg, mesh1)
    jstate = tuple(jsv.init_slot_state(jcfg, mesh1, NS))
    tstate = tsv.init_slot_state(tcfg, NS, "cpu")
    jfn = jsv.make_chunked_prefill(jcfg, mesh1, 8, NS)
    tfn = tsv.make_chunked_prefill(tcfg, 8, NS)
    for call in _chunks(CHUNKED, 8):
        jstate, tstate, _ = _call(jfn, tfn, jstate, tstate, sparams,
                                  tparams, *call)
    assert tstate[2].tolist() == [21, 0, 10, 30]


def _table(ps, lens):
    mp = pages_for(FIELDS["max_len"], ps)
    bt = np.zeros((NS, mp), np.int32)
    nxt = 1
    for i, n in lens.items():
        k = pages_for(n, ps)
        bt[i, :k] = np.arange(nxt, nxt + k)
        nxt += k
    return bt, mp, nxt + 1


@pytest.mark.usefixtures("_jax_moe_programs")
def test_paged_prefill_and_decode_match_jax(mesh1, jparams, tparams):
    """A paged prefill (N = Ns * Tb, pad rows masked) then a paged decode
    chunk (N = Ns): pools 1e-5 off the scratch page, ints exactly."""
    jcfg, tcfg = _cfgs(0.5)
    ps = 8
    bt, mp, npg = _table(ps, {0: 21 + 4, 1: 7 + 4, 2: 12 + 4})
    sparams = jsv.shard_serving_params(jparams, jcfg, mesh1)
    jstate = tuple(jsv.init_paged_state(jcfg, mesh1, NS, ps, npg))
    tstate = tsv.init_paged_state(tcfg, NS, ps, npg, "cpu")
    suffix, slen = _pool({0: _prompt(21, 1), 1: _prompt(7, 2),
                          2: _prompt(12, 3)}, 24)
    jstate, tstate, _ = _call(
        jsv.make_paged_prefill(jcfg, mesh1, 24, NS, ps, mp, npg),
        tsv.make_paged_prefill(tcfg, 24, NS, ps, mp, npg), jstate, tstate,
        sparams, tparams, bt, suffix, slen, np.zeros((NS,), np.int32),
        paged=True)
    active = np.array([True, True, True, False])
    rem = np.array([4, 2, 4, 3], np.int32)
    _call(jsv.make_paged_decode(jcfg, mesh1, 4, NS, ps, mp, npg),
          tsv.make_paged_decode(tcfg, 4, NS, ps, mp, npg), jstate, tstate,
          sparams, tparams, bt, active, rem, paged=True)


@pytest.mark.usefixtures("_jax_moe_programs")
def test_paged_chunked_prefill_matches_jax(mesh1, jparams, tparams):
    """The chunked prompts in chunks of 8 on the paged pool."""
    jcfg, tcfg = _cfgs(0.5)
    ps = 8
    bt, mp, npg = _table(ps, {i: p.shape[0] for i, p in CHUNKED.items()})
    sparams = jsv.shard_serving_params(jparams, jcfg, mesh1)
    jstate = tuple(jsv.init_paged_state(jcfg, mesh1, NS, ps, npg))
    tstate = tsv.init_paged_state(tcfg, NS, ps, npg, "cpu")
    jfn = jsv.make_paged_chunked_prefill(jcfg, mesh1, 8, NS, ps, mp, npg)
    tfn = tsv.make_paged_chunked_prefill(tcfg, 8, NS, ps, mp, npg)
    for call in _chunks(CHUNKED, 8):
        jstate, tstate, _ = _call(jfn, tfn, jstate, tstate, sparams,
                                  tparams, bt, *call, paged=True)
    assert tstate[2].tolist() == [21, 0, 10, 30]


def test_paged_duplicate_writes_resolve_to_the_last():
    """`_last_write_wins`: writes sharing a (page, offset) target all
    carry the last one's values (row-major order), so an index write
    stores that value in any order; unique targets keep their own rows.
    A many-to-one write (pad rows on the scratch page) then gives the
    same page twenty times over, as a sequential scatter does."""
    ps, npg = 4, 6
    kv = (torch.zeros(1, npg, ps, 8),)
    rng = np.random.default_rng(9)
    pg = torch.from_numpy(rng.integers(0, 3, (16, 40)))
    off = torch.from_numpy(rng.integers(0, ps, (16, 40)))
    rows = torch.from_numpy(rng.standard_normal((16, 40, 8)).astype(
        np.float32))
    got, = tsv._last_write_wins(kv, pg, off, rows)
    want = np.zeros((npg, ps, 8), np.float32)
    for b in range(16):
        for t in range(40):
            want[pg[b, t], off[b, t]] = rows[b, t].numpy()
    for b in range(16):
        for t in range(40):
            np.testing.assert_array_equal(got[b, t].numpy(),
                                          want[pg[b, t], off[b, t]])
    pages = set()
    for _ in range(20):
        plane = kv[0][0].clone()
        plane[(pg, off)] = got
        pages.add(plane.numpy().tobytes())
    assert pages == {want.tobytes()}


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

POOLS = {"contiguous": {},
         "paged": dict(paged=True, page_size=8, prefix_cache=True),
         "chunked": dict(prefill_chunk=5),
         "int8": dict(quantize="int8", kv_quantize="int8")}


def _engine_prompts():
    """Six prompts, three sharing a 16-token prefix (page-aligned)."""
    sys_prompt = _prompt(16, 60)
    return ([np.concatenate([sys_prompt, _prompt(n, 61 + n)])
             for n in (0, 5, 9)] + [_prompt(n, 70 + n) for n in (7, 25, 12)])


# The port's pipelined loop makes the synchronous loop's calls; JAX's
# refills a freed slot a tick later. An MoE decode chunk routes every
# slot's token, so where the capacity binds the schedule moves tokens:
# the pipelined port is held to JAX's synchronous engine at capacity
# 1.25 (one token an expert a decode step at 4 slots) and to JAX's
# pipelined engine at 8.0, where the capacity never binds.
@pytest.mark.parametrize("pipeline,cf,jax_pipeline", [
    (False, 1.25, False), (True, 1.25, False), (True, 8.0, True)],
    ids=["sync", "pipelined", "pipelined_nodrop"])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.usefixtures("_jax_moe_programs")
def test_moe_engine_matches_jax_engine(mesh1, jparams, tparams, pool,
                                      pipeline, cf, jax_pipeline):
    """Six greedy requests through 4 slots (the paged pool twice, the
    second wave prefix hits) on each pool: token-exact against JAX's
    engine; at capacity 1.25 the synchronous engine's tokens differ from
    its tokens at 8.0 (the cap binds)."""
    kw = dict(num_slots=NS, decode_chunk=3, max_new_tokens=8,
              **POOLS[pool])
    waves = 2 if pool == "paged" else 1

    def serve(eng):
        out = []
        for _ in range(waves):
            hs = [eng.submit(p) for p in _engine_prompts()]
            eng.run_pending()
            out += [h.result() for h in hs]
        return out

    def port(c, loop):
        return teng.InferenceEngine(_cfgs(c)[1], tparams, teng.EngineConfig(
            pipeline=loop, **kw), device="cpu")

    want = serve(jeng.InferenceEngine(_cfgs(cf)[0], mesh1, jparams,
                                      jeng.EngineConfig(
                                          backoff_base_s=0.0,
                                          pipeline=jax_pipeline, **kw)))
    eng = port(cf, pipeline)
    got = serve(eng)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.drained()
    if pool == "paged":
        assert eng.counts["prefix_hits"] > 0
        assert eng.counts["pages_used"] == eng.prefix_cache_pages
    if pool == "chunked":
        assert eng.counts["prefill_chunks"] > len(_engine_prompts())
    if cf < 8.0 and not pipeline:
        wide = serve(port(8.0, False))
        assert any(not np.array_equal(a, b) for a, b in zip(got, wide))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_spec_program_refuses_moe(mesh1):
    """make_speculative_decode raises JAX's ValueError, word for word."""
    jcfg, tcfg = _cfgs(1.25)
    with pytest.raises(ValueError) as want:
        jsv.make_speculative_decode(jcfg, mesh1, 4, NS)
    with pytest.raises(ValueError) as got:
        tsv.make_speculative_decode(tcfg, 4, NS)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="MoE"):
        tsv.make_paged_speculative_decode(tcfg, 4, NS, 8, 12, 64)


def test_spec_engine_refuses_moe(mesh1, jparams, tparams):
    """spec_decode=True with an MoE config raises at construction, as
    JAX's engine does; every other pool builds."""
    jcfg, tcfg = _cfgs(1.25)
    with pytest.raises(ValueError) as want:
        jeng.InferenceEngine(jcfg, mesh1, jparams,
                             jeng.EngineConfig(spec_decode=True))
    with pytest.raises(ValueError) as got:
        teng.InferenceEngine(tcfg, tparams,
                             teng.EngineConfig(spec_decode=True),
                             device="cpu")
    assert str(got.value) == str(want.value)
    teng.InferenceEngine(tcfg, tparams, teng.EngineConfig(
        paged=True, prefill_chunk=8, quantize="int8", kv_quantize="int8"),
        device="cpu")
