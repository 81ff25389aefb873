"""Shared pieces of the port's fleet tests (tests/test_torch_fleet.py,
tests/test_torch_disagg.py, tests/test_torch_fleet_worker.py): the
injected clock, one side of a reference-vs-port comparison (`Impl`: the
reference's fleet classes on a JAX tree, or the port's on the same tree
converted), the tick loop and the record a comparison holds equal.
"""
import numpy as np

import jax

from deeplearning4j_tpu.models import transformer as jtf
from deeplearning4j_tpu.parallel import failure as jfail
from deeplearning4j_tpu.serving import disagg as jdisagg
from deeplearning4j_tpu.serving import engine as jeng
from deeplearning4j_tpu.serving import fleet as jfleet

from deeplearning4j_tpu_torch.models import transformer as ttf
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.parallel import failure as tfail
from deeplearning4j_tpu_torch.serving import disagg as tdisagg
from deeplearning4j_tpu_torch.serving import engine as teng
from deeplearning4j_tpu_torch.serving import fleet as tfleet

# max_len 80: JAX's program caches are process-wide, and
# tests/test_profiling.py leaves AOT-loaded executables of its 64-position
# config in them for any later file on its worker
FIELDS = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_len=80)
STEP = 0.05                                  # clock seconds a tick


def prompt(t0=8, seed=0, vocab=32):
    return (np.arange(t0, dtype=np.int32) * (seed + 3)) % min(vocab, 50)


class Clock:
    """Injected clock shared by a router and its engines."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Impl:
    """One side of the comparison: the reference's fleet classes or the
    port's, with the weights and the keyword arguments that build
    in-process replicas there."""

    def __init__(self, name, fields, jp, tp, mesh):
        self.name = name
        if name == "jax":
            self.cfg = jtf.TransformerConfig(**fields)
            self.fleet, self.eng, self.fail = jfleet, jeng, jfail
            self.disagg = jdisagg
            self.build = dict(cfg=self.cfg, mesh=mesh, params=jp)
        else:
            self.cfg = ttf.TransformerConfig(**fields)
            self.fleet, self.eng, self.fail = tfleet, teng, tfail
            self.disagg = tdisagg
            self.build = dict(cfg=self.cfg, params=tp, device="cpu")

    def ec(self, **kw):
        base = dict(decode_chunk=2, max_new_tokens=12, backoff_base_s=0.0,
                    max_batch_size=2, pipeline=False)
        base.update(kw)
        return self.eng.EngineConfig(**base)

    def _common(self, fleet, inj, clock):
        fc = dict(restart_backoff_base_s=0.01)
        fc.update(fleet or {})
        return dict(config=self.fleet.FleetConfig(**fc),
                    fault_injector=(self.fail.FleetFaultInjector(**inj)
                                    if inj is not None else None),
                    clock=clock)

    def router(self, n=2, ec=None, fleet=None, inj=None, clock=None,
               **kw):
        clock = clock or Clock()
        r = self.fleet.Router(num_replicas=n, engine_config=ec or self.ec(),
                              **self._common(fleet, inj, clock),
                              **self.build, **kw)
        r._test_clock = clock
        return r

    def tiered(self, prefill=1, decode=1, pc=None, dc=None, fleet=None,
               inj=None, clock=None, **kw):
        clock = clock or Clock()
        ec = self.ec(paged=True)
        r = self.disagg.TieredRouter(
            prefill_replicas=prefill, decode_replicas=decode,
            prefill_engine_config=pc or ec, decode_engine_config=dc or ec,
            **self._common(fleet, inj, clock), **self.build, **kw)
        r._test_clock = clock
        return r

    def engine(self, ec):
        if self.name == "jax":
            return jeng.InferenceEngine(self.cfg, self.build["mesh"],
                                        self.build["params"], ec)
        return teng.InferenceEngine(self.cfg, self.build["params"], ec,
                                    device="cpu")


def impls(fields, mesh):
    """Both sides on one JAX tree (the port's converted)."""
    jp = jtf.init_params(jtf.TransformerConfig(**fields),
                         jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return {n: Impl(n, fields, jp, tp, mesh) for n in ("jax", "port")}


def drive(r, limit=3000):
    """Tick to completion, the injected clock advancing STEP a tick."""
    for _ in range(limit):
        if not r.pending():
            return
        r.tick()
        r._test_clock.advance(STEP)
    raise AssertionError("fleet failed to drain within bound")


def idle(r, ticks):
    for _ in range(ticks):
        r.tick()
        r._test_clock.advance(STEP)


def record(r, hs, inj=None):
    """What a comparison holds equal: per request the terminal status,
    the error type, the shed reasons, the router-side trace kinds and
    the committed tokens; the router's stats; the injector's counts."""
    reqs = []
    for h in hs:
        reqs.append(dict(
            status=str(h.status),
            error=type(h.error).__name__ if h.error is not None else None,
            shed=[e.data.get("reason") for e in h.trace.events
                  if e.kind == "shed"],
            kinds=h.trace.kinds(),
            tokens=np.asarray(h.generated).tolist()))
    out = dict(requests=reqs, stats=r.stats)
    if inj is not None:
        out["injected"] = {k: v for k, v in vars(inj).items()
                           if k.endswith("_injected") or k in (
                               "handoffs_failed", "frames_corrupted")}
    return out


def single(imp, prompts, max_new=12, ec=None):
    """Uninterrupted single engine of ``imp``: the token oracle."""
    out = []
    for p in prompts:
        eng = imp.engine(ec or imp.ec())
        h = eng.submit(p, max_new_tokens=max_new)
        eng.run_pending()
        out.append(h.result(0))
    return out
