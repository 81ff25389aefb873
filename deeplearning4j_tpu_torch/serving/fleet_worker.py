"""Subprocess replica worker: one engine process behind a JSON pipe.

Port of deeplearning4j_tpu/serving/fleet_worker.py. `serving/fleet.py`'s
`SubprocessReplica` spawns this module (``python -m
deeplearning4j_tpu_torch.serving.fleet_worker``) to put a REAL process
boundary under the fleet's crash/hang scenarios. Protocol (the
reference's, key for key):

- stdin, line 1: the replica spec:
  ``{"cfg": {TransformerConfig kwargs}, "engine": {EngineConfig
  kwargs}, "params_seed": int, "progress_interval_s": float}``, plus
  the port's ``"device"`` (``"cpu"`` or ``"cuda[:i]"``; absent means
  the card, and without one the worker exits with the engine's error:
  there is no CPU fallback) and ``"warmup"`` (run `InferenceEngine.
  warmup` before the hello). Weights are re-derived from
  ``params_seed`` by `models.transformer.init_params`, which draws on a
  seeded CPU generator, so every replica of a fleet, on the card or
  on the CPU, holds the same values without shipping arrays across the
  pipe.
- stdout, line 1: ``{"ev": "hello", "port": <metrics port>, "pid":
  ..., "num_slots": ...}``: the port serves the engine's REAL
  `/healthz`/`/readyz`/`/metrics`/`/debugz` endpoints
  (observability.MetricsServer); the router probes them over HTTP.
  The port's hello adds ``"device"``, ``"jax_loaded"`` (whether
  ``jax`` is in this process's ``sys.modules``: it never is) and
  ``"kernels"`` (this process's nvcc runs and where each kernel
  library came from, `ops._build.nvcc_runs` / `origin`; a worker
  whose parent built the libraries loads them from the build
  directory or the compile cache and runs no nvcc).
- stdin thereafter: one JSON command per line: ``submit`` (carrying
  the router's distributed-tracing hop context, and optionally
  ``hold_kv`` plus a base64 kvwire handoff frame to adopt) /
  ``cancel`` / ``clock`` (clock-offset handshake: echoed back with
  this process's perf_counter) / ``drain`` / ``resume`` / ``reload`` /
  the kvwire ops ``export_kv`` / ``export_chain`` / ``seed_chain`` /
  ``release_held`` (KV handoffs and cached-chain migration cross the
  pipe as versioned CRC-checked frames, serving/kvwire.py) / ``qos``
  (qos_control actuation carried as one kvwire CONTROL frame) /
  ``advertised`` (fleet-advertised chain hashes for eviction bias) /
  ``stop``.
- stdout thereafter: streamed request events: ``accepted`` /
  ``rejected`` / ``progress`` (the committed tokens so far, the
  router's failover substrate when this process is SIGKILLed, plus
  the slot's committed-KV page count) / ``done`` / ``error`` (both
  carrying the request's completed ``RequestTrace`` so the router can
  stitch the fleet-wide distributed trace), plus
  ``drained``/``resumed``/``reloaded`` acks.

The engine runs its own background worker thread; a progress thread
polls in-flight handles at ``progress_interval_s``. A SIGKILL at any
point leaves the router holding each request's last progress snapshot,
which is exactly the committed prefix failover resumes from.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time


def main() -> int:
    spec = json.loads(sys.stdin.readline())

    import numpy as np

    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, init_params)
    from deeplearning4j_tpu_torch.observability.export import MetricsServer
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.serving import kvwire
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)

    cfg = TransformerConfig(**spec["cfg"])
    device = spec.get("device")
    params = init_params(cfg, int(spec.get("params_seed", 0)),
                         device=device)
    # restart-to-ready: the engine kwargs may carry compile_cache_dir
    # (+ warmup_on_init) so this worker LOADS its kernel libraries and
    # program manifests from the persistent cache instead of building
    # them; the hello line reports how long becoming servable took and
    # whether the programs were loads or builds, so the router-side
    # restart/autoscale latency is attributable
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params,
                          EngineConfig(**spec.get("engine", {})),
                          device=device)
    if spec.get("warmup") and eng.last_warmup is None:
        eng.warmup()
    cold_start_s = time.perf_counter() - t0
    srv = MetricsServer(eng.registry, port=0, health=eng.health,
                        ready=eng.ready, debug=eng.debugz,
                        profilez=eng.profilez)

    out_lock = threading.Lock()

    def _json_default(o):
        """Trace payloads may carry numpy scalars; the pipe is JSON."""
        if hasattr(o, "item"):
            return o.item()
        return str(o)

    def emit(obj: dict) -> None:
        with out_lock:
            sys.stdout.write(json.dumps(obj, default=_json_default)
                             + "\n")
            sys.stdout.flush()

    warm = eng.last_warmup
    emit({"ev": "hello", "port": srv.port, "pid": os.getpid(),
          "num_slots": eng._num_slots,
          "cold_start_s": round(cold_start_s, 4),
          "warmup": warm,
          # cross-host compile-cache priming: a
          # spec whose engine kwargs carry compile_cache_dir (+
          # warmup) starts WARM on a fresh host — every program an
          # AOT load — and says so here, so the router's debugz shows
          # whether autoscale-onto-new-host actually primed
          "cache_warm": (None if not warm
                         else (int(warm.get("aot_cache", 0) or 0) > 0
                               and int(warm.get("jit", 0) or 0) == 0)),
          # prefix-affinity advertisement: empty at birth,
          # but the key's presence tells the router this worker
          # piggybacks digests on its progress lines too
          "prefix_digest": eng.health().get("prefix_digest"),
          # KV wire capability: the frame version this
          # worker speaks — handoffs/migration cross the pipe instead
          # of degrading to re-prefill
          "kv_wire": kvwire.WIRE_VERSION,
          "device": str(eng.device),
          "jax_loaded": "jax" in sys.modules,
          "kernels": {"nvcc_runs": dict(_build.nvcc_runs),
                      "origin": dict(_build.origin)}})

    handles: dict = {}
    h_lock = threading.Lock()
    # held-slot handles: hold_kv submits park their handle
    # here — the progress loop pops `handles` entries at done, but an
    # export_kv/release_held for the slot arrives AFTER that. Only the
    # command-loop thread touches this dict.
    held: dict = {}
    stop = threading.Event()

    # digest piggyback state: re-emit the radix-cache
    # digest on a progress line only when its generation moved, so an
    # idle cache costs the pipe nothing
    last_digest_gen = [None]

    def _digest_update():
        dg = eng.health().get("prefix_digest")
        if dg and dg.get("generation") != last_digest_gen[0]:
            last_digest_gen[0] = dg.get("generation")
            return dg
        return None

    def progress_loop() -> None:
        """Stream each in-flight request's committed tokens — the
        router's failover substrate — and its terminal event."""
        interval = float(spec.get("progress_interval_s", 0.02))
        while not stop.wait(interval):
            with h_lock:
                items = list(handles.items())
            for rid, h in items:
                if h.done():
                    with h_lock:
                        handles.pop(rid, None)
                    toks = h.generated.tolist()
                    # the request's completed RequestTrace ships back
                    # on the terminal line: the router
                    # stitches it — clock-offset aligned — into the
                    # fleet-wide distributed trace
                    trace = h.trace.as_dicts()
                    if h.error is None:
                        emit({"ev": "done", "rid": rid, "tokens": toks,
                              "partial": bool(h.deadline_exceeded),
                              "trace": trace})
                    else:
                        emit({"ev": "error", "rid": rid,
                              "etype": type(h.error).__name__,
                              "msg": str(h.error), "tokens": toks,
                              "trace": trace})
                else:
                    # committed-KV page count rides every progress
                    # line: the router-side view
                    # of how much KV state a failover would re-prefill
                    # (0 on unpaged engines). The prefix-cache digest
                    # rides along when its generation moved
                    msg = {"ev": "progress", "rid": rid,
                           "tokens": h.generated.tolist(),
                           "kv_pages": eng.committed_kv_pages(h)}
                    dg = _digest_update()
                    if dg is not None:
                        msg["prefix_digest"] = dg
                    emit(msg)

    threading.Thread(target=progress_loop, daemon=True,
                     name="fleet-worker-progress").start()
    eng.start()

    for line in sys.stdin:
        try:
            cmd = json.loads(line)
        except ValueError:
            continue
        op = cmd.get("op")
        if op == "submit":
            rid = cmd["rid"]
            # KV adoption off the wire: a decode-tier
            # submit may carry the prefill tier's handoff as a kvwire
            # frame. Any decode failure degrades to a plain submit —
            # the prompt already contains the committed prefix, so
            # re-prefill is slower, never wrong.
            kv = None
            kvinfo = None
            if cmd.get("kvframe"):
                try:
                    kv = kvwire.decode_handoff(
                        kvwire.frame_from_text(cmd["kvframe"]))
                except Exception as e:
                    kvinfo = {"outcome": getattr(e, "kind", "error"),
                              "error": f"{type(e).__name__}: {e}"}
            hold = bool(cmd.get("hold_kv"))
            try:
                h = eng.submit(
                    np.asarray(cmd["prompt"], np.int32),
                    max_new_tokens=cmd.get("max_new_tokens"),
                    deadline_s=cmd.get("deadline_s"),
                    on_deadline=cmd.get("on_deadline", "shed"),
                    hold_kv=hold, kv=kv,
                    trace_ctx=cmd.get("trace_ctx"),
                    tenant=cmd.get("tenant"),
                    priority=int(cmd.get("priority") or 0),
                    constrain=cmd.get("constrain"))
            except Exception as e:
                emit({"ev": "rejected", "rid": rid,
                      "etype": type(e).__name__, "msg": str(e)})
                continue
            with h_lock:
                handles[rid] = h
            if hold:
                held[rid] = h
            msg = {"ev": "accepted", "rid": rid}
            if kvinfo is not None:
                msg["kvwire"] = kvinfo
            emit(msg)
        elif op == "export_kv":
            # held-slot KV export: gather the committed
            # rows, release the hold, ship them back as one frame
            call = cmd.get("call")
            h = held.pop(cmd.get("rid"), None)
            if h is None:
                emit({"ev": "wire", "call": call,
                      "error": "no held handle for rid "
                               f"{cmd.get('rid')}"})
                continue
            try:
                frame = kvwire.encode_handoff(
                    eng.export_slot_kv(h, release=True))
                emit({"ev": "wire", "call": call,
                      "frame": kvwire.frame_to_text(frame),
                      "nbytes": len(frame)})
            except Exception as e:
                emit({"ev": "wire", "call": call,
                      "error": f"{type(e).__name__}: {e}"})
        elif op == "export_chain":
            # cached-chain migration source: None frame =
            # chain evicted since advertisement — the router counts
            # it stale and moves on
            call = cmd.get("call")
            try:
                kvh = eng.export_cached_chain(int(cmd["hash"]))
                if kvh is None:
                    emit({"ev": "wire", "call": call, "frame": None})
                else:
                    frame = kvwire.encode_handoff(kvh)
                    emit({"ev": "wire", "call": call,
                          "frame": kvwire.frame_to_text(frame),
                          "nbytes": len(frame)})
            except Exception as e:
                emit({"ev": "wire", "call": call,
                      "error": f"{type(e).__name__}: {e}"})
        elif op == "seed_chain":
            # cached-chain migration sink
            call = cmd.get("call")
            try:
                kvh = kvwire.decode_handoff(
                    kvwire.frame_from_text(cmd["frame"]))
                emit({"ev": "wire", "call": call,
                      "ok": bool(eng.seed_cached_chain(kvh))})
            except Exception as e:
                emit({"ev": "wire", "call": call,
                      "error": f"{type(e).__name__}: {e}"})
        elif op == "release_held":
            h = held.pop(cmd.get("rid"), None)
            if h is not None:
                eng.release_held(h)
        elif op == "qos":
            # qos_control actuation over the pipe: one
            # kvwire CONTROL frame; chunk_shrink resolves against OUR
            # base chunk, which the router cannot see
            try:
                p = kvwire.decode_control(
                    kvwire.frame_from_text(cmd["frame"]))
                chunk = p.get("decode_chunk")
                if chunk is None and "chunk_shrink" in p:
                    chunk = (max(1, eng._base_chunk // 2)
                             if p["chunk_shrink"] else 0)
                state = eng.qos_control(spec_off=p.get("spec_off"),
                                        decode_chunk=chunk)
                emit({"ev": "qos_applied", "state": state})
            except Exception as e:
                emit({"ev": "qos_applied",
                      "error": f"{type(e).__name__}: {e}"})
        elif op == "advertised":
            try:
                eng.set_advertised_chains(cmd.get("hashes") or ())
            except Exception:
                pass
        elif op == "cancel":
            with h_lock:
                h = handles.get(cmd.get("rid"))
            if h is not None:
                eng.cancel(h)
        elif op == "clock":
            # clock-offset handshake: echo the router's t0
            # with OUR perf_counter; the router takes the min-RTT
            # midpoint as this process's offset
            emit({"ev": "clock", "t0": cmd.get("t0"),
                  "t": time.perf_counter()})
        elif op == "drain":
            eng.drain(wait=True)
            emit({"ev": "drained"})
        elif op == "resume":
            eng.resume()
            emit({"ev": "resumed"})
        elif op == "reload":
            try:
                step = eng.reload_weights(cmd["dir"],
                                          step=cmd.get("step"))
                emit({"ev": "reloaded", "step": int(step)})
            except Exception as e:
                emit({"ev": "reloaded", "step": -1,
                      "error": f"{type(e).__name__}: {e}"})
        elif op == "stop":
            break
    stop.set()
    srv.stop()
    try:
        eng.stop(drain=False)
    except Exception:
        pass
    emit({"ev": "bye"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
