"""Framework-as-Keras-backend RPC server (port of
deeplearning4j_tpu/keras_server.py).

The reference's deeplearning4j-keras module (Server.java:18, a py4j
GatewayServer exposing DeepLearning4jEntryPoint.fit():21-33, which
imports a Keras HDF5 model and trains it on minibatch files pushed from
Python). Both sides are Python here, so the wire is plain HTTP/JSON on
localhost; the entry-point surface is the same: fit and predict against
files on shared disk. Models are imported through the port's Keras
import onto the server's device (the card unless ``device="cpu"``).

Endpoints:
  POST /fit      {"model_path", "data_path" (npz: features, labels),
                  "epochs"?, "batch_size"?} -> {"scores": [...]}
  POST /predict  {"model_path"?, "data_path"} -> {"output_path"}
  GET  /health
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import urlparse

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device


class DeepLearning4jEntryPoint:
    """Reference: DeepLearning4jEntryPoint.java, the RPC surface."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._model_cache: Dict[str, Any] = {}
        self._model_locks: Dict[str, threading.Lock] = {}
        self._cache_lock = threading.Lock()

    def _load(self, model_path: str):
        """Import (once) and return (model, per-model lock). Networks are
        stateful (params / updater / iteration), so concurrent RPCs on the
        same model serialize on its lock."""
        with self._cache_lock:
            lock = self._model_locks.setdefault(model_path,
                                                threading.Lock())
        with lock:
            if model_path not in self._model_cache:
                from deeplearning4j_tpu_torch.modelimport.keras import \
                    import_keras_model_auto
                self._model_cache[model_path] = import_keras_model_auto(
                    model_path, device=self.device)
        return self._model_cache[model_path], lock

    def fit(self, model_path: str, data_path: str, epochs: int = 1,
            batch_size: int = 32) -> Dict[str, Any]:
        """Reference: DeepLearning4jEntryPoint.sequentialFit: import the
        Keras model, train on the pushed minibatch file."""
        from deeplearning4j_tpu_torch.datasets.iterators import \
            BaseDatasetIterator
        net, lock = self._load(model_path)
        with np.load(data_path) as data:
            x, y = data["features"], data["labels"]
        scores = []
        with lock:
            for _ in range(int(epochs)):
                net.fit(BaseDatasetIterator(x, y, int(batch_size)))
                scores.append(float(net.score_value))
        return {"scores": scores}

    def predict(self, model_path: str, data_path: str,
                output_path: Optional[str] = None) -> Dict[str, Any]:
        net, lock = self._load(model_path)
        with np.load(data_path) as data:
            x = data["features"]
        with lock:
            out = net.output(x)
        if isinstance(out, list):
            out = out[0]
        output_path = output_path or data_path + ".out.npy"
        out = out.detach().cpu()
        if out.dtype == torch.bfloat16:     # numpy has no bfloat16
            out = out.float()
        np.save(output_path, out.numpy())
        return {"output_path": output_path}


class KerasServer:
    """Reference: Server.java, which starts the gateway; here an HTTP
    server bound to localhost."""

    def __init__(self, port: int = 0, device=None):
        entry = DeepLearning4jEntryPoint(device)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if urlparse(self.path).path == "/health":
                    self._json({"ok": True})
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                path = urlparse(self.path).path
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                    if path == "/fit":
                        self._json(entry.fit(
                            req["model_path"], req["data_path"],
                            req.get("epochs", 1),
                            req.get("batch_size", 32)))
                    elif path == "/predict":
                        self._json(entry.predict(
                            req["model_path"], req["data_path"],
                            req.get("output_path")))
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:  # RPC boundary: report, don't die
                    self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        self.entry_point = entry
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=30)
