"""REST serving frontend (stdlib http.server).

Endpoint parity with the reference's TorchServe deployment
(``torchserve/config.properties:2-4``, ``torchserve/recommend.sh:1``):

    POST /v1/models/lightgcn_recommender:predict
        body: JSON list of relabelled user ids, e.g. ``[1189793]``
        response: ``{"items": [[20 local item ids], ...]}`` — the same
        payload shape the reference handler returns
        (``torchserve/lightgcn_handler.py:94``).
    GET  /ping                      → {"status": "Healthy"}   (TorchServe ping)
    GET  /v1/models/lightgcn_recommender → model/config stats (management API
        analog of TorchServe's :8081 describe endpoint).
    GET  /metrics                   → Prometheus text counters (metrics API
        analog of TorchServe's :8082 endpoint, ``config.properties:4``).

Management API (TorchServe :8081 register/unregister/scale-workers parity,
``config.properties:3`` — one port here; the verbs map 1:1):

    GET    /v1/models                                     → list versions
    POST   /v1/models/lightgcn_recommender:register
           body {"checkpoint_dir": …, "checkpoint_name": …, "version": …,
                 "set_default": true}                     → load + swap in a
           new model version atomically (old version kept for rollback)
    PUT    /v1/models/lightgcn_recommender/<version>/set-default
    DELETE /v1/models/lightgcn_recommender/<version>      → unregister
    PUT    /v1/models/lightgcn_recommender?workers=N      → resize the
           batcher's dispatch worker pool (scale-workers analog; 501 when
           batching is disabled)
    POST   /v1/models/lightgcn_recommender:refresh        → re-propagate the
           active version from its checkpoint directory

Counterpart of ``gnn_ecommerce_tpu/serve/server.py``: one Python process
hosts a threaded HTTP server in front of the device-resident embedding cache.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .service import RecommenderService

MODEL_NAME = "lightgcn_recommender"
# The listen backlog. The stdlib server's is 5: with more clients connecting
# at once the kernel drops handshakes beyond it (the client retries after a
# 1 s timeout) and resets some connections. Every request opens a connection
# (HTTP/1.0), so 16 concurrent clients overflow 5. A deliberate difference
# from the JAX server, which keeps the stdlib's.
LISTEN_BACKLOG = 128


class _HTTPServer(ThreadingHTTPServer):
    request_queue_size = LISTEN_BACKLOG


def make_server(service: RecommenderService, host: str = "127.0.0.1", port: int = 8080):
    """Build a ThreadingHTTPServer bound to (host, port); port 0 = ephemeral."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/ping":
                self._send(200, {"status": "Healthy"})
            elif self.path == "/v1/models":
                # Management list-models analog.
                self._send(
                    200, {"models": [{"modelName": MODEL_NAME,
                                      "versions": service.list_versions()}]}
                )
            elif self.path == f"/v1/models/{MODEL_NAME}":
                self._send(200, {"model": MODEL_NAME, **service.stats()})
            elif self.path == "/metrics":
                # TorchServe metrics-port (:8082) analog: Prometheus text
                # exposition of the serving counters.
                lines = []
                for name, val in service.metrics().items():
                    lines.append(f"# TYPE lightgcn_{name} "
                                 f"{'counter' if name.endswith('_total') else 'gauge'}")
                    lines.append(f"lightgcn_{name} {val}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def _read_json(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"null")

        def do_PUT(self):
            from urllib.parse import parse_qs, urlparse

            parsed = urlparse(self.path)
            # Scale-workers analog: PUT /v1/models/<name>?workers=N
            if parsed.path == f"/v1/models/{MODEL_NAME}":
                q = parse_qs(parsed.query)
                if "workers" not in q:
                    self._send(400, {"error": "missing ?workers=N"})
                    return
                if not hasattr(service, "set_parallelism"):
                    self._send(
                        501,
                        {"error": "batching disabled: no worker pool to scale"},
                    )
                    return
                try:
                    n = service.set_parallelism(int(q["workers"][0]))
                    self._send(200, {"status": "scaled", "workers": n})
                except Exception as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            # Set-default: PUT /v1/models/<name>/<version>/set-default
            prefix = f"/v1/models/{MODEL_NAME}/"
            if parsed.path.startswith(prefix) and parsed.path.endswith(
                "/set-default"
            ):
                version = parsed.path[len(prefix) : -len("/set-default")]
                try:
                    service.set_default_version(version)
                    self._send(200, {"status": "default", "version": version})
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                return
            self._send(404, {"error": f"unknown path {self.path}"})

        def do_DELETE(self):
            # Unregister: DELETE /v1/models/<name>/<version>
            prefix = f"/v1/models/{MODEL_NAME}/"
            if self.path.startswith(prefix):
                version = self.path[len(prefix) :]
                try:
                    service.unregister_version(version)
                    self._send(200, {"status": "unregistered", "version": version})
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                except ValueError as e:
                    self._send(409, {"error": str(e)})
                return
            self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path == f"/v1/models/{MODEL_NAME}:register":
                # Register a new model version from a checkpoint directory
                # (TorchServe POST /models analog).
                try:
                    body = self._read_json()
                    if not isinstance(body, dict) or "checkpoint_dir" not in body:
                        raise ValueError(
                            'body must be {"checkpoint_dir": ..., '
                            '["checkpoint_name"], ["version"], ["set_default"]}'
                        )
                    kwargs = {"checkpoint_dir": body["checkpoint_dir"]}
                    if "checkpoint_name" in body:
                        kwargs["checkpoint_name"] = body["checkpoint_name"]
                    if "version" in body:
                        kwargs["version"] = str(body["version"])
                    if "set_default" in body:
                        kwargs["set_default"] = bool(body["set_default"])
                    vid = service.register_version(**kwargs)
                    self._send(
                        200,
                        {
                            "status": "registered",
                            "version": vid,
                            "versions": service.list_versions(),
                        },
                    )
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except FileNotFoundError as e:
                    self._send(404, {"error": str(e)})
                except Exception as e:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path == f"/v1/models/{MODEL_NAME}:refresh":
                # Management-API analog: re-propagate cached embeddings from
                # the service's current parameters (e.g. after a checkpoint
                # reload swapped them in).
                try:
                    secs = service.refresh_from_checkpoint()
                    self._send(200, {"status": "refreshed", "seconds": round(secs, 3)})
                except Exception as e:
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if self.path != f"/v1/models/{MODEL_NAME}:predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"null")
                # Accept both a bare id list and {"instances": [...]}
                # (TorchServe KFServing-style envelope).
                if isinstance(payload, dict) and "instances" in payload:
                    payload = payload["instances"]
                if not isinstance(payload, list) or not payload:
                    raise ValueError("body must be a non-empty JSON list of user ids")
                items = service.recommend(payload)
                self._send(200, {"items": [list(map(int, row)) for row in items]})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return _HTTPServer((host, port), Handler)


def serve_forever(service: RecommenderService, host: str = "0.0.0.0", port: int = 8080):
    server = make_server(service, host, port)
    print(f"serving {MODEL_NAME} on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
