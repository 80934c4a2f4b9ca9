"""HTTP action server: raw camera frames and an instruction in, 7-dof
actions out, over any number of independent robot streams (the JAX
package's ``serving/server.py``).

The reference has no serving daemon: deploying it means re-running the
eval stack a host (eval_calvin.py:543-577).  Here one long-lived stdlib
HTTP server wraps one shared dynamic-exit engine
(``eval/scan_policy.ScanDeerPolicy``, or ``DiffusionSamplerPolicy`` around
it for a diffusion head): the weights are shared, and each stream's state
(carry, thresholds, rolling frame window, stage-reuse step counter) lives
in a per-stream view.

Protocol (JSON bodies; images are base64 raw bytes with their shape):

  GET  /healthz     -> {ok, exits, n_layers, head_type, quantize, streams,
                        steps, uptime_s}
  POST /v1/reset    {"stream": "arm0", "thresholds": [per-exit floats]?}
                    a new subtask; the optional per-stream thresholds let
                    clients with different compute budgets share the engine
  POST /v1/step     {"stream": "arm0", "instruction": "push the red block",
                     "rgb": <b64 u8>, "rgb_shape": [H, W, 3],
                     "gripper": <b64 u8>, "gripper_shape": [h, w, 3],
                     "robot_obs": [floats]?}   (state and tcp_rel models)
                    -> {"action": [7] | [[k x 7]], "exit_layer": int,
                        "step_ms": float}
  POST /v1/close    {"stream": "arm0"}

A client error answers 400, an engine or kernel error 500, with
{"error": ...}.  The frames are CALVIN observations as the rollout adapter
takes them (``eval/rollout.CalvinPolicyAdapter``): raw H x W x 3 uint8,
resized and normalized on the engine's device.  Requests are serialized
around the engine; ``serving/batcher.BatchedActionServer`` batches
concurrent streams instead.  Every engine call runs on the engine's
device under ``inference_mode`` (``engine_mode``: both are per thread in
torch, and the HTTP handler threads start in grad mode).
"""

from __future__ import annotations

import base64
import contextlib
import copy
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np
import torch

from deer_vla_tpu_torch.eval.rollout import CalvinPolicyAdapter, state_row


class ServeError(ValueError):
    """A client error: HTTP 400 with a JSON body."""


@contextlib.contextmanager
def engine_mode(device: torch.device):
    """``inference_mode`` on the engine's CUDA device, for the thread that
    enters it."""
    with torch.inference_mode():
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield


def _decode_image(payload: dict, key: str) -> np.ndarray:
    if key not in payload:
        raise ServeError(f"missing field {key!r}")
    shape = payload.get(key + "_shape")
    if not (isinstance(shape, list) and len(shape) == 3
            and all(isinstance(s, int) and s > 0 for s in shape)
            and shape[2] == 3):
        raise ServeError(f"{key}_shape must be [H, W, 3] positive "
                         f"integers, got {shape!r}")
    try:
        raw = base64.b64decode(payload[key])
    except Exception as e:
        raise ServeError(f"{key}: invalid base64 ({e})")
    n = int(np.prod(shape))
    if len(raw) != n:
        raise ServeError(f"{key}: {len(raw)} bytes != prod({shape}) = {n}")
    # a writable copy: torch warns on (and must not write to) the buffer
    return np.frombuffer(raw, np.uint8).reshape(shape).copy()


def request_robot_obs(payload: dict, cfg, required: bool = False,
                      tcp_rel: bool = False) -> Optional[np.ndarray]:
    """The request's ``robot_obs`` as fp32, None when absent (ServeError if
    ``required``).  For a state model its training-layout row
    (``eval/rollout.state_row``: arm pose and gripper with ``clip_state``)
    must have ``cfg.state_dim`` values and a gripper state the head can
    look up; for ``tcp_rel`` it must hold the tcp pose at [3:6]."""
    ro = payload.get("robot_obs")
    if ro is None:
        if required:
            raise ServeError("this model was trained with proprio state; "
                             "send 'robot_obs': [floats]")
        return None
    try:
        ro = np.asarray(ro, np.float32).reshape(-1)
    except (TypeError, ValueError):
        raise ServeError("'robot_obs' must be a list of numbers")
    if cfg.use_state or cfg.head.use_state:
        try:
            row = state_row({"robot_obs": ro}, cfg)
        except ValueError as e:
            raise ServeError(str(e))
        if row.shape[0] != cfg.state_dim:
            raise ServeError(f"'robot_obs' must have {cfg.state_dim} values "
                             "(after clip_state)")
    if tcp_rel and ro.shape[0] < 6:
        raise ServeError("'robot_obs' must hold the tcp pose at [3:6]")
    return ro


def engine_of(policy):
    """The object that holds ``set_thresholds`` / ``exits`` under wrapper
    policies (``DiffusionSamplerPolicy``), which delegate the step only."""
    p = policy
    while not hasattr(p, "set_thresholds") and hasattr(p, "policy"):
        p = p.policy
    return p


def check_thresholds(th, exits) -> list:
    """A /v1/reset threshold override: one number an exit."""
    if (not isinstance(th, list) or len(th) != len(exits)
            or not all(isinstance(t, (int, float))
                       and not isinstance(t, bool) for t in th)):
        raise ServeError(f"'thresholds' must be {len(exits)} numbers "
                         f"(exits {list(map(int, exits))})")
    return [float(t) for t in th]


class DeerActionServer:
    """The stream registry and request execution around one shared engine.

    ``base_policy`` has ScanDeerPolicy's state contract (carry, cur_step,
    last_exit_layer, thresholds as plain attributes; weights shared).
    Each stream gets a shallow copy (``_clone_policy``): an ``nn.Module``'s
    copy shares its buffer and module dicts, so the weights are shared,
    and ``reset`` / ``set_thresholds`` rebind the per-stream attributes on
    the copy only."""

    def __init__(self, base_policy, text_fn: Callable, max_streams: int = 64,
                 tcp_rel: bool = False):
        self._base = base_policy
        self._engine = engine_of(base_policy)
        self.cfg = base_policy.cfg
        self.device = self._engine.device
        self._text_fn = text_fn
        self._tcp_rel = tcp_rel
        self.max_streams = max_streams
        self._streams: Dict[str, object] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.total_steps = 0
        self.started = time.time()

    # -- stream management --------------------------------------------------

    @staticmethod
    def _clone_policy(p):
        """A per-stream view: a shallow copy shares the weights; a wrapper
        policy (``DiffusionSamplerPolicy``) also gets a copy of its inner
        policy, so that no two streams share a carry.  ``reset`` rebinds
        the per-stream state."""
        q = copy.copy(p)
        if hasattr(p, "policy"):
            q.policy = DeerActionServer._clone_policy(p.policy)
        q.reset()
        return q

    def _get(self, name: str):
        if not isinstance(name, str) or not name:
            raise ServeError("'stream' must be a non-empty string")
        ad = self._streams.get(name)
        if ad is None:
            if len(self._streams) >= self.max_streams:
                raise ServeError(
                    f"stream limit {self.max_streams} reached; close one")
            ad = CalvinPolicyAdapter(self._clone_policy(self._base),
                                     self._text_fn,
                                     text_len=self.cfg.text_len,
                                     tcp_rel=self._tcp_rel)
            self._counts[name] = 0
            self._streams[name] = ad
        return ad

    # -- endpoints ----------------------------------------------------------

    def healthz(self) -> dict:
        with self._lock:  # the POST threads change the stream dict
            streams = sorted(self._streams)
            steps = self.total_steps
        return {
            "ok": True,
            "exits": [int(e) for e in self._engine.exits],
            "n_layers": self.cfg.n_layers,
            "head_type": self.cfg.head_type,
            "quantize": getattr(self._engine, "quantize", None),
            "streams": streams,
            "steps": steps,
            "uptime_s": time.time() - self.started,
        }

    def reset(self, payload: dict) -> dict:
        with self._lock:
            name = payload.get("stream", "")
            ad = self._get(name)
            th = payload.get("thresholds")
            eng = engine_of(ad.policy)
            if th is not None:
                th = check_thresholds(th, eng.exits)
            with engine_mode(self.device):
                ad.reset()
                if th is not None:
                    # each stream's view holds its own threshold row
                    eng.set_thresholds(th)
            self._counts[name] = 0
        return {"ok": True}

    def close(self, payload: dict) -> dict:
        with self._lock:
            gone = self._streams.pop(payload.get("stream", ""), None)
            self._counts.pop(payload.get("stream", ""), None)
        return {"ok": True, "existed": gone is not None}

    def step(self, payload: dict) -> dict:
        instruction = payload.get("instruction")
        if not isinstance(instruction, str) or not instruction.strip():
            raise ServeError("'instruction' must be a non-empty string")
        rgb = _decode_image(payload, "rgb")
        grip = _decode_image(payload, "gripper")
        obs = {"rgb_obs": {"rgb_static": rgb, "rgb_gripper": grip}}
        ro = request_robot_obs(payload, self.cfg, tcp_rel=self._tcp_rel)
        if ro is not None:
            obs["robot_obs"] = ro
        with self._lock:
            name = payload.get("stream", "")
            ad = self._get(name)
            # stage reuse (steps_per_stage) keys off the stream's step
            # count, which the rollout loop sets a step (eval_utils.py:663)
            ad.policy.set_timestep(self._counts[name])
            t0 = time.perf_counter()
            with engine_mode(self.device):
                action = ad.step(obs, instruction)
            dt = time.perf_counter() - t0
            self._counts[name] += 1
            self.total_steps += 1
            exit_layer = ad.current_exit_layer
        return {"action": np.asarray(action, np.float32).tolist(),
                "exit_layer": int(exit_layer),
                "step_ms": 1000 * dt}


_ROUTES = {
    "/v1/reset": "reset",
    "/v1/step": "step",
    "/v1/close": "close",
}


def make_server(core, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer bound to ``core`` (``DeerActionServer`` or
    ``serving/batcher.BatchedActionServer``); port 0 picks a free port
    (``server.server_address[1]`` tells which)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._send(200, core.healthz())
            return self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            name = _ROUTES.get(self.path)
            if name is None:
                return self._send(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:
                    raise ServeError(f"body is not JSON ({e})")
                if not isinstance(payload, dict):
                    raise ServeError("body must be a JSON object")
                return self._send(200, getattr(core, name)(payload))
            except ServeError as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:  # an engine or kernel error: keep serving
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
