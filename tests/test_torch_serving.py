"""PyTorch port, the per-stream HTTP action server (``serving/server.py``)
and ``cli/serve``, on the CPU at deer_tiny width.

The port's server and the JAX package's answer the same HTTP requests on
the same bridged weights (the cross-attention gates drawn non-zero, so
that the frames reach the actions): equal ``exit_layer`` and actions
within 2e-4, the tolerance tests/test_torch_scan_policy.py holds the
engines to.  Within the port, a served stream is bit-equal to a local
``CalvinPolicyAdapter`` on its own view of the engine, and streams served
from concurrent client threads are bit-equal to the same streams served
alone.  Also: the protocol's 400 / 404 / 500 answers, per-stream threshold
overrides, diffusion streams, ``cli/serve``'s threshold sources and
refusals, and "no CUDA device" without ``device=``.
"""

import base64
import copy
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxPolicy
from deer_vla_tpu.serving.server import DeerActionServer as JaxServer
from deer_vla_tpu.serving.server import make_server as jax_make_server
from deer_vla_tpu_torch.cli import serve as serve_cli
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval.rollout import CalvinPolicyAdapter
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.serving.server import (DeerActionServer, ServeError,
                                               make_server)
from test_torch_scan_policy import make_params

TOL = dict(rtol=2e-4, atol=2e-4)
INSTRUCTIONS = ("push the red block", "lift the cup", "open the drawer",
                "turn on the led")


def tiny_configs():
    """deer_tiny in both packages, the media token the tokenizer's."""
    tok = HashTokenizer(vocab_size=tconfig.deer_tiny().mpt.vocab_size,
                        max_length=tconfig.deer_tiny().text_len)
    return (dataclasses.replace(jconfig.deer_tiny(),
                                media_token_id=tok.media_token_id),
            dataclasses.replace(tconfig.deer_tiny(),
                                media_token_id=tok.media_token_id), tok)


def start(core, factory=make_server):
    httpd = factory(core, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def post(base, path, payload, expect=200):
    body = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            assert r.status == expect
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect, (e.code, e.read())
        return json.loads(e.read())


def frame(seed, hw=(64, 48)):
    return np.random.RandomState(seed).randint(0, 255, hw + (3,), np.uint8)


def payload(stream, seed, instruction=INSTRUCTIONS[0], robot_obs=None):
    rgb, grip = frame(seed), frame(seed + 1000, (40, 40))
    out = {"stream": stream, "instruction": instruction,
           "rgb": base64.b64encode(rgb.tobytes()).decode(),
           "rgb_shape": list(rgb.shape),
           "gripper": base64.b64encode(grip.tobytes()).decode(),
           "gripper_shape": list(grip.shape)}
    if robot_obs is not None:
        out["robot_obs"] = [float(x) for x in robot_obs]
    return out


def observation(p):
    obs = {"rgb_obs": {
        "rgb_static": np.frombuffer(base64.b64decode(p["rgb"]), np.uint8
                                    ).reshape(p["rgb_shape"]).copy(),
        "rgb_gripper": np.frombuffer(base64.b64decode(p["gripper"]),
                                     np.uint8
                                     ).reshape(p["gripper_shape"]).copy()}}
    if "robot_obs" in p:
        obs["robot_obs"] = np.asarray(p["robot_obs"], np.float32)
    return obs


@pytest.fixture(scope="module")
def servers():
    """The JAX and the port server around engines on the same weights."""
    jcfg, tcfg, tok = tiny_configs()
    params = make_params(jcfg)
    jpol = JaxPolicy(jax.tree.map(jnp.asarray, params), jcfg,
                     thresholds=[1e8, 1e8])
    tpol = ScanDeerPolicy(params, tcfg, thresholds=[1e8, 1e8], device="cpu")
    jtok = JaxTokenizer(vocab_size=jcfg.mpt.vocab_size,
                        max_length=jcfg.text_len)
    jcore = JaxServer(jpol, jtok, max_streams=8)
    tcore = DeerActionServer(tpol, tok, max_streams=8)
    jhttpd, jbase = start(jcore, jax_make_server)
    thttpd, tbase = start(tcore)
    yield {"jcfg": jcfg, "tcfg": tcfg, "tok": tok, "params": params,
           "tpol": tpol, "tcore": tcore, "jbase": jbase, "tbase": tbase}
    for h in (jhttpd, thttpd):
        h.shutdown()
        h.server_close()


def close_all(base, core):
    for name in list(core._streams):
        post(base, "/v1/close", {"stream": name})


@pytest.mark.parametrize("thresholds", [[1e8, 1e8], [-1.0, 1e8],
                                        [3e-2, 1e8]])
def test_served_steps_match_jax(servers, thresholds):
    """Three steps of a stream with a threshold override, the same
    requests to both servers: equal exits, actions within 2e-4."""
    s = servers
    close_all(s["tbase"], s["tcore"])
    for base in (s["jbase"], s["tbase"]):
        post(base, "/v1/reset", {"stream": "arm", "thresholds": thresholds})
    exits = set()
    for t in range(3):
        p = payload("arm", 10 + t, INSTRUCTIONS[t % 2])
        want = post(s["jbase"], "/v1/step", p)
        got = post(s["tbase"], "/v1/step", p)
        assert got["exit_layer"] == want["exit_layer"]
        assert len(got["action"]) == 7 and got["action"][6] in (-1.0, 1.0)
        np.testing.assert_allclose(got["action"], want["action"], **TOL)
        assert got["step_ms"] > 0
        exits.add(got["exit_layer"])
    if thresholds[0] == -1.0:
        assert exits == {3}


def test_served_stream_equals_local_adapter(servers):
    """What crosses HTTP is bit-equal to a local adapter around a copy of
    the same engine, the carry threaded through the steps."""
    s = servers
    local = CalvinPolicyAdapter(DeerActionServer._clone_policy(s["tpol"]),
                                s["tok"], text_len=s["tcfg"].text_len)
    post(s["tbase"], "/v1/reset", {"stream": "parity"})
    for t in range(3):
        p = payload("parity", 100 + t)
        out = post(s["tbase"], "/v1/step", p)
        with torch.inference_mode():
            want = local.step(observation(p), p["instruction"])
        assert out["action"] == want.tolist()
        assert out["exit_layer"] == local.current_exit_layer


def test_streams_are_isolated_under_concurrency(servers):
    """Four client threads, a stream each with its own instruction and
    threshold row, step at once; each stream equals the same requests
    served alone on a fresh stream.  The per-stream views share the
    engine's weights and nothing else."""
    s = servers
    close_all(s["tbase"], s["tcore"])
    rows = [[1e8, 1e8], [-1.0, 1e8], [3e-2, 1e8], [1e8, 1e8]]

    def run(name, i, out):
        post(s["tbase"], "/v1/reset", {"stream": name, "thresholds": rows[i]})
        out[name] = [post(s["tbase"], "/v1/step",
                          payload(name, 200 + 10 * i + t, INSTRUCTIONS[i]))
                     for t in range(3)]

    together = {}
    threads = [threading.Thread(target=run, args=(f"c{i}", i, together))
               for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    streams = s["tcore"]._streams
    views = [streams[f"c{i}"].policy for i in range(4)]
    assert all(v._buffers is s["tpol"]._buffers for v in views)
    assert len({id(v.carry[0]) for v in views}) == 4
    assert "carry" not in s["tpol"]._buffers
    close_all(s["tbase"], s["tcore"])
    for i in range(4):
        alone = {}
        run(f"c{i}", i, alone)
        for got, want in zip(together[f"c{i}"], alone[f"c{i}"]):
            assert got["action"] == want["action"]
            assert got["exit_layer"] == want["exit_layer"]
    assert not np.allclose(together["c0"][0]["action"],
                           together["c1"][0]["action"])


def test_threshold_override_per_stream(servers):
    """/v1/reset thresholds: a fast and a slow stream on one engine exit
    at the first and the last exit, as in JAX; a malformed override is a
    400."""
    s = servers
    close_all(s["tbase"], s["tcore"])
    for base in (s["jbase"], s["tbase"]):
        post(base, "/v1/reset", {"stream": "fast", "thresholds": [1e8, 1e8]})
        post(base, "/v1/reset", {"stream": "slow",
                                 "thresholds": [-1e8, 1e8]})
    for name, exit_layer in (("fast", 1), ("slow", 3)):
        got = post(s["tbase"], "/v1/step", payload(name, 50))
        want = post(s["jbase"], "/v1/step", payload(name, 50))
        assert got["exit_layer"] == want["exit_layer"] == exit_layer
    for bad in ([1.0], "x", [1.0, "y"], [True, 1.0]):
        out = post(s["tbase"], "/v1/reset",
                   {"stream": "fast", "thresholds": bad}, expect=400)
        assert "thresholds" in out["error"]


def test_protocol_errors(servers):
    s = servers
    base, core = s["tbase"], s["tcore"]
    close_all(base, core)
    out = post(base, "/v1/step", {"stream": "x"}, expect=400)
    assert "instruction" in out["error"]
    bad = payload("x", 0)
    bad["rgb_shape"] = [2, 2, 3]
    assert "bytes" in post(base, "/v1/step", bad, expect=400)["error"]
    bad = payload("x", 0)
    bad["gripper_shape"] = [40, 40]
    assert "gripper_shape" in post(base, "/v1/step", bad,
                                   expect=400)["error"]
    bad = payload("x", 0)
    bad["rgb"] = "abc"  # not a whole base64 quantum
    assert "base64" in post(base, "/v1/step", bad, expect=400)["error"]
    assert "stream" in post(base, "/v1/step", payload("", 0),
                            expect=400)["error"]
    assert "JSON" in post(base, "/v1/step", b"{not json",
                          expect=400)["error"]
    assert "object" in post(base, "/v1/step", b"[1, 2]",
                            expect=400)["error"]
    assert "no route" in post(base, "/v1/nope", {}, expect=404)["error"]
    with urllib.request.urlopen(base + "/healthz") as r:
        h = json.loads(r.read())
    assert h["ok"] and h["exits"] == [1, 3] and h["quantize"] is None
    for i in range(core.max_streams):
        post(base, "/v1/reset", {"stream": f"fill{i}"})
    assert "limit" in post(base, "/v1/step", payload("over", 0),
                           expect=400)["error"]
    assert post(base, "/v1/close", {"stream": "fill0"})["existed"]
    assert not post(base, "/v1/close", {"stream": "fill0"})["existed"]
    assert len(post(base, "/v1/step", payload("over", 0))["action"]) == 7
    close_all(base, core)


def test_engine_error_answers_500_and_server_keeps_serving(servers,
                                                           monkeypatch):
    """An engine or kernel error is no client error: 500, and the next
    request is served.  Nothing falls back to another path."""
    s = servers
    close_all(s["tbase"], s["tcore"])

    def boom(*a, **k):
        raise RuntimeError("flash_attention: launch failed")

    monkeypatch.setattr(ScanDeerPolicy, "step", boom)
    out = post(s["tbase"], "/v1/step", payload("e", 0), expect=500)
    assert out["error"] == "RuntimeError: flash_attention: launch failed"
    monkeypatch.undo()
    assert len(post(s["tbase"], "/v1/step", payload("e", 1))["action"]) == 7


def test_state_stream_checks_the_gripper_state():
    """A state model's robot_obs: an in-range wrap is served as JAX
    computes it, a gripper state the head cannot look up is a 400, not a
    NaN action."""
    from test_torch_fusion import open_gates
    from deer_vla_tpu.models.flamingo import init_deer as jax_init
    jcfg, tcfg, tok = tiny_configs()
    jcfg = dataclasses.replace(jcfg, use_state=True, head=dataclasses.replace(
        jcfg.head, use_state=True))
    tcfg = dataclasses.replace(tcfg, use_state=True, head=dataclasses.replace(
        tcfg.head, use_state=True))
    params = open_gates(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(3), jcfg)))
    jcore = JaxServer(JaxPolicy(jax.tree.map(jnp.asarray, params), jcfg,
                                thresholds=[1e8, 1e8]),
                      JaxTokenizer(vocab_size=jcfg.mpt.vocab_size,
                                   max_length=jcfg.text_len))
    tcore = DeerActionServer(ScanDeerPolicy(params, tcfg,
                                            thresholds=[1e8, 1e8],
                                            device="cpu"), tok)
    ro = np.random.RandomState(4).uniform(-1, 1, 15)
    for g in (1.0, -1.0, -3.5, -5.0):  # rows 1, 0, 1 (wrapped), 0 (wrapped)
        ro[-1] = g
        p = payload(f"g{g}", 7, robot_obs=ro)
        got, want = tcore.step(p), jcore.step(p)
        assert got["exit_layer"] == want["exit_layer"]
        np.testing.assert_allclose(got["action"], want["action"], **TOL)
    httpd, base = start(tcore)
    try:
        for g in (3.0, -7.0, float("nan")):
            ro[-1] = g
            out = post(base, "/v1/step", payload("bad", 8, robot_obs=ro),
                       expect=400)
            assert "gripper state" in out["error"]
        out = post(base, "/v1/step", payload("bad", 8, robot_obs=ro[:5]),
                   expect=400)
        assert "15 values" in out["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_diffusion_streams_are_isolated():
    """Diffusion serving: each stream's sampler and engine are copies (no
    carry or history aliasing, the weights shared); clients get (k, 7)
    plans; a stream replayed on a fresh stream gives the same plan; the
    exits are JAX's."""
    from deer_vla_tpu.eval.diffusion_policy import \
        DiffusionSamplerPolicy as JaxSampler
    from deer_vla_tpu_torch.eval.diffusion_policy import \
        DiffusionSamplerPolicy
    from test_torch_diffusion import DIFF, diff_params
    from test_torch_heads import configs
    jcfg, tcfg = configs(DIFF)
    _, _, tok = tiny_configs()
    jcfg = dataclasses.replace(jcfg, media_token_id=tok.media_token_id)
    tcfg = dataclasses.replace(tcfg, media_token_id=tok.media_token_id)
    p = diff_params(jcfg)
    scan = ScanDeerPolicy(p, tcfg, thresholds=[0.1, 1e8], device="cpu")
    base = DiffusionSamplerPolicy(scan, p, seed=0, sample_steps=3)
    core = DeerActionServer(base, tok, max_streams=4)
    jcore = JaxServer(JaxSampler(
        JaxPolicy(jax.tree.map(jnp.asarray, p), jcfg, thresholds=[0.1, 1e8]),
        jax.tree.map(jnp.asarray, p), seed=0, sample_steps=3),
        JaxTokenizer(vocab_size=jcfg.mpt.vocab_size,
                     max_length=jcfg.text_len))
    outs = {}
    for name, seed in (("s1", 1), ("s2", 2)):
        outs[name] = [core.step(payload(name, seed + t, INSTRUCTIONS[seed]))
                      for t in range(2)]
        want = [jcore.step(payload(name, seed + t, INSTRUCTIONS[seed]))
                for t in range(2)]
        assert ([o["exit_layer"] for o in outs[name]]
                == [w["exit_layer"] for w in want])
    plan = np.asarray(outs["s1"][0]["action"])
    k = tcfg.diff_horizon - (tcfg.n_obs_steps - 1)
    assert plan.shape == (k, 7) and np.isfinite(plan).all()
    assert set(plan[:, 6]) <= {-1.0, 1.0}
    ads = core._streams
    assert ads["s1"].policy is not ads["s2"].policy
    assert ads["s1"].policy.policy is not ads["s2"].policy.policy
    assert ads["s1"].policy.policy is not scan
    assert ads["s1"].policy.policy._buffers is scan._buffers
    assert scan.carry is None  # the base engine never stepped
    again = core.step(payload("s1b", 1, INSTRUCTIONS[1]))
    assert again["action"] == outs["s1"][0]["action"]
    h = core.healthz()
    assert h["exits"] == [1, 3] and h["head_type"] == "diffusion"


# ---------------------------------------------------------------------------
# cli/serve
# ---------------------------------------------------------------------------


def args_of(*flags):
    return serve_cli.build_parser().parse_args(["--model", "tiny", *flags])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A full deer_tiny checkpoint with its config sidecar."""
    from deer_vla_tpu_torch.models.flamingo import init_deer
    from deer_vla_tpu_torch.train.checkpoint import save_checkpoint
    cfg = tconfig.deer_tiny()
    stem = str(tmp_path_factory.mktemp("serve_run") / "deer_0")
    save_checkpoint(stem, init_deer(cfg, seed=5, device="cpu"), cfg,
                    meta={"seed": 5})
    return stem + ".ckpt"


@pytest.mark.parametrize("source", ["flag", "sidecar", "full_depth"])
def test_serve_threshold_sources_match_jax(tmp_path, source, capsys):
    """--thresholds, then the checkpoint's values sidecar solved at
    --exit_ratio, then full depth: each resolves as JAX's cli/serve does."""
    from deer_vla_tpu.cli.serve import _resolve_thresholds as jax_resolve
    from deer_vla_tpu_torch.train.checkpoint import save_calibration_values
    ckpt = str(tmp_path / "m.ckpt")
    flags = ["--evaluate_from_checkpoint", ckpt, "--exit_ratio", "0.6"]
    if source == "flag":
        flags += ["--thresholds", "0.25", "1e8"]
    if source == "sidecar":
        values = np.random.RandomState(5).uniform(0, 1, (2, 40))
        save_calibration_values(ckpt, values)
    args = args_of(*flags)
    pol = type("P", (), {"exits": [1, 3]})()
    got = serve_cli.resolve_thresholds(args, pol)
    want = jax_resolve(args, pol)
    if isinstance(want, dict):
        want = [want[e] for e in pol.exits]
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    if source == "full_depth":
        assert "FULL DEPTH" in capsys.readouterr().out


def test_build_core_serves_a_checkpoint_with_its_sidecar(checkpoint, capsys):
    """build_core on a trained checkpoint: the sidecar's thresholds reach
    the engine, and a step is served."""
    from deer_vla_tpu_torch.train.checkpoint import save_calibration_values
    save_calibration_values(checkpoint, np.linspace(0, 1, 80).reshape(2, 40))
    core, cfg = serve_cli.build_core(args_of(
        "--evaluate_from_checkpoint", checkpoint, "--exit_ratio", "0.5"),
        "cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    th = core._base.thresholds.numpy()
    assert th[1] == np.float32(printed["thresholds"]["1"])
    assert th[3] == np.float32(1e30)
    assert len(core.step(payload("a", 0))["action"]) == 7


@pytest.mark.parametrize("flags,item", [
    (["--artifact", "m.step"], "M14b"), (["--bundle", "m.step"], "M14b"),
    (["--tokenizer_path", "tok"], "M9")])
def test_serve_unserved_flags_name_the_roadmap_item(flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md {item} "):
        serve_cli.main(["--model", "tiny", "--oneshot_healthz", *flags],
                       device="cpu")


def test_serve_main_oneshot_healthz(capsys):
    assert serve_cli.main(["--model", "tiny", "--port", "0",
                           "--thresholds", "0.1", "1e8",
                           "--oneshot_healthz"], device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["serving"].startswith("http://127.0.0.1:")
    assert lines[0]["device"] == "cpu"
    assert lines[1]["ok"] and lines[1]["exits"] == [1, 3]
    assert lines[1]["steps"] == 0


def test_serve_main_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--model", "tiny", "--oneshot_healthz"])


def test_serve_quantized_core_reports_its_mode():
    core, _ = serve_cli.build_core(args_of("--quantize", "int8",
                                           "--thresholds", "0.1", "1e8"),
                                   "cpu")
    assert core.healthz()["quantize"] == "int8"
    out = core.step(payload("q", 3))
    assert len(out["action"]) == 7 and np.isfinite(out["action"]).all()


def test_clone_shares_weights_not_state():
    """The per-stream view of an nn.Module engine: buffers shared, every
    per-stream attribute its own."""
    _, tcfg, _ = tiny_configs()
    jcfg = jconfig.deer_tiny()
    pol = ScanDeerPolicy(make_params(jcfg), tcfg, thresholds=[0.1, 1e8],
                         device="cpu")
    a = DeerActionServer._clone_policy(pol)
    b = copy.copy(a)
    b.set_thresholds([1e8, 1e8])
    assert a._buffers is pol._buffers and a._modules is pol._modules
    assert a.thresholds is not b.thresholds
    assert "thresholds" not in pol._buffers
    np.testing.assert_array_equal(pol.thresholds.numpy(), a.thresholds.numpy())
    with pytest.raises(ServeError):
        DeerActionServer(pol, None)._get("")
