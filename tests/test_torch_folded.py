"""PyTorch port, the window-folded variants ('vit_concat' and ``use_hist``)
against the JAX package on the CPU: the scan engine's step on the rolling
W-frame window (B=1, and B=2 streams with per-stream threshold rows),
``DeerPolicy``, the rolling frame cache (``FrameCachePolicy``) against the
uncached step, the windowed adapter's and the batched lanes' rollouts, the
engines' refusals, and ``cli/train`` then ``cli/eval`` with every variant
flag (the sidecar config carries the variant into serving).

Weights: the shared JAX init of tests/test_torch_fusion.py, bridged.
Exit layers must be equal; actions and carries within 2e-4
(tests/test_torch_scan_policy.py's); the rollout reports equal.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.cli import train as jtrain_cli
from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu.eval import batched_rollout as jbatched
from deer_vla_tpu.eval import rollout as jrollout
from deer_vla_tpu.eval import scan_policy as jscan
from deer_vla_tpu.eval.policy import DeerPolicy as JaxDeerPolicy
from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.cli import train as train_cli
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import batched_rollout as tbatched
from deer_vla_tpu_torch.eval import rollout as trollout
from deer_vla_tpu_torch.eval import scan_policy as tscan
from deer_vla_tpu_torch.eval.batched_policy import BatchedDeerPolicy
from deer_vla_tpu_torch.eval.caching import FrameCachePolicy
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from test_torch_fusion import frames, jx, pair, text, variant_params
from test_torch_state import THRESHOLDS, controllers, same_carry

TOL = dict(rtol=2e-4, atol=2e-4)
FOLDED = {"vit_concat_state": {"fusion_mode": "vit_concat",
                               "use_state": True},
          "hist_state": {"use_hist": True, "use_state": True}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name):
    tok = HashTokenizer(vocab_size=128, max_length=8)
    return tuple(dataclasses.replace(c, media_token_id=tok.media_token_id)
                 for c in pair(FOLDED[name]))


@pytest.fixture(scope="module")
def folded():
    """{name: (jcfg, tcfg, params, JAX scan policy, port scan policy)}."""
    out = {}
    for name in FOLDED:
        jcfg, tcfg = configs(name)
        p = variant_params(jcfg)
        out[name] = (jcfg, tcfg, p,
                     jscan.ScanDeerPolicy(jax.tree.map(jnp.asarray, p), jcfg),
                     tscan.ScanDeerPolicy(p, tcfg, device="cpu"))
    return out


def window_obs(cfg, streams, seed):
    """``streams`` stream-major W-frame windows (frames and state rows) and
    their text: a row a stream, a row a frame under use_hist."""
    w = cfg.window_size
    img, grip, st = frames(cfg, streams * w, seed)
    ids, mask = text(cfg, streams, seed + 1, media_at=1)
    if cfg.use_hist:
        ids, mask = (np.repeat(a, w, axis=0) for a in (ids, mask))
    return img, grip, ids, mask, st


@pytest.mark.parametrize("name", list(FOLDED))
def test_folded_scan_step_matches_jax(folded, name):
    jcfg, _, _, jpol, tpol = folded[name]
    seen = set()
    for th in THRESHOLDS:
        for p in (jpol, tpol):
            p.set_thresholds(th)
            p.reset()
        for t in range(2):
            img, grip, ids, mask, st = window_obs(jcfg, 1, seed=t)
            a_j = jpol.step(*jx(img, grip, ids, mask), state=jnp.asarray(st))
            a_t = tpol.step(img, grip, ids, mask, state=st)
            assert tpol.last_exit_layer == jpol.last_exit_layer
            np.testing.assert_allclose(a_t, np.asarray(a_j), **TOL)
            same_carry(tpol.carry, jpol.carry)
            seen.add(tpol.last_exit_layer)
    assert seen == set(jcfg.all_exit_ids())


@pytest.mark.parametrize("name", list(FOLDED))
def test_folded_scan_step_batch_matches_jax(folded, name):
    """Four streams' windows, each with its own threshold row."""
    jcfg, _, _, jpol, tpol = folded[name]
    for p in (jpol, tpol):
        p.set_thresholds_batch(THRESHOLDS + [[1e-4, 1e8]])
        p.reset()
    for t in range(2):
        img, grip, ids, mask, st = window_obs(jcfg, 4, seed=10 + t)
        acts_j, ex_j = jpol.step_batch(*jx(img, grip, ids, mask),
                                       state=jnp.asarray(st))
        acts_t, ex_t = tpol.step_batch(img, grip, ids, mask, state=st)
        np.testing.assert_array_equal(ex_t, ex_j)
        np.testing.assert_array_equal(ex_t[:2], jcfg.all_exit_ids())
        np.testing.assert_allclose(acts_t, acts_j, **TOL)
        same_carry(tpol.carry, jpol.carry)
    with pytest.raises(ValueError, match="stream-major"):
        tpol.step_batch(img[:3], grip[:3], ids, mask, state=st[:3])


@pytest.mark.parametrize("name", list(FOLDED))
def test_frame_cache_matches_the_uncached_step(folded, name):
    """FrameCachePolicy encodes the newest frame a step and keeps the
    window's tokens; the uncached engine re-encodes the whole window (left
    padded with the first frame).  Exits equal, actions within 2e-4."""
    jcfg, tcfg, p, _, tpol = folded[name]
    w = jcfg.window_size
    cached = FrameCachePolicy(tscan.ScanDeerPolicy(p, tcfg, device="cpu"))
    img, grip, st = frames(jcfg, w + 2, seed=21)
    ids, mask = text(jcfg, 1, seed=22, media_at=1)
    if jcfg.use_hist:
        ids, mask = (np.repeat(a, w, axis=0) for a in (ids, mask))
    for pol in (cached, tpol):
        pol.set_thresholds([1e-3, 1e8])
        pol.reset()
    for t in range(w + 2):
        rows = [max(0, i) for i in range(t - w + 1, t + 1)]
        a_u = tpol.step(img[rows], grip[rows], ids, mask, state=st[rows])
        a_c = cached.step(img[t:t + 1], grip[t:t + 1], ids, mask,
                          state=st[rows])
        assert cached.last_exit_layer == tpol.last_exit_layer
        np.testing.assert_allclose(a_c, a_u, **TOL)
        same_carry(cached.carry, tpol.carry)
    with pytest.raises(ValueError, match="newest frame only"):
        cached.step(img[:2], grip[:2], ids, mask, state=st[rows])


def test_folded_deer_policy_matches_jax(folded):
    """The host-bucketed engine on the 'vit_concat' state model's windows."""
    jcfg, tcfg, p, _, _ = folded["vit_concat_state"]
    jc, tc = controllers(tcfg, THRESHOLDS[0])
    jpol = JaxDeerPolicy(jax.tree.map(jnp.asarray, p), jcfg, controller=jc)
    tpol = DeerPolicy(p, tcfg, controller=tc, device="cpu")
    for t, th in enumerate(THRESHOLDS * 2):
        jc.set_threshold_values(th)
        tc.set_threshold_values(th)
        img, grip, ids, mask, st = window_obs(jcfg, 1, seed=30 + t)
        a_j = jpol.step(*jx(img, grip, ids, mask), state=jnp.asarray(st))
        a_t = tpol.step(img, grip, ids, mask, state=st)
        assert tpol.last_exit_layer == jpol.last_exit_layer
        np.testing.assert_allclose(a_t, np.asarray(a_j), **TOL)
        same_carry(tpol.carry, jpol.carry)


def test_serving_refusals_match_jax():
    """Both window foldings at once, and the window-folded variants in the
    per-frame engines, are refused as in JAX."""
    for changes, folded_ok in (({"fusion_mode": "vit_concat"}, True),
                               ({"use_hist": True}, True),
                               ({"fusion_mode": "vit_concat",
                                 "use_hist": True}, False)):
        jcfg, tcfg = pair(changes)
        for allow in (False, True):
            refused = []
            for check, cfg in ((jscan.check_serving_supported, jcfg),
                               (tscan.check_serving_supported, tcfg)):
                try:
                    check(cfg, allow_window_folded=allow)
                    refused.append(None)
                except NotImplementedError as err:
                    refused.append(str(err).split(";")[0])
            assert refused[0] is None or refused[1] is not None
            assert (refused[1] is None) == (allow and folded_ok)
    jcfg, tcfg = pair({"fusion_mode": "vit_concat"})
    with pytest.raises(NotImplementedError, match="vit_concat"):
        BatchedDeerPolicy(variant_params(jcfg), tcfg, batch=2, device="cpu")
    _, post = pair()
    with pytest.raises(ValueError, match="window-folded"):
        FrameCachePolicy(tscan.ScanDeerPolicy(
            variant_params(pair()[0]), post, device="cpu"))


# ---------------------------------------------------------------------------
# rollouts: the windowed adapter and the batched lanes
# ---------------------------------------------------------------------------

REPORT_KEYS = ("avg_seq_len", "success_exit_hist", "fail_exit_hist",
               "avg_exit_layer")


def rollout_pair(folded, name, lanes, cache=False):
    """(JAX report, port report) over the same DebugEnv sequences with the
    fixture's policies at thresholds [1e-3, 1e8]."""
    jcfg, tcfg, p, jpol, tpol = folded[name]
    tok_j = JaxTokenizer(vocab_size=128, max_length=8)
    tok_t = HashTokenizer(vocab_size=128, max_length=8)
    for pol in (jpol, tpol):
        pol.set_thresholds([1e-3, 1e8])
    seqs = jrollout.make_debug_sequences(2, seed=3)
    hw = jcfg.vit.image_size

    def env(mod):
        return mod.DebugEnv(img_hw=hw, grip_hw=hw)

    if lanes == 1:
        tp = (FrameCachePolicy(tscan.ScanDeerPolicy(p, tcfg, device="cpu"))
              if cache else tpol)
        for pol in (tp,):
            pol.set_thresholds([1e-3, 1e8])
        want = jrollout.evaluate_policy(
            jrollout.CalvinPolicyAdapter(jpol, tok_j, jcfg.text_len),
            env(jrollout), seqs, {}, jrollout.DebugTaskOracle(0.05),
            ep_len=6)
        got = trollout.evaluate_policy(
            trollout.CalvinPolicyAdapter(tp, tok_t, tcfg.text_len),
            env(trollout), seqs, {}, trollout.DebugTaskOracle(0.05),
            ep_len=6)
    else:
        want = jbatched.evaluate_policy_batched(
            jpol, [env(jrollout) for _ in range(lanes)], seqs, {},
            jrollout.DebugTaskOracle(0.05), tok_j, text_len=jcfg.text_len,
            ep_len=6)
        got = tbatched.evaluate_policy_batched(
            tpol, [env(trollout) for _ in range(lanes)], seqs, {},
            trollout.DebugTaskOracle(0.05), tok_t, text_len=tcfg.text_len,
            ep_len=6)
    return want, got


@pytest.mark.parametrize("name,lanes,cache", [
    ("vit_concat_state", 1, False), ("vit_concat_state", 1, True),
    ("hist_state", 2, False)])
def test_folded_rollouts_match_jax(folded, name, lanes, cache):
    """The windowed adapter (frame and state queues, the goal tiled a frame
    under use_hist), with and without the frame cache, and two batched
    lanes' stream-major windows: the reports JAX's."""
    want, got = rollout_pair(folded, name, lanes, cache)
    assert got["task_info"] == want["task_info"]
    assert sum(got["success_exit_hist"]) + sum(got["fail_exit_hist"]) > 0
    for key in REPORT_KEYS:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=0, atol=1e-9, err_msg=key)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

TRAIN = ["--debug", "--model", "tiny", "--num_joint_epochs", "1",
         "--num_exit_epochs", "0", "--batch_size_calvin", "2",
         "--precision", "fp32", "--joint_warmup_steps", "1"]
EVAL = ["--debug", "--precision", "fp32", "--num_sequences_override", "2",
        "--exit_ratio", "0.5", "--calib_batches", "1", "--ep_len", "8"]
# (train flags, eval flags on its checkpoint)
CLI_RUNS = {
    "vit_concat_state": (["--fusion_mode", "vit_concat", "--use_state",
                          "--clip_state"],
                         ["--frame_cache", "--calib_warm", "2"]),
    "hist": (["--use_hist"], ["--frame_cache"]),
    "pre_sep_k2": (["--fusion_mode", "pre", "--sep_resampler",
                    "--multi_step_action", "2"], ["--calib_streamed"]),
    "gripper_two_way": (["--gripper_res", "14", "--fusion_mode", "two_way"],
                        ["--lanes", "2"]),
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{name: checkpoint path} of cli/train runs with each CLI_RUNS flags."""
    out = {}
    for name, (flags, _) in CLI_RUNS.items():
        run = str(tmp_path_factory.mktemp(name))
        train_cli.main(TRAIN + flags + ["--run_name", run], device="cpu")
        out[name] = run + "/deer_0.ckpt"
    return out


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_train_then_eval_serves_each_variant(trained, name, capsys):
    """cli/train builds the config JAX's builds from the same flags, its
    sidecar carries the variant, and cli/eval calibrates and serves it from
    the checkpoint (the frame cache, --calib_warm, --calib_streamed,
    --lanes)."""
    flags, eval_flags = CLI_RUNS[name]
    want = jtrain_cli.make_model_config(
        jtrain_cli.build_parser().parse_args(TRAIN + flags))
    got = train_cli.make_model_config(
        train_cli.build_parser().parse_args(TRAIN + flags))
    assert got.to_json() == want.to_json()
    ckpt = trained[name]
    with open(ckpt[:-5] + ".json") as f:
        side = json.load(f)["config"]
    for key in ("fusion_mode", "use_hist", "use_state", "gripper_res",
                "sep_resampler", "clip_state", "state_dim"):
        assert side[key] == json.loads(want.to_json())[key], key
    assert side["head"]["multi_step_action"] == \
        want.head.multi_step_action
    report = eval_cli.main(EVAL + ["--evaluate_from_checkpoint", ckpt]
                           + eval_flags, device="cpu")
    out = capsys.readouterr().out
    assert np.isfinite(report["avg_seq_len"])
    assert report["env_steps"] > 0
    assert ("RECOMMENDED" in out) == (name == "gripper_two_way")


@pytest.mark.parametrize("case,flags,match", [
    ("gripper_two_way", ["--frame_cache"], "only applies to window-folded"),
    ("vit_concat_state", ["--frame_cache", "--lanes", "2"],
     "--lanes does not compose with --frame_cache"),
    ("vit_concat_state", ["--frame_cache", "--vision_cache_tau", "0.1"],
     "mutually exclusive"),
    ("vit_concat_state", ["--calib_streamed"], "needs a real time window"),
    ("hist", ["--frame_cache", "--multi_execution", "2"],
     "--frame_cache needs the scan engine"),
    ("hist", ["--gripper_res", "20"], "multiple of the ViT patch size"),
    ("vit_concat_state", ["--vision_cache_tau", "0.1"],
     "cannot serve state models")])
def test_cli_eval_refuses_what_jax_refuses(trained, case, flags, match):
    with pytest.raises(SystemExit, match=match):
        eval_cli.main(EVAL + ["--evaluate_from_checkpoint", trained[case]]
                      + flags, device="cpu")


def test_cli_train_refuses_what_jax_refuses():
    argv = TRAIN + ["--gripper_res", "20"]
    for cli in (jtrain_cli, train_cli):
        with pytest.raises(SystemExit, match="multiple of the ViT patch"):
            cli.make_model_config(cli.build_parser().parse_args(argv))
    for cli in (jtrain_cli, train_cli):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(TRAIN + ["--fusion_mode", "x"])
