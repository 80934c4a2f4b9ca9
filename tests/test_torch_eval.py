"""PyTorch port, the evaluation path: the copied host modules (tokenizer,
metrics, sequences, FLOPs), closed-loop rollouts through both packages'
ScanDeerPolicy on DebugEnv (sequential and 2 lanes), and the port's
``cli/eval`` on the CPU, also calibrating on a CALVIN-format directory
(the batches bit for bit, the values within 1e-4 relative L2 and the
thresholds within 1e-4 relative of JAX's, given JAX's layer draws).

The rollout parity runs bridged deer_tiny weights in fp32 with the same
thresholds: the per-chain results, the exit histograms and the per-task
table must be equal (exits are discrete; the actions behind them agree
within 2e-4, tests/test_torch_scan_policy.py).  The copied numpy modules
must agree bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.data import text as jtext
from deer_vla_tpu.cli import eval as jcli
from deer_vla_tpu.eval import batched_rollout as jbatched
from deer_vla_tpu.eval import calibrate as jcal
from deer_vla_tpu.eval import flops as jflops
from deer_vla_tpu.eval import metrics as jmetrics
from deer_vla_tpu.eval import rollout as jrollout
from deer_vla_tpu.eval import sequences as jseq
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxPolicy
from deer_vla_tpu.models.flamingo import init_deer as jinit
from deer_vla_tpu_torch.cli import eval as cli
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.data import text as ttext
from deer_vla_tpu_torch.data.debug_data import make_synthetic_calvin
from deer_vla_tpu_torch.eval import batched_rollout as tbatched
from deer_vla_tpu_torch.eval import calibrate as tcal
from deer_vla_tpu_torch.eval import flops as tflops
from deer_vla_tpu_torch.eval import metrics as tmetrics
from deer_vla_tpu_torch.eval import rollout as trollout
from deer_vla_tpu_torch.eval import sequences as tseq
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.models.value_net import solve_thresholds
from deer_vla_tpu_torch.train.checkpoint import load_calibration_values

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPORT_KEYS = ("avg_seq_len", "chain_sr", "success_exit_hist",
               "fail_exit_hist", "avg_exit_layer", "total_success_steps",
               "task_info")


# ---------------------------------------------------------------------------
# the copied host modules
# ---------------------------------------------------------------------------


def test_hash_tokenizer_and_fixed_length_match_jax():
    texts = ["open the drawer", "push the slider to the left now please",
             "  lift   it "]
    a, b = (m.HashTokenizer(vocab_size=128, max_length=8)
            for m in (jtext, ttext))
    for x, y in zip(a(texts), b(texts)):
        np.testing.assert_array_equal(x, y)
    ids, mask = b(texts)
    for length in (4, 12):
        for x, y in zip(jtext.fixed_length(ids, mask, length, 127),
                        ttext.fixed_length(ids, mask, length, 127)):
            np.testing.assert_array_equal(x, y)
    assert (b.media_token_id, b.eoc_token_id, b.pad_token_id) == (126, 125,
                                                                  127)
    with pytest.raises(NotImplementedError):
        ttext.HFTokenizer("some/path")


def test_metrics_match_jax():
    seqs = jrollout.make_debug_sequences(6, seed=1)
    args = ([5, 2, 0, 3, 1, 4], [1, 3, 3, 1, 5], [3, 5, 1], [4, 2, 7],
            [0.01, 0.02], seqs, 6)
    for fpl in (None, 2.5e9):
        want = jmetrics.summarize(*args, flops_per_layer=fpl)
        got = tmetrics.summarize(*args, flops_per_layer=fpl)
        assert got == want
        assert tmetrics.format_report(got) == jmetrics.format_report(want)
    assert tmetrics.count_success([]) == jmetrics.count_success([])


def test_sequences_match_jax():
    tasks = ["a_b", "c", "d_e_f"]
    assert (tseq.generate_sequences(tasks, n=7, seed=3)
            == jseq.generate_sequences(tasks, n=7, seed=3))
    assert (trollout.make_debug_sequences(5, seed=2)
            == jrollout.make_debug_sequences(5, seed=2))


@pytest.mark.parametrize("variant", ["deer_3b", "tiny", "tome", "gripper"])
def test_flops_match_jax(variant):
    def make(mod):
        cfg = mod.deer_3b() if variant != "tiny" else mod.deer_tiny()
        if variant == "tome":
            cfg = dataclasses.replace(
                cfg, vit=dataclasses.replace(cfg.vit, tome_r=8))
        if variant == "gripper":
            cfg = dataclasses.replace(cfg, gripper_res=84)
        return cfg

    jc, tc = make(jconfig), make(tconfig)
    assert tflops.llm_flops_per_exit(tc) == jflops.llm_flops_per_exit(jc)
    for fn in ("vision_flops", "head_flops", "train_step_flops"):
        assert getattr(tflops, fn)(tc) == getattr(jflops, fn)(jc)
    for e in (0, tc.n_layers - 1):
        assert tflops.full_step_flops(tc, e) == jflops.full_step_flops(jc, e)
        assert (tflops.paper_convention_gflops(tc, e)
                == jflops.paper_convention_gflops(jc, e))
    hist = np.linspace(0, 1, tc.n_layers)
    assert tflops.avg_llm_gflops(tc, hist) == jflops.avg_llm_gflops(jc, hist)


# ---------------------------------------------------------------------------
# rollouts through both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """Bridged deer_tiny weights (x-attn gates open) and the two packages'
    policies, thresholds set where these weights' first-exit deltas on
    DebugEnv frames straddle it (both exits taken)."""
    tok = ttext.HashTokenizer(vocab_size=128, max_length=8)
    jcfg, tcfg = (dataclasses.replace(c, media_token_id=tok.media_token_id)
                  for c in (jconfig.deer_tiny(), tconfig.deer_tiny()))
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(1), jcfg))
    r = np.random.RandomState(2)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    jpol = JaxPolicy(jax.tree.map(jnp.asarray, params), jcfg)
    tpol = ScanDeerPolicy(params, tcfg, indexed_mm=True, device="cpu")
    for p in (jpol, tpol):
        p.set_thresholds({1: 1.5e-4, 3: 1e8})
    return tok, jcfg, tcfg, jpol, tpol


def envs(mod, n):
    # frames at 40 / 20 px: both cameras go through the cubic resize to 28
    return [mod.DebugEnv(img_hw=40, grip_hw=20) for _ in range(n)]


def assert_same_report(got, want):
    for k in REPORT_KEYS:
        assert got[k] == want[k], k
    exits = [e for h in ("success_exit_hist", "fail_exit_hist")
             for e, p in enumerate(got[h]) if p > 0]
    assert len(set(exits)) > 1, f"one exit layer only: {exits}"


def test_evaluate_policy_matches_jax(served):
    tok, jcfg, tcfg, jpol, tpol = served
    seqs = jrollout.make_debug_sequences(2, seed=3)
    kw = dict(num_sequences=2, ep_len=8, n_layers=tcfg.n_layers)
    want = jrollout.evaluate_policy(
        jrollout.CalvinPolicyAdapter(jpol, tok, text_len=jcfg.text_len),
        envs(jrollout, 1)[0], seqs, {}, jrollout.DebugTaskOracle(0.6), **kw)
    got = trollout.evaluate_policy(
        trollout.CalvinPolicyAdapter(tpol, tok, text_len=tcfg.text_len),
        envs(trollout, 1)[0], seqs, {}, trollout.DebugTaskOracle(0.6), **kw)
    assert_same_report(got, want)


def test_evaluate_policy_batched_matches_jax(served):
    tok, jcfg, tcfg, jpol, tpol = served
    seqs = jrollout.make_debug_sequences(3, seed=4)
    kw = dict(text_len=tcfg.text_len, ep_len=8, n_layers=tcfg.n_layers)
    want = jbatched.evaluate_policy_batched(
        jpol, envs(jrollout, 2), seqs, {}, jrollout.DebugTaskOracle(0.6),
        tok, **kw)
    got = tbatched.evaluate_policy_batched(
        tpol, envs(trollout, 2), seqs, {}, trollout.DebugTaskOracle(0.6),
        tok, **kw)
    assert_same_report(got, want)
    assert got["batched_exit_waste"] == want["batched_exit_waste"]


def test_evaluate_policy_checks_world_size(served):
    tok, _, tcfg, _, tpol = served
    adapter = trollout.CalvinPolicyAdapter(tpol, tok, text_len=tcfg.text_len)
    with pytest.raises(ValueError, match="world_size=2"):
        trollout.evaluate_policy(adapter, envs(trollout, 1)[0],
                                 trollout.make_debug_sequences(2), {},
                                 trollout.DebugTaskOracle(), world_size=2)


def test_debug_env_matches_jax_and_counts_steps():
    a, b = jrollout.DebugEnv(img_hw=8, grip_hw=6), trollout.DebugEnv(
        img_hw=8, grip_hw=6)
    for env in (a, b):
        env.reset(robot_obs=np.arange(3.0))
    act = np.array([0.5, -0.2, 0.1, 0.3, 0.0, 0.9, 1.0], np.float32)
    for _ in range(3):
        oa, _, _, ia = a.step(act)
        ob, _, _, ib = b.step(act)
    for k in ("rgb_static", "rgb_gripper"):
        np.testing.assert_array_equal(oa["rgb_obs"][k], ob["rgb_obs"][k])
    np.testing.assert_array_equal(ia["state"], ib["state"])
    assert ia["progress"] == ib["progress"] and b.steps == 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["--debug", "--model", "tiny", "--precision", "fp32",
            "--calib_batches", "4", "--num_sequences_override", "2",
            "--ep_len", "8", "--exit_ratio", "0.5"]


def simulate_exits(vals, exits, th):
    """First exit whose delta passes, the last always fires."""
    taken = np.full(vals.shape[1], exits[-1])
    done = np.zeros(vals.shape[1], bool)
    for k, e in enumerate(exits):
        m = ~done & (vals[k] <= (1e30 if k == len(exits) - 1 else th[e]))
        taken[m] = e
        done |= m
    return taken


def last_three(out: str):
    lines = out.strip().splitlines()[-3:]
    return ([float(t) for t in lines[0].split(",")], float(lines[1]),
            float(lines[2]))


def test_cli_calibrates_serves_and_keeps_the_parse_contract(tmp_path,
                                                             capsys):
    cache = str(tmp_path / "deer_tiny")
    report_path = tmp_path / "report.json"
    report = cli.main(CLI_ARGS + ["--value_cache", cache, "--report_json",
                                  str(report_path)], device="cpu")
    out = capsys.readouterr().out
    th, avg_len, avg_exit = last_three(out)
    payload = json.loads(report_path.read_text())
    saved = {int(k): v for k, v in payload["thresholds"].items()}
    exits = sorted(saved)
    assert exits == list(tconfig.deer_tiny().all_exit_ids())
    np.testing.assert_allclose(th, [saved[e] for e in exits], atol=1e-6)
    assert avg_len == pytest.approx(report["avg_seq_len"], abs=1e-6)
    assert avg_exit == pytest.approx(report["avg_exit_layer"] - 1, abs=1e-6)
    assert "exit contract: target=" in out
    assert report["env_steps"] > 0 and report["rollout_seconds"] > 0
    assert set(report["exit_contract"]) >= {"target_probs", "realized",
                                            "max_abs_gap"}

    # the on-calibration contract: the solved thresholds applied to the
    # calibration values realize the target mix (floor rounding aside)
    vals = load_calibration_values(cache)
    assert vals.shape == (len(exits), 4 * 2 * 2)
    th_solved, probs = solve_thresholds(vals, 0.5, exits, exits[-1])
    assert th_solved == saved
    taken = simulate_exits(vals, exits, th_solved)
    realized = np.array([np.mean(taken == e) for e in exits])
    assert np.all(np.abs(realized - probs) <= 3.0 / vals.shape[1] + 1e-9), \
        (realized, probs)

    # a second run reuses the sidecar: same thresholds, no calibration
    cli.main(CLI_ARGS + ["--value_cache", cache], device="cpu")
    out2 = capsys.readouterr().out
    assert "reusing calibration values" in out2
    assert "calibrated" not in out2
    assert last_three(out2)[0] == th


def test_cli_lanes_and_fixed_thresholds(capsys):
    report = cli.main(CLI_ARGS + ["--lanes", "2", "--thresholds", "-1",
                                  "1e5"], device="cpu")
    th, avg_len, _ = last_three(capsys.readouterr().out)
    assert th == [-1.0, 1e5]
    assert "exit_contract" not in report
    # threshold -1 never passes: every step runs to the last exit
    assert report["fail_exit_hist"][3] + report["success_exit_hist"][3] > 0
    assert report["avg_exit_layer"] == 4.0
    assert report["batched_exit_waste"]["avg_wasted_layers_per_step"] == 0


# the ids are the cases' names from when each flag named its item
@pytest.mark.parametrize("flag,item", [
    pytest.param(["--visualize", "gifs", "--lanes", "2"],
                 "--visualize needs the sequential harness", id="flag0-M9"),
    pytest.param(["--tcp_rel", "--lanes", "2"],
                 "does not apply the tcp->world", id="flag1-M9b"),
    pytest.param(["--diverse_inst", "--tcp_rel", "--lanes", "2",
                  "--pipeline", "2"], "does not apply the tcp->world",
                 id="flag2-M9b"),
    pytest.param(["--annotation_cache", "a.json", "--visualize", "out",
                  "--lanes", "4"], "--visualize needs the sequential harness",
                 id="flag3-M9b"),
    pytest.param(["--calvin_conf_path", "conf"], r"ROADMAP\.md M9 ",
                 id="flag4-M9"),
    pytest.param(["--visualize", "out", "--tcp_rel", "--lanes", "2"],
                 "--visualize needs the sequential harness", id="flag5-M9b")])
def test_cli_unserved_flags_raise_naming_the_roadmap_item(flag, item):
    """A JAX flag the port does not serve names its ROADMAP.md item; the
    rollout options that need no download (M9b) are served and keep the
    JAX CLI's refusals with --lanes (cli/eval.py:468-475)."""
    with pytest.raises(SystemExit, match=item):
        cli.main(CLI_ARGS + flag, device="cpu")


# ---------------------------------------------------------------------------
# calibration on a CALVIN-format directory
# ---------------------------------------------------------------------------

CALIB_REL = 1e-4


@pytest.fixture(scope="module")
def calvin_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("calvin"))
    make_synthetic_calvin(root, n_episodes=2, ep_len=10, img_hw=200,
                          grip_hw=84)
    make_synthetic_calvin(root, n_episodes=3, ep_len=12, img_hw=200,
                          grip_hw=84, split="validation", seed=1,
                          compressed_episodes={0})
    return root


def calib_args(parser, root, batch):
    return parser.parse_args(["--calvin_dataset", root, "--batch_size_calvin",
                              str(batch), "--calib_batches", "2"])


def jax_calibration_draws(jcfg, batch, num):
    """forward_train's sampling-1 layers in JAX calibrate, from the key
    chain of generate_calibration_values (rng -> rng, prep, fwd)."""
    rng = jax.random.PRNGKey(0)
    exit_ids = jnp.asarray(jcfg.all_exit_ids())
    out = []
    for _ in range(num):
        rng, _, fwd = jax.random.split(rng, 3)
        lay1 = exit_ids[jax.random.randint(jax.random.split(fwd, 8)[2],
                                           (batch, jcfg.window_size), 0,
                                           jcfg.num_exits)]
        out.append({"rand_layer_ids": torch.as_tensor(np.array(lay1))})
    return out


def test_calibration_batches_and_thresholds_match_jax(calvin_root):
    """DIR/validation, hash-fixed windows, no shuffle, --batch_size_calvin
    trajectories: the batches equal JAX's _calibration_batches' bit for
    bit, and calibrate gives JAX's values and thresholds."""
    tok = ttext.HashTokenizer(vocab_size=128, max_length=8)
    jcfg, tcfg = (dataclasses.replace(c, media_token_id=tok.media_token_id)
                  for c in (jconfig.deer_tiny(), tconfig.deer_tiny()))
    jbatches = list(jcli._calibration_batches(
        calib_args(jcli.build_parser(), calvin_root, 3), jcfg, tok))
    tloader = cli.calibration_batches(
        calib_args(cli.build_parser(), calvin_root, 3), tcfg, tok)
    assert not tloader.shuffle and tloader.ds.validation
    assert tloader.ds.dir.name == "validation"
    tbatches = list(tloader)
    # 3 episodes of 12 frames: 8 windows of 4 each
    assert len(tbatches) == len(jbatches) == 3 * 8 // 3
    for got, want in zip(tbatches, jbatches):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tbatches[0]["rgb_static"].shape == (3, 4, 200, 200, 3)
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(3), jcfg))
    r = np.random.RandomState(4)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    th_j, vals_j = jcal.calibrate(jax.tree.map(jnp.asarray, params), jcfg,
                                  jbatches, 0.5, max_batches=2)
    th_t, vals_t = tcal.calibrate(to_torch(params, "cpu"), tcfg, tbatches,
                                  0.5, max_batches=2,
                                  draws=jax_calibration_draws(jcfg, 3, 2))
    # 2 batches of 3 trajectories, 2 samples each (W=4)
    assert vals_t.shape == vals_j.shape == (tcfg.num_exits, 2 * 3 * 2)
    vals_j = np.asarray(vals_j, np.float64)
    assert np.linalg.norm(vals_t - vals_j) <= \
        CALIB_REL * np.linalg.norm(vals_j)
    assert th_t.keys() == th_j.keys()
    np.testing.assert_allclose([th_t[e] for e in th_t],
                               [th_j[e] for e in th_j], rtol=CALIB_REL)


def test_cli_calibrates_on_calvin_then_stops_before_the_calvin_env(
        tmp_path, capsys, calvin_root):
    """Without --debug: calibrate on DIR/validation, write the sidecar,
    then the dropped-env SystemExit; a --debug run on the same stem serves
    those values instead of recomputing them."""
    cache = str(tmp_path / "calvin_values")
    args = ["--model", "tiny", "--precision", "fp32", "--calvin_dataset",
            calvin_root, "--batch_size_calvin", "3", "--calib_batches", "2",
            "--exit_ratio", "0.5", "--value_cache", cache]
    with pytest.raises(SystemExit) as exc:
        cli.main(args, device="cpu")
    assert str(exc.value) == cli.CALVIN_ENV_DROPPED
    assert "Dropped for good" in str(exc.value)
    out = capsys.readouterr().out
    assert "calibrated 12 samples" in out  # 2 batches x 3 x 2
    vals = load_calibration_values(cache)
    assert vals.shape == (tconfig.deer_tiny().num_exits, 12)
    th = [float(t) for t in out.strip().splitlines()[-1].split(",")]
    report = cli.main(CLI_ARGS + ["--value_cache", cache], device="cpu")
    out2 = capsys.readouterr().out
    assert "reusing calibration values" in out2 and "calibrated" not in out2
    assert last_three(out2)[0] == th
    assert report["env_steps"] > 0
    # --debug beside --calvin_dataset keeps the debug batches (JAX :604)
    cli.main(CLI_ARGS + ["--calvin_dataset", calvin_root], device="cpu")
    assert "calibrated 16 samples" in capsys.readouterr().out
