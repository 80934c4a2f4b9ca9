"""The port's threshold search against the JAX package's on the CPU: the
parallel-candidate batched rollout (``evaluate_policy_batched(candidates=)``),
``cli/bayes_opt`` serial and ``--parallel`` on a converted checkpoint, a
diffusion-head ``--parallel`` run, and the restartable checkpoint sweep
(``cli/eval_ckpts``)."""

import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.cli.bayes_opt import main as jax_bayes_opt
from deer_vla_tpu.cli.convert import main as jax_convert
from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu.eval import batched_rollout as jbatched
from deer_vla_tpu.eval import rollout as jrollout
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxScan
from deer_vla_tpu_torch.cli.bayes_opt import main as torch_bayes_opt
from deer_vla_tpu_torch.cli.convert import main as torch_convert
from deer_vla_tpu_torch.cli.eval_ckpts import main as eval_ckpts
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import batched_rollout as tbatched
from deer_vla_tpu_torch.eval import rollout as trollout
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.models.flamingo import init_deer
from deer_vla_tpu_torch.train.checkpoint import save_checkpoint
from test_convert_cli import artifacts  # noqa: F401  (a fixture)
from test_torch_policy import make_params

REPORT_KEYS = ("avg_seq_len", "chain_sr", "success_exit_hist",
               "fail_exit_hist", "avg_exit_layer", "total_success_steps",
               "task_info", "batched_exit_waste")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread keeps them
    from waiting on a pool the other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def three_exit_configs():
    """deer_tiny at 6 layers: exits 1, 3, 5, so a candidate can exit in
    the middle."""
    jcfg = jconfig.deer_tiny(n_layers=6)
    tcfg = tconfig.deer_tiny(n_layers=6)
    tok = JaxTokenizer(vocab_size=jcfg.mpt.vocab_size,
                       max_length=jcfg.text_len)
    return (dataclasses.replace(jcfg, media_token_id=tok.media_token_id),
            dataclasses.replace(tcfg, media_token_id=tok.media_token_id))


def candidate_rollouts(rollout, cfg, cands, lanes_per, n_seq):
    envs = [rollout.DebugEnv(img_hw=cfg.vit.image_size,
                             grip_hw=cfg.vit.image_size)
            for _ in range(len(cands) * lanes_per)]
    return envs, rollout.make_debug_sequences(n_seq)


def test_candidates_reports_match_jax():
    """Three candidates (first exit, a middle exit, full depth) over two
    lanes each: every report field equal to JAX's, each candidate's exits
    where its row puts them; lanes that do not divide raise."""
    jcfg, tcfg = three_exit_configs()
    params = make_params(jcfg)
    jpol = JaxScan(jax.tree.map(jnp.asarray, params), jcfg)
    tpol = ScanDeerPolicy(params, tcfg, indexed_mm=True, device="cpu")
    exits = tpol.exits
    assert exits == list(jpol.exits) and len(exits) == 3
    cands = [[1e8, 1e8, 1e8], [-1e8, 1e8, 1e8], [-1e8, -1e8, 1e8]]
    reports = {}
    for name, pol, rollout, batched, tok in (
            ("jax", jpol, jrollout, jbatched,
             JaxTokenizer(vocab_size=jcfg.mpt.vocab_size,
                          max_length=jcfg.text_len)),
            ("torch", tpol, trollout, tbatched,
             HashTokenizer(vocab_size=tcfg.mpt.vocab_size,
                           max_length=tcfg.text_len))):
        envs, seqs = candidate_rollouts(rollout, jcfg, cands, 2, 3)
        reports[name] = batched.evaluate_policy_batched(
            pol, envs, seqs, {}, rollout.DebugTaskOracle(threshold=0.05),
            tok, text_len=jcfg.text_len, ep_len=8, n_layers=jcfg.n_layers,
            candidates=cands)
    assert len(reports["torch"]) == len(reports["jax"]) == 3
    for got, want in zip(reports["torch"], reports["jax"]):
        for k in REPORT_KEYS:
            assert got[k] == want[k], k
    for rep, e in zip(reports["torch"], exits):
        hist = np.add(rep["success_exit_hist"], rep["fail_exit_hist"])
        assert hist.sum() > 0 and hist[e] == hist.sum()
    envs, seqs = candidate_rollouts(trollout, tcfg, cands, 1, 2)
    with pytest.raises(ValueError, match="not divisible"):
        tbatched.evaluate_policy_batched(
            tpol, envs[:2], seqs, {}, trollout.DebugTaskOracle(),
            HashTokenizer(vocab_size=tcfg.mpt.vocab_size,
                          max_length=tcfg.text_len),
            text_len=tcfg.text_len, ep_len=4, candidates=cands)


@pytest.fixture(scope="module")
def converted_pair(artifacts, tmp_path_factory):  # noqa: F811
    """The tiny base + delta converted by each package (their trees are
    bit-equal, tests/test_torch_convert.py)."""
    cfg, tmp, _ = artifacts
    out = tmp_path_factory.mktemp("bo_ckpt")
    paths = {}
    for name, convert in (("jax", jax_convert), ("torch", torch_convert)):
        stem = str(out / name / "deer")
        with contextlib.redirect_stdout(io.StringIO()):
            convert(["--model", "tiny", "--max_layer", str(cfg.n_layers),
                     "--openflamingo_checkpoint",
                     str(tmp / "openflamingo_base.pt"),
                     "--deer_checkpoint", str(tmp / "deer_delta.pth"),
                     "--out", stem])
        paths[name] = stem + ".ckpt"
    return paths


BO_LINE = re.compile(r"BO eval thresholds=\[(.*)\] len=(\S+) exit=(\S+) "
                     r"score=(\S+)")


def bo_run(fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(argv, **kw)
    evals = [[float(t.strip("' ")) for t in m.group(1).split(",")]
             + [float(m.group(i)) for i in (2, 3, 4)]
             for m in BO_LINE.finditer(buf.getvalue())]
    return result, evals, buf.getvalue()


@pytest.mark.parametrize("mode", [[], ["--parallel", "2",
                                       "--lanes_per_candidate", "2"]],
                         ids=["serial", "parallel2"])
def test_bayes_opt_cli_matches_jax(converted_pair, mode):
    """The same search on each package's converted checkpoint in fp32:
    every BO eval line (candidate, length, exit, score) and the optimum
    within 1e-4 of JAX's."""
    argv = ["--debug", "--num_seq", "2", "--n_calls", "3", "--precision",
            "fp32"] + mode
    want, want_evals, _ = bo_run(
        jax_bayes_opt, argv + ["--evaluate_from_checkpoint",
                               converted_pair["jax"]])
    got, got_evals, out = bo_run(
        torch_bayes_opt, argv + ["--evaluate_from_checkpoint",
                                 converted_pair["torch"]], device="cpu")
    n = 3 if not mode else 4  # parallel rounds evaluate q points each
    assert len(got_evals) == len(want_evals) == n
    np.testing.assert_allclose(got_evals, want_evals, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.x, want.x, rtol=1e-4, atol=1e-4)
    assert abs(got.fun - want.fun) <= 1e-4
    np.testing.assert_allclose(got.func_vals, want.func_vals, atol=1e-4)
    assert "Optimal thresholds:" in out


def test_bayes_opt_refuses_the_calvin_env():
    with pytest.raises(SystemExit, match="dropped for good"):
        torch_bayes_opt(["--calvin_conf_path", "conf"], device="cpu")


@pytest.mark.parametrize("flag", ["--calvin_dataset", "--eval_sequences"])
def test_bayes_opt_refuses_the_calvin_data_flags(flag, capsys):
    """JAX forwards these only with --calvin_conf_path; the port has no
    CALVIN env, so it takes neither rather than dropping it silently."""
    with pytest.raises(SystemExit) as err:
        torch_bayes_opt([flag, "x"], device="cpu")
    assert err.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def diffusion_checkpoint(path) -> str:
    cfg = dataclasses.replace(
        tconfig.deer_tiny(), head_type="diffusion", diff_timesteps=5,
        diff_horizon=4, n_obs_steps=2, diff_down_dims=(8, 16))
    params = init_deer(cfg, seed=0, device="cpu")
    return save_checkpoint(str(path), params, cfg, meta={"seed": 0})


def test_bayes_opt_parallel_diffusion_head(tmp_path):
    """--parallel over a diffusion-head checkpoint: the candidates' lanes
    sample their plans through BatchedDiffusionSampler."""
    ckpt = diffusion_checkpoint(tmp_path / "diff")
    result, evals, out = bo_run(
        torch_bayes_opt,
        ["--debug", "--evaluate_from_checkpoint", ckpt, "--num_seq", "2",
         "--n_calls", "2", "--parallel", "2", "--lanes_per_candidate", "1",
         "--precision", "fp32"], device="cpu")
    assert len(evals) == 2 and all(np.isfinite(e).all() for e in evals)
    assert "Optimal thresholds:" in out and np.isfinite(result.fun)


def sweep_checkpoints(tmp_path) -> str:
    cfg = tconfig.deer_tiny()
    params = init_deer(cfg, seed=0, device="cpu")
    d = tmp_path / "run"
    for name in ("deer_0", "deer_1", "deer_1_ema"):
        save_checkpoint(str(d / name), params, cfg, meta={"seed": 0})
    return str(d)


def test_eval_ckpts_sweeps_skips_and_restarts(tmp_path, capsys):
    """checkpoint x ratio: a log and a report each, the _ema sibling left
    out; a second call skips every log; a deleted log runs again, and an
    extra argument reaches cli/eval."""
    import json
    ckpt_dir = sweep_checkpoints(tmp_path)
    logs = tmp_path / "logs"
    argv = ["--ckpt_dir", ckpt_dir, "--log_dir", str(logs), "--debug",
            "--num_seq", "1", "--exit_ratio", "0.5", "1.0", "--",
            "--calib_batches", "1", "--ep_len", "4",
            "--num_sequences_override", "1"]
    assert eval_ckpts(argv, device="cpu") == 0
    names = {f"deer_{i}_ratio{r}" for i in (0, 1) for r in (0.5, 1.0)}
    assert {p.stem for p in logs.glob("*.log")} == names
    for name in names:
        tail = (logs / f"{name}.log").read_text().strip().splitlines()[-3:]
        rep = json.loads((logs / f"{name}.json").read_text())
        assert abs(float(tail[1]) - rep["report"]["avg_seq_len"]) < 1e-5
        assert rep["exit_ratio"] == float(name.split("ratio")[1])
    capsys.readouterr()
    assert eval_ckpts(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("skip (done)") == 4 and "result:" not in out
    (logs / "deer_1_ratio1.0.log").unlink()
    assert eval_ckpts(argv + ["--exit_dist", "gauss"], device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("skip (done)") == 3 and out.count("result:") == 1
    assert not list(logs.glob("*.tmp"))
    assert eval_ckpts(["--include_ema"] + argv, device="cpu") == 0
    assert (logs / "deer_1_ema_ratio0.5.log").exists()


def test_eval_ckpts_failed_run_is_not_skipped(tmp_path, monkeypatch):
    """A run that raises leaves no log, so the next call runs it again."""
    from deer_vla_tpu_torch.cli import eval as eval_cli
    ckpt_dir = sweep_checkpoints(tmp_path)
    logs = tmp_path / "logs"
    argv = ["--ckpt_dir", ckpt_dir, "--log_dir", str(logs), "--debug",
            "--pattern", "deer_0.ckpt"]

    def fail(args, device=None):
        print("partial output")
        raise RuntimeError("device lost")

    monkeypatch.setattr(eval_cli, "main", fail)
    monkeypatch.setenv("DEER_ERROR_FILE", str(tmp_path / "crash.jsonl"))
    with pytest.raises(RuntimeError, match="device lost"):
        eval_ckpts(argv, device="cpu")
    assert not (logs / "deer_0_ratio1.0.log").exists()
    assert eval_ckpts(["--ckpt_dir", str(tmp_path / "none"), "--log_dir",
                       str(logs)], device="cpu") == 1
