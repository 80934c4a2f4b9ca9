"""PyTorch port, the host-bucketed ``DeerPolicy`` (``eval/policy.py``), the
fixed-exit forward (``models/flamingo.forward_fixed_exit``) and the decoder
segment (``models/mpt.decoder_segment_forward``) against the JAX package's
on the CPU, on the same bridged deer_tiny weights (cross-attention gates
opened so that the vision path reaches the actions) and numpy-seeded
inputs.

Exit layers must be equal at every step; actions, gripper and carries must
agree within 2e-4, the tolerance tests/test_torch_scan_policy.py holds the
serving step to, in every mode including int8 and int4 (the codes are
equal bit for bit, tests/test_torch_quant.py); the decoder segment and the
fixed-exit forward within 2e-5, as tests/test_torch_models.py holds a
module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval.policy import DeerPolicy as JaxPolicy
from deer_vla_tpu.models import flamingo as jflam
from deer_vla_tpu.models import mpt as jmpt
from deer_vla_tpu.models.value_net import ExitController as JaxController
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.models import mpt as tmpt
from deer_vla_tpu_torch.models.value_net import ExitController

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread keeps them
    from waiting on a pool the other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
MODULE_TOL = dict(rtol=2e-5, atol=2e-5)
# these weights' first-exit deltas on the inputs below straddle it: the
# dynamic steps take exits 1 and 3
TH = [5e-4, 1e8]


def make_params(jcfg, seed=0):
    params = jax.tree.map(np.asarray,
                          jflam.init_deer(jax.random.PRNGKey(seed), jcfg))
    r = np.random.RandomState(seed + 100)
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    return params


def obs(cfg, b, seed):
    r = np.random.RandomState(seed)
    hw, s = cfg.vit.image_size, cfg.text_len
    img = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    grip = r.randn(b, 1, 1, 3, hw, hw).astype(np.float32)
    ids = r.randint(0, cfg.media_token_id, size=(b, s)).astype(np.int32)
    ids[:, 2] = cfg.media_token_id
    mask = np.ones((b, s), np.int32)
    return img, grip, ids, mask


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.deer_tiny()
    return jcfg, make_params(jcfg)


def configs(jcfg, **changes):
    jc = dataclasses.replace(jcfg, **changes)
    return jc, tconfig.DeerConfig.from_json(jc.to_json())


def controllers(cfg, th, steps_per_stage=1):
    out = []
    for cls in (JaxController, ExitController):
        c = cls(exit_id_list=list(cfg.all_exit_ids()),
                steps_per_stage=steps_per_stage, max_layer=cfg.n_layers)
        c.set_threshold_values(th)
        out.append(c)
    return out


def pair(jcfg, tcfg, params, th=None, steps_per_stage=1, **kw):
    jc, tc = (controllers(tcfg, th, steps_per_stage) if th is not None
              else (None, None))
    return (JaxPolicy(jax.tree.map(jnp.asarray, params), jcfg, controller=jc,
                      **kw),
            DeerPolicy(params, tcfg, controller=tc, device="cpu", **kw))


def same_carry(ct, cj):
    for t, j in zip(ct, cj):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def run(jpol, tpol, cfg, steps=4):
    """Both policies over ``steps`` timesteps, the carry threaded; returns
    the exit layers taken."""
    exits = []
    for t in range(steps):
        img, grip, ids, mask = obs(cfg, 1, seed=t)
        for p in (jpol, tpol):
            p.set_timestep(t)
        a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                        jnp.asarray(ids), jnp.asarray(mask))
        a_t = tpol.step(img, grip, ids, mask)
        assert tpol.last_exit_layer == jpol.last_exit_layer, t
        assert a_t.shape == np.shape(a_j)
        np.testing.assert_allclose(a_t, a_j, **TOL)
        same_carry(tpol.carry, jpol.carry)
        exits.append(tpol.last_exit_layer)
    return exits


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_dynamic_exit_matches_jax(tiny, quantize):
    jcfg, params = tiny
    jc, tc = configs(jcfg)
    exits = run(*pair(jc, tc, params, TH, quantize=quantize), tc)
    if quantize is None:
        assert set(exits) == {1, 3}, exits


@pytest.mark.parametrize("exit_id", [1, -1, None])
def test_fixed_exit_matches_jax(tiny, exit_id):
    jcfg, params = tiny
    jc, tc = configs(jcfg)
    exits = run(*pair(jc, tc, params, exit_id=exit_id), tc, steps=2)
    want = {None: 3, -1: 3}.get(exit_id, exit_id)
    assert exits == [want, want]


def test_action_ensemble_matches_jax(tiny):
    jcfg, params = tiny
    jc, tc = configs(jcfg)
    jpol, tpol = pair(jc, tc, params, TH, use_action_ensemble=True)
    run(jpol, tpol, tc)
    assert tpol.controller.action_list == []


@pytest.mark.parametrize("m", [2, 3])
def test_multi_execution_matches_jax(tiny, m):
    jcfg, params = tiny
    jc, tc = configs(jcfg)
    jpol, tpol = pair(jc, tc, params, TH, multi_execution=m)
    run(jpol, tpol, tc, steps=2)
    plan = tpol.step(*obs(tc, 1, seed=7))
    assert plan.shape == (m, 7) and (plan == plan[:1]).all()


def test_steps_per_stage_reuse_matches_jax(tiny):
    """steps_per_stage=2: odd steps reuse the stage's exit without a delta
    read; the reuse forces the exit even where a fresh decision differs."""
    jcfg, params = tiny
    jc, tc = configs(jcfg)
    exits = run(*pair(jc, tc, params, TH, steps_per_stage=2), tc, steps=4)
    assert exits[1] == exits[0] and exits[3] == exits[2]


def test_layerwise_exit_eval_matches_jax(tiny):
    """Each exit's own head gives the action with its own carry; the exit
    decisions stay those of the extra exit."""
    jcfg, params = tiny
    jc, tc = configs(jcfg, layerwise_exit_eval=True)
    jpol, tpol = pair(jc, tc, params, TH)
    exits = run(jpol, tpol, tc)
    assert set(tpol.layer_carries) == set(exits) == set(jpol.layer_carries)
    for e in exits:
        same_carry(tpol.layer_carries[e], jpol.layer_carries[e])
    plain = pair(*configs(jcfg), params, TH)[1]
    for t in range(4):
        plain.set_timestep(t)
        a = plain.step(*obs(tc, 1, seed=t))
        assert plain.last_exit_layer == exits[t]
    assert not np.allclose(a[:6], tpol.step(*obs(tc, 1, seed=3))[:6])


def test_layerwise_refuses_a_model_without_exit_heads(tiny):
    jcfg, params = tiny
    _, tc = configs(jcfg, layerwise_exit_eval=True)
    bare = dict(params, lm_exits={})
    with pytest.raises(ValueError, match="lm_exits"):
        DeerPolicy(bare, tc, exit_id=1, device="cpu")


def test_decoder_segment_forward_matches_jax(tiny):
    jcfg, params = tiny
    tcfg = tconfig.deer_tiny()
    r = np.random.RandomState(3)
    _, _, ids, mask = obs(tcfg, 2, seed=3)
    mask[1, 5:] = 0
    x = r.randn(2, tcfg.text_len, 64).astype(np.float32)
    media = r.randn(2, 1, 2 * tcfg.perceiver.num_latents,
                    64).astype(np.float32)
    mloc = ids == tcfg.media_token_id
    tp = to_torch(params, "cpu")
    for start, stop in ((0, 2), (2, 4), (1, 2), (0, 4)):
        want = jmpt.decoder_segment_forward(
            jax.tree.map(jnp.asarray, params["decoder"]), jnp.asarray(x),
            jnp.asarray(mask), jnp.asarray(media), jcfg, start, stop,
            jnp.asarray(mloc))
        got = tmpt.decoder_segment_forward(
            tp["decoder"], torch.from_numpy(x), torch.from_numpy(mask),
            torch.from_numpy(media), tcfg, start, stop,
            torch.from_numpy(mloc))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **MODULE_TOL)


@pytest.mark.parametrize("layerwise", [False, True])
@pytest.mark.parametrize("exit_id", [1, 3])
def test_forward_fixed_exit_matches_jax(tiny, layerwise, exit_id):
    jcfg, params = tiny
    jc, tc = configs(jcfg, layerwise_exit_eval=layerwise)
    jp, tp = jax.tree.map(jnp.asarray, params), to_torch(params, "cpu")
    fwd = jax.jit(lambda p, a, b, c, g, carry: jflam.forward_fixed_exit(
        p, a, b, c, jc, exit_id, vision_gripper=g, carry=carry))
    cj = ct = None
    for t in range(2):
        img, grip, ids, mask = obs(tc, 2, seed=20 + t)
        out_j, cj = fwd(jp, jnp.asarray(img), jnp.asarray(ids),
                        jnp.asarray(mask), jnp.asarray(grip), cj)
        out_t, ct = tflam.forward_fixed_exit(
            tp, torch.from_numpy(img), torch.from_numpy(ids).long(),
            torch.from_numpy(mask), tc, exit_id,
            vision_gripper=torch.from_numpy(grip), carry=ct)
        for g, w in zip(out_t, out_j):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **MODULE_TOL)
        for g, w in zip(ct, cj):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **MODULE_TOL)


# ---------------------------------------------------------------------------
# cli/eval: the newly served flags against the JAX CLI
# ---------------------------------------------------------------------------

# thresholds at which the checkpoint's DebugEnv rollouts take exits 1 and 3
CLI_TH = ["--thresholds", "5.5e-4", "1e5"]
CLI_REPORT = ("avg_seq_len", "chain_sr", "success_exit_hist",
              "fail_exit_hist", "avg_exit_layer", "task_info")


@pytest.fixture(scope="module")
def checkpoint(tiny, tmp_path_factory):
    """A full fp32 checkpoint of the bridged weights that both CLIs load."""
    from deer_vla_tpu.train.checkpoint import save_checkpoint
    jcfg, params = tiny
    path = str(tmp_path_factory.mktemp("cli") / "full")
    save_checkpoint(path, params, jcfg, meta={"seed": 0})
    return ["--debug", "--evaluate_from_checkpoint", path + ".ckpt",
            "--precision", "fp32", "--num_sequences_override", "2",
            "--ep_len", "8"]


@pytest.mark.parametrize("flags", [
    ["--engine", "bucketed", "--quantize", "int8", "--steps_per_stage", "2"],
    ["--engine", "fused", "--vit_tome_r", "1", "--vision_cache_tau", "0.05"],
    ["--exit_id", "1"],
    ["--use_action_ensemble", "--multi_execution", "2"],
    ["--layerwise_exit_eval"],
    ["--engine", "bucketed", "--vision_cache_tau", "0.05",
     "--action_cache_tau", "0.03", "--action_cache_refresh", "3"],
    ["--lanes", "4", "--pipeline", "2", "--env_workers", "2"]],
    ids=lambda f: "_".join(a.strip("-") for a in f))
def test_cli_serves_each_flag_as_the_jax_cli(checkpoint, flags, capsys):
    from deer_vla_tpu.cli import eval as jcli
    from deer_vla_tpu_torch.cli import eval as tcli
    argv = checkpoint + ([] if "--exit_id" in flags else CLI_TH) + flags
    want = jcli.main(argv)
    want_out = capsys.readouterr().out.strip().splitlines()[-3:]
    got = tcli.main(argv, device="cpu")
    got_out = capsys.readouterr().out.strip().splitlines()[-3:]
    assert got_out == want_out
    for k in CLI_REPORT:
        assert got[k] == want[k], k
    for k in ("action_cache_hit_rate", "vision_cache_hit_rate"):
        assert got.get(k) == want.get(k), k
    if not {"--exit_id", "--layerwise_exit_eval", "--steps_per_stage",
            "--action_cache_tau"} & set(flags):
        taken = [e for h in ("success_exit_hist", "fail_exit_hist")
                 for e, p in enumerate(got[h]) if p > 0]
        assert set(taken) == {1, 3}, taken


@pytest.mark.parametrize("flags,match", [
    (["--env_workers", "2"], "only applies to the batched"),
    (["--layerwise_exit_eval", "--engine", "fused"], "host-bucketed"),
    (["--layerwise_exit_eval", "--lanes", "2"], "does not compose"),
    (["--layerwise_exit_eval", "--use_action_ensemble"], "does not compose"),
    (["--lanes", "2", "--vision_cache_tau", "0.1"], "does not compose"),
    (["--lanes", "2", "--action_cache_tau", "0.1"], "does not compose"),
    (["--lanes", "2", "--multi_execution", "2"], "does not compose"),
    (["--lanes", "2", "--exit_id", "1"], "does not compose")])
def test_cli_refuses_what_the_jax_cli_refuses(checkpoint, flags, match):
    from deer_vla_tpu_torch.cli import eval as tcli
    with pytest.raises(SystemExit, match=match):
        tcli.main(checkpoint + CLI_TH + flags, device="cpu")


def test_cli_layerwise_needs_a_multi_exit_checkpoint(tiny, tmp_path):
    from deer_vla_tpu.train.checkpoint import save_checkpoint
    from deer_vla_tpu_torch.cli import eval as tcli
    jcfg, params = tiny
    single = dataclasses.replace(jcfg, multi_exit=False)
    path = str(tmp_path / "single")
    save_checkpoint(path, dict(params, lm_exits={}), single,
                    meta={"seed": 0})
    with pytest.raises(SystemExit, match="multi-exit checkpoint"):
        tcli.main(["--debug", "--evaluate_from_checkpoint", path + ".ckpt",
                   "--layerwise_exit_eval"] + CLI_TH, device="cpu")


def unserved_cases():
    """Each flag of ``cli/eval.UNSERVED`` with a value other than its
    default, and the ROADMAP.md item it names."""
    from deer_vla_tpu_torch.cli import eval as tcli
    for flag, _, kw, item in tcli.UNSERVED:
        arg = ([] if kw.get("action") == "store_true"
               else [{int: "3", float: "0.5"}.get(kw.get("type"), "other")])
        yield pytest.param([flag] + arg, item.split()[0], id=flag.strip("-"))


@pytest.mark.parametrize("flag,item", list(unserved_cases()))
def test_cli_flags_still_unserved_name_their_roadmap_item(checkpoint, flag,
                                                          item):
    from deer_vla_tpu_torch.cli import eval as tcli
    with pytest.raises(SystemExit, match=f"ROADMAP.md {item}"):
        tcli.main(checkpoint + flag, device="cpu")
    if flag == ["--frame_cache"]:
        assert item == "M10"
