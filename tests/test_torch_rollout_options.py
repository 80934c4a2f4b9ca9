"""PyTorch port, the rollout options that need no download (ROADMAP M9b)
against the JAX package on the CPU: the tcp-frame conversions
(``utils/tcp.py``, within 1e-5 of JAX's fp32, 1e-4 after the orientation's
x100 scale), the trainer's tcp-frame labels, the adapter's conversion back
to the world frame, the episode GIFs (``--visualize``), enriched
instructions (``--diverse_inst``), ``cli/gen_sequences`` (byte-equal
files), and the host check of the gripper state a state head looks up.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.cli import gen_sequences as jax_gen
from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.models import action_head as jhead
from deer_vla_tpu.train import trainer as jtrainer
from deer_vla_tpu.utils import tcp as jtcp
from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.cli import gen_sequences
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.preprocess import check_gripper_state, state_rows
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import rollout
from deer_vla_tpu_torch.eval.sequences import generate_annotation_cache
from deer_vla_tpu_torch.models import action_head as thead
from deer_vla_tpu_torch.train import trainer as ttrainer
from deer_vla_tpu_torch.utils import tcp

TCP_TOL = dict(rtol=1e-5, atol=1e-4)


def rand_actions(r, shape):
    a = r.uniform(-0.5, 0.5, shape + (7,)).astype(np.float32)
    a[..., 6] = np.sign(a[..., 6])
    return a


def rand_obs(r, shape):
    ro = r.uniform(-0.5, 0.5, shape + (15,)).astype(np.float32)
    ro[..., 3:6] = r.uniform(-1.0, 1.0, shape + (3,))  # the euler pose
    return ro


# ---------------------------------------------------------------------------
# utils/tcp.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(32,), (2, 5)])
def test_euler_conversions_match_jax(shape):
    e = np.random.RandomState(0).uniform(-1.2, 1.2, shape + (3,)).astype(
        np.float32)
    m = tcp.euler_angles_to_matrix(torch.as_tensor(e))
    np.testing.assert_allclose(
        m.numpy(), np.asarray(jtcp.euler_angles_to_matrix(jnp.asarray(e))),
        rtol=1e-6, atol=1e-6)
    back = tcp.matrix_to_euler_angles(m).numpy()
    np.testing.assert_allclose(back, np.asarray(
        jtcp.matrix_to_euler_angles(jnp.asarray(m.numpy()))), atol=1e-6)
    np.testing.assert_allclose(back, e, atol=1e-5)


@pytest.mark.parametrize("shape", [(), (8,), (2, 3)])
@pytest.mark.parametrize("direction", ["world_to_tcp", "tcp_to_world"])
def test_tcp_frames_match_jax(shape, direction):
    """One (7,) host action, a batch, a (B, k) plan with its own pose a
    row: both directions against JAX's."""
    r = np.random.RandomState(len(shape))
    a, ro = rand_actions(r, shape), rand_obs(r, shape)
    got = getattr(tcp, f"{direction}_frame")(a, ro)
    want = getattr(jtcp, f"{direction}_frame")(jnp.asarray(a),
                                               jnp.asarray(ro))
    assert got.shape == a.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TCP_TOL)
    np.testing.assert_array_equal(got[..., 6].numpy(), a[..., 6])


def test_world_tcp_world_round_trip():
    """tcp_to_world inverts world_to_tcp at the same pose; the position's
    norm is kept (a rotation); one pose broadcasts over a (k, 7) plan."""
    r = np.random.RandomState(1)
    a, ro = torch.as_tensor(rand_actions(r, (8,))), \
        torch.as_tensor(rand_obs(r, (8,)))
    t = tcp.world_to_tcp_frame(a, ro)
    np.testing.assert_allclose(tcp.tcp_to_world_frame(t, ro).numpy(),
                               a.numpy(), atol=1e-4)
    np.testing.assert_allclose(t[:, :3].norm(dim=-1).numpy(),
                               a[:, :3].norm(dim=-1).numpy(), atol=1e-6)
    plan = tcp.tcp_to_world_frame(a[:3], ro[0])
    each = torch.stack([tcp.tcp_to_world_frame(x, ro[0]) for x in a[:3]])
    np.testing.assert_array_equal(plan.numpy(), each.numpy())


# ---------------------------------------------------------------------------
# --tcp_rel in training and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_prepare_batch_tcp_labels_match_jax(k):
    """The labels in the tcp frame at each frame's robot_obs, the pose
    broadcast over a multi-step label's k actions; without tcp_rel they
    stay world-frame."""
    cfg_j, cfg_t = jconfig.deer_tiny(), tconfig.deer_tiny()
    tok = HashTokenizer(vocab_size=cfg_t.mpt.vocab_size,
                        max_length=cfg_t.text_len)
    r = np.random.RandomState(2)
    bs, w, hw = 2, cfg_t.window_size, cfg_t.vit.image_size
    ids, mask = tok(["do x"] * bs)
    raw = {"rgb_static": r.randint(0, 255, (bs, w, hw, hw, 3), np.uint8),
           "rgb_gripper": r.randint(0, 255, (bs, w, hw, hw, 3), np.uint8),
           "input_ids": ids, "attention_mask": mask,
           "actions": rand_actions(r, (bs, w) + ((k,) if k > 1 else ())),
           "robot_obs": rand_obs(r, (bs, w))}
    want = jtrainer.prepare_batch(raw, cfg_j, jax.random.PRNGKey(0),
                                  jtrainer.TrainConfig(tcp_rel=True,
                                                       rgb_pad=0,
                                                       gripper_pad=0))
    tcfg = ttrainer.TrainConfig(tcp_rel=True, rgb_pad=0, gripper_pad=0)
    got = ttrainer.prepare_batch(raw, cfg_t, None, tcfg, "cpu")
    assert got["labels"].shape == raw["actions"].shape
    np.testing.assert_allclose(got["labels"].numpy(),
                               np.asarray(want["labels"]), **TCP_TOL)
    plain = ttrainer.prepare_batch(raw, cfg_t, None, dataclasses.replace(
        tcfg, tcp_rel=False), "cpu")
    np.testing.assert_array_equal(plain["labels"].numpy(), raw["actions"])


class FixedPolicy:
    """A policy that returns a fixed action or (k, 7) plan."""

    def __init__(self, action):
        self.cfg = tconfig.deer_tiny()
        self.device = torch.device("cpu")
        self.action = action
        self.last_exit_layer = 1

    def step(self, img, grip, ids, mask, state=None):
        return self.action.copy()

    def reset(self):
        pass

    def set_timestep(self, t):
        pass


@pytest.mark.parametrize("k", [1, 4])
def test_adapter_tcp_rel_converts_back_like_jax(k):
    """The adapter turns a tcp-frame action, or each row of a plan, back to
    the world frame at the observation's pose; without robot_obs or
    without tcp_rel it leaves the action as it is."""
    r = np.random.RandomState(3)
    act = rand_actions(r, (k,) if k > 1 else ())
    cfg = tconfig.deer_tiny()
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size,
                        max_length=cfg.text_len)
    hw = cfg.vit.image_size
    obs = {"rgb_obs": {"rgb_static": r.randint(0, 255, (hw, hw, 3),
                                               np.uint8),
                       "rgb_gripper": r.randint(0, 255, (hw, hw, 3),
                                                np.uint8)},
           "robot_obs": rand_obs(r, ())}
    ad = rollout.CalvinPolicyAdapter(FixedPolicy(act), tok,
                                     text_len=cfg.text_len, tcp_rel=True)
    got = ad.step(obs, "do x")
    ro_b = np.broadcast_to(obs["robot_obs"], act.shape[:-1] + (15,))
    want = jtcp.tcp_to_world_frame(jnp.asarray(act), jnp.asarray(ro_b))
    assert got.shape == act.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TCP_TOL)
    no_pose = {"rgb_obs": obs["rgb_obs"]}
    np.testing.assert_array_equal(ad.step(no_pose, "do x"), act)
    ad.tcp_rel = False
    np.testing.assert_array_equal(ad.step(obs, "do x"), act)


# ---------------------------------------------------------------------------
# --visualize, --diverse_inst, cli/gen_sequences
# ---------------------------------------------------------------------------


class MovingAdapter:
    """An adapter that moves the arm a lot, so that every frame differs
    (PIL merges equal consecutive GIF frames)."""
    policy = FixedPolicy(np.array([1.0, 0, 0, 0, 0, 0, 1.0], np.float32))
    current_exit_layer = 1
    llm_time = 0.0

    def reset(self):
        pass

    def step(self, obs, goal):
        return self.policy.action.copy()


def test_visualize_saves_episode_gifs(tmp_path):
    """A GIF an episode, named as JAX names it and tagged ok / fail, with a
    frame a step after the first observation."""
    Image = pytest.importorskip("PIL.Image")
    env = rollout.DebugEnv(img_hw=28, grip_hw=28)
    report = rollout.evaluate_policy(
        MovingAdapter(), env, [({}, ["task_a", "task_b"])], {},
        rollout.DebugTaskOracle(threshold=1e9), ep_len=5,
        visualize_dir=str(tmp_path / "gifs"))
    files = sorted((tmp_path / "gifs").glob("*.gif"))
    assert [f.name for f in files] == ["seq0000_0_task_a_fail.gif"]
    assert report["avg_seq_len"] == 0
    with Image.open(files[0]) as im:
        assert 3 <= im.n_frames <= 6 and im.size == (28, 28)
    rollout.evaluate_sequence(env, MovingAdapter(),
                              rollout.DebugTaskOracle(threshold=0.0), {},
                              ["task_b"], {}, ep_len=5, seq_i=3,
                              visualize_dir=str(tmp_path))
    assert (tmp_path / "seq0003_0_task_b_ok.gif").exists()


@pytest.mark.parametrize("extra", [[], ["--tasks", "a_b", "c_d", "e"],
                                   "enriched"])
def test_gen_sequences_files_are_byte_equal_to_jax(tmp_path, extra):
    if extra == "enriched":
        (tmp_path / "enrich.json").write_text(json.dumps(
            {"open_drawer": ["pull the drawer", "open it"],
             "lift_red_block_table": ["pick up the red block"]}))
        (tmp_path / "base.json").write_text(json.dumps(
            {"open_drawer": "open the drawer", "turn_on_led": "led on"}))
        extra = ["--enrich_lang", str(tmp_path / "enrich.json"),
                 "--annotations", str(tmp_path / "base.json")]
    for pkg, main in (("jax", jax_gen.main), ("torch", gen_sequences.main)):
        main(["--num_sequences", "12", "--seed", "7", "--out_sequences",
              str(tmp_path / f"{pkg}_seq.json"), "--out_annotation_cache",
              str(tmp_path / f"{pkg}_cache.json")] + extra)
    for name in ("seq", "cache"):
        assert ((tmp_path / f"torch_{name}.json").read_bytes()
                == (tmp_path / f"jax_{name}.json").read_bytes())
    cache = json.loads((tmp_path / "torch_cache.json").read_text())
    assert len(cache) == 12 and all(len(row) == 5 for row in cache)


def test_annotation_cache_falls_back_to_the_task_name():
    seqs = [({}, ["open_drawer", "turn_on_led"])]
    assert generate_annotation_cache(seqs, {}) == [["open drawer",
                                                    "turn on led"]]


EVAL_ARGV = ["--debug", "--model", "tiny", "--precision", "fp32",
             "--thresholds", "0.1", "1e8", "--num_sequences_override", "2",
             "--ep_len", "6"]


def test_eval_cli_serves_the_download_free_options(tmp_path, monkeypatch):
    """cli/eval --tcp_rel --visualize DIR --diverse_inst with a cache from
    cli/gen_sequences: the rollouts take the cache's instructions, a GIF
    an episode is written, the report is a report."""
    pytest.importorskip("PIL")
    cache = tmp_path / "cache.json"
    gen_sequences.main(["--num_sequences", "2", "--out_sequences",
                        str(tmp_path / "seqs.json"), "--out_annotation_cache",
                        str(cache)])
    seen = []
    resolve = rollout.resolve_annotation

    def spy(annotations, subtask, seq_i=0, subtask_i=0):
        seen.append(resolve(annotations, subtask, seq_i, subtask_i))
        return seen[-1]

    monkeypatch.setattr(rollout, "resolve_annotation", spy)
    report = eval_cli.main(EVAL_ARGV + [
        "--tcp_rel", "--visualize", str(tmp_path / "gifs"), "--diverse_inst",
        "--annotation_cache", str(cache)], device="cpu")
    rows = json.loads(cache.read_text())
    assert seen and all(s in rows[0] + rows[1] for s in seen)
    gifs = list((tmp_path / "gifs").glob("seq000*_*.gif"))
    assert len(gifs) == len(seen)
    assert np.isfinite(report["avg_exit_layer"])


def test_eval_cli_diverse_inst_without_a_cache_warns(tmp_path, capsys):
    eval_cli.main(EVAL_ARGV + ["--diverse_inst", "--annotation_cache",
                               str(tmp_path / "none.json")], device="cpu")
    assert "WARNING: --diverse_inst without" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the gripper state a state head looks up
# ---------------------------------------------------------------------------


def state_cfgs(clip_state=False):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.deer_tiny()
        cfg = dataclasses.replace(cfg, use_state=True, head=dataclasses.replace(
            cfg.head, use_state=True))
        if clip_state:
            cfg = dataclasses.replace(cfg, clip_state=True, state_dim=7)
        out.append(cfg)
    return out


IN_RANGE = (1.0, -1.0, 0.0, 2.9, -3.5, -5.0, -6.9)
OUT_OF_RANGE = (3.0, 5.0, -7.0, -100.0, float("nan"), float("inf"))


def test_in_range_gripper_states_are_looked_up_as_jax_does():
    """Indices -2 and -1 wrap to the table's rows in both packages."""
    jcfg, tcfg = state_cfgs()
    p = jax.tree.map(np.asarray, jhead.init_head(jax.random.PRNGKey(0),
                                                 jcfg.head))
    r = np.random.RandomState(0)
    st = r.uniform(-1, 1, (len(IN_RANGE), 7)).astype(np.float32)
    st[:, -1] = IN_RANGE
    check_gripper_state(st, tcfg)
    want = np.asarray(jhead.embed_state(jax.tree.map(jnp.asarray, p),
                                        jnp.asarray(st), jcfg.head))
    got = thead.embed_state({k: {n: torch.tensor(v) for n, v in d.items()}
                             for k, d in p.items()
                             if k.startswith("embed_")}, torch.as_tensor(st))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("g", OUT_OF_RANGE)
def test_out_of_range_gripper_state_raises_on_the_host(g):
    """What JAX turns into NaN actions raises before the rows reach the
    device: in the trainer's rows, the rollout adapter's, and (through
    ``check_gripper_state``) the servers'."""
    jcfg, tcfg = state_cfgs(clip_state=True)
    ro = np.zeros((1, tcfg.window_size, 15), np.float32)
    ro[0, -1, -1] = g
    with pytest.raises(ValueError, match="gripper state"):
        state_rows({"robot_obs": ro}, tcfg, "cpu")
    with pytest.raises(ValueError, match="gripper state"):
        rollout.state_row({"robot_obs": ro[0, -1]}, tcfg)
    ro[0, -1, -1] = 1.0
    assert state_rows({"robot_obs": ro}, tcfg, "cpu").shape == (
        tcfg.window_size, 1, 1, 7)
    # only a head that looks the state up is checked
    vision_only = dataclasses.replace(tcfg, head=dataclasses.replace(
        tcfg.head, use_state=False))
    check_gripper_state(np.full((1, 7), g, np.float32), vision_only)


def test_train_cli_tcp_rel_reaches_the_trainer(tmp_path):
    """cli/train --tcp_rel: the trainer's config carries it, and its first
    batch's labels are the tcp-frame labels of the loader's batch."""
    from deer_vla_tpu_torch.cli import train as train_cli
    trainer, args = train_cli.build_trainer(
        ["--debug", "--model", "tiny", "--tcp_rel", "--batch_size_calvin",
         "2", "--run_name", str(tmp_path)], device="cpu")
    assert args.tcp_rel and trainer.tcfg.tcp_rel
    raw = next(iter(trainer.loader))
    tcfg = dataclasses.replace(trainer.tcfg, rgb_pad=0, gripper_pad=0)
    got = ttrainer.prepare_batch(raw, trainer.cfg, None, tcfg,
                                 "cpu")["labels"]
    w = trainer.cfg.window_size
    want = tcp.world_to_tcp_frame(raw["actions"][:, :w],
                                  raw["robot_obs"][:, :w])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
