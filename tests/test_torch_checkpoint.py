"""PyTorch port, checkpoints: its own msgpack codec against
``flax.serialization`` (byte for byte, chunked arrays and bf16 included),
checkpoints written by either package read by the other, the newest
checkpoint picked as the JAX package picks it, the optimizer state in
optax's layout restored across the packages, and the evaluation loader's
seed contract.  Values must come back bit for bit.
"""

import io
import json
import os
import warnings

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.models import flamingo as jflamingo
from deer_vla_tpu.train import checkpoint as jckpt
from deer_vla_tpu.train import optimizer as joptim
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.ops.layers import flat_key, tree_leaves_with_path
from deer_vla_tpu_torch.train import checkpoint as tckpt
from deer_vla_tpu_torch.train import msgpack_io
from deer_vla_tpu_torch.train import optimizer as toptim
from deer_vla_tpu_torch.train.optimizer import make_optimizer


def flat_np(tree) -> dict:
    return {flat_key(p): (v.float() if v.dtype == torch.bfloat16 else v)
            .numpy() for p, v in tree_leaves_with_path(tree)}


def jax_flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): np.asarray(leaf, np.float32)
            if leaf.dtype == jnp.bfloat16 else np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = jconfig.deer_tiny(), tconfig.deer_tiny()
    jp = jflamingo.init_deer(jax.random.PRNGKey(0), jcfg)
    # a bf16 frozen backbone, as the trainers keep it
    jp = jflamingo.cast_frozen_to_bf16(jp, jflamingo.trainable_mask(
        jp, jcfg, "joint"))
    return jcfg, tcfg, jp


def dumps(obj) -> bytes:
    f = io.BytesIO()
    msgpack_io.dump(obj, f)
    return f.getvalue()


def bf16_bits(a) -> msgpack_io.Bf16Array:
    return msgpack_io.Bf16Array(np.asarray(a).view(np.uint16))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def test_codec_writes_what_flax_writes_and_reads_it_back():
    tree = {"params": {"b/w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "a": np.zeros((0,), np.int32),
                       "c": np.array(3.5), "d": np.ones((2, 2), np.int8)},
            "meta": {"i": 1, "neg": -5, "big": 2 ** 40, "m": -70000,
                     "none": None, "t": True, "f": 1.5, "s": "héllo",
                     "l": [1, 2, "a"], "long": "x" * 300},
            "scalar": np.float32(2.0),
            "bf": np.asarray(jnp.arange(5, dtype=jnp.bfloat16))}
    mine = dict(tree, bf=bf16_bits(tree["bf"]))
    data = dumps(mine)
    assert data == fser.msgpack_serialize(tree)
    back = msgpack_io.loads(fser.msgpack_serialize(tree))
    assert back["meta"] == tree["meta"]
    assert back["scalar"] == 2.0
    np.testing.assert_array_equal(back["bf"].bits, mine["bf"].bits)
    for k, v in tree["params"].items():
        np.testing.assert_array_equal(back["params"][k], v)
        assert back["params"][k].dtype == v.dtype
    restored = fser.msgpack_restore(data)
    np.testing.assert_array_equal(np.asarray(restored["bf"], np.float32),
                                  np.asarray(tree["bf"], np.float32))


@pytest.mark.parametrize("chunk", [16, 24, 1 << 30])
def test_codec_chunks_large_arrays_as_flax_does(monkeypatch, chunk):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", chunk)
    w = np.arange(90, dtype=np.float32).reshape(15, 6)
    h = np.asarray(jnp.arange(21, dtype=jnp.bfloat16)).reshape(3, 7)
    ref = fser.msgpack_serialize({"w": w, "h": h})
    assert (b"__msgpack_chunked_array__" in ref) == (chunk < 1 << 30)
    assert dumps({"w": w, "h": bf16_bits(h)}) == ref
    back = msgpack_io.loads(ref)
    np.testing.assert_array_equal(back["w"], w)
    np.testing.assert_array_equal(back["h"].bits, bf16_bits(h).bits)


def test_codec_rejects_truncated_and_unknown_data():
    data = dumps({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.loads(data[:-2])
    with pytest.raises(ValueError, match="ext type"):
        msgpack_io.loads(b"\xd4\x02\x00")


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_jax_written_checkpoint_reads_as_jax_reads_it(tiny, tmp_path):
    jcfg, tcfg, jp = tiny
    mask = jflamingo.checkpoint_mask(jp, jcfg)
    opt = joptim.make_optimizer(jp, jcfg, phase="joint", learning_rate=1e-3,
                                warmup_steps=0, total_steps=2,
                                trainable=mask)
    path = str(tmp_path / "deer_0")
    jckpt.save_checkpoint(path, jp, jcfg, meta={"epoch": 0, "seed": 0},
                          trainable_mask=mask, opt_state=opt.init(jp))
    # another init as the template, so every stored leaf must come from disk
    other = jflamingo.init_deer(jax.random.PRNGKey(1), jcfg)
    other = jflamingo.cast_frozen_to_bf16(other, mask)
    want, _, wmeta = jckpt.load_checkpoint(path + ".ckpt", other)
    template = to_torch(jax.tree.map(np.asarray, other), "cpu")
    template = tflamingo.cast_frozen_to_bf16(
        template, tflamingo.trainable_mask(template, tcfg, "joint"))
    tp = tflamingo.init_deer(tcfg, 0, "cpu")
    tmask = tflamingo.checkpoint_mask(tp, tcfg)
    got, opt_state, meta = tckpt.load_checkpoint(
        path, template, opt_state_template=make_optimizer(
            tp, tcfg, phase="joint", learning_rate=1e-3, warmup_steps=0,
            total_steps=2, trainable=tmask).init(tp))
    # the optax state of a fresh chain: count 0, zero moments of every
    # trainable leaf
    assert opt_state["count"] == 0
    assert set(opt_state["mu"]) == {
        flat_key(p) for p, m in tree_leaves_with_path(tmask) if m}
    assert all(not v.any() for v in opt_state["nu"].values())
    assert meta["meta"]["loaded_keys"] == wmeta["meta"]["loaded_keys"] > 0
    assert meta["meta"]["unconsumed_keys"] == []
    assert meta["config"] == json.loads(jcfg.to_json())
    g, w = flat_np(got), jax_flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got["vit"]["blocks"][0]["qkv"]["w"].dtype == torch.bfloat16


def test_port_written_checkpoint_reads_in_jax(tiny, tmp_path):
    jcfg, tcfg, jp = tiny
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tp = tflamingo.cast_frozen_to_bf16(
        tp, tflamingo.trainable_mask(tp, tcfg, "joint"))
    opt = make_optimizer(tp, tcfg, phase="joint", learning_rate=1e-3,
                         warmup_steps=0, total_steps=2)
    state = opt.init(tp)
    state["count"] = 3
    path = str(tmp_path / "full")
    tckpt.save_checkpoint(path, tp, tcfg, meta={"epoch": 1},
                          opt_state=opt.state_dict(state, tp))
    template = jflamingo.init_deer(jax.random.PRNGKey(5), jcfg)
    got, _, meta = jckpt.load_checkpoint(path, template)
    assert meta["meta"]["loaded_keys"] == len(tree_leaves_with_path(tp))
    assert meta["meta"]["unconsumed_keys"] == []
    assert jconfig.DeerConfig.from_json(json.dumps(meta["config"])) == jcfg
    g, w = jax_flat(got), flat_np(tp)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    raw = fser.msgpack_restore(open(path + ".ckpt", "rb").read())
    assert raw["params"]["vit/blocks/0/qkv/w"].dtype == jnp.bfloat16
    # the port's optimizer state comes back in the port
    _, restored, _ = tckpt.load_checkpoint(path, tp,
                                           opt_state_template=opt.init(tp))
    assert restored["count"] == 3 and restored["mu"].keys() == \
        state["mu"].keys()


def test_chunked_checkpoints_read_across_packages(tiny, tmp_path,
                                                 monkeypatch):
    """Leaves over the chunk size (shrunk here to 4 KiB) are stored in
    flax's chunked form by both writers and read back by both readers."""
    jcfg, tcfg, jp = tiny
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 4096)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jpath, jp, jcfg)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    tp = tflamingo.cast_frozen_to_bf16(
        tp, tflamingo.trainable_mask(tp, tcfg, "joint"))
    tckpt.save_checkpoint(tpath, tp, tcfg)
    for path in (jpath, tpath):
        assert open(path + ".ckpt", "rb").read().count(
            b"__msgpack_chunked_array__") > 10
    template = tflamingo.init_deer(tcfg, 3, "cpu")
    got, _, _ = tckpt.load_checkpoint(jpath, template)
    back, _, _ = jckpt.load_checkpoint(tpath, jflamingo.init_deer(
        jax.random.PRNGKey(3), jcfg))
    want = jax_flat(jp)
    for flat in (flat_np(got), jax_flat(back)):
        for k in want:
            np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def test_delta_checkpoint_overlays_and_reports_unmatched_keys(tiny,
                                                               tmp_path):
    jcfg, tcfg, jp = tiny
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu")
    mask = tflamingo.checkpoint_mask(tp, tcfg)
    path = str(tmp_path / "delta")
    tckpt.save_checkpoint(path, tp, tcfg, trainable_mask=mask)
    stored = msgpack_io.load(path + ".ckpt")["params"]
    assert set(stored) == {flat_key(p) for p, m in
                           tree_leaves_with_path(mask) if m}
    template = {"lm_head": tp["lm_head"], "extra": torch.zeros(2)}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got, _, meta = tckpt.load_checkpoint(path + ".ckpt", template)
    assert meta["meta"]["loaded_keys"] == len(tree_leaves_with_path(
        tp["lm_head"]))
    assert "decoder/wte/w" in meta["meta"]["unconsumed_keys"]
    assert any("not matched" in str(w.message) for w in rec)
    assert got["extra"] is template["extra"]


def test_find_latest_checkpoint_picks_what_jax_picks(tmp_path):
    names = ["deer_3_it500.ckpt", "deer_3.ckpt", "deer_2_it9.ckpt",
             "deer_4_it2.ckpt", "deer_4_it10.ckpt", "deer_5_ema.ckpt",
             "notes.txt", "deer_1.json"]
    for i in range(1, len(names) + 1):
        d = tmp_path / str(i)
        d.mkdir()
        for n in names[:i]:
            (d / n).write_bytes(b"")
        assert tckpt.find_latest_checkpoint(str(d)) == \
            jckpt.find_latest_checkpoint(str(d))
    assert tckpt.find_latest_checkpoint(str(tmp_path / "8")).endswith(
        "deer_4_it10.ckpt")
    assert tckpt.find_latest_checkpoint(str(tmp_path / "missing")) is None


def test_save_is_atomic_and_leaves_no_temporary_files(tmp_path):
    cfg = tconfig.deer_tiny()
    tckpt.save_checkpoint(str(tmp_path / "a"), {"w": torch.ones(3)}, cfg)
    assert sorted(os.listdir(tmp_path)) == ["a.ckpt", "a.json"]


# ---------------------------------------------------------------------------
# the evaluation loader's seed contract
# ---------------------------------------------------------------------------


def eval_args(path):
    return eval_cli.build_parser().parse_args(
        ["--debug", "--evaluate_from_checkpoint", path, "--precision",
         "fp32"])


def test_eval_loader_rebuilds_the_ports_backbone(tmp_path):
    cfg = tconfig.deer_tiny()
    params = tflamingo.init_deer(cfg, seed=5, device="cpu")
    for x in params["lm_head"]["rnn"]["layers"]:
        x["wi"].add_(1.0)  # the trained delta
    path = str(tmp_path / "deer_0")
    tckpt.save_checkpoint(path, params, cfg,
                          meta={"init": {"package": "deer_vla_tpu_torch",
                                         "seed": 5,
                                         "generator_device": "cpu"}},
                          trainable_mask=tflamingo.checkpoint_mask(params,
                                                                   cfg))
    got_cfg, got = eval_cli.load_model(eval_args(path + ".ckpt"),
                                       torch.device("cpu"))
    assert got_cfg == cfg
    for (p, a), (_, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(params)):
        assert torch.equal(a, b), p


def test_eval_loader_refuses_a_delta_it_cannot_rebuild(tiny, tmp_path):
    """A JAX-written delta overlays a JAX-drawn backbone the port cannot
    draw; a full checkpoint from either package loads."""
    jcfg, tcfg, jp = tiny
    jp32 = jflamingo.init_deer(jax.random.PRNGKey(0), jcfg)
    delta = str(tmp_path / "delta")
    jckpt.save_checkpoint(delta, jp32, jcfg, meta={"seed": 0},
                          trainable_mask=jflamingo.checkpoint_mask(jp32,
                                                                   jcfg))
    with pytest.raises(SystemExit, match="cannot rebuild"):
        eval_cli.load_model(eval_args(delta + ".ckpt"), torch.device("cpu"))
    full = str(tmp_path / "full")
    jckpt.save_checkpoint(full, jp32, jcfg, meta={"seed": 0})
    _, got = eval_cli.load_model(eval_args(full + ".ckpt"),
                                 torch.device("cpu"))
    want = jax_flat(jp32)
    for k, v in flat_np(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_eval_loader_needs_a_card_for_a_card_drawn_backbone(tmp_path,
                                                            monkeypatch):
    cfg = tconfig.deer_tiny()
    params = tflamingo.init_deer(cfg, seed=1, device="cpu")
    path = str(tmp_path / "deer_0")
    tckpt.save_checkpoint(path, params, cfg,
                          meta={"init": {"package": "deer_vla_tpu_torch",
                                         "seed": 1,
                                         "generator_device": "cuda"}},
                          trainable_mask=tflamingo.checkpoint_mask(params,
                                                                   cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="drawn on a CUDA device"):
        eval_cli.load_model(eval_args(path + ".ckpt"), torch.device("cpu"))


# ---------------------------------------------------------------------------
# the optimizer state in optax's layout
# ---------------------------------------------------------------------------


def state_paths(tree, prefix=()):
    """{path: leaf} of a state dict, an empty dict (optax's MaskedNode or
    EmptyState) kept as a leaf."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(state_paths(v, prefix + (str(k),)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("phase", ["joint", "exit_only"])
def test_optax_layout_state_restores_across_packages(tmp_path, phase):
    """Three updates with the same gradients in each package.  The port's
    opt_state has flax's to_state_dict layout of the JAX chain (every path,
    MaskedNodes included) with JAX's values within 1e-6; JAX's
    load_checkpoint restores it into an optax template, and the port
    restores a JAX-written one, both to the stored count, mu and nu bit for
    bit."""
    jcfg, tcfg = jconfig.deer_tiny(), tconfig.deer_tiny()
    jp = jax.tree.map(np.asarray, jflamingo.init_deer(jax.random.PRNGKey(0),
                                                      jcfg))
    tp = to_torch(jp, "cpu")
    kw = dict(phase=phase, learning_rate=1e-2, warmup_steps=0,
              total_steps=3, exit_lr_scale=2.0, weight_decay=0.1)
    jmask = jflamingo.trainable_mask(jp, jcfg, phase)
    jopt = joptim.make_optimizer(jp, jcfg, trainable=jmask, **kw)
    topt = make_optimizer(tp, tcfg, trainable=tflamingo.trainable_mask(
        tp, tcfg, phase), **kw)
    jparams, jstate = jax.tree.map(jnp.asarray, jp), None
    jstate = jopt.init(jparams)
    tstate = topt.init(tp)
    r = np.random.RandomState(1)
    for _ in range(3):
        grads = jax.tree.map(lambda x: r.randn(*x.shape).astype(np.float32)
                             * 0.1, jp)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        tflat = {flat_key(p): torch.as_tensor(v)
                 for p, v in tree_leaves_with_path(grads)}
        topt.update(tp, {k: tflat[k] for k in topt.trainable_keys()},
                    tstate)
    assert tstate["count"] == 3
    port_path, jax_path = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save_checkpoint(port_path, tp, tcfg,
                          opt_state=topt.state_dict(tstate, tp))
    raw = fser.msgpack_restore(open(port_path + ".ckpt", "rb").read())
    want = state_paths(fser.to_state_dict(jstate))
    got = state_paths(raw["opt_state"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict) or w is None:  # a MaskedNode, a None leaf
            assert got[k] == w, k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6,
                                       err_msg=k)
    # the port's state in JAX
    _, restored, _ = jckpt.load_checkpoint(port_path, jparams,
                                           opt_state_template=jopt.init(
                                               jparams))
    inner = restored[2].inner_states
    for label in toptim.ADAMW_LABELS:
        adam = inner[label].inner_state[0]
        assert int(adam.count) == 3 and \
            int(inner[label].inner_state[2].count) == 3
        for which in ("mu", "nu"):
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    getattr(adam, which))[0]:
                key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                               for p in path)
                assert topt.labels[key] == label, key
                np.testing.assert_array_equal(
                    np.asarray(leaf), tstate[which][key].numpy(), err_msg=key)
    # JAX's state in the port
    jckpt.save_checkpoint(jax_path, jparams, jcfg, opt_state=jstate)
    _, back, _ = tckpt.load_checkpoint(jax_path, tp,
                                       opt_state_template=topt.init(tp))
    assert back["count"] == 3
    jflat = state_paths(fser.to_state_dict(jstate))
    for which in ("mu", "nu"):
        assert back[which].keys() == tstate[which].keys()
        for key, v in back[which].items():
            stored = jflat[f"2/inner_states/{topt.labels[key]}/inner_state/"
                           f"0/{which}/{key}"]
            np.testing.assert_array_equal(v.numpy(), np.asarray(stored))
    # a template over other leaves is refused
    other = make_optimizer(tp, tcfg, phase="joint", learning_rate=1e-3,
                           warmup_steps=0, total_steps=1).init(tp)
    if phase == "exit_only":
        with pytest.raises(ValueError, match="does not cover"):
            tckpt.load_checkpoint(jax_path, tp, opt_state_template=other)
