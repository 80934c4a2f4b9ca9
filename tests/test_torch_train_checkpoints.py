"""PyTorch port, the trainer (mirrors the JAX package's
tests/test_train.py): both phases and their freeze, checkpoints and
resume (the optimizer state, mid-epoch, refusing another backbone),
``save_freq``, EMA checkpoints and the loss multiplier, on deer_tiny on
the CPU.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.train.checkpoint import (backbone_record,
                                                 load_checkpoint)
from deer_vla_tpu_torch.train.trainer import Trainer

from torch_train_common import (torch_flat, trainer_setup)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# the trainer (mirrors tests/test_train.py)
# ---------------------------------------------------------------------------


def test_two_phases_freeze_and_checkpoint(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path)
    logs = []
    tr = Trainer(cfg, tcfg, loader, log_fn=logs.append, device="cpu")
    p0 = {k: v.clone() for k, v in torch_flat(tr.params).items()}
    metrics = tr.train()
    assert np.isfinite(metrics["loss"])
    assert {l["phase"] for l in logs} == {"joint", "exit_only"}
    p1 = torch_flat(tr.params)
    joint = torch_flat(tflamingo.trainable_mask(tr.params, cfg, "joint"))
    for k, v in p1.items():
        if not joint[k]:
            assert torch.equal(v, p0[k]), k  # frozen: untouched
    for k in ("extra_exit/rnn/layers/0/wi", "decoder/xattn/0/to_q/w",
              "decoder/wte/w"):
        assert not torch.equal(p1[k], p0[k]), k
    # the exit-only phase moved the heads only: deer_0 holds the joint end
    joint_end, _, side = load_checkpoint(str(tmp_path / "deer_0.ckpt"),
                                         tr.params)
    for k, v in torch_flat(joint_end).items():
        head = k.split("/")[0] in ("lm_head", "extra_exit", "lm_exits")
        assert torch.equal(v, p1[k]) != head, k
    assert side["meta"]["init"] == {"package": "deer_vla_tpu_torch",
                                    "seed": 42, "generator_device": "cpu",
                                    "backbone": backbone_record(cfg)}
    # resume: both epochs done
    tr2 = Trainer(cfg, tcfg, loader, device="cpu")
    assert tr2.maybe_resume() == 2
    assert torch.equal(torch_flat(tr2.params)["lm_head/rnn/layers/0/wi"],
                       p1["lm_head/rnn/layers/0/wi"])
    # the seed contract: the frozen backbone is init_deer(seed) on the device
    ref = tflamingo.init_deer(cfg, seed=tcfg.seed, device="cpu")
    assert torch.equal(tr2.params["vit"]["blocks"][0]["qkv"]["w"],
                       ref["vit"]["blocks"][0]["qkv"]["w"])


def test_resume_restores_optimizer_state(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path, num_joint_epochs=2,
                                      num_exit_epochs=0)
    tr = Trainer(cfg, tcfg, loader, device="cpu")
    tr.train(num_epochs=1)  # 3 steps, deer_0 with the optimizer state
    tr2 = Trainer(cfg, tcfg, loader, device="cpu")
    assert tr2.maybe_resume() == 1
    tr2.train(num_epochs=2)
    assert tr2.state.opt_state["count"] == 6  # 3 restored + 3 new


@pytest.mark.parametrize("change", ["seed", "generator_device",
                                    "given_params"])
def test_resume_refuses_another_backbone(tmp_path, change):
    """A delta checkpoint overlays the backbone it was trained over: resuming
    with another seed, after a run whose backbone was drawn on another
    device, or over weights the caller gave, raises."""
    cfg, tcfg, loader = trainer_setup(tmp_path, batches=1,
                                      num_joint_epochs=2, num_exit_epochs=0)
    Trainer(cfg, tcfg, loader, device="cpu").train(num_epochs=1)
    params = None
    if change == "seed":
        tcfg = dataclasses.replace(tcfg, seed=tcfg.seed + 1)
    elif change == "generator_device":
        side = tmp_path / "deer_0.json"
        rec = json.loads(side.read_text())
        rec["meta"]["init"]["generator_device"] = "cuda"
        side.write_text(json.dumps(rec))
    else:
        params = tflamingo.init_deer(cfg, seed=tcfg.seed, device="cpu")
    tr = Trainer(cfg, tcfg, loader, params=params, device="cpu")
    with pytest.raises(ValueError, match="trained over the backbone"):
        tr.maybe_resume()


def test_mid_epoch_checkpoints_and_resume(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path, num_exit_epochs=0,
                                      save_every_epoch=False,
                                      save_every_iter=2, logging_steps=100)
    Trainer(cfg, tcfg, loader, device="cpu").train()
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.endswith(".ckpt")) == ["deer_0_it2.ckpt"]
    tr = Trainer(cfg, dataclasses.replace(tcfg, num_joint_epochs=2), loader,
                 device="cpu")
    assert tr.maybe_resume() == 0  # re-run epoch 0, don't skip it
    tr.train()
    assert tr.state.opt_state["count"] == 2 + 2 * 3


def test_save_freq_skips_epochs(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path, batches=1,
                                      num_joint_epochs=4, num_exit_epochs=0,
                                      save_freq=3, logging_steps=100)
    Trainer(cfg, tcfg, loader, device="cpu").train()
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".ckpt")) \
        == ["deer_0.ckpt", "deer_3.ckpt"]


def test_ema_checkpoints(tmp_path):
    cfg, tcfg, loader = trainer_setup(tmp_path, num_exit_epochs=0,
                                      ema_decay=0.95)
    tr = Trainer(cfg, tcfg, loader, device="cpu")
    tr.train()
    template = tflamingo.init_deer(cfg, seed=tcfg.seed, device="cpu")
    reg, _, _ = load_checkpoint(str(tmp_path / "deer_0.ckpt"), template)
    ema, _, side = load_checkpoint(str(tmp_path / "deer_0_ema.ckpt"),
                                   template)
    k = "extra_exit/rnn/layers/0/wi"
    assert not torch.allclose(torch_flat(reg)[k], torch_flat(ema)[k])
    assert torch.isfinite(torch_flat(ema)[k]).all()
    assert side["meta"]["ema_decay"] == 0.95
    from deer_vla_tpu_torch.train.checkpoint import find_latest_checkpoint
    assert find_latest_checkpoint(str(tmp_path)).endswith("deer_0.ckpt")


def test_loss_multiplier_scales_gradient_and_logged_loss(tmp_path):
    def run(mult):
        cfg, tcfg, loader = trainer_setup(
            tmp_path / str(mult), batches=1, num_exit_epochs=0,
            save_every_epoch=False, seed=7, loss_multiplier_calvin=mult)
        tr = Trainer(cfg, tcfg, loader, device="cpu")
        return tr.train(), torch_flat(tr.params)
    m1, p1 = run(1.0)
    m2, p2 = run(2.0)
    np.testing.assert_allclose(2.0 * m1["loss"], m2["loss"], rtol=1e-5)
    k = "extra_exit/rnn/layers/0/wi"
    assert not torch.equal(p1[k], p2[k])
