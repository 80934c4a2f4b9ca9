"""PyTorch port, the train CLI on the CPU: ``cli/train --debug`` and on a
CALVIN-format directory, then ``cli/eval --evaluate_from_checkpoint`` on
its checkpoint, and the flags it refuses.
"""

import json
import os

import numpy as np
import pytest

from deer_vla_tpu_torch.cli import eval as eval_cli
from deer_vla_tpu_torch.cli import train as train_cli
from deer_vla_tpu_torch.data import calvin as tcalvin
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.ops.layers import tree_leaves_with_path

from torch_train_common import (calvin_root)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_cli_then_eval_from_checkpoint(tmp_path, capsys):
    run = str(tmp_path / "run")
    tr = train_cli.main(["--debug", "--model", "tiny", "--num_joint_epochs",
                         "1", "--num_exit_epochs", "1", "--batch_size_calvin",
                         "2", "--run_name", run, "--joint_warmup_steps", "1",
                         "--exit_warmup_steps", "1", "--precision", "fp32"],
                        device="cpu")
    assert sorted(f for f in os.listdir(run) if f.endswith(".ckpt")) == \
        ["deer_0.ckpt", "deer_1.ckpt"]
    side = json.load(open(os.path.join(run, "deer_1.json")))
    assert side["config"]["media_token_id"] == tr.cfg.media_token_id
    capsys.readouterr()
    report = eval_cli.main(["--debug", "--evaluate_from_checkpoint",
                            os.path.join(run, "deer_1.ckpt"),
                            "--calib_batches", "1", "--precision", "fp32",
                            "--num_sequences_override", "2",
                            "--exit_ratio", "0.5"], device="cpu")
    out = capsys.readouterr().out
    n = len(tree_leaves_with_path(tflamingo.checkpoint_mask(tr.params,
                                                            tr.cfg)))
    n_true = sum(bool(m) for _, m in tree_leaves_with_path(
        tflamingo.checkpoint_mask(tr.params, tr.cfg)))
    assert n > n_true > 0
    assert f"loaded {n_true} param groups from ckpt" in out
    assert report["avg_seq_len"] >= 0


@pytest.mark.parametrize("flag,error,match", [
    (["--tokenizer_path", "x"], SystemExit, "ROADMAP.md M9"),
    (["--cotrain"], SystemExit, "--cotrain needs --coco_ann"),
    (["--cotrain", "--vl_weight", "0.5"], SystemExit, "--cotrain needs"),
    (["--cotrain", "--coco_image_dir", "d"], SystemExit, "--cotrain needs"),
    (["--cotrain", "--vqa_image_dir", "d", "--vqa_ann", "a.json"],
     SystemExit, "--cotrain needs"),
    (["--cotrain", "--cotrain_laion_shards", "/nonexistent/s-*.tar"],
     SystemExit, "matched no files"),
    (["--cotrain", "--coco_ann", "/nonexistent/ann.json"],
     FileNotFoundError, "ann.json"),
    (["--cotrain", "--vqa_questions", "/nonexistent/q.json"],
     FileNotFoundError, "q.json"),
    (["--tcp_rel", "--cotrain"], SystemExit, "--cotrain needs"),
    (["--batch_size_calvin", "3", "--gradient_accumulation_steps", "2"],
     SystemExit, "not divisible by --gradient_accumulation_steps 2"),
    (["--cotrain", "--cotrain_laion_shards", "s", "--vl_batch_size", "3",
      "--gradient_accumulation_steps", "2", "--batch_size_calvin", "2"],
     SystemExit, "the VL batch 3 is not divisible"),
    (["--process_id", "1"], SystemExit, "need --coordinator"),
    (["--num_processes", "2"], SystemExit, "need --coordinator"),
    (["--coordinator", "h:1", "--num_processes", "2", "--process_id", "2"],
     SystemExit, "--process_id 2 is not a rank of --num_processes 2"),
    (["--coordinator", "h:1", "--num_processes", "0"], SystemExit,
     "not a rank of --num_processes 0")])
def test_train_cli_unserved_flags_raise(flag, error, match):
    """The CLI's refusals: --tokenizer_path (unserved, M9); --cotrain
    without a VL source or with one that is not there (JAX
    cli/train.py:358-375); a batch the microbatch split does not divide;
    process flags without --coordinator or naming no rank of the
    group."""
    with pytest.raises(error, match=match):
        train_cli.main(["--debug", "--model", "tiny"] + flag, device="cpu")


def test_train_cli_without_debug_raises():
    """Without --debug the CLI trains on --calvin_dataset; with neither it
    refuses."""
    with pytest.raises(SystemExit, match="--calvin_dataset"):
        train_cli.main(["--model", "tiny"], device="cpu")


@pytest.mark.parametrize("variant", ["window", "dif_ws_remat"])
def test_train_cli_on_calvin_then_eval_from_checkpoint(tmp_path, capsys,
                                                       calvin_root, variant):
    """cli/train without --debug on a CALVIN-format directory: the loader
    gives every epoch (set_epoch) its len(loader) steps; cli/eval serves
    the checkpoint."""
    run = str(tmp_path / "run")
    argv = ["--model", "tiny", "--calvin_dataset", calvin_root,
            "--num_joint_epochs", "1", "--num_exit_epochs", "1",
            "--batch_size_calvin", "2", "--run_name", run,
            "--joint_warmup_steps", "1", "--exit_warmup_steps", "1",
            "--precision", "fp32", "--workers", "2", "--window_size", "4"]
    # 2 batches an epoch: 4 of the 12 windows, or of dif_ws' 16
    if variant == "dif_ws_remat":
        argv += ["--dif_ws", "--min_window_size", "2", "--max_window_size",
                 "4", "--remat", "--remat_policy", "dots", "--text_aug",
                 "--data_percent", "0.25"]
    else:
        argv += ["--data_percent", "0.34"]
    tr = train_cli.main(argv, device="cpu")
    loader = tr.loader
    assert isinstance(loader, tcalvin.CalvinLoader)
    assert loader.epoch == 1
    assert tr.state.opt_state["count"] == len(loader) == 2
    ds = loader.ds
    assert ds.cfg.dataset_dir == f"{calvin_root}/training"
    assert ds.cfg.dif_ws == (variant == "dif_ws_remat")
    assert tr.cfg.remat_layers == (variant == "dif_ws_remat")
    assert sorted(f for f in os.listdir(run) if f.endswith(".ckpt")) == \
        ["deer_0.ckpt", "deer_1.ckpt"]
    capsys.readouterr()
    report = eval_cli.main(["--debug", "--evaluate_from_checkpoint",
                            os.path.join(run, "deer_1.ckpt"),
                            "--calib_batches", "1", "--precision", "fp32",
                            "--num_sequences_override", "2"], device="cpu")
    assert "param groups from ckpt" in capsys.readouterr().out
    assert report["avg_seq_len"] >= 0


def test_train_cli_on_calvin_with_state(tmp_path, calvin_root):
    """cli/train --use_state on the synthetic CALVIN tree: every gripper
    state is CALVIN's -1 or 1, so the host check passes each batch and the
    state rows reach the trained head."""
    from deer_vla_tpu_torch.data.preprocess import check_gripper_state
    tr = train_cli.main(["--model", "tiny", "--calvin_dataset", calvin_root,
                         "--use_state", "--num_joint_epochs", "1",
                         "--num_exit_epochs", "0", "--batch_size_calvin",
                         "2", "--run_name", str(tmp_path / "run"),
                         "--joint_warmup_steps", "1", "--precision", "fp32",
                         "--workers", "1", "--window_size", "4",
                         "--data_percent", "0.34"], device="cpu")
    assert tr.cfg.use_state and tr.cfg.head.use_state
    assert tr.state.opt_state["count"] == len(tr.loader) > 0
    for i in range(len(tr.loader.ds)):
        grip = tr.loader.ds[i]["robot_obs"][:, -1]
        assert set(np.unique(grip)) <= {-1.0, 1.0}
        check_gripper_state(tr.loader.ds[i]["robot_obs"], tr.cfg)


def test_train_cli_refuses_dif_ws_off_the_max_window(calvin_root, tmp_path):
    with pytest.raises(SystemExit, match="--max_window_size"):
        train_cli.main(["--model", "tiny", "--calvin_dataset", calvin_root,
                        "--dif_ws", "--window_size", "4",
                        "--max_window_size", "6", "--run_name",
                        str(tmp_path)], device="cpu")
