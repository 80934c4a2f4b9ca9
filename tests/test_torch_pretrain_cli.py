"""PyTorch port, the VL pretraining and co-training CLIs (``cli/pretrain``,
``cli/train --cotrain``; ROADMAP M16b) against the JAX package's on the
CPU, with the same weights on both sides (each side's init replaced by
the port's deer_tiny draw, gates open), and their refusals.

``cli/pretrain --debug`` takes no random draw, so its per-step losses
compare; ``cli/train --cotrain`` draws its exit layers and shifts from
another generator than JAX's, so its first step's draw-free metrics
compare: the LM loss, accuracy and token count.  Tolerance: 1e-5 relative
(fp32, other summation orders), as tests/test_torch_pretrain.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.cli import pretrain as jpretrain_cli
from deer_vla_tpu.cli import train as jtrain_cli
from deer_vla_tpu.models import flamingo as jflamingo
from deer_vla_tpu.train import trainer as jtrainer
from deer_vla_tpu_torch.bridge import to_torch
from deer_vla_tpu_torch.cli import pretrain as tpretrain_cli
from deer_vla_tpu_torch.cli import train as ttrain_cli
from deer_vla_tpu_torch.data.vl_dataset import write_ppm
from deer_vla_tpu_torch.data.webdataset import write_synthetic_laion_shard
from deer_vla_tpu_torch.models import flamingo as tflamingo
from deer_vla_tpu_torch.train import trainer as ttrainer

from test_torch_pretrain import LOSS_REL, assert_rel, tiny_params
from test_torch_train import torch_flat




def same_weights(monkeypatch, params):
    """Both sides' inits return the bridged draw."""
    monkeypatch.setattr(jflamingo, "init_deer",
                        lambda key, cfg: jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr(jtrainer, "init_deer",
                        lambda key, cfg: jax.tree.map(jnp.asarray, params))
    port = lambda cfg, seed=0, device=None: to_torch(params, device)  # noqa
    monkeypatch.setattr(tflamingo, "init_deer", port)
    monkeypatch.setattr(ttrainer, "init_deer", port)


def json_lines(out: str):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_pretrain_cli_debug_matches_jax(monkeypatch, tmp_path, capsys):
    """cli/pretrain --debug: one synthetic LAION and one MMC4 shard, the
    sources taking turns: every step's LM loss and accuracy; the
    checkpoint holds the trained weights."""
    params = tiny_params()
    same_weights(monkeypatch, params)
    argv = ["--debug", "--model", "tiny", "--steps", "4",
            "--batch_size_laion", "2", "--batch_size_mmc4", "2",
            "--logging_steps", "1", "--precision", "fp32",
            "--warmup_steps", "0", "--max_tokens", "24"]
    jpretrain_cli.main(argv + ["--run_name", str(tmp_path / "jax")])
    want = json_lines(capsys.readouterr().out)
    tp, metrics = tpretrain_cli.main(
        argv + ["--run_name", str(tmp_path / "port")], device="cpu")
    got = json_lines(capsys.readouterr().out)
    steps_w = [d for d in want if "step" in d]
    steps_g = [d for d in got if "step" in d]
    assert [d["source"] for d in steps_g] == \
        [d["source"] for d in steps_w] == ["laion", "mmc4"] * 2
    for g, w in zip(steps_g, steps_w):
        assert_rel(g["lm_loss"], w["lm_loss"], LOSS_REL)
        assert_rel(g["lm_acc"], w["lm_acc"], LOSS_REL)
    assert got[-1] == want[-1] == {"final_steps": 4}
    assert os.path.exists(tmp_path / "port" / "pretrain_0.ckpt")
    from deer_vla_tpu_torch.train.checkpoint import load_checkpoint
    template = to_torch(params, "cpu")
    mine, _, side = load_checkpoint(
        str(tmp_path / "port" / "pretrain_0.ckpt"), template)
    _, _, jside = load_checkpoint(str(tmp_path / "jax" / "pretrain_0.ckpt"),
                                  template)
    assert side["meta"]["phase"] == jside["meta"]["phase"] == "pretrain"
    mine = torch_flat(mine)
    for k, v in torch_flat(tp).items():
        assert torch.equal(mine[k], v), k


@pytest.mark.parametrize("flag,match", [
    (["--laion_weight", "0.5"], "found in the reference"),
    (["--mmc4_weight", "2"], "found in the reference"),
    (["--tokenizer_path", "x"], "ROADMAP.md M9"),
    (["--process_id", "1"], "need --coordinator"),
    (["--coordinator", "h:1", "--num_processes", "2", "--process_id", "3"],
     "not a rank")])
def test_pretrain_cli_refusals(tmp_path, flag, match):
    with pytest.raises(SystemExit, match=match):
        tpretrain_cli.main(["--debug", "--model", "tiny", "--run_name",
                            str(tmp_path)] + flag, device="cpu")


def test_pretrain_cli_needs_shards(tmp_path):
    """Without --debug a glob that matches nothing is no source (JAX's
    SystemExit); a process group asks at least one shard a process."""
    for argv in ([], ["--laion_shards", str(tmp_path / "none-*.tar")]):
        with pytest.raises(SystemExit, match="need --laion_shards"):
            tpretrain_cli.main(["--model", "tiny", "--run_name",
                                str(tmp_path / "r")] + argv, device="cpu")


def coco_fixture(root, n=6, hw=40):
    """A COCO-caption directory of PPM images (PIL reads them for JAX)."""
    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(0)
    images, anns = [], []
    for i in range(n):
        name = f"img{i}.ppm"
        write_ppm(os.path.join(root, name),
                  r.randint(0, 256, (hw, hw + 4, 3)).astype(np.uint8))
        images.append({"id": i, "file_name": name})
        anns += [{"image_id": i, "caption": f"a photo of thing {i} {j}"}
                 for j in range(2)]
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return path


@pytest.mark.parametrize("source", ["laion_shard", "coco"])
def test_train_cli_cotrain_matches_jax(monkeypatch, tmp_path, capsys,
                                       source):
    """cli/train --debug --cotrain on the same weights: the first step's
    LM loss, accuracy and token count (no draw reaches them), then finite
    steps and a checkpoint."""
    params = tiny_params()
    same_weights(monkeypatch, params)
    argv = ["--debug", "--model", "tiny", "--cotrain", "--num_joint_epochs",
            "1", "--num_exit_epochs", "0", "--batch_size_calvin", "2",
            "--vl_batch_size", "2", "--vl_weight", "0.5", "--precision",
            "fp32", "--logging_steps", "1", "--joint_warmup_steps", "1"]
    if source == "laion_shard":
        shard = str(tmp_path / "laion-000.tar")
        write_synthetic_laion_shard(shard, n=6, hw=24, seed=3)
        argv += ["--cotrain_laion_shards", str(tmp_path / "laion-*.tar")]
    else:
        ann = coco_fixture(str(tmp_path / "coco"))
        argv += ["--coco_image_dir", str(tmp_path / "coco"), "--coco_ann",
                 ann]
    jtrain_cli.main(argv + ["--run_name", str(tmp_path / "jax")])
    want = [d for d in json_lines(capsys.readouterr().out) if "step" in d]
    ttrain_cli.main(argv + ["--run_name", str(tmp_path / "port")],
                    device="cpu")
    got = [d for d in json_lines(capsys.readouterr().out) if "step" in d]
    assert len(got) == len(want) == 4
    for k in ("lm_loss", "lm_acc", "tokens"):
        assert_rel(got[0][k], want[0][k], LOSS_REL)
    assert all(np.isfinite(d["loss"]) for d in got)
    assert os.path.exists(tmp_path / "port" / "deer_0.ckpt")
