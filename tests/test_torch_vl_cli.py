"""PyTorch port, ``cli/vl_eval`` and ``cli/cache_features`` against the JAX
package's CLIs on the CPU: one fixture directory that both read (binary PPM
frames under VQAv2's file names, which PIL reads by content; the COCO,
Karpathy, VQA, label and hateful-memes files) and one checkpoint each
family (flamingo: deer_tiny in flax's msgpack format, its cross-attention
gates open; BLIP: an HF state dict ``.pt`` at blip_tiny), ``--precision
fp32``.  Every task's result (scores, metrics, RICES indices) must be equal,
and the prediction files equal.  The CLIs' own refusals and ``--debug``
(its PPM fixture) are checked on the port alone.
"""

import json
import os

import numpy as np
import pytest
import torch

from deer_vla_tpu.cli import cache_features as jcache
from deer_vla_tpu.cli import vl_eval as jcli
from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.train.checkpoint import save_checkpoint
from deer_vla_tpu_torch.cli import cache_features as tcache
from deer_vla_tpu_torch.cli import vl_eval as tcli
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data.vl_dataset import write_ppm
from deer_vla_tpu_torch.models import blip as tblip
from deer_vla_tpu_torch.models import flamingo as tflam
from deer_vla_tpu_torch.ops.layers import tree_map
from test_torch_vl_models import flat_leaves, hf_blip_state_dict

N = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """{flag lists by name}: the fixture directory's paths and the two
    checkpoints."""
    root = str(tmp_path_factory.mktemp("vl"))
    img_dir = os.path.join(root, "val2014")
    os.makedirs(img_dir)
    r = np.random.RandomState(0)
    images, anns, karp, questions, answers, memes = [], [], [], [], [], []
    for i in range(N):
        fn = f"COCO_val2014_{i:012d}.jpg"
        write_ppm(os.path.join(img_dir, fn),
                  r.randint(0, 256, (30 + i, 32, 3), np.uint8))
        images.append({"id": i, "file_name": fn})
        anns.append({"image_id": i, "caption": f"a synthetic object {i % 3}"})
        karp.append({"filename": fn, "split": "test",
                     "sentences": [{"raw": f"a synthetic object {i % 3}"},
                                   {"raw": f"the object {i % 3} photo"}]})
        questions.append({"question": f"what is object {i % 3}?",
                          "question_id": 10 + i, "image_id": i})
        answers.append({"answers": [{"answer": f"object {i % 3}"}] * 3})
        memes.append({"img": fn, "text": f"meme text {i % 4}",
                      "label": i % 2})
    files = {"coco": {"images": images, "annotations": anns},
             "karpathy": {"images": karp},
             "q": {"questions": questions}, "a": {"annotations": answers},
             "labels": {"classes": [f"object {k}" for k in range(3)],
                        "samples": [{"file_name": im["file_name"],
                                     "label": im["id"] % 3}
                                    for im in images]}}
    paths = {}
    for name, obj in files.items():
        paths[name] = os.path.join(root, name + ".json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    paths["memes"] = os.path.join(root, "dev.jsonl")
    with open(paths["memes"], "w") as f:
        f.write("".join(json.dumps(m) + "\n" for m in memes))

    jcfg = jconfig.deer_tiny()
    params = tree_map(lambda t: t.numpy(), tflam.init_deer(
        tconfig.DeerConfig.from_json(jcfg.to_json()), seed=0, device="cpu"))
    for x in params["decoder"]["xattn"]:
        x["attn_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
        x["ff_gate"] = r.uniform(-1, 1, (1,)).astype(np.float32)
    save_checkpoint(os.path.join(root, "flamingo"), params, jcfg,
                    meta={"seed": 0})
    blip_pt = os.path.join(root, "blip.pt")
    torch.save(hf_blip_state_dict(tblip.blip_tiny(), seed=1), blip_pt)
    common = ["--precision", "fp32", "--image_dir", img_dir,
              "--num_samples", str(N), "--batch_size", str(N)]
    return {"root": root, "paths": paths,
            "flamingo": common + ["--evaluate_from_checkpoint",
                                  os.path.join(root, "flamingo.ckpt")],
            "blip": common + ["--eval_model", "blip", "--model", "tiny",
                              "--evaluate_from_checkpoint", blip_pt]}


def task_flags(shared, task):
    p = shared["paths"]
    return {"caption": ["--annotations", p["coco"]],
            "flickr": ["--annotations", p["karpathy"]],
            "vqa": ["--questions", p["q"], "--annotations", p["a"]],
            "okvqa": ["--questions", p["q"], "--annotations", p["a"]],
            "classify": ["--labels", p["labels"]],
            "imagenet": ["--labels", p["labels"]],
            "hateful_memes": ["--annotations", p["memes"]]}[task]


def both(jmain, tmain, argv, capsys):
    """(JAX's result, the port's), each CLI's last stdout line its JSON."""
    want = jmain(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == want
    got = tmain(argv, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    return want, got


@pytest.mark.parametrize("family,task,flags", [
    ("flamingo", "caption", []),
    ("flamingo", "flickr", []),
    ("flamingo", "vqa", ["--fewshot", "--rices", "--save_predictions"]),
    ("flamingo", "hateful_memes", []),
    ("blip", "caption", ["--save_predictions"]),
    ("blip", "okvqa", ["--save_predictions"]),
    ("blip", "vqa", ["--fewshot", "--rices", "--shots", "3"]),
    ("blip", "classify", [])],
    ids=lambda v: v if isinstance(v, str) else
    "_".join(a.strip("-") for a in v if a.startswith("--")) or "plain")
def test_vl_eval_equals_jax(shared, family, task, flags, capsys):
    argv = shared[family] + ["--task", task] + task_flags(shared, task)
    preds = None
    if "--save_predictions" in flags:
        flags = [f for f in flags if f != "--save_predictions"]
        preds = os.path.join(shared["root"], f"{family}_{task}.json")
        argv += ["--save_predictions", preds]
    argv += flags
    want = jcli.main(argv)
    written = []
    if preds:
        with open(preds) as f:
            written.append(json.load(f))
        os.remove(preds)
    got = tcli.main(argv, device="cpu")
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == [want, got]
    assert got == want and got["n"] == N
    if preds:
        with open(preds) as f:
            written.append(json.load(f))
        assert written[1] == written[0] and len(written[0]) == N


def test_cache_features_and_cached_retrieval_equal_jax(shared, capsys):
    """cli/cache_features writes the same index in both packages (within
    2e-5: a feature is a float vector); vl_eval --rices on the port's file
    retrieves the same examples."""
    out = {}
    for name, main in (("jax", jcache.main), ("port", tcache.main)):
        path = os.path.join(shared["root"], f"feats_{name}")
        argv = (shared["flamingo"] + ["--task", "vqa", "--output", path]
                + task_flags(shared, "vqa"))
        res = (main(argv) if name == "jax" else main(argv, device="cpu"))
        assert res["output"] == path + ".npz" and res["n"] == N
        out[name] = np.load(path + ".npz")["features"]
    np.testing.assert_allclose(out["port"], out["jax"], rtol=2e-5,
                               atol=2e-5)
    capsys.readouterr()
    argv = (shared["flamingo"] + ["--task", "caption", "--rices",
                                  "--cached_features",
                                  os.path.join(shared["root"],
                                               "feats_port.npz")]
            + task_flags(shared, "caption"))
    want, got = both(jcli.main, tcli.main, argv, capsys)
    assert got == want and "rices_example" in got


def test_blip_npz_checkpoint_loads_as_the_state_dict(shared, tmp_path):
    """A converted tree saved as npz under flat a/b/c keys loads into the
    same weights as the state dict it came from."""
    from deer_vla_tpu_torch.eval.eval_models import _load_blip_checkpoint
    pt = shared["blip"][shared["blip"].index("--evaluate_from_checkpoint")
                        + 1]
    tree = _load_blip_checkpoint(pt, tblip.blip_tiny())
    flat = {"/".join(k): v.numpy() for k, v in flat_leaves(tree).items()}
    path = str(tmp_path / "blip.npz")
    np.savez(path, **flat)
    back = flat_leaves(_load_blip_checkpoint(path, tblip.blip_tiny()))
    assert back.keys() == flat_leaves(tree).keys()
    for k, v in flat_leaves(tree).items():
        np.testing.assert_array_equal(back[k], v.numpy())
    assert isinstance(_load_blip_checkpoint(path, tblip.blip_tiny())[
        "vision"]["blocks"], list)


@pytest.mark.parametrize("argv,match", [
    (["--task", "classify"], "needs --labels"),
    (["--task", "hateful_memes"], "needs --annotations"),
    (["--task", "vqa", "--debug", "--fewshot", "--shots", "8"],
     "1 <= --shots < num samples"),
    (["--task", "vqa", "--debug", "--fewshot", "--rices",
      "--cached_features", "FEATS"], "resolvable samples"),
    (["--tokenizer_path", "tok"], "M9 \\(a transformers tokenizer\\)"),
    (["--eval_model", "blip", "--tokenizer_path", "tok"], "M9")])
def test_vl_eval_refusals(argv, match, tmp_path):
    feats = str(tmp_path / "feats.npz")
    np.savez(feats, features=np.eye(8, 64, dtype=np.float32))
    argv = [feats if a == "FEATS" else a for a in argv]
    with pytest.raises(SystemExit, match=match):
        tcli.main(argv + ["--num_samples", "4"], device="cpu")


@pytest.mark.parametrize("task", ["caption", "flickr", "vqa", "textvqa",
                                  "vizwiz", "okvqa", "classify", "imagenet",
                                  "hateful_memes"])
def test_debug_fixture_runs_every_task(task, capsys):
    """--debug writes PPM frames the port reads without PIL, for every
    task, flamingo and BLIP."""
    for family in ("flamingo", "blip"):
        res = tcli.main(["--task", task, "--debug", "--eval_model", family,
                         "--num_samples", "4", "--precision", "fp32"],
                        device="cpu")
        assert res["task"] == task and res["n"] == 4
        assert 0.0 <= res["score"] <= 10.0
    assert capsys.readouterr().out.count('"task"') == 2
