"""PyTorch port, the vision-language harness's host side against the JAX
package: every metric of ``eval/vl_eval.py`` bit for bit on a fixed table
of strings, the continuation mask, RICES retrieval, the BLIP hash
tokenizer, the image reader (binary PPM by numpy, PIL's bicubic filter
copied; held to PIL) and the datasets of ``data/vl_dataset.py`` read by
both packages from one directory of PPM frames (PIL reads PPM too).
"""

import json
import os

import numpy as np
import pytest

from deer_vla_tpu.data import vl_dataset as jds
from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu.eval import eval_models as jem
from deer_vla_tpu.eval import vl_eval as jvl
from deer_vla_tpu_torch.data import vl_dataset as tds
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.eval import eval_models as tem
from deer_vla_tpu_torch.eval import vl_eval as tvl

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ANSWERS = ["The red block", "red block", "two", "2", "dont know",
           "don't know", "1,000", "3.5", "yes.", "red, white", "riding",
           "rides", "cities", "glass", "Gloves!", "firefighting", "  a  ",
           "none", "It's ten o'clock", "ride Question: what", "dogs",
           "Answer: cat, dog", "Short answer: yes", "the (big) [dog]",
           "x-ray", "well;", "@home", "1/2", "hes", "y'allll", "Im",
           "3.0.1", "a.b", "", "\tTabbed\nline"]
REFS = [["red block"] * 10, ["red"] * 3 + ["blue"] * 7, ["red"] + ["blue"] * 9,
        ["2"] * 10, ["don't know"] * 10, ["red"], [], ["rides"] * 10,
        ["dogs"] * 5 + ["dog"] * 5, ["glove", "gloves", "mittens"]]


def test_text_metrics_bit_equal():
    for a in ANSWERS:
        for fn in ("normalize_answer", "vqa_normalize",
                   "postprocess_vqa_generation", "okvqa_stem"):
            assert getattr(tvl, fn)(a) == getattr(jvl, fn)(a), (fn, a)
        for refs in REFS:
            for fn in ("vqa_accuracy", "okvqa_accuracy", "caption_bleu1"):
                got, want = getattr(tvl, fn)(a, refs), getattr(jvl, fn)(a,
                                                                      refs)
                assert got == want and type(got) is type(want), (fn, a, refs)


def test_corpus_metrics_bit_equal():
    preds = ["a red block on the table", "the cat", "", "dog dog dog",
             "a synthetic object 3", "two small red blocks"]
    refs = [["red block on a table", "a red cube"], ["a cat"], ["nothing"],
            ["dog"], ["a synthetic object 3", "the object 3 photo"],
            ["two red blocks", "small blocks"]]
    for n in range(len(preds) + 1):
        assert tvl.cider_d(preds[:n], refs[:n]) == jvl.cider_d(preds[:n],
                                                               refs[:n])
    r = np.random.RandomState(0)
    for labels, scores in (([1, 0, 1, 0], [0.9, 0.1, 0.9, 0.5]),
                           ([1, 1], [0.2, 0.3]),
                           (r.randint(0, 2, 50), r.rand(50).round(1))):
        assert tvl.roc_auc(labels, scores) == jvl.roc_auc(labels, scores)


def test_masks_and_retrieval_equal():
    r = np.random.RandomState(1)
    mask = (np.arange(9)[None] < r.randint(3, 10, (4, 1))).astype(np.int32)
    pmask = (np.arange(9)[None] < r.randint(1, 4, (4, 1))).astype(np.int32)
    for trailing in (0, 2):
        np.testing.assert_array_equal(
            tvl.continuation_target_mask(mask, pmask, trailing),
            jvl.continuation_target_mask(mask, pmask, trailing))
    q = r.randn(5, 8).astype(np.float32)
    index = r.randn(11, 8).astype(np.float32)
    for k in (1, 3, 11):
        np.testing.assert_array_equal(tvl.rices_retrieve(q, index, k),
                                      jvl.rices_retrieve(q, index, k))


def test_blip_hash_tokenizer_equal():
    want = jem.BlipHashTokenizer(30524, 30522, 102, 0)
    got = tem.BlipHashTokenizer(30524, 30522, 102, 0)
    texts = ["A photo of", "Question:what is it? Short answer:", "x"]
    for w, g in zip(want(texts), got(texts)):
        np.testing.assert_array_equal(g, w)
    row = [30522, 5, 102, 0, 77]
    assert got.decode(row) == want.decode(row)
    assert tem.decode_row(got, row, 102) == jem._decode_row(want, row, 102)
    flam = HashTokenizer(vocab_size=128)
    assert tem.decode_row(flam, [3, 4, 0, 9], 0) == jem._decode_row(
        JaxTokenizer(vocab_size=128), [3, 4, 0, 9], 0) == "3 4"


@pytest.mark.parametrize("hw", [(32, 32), (40, 17), (200, 200), (7, 9)])
def test_ppm_and_bicubic_equal_pil(tmp_path, hw):
    """The PPM writer / reader and PIL's bicubic filter copied, against PIL
    bit for bit, down- and upsampling."""
    from PIL import Image
    img = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,), np.uint8)
    path = str(tmp_path / "f.ppm")
    tds.write_ppm(path, img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(path).convert("RGB")), img)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(tds.read_ppm(f.read()), img)
    for size in (5, 24, 28, 32, 224, 384):
        want = np.asarray(Image.fromarray(img).resize((size, size),
                                                      Image.BICUBIC))
        np.testing.assert_array_equal(tds.pil_bicubic_resize(img, size),
                                      want)
        np.testing.assert_array_equal(tds._load_image(path, size),
                                      jds._load_image(path, size))


def test_ppm_header_comments_and_jpeg(tmp_path):
    from PIL import Image
    img = np.random.RandomState(3).randint(0, 256, (6, 5, 3), np.uint8)
    data = b"P6 # written by hand\n5 6\n# maxval next\n255\n" + img.tobytes()
    np.testing.assert_array_equal(tds.read_ppm(data), img)
    with pytest.raises(ValueError, match="8-bit binary PPM"):
        tds.read_ppm(b"P3\n1 1\n255\n0 0 0")
    jpg = str(tmp_path / "f.jpg")
    Image.fromarray(img).save(jpg)
    np.testing.assert_array_equal(tds._load_image(jpg, 16),
                                  jds._load_image(jpg, 16))


def write_fixture(root, n=6):
    """A PPM directory both packages read: COCO captions, Karpathy json,
    VQAv2 questions (COCO file names) and answers."""
    img_dir = os.path.join(root, "val2014")
    os.makedirs(img_dir)
    r = np.random.RandomState(7)
    images, anns, karp, questions, answers = [], [], [], [], []
    for i in range(n):
        frame = r.randint(0, 256, (20 + i, 30, 3), np.uint8)
        fn = f"COCO_val2014_{i:012d}.jpg"  # VQAv2's naming, PPM inside
        tds.write_ppm(os.path.join(img_dir, fn), frame)
        images.append({"id": i, "file_name": fn})
        anns += [{"image_id": i, "caption": f"thing {i}"},
                 {"image_id": i, "caption": f"another view {i}"}]
        karp.append({"filename": fn, "split": "test" if i % 3 else "train",
                     "cocoid": 100 + i,
                     "sentences": [{"raw": f"thing {i}"}, {"raw": "x"}]})
        questions.append({"question": f"what is {i}?", "question_id": i,
                          "image_id": i})
        answers.append({"answers": [{"answer": "red"}, {"answer": f"{i}"}]})
    paths = {}
    for name, obj in (("coco", {"images": images, "annotations": anns}),
                      ("karpathy", {"images": karp}),
                      ("q", {"questions": questions}),
                      ("a", {"annotations": answers})):
        paths[name] = os.path.join(root, name + ".json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return img_dir, paths


def same_batches(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_datasets_and_loader_equal_jax(tmp_path):
    img_dir, p = write_fixture(str(tmp_path))
    tok = HashTokenizer(max_length=16)
    pairs = [
        (tds.CaptionDataset(img_dir, p["coco"], image_size=24),
         jds.CaptionDataset(img_dir, p["coco"], image_size=24)),
        (tds.VQADataset(img_dir, p["q"], p["a"], image_size=28),
         jds.VQADataset(img_dir, p["q"], p["a"], image_size=28))]
    for name in ("flickr", "coco"):
        for train in (False, True):
            pairs.append((tds.KarpathyCaptionDataset(
                img_dir, p["karpathy"], name, train, 16),
                jds.KarpathyCaptionDataset(
                    img_dir, p["karpathy"], name, train, 16)))
    for t, j in pairs:
        assert len(t) == len(j) > 0
        for i in range(len(t)):
            st, sj = t[i], j[i]
            assert st.keys() == sj.keys()
            for k in st:
                np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
        same_batches(t.collate([t[0], t[-1]], tok),
                     j.collate([j[0], j[-1]], tok))
    t, j = pairs[0]
    for epoch in (0, 1):
        lt = tds.VLLoader(t, tok, batch_size=2, seed=3)
        lj = jds.VLLoader(j, tok, batch_size=2, seed=3)
        lt.set_epoch(epoch)
        lj.set_epoch(epoch)
        assert len(lt) == len(lj) == 3
        for bt, bj in zip(lt, lj):
            same_batches(bt, bj)


def test_debug_fixture_frames_read_as_pil_reads_them(tmp_path):
    """The frames cli/vl_eval --debug writes (PPM) read the same through
    the port's numpy reader and through PIL (the JAX package's reader), at
    the flamingo and BLIP sizes."""
    from types import SimpleNamespace

    from deer_vla_tpu_torch.cli.vl_eval import _synthetic_fixture
    args = SimpleNamespace(seed=42, num_samples=8, task="caption")
    img_dir = _synthetic_fixture(args, str(tmp_path))[0]
    frames = sorted(os.listdir(img_dir))
    assert len(frames) == 8 and all(f.endswith(".ppm") for f in frames)
    for fn in frames:
        path = os.path.join(img_dir, fn)
        for size in (24, 28, 224, 384):
            np.testing.assert_array_equal(tds._load_image(path, size),
                                          jds._load_image(path, size))
