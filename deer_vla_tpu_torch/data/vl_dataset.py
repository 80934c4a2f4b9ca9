"""Vision-language datasets (the JAX package's ``data/vl_dataset.py``):
COCO-style captions, Karpathy-split captions (Flickr30k / COCO) and
VQAv2-style questions, with a shuffled batch iterator.

Images load as uint8 (size, size, 3) on the host: a binary PPM (P6) is
parsed with numpy, any other file (the datasets' JPEGs) is decoded by PIL,
imported only there, as the card's machine has no PIL.  Both are resized by
``pil_bicubic_resize``, a copy of PIL's BICUBIC filter for 8-bit images
(Resample.c: a = -0.5, antialiased support, coefficients normalized to 22
fractional bits, the horizontal pass rounded to uint8 before the vertical
one), equal to ``Image.resize(..., Image.BICUBIC)`` bit for bit.  The
``--debug`` fixtures write PPM, which PIL reads too.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # Resample.c


def _bicubic(x: float) -> float:
    """PIL's bicubic filter, a = -0.5."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=64)
def _coeff_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) int64 fixed-point weights of one axis
    (Resample.c precompute_coeffs + normalize_coeffs_8bpc), in double
    arithmetic as there."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    mat = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            if ww != 0.0:
                v /= ww
            v *= 1 << _PRECISION_BITS
            mat[xx, xmin + x] = int(v - 0.5) if v < 0 else int(v + 0.5)
    return mat


def _pass(img: np.ndarray, mat: np.ndarray, axis: int) -> np.ndarray:
    """One axis of the resize: the fixed-point sum rounded and clipped to
    uint8 (clip8)."""
    acc = np.tensordot(img.astype(np.int64), mat, axes=([axis], [1]))
    acc = np.moveaxis(acc, -1, axis) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bicubic_resize(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, C) -> (size, size, C), as PIL's ``Image.resize((size,
    size), Image.BICUBIC)`` computes it: the horizontal pass first."""
    h, w = img.shape[:2]
    if w != size:
        img = _pass(img, _coeff_matrix(w, size), 1)
    if h != size:
        img = _pass(img, _coeff_matrix(h, size), 0)
    return img


def write_ppm(path: str, img: np.ndarray) -> None:
    """uint8 (H, W, 3) -> binary PPM (P6, maxval 255)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def read_ppm(data: bytes) -> np.ndarray:
    """A binary PPM (P6, maxval 255; '#' comments in the header) -> uint8
    (H, W, 3)."""
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), \
        int(fields[3])
    if magic != b"P6" or maxval != 255:
        raise ValueError(f"not an 8-bit binary PPM: {magic!r} {maxval}")
    pos += 1  # the one whitespace byte before the raster
    raster = np.frombuffer(data, np.uint8, 3 * w * h, pos)
    return raster.reshape(h, w, 3)


def _load_image(path: str, size: int) -> np.ndarray:
    """uint8 (size, size, 3): PPM by numpy, anything else by PIL, resized
    with PIL's bicubic filter."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        img = read_ppm(data)
    else:
        import io

        from PIL import Image
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                         np.uint8)
    return pil_bicubic_resize(img, size)


class CaptionDataset:
    """COCO-caption style: an annotations json with images[] and
    annotations[]."""

    def __init__(self, image_dir: str, annotations_path: str, seed: int = 123,
                 image_size: int = 224):
        self.image_dir = image_dir
        self.image_size = image_size
        self._rng = np.random.RandomState(seed)
        with open(annotations_path) as f:
            full = json.load(f)
        self.id2path = {im["id"]: os.path.join(image_dir, im["file_name"])
                        for im in full["images"]}
        self.id2caption: Dict[int, List[str]] = {}
        for ann in full["annotations"]:
            self.id2caption.setdefault(ann["image_id"], []).append(
                ann["caption"])
        self.image_ids = list(self.id2path.keys())

    def __len__(self):
        return len(self.image_ids)

    @staticmethod
    def get_caption_prompt(caption: Optional[str] = None) -> str:
        return f"A photo of {caption if caption is not None else ''}"

    def __getitem__(self, idx: int) -> Dict:
        iid = self.image_ids[idx]
        caps = self.id2caption[iid]
        return {"image": _load_image(self.id2path[iid], self.image_size),
                "caption": caps[self._rng.randint(len(caps))],
                "image_id": iid}

    def collate(self, samples: Sequence[Dict], text_fn: Callable) -> Dict:
        images = np.stack([s["image"] for s in samples])
        ids, mask = text_fn([self.get_caption_prompt(s["caption"])
                             for s in samples])
        return {"image": images, "input_ids": ids, "attention_mask": mask}


class KarpathyCaptionDataset:
    """Karpathy-split caption json (Flickr30k / COCO): one ``images`` list
    with ``sentences[].raw``, ``split`` and ``filename`` an image
    (open_flamingo eval_datasets.py:11-64): the caption is
    ``sentences[0].raw``, the image id ``cocoid`` for COCO and the file
    name's stem for Flickr; ``split`` selects train or test entries."""

    def __init__(self, image_dir: str, annotations_path: str,
                 dataset_name: str = "flickr", is_train: bool = False,
                 image_size: int = 224):
        self.image_dir = image_dir
        self.dataset_name = dataset_name
        self.image_size = image_size
        want = "train" if is_train else "test"
        with open(annotations_path) as f:
            self.annotations = [a for a in json.load(f)["images"]
                                if a.get("split", want) == want]

    def __len__(self):
        return len(self.annotations)

    get_caption_prompt = staticmethod(CaptionDataset.get_caption_prompt)

    def __getitem__(self, idx: int) -> Dict:
        a = self.annotations[idx]
        if self.dataset_name == "coco":
            image_id = a["cocoid"]
        else:
            image_id = os.path.splitext(a["filename"])[0]
        return {"image": _load_image(
                    os.path.join(self.image_dir, a["filename"]),
                    self.image_size),
                "caption": a["sentences"][0]["raw"],
                "captions": [s["raw"] for s in a["sentences"]],
                "image_id": image_id}

    collate = CaptionDataset.collate


class VLLoader:
    """Shuffled batch iterator over a caption / VQA dataset.  With
    ``world_size`` > 1 a global batch holds ``batch_size`` rows a process,
    drawn from one shuffled order, and process ``rank`` takes its
    contiguous ``batch_size`` of them."""

    def __init__(self, dataset, text_fn: Callable, batch_size: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 rank: int = 0, world_size: int = 1):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside [0, {world_size})")
        self.ds = dataset
        self.text_fn = text_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0

    def set_epoch(self, e: int):
        self.epoch = e

    def __len__(self):
        return len(self.ds) // (self.batch_size * self.world_size)

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        global_bs = self.batch_size * self.world_size
        for b in range(len(self)):
            start = b * global_bs + self.rank * self.batch_size
            idxs = order[start:start + self.batch_size]
            yield self.ds.collate([self.ds[int(i)] for i in idxs],
                                  self.text_fn)


class VQADataset:
    """VQAv2-style questions and annotations jsons; the image file name by
    dataset (eval_datasets.py:85-97)."""

    def __init__(self, image_dir: str, question_path: str,
                 annotations_path: Optional[str] = None, seed: int = 123,
                 dataset_name: str = "vqav2", is_train: bool = True,
                 image_size: int = 224):
        with open(question_path) as f:
            self.questions = json.load(f)["questions"]
        self.answers = None
        if annotations_path:
            with open(annotations_path) as f:
                self.answers = json.load(f)["annotations"]
        self.image_dir = image_dir
        self.dataset_name = dataset_name
        self.is_train = is_train
        self.image_size = image_size
        self._rng = np.random.RandomState(seed)
        if dataset_name in {"vqav2", "ok_vqa"}:
            self.img_coco_split = image_dir.strip("/").split("/")[-1]

    def __len__(self):
        return len(self.questions)

    def get_img_path(self, question: Dict) -> str:
        if self.dataset_name in {"vqav2", "ok_vqa"}:
            return os.path.join(
                self.image_dir,
                f"COCO_{self.img_coco_split}_{question['image_id']:012d}.jpg")
        if self.dataset_name == "vizwiz":
            return os.path.join(self.image_dir, question["image_id"])
        if self.dataset_name == "textvqa":
            return os.path.join(self.image_dir, f"{question['image_id']}.jpg")
        raise ValueError(self.dataset_name)

    @staticmethod
    def get_vqa_prompt(question: str, answer: Optional[str] = None) -> str:
        return (f"Question:{question} Short answer:"
                f"{answer if answer is not None else ''}")

    def __getitem__(self, idx: int) -> Dict:
        q = self.questions[idx]
        out = {"image": _load_image(self.get_img_path(q), self.image_size),
               "question": q["question"], "question_id": q["question_id"]}
        if self.answers is not None:
            out["answers"] = [a["answer"]
                              for a in self.answers[idx]["answers"]]
        return out

    def collate(self, samples: Sequence[Dict], text_fn: Callable) -> Dict:
        """With ``answer_mask`` marking the answer tokens only (the loss
        mask, vl_dataset.py:138-147)."""
        images = np.stack([s["image"] for s in samples])
        texts = [self.get_vqa_prompt(
            s["question"], s["answers"][self._rng.randint(len(s["answers"]))])
            for s in samples]
        ids, mask = text_fn(texts)
        _, qmask = text_fn([self.get_vqa_prompt(s["question"])
                            for s in samples])
        t = mask.shape[1]
        qlen = qmask.sum(1)
        # answers start where the question prompt ends, less its trailing
        # specials (<eoc><eos>)
        idxs = np.arange(t)[None, :]
        answer_mask = ((idxs >= np.maximum(qlen - 2, 0)[:, None])
                       & (mask > 0)).astype(np.int32)
        return {"image": images, "input_ids": ids, "attention_mask": mask,
                "answer_mask": answer_mask}
