"""Webdataset-format readers for interleaved VL pretraining, LAION and MMC4
(the JAX package's ``data/webdataset.py``; upstream
open_flamingo/train/data.py):

  * LAION shards: tar members ``{key}.jpg`` + ``{key}.txt``, a caption
    sample ``<image>{caption}<|endofchunk|>`` (data.py:56-72);
  * MMC4 shards: ``{key}.json`` with ``text_list``, ``similarity_matrix``
    and base64 images in ``image_info``; each kept image goes before the
    sentence the optimal (Hungarian) assignment gives it, above a
    similarity threshold (data.py:138-270).

Shards stream through ``tarfile``; processes take disjoint shards, whose
order is reshuffled each epoch from a seed, and a thread prefetches
batches.  The 50% single-image drop (data.py:245-249) hashes the sample's
text, so it is deterministic.

Images decode without PIL where they can (the card's machine has none): a
PNG through ``zlib`` and numpy, all five PNG row filters undone (PIL's
encoder picks a filter a row); a binary PPM by numpy; anything else (the
datasets' JPEGs) by PIL, imported only there.  A resize is
``vl_dataset.pil_bicubic_resize``, PIL's bicubic filter bit for bit.  A
missing decoder or a corrupt image raises: only the reference's own
filters (no caption, no image, under the size or similarity threshold,
too few images, the single-image drop) skip a sample.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import os
import queue
import struct
import tarfile
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deer_vla_tpu_torch.data.vl_dataset import pil_bicubic_resize, read_ppm

MIN_KB = 10
N_CHANNELS = 3
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples a pixel (8-bit depth)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ---------------------------------------------------------------------------
# tar streaming
# ---------------------------------------------------------------------------


def iter_tar_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Consecutive tar members grouped by sample key (the basename before
    its first dot), the webdataset convention: {extension: bytes}."""
    cur_key: Optional[str] = None
    cur: Dict[str, bytes] = {}
    with tarfile.open(path, "r|*") as tf:
        for member in tf:
            if not member.isfile():
                continue
            key, _, ext = os.path.basename(member.name).partition(".")
            if cur_key is not None and key != cur_key and cur:
                yield cur
                cur = {}
            cur_key = key
            data = tf.extractfile(member)
            if data is not None:
                cur[ext.lower()] = data.read()
        if cur:
            yield cur


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of
    ``height`` rows of a filter byte and ``stride`` bytes each."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: left to right
            up = prior.tolist()
            vals = line.tolist()
            rec = [0] * stride
            for x in range(stride):
                a = rec[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else \
                        (b if pb <= pc else c)
                rec[x] = (vals[x] + pred) & 0xFF
            cur = np.asarray(rec, np.int64)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        cur = cur & 0xFF
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced PNG (gray, RGB, palette, gray + alpha,
    RGBA) -> uint8 (H, W, 3), as PIL's ``convert("RGB")`` gives it (alpha
    dropped, gray replicated, the palette looked up).  Raises ValueError
    on anything else or a corrupt file."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or \
                zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: depth {depth}, color type "
                         f"{color}, interlace {interlace}")
    bpp = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"PNG data of {raw.size} bytes for {w}x{h}")
    px = _unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3) -> an RGB PNG, every row filter None."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def _decode_image(raw: bytes, size: int) -> np.ndarray:
    """Image bytes -> uint8 (size, size, 3): PNG and PPM by numpy, any
    other format by PIL; resized with PIL's bicubic filter."""
    if raw[:8] == PNG_SIGNATURE:
        img = decode_png(raw)
    elif raw[:2] == b"P6":
        img = read_ppm(raw)
    else:
        from PIL import Image
        img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"),
                         np.uint8)
    return pil_bicubic_resize(img, size)


# ---------------------------------------------------------------------------
# sample decoders
# ---------------------------------------------------------------------------


def decode_laion_sample(sample: Dict[str, bytes], image_size: int
                        ) -> Optional[Dict]:
    """(jpg | png | jpeg) + txt -> a one-image caption sample, or None
    without a caption or an image (filter_no_caption_or_no_image +
    preprocess_laion_text, data.py:47-72)."""
    raw = sample.get("jpg") or sample.get("png") or sample.get("jpeg")
    txt = sample.get("txt")
    if raw is None or txt is None:
        return None
    caption = txt.decode("utf-8", "replace").strip()
    if not caption:
        return None
    return {"images": _decode_image(raw, image_size)[None],
            "text": f"<image>{caption}<|endofchunk|>"}


def _assignment(sim: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The one-to-one image -> sentence assignment of most similarity
    (linear_sum_assignment on -sim, data.py:181-185)."""
    from scipy.optimize import linear_sum_assignment
    return linear_sum_assignment(-sim)


def _sample_hash01(text: str) -> float:
    h = int.from_bytes(hashlib.md5(text.encode()).digest()[:4], "little")
    return h / 2.0 ** 32


def decode_mmc4_sample(sample: Dict[str, bytes], image_size: int, *,
                       sim_threshold: float = 0.24, min_num_images: int = 1,
                       max_num_images: int = 6) -> Optional[Dict]:
    """MMC4 interleaved json -> a multi-image sample (preprocess_interleaved,
    data.py:138-270): {images (max_num_images, size, size, 3), text,
    n_images}, or None where the reference filters the sample out."""
    raw = sample.get("json")
    if raw is None:
        return None
    info = json.loads(raw)
    sentences = info.get("text_list")
    sim_matrix = info.get("similarity_matrix")
    image_info = info.get("image_info")
    if not sentences or sim_matrix is None or not image_info:
        return None

    valid_images, valid_idx = [], []
    for i, im in enumerate(image_info):
        b64 = im.get("image_base64")
        if b64 is None:
            continue
        rawbytes = base64.b64decode(b64)
        if len(rawbytes) // 1000 <= MIN_KB and len(image_info) > 1:
            continue  # the >10 KB filter (data.py:168-170)
        valid_images.append(_decode_image(rawbytes, image_size))
        valid_idx.append(i)
    if not valid_idx:
        return None

    sim = np.asarray(sim_matrix, np.float32)[valid_idx]  # (imgs, sents)
    img_ix, sent_ix = _assignment(sim)
    images, sentence_ixs = [], []
    for i, j in zip(img_ix, sent_ix):
        if sim[i, j] < sim_threshold:
            continue
        images.append(valid_images[i])
        sentence_ixs.append(int(j))
    if not images:
        return None

    keep = min(len(images), max_num_images)
    order = np.argsort(sentence_ixs)[:keep]  # document order
    images = [images[k] for k in order]
    sentence_ixs = [sentence_ixs[k] for k in order]

    sentences = list(sentences)
    for ix in sentence_ixs:
        sentences[ix] = f"<|endofchunk|><image>{sentences[ix]}"
    text = " ".join(sentences)
    text = text.replace("<|endofchunk|>", "", 1)  # no leading eoc
    text = (text.replace(" <|endofchunk|>", "<|endofchunk|>")
            .replace("<image> ", "<image>").replace(" <image>", "<image>"))
    text = f"{text}<|endofchunk|>"

    n_img = len(images)
    if n_img < min_num_images:
        return None
    if n_img == 1 and _sample_hash01(text) <= 0.5:
        return None  # the 50% single-image drop, deterministic
    arr = np.zeros((max_num_images, image_size, image_size, N_CHANNELS),
                   np.uint8)
    arr[:n_img] = np.stack(images)
    return {"images": arr, "text": text, "n_images": n_img}


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


class WebLoader:
    """Batches of webdataset tar shards, seeded and split by rank.

    kind 'laion' (one image a sample) or 'mmc4' (interleaved).  Batches:
    {"image": (B, T, H, W, 3) uint8, "input_ids": (B, S) int32,
    "attention_mask": (B, S) int32}; ``prepare_interleaved_batch`` makes
    the model's vision input of them.  A decode error in the prefetch
    thread raises in the iterating thread."""

    def __init__(self, shards: Sequence[str], tokenizer, *, kind: str,
                 batch_size: int, image_size: int = 224,
                 max_tokens: int = 256, rank: int = 0, world_size: int = 1,
                 seed: int = 0, sim_threshold: float = 0.24,
                 min_num_images: int = 1, max_num_images: int = 6,
                 prefetch: int = 2):
        if kind not in ("laion", "mmc4"):
            raise ValueError(f"kind {kind!r}: 'laion' or 'mmc4'")
        if len(shards) < world_size:
            raise ValueError(f"{len(shards)} shards for {world_size} "
                             "processes: need at least one shard a process")
        self.shards = sorted(shards)
        self.tok = tokenizer
        self.kind = kind
        self.batch_size = batch_size
        self.image_size = image_size
        self.max_tokens = max_tokens if kind == "mmc4" else 32
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.sim_threshold = sim_threshold
        self.min_num_images = min_num_images
        self.max_num_images = max_num_images
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, e: int) -> None:
        self.epoch = e

    def _epoch_shards(self) -> List[str]:
        order = np.random.RandomState(self.seed + self.epoch).permutation(
            len(self.shards))
        mine = [self.shards[i] for i in order]
        return mine[self.rank::self.world_size]

    def _iter_samples(self) -> Iterator[Dict]:
        for shard in self._epoch_shards():
            for raw in iter_tar_samples(shard):
                if self.kind == "laion":
                    s = decode_laion_sample(raw, self.image_size)
                else:
                    s = decode_mmc4_sample(
                        raw, self.image_size,
                        sim_threshold=self.sim_threshold,
                        min_num_images=self.min_num_images,
                        max_num_images=self.max_num_images)
                if s is not None:
                    yield s

    def _make_batch(self, samples: List[Dict]) -> Dict:
        t = 1 if self.kind == "laion" else self.max_num_images
        imgs = np.zeros((len(samples), t, self.image_size, self.image_size,
                         N_CHANNELS), np.uint8)
        for i, s in enumerate(samples):
            imgs[i, :s["images"].shape[0]] = s["images"]
        ids, mask = self.tok.encode_raw([s["text"] for s in samples],
                                        self.max_tokens)
        return {"image": imgs, "input_ids": ids, "attention_mask": mask}

    def __iter__(self) -> Iterator[Dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                buf: List[Dict] = []
                for s in self._iter_samples():
                    buf.append(s)
                    if len(buf) == self.batch_size:
                        if not put(self._make_batch(buf)):
                            return
                        buf = []
                put(None)
            except BaseException as e:  # re-raised by the consumer
                put(e)

        th = threading.Thread(target=produce, daemon=True)
        th.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()


class WebVLLoader:
    """A 'laion' ``WebLoader`` as the co-training VL source (``cli/train
    --cotrain_laion_shards``): one-image uint8 batches {image (B, H, W, 3),
    input_ids, attention_mask} that ``trainer.prepare_vl_batch`` takes."""

    def __init__(self, web: WebLoader):
        if web.kind != "laion":
            raise ValueError("the co-training adapter takes one-image "
                             "'laion' shards")
        self.web = web

    def set_epoch(self, e: int) -> None:
        self.web.set_epoch(e)

    def __iter__(self):
        for b in self.web:
            yield {"image": b["image"][:, 0],
                   "input_ids": b["input_ids"],
                   "attention_mask": b["attention_mask"]}


def prepare_interleaved_batch(batch: Dict, size: int = 224, device=None,
                              dtype=None):
    """uint8 (B, T, H, W, 3) -> (B, T, 1, 3, size, size) normalized on
    ``device`` (the images' own when None): the vision input of
    ``pretrain.lm_loss``."""
    import torch

    from deer_vla_tpu_torch.data.preprocess import clip_preprocess
    img = torch.as_tensor(np.asarray(batch["image"]), device=device)
    b, t = img.shape[:2]
    x = clip_preprocess(img.reshape((b * t,) + tuple(img.shape[2:])), size,
                        dtype if dtype is not None else torch.float32)
    return x.reshape(b, t, 1, *x.shape[1:])


# ---------------------------------------------------------------------------
# synthetic shards (tests and smoke runs: the --debug of pretraining)
# ---------------------------------------------------------------------------


def _png_bytes(rng: np.random.RandomState, hw: int, pad_to_kb: int = 0
               ) -> bytes:
    raw = encode_png(rng.randint(0, 255, (hw, hw, 3), np.uint8))
    if pad_to_kb and len(raw) < pad_to_kb * 1000:
        # a PNG ends at IEND; the padding passes the size filter
        raw += b"\0" * (pad_to_kb * 1000 - len(raw) + 1)
    return raw


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    ti = tarfile.TarInfo(name)
    ti.size = len(data)
    tf.addfile(ti, io.BytesIO(data))


def write_synthetic_laion_shard(path: str, n: int = 8, hw: int = 64,
                                seed: int = 0) -> None:
    """``n`` caption samples of random ``hw`` px PNG images (named .jpg,
    as the JAX package writes them)."""
    rng = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            key = f"{i:09d}"
            _add(tf, f"{key}.jpg", _png_bytes(rng, hw))
            _add(tf, f"{key}.txt", f"a synthetic photo number {i}".encode())


def write_synthetic_mmc4_shard(path: str, n: int = 4, hw: int = 64,
                               n_images: int = 2, n_sentences: int = 4,
                               seed: int = 0) -> None:
    """``n`` interleaved samples of ``n_images`` random PNG images (padded
    past the size filter) and ``n_sentences`` sentences, with a random
    similarity matrix."""
    rng = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            sim = rng.rand(n_images, n_sentences).tolist()
            info = {
                "text_list": [f"sentence {i} {j} words here"
                              for j in range(n_sentences)],
                "similarity_matrix": sim,
                "image_info": [
                    {"image_base64": base64.b64encode(
                        _png_bytes(rng, hw, pad_to_kb=MIN_KB + 1)).decode()}
                    for _ in range(n_images)],
            }
            _add(tf, f"{i:09d}.json", json.dumps(info).encode())
