"""PyTorch port, the webdataset readers of VL pretraining
(``data/webdataset.py``, ROADMAP M16b) against the JAX package's on the
CPU: shards the JAX package writes decode in the port exactly as JAX
decodes them (JAX through PIL, the port through zlib and numpy), the
port's writer gives JAX's writer's pixels for a seed, ``WebLoader``
batches are JAX's (images, ids, masks) by rank and epoch, and a decode
failure raises where JAX drops the sample.

Tolerances: images, ids, masks and texts bit for bit; the CLIP-normalized
batches within 2e-5 absolute (tests/test_torch_calibrate.py's pixel
tolerance: both sides sum the same fp32 products in other orders).
"""

import base64
import io
import json
import sys
import tarfile
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.data import webdataset as jwds
from deer_vla_tpu.data.text import HashTokenizer as JaxTokenizer
from deer_vla_tpu.train import trainer as jtrainer
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.data import webdataset as twds
from deer_vla_tpu_torch.data.text import HashTokenizer
from deer_vla_tpu_torch.train import trainer as ttrainer

PIXEL_ATOL = 2e-5


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """JAX-written shards: three LAION, one MMC4 (48 px), and the port's
    with the same seeds."""
    d = tmp_path_factory.mktemp("wds")
    out = {"jax_laion": [], "port_laion": []}
    for i in range(3):
        for side, mod in (("jax", jwds), ("port", twds)):
            p = str(d / f"{side}-laion-{i:05d}.tar")
            mod.write_synthetic_laion_shard(p, n=6, hw=48, seed=i)
            out[f"{side}_laion"].append(p)
    for side, mod in (("jax", jwds), ("port", twds)):
        p = str(d / f"{side}-mmc4-00000.tar")
        mod.write_synthetic_mmc4_shard(p, n=8, hw=48, n_images=3,
                                       n_sentences=5, seed=7)
        out[f"{side}_mmc4"] = [p]
    return out


def decoded(mod, path, kind, size, **kw):
    dec = mod.decode_laion_sample if kind == "laion" else \
        mod.decode_mmc4_sample
    return [dec(raw, size, **kw) for raw in mod.iter_tar_samples(path)]


def assert_same_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g["text"] == w["text"]
            assert g.get("n_images") == w.get("n_images")
            np.testing.assert_array_equal(g["images"], w["images"])


@pytest.mark.parametrize("size", [48, 64, 32])
def test_jax_written_shards_decode_as_jax_decodes_them(shards, size):
    """Native size, PIL's bicubic up and down."""
    for path in shards["jax_laion"]:
        assert_same_samples(decoded(twds, path, "laion", size),
                            decoded(jwds, path, "laion", size))
    for thr, mx in ((0.0, 4), (0.24, 6), (0.6, 2)):
        kw = dict(sim_threshold=thr, max_num_images=mx)
        want = decoded(jwds, shards["jax_mmc4"][0], "mmc4", size, **kw)
        assert_same_samples(
            decoded(twds, shards["jax_mmc4"][0], "mmc4", size, **kw), want)
    assert any(w is not None for w in want)


@pytest.mark.parametrize("kind", ["laion", "mmc4"])
def test_port_writer_gives_jax_writers_pixels(shards, kind):
    kw = {} if kind == "laion" else dict(sim_threshold=0.0)
    for jp, tp in zip(shards[f"jax_{kind}"], shards[f"port_{kind}"]):
        assert_same_samples(decoded(twds, tp, kind, 48, **kw),
                            decoded(jwds, jp, kind, 48, **kw))
        # the port's PNGs are PNGs to PIL too
        from PIL import Image
        raw = next(twds.iter_tar_samples(tp))
        img = raw["jpg"] if kind == "laion" else base64.b64decode(
            json.loads(raw["json"])["image_info"][0]["image_base64"])
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(img)).convert("RGB")),
            twds.decode_png(img))


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_with_filter(img: np.ndarray, kind: int) -> bytes:
    """An RGB PNG whose every row carries filter ``kind`` (the forward
    filters of the PNG spec, on the original bytes)."""
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int64)
    left = np.concatenate([np.zeros((h, 3), np.int64), x[:, :-3]], axis=1)
    up = np.concatenate([np.zeros((1, w * 3), np.int64), x[:-1]], axis=0)
    upleft = np.concatenate([np.zeros((h, 3), np.int64), up[:, :-3]],
                            axis=1)
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
            4: paeth(left, up, upleft)}[kind]
    rows = np.concatenate([np.full((h, 1), kind), (x - pred) & 0xFF],
                          axis=1).astype(np.uint8)
    raw = twds.encode_png(img)
    # swap the IDAT of the filter-0 encoding for this one's
    head, tail = raw[:33], raw[-12:]
    body = zlib.compress(rows.tobytes())
    idat = (len(body).to_bytes(4, "big") + b"IDAT" + body
            + zlib.crc32(b"IDAT" + body).to_bytes(4, "big"))
    return head + idat + tail


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_decoder_undoes_every_row_filter(kind):
    r = np.random.RandomState(kind)
    img = r.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    img[:, :3] = np.arange(7 * 3, dtype=np.uint8).reshape(7, 3)[:3]
    data = png_with_filter(img, kind)
    from PIL import Image
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
    np.testing.assert_array_equal(twds.decode_png(data), img)


@pytest.mark.parametrize("mode", ["L", "P", "RGBA", "LA", "RGB"])
def test_png_color_types_decode_as_pil_converts_them(mode):
    """PIL's own PNGs (its encoder picks a row filter a row) of each color
    type, against PIL's convert('RGB')."""
    from PIL import Image
    g = (np.add.outer(np.arange(40), 3 * np.arange(52))[..., None]
         * np.array([1, 2, 3])).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(g).convert(mode).save(buf, format="PNG")
    data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(twds.decode_png(data), want)


@pytest.mark.parametrize("kind,rank,world,epoch", [
    ("laion", 0, 1, 0), ("laion", 0, 1, 1), ("laion", 0, 3, 0),
    ("laion", 2, 3, 1), ("mmc4", 0, 1, 0)])
def test_webloader_batches_match_jax(shards, kind, rank, world, epoch):
    tok, jtok = (t(vocab_size=512, max_length=32) for t in
                 (HashTokenizer, JaxTokenizer))
    kw = dict(kind=kind, batch_size=2, image_size=40, rank=rank,
              world_size=world, seed=5)
    if kind == "mmc4":
        kw.update(sim_threshold=0.0, max_num_images=3, max_tokens=48)
    paths = shards[f"jax_{kind}"]
    jl, tl = jwds.WebLoader(paths, jtok, **kw), twds.WebLoader(paths, tok,
                                                               **kw)
    jl.set_epoch(epoch)
    tl.set_epoch(epoch)
    assert tl._epoch_shards() == jl._epoch_shards()
    want, got = list(jl), list(tl)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def write_tar(path, members):
    with tarfile.open(path, "w") as tf:
        for name, data in members:
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))


def test_decode_failures_raise_where_jax_drops_the_sample(tmp_path,
                                                          monkeypatch):
    """A corrupt image, a missing decoder or bad json raises (JAX returns
    None and the sample is gone); the reference's own filters still
    return None; a failure in the loader's prefetch thread raises in the
    iterating thread."""
    good = twds.encode_png(np.zeros((8, 8, 3), np.uint8))
    bad_crc = good[:40] + bytes([good[40] ^ 1]) + good[41:]
    cases = {"bad_crc": bad_crc, "truncated": good[:-20],
             "garbage": b"\x89PNG\r\n\x1a\n" + b"\0" * 30}
    for name, data in cases.items():
        with pytest.raises(ValueError):
            twds.decode_laion_sample({"jpg": data, "txt": b"a caption"}, 8)
    # JAX drops what PIL cannot read
    assert jwds.decode_laion_sample({"jpg": cases["garbage"],
                                     "txt": b"a caption"}, 8) is None
    # no decoder for a JPEG: PIL absent raises ImportError, it drops nothing
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        twds.decode_laion_sample({"jpg": b"\xff\xd8\xff\xe0rest",
                                  "txt": b"x"}, 8)
    monkeypatch.undo()
    with pytest.raises(json.JSONDecodeError):
        twds.decode_mmc4_sample({"json": b"{not json"}, 8)
    # the reference's filters
    assert twds.decode_laion_sample({"jpg": good}, 8) is None
    assert twds.decode_laion_sample({"jpg": good, "txt": b"  "}, 8) is None
    assert twds.decode_laion_sample({"txt": b"x"}, 8) is None
    assert twds.decode_mmc4_sample({}, 8) is None
    # a corrupt member in a shard: the loader raises, it does not hang
    shard = str(tmp_path / "bad.tar")
    write_tar(shard, [("000.jpg", good), ("000.txt", b"one"),
                      ("001.jpg", bad_crc), ("001.txt", b"two")])
    loader = twds.WebLoader([shard], HashTokenizer(512, 32), kind="laion",
                            batch_size=1, image_size=8)
    with pytest.raises(ValueError, match="bad CRC"):
        list(loader)
    with pytest.raises(ValueError, match="need at least one shard"):
        twds.WebLoader([shard], None, kind="laion", batch_size=1,
                       world_size=2)


def test_cotrain_adapter_and_prepared_batches_match_jax(shards):
    """WebVLLoader batches through prepare_vl_batch, and an MMC4 batch
    through prepare_interleaved_batch, against JAX's."""
    jcfg, tcfg = jconfig.deer_tiny(), tconfig.deer_tiny()
    size = tcfg.vit.image_size
    tok, jtok = (t(vocab_size=tcfg.mpt.vocab_size, max_length=32)
                 for t in (HashTokenizer, JaxTokenizer))
    jv = jwds.WebVLLoader(jwds.WebLoader(shards["jax_laion"], jtok,
                                         kind="laion", batch_size=3,
                                         image_size=size))
    tv = twds.WebVLLoader(twds.WebLoader(shards["jax_laion"], tok,
                                         kind="laion", batch_size=3,
                                         image_size=size))
    jraw, traw = next(iter(jv)), next(iter(tv))
    assert traw["image"].shape == (3, size, size, 3)
    want = jtrainer.prepare_vl_batch(jraw, jcfg)
    got = ttrainer.prepare_vl_batch(traw, tcfg, "cpu")
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["image"].numpy(),
                               np.asarray(want["image"]), atol=PIXEL_ATOL,
                               rtol=0)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="one-image"):
        twds.WebVLLoader(twds.WebLoader(shards["jax_mmc4"], tok, kind="mmc4",
                                        batch_size=1))
    mm = twds.WebLoader(shards["jax_mmc4"], tok, kind="mmc4", batch_size=2,
                        image_size=size, max_tokens=48, sim_threshold=0.0,
                        max_num_images=3)
    batch = next(iter(mm))
    got = twds.prepare_interleaved_batch(batch, size)
    want = jwds.prepare_interleaved_batch(
        {"image": jnp.asarray(batch["image"])}, size)
    assert tuple(got.shape) == (2, 3, 1, 3, size, size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PIXEL_ATOL, rtol=0)
