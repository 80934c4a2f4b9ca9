"""The port's reference-checkpoint conversion (``utils/convert.py``,
``cli/convert.py``) against the JAX package's, on the reference-layout
artifacts of ``tests/test_convert_cli.py`` (an OpenFlamingo base and a DeeR
delta written by torch modules with the reference's attribute layout), and
the port's own safetensors reader."""

import contextlib
import io
import json
import struct

import numpy as np
import pytest
import torch

from deer_vla_tpu.cli.convert import main as jax_convert
from deer_vla_tpu.cli.eval import main as jax_eval
from deer_vla_tpu_torch.cli.convert import main as torch_convert
from deer_vla_tpu_torch.cli.eval import main as torch_eval
from deer_vla_tpu_torch.train import msgpack_io
from deer_vla_tpu_torch.utils.convert import (load_torch_checkpoint,
                                              read_safetensors)
from test_convert_cli import artifacts  # noqa: F401  (a fixture)


def convert_argv(cfg, tmp, out):
    return ["--model", "tiny", "--max_layer", str(cfg.n_layers),
            "--openflamingo_checkpoint", str(tmp / "openflamingo_base.pt"),
            "--deer_checkpoint", str(tmp / "deer_delta.pth"), "--out", out]


@pytest.fixture(scope="module")
def converted(artifacts, tmp_path_factory):  # noqa: F811
    """Both packages' conversion of the same base + delta."""
    cfg, tmp, base = artifacts
    out = tmp_path_factory.mktemp("converted")
    jax_out, torch_out = str(out / "jax" / "deer"), str(out / "torch" / "deer")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_convert(convert_argv(cfg, tmp, jax_out))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        torch_convert(convert_argv(cfg, tmp, torch_out))
    return cfg, jax_out, torch_out, buf.getvalue()


def test_converted_trees_bit_equal_to_jax(converted):
    """Every stored leaf bit-equal, the same config and the same cached
    calibration values; the port's sidecar records how it drew the leaves
    no source covers, and the audit left no key unconsumed."""
    cfg, jax_out, torch_out, said = converted
    want = msgpack_io.load(jax_out + ".ckpt")["params"]
    got = msgpack_io.load(torch_out + ".ckpt")["params"]
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    side_j = json.load(open(jax_out + ".json"))
    side_t = json.load(open(torch_out + ".json"))
    assert side_t["config"] == side_j["config"]
    assert side_t["meta"]["epoch"] == side_j["meta"]["epoch"] == 3
    init = side_t["meta"]["init"]
    assert init["package"] == "deer_vla_tpu_torch"
    assert init["seed"] == 42 and init["generator_device"] == "cpu"
    assert [s["unconsumed"] for s in side_t["meta"]["converted_from"]] \
        == [0, 0]
    vj = np.load(jax_out + ".values.npz")["values"]
    vt = np.load(torch_out + ".values.npz")["values"]
    assert vt.shape == (cfg.num_exits, 50) and np.array_equal(vj, vt)
    assert "0 unconsumed" in said


def test_delta_overwrote_the_base(converted, artifacts):  # noqa: F811
    """The delta's +0.25 x-attn leaf and the base's frozen decoder leaf
    land where the JAX test expects them."""
    _, _, torch_out, _ = converted
    _, _, base = artifacts
    got = msgpack_io.load(torch_out + ".ckpt")["params"]
    want = (base["lang_encoder.transformer.blocks.0.gated_cross_attn_layer."
                 "attn.to_q.weight"].numpy().T + 0.25)
    np.testing.assert_allclose(got["decoder/xattn/0/to_q/w"], want,
                               rtol=1e-6)
    want_qkv = base["lang_encoder.transformer.blocks.0.decoder_layer."
                    "attn.Wqkv.weight"].numpy().T
    assert np.array_equal(got["decoder/blocks/0/wqkv/w"], want_qkv)


def test_delta_only_warns_and_writes(artifacts, tmp_path, capsys):  # noqa: F811
    """Delta-only conversion: the random-backbone warning, the delta and
    the DeeR dict's readouts still land."""
    cfg, tmp, _ = artifacts
    out = str(tmp_path / "delta_only" / "deer")
    torch_convert(["--model", "tiny", "--max_layer", str(cfg.n_layers),
                   "--deer_checkpoint", str(tmp / "deer_delta.pth"),
                   "--out", out])
    assert "RANDOM init" in capsys.readouterr().out
    side = json.load(open(out + ".json"))
    assert side["config"]["exit_interval"] == 2  # the ckpt-dict readout
    assert side["meta"]["epoch"] == 3


def test_naming_drift_refused(artifacts, tmp_path):  # noqa: F811
    cfg, _, base = artifacts
    drifted = dict(base)
    drifted["lang_encoder.transformer.blocks.0.decoder_layer."
            "attn.Wqkv_RENAMED.weight"] = torch.zeros(
        3 * cfg.mpt.d_model, cfg.mpt.d_model)
    torch.save(drifted, tmp_path / "drift.pt")
    argv = ["--model", "tiny", "--max_layer", str(cfg.n_layers),
            "--openflamingo_checkpoint", str(tmp_path / "drift.pt"),
            "--out", str(tmp_path / "x")]
    with pytest.raises(SystemExit, match="NOT consumed"):
        torch_convert(argv)
    assert not (tmp_path / "x.ckpt").exists()
    torch_convert(argv + ["--allow_unconsumed"])
    assert (tmp_path / "x.ckpt").exists()


def test_no_source_refused(tmp_path):
    with pytest.raises(SystemExit, match="at least one source"):
        torch_convert(["--model", "tiny", "--out", str(tmp_path / "x")])


def last_three(fn, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv, **kw)
    lines = [l for l in buf.getvalue().strip().splitlines() if l.strip()]
    th = [float(t) for t in lines[-3].split(",")]
    return th, float(lines[-2]), float(lines[-1])


def test_eval_on_converted_matches_jax(converted):
    """cli/eval --evaluate_from_checkpoint on each package's converted
    checkpoint: the three-line parse contract within 1e-5."""
    _, jax_out, torch_out, _ = converted
    argv = ["--debug", "--precision", "fp32", "--num_sequences_override", "2",
            "--exit_ratio", "1.0", "--calib_batches", "1"]
    want = last_three(jax_eval, argv + ["--evaluate_from_checkpoint",
                                        jax_out + ".ckpt"])
    got = last_three(torch_eval, argv + ["--evaluate_from_checkpoint",
                                         torch_out + ".ckpt"], device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert abs(got[1] - want[1]) <= 1e-5 and abs(got[2] - want[2]) <= 1e-5


def write_safetensors(path, tensors: dict, metadata=None) -> None:
    """A .safetensors file written by hand: the 8-byte little-endian
    header length, the JSON header, the little-endian data."""
    names = {torch.float32: "F32", torch.bfloat16: "BF16",
             torch.float16: "F16", torch.int64: "I64"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = metadata
    text = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text + b"".join(blobs))


def shard_tensors(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"transformer.wte.weight": torch.randn(8, 4, generator=g),
            "transformer.blocks.0.ln_1.weight": torch.randn(
                4, generator=g).to(torch.bfloat16),
            "transformer.blocks.0.attn.Wqkv.weight": torch.randn(
                12, 4, generator=g).to(torch.float16),
            "module.transformer.step": torch.tensor(7),
            "transformer.scalar": torch.tensor(0.5)}


def test_safetensors_reader_on_hand_written_file(tmp_path):
    """fp32, bf16 (widened through torch), fp16, int64 and 0-d tensors,
    the metadata entry skipped, 'module.' stripped; a truncated tensor
    raises."""
    ts = shard_tensors(0)
    write_safetensors(tmp_path / "a.safetensors", ts, {"format": "pt"})
    got = read_safetensors(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(k.removeprefix("module.") for k in ts)
    for k, t in ts.items():
        a = got[k.removeprefix("module.")]
        assert a.dtype == np.float32 and a.shape == tuple(t.shape)
        assert np.array_equal(a, t.float().numpy())
    bad = tmp_path / "bad.safetensors"
    write_safetensors(bad, {"x": torch.ones(4)})
    raw = bad.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    header["x"]["shape"] = [5]
    text = json.dumps(header).encode()
    bad.write_bytes(struct.pack("<Q", len(text)) + text + raw[8 + n:])
    with pytest.raises(ValueError, match="bytes"):
        read_safetensors(str(bad))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    """Files written by the ``safetensors`` package (where this host has
    it): one shard, and a sharded snapshot directory merged by
    ``load_torch_checkpoint``."""
    st = pytest.importorskip("safetensors.torch")
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(1)
    shards = [{f"transformer.blocks.{i}.attn.Wqkv.weight":
               torch.randn(12, 4, generator=g).to(dt),
               f"transformer.blocks.{i}.ln_1.weight":
               torch.randn(4, generator=g).to(dt)} for i in range(2)]
    snap = tmp_path / "snapshot"
    snap.mkdir()
    for i, sd in enumerate(shards):
        st.save_file(sd, str(snap / f"model-0000{i + 1}-of-00002"
                                    ".safetensors"))
    (snap / "model.safetensors.index.json").write_text("{}")
    one = read_safetensors(str(snap / "model-00001-of-00002.safetensors"))
    assert sorted(one) == sorted(shards[0])
    merged = load_torch_checkpoint(str(snap))
    want = {k: v for sd in shards for k, v in sd.items()}
    assert sorted(merged) == sorted(want)
    for k, t in want.items():
        assert np.array_equal(merged[k], t.float().numpy()), k
