"""PyTorch port, the serving artifact's quantized layouts and bundles
(``serving/export.py``) on the CPU: ``tests/test_export.py``'s int8 round
trip and bundle cases against the port's live engine, the int8 and int4
artifacts against JAX's on the same bridged weights, and the kernels each
exported program reaches.  ``tests/test_torch_export.py`` has the config,
the fixtures and the comparison (``assert_matches_jax``).
"""

import json
import os

import numpy as np
import pytest

from deer_vla_tpu_torch.eval import scan_policy as tscan
from deer_vla_tpu_torch.serving import export as texport
from test_torch_export import Artifacts, assert_matches_jax, live, obs

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    return Artifacts(tmp_path_factory.mktemp("export_bundle"))


def test_export_int8_roundtrip_bit_exact(art, tmp_path):
    """The int8 stacked layout baked into the programs (K3's operator in
    every segment); the host quantizes the checkpoint to match, and a host
    asking for another mode is refused."""
    path, meta, _ = art.export(quantize="int8")
    aot = art.policy(quantize="int8")
    assert meta["quantize"] == "int8"
    pol = live(art.tcfg, art.params, quantize="int8")
    pol.set_thresholds([-1e8, 1e8]), aot.set_thresholds([-1e8, 1e8])
    for step_i in range(3):
        np.testing.assert_array_equal(pol.step(*obs(art.tcfg, seed=step_i)),
                                      aot.step(*obs(art.tcfg, seed=step_i)))
    assert aot.last_exit_layer == pol.last_exit_layer == 2
    with pytest.raises(ValueError, match="quantize"):
        texport.ExportedScanPolicy(path, art.params, art.tcfg,
                                   quantize=None, device="cpu")
    fp = str(tmp_path / "fp.step")  # an unquantized artifact's meta
    with open(fp + ".json", "w") as f:
        json.dump(dict(meta, quantize=None), f)
    with pytest.raises(ValueError, match="quantize"):
        texport.ExportedScanPolicy(fp, art.params, art.tcfg,
                                   quantize="int8", device="cpu")


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_bundle_roundtrip_no_model_python(art, monkeypatch, quantize):
    """The bundle serves with no checkpoint: ``init_deer``,
    ``build_scan_step`` and the bridge raise while it loads and serves,
    and it is bit-exact against the live engine (int4 ships the packed
    nibbles)."""
    path, _, _ = art.export(quantize=quantize)
    pol = live(art.tcfg, art.params, quantize=quantize)

    def forbidden(*a, **k):
        raise AssertionError("model-building Python on a bundle host")

    from deer_vla_tpu_torch import bridge
    from deer_vla_tpu_torch.models import flamingo
    monkeypatch.setattr(flamingo, "init_deer", forbidden)
    monkeypatch.setattr(tscan, "build_scan_step", forbidden)
    monkeypatch.setattr(tscan, "to_torch", forbidden)
    monkeypatch.setattr(bridge, "to_torch", forbidden)
    bundled = texport.BundledScanPolicy(path, device="cpu")
    assert bundled.quantize == quantize
    th = [-1e8, 1e8]
    pol.set_thresholds(th), bundled.set_thresholds(th)
    for step_i in range(3):
        np.testing.assert_array_equal(
            pol.step(*obs(art.tcfg, seed=step_i)),
            bundled.step(*obs(art.tcfg, seed=step_i)))
    assert bundled.last_exit_layer == pol.last_exit_layer


def test_bundle_int8_weights_smaller(art):
    sizes = {q: os.path.getsize(art.export(quantize=q)[0] + ".weights")
             for q in (None, "int8")}
    assert sizes["int8"] < 0.7 * sizes[None]


def test_programs_hold_the_kernels_and_no_weights(art):
    """Every segment program reaches its mode's layer-indexed kernel as a
    ``deer::`` operator node (K2, K3 or K4), and no program holds a
    parameter, a buffer or a constant beyond the ALiBi slopes."""
    want = {None: "deer.indexed_matmul.default",
            "int8": "deer.indexed_matmul_q8.default",
            "int4": "deer.indexed_matmul_q4.default"}
    for quantize, op in want.items():
        programs = art.export(quantize=quantize)[2]
        for name, ep in programs.items():
            ops = {str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"}
            deer = {o for o in ops if o.startswith("deer.")}
            assert deer == (set() if name == "encode" else {op}), (name,
                                                                   deer)
            assert not ep.state_dict and not list(ep.parameters())
            assert not ep.graph_signature.buffers
            slopes = art.tcfg.mpt.n_heads
            assert sum(c.numel() for c in ep.constants.values()) <= slopes


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_matches_jax_exported_step(art, tmp_path, quantize):
    """The quantized artifact against JAX's of the same mode: the host of
    each quantizes the same bridged checkpoint (``assert_matches_jax``)."""
    assert_matches_jax(art, tmp_path, quantize=quantize)
