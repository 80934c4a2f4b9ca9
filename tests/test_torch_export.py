"""PyTorch port, the serving artifact (``serving/export.py``) on the CPU:
``tests/test_export.py``'s round trips against the port's live engine, and
the port's exported step against JAX's exported step on the same bridged
deer_tiny weights (``tests/test_torch_export_bundle.py`` has the int8,
int4 and bundle cases, ``tests/test_torch_export_bf16.py`` the model
computing in bf16, ``tests/test_torch_export_gpt.py`` the gpt head and
``tests/test_torch_export_cli.py`` the CLIs).

The port's artifact runs the programs traced from the live engine's own
encode and segment functions, so against ``ScanDeerPolicy(indexed_mm=True)``
it must be bit-exact.  Against JAX's artifact (``platforms=("cpu",)``):
exit layers equal, actions within 2e-4 (the tolerance
``tests/test_torch_scan_policy.py`` holds the live engines to).  The
cross-attention gates are drawn non-zero so the vision path reaches the
actions, and the media token is the tokenizer's, as ``cli/serve`` sets it.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.serving import export as jexport
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.models.flamingo import init_deer
from deer_vla_tpu_torch.serving import export as texport
from test_torch_scan_policy import make_params
from test_torch_serving import tiny_configs

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)


def small(cfg):
    """deer_tiny with one ViT and one perceiver layer and 3 decoder layers
    (exits 1 and 2): every program kind at a third of the nodes, which the
    export, the save and the load pay for one by one."""
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, layers=1),
        perceiver=dataclasses.replace(cfg.perceiver, depth=1),
        mpt=dataclasses.replace(cfg.mpt, n_layers=3))


def obs(cfg, batch=1, seed=0):
    """tests/test_export.py's inputs."""
    r = np.random.RandomState(seed)
    hw, s = cfg.vit.image_size, cfg.text_len
    img = r.randn(batch, 1, 1, 3, hw, hw).astype(np.float32)
    grip = r.randn(batch, 1, 1, 3, hw, hw).astype(np.float32)
    ids = np.full((batch, s), 7, np.int32)
    ids[:, 0] = cfg.media_token_id
    return img, grip, ids, np.ones((batch, s), np.int32)


class Artifacts:
    """Each artifact exported (with its bundle) once a module:
    ``export(batch, quantize, head)`` -> (path, meta, programs), and
    ``policy(...)`` its ``ExportedScanPolicy``, loaded once.  ``head``
    names the model (``config``).  The weights are JAX's draw bridged
    (``jax_weights``, for the comparison with JAX's artifact) or the
    port's own."""

    def __init__(self, root, jax_weights=True):
        jcfg, tcfg, _ = tiny_configs()
        self.jcfg, self.tcfg = small(jcfg), small(tcfg)
        self.jax_weights = jax_weights
        self.params = self.draw(self.jcfg, self.tcfg, seed=0)
        self.models = {"deterministic": (self.jcfg, self.tcfg, self.params)}
        self.root, self.exported, self.loaded = root, {}, {}

    def draw(self, jcfg, tcfg, seed):
        return (make_params(jcfg, seed=seed) if self.jax_weights
                else init_deer(tcfg, seed=seed, device="cpu"))

    def config(self, head="deterministic"):
        """(JAX cfg, port cfg, params) of a model: "deterministic", "bf16"
        (the same model and weights computing in bf16) or "gpt" (the gpt
        head family, drawn with seed 3)."""
        if head not in self.models:
            if head == "bf16":
                self.models[head] = (
                    dataclasses.replace(self.jcfg, dtypes=jconfig.BF16),
                    dataclasses.replace(self.tcfg, dtypes=tconfig.BF16),
                    self.params)
            else:
                jcfg, tcfg = (dataclasses.replace(c, head_type=head)
                              for c in (self.jcfg, self.tcfg))
                self.models[head] = (jcfg, tcfg, self.draw(jcfg, tcfg, 3))
        return self.models[head]

    def export(self, batch=1, quantize=None, head="deterministic"):
        key = (batch, quantize, head)
        if key not in self.exported:
            _, cfg, p = self.config(head)
            programs, meta, policy = texport.export_policy(
                p, cfg, batch_size=batch, platforms=("cpu",),
                quantize=quantize, return_policy=True, device="cpu")
            path = str(self.root / f"b{batch}_{quantize}_{head}.step")
            texport.save_bundle(path, programs, meta, policy)
            self.exported[key] = (path, meta, programs)
        return self.exported[key]

    def policy(self, batch=1, quantize=None, head="deterministic"):
        key = (batch, quantize, head)
        if key not in self.loaded:
            _, cfg, p = self.config(head)
            path = self.export(*key)[0]
            self.loaded[key] = texport.ExportedScanPolicy(path, p, cfg,
                                                          device="cpu")
        aot = self.loaded[key]
        aot.reset()
        return aot


# a threshold row a pass: the first exit, the last, and one between (the
# deltas at exit 1 sit below it)
ROWS = ([1e8, 1e8], [-1e8, 1e8], [0.05, 1e8])


def assert_matches_jax(art, tmp_path, batch=1, quantize=None,
                       head="deterministic"):
    """The port's artifact against JAX's (``platforms=("cpu",)``, the same
    bridged weights, mode and batch): 3 steps from a reset for each row of
    ROWS, exit layers equal, actions within 2e-4, and both exits taken."""
    jcfg, tcfg, params = art.config(head)
    tpol = art.policy(batch, quantize, head)
    jparams = jax.tree.map(jnp.asarray, params)
    blob, meta = jexport.export_policy(jparams, jcfg, batch_size=batch,
                                       platforms=("cpu",), quantize=quantize)
    jpath = str(tmp_path / "jax.step")
    jexport.save_exported(jpath, blob, meta)
    jpol = jexport.ExportedScanPolicy(jpath, jparams, jcfg)
    assert jpol.quantize == tpol.quantize == quantize
    seen = set()
    for th in ROWS:
        for pol in (jpol, tpol):
            pol.set_thresholds(th)
            pol.reset()
        for step_i in range(3):
            inputs = obs(tcfg, batch=batch, seed=step_i)
            if batch == 1:
                np.testing.assert_allclose(tpol.step(*inputs),
                                           jpol.step(*inputs), **TOL)
                assert tpol.last_exit_layer == jpol.last_exit_layer
                seen.add(tpol.last_exit_layer)
            else:
                ta, te = tpol.step_batch(*inputs)
                ja, je = jpol.step_batch(*inputs)
                np.testing.assert_array_equal(te, je)
                np.testing.assert_allclose(ta, ja, **TOL)
                seen.update(te.tolist())
    assert seen == set(meta["exits"]) == {1, 2}


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    return Artifacts(tmp_path_factory.mktemp("export"))


def live(tcfg, params, **kw):
    return ScanDeerPolicy(params, tcfg, indexed_mm=True, device="cpu", **kw)


def test_export_roundtrip_bit_exact(art):
    path, meta, _ = art.export()
    aot = art.policy()
    assert os.path.isdir(path) and os.path.exists(path + ".json")
    meta2 = texport.load_meta(path)
    assert meta2["exits"] == meta["exits"] == [1, 2]
    assert meta2["programs"] == ["encode", "segment_0", "segment_1"]
    assert all(order[:2] == ["params", "stacked"]
               for order in meta2["arg_order"].values())
    assert meta2["torch_version"] == torch.__version__
    pol = live(art.tcfg, art.params)
    for th in ([1e8, 1e8], [-1e8, 1e8], [0.05, 1e8]):
        pol.set_thresholds(th), aot.set_thresholds(th)
        pol.reset(), aot.reset()
        for step_i in range(3):  # the carry threads across steps
            a_live = pol.step(*obs(art.tcfg, seed=step_i))
            a_aot = aot.step(*obs(art.tcfg, seed=step_i))
            np.testing.assert_array_equal(a_live, a_aot)
            assert aot.last_exit_layer == pol.last_exit_layer
        for c_live, c_aot in zip(pol.carry, aot.carry):
            assert torch.equal(c_live, c_aot)
        assert torch.equal(pol.last_hidden, aot.last_hidden)


def test_export_batched_shapes(art):
    aot = art.policy(batch=4)
    pol = live(art.tcfg, art.params)
    aot.set_thresholds([0.05, 1e8]), pol.set_thresholds([0.05, 1e8])
    img, grip, ids, mask = obs(art.tcfg, batch=4)
    assert aot.step(img, grip, ids, mask).shape == (7,)  # stream 0's
    aot.reset()
    acts, exits = aot.step_batch(img, grip, ids, mask)
    want_acts, want_exits = pol.step_batch(img, grip, ids, mask)
    np.testing.assert_array_equal(acts, want_acts)
    np.testing.assert_array_equal(exits, want_exits)
    # the batch is baked into the programs' shapes
    aot.reset()
    with pytest.raises(Exception):
        aot.step(*obs(art.tcfg, batch=2))


def test_export_exit_mismatch_rejected(art, tmp_path):
    path, meta, _ = art.export()
    bad = str(tmp_path / "m.step")
    shutil.copytree(path, bad)
    with open(bad + ".json", "w") as f:
        json.dump(dict(meta, exits=[0]), f)
    with pytest.raises(ValueError, match="wrong checkpoint/config"):
        texport.ExportedScanPolicy(bad, art.params, art.tcfg, device="cpu")


def test_encode_program_holds_k1(art):
    """At 145 ViT tokens (>= 128) the encode program reaches K1 as the
    ``deer::flash_attention`` operator; the live encode and the program
    agree bit for bit."""
    tbig = dataclasses.replace(art.tcfg, vit=dataclasses.replace(
        art.tcfg.vit, image_size=168))
    pol = live(tbig, init_deer(tbig, seed=0, device="cpu"))
    args = texport.example_inputs(pol, 1)["encode"]
    with torch.no_grad():
        ep = torch.export.export(texport._Program(pol.scan_step.encode),
                                 args, strict=False)
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert "deer.flash_attention.default" in ops
    img, grip, ids, _ = obs(tbig)
    inputs = (pol.params, pol.stacked, torch.from_numpy(img),
              torch.from_numpy(grip), torch.from_numpy(ids).long(), None)
    with torch.inference_mode():
        got = ep.module()(*inputs)
        want = pol.scan_step.encode(*inputs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", [1, 4])
def test_matches_jax_exported_step(art, tmp_path, batch):
    """The fp32 artifact against JAX's at B=1 and B=4
    (``assert_matches_jax``; the bf16 model, int8, int4 and the gpt head
    have theirs in the other ``test_torch_export_*`` files)."""
    assert_matches_jax(art, tmp_path, batch=batch)


def test_loaded_program_rechecks_a_new_weight(art):
    """A weight leaf put in place of another is checked on the next call:
    another dtype raises, naming the leaf; the original served again."""
    aot = art.policy()
    aot.set_thresholds([-1e8, 1e8])
    want = aot.step(*obs(art.tcfg))
    name = "stacked__blocks__mlp_down__w"
    leaf = aot._buffers[name]
    setattr(aot, name, leaf.to(torch.bfloat16))
    aot.reset()
    with pytest.raises(ValueError, match=r"\['mlp_down'\]\['w'\]"):
        aot.step(*obs(art.tcfg))
    setattr(aot, name, leaf)
    aot.reset()
    np.testing.assert_array_equal(aot.step(*obs(art.tcfg)), want)
