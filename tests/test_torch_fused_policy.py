"""PyTorch port, the cond-chain oracle engine (``eval/fused_policy.py``)
against the JAX package's ``FusedDeerPolicy`` on the CPU, on the same
bridged deer_tiny weights (cross-attention gates opened) and numpy-seeded
inputs; then against the port's other engines at B=1.

Exit layers must be equal at every step; actions within 2e-4 (the JAX
package's own tolerance, tests/test_fused_policy.py) and carries within
1e-5.  One JAX engine a configuration serves every case (thresholds are a
runtime argument), so JAX compiles each program once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.eval.fused_policy import FusedDeerPolicy as JaxFused
from deer_vla_tpu_torch.eval.fused_policy import FusedDeerPolicy
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
from deer_vla_tpu_torch.models.value_net import ExitController

from test_torch_policy import configs, make_params, obs

TOL = dict(rtol=2e-4, atol=2e-4)
CARRY_TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_fused_policy.py's rows: the first exit, the last exit, and a
# data-dependent one (these gate-opened weights' first-exit deltas lie near
# 3e-4 to 6e-4, so it exits first at every step); "mixed" sits among those
# deltas, and takes both exits at B=1 and at B=2
ROWS = {"first": [1e8, 1e8], "last": [-1.0, 1e8], "data": [0.05, 1e8],
        "mixed": [3.5e-4, 1e8]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread keeps them
    from waiting on a pool the other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """One JAX / port engine pair a configuration (deer_tiny; and with
    multi_step_action 2), built once for the whole file."""
    from deer_vla_tpu.core import config as jconfig
    jcfg = jconfig.deer_tiny()
    out = {}
    for name, head in (("k1", {}), ("k2", {"multi_step_action": 2})):
        jc, tc = configs(jcfg, head=dataclasses.replace(jcfg.head, **head))
        params = make_params(jc)
        out[name] = (JaxFused(jax.tree.map(jnp.asarray, params), jc),
                     FusedDeerPolicy(params, tc, device="cpu"), tc, params)
    return out


def run(jpol, tpol, cfg, th, steps=4, b=1, sps=1, seed=0):
    """Both engines over ``steps`` timesteps from a reset, the carry
    threaded; returns the exit layers taken."""
    exits = []
    for p in (jpol, tpol):
        p.reset()
        p.set_thresholds(th)
        p.steps_per_stage = sps
    for t in range(steps):
        img, grip, ids, mask = obs(cfg, b, seed=seed + t)
        for p in (jpol, tpol):
            p.set_timestep(t)
        a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                        jnp.asarray(ids), jnp.asarray(mask))
        a_t = tpol.step(img, grip, ids, mask)
        assert tpol.last_exit_layer == jpol.last_exit_layer, t
        assert a_t.shape == np.shape(a_j)
        np.testing.assert_allclose(a_t, a_j, **TOL)
        for ct, cj in zip(tpol.carry, jpol.carry):
            np.testing.assert_allclose(ct.numpy(), np.asarray(cj),
                                       **CARRY_TOL)
        exits.append(tpol.last_exit_layer)
    return exits


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("row", list(ROWS))
def test_fused_matches_jax(engines, row, b):
    """B=2 covers the batch-wide ``done`` and the batch-mean delta."""
    jpol, tpol, cfg, _ = engines["k1"]
    exits = run(jpol, tpol, cfg, ROWS[row], b=b)
    want = {"first": {1}, "last": {3}, "data": {1}, "mixed": {1, 3}}
    assert set(exits) == want[row], exits


def test_fused_plans_match_jax(engines):
    """multi_step_action 2: a flat 12-wide arm, (2, 7) plans."""
    jpol, tpol, cfg, _ = engines["k2"]
    run(jpol, tpol, cfg, ROWS["mixed"])
    img, grip, ids, mask = obs(cfg, 1, seed=9)
    assert tpol.step(img, grip, ids, mask).shape == (2, 7)


def test_fused_stage_reuse_with_dict_thresholds_matches_jax(engines):
    """steps_per_stage 2 through the runtime row (-inf below the reused
    exit, +inf at it), thresholds given by exit."""
    jpol, tpol, cfg, _ = engines["k1"]
    e0, e1 = tpol.exits
    exits = run(jpol, tpol, cfg, {e0: -1.0, e1: 1e8}, sps=2)
    assert exits == [e1] * 4
    # mid-stage the previous exit is reused whatever the thresholds say
    for p in (jpol, tpol):
        p.set_thresholds({e0: 1e8, e1: 1e8})
    img, grip, ids, mask = obs(cfg, 1, seed=4)
    for t, want in ((5, e1), (6, e0)):
        for p in (jpol, tpol):
            p.set_timestep(t)
        a_j = jpol.step(jnp.asarray(img), jnp.asarray(grip),
                        jnp.asarray(ids), jnp.asarray(mask))
        a_t = tpol.step(img, grip, ids, mask)
        assert tpol.last_exit_layer == jpol.last_exit_layer == want
        np.testing.assert_allclose(a_t, a_j, **TOL)


@pytest.mark.parametrize("changes", [
    {"fusion_mode": "vit_concat"}, {"use_hist": True},
    {"head_type": "gpt"}], ids=["vit_concat", "use_hist", "gpt_head"])
def test_fused_refuses_what_jax_refuses(engines, changes):
    """check_serving_supported with the JAX engine's arguments: no
    window-folded variant, the LSTM head only (JAX's
    tests/test_fusion_modes.py)."""
    from deer_vla_tpu.core import config as jconfig
    jc, tc = configs(jconfig.deer_tiny(), **changes)
    _, _, _, params = engines["k1"]
    with pytest.raises(NotImplementedError):
        JaxFused(params, jc)
    with pytest.raises(NotImplementedError):
        FusedDeerPolicy(params, tc, device="cpu")


@pytest.mark.parametrize("row", list(ROWS))
def test_fused_matches_the_ports_engines(engines, row):
    """At B=1 the batch-wide exit is the stream's: the port's DeerPolicy
    and ScanDeerPolicy take the same exits with the same actions."""
    _, fused, cfg, params = engines["k1"]
    ctrl = ExitController(exit_id_list=list(cfg.all_exit_ids()),
                          max_layer=cfg.n_layers)
    ctrl.set_threshold_values(ROWS[row])
    others = (DeerPolicy(params, cfg, controller=ctrl, device="cpu"),
              ScanDeerPolicy(params, cfg, thresholds=ROWS[row],
                             device="cpu"))
    fused.reset()
    fused.set_thresholds(ROWS[row])
    for t in range(4):
        img, grip, ids, mask = obs(cfg, 1, seed=t)
        a_f = fused.step(img, grip, ids, mask)
        for p in others:
            p.set_timestep(t)
            a = p.step(img, grip, ids, mask)
            assert p.last_exit_layer == fused.last_exit_layer, (t, p)
            np.testing.assert_allclose(a, a_f, **TOL)
