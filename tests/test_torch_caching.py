"""PyTorch port, the serving caches (``eval/caching.py``) against the JAX
package's on the CPU: ``frame_delta``, the action cache and the vision
caches around both engines, on the same bridged deer_tiny weights and
numpy-seeded frames (the JAX tests/test_caching.py cases, less the rolling
frame cache of window-folded models, ROADMAP.md M10).

Hits and steps must be equal; exit layers equal at every step; actions
within 2e-4 of JAX's, the tolerance tests/test_torch_scan_policy.py holds
the step to.  Against the port's own uncached policy a never-hitting cache
must be equal bit for bit, and a cache that hits on repeated frames equal
too (the same frame encodes to the same prefix).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deer_vla_tpu.core import config as jconfig
from deer_vla_tpu.eval import caching as jcache
from deer_vla_tpu.eval.policy import DeerPolicy as JaxDeer
from deer_vla_tpu.eval.scan_policy import ScanDeerPolicy as JaxScan
from deer_vla_tpu_torch.core import config as tconfig
from deer_vla_tpu_torch.eval import caching as tcache
from deer_vla_tpu_torch.eval.policy import DeerPolicy
from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy

from test_torch_policy import TH, controllers, make_params

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread keeps them
    from waiting on a pool the other test workers keep busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("layout", [(2, 1, 1, 3, 28, 28), (1, 40, 40, 3)])
def test_frame_delta_matches_jax(stride, layout):
    r = np.random.RandomState(stride)
    a = r.randint(0, 256, layout).astype(np.float32)
    b = a + r.randn(*layout).astype(np.float32) * 3
    want = float(jcache.frame_delta(jnp.asarray(a), jnp.asarray(b),
                                    stride=stride))
    for x, y in ((a, b), (torch.from_numpy(a), torch.from_numpy(b))):
        got = float(tcache.frame_delta(x, y, stride=stride))
        assert got == pytest.approx(want, rel=1e-6)
    assert float(tcache.frame_delta(a, a)) == 0.0


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.deer_tiny()
    return jcfg, tconfig.deer_tiny(), make_params(jcfg)


def port_policy(tcfg, params, engine):
    """The port's policy of one engine with thresholds TH."""
    if engine == "scan":
        return ScanDeerPolicy(params, tcfg, thresholds=list(TH),
                              indexed_mm=True, device="cpu")
    return DeerPolicy(params, tcfg, controller=controllers(tcfg, TH)[1],
                      device="cpu")


def engines(jcfg, tcfg, params, engine):
    """(JAX policy, port policy) of one engine with thresholds TH."""
    jp = jax.tree.map(jnp.asarray, params)
    if engine == "scan":
        jpol = JaxScan(jp, jcfg, thresholds=list(TH))
    else:
        jpol = JaxDeer(jp, jcfg, controller=controllers(tcfg, TH)[0])
    return jpol, port_policy(tcfg, params, engine)


def frames(cfg, seed):
    r = np.random.RandomState(seed)
    hw, s = cfg.vit.image_size, cfg.text_len
    img = r.randn(1, 1, 1, 3, hw, hw).astype(np.float32)
    ids = np.full((1, s), 7, np.int32)
    ids[:, 0] = cfg.media_token_id
    return img, ids, np.ones((1, s), np.int32)


# repeated frames, then a changed one, then repeats of that
SEQUENCE = (0, 0, 0, 0, 9, 9, 9)


def drive(jpol, tpol, cfg, seeds=SEQUENCE):
    """Both wrapped policies over the frame sequence; returns the port's
    actions and exit layers."""
    acts, exits = [], []
    for t, seed in enumerate(seeds):
        img, ids, mask = frames(cfg, seed)
        for p in (jpol, tpol):
            p.set_timestep(t)
        a_j = jpol.step(jnp.asarray(img), jnp.asarray(img), jnp.asarray(ids),
                        jnp.asarray(mask))
        a_t = tpol.step(img, img, ids, mask)
        assert tpol.last_exit_layer == jpol.last_exit_layer, t
        np.testing.assert_allclose(a_t, a_j, **TOL)
        acts.append(a_t)
        exits.append(tpol.last_exit_layer)
    return acts, exits


@pytest.mark.parametrize("engine", ["scan", "bucketed"])
def test_action_cache_matches_jax(tiny, engine):
    jcfg, tcfg, params = tiny
    jp, tp = engines(jcfg, tcfg, params, engine)
    jw = jcache.ActionCachePolicy(jp, tau=0.01, refresh_every=3)
    tw = tcache.ActionCachePolicy(tp, tau=0.01, refresh_every=3)
    acts, exits = drive(jw, tw, tcfg)
    # hits at steps 1, 2 (refresh at 3), 5, 6; each hit replays the action
    assert (tw.hits, tw.steps) == (jw.hits, jw.steps) == (4, 7)
    assert exits[1] == exits[2] == exits[5] == exits[6] == -1
    np.testing.assert_array_equal(acts[1], acts[0])
    np.testing.assert_array_equal(acts[6], acts[4])


@pytest.mark.parametrize("engine", ["scan", "bucketed"])
def test_vision_cache_matches_jax(tiny, engine):
    jcfg, tcfg, params = tiny
    wrap = {"scan": (jcache.VisionCacheScanPolicy,
                     tcache.VisionCacheScanPolicy),
            "bucketed": (jcache.VisionCacheDeerPolicy,
                         tcache.VisionCacheDeerPolicy)}[engine]
    jp, tp = engines(jcfg, tcfg, params, engine)
    jw, tw = wrap[0](jp, tau=0.01), wrap[1](tp, tau=0.01)
    _, exits = drive(jw, tw, tcfg)
    assert (tw.encode_hits, tw.steps) == (jw.encode_hits, jw.steps) == (5, 7)
    assert -1 not in exits


@pytest.mark.parametrize("engine", ["scan", "bucketed"])
def test_vision_cache_equals_the_uncached_policy(tiny, engine):
    """A cache that never hits (tau -1) is the inner policy bit for bit; on
    repeated frames a hitting cache gives the uncached actions (the carry
    advances every step)."""
    jcfg, tcfg, params = tiny
    wrap = (tcache.VisionCacheScanPolicy if engine == "scan"
            else tcache.VisionCacheDeerPolicy)
    plain = port_policy(tcfg, params, engine)
    never = wrap(port_policy(tcfg, params, engine), tau=-1.0)
    hits = wrap(port_policy(tcfg, params, engine), tau=0.01)
    for t, seed in enumerate(SEQUENCE):
        img, ids, mask = frames(tcfg, seed)
        outs = []
        for p in (plain, never, hits):
            p.set_timestep(t)
            outs.append(p.step(img, img, ids, mask))
        np.testing.assert_array_equal(outs[1], outs[0])
        np.testing.assert_array_equal(outs[2], outs[0])
        assert never.last_exit_layer == hits.last_exit_layer == \
            plain.last_exit_layer
    assert never.encode_hits == 0 and hits.encode_hits == 5


def test_vision_cache_refusals(tiny):
    jcfg, tcfg, params = tiny
    with pytest.raises(TypeError, match="DeerPolicy"):
        tcache.VisionCacheDeerPolicy(port_policy(tcfg, params, "scan"))
    deer = port_policy(tcfg, params, "bucketed")
    deer.cfg = dataclasses.replace(tcfg, use_state=True)
    with pytest.raises(NotImplementedError, match="state models"):
        tcache.VisionCacheDeerPolicy(deer)
