"""PyTorch port, the serving artifact of the model computing in bf16 (the
card's precision) on the CPU: bit-exact against the port's live engine in
bf16, and against JAX's bf16 artifact on the same bridged weights within
the fp32 cases' 2e-4 (``assert_matches_jax``).  A file of its own, so that
its export runs beside the others'.
"""

import numpy as np
import pytest
import torch

from test_torch_export import ROWS, Artifacts, assert_matches_jax, live, obs

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    return Artifacts(tmp_path_factory.mktemp("export_bf16"))


def test_export_bf16_roundtrip_bit_exact(art):
    _, cfg, params = art.config("bf16")
    aot = art.policy(head="bf16")
    pol = live(cfg, params)
    for th in ROWS:
        pol.set_thresholds(th), aot.set_thresholds(th)
        pol.reset(), aot.reset()
        for step_i in range(3):
            np.testing.assert_array_equal(pol.step(*obs(cfg, seed=step_i)),
                                          aot.step(*obs(cfg, seed=step_i)))
            assert aot.last_exit_layer == pol.last_exit_layer
        assert aot.last_hidden.dtype == torch.bfloat16
        assert torch.equal(pol.last_hidden, aot.last_hidden)


def test_matches_jax_exported_step(art, tmp_path):
    assert_matches_jax(art, tmp_path, head="bf16")
