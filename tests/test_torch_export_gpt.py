"""PyTorch port, the serving artifact of a gpt-head model on the CPU
(``tests/test_export.py``'s gpt case): the head's rolling-history carry
crosses the programs' boundary, and the artifact is bit-exact against the
port's live engine and matches JAX's artifact on the same bridged weights.
Its eight GPT-2 blocks at every exit check make these the largest programs
of the tests, so they have a file of their own.
"""

import numpy as np
import pytest

from test_torch_export import Artifacts, assert_matches_jax, live, obs

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    return Artifacts(tmp_path_factory.mktemp("export_gpt"))


def test_export_gpt_head_roundtrip(art):
    """The gpt head's rolling-history carry (a ``GPTCarry``) crosses the
    programs' boundary; round trip bit-exact."""
    _, gcfg, gparams = art.config("gpt")
    aot = art.policy(head="gpt")
    pol = live(gcfg, gparams, thresholds=[-1e8, 1e8])
    aot.set_thresholds([-1e8, 1e8])
    for step_i in range(3):
        np.testing.assert_array_equal(pol.step(*obs(gcfg, seed=step_i)),
                                      aot.step(*obs(gcfg, seed=step_i)))
    assert int(aot.carry.count[0]) == 3
    assert aot.last_exit_layer == pol.last_exit_layer


def test_matches_jax_exported_step(art, tmp_path):
    """The gpt head's artifact against JAX's (``assert_matches_jax``)."""
    assert_matches_jax(art, tmp_path, head="gpt")
