"""Eval-sequence generation (``generate_sequences`` of the JAX package's
``eval/sequences.py``).

The reference freezes 1000 CALVIN chains in eval_sequences.json
(eval_utils.py:521-527).  With the CALVIN package installed
``generate_sequences`` defers to its sampler; otherwise chains are drawn
uniformly from the task list, deterministic in the seed.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def generate_sequences(tasks: Sequence[str], n: int = 1000,
                       chain_len: int = 5, seed: int = 42) -> List:
    """[(initial_state, [subtask x chain_len])]."""
    try:
        from calvin_agent.evaluation.multistep_sequences import get_sequences
        return get_sequences(n)
    except ImportError:
        pass
    r = np.random.RandomState(seed)
    seqs = []
    for _ in range(n):
        chain = list(r.choice(list(tasks), size=chain_len, replace=True))
        seqs.append(({}, chain))
    return seqs
