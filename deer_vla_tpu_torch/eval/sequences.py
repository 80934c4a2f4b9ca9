"""Eval-sequence and annotation-cache generation (the JAX package's
``eval/sequences.py``).

The reference freezes 1000 CALVIN chains in eval_sequences.json
(eval_utils.py:521-527, written by save_sequences :729-733) and pre-samples
one enriched instruction a (sequence, subtask) into
lang_annotation_cache.json for --diverse_inst (:713-726).  With the CALVIN
package installed ``generate_sequences`` defers to its sampler; otherwise
chains are drawn uniformly from the task list, deterministic in the seed.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

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


def save_sequences(path: str, sequences: List) -> None:
    with open(path, "w") as f:
        json.dump(sequences, f)


def generate_annotation_cache(sequences: List,
                              enrich_lang: Dict[str, List[str]],
                              base_annotations: Optional[Dict[str, str]] = None,
                              seed: int = 42) -> List[List[str]]:
    """One enriched instruction a (sequence, subtask), drawn from the
    task's enriched texts plus its base text (the task name with spaces
    when it has neither): the lang_annotation_cache.json layout,
    list[seq][subtask] -> text."""
    r = np.random.RandomState(seed)
    base = base_annotations or {}
    cache = []
    for _, chain in sequences:
        row = []
        for task in chain:
            cands = list(enrich_lang.get(task, []))
            if task in base:
                cands.append(base[task])
            if not cands:
                cands = [task.replace("_", " ")]
            row.append(cands[r.randint(len(cands))])
        cache.append(row)
    return cache


def save_annotation_cache(path: str, cache: List[List[str]]) -> None:
    with open(path, "w") as f:
        json.dump(cache, f)
