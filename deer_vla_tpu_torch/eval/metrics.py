"""Rollout metrics (a copy of the JAX package's ``eval/metrics.py``, the
port of eval_utils.py:53-118).

``count_success``: chain success rates for 1..5 instructions in a row;
``count_exit_ratio``: per-layer exit histograms; ``summarize``: the report
dict (average successful sequence length, chain success rates, exit
histograms, per-task success, LLM ms, LLM GFLOPs from the exit layers).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np


def count_success(results: Sequence[int]) -> List[float]:
    count = Counter(results)
    out = []
    for i in range(1, 6):
        n_success = sum(count[j] for j in range(i, 6))
        out.append(n_success / max(len(results), 1))
    return out


def count_exit_ratio(exit_layers: Sequence[int], n_layers: int
                     ) -> List[float]:
    count = Counter(exit_layers)
    return [count[i] / max(len(exit_layers), 1) for i in range(n_layers)]


def summarize(results: List[int], success_exits: List[int],
              fail_exits: List[int], step_counts: List[int],
              success_llm_times: List[float], sequences: List,
              n_layers: int, flops_per_layer: Optional[float] = None) -> Dict:
    avg_seq_len = float(np.mean(results)) if results else 0.0
    chain_sr = {i + 1: sr for i, sr in enumerate(count_success(results))}
    data = {
        "avg_seq_len": avg_seq_len,
        "chain_sr": chain_sr,
        "success_exit_hist": count_exit_ratio(success_exits, n_layers),
        "fail_exit_hist": count_exit_ratio(fail_exits, n_layers),
        "avg_exit_layer": float(np.mean(success_exits + fail_exits) + 1)
        if (success_exits or fail_exits) else 0.0,
        "avg_llm_ms": float(np.mean(success_llm_times) * 1000)
        if success_llm_times else 0.0,
        "total_success_steps": int(np.sum(step_counts)) if step_counts else 0,
    }
    if flops_per_layer is not None:
        data["avg_llm_gflops"] = data["avg_exit_layer"] * flops_per_layer / 1e9

    # per-task success table (eval_utils.py:96-111)
    cnt_success, cnt_fail = Counter(), Counter()
    for result, seq in zip(results, sequences):
        subtasks = (seq[1] if isinstance(seq, (tuple, list)) and len(seq) == 2
                    else seq)
        for st in subtasks[:result]:
            cnt_success[st] += 1
        if result < len(subtasks):
            cnt_fail[subtasks[result]] += 1
    total = cnt_success + cnt_fail
    data["task_info"] = {t: {"success": cnt_success[t], "total": total[t]}
                         for t in sorted(total)}
    return data


def format_report(data: Dict) -> str:
    lines = [f"Average successful sequence length: {data['avg_seq_len']:.4f}"]
    for i, sr in data["chain_sr"].items():
        lines.append(f"{i}: {sr * 100:.1f}%")
    lines.append(f"avg exit layer: {data['avg_exit_layer']:.2f}")
    if "avg_llm_gflops" in data:
        lines.append(f"avg LLM GFLOPs: {data['avg_llm_gflops']:.2f}")
    lines.append(f"avg LLM ms: {data['avg_llm_ms']:.1f}")
    for t, ti in data.get("task_info", {}).items():
        sr = ti["success"] / max(ti["total"], 1)
        lines.append(f"{t}: {ti['success']} / {ti['total']} | "
                     f"SR: {sr * 100:.1f}%")
    return "\n".join(lines)
