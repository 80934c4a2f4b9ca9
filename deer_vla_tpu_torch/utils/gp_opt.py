"""Minimal Gaussian-process minimizer (a copy of the JAX package's
``utils/gp_opt.py``, which the port does not import; numpy and scipy only).

The reference searches the exit thresholds online with scikit-optimize's
gp_minimize (bayesian_optimization.py:157-165).  This is a compact
GP-EI / LCB / PI minimizer with the same call shape: box bounds, an
optional (x0, y0) warm start, an n_calls budget; ``gp_minimize_lite_batch``
proposes q points a round for ``cli/bayes_opt --parallel``.  Given the same
objective and ``random_state`` both packages propose the same points bit
for bit (``tests/test_torch_gp_opt.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial.distance import cdist
from scipy.stats import norm


def _matern52(a: np.ndarray, b: np.ndarray, length: np.ndarray) -> np.ndarray:
    d = cdist(a / length, b / length)
    s = np.sqrt(5.0) * d
    return (1.0 + s + s * s / 3.0) * np.exp(-s)


@dataclass
class GPResult:
    x: List[float]
    fun: float
    x_iters: List[List[float]]
    func_vals: List[float]


def gp_minimize_lite(objective: Callable[[Sequence[float]], float],
                     bounds: Sequence[Tuple[float, float]],
                     *, x0: Optional[Sequence[Sequence[float]]] = None,
                     y0: Optional[Sequence[float]] = None,
                     n_calls: int = 20, n_initial: int = 5,
                     acq_func: str = "EI", random_state: int = 1,
                     noise: float = 1e-6, n_candidates: int = 4096) -> GPResult:
    rng = np.random.RandomState(random_state)
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    span = np.maximum(hi - lo, 1e-12)

    X: List[np.ndarray] = [np.asarray(x, float) for x in (x0 or [])]
    y: List[float] = [float(v) for v in (y0 or [])]
    if len(X) != len(y):
        raise ValueError(f"{len(X)} warm-start points, {len(y)} values")

    def ask_random():
        return lo + rng.rand(len(bounds)) * span

    n_rand = max(0, n_initial - len(X))
    evals_left = n_calls

    def evaluate(x):
        nonlocal evals_left
        v = float(objective(list(x)))
        X.append(np.asarray(x, float))
        y.append(v)
        evals_left -= 1
        return v

    for _ in range(min(n_rand, evals_left)):
        evaluate(ask_random())

    if not X and evals_left > 0:
        # no warm start and n_initial=0: the GP needs at least one
        # observation — seed with the bounds center
        evaluate(lo + 0.5 * span)

    length = span * 0.25
    while evals_left > 0:
        ya = np.asarray(y)
        ymu, ystd = ya.mean(), max(ya.std(), 1e-12)
        cand = lo + rng.rand(n_candidates, len(bounds)) * span
        score = _acq_scores(cand, np.stack(X), (ya - ymu) / ystd, length,
                            acq_func, noise)
        evaluate(cand[int(np.argmax(score))])

    i = int(np.argmin(y))
    return GPResult(x=list(X[i]), fun=y[i],
                    x_iters=[list(x) for x in X], func_vals=list(y))


def _acq_scores(cand, Xa, yn, length, acq_func, noise):
    """Posterior + acquisition over ``cand`` given observations (Xa, yn)."""
    K = _matern52(Xa, Xa, length) + noise * np.eye(len(Xa))
    try:
        L = np.linalg.cholesky(K)
    except np.linalg.LinAlgError:
        L = np.linalg.cholesky(K + 1e-4 * np.eye(len(Xa)))
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
    Ks = _matern52(cand, Xa, length)
    mu = Ks @ alpha
    v = np.linalg.solve(L, Ks.T)
    sigma = np.sqrt(np.maximum(1.0 - np.sum(v * v, axis=0), 1e-12))
    best = yn.min()
    if acq_func == "LCB":
        return -(mu - 1.96 * sigma)
    if acq_func == "PI":
        return norm.cdf((best - mu) / sigma)
    z = (best - mu) / sigma
    return sigma * (z * norm.cdf(z) + norm.pdf(z))  # EI


def gp_minimize_lite_batch(objective_batch: Callable[[List[List[float]]],
                                                     Sequence[float]],
                           bounds: Sequence[Tuple[float, float]],
                           *, q: int,
                           x0: Optional[Sequence[Sequence[float]]] = None,
                           y0: Optional[Sequence[float]] = None,
                           n_calls: int = 20,
                           acq_func: str = "EI", random_state: int = 1,
                           noise: float = 1e-6,
                           n_candidates: int = 4096) -> GPResult:
    """q-batch GP minimization: ``objective_batch`` evaluates q points AT
    ONCE (the parallel-BO rollout evaluates q threshold candidates in one
    batched program).  Batch proposals use the constant-liar heuristic:
    after greedily picking an acquisition argmax, the point is added to the
    working posterior with the incumbent-best value so the next pick seeks
    a DIFFERENT region (skopt's strategy='cl_min' equivalent).  n_calls
    counts single-point evaluations; rounds ALWAYS evaluate exactly q
    points (batched rollouts need a fixed candidate count per dispatch —
    lanes divide q), so up to q-1 evaluations beyond n_calls may run to
    complete the final round."""
    rng = np.random.RandomState(random_state)
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    span = np.maximum(hi - lo, 1e-12)
    length = span * 0.25

    X: List[np.ndarray] = [np.asarray(x, float) for x in (x0 or [])]
    y: List[float] = [float(v) for v in (y0 or [])]
    if len(X) != len(y):
        raise ValueError(f"{len(X)} warm-start points, {len(y)} values")
    evals_left = n_calls

    def eval_batch(points):
        nonlocal evals_left
        vals = [float(v) for v in objective_batch([list(p) for p in points])]
        if len(vals) != len(points):
            raise ValueError(f"{len(vals)} values for {len(points)} points")
        X.extend(np.asarray(p, float) for p in points)
        y.extend(vals)
        evals_left -= len(points)

    if not X and evals_left > 0:
        # seed round: center + random q-1 (one batched evaluation)
        eval_batch([lo + 0.5 * span] +
                   [lo + rng.rand(len(bounds)) * span for _ in range(q - 1)])

    while evals_left > 0:
        Xa = np.stack(X)
        ya = np.asarray(y)
        ymu, ystd = ya.mean(), max(ya.std(), 1e-12)
        yn = list((ya - ymu) / ystd)
        Xw = [x for x in Xa]
        picks = []
        for _ in range(q):
            cand = lo + rng.rand(n_candidates, len(bounds)) * span
            score = _acq_scores(cand, np.stack(Xw), np.asarray(yn), length,
                                acq_func, noise)
            pick = cand[int(np.argmax(score))]
            picks.append(pick)
            Xw.append(pick)
            yn.append(min(yn))  # constant liar: assume it wins
        eval_batch(picks)

    i = int(np.argmin(y))
    return GPResult(x=list(X[i]), fun=y[i],
                    x_iters=[list(x) for x in X], func_vals=list(y))
