"""Online Bayesian-optimization search of the exit thresholds on the port
(the JAX package's ``cli/bayes_opt.py``; reference
bayesian_optimization.py).

  1. The initial point: one ``cli/eval`` run with thresholds solved from
     the exit distribution at ``--init_exit_ratio``; its average exit layer
     becomes the compute budget.
  2. A GP minimizes the free thresholds in a box around the initial point
     (+-``--t0_box`` for the first, +-``--t_box`` for the others; the last
     exit's stays 1e5, it always fires).
  3. The objective is ``-avg_len + max(0, avg_exit - budget)`` (:19-24).

Serially each evaluation is a ``cli/eval`` run in-process whose last three
stdout lines (thresholds, average length, average exit - 1) are parsed.
``--parallel q`` evaluates q candidates a GP round in one batched rollout
over ``q * --lanes_per_candidate`` DebugEnv lanes
(``eval/batched_rollout.evaluate_policy_batched(candidates=)``), a
diffusion model's lanes through ``BatchedDiffusionSampler``.  Rollouts run
in the DebugEnv: the CALVIN env is dropped for good (ROADMAP.md), so
``--calvin_conf_path`` raises SystemExit.

    python -m deer_vla_tpu_torch.cli.bayes_opt --debug --model deer_3b \
        --parallel 2 --lanes_per_candidate 2 --n_calls 4 --num_seq 2

``main(argv, device=None)`` runs on the card; ``device="cpu"`` runs the
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
from typing import Optional

from deer_vla_tpu_torch.utils.errors import record


def run_eval(eval_args, device=None) -> tuple:
    """``cli/eval.main`` with its stdout captured; (thresholds, avg_len,
    avg_exit) from its last three lines."""
    from deer_vla_tpu_torch.cli import eval as eval_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_cli.main(eval_args, device=device)
    lines = [l for l in buf.getvalue().strip().splitlines() if l.strip()]
    thresholds = [float(x) for x in lines[-3].split(",")] if lines[-3] else []
    return thresholds, float(lines[-2]), float(lines[-1])


def report_eval(th, avg_len: float, avg_exit: float, s: float) -> None:
    print(f"BO eval thresholds={['%.5f' % t for t in th]} "
          f"len={avg_len:.4f} exit={avg_exit:.3f} score={s:.4f}")


def report_result(result) -> None:
    print("Optimal thresholds:", [round(t, 6) for t in result.x] + [1e5])
    print("Best score:", result.fun)


def run_parallel_bo(args, init_th, init_len, init_exit, bounds, score,
                    device=None):
    """q candidates a GP round, all evaluated in one batched rollout: the
    lanes split into q blocks, block k serving candidate k's thresholds
    through the engine's (B, n_layers) rows (the reference runs each
    candidate as a serial eval, bayesian_optimization.py:130-144)."""
    from deer_vla_tpu_torch.cli.eval import load_model
    from deer_vla_tpu_torch.core.device import resolve_device
    from deer_vla_tpu_torch.data.text import HashTokenizer
    from deer_vla_tpu_torch.eval.batched_rollout import \
        evaluate_policy_batched
    from deer_vla_tpu_torch.eval.diffusion_policy import \
        BatchedDiffusionSampler
    from deer_vla_tpu_torch.eval.rollout import (DebugEnv, DebugTaskOracle,
                                                 make_debug_sequences)
    from deer_vla_tpu_torch.eval.scan_policy import ScanDeerPolicy
    from deer_vla_tpu_torch.utils.gp_opt import gp_minimize_lite_batch

    dev = resolve_device(device)
    q = args.parallel
    b = q * args.lanes_per_candidate
    cfg, params = load_model(args, dev)
    tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size, max_length=cfg.text_len)
    cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
    policy = ScanDeerPolicy(
        params, cfg, max_layer=args.max_layer if args.max_layer > 0 else None,
        indexed_mm=cfg.mpt.arch == "mpt", device=dev)
    if cfg.head_type == "diffusion":
        # the lanes' DDPM plans around the engine; the thresholds act on
        # the feature deltas, upstream of the plans
        policy = BatchedDiffusionSampler(policy, params, seed=args.seed)
    envs = [DebugEnv(img_hw=cfg.vit.image_size, grip_hw=cfg.vit.image_size)
            for _ in range(b)]
    oracle = DebugTaskOracle(threshold=0.05)
    sequences = make_debug_sequences(args.num_seq)[:args.num_seq]
    n_free = len(init_th) - 1

    def objective_batch(points):
        cands = [list(p) + [1e5] for p in points]
        reports = evaluate_policy_batched(
            policy, envs, sequences, {}, oracle, tok, text_len=cfg.text_len,
            ep_len=40, n_layers=cfg.n_layers, pipeline=args.pipeline,
            candidates=cands)
        out = []
        for th, rep in zip(cands, reports):
            avg_exit = rep["avg_exit_layer"] - 1
            s = score(rep["avg_seq_len"], avg_exit)
            report_eval(th, rep["avg_seq_len"], avg_exit, s)
            out.append(s)
        return out

    result = gp_minimize_lite_batch(
        objective_batch, bounds, q=q, x0=[init_th[:n_free]],
        y0=[score(init_len, init_exit)], n_calls=args.n_calls,
        acq_func=args.acq_func, random_state=args.seed)
    report_result(result)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Bayesian-optimization threshold search on the "
                    "PyTorch port")
    p.add_argument("--evaluate_from_checkpoint", default="")
    p.add_argument("--num_seq", type=int, default=56)
    p.add_argument("--acq_func", default="EI", choices=["EI", "LCB", "PI"])
    p.add_argument("--n_calls", type=int, default=20)
    p.add_argument("--init_exit_ratio", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--t0_box", type=float, default=0.02)
    p.add_argument("--t_box", type=float, default=0.002)
    p.add_argument("--parallel", type=int, default=1,
                   help=">1: evaluate this many BO candidates a GP round "
                        "in one batched rollout (constant-liar q-batch "
                        "acquisition; lanes split across candidates)")
    p.add_argument("--lanes_per_candidate", type=int, default=4)
    p.add_argument("--pipeline", type=int, default=1)
    p.add_argument("--model", default="tiny")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--max_layer", type=int, default=-1)
    p.add_argument("--tokenizer_path", default="")
    p.add_argument("--calvin_conf_path", default="")
    return p


@record
def main(argv=None, device: Optional[str] = None):
    from deer_vla_tpu_torch.cli.eval import CALVIN_ENV_DROPPED
    from deer_vla_tpu_torch.core.device import resolve_device
    from deer_vla_tpu_torch.utils.gp_opt import gp_minimize_lite
    args = build_parser().parse_args(argv)
    if args.calvin_conf_path:
        raise SystemExit(f"--calvin_conf_path: {CALVIN_ENV_DROPPED}")
    resolve_device(device)  # no card and no device: raise before any run

    # the model flags go to every eval, so the initial point (the budget)
    # sees the model the objective runs
    base = []
    if args.evaluate_from_checkpoint:
        base += ["--evaluate_from_checkpoint", args.evaluate_from_checkpoint]
    if args.debug:
        base += ["--debug"]
    base += ["--num_seq", str(args.num_seq), "--model", args.model,
             "--precision", args.precision, "--seed", str(args.seed)]
    if args.max_layer > 0:
        base += ["--max_layer", str(args.max_layer)]
    if args.tokenizer_path:
        base += ["--tokenizer_path", args.tokenizer_path]

    # 1) the initial point from the exit distribution's thresholds
    init_th, init_len, init_exit = run_eval(
        base + ["--exit_ratio", str(args.init_exit_ratio)], device)
    budget = init_exit
    print(f"init thresholds={init_th} avg_len={init_len} avg_exit={init_exit}")

    n_free = len(init_th) - 1  # the last threshold stays 1e5
    if n_free < 1:
        print("nothing to optimize (single exit)")
        return None
    boxes = [args.t0_box] + [args.t_box] * (n_free - 1)
    bounds = [(init_th[i] - boxes[i], init_th[i] + boxes[i])
              for i in range(n_free)]

    def score(avg_len, avg_exit):
        return -avg_len + max(0.0, avg_exit - budget)  # :19-24

    if args.parallel > 1:
        return run_parallel_bo(args, init_th, init_len, init_exit, bounds,
                               score, device)

    def objective(ts):
        th = list(ts) + [1e5]
        _, avg_len, avg_exit = run_eval(
            base + ["--thresholds"] + [str(t) for t in th], device)
        s = score(avg_len, avg_exit)
        report_eval(th, avg_len, avg_exit, s)
        return s

    result = gp_minimize_lite(
        objective, bounds, x0=[init_th[:n_free]],
        y0=[score(init_len, init_exit)], n_calls=args.n_calls,
        acq_func=args.acq_func, random_state=args.seed)
    report_result(result)
    return result


if __name__ == "__main__":
    main()
