"""Checkpoint sweeps on the port (the JAX package's ``cli/eval_ckpts.py``;
reference eval_ckpts.py + pt_eval_ckpts.bash): ``cli/eval`` in-process for
every (checkpoint x ``--exit_ratio``), its stdout in
``<log_dir>/<name>_ratio<r>.log`` and its report in the ``.json`` beside
it.  A combination whose log exists and is not empty is skipped, so a
sweep restarts where it stopped (eval_ckpts.py:58-60); a log is renamed
into place when its run completes, so a run that failed runs again.
``*_ema.ckpt`` siblings are left out unless ``--include_ema``.  Arguments
after ``--`` go to ``cli/eval``:

    python -m deer_vla_tpu_torch.cli.eval_ckpts --ckpt_dir runs/deer \
        --exit_ratio 0.5 1.0 --debug -- --calib_batches 2 --quantize int8

``main(argv, device=None)`` runs on the card; ``device="cpu"`` runs the
plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
from typing import Optional

from deer_vla_tpu_torch.utils.errors import record


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="checkpoint x exit-ratio sweeps on the PyTorch port")
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--log_dir", default="")
    p.add_argument("--exit_ratio", type=float, nargs="+", default=[1.0])
    p.add_argument("--max_layer", type=int, default=-1)
    p.add_argument("--num_seq", type=int, default=224)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--pattern", default="*_[0-9]*.ckpt")
    p.add_argument("--include_ema", action="store_true",
                   help="also sweep <name>_ema.ckpt siblings (--ema_decay "
                        "training); excluded by default so epoch ckpts "
                        "aren't double-counted")
    p.add_argument("extra", nargs=argparse.REMAINDER,
                   help="extra args forwarded to cli.eval")
    return p


@record
def main(argv=None, device: Optional[str] = None) -> int:
    """Run the sweep; 1 when no checkpoint matches, else 0."""
    from deer_vla_tpu_torch.cli import eval as eval_cli
    from deer_vla_tpu_torch.core.device import resolve_device
    args = build_parser().parse_args(argv)
    resolve_device(device)  # no card and no device: raise before any run

    log_dir = args.log_dir or ("log_" + args.ckpt_dir.strip("/")
                               .replace("/", "_"))
    os.makedirs(log_dir, exist_ok=True)
    ckpts = sorted(glob.glob(os.path.join(args.ckpt_dir, args.pattern)))
    if not args.include_ema:
        ckpts = [c for c in ckpts if not c.endswith("_ema.ckpt")]
    if not ckpts:
        print(f"no checkpoints matching {args.pattern} in {args.ckpt_dir}")
        return 1

    for ckpt in ckpts:
        for ratio in args.exit_ratio:
            name = os.path.basename(ckpt).replace(".ckpt", "")
            log_file = os.path.join(log_dir, f"{name}_ratio{ratio}.log")
            if os.path.exists(log_file) and os.path.getsize(log_file) > 0:
                print(f"skip (done): {log_file}")
                continue
            print(f"eval {ckpt} exit_ratio={ratio} -> {log_file}")
            eval_args = ["--evaluate_from_checkpoint", ckpt,
                         "--exit_ratio", str(ratio),
                         "--num_seq", str(args.num_seq),
                         "--max_layer", str(args.max_layer)]
            if args.debug:
                eval_args.append("--debug")
            eval_args += [a for a in args.extra if a != "--"]
            if not any(a == "--report_json" or a.startswith("--report_json=")
                       for a in eval_args):
                # machine-readable sweep results beside the logs
                eval_args += ["--report_json", log_file[:-4] + ".json"]
            # the log ends in the three-line parse contract; it is renamed
            # into place only when the run completes, so a failed run is
            # not skipped on restart
            with open(log_file + ".tmp", "w") as f, \
                    contextlib.redirect_stdout(f):
                eval_cli.main(eval_args, device=device)
            os.replace(log_file + ".tmp", log_file)
            with open(log_file) as f:
                tail = f.readlines()[-3:]
            print("  result:", " | ".join(x.strip() for x in tail))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
