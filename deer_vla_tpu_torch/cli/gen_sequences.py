"""Write the frozen evaluation artifacts (the JAX package's
``cli/gen_sequences.py``):

  eval_sequences.json        N 5-subtask chains (save_sequences,
                             eval_utils.py:729-733)
  lang_annotation_cache.json one enriched instruction a (sequence,
                             subtask) for ``cli/eval --diverse_inst``
                             (eval_utils.py:713-726)

    python -m deer_vla_tpu_torch.cli.gen_sequences --num_sequences 8 \
        --out_sequences seqs.json --out_annotation_cache cache.json

Chains come from CALVIN's task-distribution sampler when calvin_agent is
installed, else uniformly from ``--tasks`` (deterministic in ``--seed``);
for the same seed both files are byte-equal to the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json

from deer_vla_tpu_torch.utils.errors import record


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DeeR-VLA eval sequences and annotation cache")
    p.add_argument("--out_sequences", default="eval_sequences.json")
    p.add_argument("--out_annotation_cache", default="")
    p.add_argument("--num_sequences", type=int, default=1000)
    p.add_argument("--chain_len", type=int, default=5)
    p.add_argument("--tasks", nargs="*", default=None,
                   help="task list for the uniform sampler")
    p.add_argument("--enrich_lang", default="",
                   help="enrich_lang_annotations.json for the cache")
    p.add_argument("--annotations", default="",
                   help="base {task: text} json merged into the candidates")
    p.add_argument("--seed", type=int, default=42)
    return p


@record
def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from deer_vla_tpu_torch.data.debug_data import TASKS
    from deer_vla_tpu_torch.eval.sequences import (generate_annotation_cache,
                                                   generate_sequences,
                                                   save_annotation_cache,
                                                   save_sequences)

    seqs = generate_sequences(args.tasks or TASKS, n=args.num_sequences,
                              chain_len=args.chain_len, seed=args.seed)
    save_sequences(args.out_sequences, seqs)
    print(f"wrote {len(seqs)} sequences -> {args.out_sequences}")
    if args.out_annotation_cache:
        enrich, base = {}, {}
        if args.enrich_lang:
            with open(args.enrich_lang) as f:
                enrich = json.load(f)
        if args.annotations:
            with open(args.annotations) as f:
                base = json.load(f)
        cache = generate_annotation_cache(seqs, enrich, base, seed=args.seed)
        save_annotation_cache(args.out_annotation_cache, cache)
        print(f"wrote annotation cache -> {args.out_annotation_cache}")


if __name__ == "__main__":
    main()
