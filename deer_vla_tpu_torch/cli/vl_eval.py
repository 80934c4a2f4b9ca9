"""Vision-language benchmark CLI of the port (the JAX package's
``cli/vl_eval.py``; upstream open_flamingo/eval/evaluate.py): captions
(COCO json, Flickr30k Karpathy json), VQA (VQAv2, TextVQA, VizWiz, OK-VQA:
each dataset's image naming, eval_datasets.py:85-97, and the official
VQAEval accuracy), zero-shot classification (ImageNet-style) and hateful
memes, by greedy decoding or LM-likelihood ranking, optionally with K-shot
in-context prompts whose demos RICES retrieves, and test-server prediction
files.

    python -m deer_vla_tpu_torch.cli.vl_eval --task caption --debug \
        --eval_model blip --model base
    python -m deer_vla_tpu_torch.cli.vl_eval --task vqa --debug \
        --model mpt_dolly_3b --fewshot --shots 2 --rices

``--debug`` writes a synthetic fixture (random 32 px frames as binary PPM,
which the port reads with numpy; their json files) into a temporary
directory; its VQA questions name their image files, as VizWiz's do.
``main(argv, device=None)`` runs on the card; ``device="cpu"`` runs the
plain versions on the CPU.  The result is one JSON line on stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
from typing import Optional

import numpy as np

from deer_vla_tpu_torch.utils.errors import record

VQA_DATASETS = {"vqa": "vqav2", "okvqa": "ok_vqa", "textvqa": "textvqa",
                "vizwiz": "vizwiz"}


def build_parser():
    p = argparse.ArgumentParser(description="DeeR-VLA VL benchmark eval on "
                                            "the PyTorch port")
    p.add_argument("--task",
                   choices=["caption", "flickr", "vqa", "textvqa", "vizwiz",
                            "okvqa", "classify", "imagenet", "hateful_memes"],
                   default="caption",
                   help="caption=COCO-style json; flickr=karpathy-split json "
                        "scored by CIDEr-D; vqa/textvqa/vizwiz share the "
                        "official VQAEval accuracy; okvqa adds the stemmed-"
                        "answer protocol; classify/imagenet rank class "
                        "continuations by LM NLL (imagenet under the "
                        "'Output:' prompt); hateful_memes scores yes/no, "
                        "headline ROC-AUC (evaluate.py:1154-1291)")
    p.add_argument("--save_predictions", default="",
                   help="write the predictions json ([{answer, question_id}]"
                        " / [{image_id, caption}]) for test-server "
                        "submission")
    p.add_argument("--labels", default="",
                   help="classify / imagenet: json {classes: [...], "
                        "samples: [{file_name, label}]}")
    p.add_argument("--model", default="tiny",
                   help="flamingo: a registry name (mpt_dolly_3b, mpt_9b, "
                        "llama_9b, tiny, deer_3b); blip: tiny or any other "
                        "name for blip_base")
    p.add_argument("--eval_model", default="flamingo",
                   choices=["flamingo", "blip"],
                   help="the eval-model family (evaluate.py --model): "
                        "flamingo = the DeeR stack, blip = models/blip.py")
    p.add_argument("--evaluate_from_checkpoint", default="")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--tokenizer_path", default="")
    p.add_argument("--image_dir", default="")
    p.add_argument("--annotations", default="")
    p.add_argument("--questions", default="")
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=10)
    p.add_argument("--decode_engine", default="auto",
                   choices=["auto", "recompute", "kv_cache"],
                   help="flamingo generation: recompute re-runs the buffer "
                        "a token; kv_cache prefills each layer's K/V once "
                        "(eval/kv_decode.py); auto takes the cache from a "
                        "buffer of 48 tokens")
    p.add_argument("--rices", action="store_true",
                   help="report RICES retrieval indices for shot selection")
    p.add_argument("--cached_features", default="",
                   help="npz feature index from cli/cache_features; skips "
                        "the RICES embedding sweep")
    p.add_argument("--shots", type=int, default=2)
    p.add_argument("--fewshot", action="store_true",
                   help="K-shot in-context prompts (K=--shots): demos with "
                        "their ground truth before the query "
                        "(evaluate.py:1216-1239), RICES neighbours with "
                        "--rices else seeded draws, the query excluded")
    p.add_argument("--max_layer", type=int, default=-1)
    p.add_argument("--debug", action="store_true",
                   help="synthetic images and annotations, no dataset")
    p.add_argument("--seed", type=int, default=42)
    return p


def _synthetic_fixture(args, tmpdir):
    """(img_dir, ann_p, q_p, a_p) of a fixture in ``tmpdir``: max(8,
    num_samples) random 32 px frames as PPM, COCO / Karpathy caption json,
    VQA questions (image_id = the file name) and answers."""
    from deer_vla_tpu_torch.data.vl_dataset import write_ppm
    img_dir = os.path.join(tmpdir, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, anns, karp, questions, answers = [], [], [], [], []
    r = np.random.RandomState(args.seed)
    for i in range(max(8, args.num_samples)):
        fn = f"{i}.ppm"
        write_ppm(os.path.join(img_dir, fn),
                  r.randint(0, 256, (32, 32, 3), np.uint8))
        images.append({"id": i, "file_name": fn})
        anns.append({"image_id": i, "caption": f"a synthetic object {i % 5}"})
        karp.append({"filename": fn, "split": "test",
                     "sentences": [{"raw": f"a synthetic object {i % 5}"},
                                   {"raw": f"the object {i % 5} photo"}]})
        questions.append({"question": f"what is object {i % 5}?",
                          "question_id": i, "image_id": fn})
        answers.append({"answers": [{"answer": f"object {i % 5}"}] * 3})
    ann_p = os.path.join(tmpdir, "ann.json")
    q_p = os.path.join(tmpdir, "q.json")
    a_p = os.path.join(tmpdir, "a.json")
    for path, obj in ((ann_p, {"images": karp} if args.task == "flickr"
                       else {"images": images, "annotations": anns}),
                      (q_p, {"questions": questions}),
                      (a_p, {"annotations": answers})):
        with open(path, "w") as f:
            json.dump(obj, f)
    return img_dir, ann_p, q_p, a_p


def resolve_paths(args, tmpdir: Optional[str]):
    """(img_dir, ann_p, q_p, a_p): the fixture in ``tmpdir`` under
    --debug, else the path flags (VQA answers ride --annotations)."""
    if args.debug:
        return _synthetic_fixture(args, tmpdir)
    return (args.image_dir, args.annotations, args.questions,
            args.annotations)


@contextlib.contextmanager
def fixture_dir(args):
    """A temporary directory for --debug's fixture (None without it),
    removed on exit."""
    if not args.debug:
        yield None
        return
    with tempfile.TemporaryDirectory(prefix="vl_eval_") as d:
        yield d


def build_dataset(args, size, img_dir, ann_p, q_p, a_p):
    """Task -> dataset, shared by vl_eval and cache_features."""
    from deer_vla_tpu_torch.data.vl_dataset import (CaptionDataset,
                                                    KarpathyCaptionDataset,
                                                    VQADataset)
    if args.task == "flickr":
        return KarpathyCaptionDataset(img_dir, ann_p, dataset_name="flickr",
                                      is_train=False, image_size=size)
    if args.task == "caption":
        return CaptionDataset(img_dir, ann_p, image_size=size)
    # the fixture's questions name their files, as VizWiz's do
    ds_name = "vizwiz" if args.debug else VQA_DATASETS[args.task]
    return VQADataset(img_dir, q_p, a_p, dataset_name=ds_name,
                      image_size=size)


def _run_hateful_memes(args, model, img_dir, size):
    """The hateful-memes protocol (evaluate.py:1154-1291): a meme's 'no' and
    'yes' continuations of the OCR prompt ranked by NLL; ROC-AUC over the
    softmax probability of 'yes'.  --annotations is the jsonl of {img,
    text, label} rows."""
    from deer_vla_tpu_torch.data.vl_dataset import _load_image, write_ppm
    from deer_vla_tpu_torch.eval.vl_eval import roc_auc
    if args.debug:
        r = np.random.RandomState(args.seed)
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(max(8, args.num_samples)):
            fn = f"meme_{i}.ppm"
            write_ppm(os.path.join(img_dir, fn),
                      r.randint(0, 256, (32, 32, 3), np.uint8))
            rows.append({"img": fn, "text": f"meme text {i % 4}",
                         "label": i % 2})
    else:
        if not args.annotations:
            raise SystemExit("--task hateful_memes needs --annotations "
                             "<dev.jsonl> (or --debug)")
        with open(args.annotations) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    n = min(args.num_samples, len(rows))
    gts, pred_scores = [], []
    for row in rows[:n]:
        img = _load_image(os.path.join(img_dir, row["img"]), size)
        nll = model.score_texts(
            model.preprocess(img[None]), ["no", "yes"],
            prompt=model.get_hateful_memes_prompt(row["text"]))
        logp = -np.asarray(nll, np.float64)
        pred_scores.append(float(np.exp(logp[1]) / np.exp(logp).sum()))
        gts.append(int(row["label"]))
    return {"task": "hateful_memes", "n": n, "metric": "roc_auc",
            "score": roc_auc(gts, pred_scores)}


def _run_classify(args, model, img_dir, size):
    """Zero-shot classification: class-name continuations ranked by summed
    NLL an image, top-1 accuracy; imagenet under the 'Output:' prompt
    (evaluate.py:639-679)."""
    from deer_vla_tpu_torch.data.vl_dataset import _load_image
    if args.debug:
        # the fixture's frames are {i}.ppm with class i % 5
        classes = [f"object {k}" for k in range(5)]
        samples = [{"file_name": f"{i}.ppm", "label": i % 5}
                   for i in range(max(8, args.num_samples))]
    else:
        if not args.labels:
            raise SystemExit(f"--task {args.task} needs --labels "
                             "<spec.json> (or --debug)")
        with open(args.labels) as f:
            spec = json.load(f)
        classes, samples = spec["classes"], spec["samples"]
    n = min(args.num_samples, len(samples))
    prompt = (model.get_imagenet_prompt().rstrip()
              if args.task == "imagenet" else "A photo of a")
    correct = 0
    for s in samples[:n]:
        img = _load_image(os.path.join(img_dir, s["file_name"]), size)
        scores = model.score_texts(model.preprocess(img[None]), classes,
                                   prompt=prompt)
        correct += int(int(np.argmin(scores)) == int(s["label"]))
    return {"task": args.task, "n": n, "metric": "top1_acc",
            "score": correct / max(n, 1), "n_classes": len(classes)}


def demo_indices(args, n, q, feats):
    """(n, shots) demo indices a query: RICES neighbours (the query
    excluded) with --rices, else seeded draws from the other samples."""
    from deer_vla_tpu_torch.eval.vl_eval import rices_retrieve
    if args.shots < 1 or n <= args.shots:
        raise SystemExit("--fewshot needs 1 <= --shots < num samples")
    if args.rices and args.cached_features:
        raise SystemExit("--fewshot demos must be resolvable samples; "
                         "--cached_features indexes a feature file whose "
                         "source samples are not loaded here")
    if args.rices:
        # the upstream retrieves from the train split, so the query never
        # appears
        cand = rices_retrieve(q, feats, args.shots + 1)
        return np.stack([np.array([j for j in row if j != i][-args.shots:])
                         for i, row in enumerate(cand)])
    r = np.random.RandomState(args.seed)
    return np.stack([r.choice(np.setdiff1d(np.arange(n), [i]),
                              size=args.shots, replace=False)
                     for i in range(n)])


def _run_generation(args, model, ds):
    """Caption / VQA by greedy decoding over the dataset's first
    num_samples items."""
    from deer_vla_tpu_torch.eval.vl_eval import (caption_bleu1, cider_d,
                                                 okvqa_accuracy,
                                                 postprocess_vqa_generation,
                                                 rices_retrieve, vqa_accuracy)
    is_caption = args.task in ("caption", "flickr")
    n = min(args.num_samples, len(ds))
    rices_idx = demo_idx = q = feats = None
    if args.rices:
        raw = np.stack([ds[i]["image"] for i in range(n)])
        bs = args.batch_size
        q = np.concatenate([model.embed_images(raw[i:i + bs])
                            for i in range(0, n, bs)], 0)
        feats = (np.load(args.cached_features)["features"]
                 if args.cached_features else q)
        rices_idx = rices_retrieve(q, feats, args.shots)
    if args.fewshot:
        demo_idx = demo_indices(args, n, q, feats)

    scores, cap_preds, cap_refs, predictions = [], [], [], []
    for start in range(0, n, args.batch_size):
        idxs = list(range(start, min(start + args.batch_size, n)))
        samples = [ds[i] for i in idxs]
        if is_caption:
            finals = [model.get_caption_prompt() for _ in samples]
        else:
            finals = [model.get_vqa_prompt(s["question"]) for s in samples]
        if demo_idx is not None:
            demos = [[ds[int(j)] for j in demo_idx[i]] for i in idxs]
            if is_caption:
                demo_texts = [[model.get_caption_prompt(d["caption"])
                               for d in row] for row in demos]
            else:
                demo_texts = [[model.get_vqa_prompt(
                    d["question"], (d.get("answers") or [""])[0])
                    for d in row] for row in demos]
            prompts = [model.build_fewshot_prompt(dt, f)
                       for dt, f in zip(demo_texts, finals)]
            vision = model.build_fewshot_vision(
                [[d["image"] for d in row] for row in demos],
                [s["image"] for s in samples])
            texts = model.get_outputs(vision, prompts,
                                      max_new_tokens=args.max_new_tokens,
                                      raw=True)
        else:
            vision = model.preprocess(np.stack([s["image"]
                                                for s in samples]))
            texts = model.get_outputs(vision, finals,
                                      max_new_tokens=args.max_new_tokens)
        for text, s in zip(texts, samples):
            if is_caption:
                refs = s.get("captions", [s["caption"]])
                scores.append(caption_bleu1(text, refs))
                cap_preds.append(text)
                cap_refs.append(refs)
                predictions.append({"image_id": s["image_id"],
                                    "caption": text})
                continue
            if args.task == "okvqa":
                scores.append(okvqa_accuracy(text, s.get("answers", [])))
            else:
                scores.append(vqa_accuracy(postprocess_vqa_generation(text),
                                           s.get("answers", [])))
            predictions.append({"answer": postprocess_vqa_generation(text),
                                "question_id": s["question_id"]})

    metric = {"caption": "bleu1", "flickr": "cider", "vqa": "vqa_acc",
              "textvqa": "textvqa_acc", "vizwiz": "vizwiz_acc",
              "okvqa": "okvqa_acc"}[args.task]
    result = {"task": args.task, "n": n, "metric": metric,
              "shots": args.shots if args.fewshot else 0}
    if is_caption:
        result["cider"] = cider_d(cap_preds, cap_refs)
        result["bleu1"] = float(np.mean(scores)) if scores else 0.0
        # CIDEr is flickr's headline (evaluate.py:886-895); caption keeps
        # bleu1 as its score
        result["score"] = (result["cider"] if args.task == "flickr"
                           else result["bleu1"])
    else:
        result["score"] = float(np.mean(scores)) if scores else 0.0
    if rices_idx is not None:
        result["rices_example"] = rices_idx[0].tolist()
    if args.save_predictions:
        with open(args.save_predictions, "w") as f:
            json.dump(predictions, f)
        result["predictions_path"] = args.save_predictions
    return result


@record
def main(argv=None, device: Optional[str] = None) -> dict:
    args = build_parser().parse_args(argv)
    from deer_vla_tpu_torch.eval.eval_models import make_eval_model
    model = make_eval_model(args, device)
    size = model.image_size
    with fixture_dir(args) as tmp:
        img_dir, ann_p, q_p, a_p = resolve_paths(args, tmp)
        if args.task in ("classify", "imagenet"):
            result = _run_classify(args, model, img_dir, size)
        elif args.task == "hateful_memes":
            result = _run_hateful_memes(args, model, img_dir, size)
        else:
            ds = build_dataset(args, size, img_dir, ann_p, q_p, a_p)
            result = _run_generation(args, model, ds)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
