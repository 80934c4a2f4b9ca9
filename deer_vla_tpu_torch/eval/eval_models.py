"""The VL harness's eval-model families (the JAX package's
``eval/eval_models.py``; upstream open_flamingo/eval/eval_model.py
BaseEvalModel, eval/models/open_flamingo.py and eval/models/blip.py, chosen
by ``--eval_model``).  Each family owns its preprocessing, prompt formats,
greedy generation, rank-classification scorer and RICES image embedding, so
``cli/vl_eval`` runs caption / VQA / classification without knowing which
is loaded.

  - ``FlamingoEvalModel``: the DeeR / OpenFlamingo stack
    (``models/flamingo``, ``eval/vl_eval``, ``eval/kv_decode``);
  - ``BlipEvalModel``: the BLIP captioner (``models/blip``).

Vision inputs stay tensors on the device of the model's weights between
the calls; what goes back to the caller (texts, scores, features) is host
data.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence

import numpy as np
import torch

# the buffer length (prompt + new tokens) from which decode_engine "auto"
# takes the cached engine
AUTO_KV_MIN_BUFFER = 48
# what --tokenizer_path raises: the port loads no transformers tokenizer
TOKENIZER_DROPPED = ("--tokenizer_path needs a transformers tokenizer, "
                     "which the port does not load: ROADMAP.md M9 (a "
                     "transformers tokenizer)")


def _ids(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


class BaseEvalModel:
    """The interface (reference eval_model.py:8-108).  The ``vision`` a
    method takes is what the family's ``preprocess`` returned."""

    name = "base"

    @property
    def image_size(self) -> int:
        raise NotImplementedError

    def preprocess(self, images: np.ndarray):
        """(B, H, W, 3) uint8 raw images -> the model's vision input."""
        raise NotImplementedError

    def get_outputs(self, vision, prompts: Sequence[str],
                    max_new_tokens: int = 10, raw: bool = False) -> List[str]:
        """A greedy continuation a (image, prompt) row.  With raw=True the
        prompts carry the family's inline markers (few-shot interleaved
        sequences) and are tokenized as they are."""
        raise NotImplementedError

    def build_fewshot_prompt(self, demo_texts: Sequence[str],
                             final_prompt: str) -> str:
        """A K-shot prompt from completed demo texts and the query prompt
        (evaluate.py:939-957's context join), for get_outputs(raw=True)."""
        raise NotImplementedError

    def build_fewshot_vision(self, demo_images: Sequence[Sequence[np.ndarray]],
                             query_images: Sequence[np.ndarray]):
        """A row's demo images and query image -> the family's vision
        input; single-image families take the query only
        (eval/models/blip.py:45-47)."""
        raise NotImplementedError

    def get_caption_prompt(self, caption: Optional[str] = None) -> str:
        raise NotImplementedError

    def get_vqa_prompt(self, question: str,
                       answer: Optional[str] = None) -> str:
        raise NotImplementedError

    def get_imagenet_prompt(self, label: Optional[str] = None) -> str:
        raise NotImplementedError

    def get_hateful_memes_prompt(self, text: str,
                                 label: Optional[str] = None) -> str:
        raise NotImplementedError

    def embed_images(self, images: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) raw -> (B, D) L2-normalized features (RICES)."""
        raise NotImplementedError

    def score_texts(self, vision_one, texts: Sequence[str],
                    prompt: str) -> np.ndarray:
        """Summed NLL of each text's continuation after ``prompt`` for ONE
        image (get_rank_classifications, eval_model.py:69-108); lower is
        better."""
        raise NotImplementedError


class FlamingoEvalModel(BaseEvalModel):
    """The DeeR / OpenFlamingo stack (reference eval/models/
    open_flamingo.py).  ``decode_engine``: "recompute" re-runs the decoder
    over the buffer a token, "kv_cache" prefills each layer's K / V once
    (``eval/kv_decode``), "auto" takes the cache from a buffer of
    ``AUTO_KV_MIN_BUFFER`` tokens; a llama decoder always recomputes."""

    name = "flamingo"

    def __init__(self, cfg, params, tok, decode_engine: str = "auto"):
        if decode_engine not in ("auto", "recompute", "kv_cache"):
            raise ValueError(f"unknown decode_engine {decode_engine!r}")
        self.cfg = cfg
        self.params = params
        self.tok = tok
        self.decode_engine = decode_engine
        self.device = params["vit"]["patch_embed"]["w"].device

    @property
    def image_size(self) -> int:
        return self.cfg.vit.image_size

    def preprocess(self, images: np.ndarray) -> torch.Tensor:
        """-> (B, T=1, F=1, 3, H, W) fp32 on the model's device."""
        from deer_vla_tpu_torch.data.preprocess import clip_preprocess
        x = torch.from_numpy(np.asarray(images)).to(self.device)
        return clip_preprocess(x, self.image_size)[:, None, None]

    def encode_prompts(self, prompts, raw=False):
        """(ids, mask) of the prompts to continue: the tokenizer's trailing
        specials dropped at each row's own length."""
        eos = getattr(self.tok, "eos_token_id", None)
        pad = getattr(self.tok, "pad_token_id", 0)
        if raw:
            # interleaved few-shot sequences with inline markers; a
            # generous length, truncated as HF would
            words = max(len(p.split()) for p in prompts) + 1
            ids, mask = self.tok.encode_raw(list(prompts),
                                            min(512, 4 * words + 8))
            ids = np.array(ids, copy=True)
            mask = np.array(mask, copy=True)
            # drop the trailing <eos> so that generation continues the
            # prompt
            for r, length in enumerate(mask.sum(-1)):
                le = int(length)
                if eos is not None and le and ids[r, le - 1] == eos:
                    ids[r, le - 1] = pad
                    mask[r, le - 1] = 0
            longest = max(int(mask.sum(-1).max()), 1)
            return ids[:, :longest], mask[:, :longest]
        ids, mask = self.tok(prompts)
        # strip each row's trailing <eoc><eos> at its own length (rows are
        # right-padded: a flat [:, :-2] strips the longest only)
        ids = np.array(ids, copy=True)
        mask = np.array(mask, copy=True)
        for r, length in enumerate(mask.sum(-1)):
            le = int(length)
            if le >= 2:
                ids[r, le - 2:le] = 0
                mask[r, le - 2:le] = 0
        return ids[:, :-2], mask[:, :-2]

    def engine(self, total: int):
        """The generate function for a buffer of ``total`` tokens."""
        from deer_vla_tpu_torch.eval.kv_decode import (greedy_generate_cached,
                                                       supports_kv_cache)
        from deer_vla_tpu_torch.eval.vl_eval import greedy_generate
        use_cache = supports_kv_cache(self.cfg) and (
            self.decode_engine == "kv_cache" or
            (self.decode_engine == "auto" and total >= AUTO_KV_MIN_BUFFER))
        return greedy_generate_cached if use_cache else greedy_generate

    def get_outputs(self, vision, prompts, max_new_tokens=10, raw=False):
        eos = getattr(self.tok, "eos_token_id", None)
        ids, mask = self.encode_prompts(prompts, raw)
        generate = self.engine(ids.shape[1] + max_new_tokens)
        out = generate(self.params, self.cfg, vision, ids, mask,
                       max_new_tokens=max_new_tokens, eos_id=eos)
        return [decode_row(self.tok, row, eos) for row in out]

    def build_fewshot_prompt(self, demo_texts, final_prompt) -> str:
        # each completed demo as <image>...<|endofchunk|> before the
        # query's open prompt (open_flamingo.py's templates)
        return ("".join(f"<image>{t}<|endofchunk|>" for t in demo_texts)
                + f"<image>{final_prompt}")

    def build_fewshot_vision(self, demo_images, query_images):
        """K demo images and the query a row -> (B, K+1, 1, 3, H, W) media
        (the gated x-attn's media-time mask routes each text span to the
        image before it)."""
        b = len(query_images)
        flat = np.concatenate(
            [np.stack(list(demo_images[r]) + [query_images[r]])
             for r in range(b)])
        prep = self.preprocess(flat)  # (B*(K+1), 1, 1, 3, H, W)
        k1 = prep.shape[0] // b
        return prep[:, 0].reshape(b, k1, *prep.shape[2:])

    def get_caption_prompt(self, caption=None) -> str:
        from deer_vla_tpu_torch.data.vl_dataset import CaptionDataset
        return CaptionDataset.get_caption_prompt(caption)

    def get_vqa_prompt(self, question, answer=None) -> str:
        from deer_vla_tpu_torch.data.vl_dataset import VQADataset
        return VQADataset.get_vqa_prompt(question, answer)

    # eval/models/open_flamingo.py:330-334 (the tokenizer prepends the
    # <image> marker itself)
    def get_imagenet_prompt(self, label=None) -> str:
        return f"Output:{label if label is not None else ''}"

    def get_hateful_memes_prompt(self, text, label=None) -> str:
        return (f"is an image with: '{text}' written on it. Is it hateful? "
                f"Answer:{label if label is not None else ''}")

    def embed_images(self, images: np.ndarray) -> np.ndarray:
        from deer_vla_tpu_torch.eval.vl_eval import embed_pooled
        vision = self.preprocess(images)  # (B, 1, 1, 3, H, W)
        return embed_pooled(self.params, vision[:, 0, 0], self.cfg)

    def score_texts(self, vision_one, texts, prompt="A photo of a"):
        from deer_vla_tpu_torch.eval.vl_eval import classify_by_lm_score
        _, scores = classify_by_lm_score(self.params, self.cfg, vision_one,
                                         list(texts), self.tok, prompt=prompt)
        return scores


class BlipEvalModel(BaseEvalModel):
    """The BLIP captioner (reference eval/models/blip.py, which wraps HF
    BLIP-2; the model here is ``models/blip``), in ``dtype`` (the JAX
    package runs it in the fp32 of its inputs)."""

    name = "blip"

    def __init__(self, cfg, params, tok, dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.params = params
        self.tok = tok
        self.dtype = dtype
        self.device = params["vision"]["patch_embed"]["w"].device

    @property
    def image_size(self) -> int:
        return self.cfg.vision.image_size

    def preprocess(self, images: np.ndarray) -> torch.Tensor:
        """-> (B, 3, H, W) in the model's dtype on its device."""
        from deer_vla_tpu_torch.models.blip import blip_preprocess
        x = torch.from_numpy(np.asarray(images)).to(self.device)
        return blip_preprocess(x, self.image_size).to(self.dtype)

    def get_outputs(self, vision, prompts, max_new_tokens=10, raw=False):
        from deer_vla_tpu_torch.models.blip import blip_generate
        # raw prompts carry no BLIP markers: the same tokenization
        ids, mask = self.tok(prompts)
        out = blip_generate(self.params, self.cfg, vision, ids, mask,
                            max_new_tokens=max_new_tokens)
        return [decode_row(self.tok, row, self.cfg.text.sep_token_id)
                for row in out]

    def build_fewshot_prompt(self, demo_texts, final_prompt) -> str:
        # text-only in-context examples: one image a row
        return " ".join(list(demo_texts) + [final_prompt])

    def build_fewshot_vision(self, demo_images, query_images):
        return self.preprocess(np.stack(list(query_images)))

    # BLIP-2's single-image prompt formats (eval/models/blip.py:99-105)
    def get_vqa_prompt(self, question, answer=None) -> str:
        return (f"Question:{question} Short answer:"
                f"{answer if answer is not None else ''}")

    def get_caption_prompt(self, caption=None) -> str:
        return f"A photo of {caption if caption is not None else ''}"

    # the upstream BLIP-2 model has no imagenet / hateful-memes prompts;
    # captioner-style ones keep the task matrix whole
    def get_imagenet_prompt(self, label=None) -> str:
        return f"A photo of {label if label is not None else ''}"

    def get_hateful_memes_prompt(self, text, label=None) -> str:
        return (f"is an image with: '{text}' written on it. Is it hateful? "
                f"Answer:{label if label is not None else ''}")

    @torch.no_grad()
    def embed_images(self, images: np.ndarray) -> np.ndarray:
        """The BLIP ViT's [CLS] token in fp32, L2-normalized."""
        from deer_vla_tpu_torch.eval.vl_eval import l2norm
        from deer_vla_tpu_torch.models.blip import vision_forward
        enc = vision_forward(self.params, self.preprocess(images),
                             self.cfg.vision)
        return l2norm(enc[:, 0].float()).cpu().numpy()

    @torch.no_grad()
    def score_texts(self, vision_one, texts, prompt="A photo of a"):
        """Decoder NLL of each class-name continuation (the flamingo
        scorer's contract)."""
        from deer_vla_tpu_torch.eval.vl_eval import (continuation_target_mask,
                                                     summed_nll)
        from deer_vla_tpu_torch.models.blip import (text_decoder_forward,
                                                    vision_forward)
        ids, mask = self.tok([f"{prompt} {t}" for t in texts])
        _, p_mask = self.tok([prompt] * len(texts))
        # the BLIP tokenizers emit [DEC]-led rows without trailing
        # specials: the continuation starts at the prompt's length
        target = continuation_target_mask(mask, p_mask, trailing_specials=0)
        pix = vision_one.repeat_interleave(len(texts), dim=0)
        ids_t, mask_t = _ids(ids, self.device), _ids(mask, self.device)
        enc = vision_forward(self.params, pix, self.cfg.vision)
        logits = text_decoder_forward(self.params, ids_t, mask_t, enc,
                                      self.cfg.text)
        return summed_nll(logits, ids_t, _ids(target, self.device)
                          ).cpu().numpy()


def decode_row(tok, row, stop_id) -> str:
    """ids -> text, cut at the stop token.  The hash tokenizers render the
    ids themselves (the debug fixtures score id strings)."""
    toks = [int(t) for t in row]
    if stop_id is not None and stop_id in toks:
        toks = toks[:toks.index(stop_id)]
    if hasattr(tok, "decode"):
        return tok.decode(toks, skip_special_tokens=True)
    return " ".join(str(t) for t in toks)


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------


def make_eval_model(args, device=None) -> BaseEvalModel:
    """``--eval_model flamingo | blip`` -> a ready eval model on ``device``
    (the card unless named; evaluate.py:398-400).  flamingo:
    ``cli/eval.load_model`` (seeded or ``--evaluate_from_checkpoint``) and
    the hash tokenizer.  blip: ``--model tiny`` is blip_tiny, any other
    blip_base; the weights from ``--evaluate_from_checkpoint`` (an HF
    state dict ``.pt`` / ``.bin``, or a converted ``.npz``), else seeded."""
    from deer_vla_tpu_torch.core.device import resolve_device
    if getattr(args, "tokenizer_path", ""):
        raise SystemExit(TOKENIZER_DROPPED)
    dev = resolve_device(device)
    name = getattr(args, "eval_model", "flamingo")
    if name == "flamingo":
        from deer_vla_tpu_torch.cli.eval import load_model
        from deer_vla_tpu_torch.data.text import HashTokenizer
        cfg, params = load_model(args, dev)
        tok = HashTokenizer(vocab_size=cfg.mpt.vocab_size,
                            max_length=cfg.text_len)
        cfg = dataclasses.replace(cfg, media_token_id=tok.media_token_id)
        return FlamingoEvalModel(cfg, params, tok,
                                 decode_engine=getattr(args, "decode_engine",
                                                       "auto"))
    if name == "blip":
        from deer_vla_tpu_torch.bridge import to_torch
        from deer_vla_tpu_torch.models.blip import (blip_base, blip_tiny,
                                                    init_blip)
        cfg = blip_tiny() if args.model == "tiny" else blip_base()
        ckpt = getattr(args, "evaluate_from_checkpoint", "")
        if ckpt:
            params = to_torch(_load_blip_checkpoint(ckpt, cfg), dev)
        else:
            params = init_blip(cfg, seed=args.seed, device=dev)
        dtype = (torch.bfloat16 if getattr(args, "precision", "fp32")
                 == "bf16" else torch.float32)
        return BlipEvalModel(cfg, params, make_blip_tokenizer(cfg), dtype)
    raise SystemExit(f"unknown --eval_model {name!r} (flamingo|blip)")


def _load_blip_checkpoint(path: str, cfg) -> dict:
    """A ``.npz`` of the tree's leaves under ``a/b/c`` keys (list indices
    as digits), or an HF state dict (``torch.load``; under "model" or
    "state_dict" if wrapped)."""
    from deer_vla_tpu_torch.models.blip import convert_hf_blip
    if path.endswith(".npz"):
        with np.load(path) as f:
            return _unflatten({k: f[k] for k in f.files})
    sd = torch.load(path, map_location="cpu")
    sd = sd.get("model", sd.get("state_dict", sd))
    return convert_hf_blip(sd, cfg)


def _unflatten(flat: dict):
    """Flat ``a/b/c`` keys -> the nested tree; a level whose keys are all
    digits becomes a list (the layer stacks)."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(out)


def make_blip_tokenizer(cfg) -> "BlipHashTokenizer":
    """The hash tokenizer with the BLIP decoder's contract."""
    return BlipHashTokenizer(cfg.text.vocab_size, cfg.text.bos_token_id,
                             cfg.text.sep_token_id, cfg.text.pad_token_id)


class BlipHashTokenizer:
    """Deterministic stand-in tokenizer with the BLIP decoder's contract:
    every row starts with [DEC] (bos) and has no trailing [SEP] (the prompt
    is a prefix to continue).  Ids from md5, the same in every process."""

    def __init__(self, vocab_size: int, bos_token_id: int, sep_token_id: int,
                 pad_token_id: int = 0):
        self.vocab_size = vocab_size
        self.bos_token_id = bos_token_id
        self.sep_token_id = sep_token_id
        self.pad_token_id = pad_token_id
        self._specials = {bos_token_id, sep_token_id, pad_token_id}
        # word ids lie in [1, lo)
        self._lo = min(bos_token_id, sep_token_id)

    def _word(self, w: str) -> int:
        h = int(hashlib.md5(w.encode()).hexdigest(), 16)
        return 1 + (h % (self._lo - 1))

    def __call__(self, texts: Sequence[str]):
        seqs = [[self.bos_token_id] + [self._word(w) for w in t.split()]
                for t in texts]
        longest = max(len(s) for s in seqs)
        ids = np.full((len(seqs), longest), self.pad_token_id, np.int32)
        mask = np.zeros((len(seqs), longest), np.int32)
        for r, s in enumerate(seqs):
            ids[r, :len(s)] = s
            mask[r, :len(s)] = 1
        return ids, mask

    def decode(self, toks, skip_special_tokens=True) -> str:
        keep = [t for t in toks if not (skip_special_tokens and
                                        t in self._specials)]
        return " ".join(str(t) for t in keep)
