"""Vision-language evaluation (the JAX package's ``eval/vl_eval.py``): greedy
caption / VQA generation, scoring by LM likelihood, RICES example retrieval
and the benchmark metrics (open_flamingo/eval/evaluate.py:393, rices.py:95).

Generation is the recompute engine: a static (B, S + n_new) token buffer,
each row decoding greedily from its own prompt length, the whole decoder
re-run over the buffer each step (``eval/kv_decode.py`` is the cached
engine).  JAX's ``lax.scan`` over the steps is a Python loop over tensors on
the device here; the buffer protocol and the results are the same.  Only
the rows' last positions go through the vocabulary product: their logits
are the ones JAX's full product picks.  The decoder's attention over a
buffer of 128 tokens or more runs through K1 (``ops.attention``).

The metrics are host code, copied from the JAX module.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deer_vla_tpu_torch.core.config import DeerConfig
from deer_vla_tpu_torch.data.text import fixed_length
from deer_vla_tpu_torch.models.flamingo import encode_vision
from deer_vla_tpu_torch.models.mpt import decoder_forward, lm_logits
from deer_vla_tpu_torch.models.vit import vit_forward


def prompt_buffer(prompt_ids, prompt_mask, max_new_tokens: int, device):
    """The decode buffer: (ids, mask) of (B, S + max_new_tokens) int64 on
    ``device`` holding the right-padded prompts, and each row's prompt
    length (a host array) where its first new token goes."""
    prompt_ids, prompt_mask = np.asarray(prompt_ids), np.asarray(prompt_mask)
    b, s = prompt_ids.shape
    ids = np.zeros((b, s + max_new_tokens), np.int64)
    mask = np.zeros((b, s + max_new_tokens), np.int64)
    ids[:, :s] = prompt_ids
    mask[:, :s] = prompt_mask
    start_lens = prompt_mask.sum(1).astype(np.int64)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(mask).to(device), start_lens)


def write_token(ids: torch.Tensor, mask: torch.Tensor, rows: torch.Tensor,
                pos: torch.Tensor, tok: torch.Tensor) -> None:
    """Each row's token ``tok`` written at its ``pos``, in place."""
    ids[rows, pos] = tok.to(ids.dtype)
    mask[rows, pos] = 1


def generated_rows(ids: torch.Tensor, start_lens: np.ndarray,
                   max_new_tokens: int, eos_id: Optional[int]) -> np.ndarray:
    """(B, max_new_tokens) new ids of each row, every id from the first
    ``eos_id`` on set to ``eos_id``."""
    out_ids = ids.cpu().numpy().astype(np.int32)
    out = np.stack([out_ids[r, start_lens[r]:start_lens[r] + max_new_tokens]
                    for r in range(len(start_lens))])
    if eos_id is not None:
        for r in out:
            stop = np.where(r == eos_id)[0]
            if len(stop):
                r[stop[0]:] = eos_id
    return out


@torch.no_grad()
def greedy_generate(params: dict, cfg: DeerConfig, vision_x: torch.Tensor,
                    prompt_ids, prompt_mask, max_new_tokens: int = 10,
                    eos_id: Optional[int] = None,
                    logits_out: Optional[list] = None) -> np.ndarray:
    """Greedy continuation of (B, S) right-padded prompts: each row decodes
    from its own prompt length in a static buffer; returns the (B,
    max_new_tokens) new ids, trimmed at ``eos_id``.  ``vision_x`` (B, T,
    1, 3, H, W) on the model's device.  ``logits_out``, when given, gets
    each step's (B, V) logits."""
    dev = vision_x.device
    ids, mask, start_lens = prompt_buffer(prompt_ids, prompt_mask,
                                          max_new_tokens, dev)
    media = encode_vision(params, vision_x, None, cfg)
    rows = torch.arange(ids.shape[0], device=dev)
    starts = torch.from_numpy(start_lens).to(dev)
    for i in range(max_new_tokens):
        _, x = decoder_forward(params["decoder"], ids, mask, media, cfg)
        last = x[rows, starts + i - 1]  # each row's last written position
        logits = lm_logits(params["decoder"], last, cfg.dtypes.cdt,
                           arch=cfg.mpt.arch)
        if logits_out is not None:
            logits_out.append(logits)
        write_token(ids, mask, rows, starts + i, logits.argmax(-1))
    return generated_rows(ids, start_lens, max_new_tokens, eos_id)


# ---------------------------------------------------------------------------
# zero-shot classification by LM scoring (classification_utils equivalent)
# ---------------------------------------------------------------------------


def summed_nll(logits: torch.Tensor, ids: torch.Tensor,
               target_mask: torch.Tensor) -> torch.Tensor:
    """(B,) teacher-forced summed NLL of the target-masked tokens: logits
    (B, S, V) predict ids shifted by one.  Shared by the flamingo and BLIP
    scorers."""
    logp = torch.log_softmax(logits[:, :-1].float(), -1)
    nll = -torch.gather(logp, -1, ids[:, 1:, None].long())[..., 0]
    return (nll * target_mask[:, 1:].to(nll.dtype)).sum(-1)


def continuation_target_mask(mask: np.ndarray, prompt_mask: np.ndarray,
                             trailing_specials: int) -> np.ndarray:
    """(B, S) mask of the continuation: from each row's prompt length, less
    the tokenizer's trailing specials (the flamingo tokenizers append
    <|endofchunk|><eos>, BLIP's nothing), to its full valid length."""
    p_len = np.asarray(prompt_mask).sum(1) - trailing_specials
    pos = np.arange(np.asarray(mask).shape[1])[None]
    return ((pos >= p_len[:, None]) & (np.asarray(mask) > 0)).astype(np.int32)


@torch.no_grad()
def lm_score(params: dict, cfg: DeerConfig, vision_x: torch.Tensor,
             ids: torch.Tensor, mask: torch.Tensor,
             target_mask: torch.Tensor) -> torch.Tensor:
    """(B,) summed NLL of the target-masked tokens (JAX's
    ``make_lm_scorer``): the classification harness ranks class-name
    continuations by it."""
    media = encode_vision(params, vision_x, None, cfg)
    _, x = decoder_forward(params["decoder"], ids, mask, media, cfg)
    logits = lm_logits(params["decoder"], x, cfg.dtypes.cdt,
                       arch=cfg.mpt.arch)
    return summed_nll(logits, ids, target_mask)


def classify_by_lm_score(params: dict, cfg: DeerConfig,
                         vision_x: torch.Tensor, class_texts: Sequence[str],
                         text_fn, text_len: Optional[int] = None,
                         prompt: str = "A photo of a"
                         ) -> Tuple[int, np.ndarray]:
    """The class whose name continuation has the lowest NLL for one image
    (``vision_x`` (1, 1, 1, 3, H, W)): (argmin, scores)."""
    tl = text_len or cfg.text_len
    texts = [f"{prompt} {c}" for c in class_texts]
    ids, mask = text_fn(texts)
    _, p_mask = text_fn([prompt] * len(texts))
    ids, mask = fixed_length(ids, mask, tl, getattr(text_fn, "pad_token_id",
                                                    0))
    target_mask = continuation_target_mask(mask, p_mask, trailing_specials=2)
    dev = vision_x.device
    vis = vision_x.repeat_interleave(len(texts), dim=0)
    scores = lm_score(params, cfg, vis,
                      *(torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                        for a in (ids, mask, target_mask)))
    scores = scores.cpu().numpy()
    return int(scores.argmin()), scores


# ---------------------------------------------------------------------------
# RICES (Retrieval-based In-Context Example Selection, rices.py)
# ---------------------------------------------------------------------------


class RICES:
    """Nearest-neighbour example retrieval on the CLIP ViT's pooled CLS
    feature (the upstream caches train-set CLIP features,
    scripts/cache_rices_features.py, and retrieves top-k cosine
    neighbours per query image)."""

    def __init__(self, params: dict, cfg: DeerConfig, batch_size: int = 32):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.features: Optional[np.ndarray] = None

    def _embed(self, images) -> np.ndarray:
        dev = self.params["vit"]["patch_embed"]["w"].device
        x = torch.as_tensor(np.asarray(images)).to(dev)
        return embed_pooled(self.params, x, self.cfg)

    def build_index(self, images: np.ndarray) -> np.ndarray:
        """images (N, 3, H, W) preprocessed -> the (N, D) feature index."""
        self.features = np.concatenate(
            [self._embed(images[i:i + self.batch_size])
             for i in range(0, len(images), self.batch_size)], 0)
        return self.features

    def retrieve(self, query_images: np.ndarray, k: int) -> np.ndarray:
        """(B, 3, H, W) -> (B, k) index rows, the most similar LAST (the
        upstream reverses so the closest example is nearest the query)."""
        assert self.features is not None, "call build_index or load first"
        return rices_retrieve(self._embed(query_images), self.features, k)

    def save(self, path: str) -> None:
        """The index as npz at exactly ``path`` (an open file handle stops
        np.savez from appending '.npz')."""
        assert self.features is not None, "call build_index first"
        with open(path, "wb") as f:
            np.savez(f, features=self.features)

    def load(self, path: str) -> np.ndarray:
        """An index written by ``save`` / ``cli/cache_features``."""
        self.features = np.load(path)["features"]
        return self.features


def rices_retrieve(query_feats: np.ndarray, index_feats: np.ndarray,
                   k: int) -> np.ndarray:
    """Cosine top-k over L2-normalized features, the most similar LAST
    (rices.py:95's sort and reverse)."""
    sim = np.asarray(query_feats) @ np.asarray(index_feats).T
    top = np.argsort(-sim, axis=1)[:, :k]
    return top[:, ::-1]


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


@torch.no_grad()
def embed_pooled(params: dict, x: torch.Tensor, cfg: DeerConfig
                 ) -> np.ndarray:
    """(B, 3, H, W) -> (B, width) L2-normalized pooled CLS features of the
    CLIP ViT in the compute dtype, as fp32 numpy."""
    pooled, _ = vit_forward(params["vit"], x.to(cfg.dtypes.cdt), cfg.vit)
    return l2norm(pooled).float().cpu().numpy()


# ---------------------------------------------------------------------------
# metrics (vqa_metric.py equivalents, dependency-free), copied
# ---------------------------------------------------------------------------


def roc_auc(labels, scores) -> float:
    """Binary ROC-AUC by the tie-averaged Mann-Whitney U statistic (the
    hateful-memes headline metric, evaluate.py:1280-1291)."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    n_pos = int(labels.sum())
    n_neg = int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5  # undefined; chance by convention
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    ranks = np.empty(len(s), np.float64)
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


_ARTICLES = {"a", "an", "the"}


def normalize_answer(s: str) -> str:
    s = s.lower().strip()
    s = re.sub(r"[^\w\s]", "", s)
    return " ".join(w for w in s.split() if w not in _ARTICLES)


# The official VQAEval normalization tables (vqa_metric.py:245-320)
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve":
    "could've", "couldnt": "couldn't", "couldn'tve": "couldn't've",
    "couldnt've": "couldn't've", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hadnt've": "hadn't've",
    "hadn'tve": "hadn't've", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's", "Id've": "I'd've",
    "I'dve": "I'd've", "Im": "I'm", "Ive": "I've", "isnt": "isn't",
    "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am",
    "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
_MANUAL_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
               "three": "3", "four": "4", "five": "5", "six": "6",
               "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
          "_", "-", ">", "<", "@", "`", ",", "?", "!"]
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")


def _process_punctuation(t: str) -> str:
    out = t
    for p in _PUNCT:
        if (p + " " in t or " " + p in t) or (_COMMA_STRIP.search(t)
                                              is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out)


def _process_digit_article(t: str) -> str:
    out = []
    for w in t.lower().split():
        w = _MANUAL_MAP.get(w, w)
        if w not in _ARTICLES:
            out.append(w)
    for i, w in enumerate(out):
        if w in _CONTRACTIONS:
            out[i] = _CONTRACTIONS[w]
    return " ".join(out)


def vqa_normalize(s: str) -> str:
    """The official VQAEval answer normalization (processPunctuation +
    processDigitArticle after the newline / tab clean-up)."""
    s = s.replace("\n", " ").replace("\t", " ").strip()
    return _process_digit_article(_process_punctuation(s))


def vqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """Official VQA accuracy: over the leave-one-out subsets of the human
    answers, the mean of min(#matches in the subset / 3, 1); min(matches /
    3, 1) with fewer than 2 answers."""
    pred = vqa_normalize(prediction)
    matches = sum(vqa_normalize(a) == pred for a in answers)
    k = len(answers)
    if k < 2:
        return min(matches / 3.0, 1.0)
    acc_without_match = min((matches - 1) / 3.0, 1.0) if matches else 0.0
    acc_with_match = min(matches / 3.0, 1.0)
    return (matches * acc_without_match
            + (k - matches) * acc_with_match) / k


def postprocess_vqa_generation(text: str) -> str:
    """The generation cut at the next Question / Answer / Short marker and
    at the first comma (eval_models/open_flamingo.py, ok_vqa_utils.py:
    211-215)."""
    text = re.split("Question|Answer|Short", text, 1)[0]
    return re.split(", ", text, 1)[0].strip()


_VOWELS = set("aeiou")


def _singularize(w: str) -> str:
    if len(w) <= 3 or w.endswith("ss") or w.endswith("us"):
        return w
    if w.endswith("ies"):
        return w[:-3] + "y"
    if any(w.endswith(s) for s in ("ches", "shes", "xes", "zes", "ses")):
        return w[:-2]
    if w.endswith("s"):
        return w[:-1]
    return w


def _lemmatize_ing(w: str) -> str:
    stem = w[:-3]
    if len(stem) >= 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
        return stem[:-1]             # running -> run
    if (len(stem) >= 3 and stem[-1] not in _VOWELS
            and stem[-2] in _VOWELS and stem[-3] not in _VOWELS):
        return stem + "e"            # riding -> ride
    return stem                      # firefighting -> firefight


def okvqa_stem(text: str) -> str:
    """OK-VQA v1.1-style answer stemming without nltk / WordNet: -ing verbs
    lemmatized, plural nouns singularized (ok_vqa_utils.py:187-208 by
    rule); predictions and references go through the same stemmer."""
    out = []
    for w in text.lower().split():
        if w.endswith("ing") and len(w) > 4:
            w = _lemmatize_ing(w)
        else:
            w = _singularize(w)
        out.append(w)
    return " ".join(out)


def okvqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """VQA accuracy over stemmed answers (the OK-VQA protocol)."""
    return vqa_accuracy(okvqa_stem(postprocess_vqa_generation(prediction)),
                        [okvqa_stem(a) for a in answers])


def caption_bleu1(prediction: str, references: Sequence[str]) -> float:
    """Unigram precision with brevity penalty, the best over references."""
    pred = normalize_answer(prediction).split()
    if not pred:
        return 0.0
    best = 0.0
    for ref in references:
        r = normalize_answer(ref).split()
        overlap = sum(min(pred.count(w), r.count(w)) for w in set(pred))
        p = overlap / len(pred)
        bp = 1.0 if len(pred) >= len(r) else np.exp(1 - len(r)
                                                    / max(len(pred), 1))
        best = max(best, p * bp)
    return float(best)


def _ngram_counts(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def cider_d(predictions: Sequence[str], references: Sequence[Sequence[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """Corpus CIDEr-D in [0, 10] (pycocoevalcap's math): tf-idf n-gram
    vectors for n = 1..4 on raw counts, the candidate clipped at each
    reference, a gaussian length penalty, averaged over n and references,
    times 10.  predictions[i] pairs with references[i]; the idf is over the
    reference sets."""
    toks_p = [normalize_answer(p).split() for p in predictions]
    toks_r = [[normalize_answer(r).split() for r in refs]
              for refs in references]
    n_img = len(toks_p)
    if n_img == 0:
        return 0.0
    df = [defaultdict(int) for _ in range(max_n)]
    for refs in toks_r:
        for n in range(max_n):
            seen = set()
            for r in refs:
                seen |= set(_ngram_counts(r, n + 1).keys())
            for g in seen:
                df[n][g] += 1
    log_n = math.log(max(n_img, 1))

    def tfidf(counts, n):
        vec, norm = {}, 0.0
        for g, c in counts.items():
            w = c * (log_n - math.log(max(df[n][g], 1)))
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    total = 0.0
    for ti, refs in zip(toks_p, toks_r):
        score_n = np.zeros(max_n)
        for n in range(max_n):
            cv, cn = tfidf(_ngram_counts(ti, n + 1), n)
            for r in refs:
                rv, rn = tfidf(_ngram_counts(r, n + 1), n)
                num = sum(min(cv.get(g, 0.0), rv[g]) * rv[g] for g in rv)
                if cn > 0 and rn > 0:
                    delta = len(ti) - len(r)
                    penalty = math.exp(-delta * delta / (2 * sigma * sigma))
                    score_n[n] += penalty * num / (cn * rn)
            score_n[n] /= max(len(refs), 1)
        total += float(score_n.mean())
    return 10.0 * total / n_img
