"""ToMe token merging for the frozen ViT (Bolya et al., "Token Merging:
Your ViT But Faster", arXiv:2210.09461): the port of the JAX package's
``ops/tome.py``.

Each ViT layer (``models/vit.vit_forward_tome``) merges the ``r`` most
similar patch-token pairs between its attention and its MLP, so the token
count falls by ``r`` a layer (257 -> 65 over ViT-L/14's 24 layers at r = 8).
The CLS token never merges.  Once a layer has merged, the next layers'
attention carries the proportional-attention bias ``log(size)`` of each key,
so a token standing for s patches weighs s times in the softmax.

Kept from the JAX package exactly:
  * the schedule is plain Python, so every layer's token count is known
    before the step runs;
  * A = even, B = odd patch tokens; each A token's best cosine match in B is
    the first maximum (``argmax``); the A tokens are ranked by that score
    with a STABLE sort, ties broken by index (DebugEnv frames are flat, so
    identical patches and exact ties happen);
  * the size-weighted average is summed in fp32.  ``scatter_add_`` on the
    card sums repeated targets in no fixed order: merged tokens agree with
    the CPU within fp32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def tome_schedule(num_patches: int, layers: int, r: int,
                  min_keep: int = 2) -> List[int]:
    """Per-layer merge counts for a constant-r schedule: layer i merges
    ``min(r, n_i // 2, n_i - min_keep)`` patch tokens, ``n_i`` the patch
    tokens entering layer i (CLS excluded)."""
    if r <= 0:
        return [0] * layers
    out, n = [], num_patches
    for _ in range(layers):
        ri = max(0, min(r, n // 2, n - min_keep))
        out.append(ri)
        n -= ri
    return out


def match_pairs(metric: torch.Tensor, r: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bipartite soft matching on (B, n, dm) similarity features: (src
    (B, r) A rows that merge, unm (B, na - r) A rows that stay, dst (B, r)
    the B row each src merges into)."""
    m = metric.float()
    m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True).clamp_min(1e-6)
    scores = torch.einsum("bad,bcd->bac", m[:, ::2], m[:, 1::2])
    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)  # the first maximum
    order = torch.argsort(-node_max, dim=-1, stable=True)
    src, unm = order[:, :r], order[:, r:]
    return src, unm, node_idx.gather(1, src)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, D) rows at idx (B, k) -> (B, k, D)."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def bipartite_merge(tokens: torch.Tensor, metric: torch.Tensor,
                    sizes: torch.Tensor, r: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the ``r`` most similar A -> B pairs (ToMe section 3).

    tokens (B, n, D) patch tokens without CLS; metric (B, n, dm) the mean
    attention keys; sizes (B, n) fp32 multiplicities.  Returns (tokens',
    sizes') with n' = n - r: the unmerged A tokens, then every B token."""
    if r <= 0:
        return tokens, sizes
    n = tokens.shape[1]
    na = (n + 1) // 2
    if not 0 < r <= min(na, n // 2):
        raise ValueError(f"r={r} invalid for n={n} (max {min(na, n // 2)})")
    src, unm, dst = match_pairs(metric, r)
    ta, tb = tokens[:, ::2], tokens[:, 1::2]
    sa, sb = sizes[:, ::2], sizes[:, 1::2]
    src_sz = sa.gather(1, src)
    num_b = tb.float() * sb[..., None].float()
    num_b = num_b.scatter_add(
        1, dst[..., None].expand(-1, -1, tokens.shape[-1]),
        _rows(ta, src).float() * src_sz[..., None].float())
    new_sb = sb.scatter_add(1, dst, src_sz)
    merged_b = (num_b / new_sb[..., None].float()).to(tokens.dtype)
    return (torch.cat([_rows(ta, unm), merged_b], dim=1),
            torch.cat([sa.gather(1, unm), new_sb], dim=1))


def proportional_attn_bias(sizes_with_cls: torch.Tensor,
                           sq: int) -> torch.Tensor:
    """log-size key bias (ToMe section 3.1), (B, 1, sq, sk) fp32: an
    ``expand`` of the (B, 1, 1, sk) row, stride 0 along sq and the head
    dim, which K1 reads through its strides without a copy."""
    logs = torch.log(sizes_with_cls.float())
    b, sk = logs.shape
    return logs[:, None, None, :].expand(b, 1, sq, sk)
