"""Plain soft-WPMI scoring and the CSV's selections, the benchmark's reference.

Soft-WPMI (Mammo-CLIP Dissect; the CLIP-Dissect family, Oikarinen and Weng,
arXiv:2204.10965): with clip = L2n(image embeddings) @ L2n(concept embeddings).T
[N, C] and softmax(a clip) taken over concepts, each unit's k most activating images
(ties to the lower index) enter with a probability decaying from p_start to p_end,

    pde[u, c] = sum_j log(1 + p_j (softmax(a clip)[top_j(u), c] - 1) + eps)
    score[u, c] = pde[u, c] - lam (logsumexp over the layer's units of pde[., c]
                                   - log(units in the layer))

with p_j = p_start - (j / top_k)(p_start - p_end), k = min(top_k, N). float32 on
whatever device the inputs live on. Imports nothing of the program."""
from __future__ import annotations

import math
from typing import Sequence

import torch

A, LAM, EPS, P_START, P_END = 10.0, 1.0, 1e-7, 0.998, 0.97


def top_images(acts: torch.Tensor, k: int) -> torch.Tensor:
    """[U, k] indices of each unit's k largest activations over acts [N, U],
    descending, ties to the lower image index."""
    return torch.sort(acts.T, dim=1, descending=True, stable=True).indices[:, :k]


def soft_wpmi(image_emb: torch.Tensor, text_emb: torch.Tensor, acts: torch.Tensor,
              widths: Sequence[int], top_k: int = 100, unit_rows: int = 256) -> torch.Tensor:
    """Scores [U, C] of acts [N, U] (layers of `widths` side by side)."""
    clip = image_emb.float() @ text_emb.float().T
    sm = torch.softmax(A * clip, dim=1)
    k = min(top_k, acts.shape[0])
    p = (P_START - torch.arange(k, device=acts.device, dtype=torch.float32) / top_k
         * (P_START - P_END))[None, :, None]
    pde = torch.empty((acts.shape[1], clip.shape[1]), dtype=torch.float32, device=acts.device)
    for u0 in range(0, acts.shape[1], unit_rows):
        idx = top_images(acts[:, u0:u0 + unit_rows], k)
        pde[u0:u0 + unit_rows] = torch.log(1.0 + p * (sm[idx] - 1.0) + EPS).sum(dim=1)
    out, start = torch.empty_like(pde), 0
    for w in widths:
        seg = pde[start:start + w]
        out[start:start + w] = seg - LAM * (torch.logsumexp(seg, dim=0, keepdim=True)
                                            - math.log(w))
        start += w
    return out
