"""Plain PyTorch version of the pair_scores kernel's tile function, the
counterpart of the JAX package's ``pair_scores/ref.py``.

It walks the traversal columns in l order, so each eta entry is summed in
the kernel's order (and the reference segment sum's). Runs on any device;
the wrapper takes it for tensors on the CPU.
"""
from __future__ import annotations

import torch


def pair_scores_ref(nbr: torch.Tensor, trav_m: torch.Tensor,
                    trav_w: torch.Tensor, trav_d: torch.Tensor):
    """nbr ``[N, U]`` (pad -1), trav_m ``[N, L]`` (pad -2), trav_w ``[N, L]``
    f32, trav_d ``[N, L]`` 0/1. Returns (eta ``[N, U]`` f32, inter
    ``[N, U]`` int32): ``sum_l w[t, l] * [m[t, l] == nbr[t, u]]`` and the
    same sum of d."""
    eta = torch.zeros(nbr.shape, dtype=torch.float32, device=nbr.device)
    inter = torch.zeros(nbr.shape, dtype=torch.int32, device=nbr.device)
    for l in range(trav_m.shape[1]):
        eq = trav_m[:, l:l + 1] == nbr
        eta = eta + torch.where(eq, trav_w[:, l:l + 1], 0.0)
        inter = inter + torch.where(eq, trav_d[:, l:l + 1], 0)
    return eta, inter
