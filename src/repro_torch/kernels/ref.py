"""Plain torch oracles of the Pallas kernels: the semantics each kernel
must match.  Port of `repro.kernels.ref`.
"""
from __future__ import annotations

import torch


def codebook_matmul_ref(x: torch.Tensor, idx: torch.Tensor,
                        codebook: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(idx (K, N), codebook).

    codebook is (n_levels,) for a per-tensor table (the paper's per-core
    shared table) or (G, n_levels) with G groups along N (one "core" per
    group of columns).
    """
    ix = idx.long()
    if codebook.dim() == 1:
        w = codebook[ix]
    else:
        g = codebook.shape[0]
        n = idx.shape[1]
        if n % g:
            raise ValueError(f"{g} codebook groups do not divide {n} columns")
        group = torch.arange(n, device=idx.device) // (n // g)
        w = codebook[group[None, :], ix]
    return x.to(torch.float32) @ w.to(torch.float32)


def zspe_spmm_ref(spikes: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """Binary spike matrix (M, K) x dense weights (K, N) -> f32 (M, N)."""
    return spikes.to(torch.float32) @ weights.to(torch.float32)


def lif_update_ref(v: torch.Tensor, elapsed: torch.Tensor,
                   current: torch.Tensor, *, threshold: float, leak: float,
                   reset: float):
    """Fused partial-update LIF step (matches core.neuron.lif_step with
    partial_update=True, hard reset).

    Returns (v_new, elapsed_new, spikes, updated_mask).
    """
    has_input = current != 0.0
    pending = elapsed + 1
    decay = torch.where(has_input, leak ** pending.to(v.dtype),
                        torch.ones_like(v))
    v_int = v * decay + current
    v_eff = torch.where(has_input, v_int, torch.full_like(v, -torch.inf))
    spikes = (v_eff >= threshold).to(v.dtype)
    new_elapsed = torch.where(has_input, torch.zeros_like(pending),
                              pending).to(elapsed.dtype)
    v_new = torch.where(spikes > 0, torch.full_like(v, reset),
                        torch.where(has_input, v_int, v))
    return v_new, new_elapsed, spikes, has_input


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Oracle for kernels/flash_attention.py: plain SDPA, f32 softmax.

    q/k/v: (B, H, S|T, hd) with kv heads pre-broadcast to H.
    """
    s, hd = q.shape[2], q.shape[3]
    t = k.shape[2]
    scores = (q.float() @ k.float().transpose(-1, -2)) / (hd ** 0.5)
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    return (probs @ v.float()).to(q.dtype)
