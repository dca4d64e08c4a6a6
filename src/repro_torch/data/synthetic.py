"""Synthetic data pipelines (offline container — no external datasets),
in torch.  Port of `repro.data.synthetic`.

  * TokenStream — zipfian LM token stream with deterministic, seekable
    batches (resume-safe: batch i is a pure function of (seed, i)).
  * EventStream — NMNIST/DVS-like event-camera spike trains: moving
    2D gaussian blobs rasterized to ON/OFF event channels, with class-
    dependent motion — linearly separable enough for a small SNN to learn,
    sparse enough (~90% zeros) to exercise the zero-skip datapath at the
    paper's operating point.
  * cifar_like_rate_coded — a rate-coded static-image workload.

The event generators draw from numpy's RNG exactly as the reference
does, so the trains are bit-equal to the JAX package's; only the
returned arrays become tensors (labels int64, the index type torch
gathers by).  The token stream draws the reference's `jax.random` bits
with the port's threefry (`faults/_threefry.py`); its f32 `exp` may round
one ulp apart from XLA's, which moves a token only where the product
lands on an integer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.faults import _threefry as TF


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int, device=None) -> dict:
        """Deterministic batch for `step` (seekable for resume): tokens
        and labels (B, seq_len) int32 on `device` (default: the card)."""
        dev = resolve_device(device)
        key = TF.fold_in(TF.prng_key(self.seed, dev), step)
        n = self.batch * (self.seq_len + 1)
        # jax.random.uniform: [0, 1) from the bits, clamped below at minval
        u = torch.clamp(TF.uniform(TF.random_bits(key, n)), min=0.0)
        # zipf-ish: sample uniform in log-rank space
        log_v = torch.log(torch.tensor(float(self.vocab),
                                       dtype=torch.float32, device=dev))
        ranks = torch.exp(u * log_v).to(torch.int32) - 1
        toks = torch.clamp(ranks, 0, self.vocab - 1).reshape(
            self.batch, self.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class EventStream:
    """Event-camera-like spike trains: (T, H*W*2) binary per sample."""

    n_classes: int = 10
    height: int = 34            # NMNIST sensor size
    width: int = 34
    timesteps: int = 20
    seed: int = 0
    angle_offset: float = 0.0   # global motion-direction drift (radians):
                                # models a rotated sensor / changed scene
                                # statistics for continual-adaptation runs
                                # (offset 2*pi/n_classes = exactly one
                                # class-slot, i.e. a label permutation)

    @property
    def n_inputs(self) -> int:
        return self.height * self.width * 2

    def sample(self, rng: np.random.Generator, label: int
               ) -> np.ndarray:
        """One spike train (T, H*W*2) for a class: a blob moving along a
        class-specific direction, ON events at the leading edge and OFF at
        the trailing edge (how a DVS sees motion)."""
        t = np.arange(self.timesteps)[:, None, None]
        ys, xs = np.mgrid[0:self.height, 0:self.width]
        angle = 2 * np.pi * label / self.n_classes + self.angle_offset
        cy = self.height / 2 + (t - self.timesteps / 2) * 0.8 * np.sin(angle)
        cx = self.width / 2 + (t - self.timesteps / 2) * 0.8 * np.cos(angle)
        d2 = (ys - cy) ** 2 + (xs - cx) ** 2
        intensity = np.exp(-d2 / (2 * 2.5 ** 2))
        vel = intensity - np.roll(intensity, 1, axis=0)
        p_on = np.clip(vel * 4.0, 0, 0.9)
        p_off = np.clip(-vel * 4.0, 0, 0.9)
        on = rng.random(p_on.shape) < p_on
        off = rng.random(p_off.shape) < p_off
        ev = np.stack([on, off], axis=-1).reshape(self.timesteps, -1)
        return ev.astype(np.float32)

    def _batch_numpy(self, batch_size: int, step: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
        """(spikes (B, T, N) f32, labels (B,) int64) on the host."""
        rng = np.random.default_rng(self.seed * 100003 + step)
        labels = rng.integers(0, self.n_classes, batch_size)
        spikes = np.stack([self.sample(rng, int(l)) for l in labels])
        return spikes, labels.astype(np.int64)

    def batch(self, batch_size: int, step: int = 0, device=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (spikes (B, T, N), labels (B,)) on `device` (default:
        the card), one copy each."""
        spikes, labels = self._batch_numpy(batch_size, step)
        dev = resolve_device(device)
        return (torch.from_numpy(spikes).to(dev),
                torch.from_numpy(labels).to(dev))

    def measured_sparsity(self, batch_size: int = 32) -> float:
        s, _ = self._batch_numpy(batch_size)
        return float(1.0 - np.mean(s))


def cifar_like_rate_coded(n: int = 32, timesteps: int = 8, seed: int = 0,
                          device=None):
    """Rate-coded static-image workload (CIFAR-10-like sparsity ~60%):
    (spikes (n, T, 3072) f32, labels (n,) int64) on `device` (default:
    the card)."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, 3 * 32 * 32)).astype(np.float32) ** 2
    labels = rng.integers(0, 10, n)
    spikes = (rng.random((n, timesteps, imgs.shape[1])) < imgs[:, None, :] * 0.55)
    dev = resolve_device(device)
    return (torch.from_numpy(spikes.astype(np.float32)).to(dev),
            torch.from_numpy(labels.astype(np.int64)).to(dev))
