"""Spiking convolutional network — the paper's DVS-Gesture / CIFAR-10
workload class, in torch.  Port of `repro.models.snn_conv`.

Conv LIF layers with surrogate-gradient BPTT, 2x2 average pooling
between stages, a dense LIF head and a rate-coded readout.  Data is NHWC
and conv weights HWIO, as in the reference; the convolution is
`torch.nn.functional.conv2d` on NCHW / OIHW views (the reference's
`lax.conv_general_dilated` is outside any kernel).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.neuron import LIFParams, LIFState, lif_step
from repro_torch.device import resolve_device
from repro_torch.models.snn import cross_entropy


@dataclasses.dataclass(frozen=True)
class ConvSNNConfig:
    in_shape: tuple = (16, 16, 2)         # H, W, C (DVS: 2 polarity channels)
    channels: tuple = (8, 16)             # conv channels per stage
    kernel: int = 3
    n_classes: int = 10
    timesteps: int = 8
    lif: LIFParams = LIFParams()


def init_params(cfg: ConvSNNConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """He-normal HWIO conv weights and a dense head, drawn on the CPU
    from `generator` (default: seed 0), placed on `device` (default: the
    card)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    params = {}
    c_in = cfg.in_shape[-1]
    for i, c_out in enumerate(cfg.channels):
        fan_in = cfg.kernel * cfg.kernel * c_in
        params[f"conv{i}"] = (torch.randn(
            (cfg.kernel, cfg.kernel, c_in, c_out), generator=gen)
            * (2.0 / fan_in) ** 0.5).to(dev)
        c_in = c_out
    h = cfg.in_shape[0] // (2 ** len(cfg.channels))
    w = cfg.in_shape[1] // (2 ** len(cfg.channels))
    params["head"] = (torch.randn((h * w * c_in, cfg.n_classes),
                                  generator=gen)
                      * (2.0 / (h * w * c_in)) ** 0.5).to(dev)
    return params


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, stride 1, SAME padding."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding="same")
    return out.permute(0, 2, 3, 1)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 sum over VALID windows, / 4 (the reference's reduce_window)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4.0


def forward(params: dict, cfg: ConvSNNConfig, spikes: torch.Tensor):
    """spikes (B, T, H, W, C) -> (counts (B, classes), stats)."""
    b, t = spikes.shape[:2]
    dev = spikes.device
    h, w, _ = cfg.in_shape

    def make_state(shape):
        return LIFState(v=torch.zeros(shape, device=dev),
                        elapsed=torch.zeros(shape, dtype=torch.int32,
                                            device=dev))

    shapes = []
    hh, ww = h, w
    for c_out in cfg.channels:
        shapes.append((b, hh, ww, c_out))
        hh, ww = hh // 2, ww // 2
    states = ([make_state(s) for s in shapes]
              + [make_state((b, cfg.n_classes))])

    counts, sops, nominal = None, [], []
    for step in range(t):
        x = spikes[:, step]                           # (B, H, W, C) {0,1}
        s_sops = torch.zeros((), device=dev)
        s_nominal = 0.0
        for i, _ in enumerate(cfg.channels):
            wgt = params[f"conv{i}"]
            cur = _conv(x, wgt)
            taps = wgt.shape[-1] * wgt.shape[0] * wgt.shape[1]
            s_sops = s_sops + ((x != 0).sum() * taps).to(torch.float32)
            s_nominal += x.numel() * taps
            states[i], out, _ = lif_step(states[i], cur, cfg.lif)
            x = _pool(out)
        flat = x.reshape(b, -1)
        cur = flat @ params["head"]
        s_sops = s_sops + ((flat != 0).sum()
                           * cfg.n_classes).to(torch.float32)
        s_nominal += flat.numel() * cfg.n_classes
        states[-1], out, _ = lif_step(states[-1], cur, cfg.lif)
        counts = out if counts is None else counts + out
        sops.append(s_sops)
        nominal.append(s_nominal)
    sops_sum = torch.stack(sops).sum()
    nominal_sum = torch.tensor(float(sum(nominal)), device=dev)
    stats = {
        "performed_sops": sops_sum,
        "nominal_sops": nominal_sum,
        "sparsity": 1.0 - sops_sum / torch.clamp(nominal_sum, min=1.0),
    }
    return counts, stats


def loss_fn(params, cfg, spikes, labels):
    counts, stats = forward(params, cfg, spikes)
    return cross_entropy(counts, labels), stats


def sgd_step(params: dict, cfg, spikes, labels, lr: float = 0.3):
    """One plain SGD step -> (new params, loss, stats)."""
    ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, stats = loss_fn(ps, cfg, spikes, labels)
    grads = torch.autograd.grad(loss, list(ps.values()))
    new = {k: (p - lr * g).detach()
           for (k, p), g in zip(ps.items(), grads)}
    return new, loss.detach(), {k: v.detach() for k, v in stats.items()}


def accuracy(params, cfg, spikes, labels):
    counts, _ = forward(params, cfg, spikes)
    return (counts.argmax(dim=-1) == labels).to(torch.float32).mean()
