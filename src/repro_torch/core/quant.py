"""Non-uniform (codebook / LUT) weight quantization — paper C3, in torch.

Port of `repro.core.quant`: quantization, the register-word round trip,
the plasticity projection `project_to_codebook`, the QAT forward
`fake_quant` (straight-through gradient), the 4-bit index packing and the
memory accounting.  On the chip all synapses of
a core share an N x W-bit weight table and each synapse stores a
log2(N)-bit index, so a weight tensor is

    idx      : int8  same shape as the weight (values in [0, N))
    codebook : (G, N) f32 — per-group table of W-bit fixed-point values
    scale    : (G,) f32 — the fixed-point step

Codebooks are fit by 1-D k-means (Lloyd) on the tensor's own device.  At
the paper's widths the (M, N) distance matrix of one Lloyd step is about
600 MB in f32, which the card holds easily; the cluster sums reduce a
one-hot matrix of the same size by a pairwise tree whose pairs depend on
M alone (`_tree_colsum`), so a fit is the same on every call and on
every device, the card's bitwise the CPU's.  Float sums over a cluster
run in another order than XLA's, so centroids agree with the reference
to a few ulp, not bit for bit; the harness carries the reference's
fitted tensors across with `repro_torch.convert` where equality matters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

VALID_N = (4, 8, 16)
VALID_W = (4, 8, 16)


@dataclasses.dataclass(frozen=True)
class CodebookConfig:
    n_levels: int = 16          # N: entries in the shared table
    bit_width: int = 8          # W: precision of each stored entry
    group_size: int = 0         # 0 => one codebook per tensor ("per-core");
                                # else one per `group_size` output columns
    kmeans_iters: int = 25
    zero_level: bool = False    # snap the centroid nearest 0 to exactly 0,
                                # so pruned synapses stay absent on-chip (the
                                # partial-update touch set sees w == 0)

    def __post_init__(self):
        if self.n_levels not in VALID_N:
            raise ValueError(f"N must be in {VALID_N}")
        if self.bit_width not in VALID_W:
            raise ValueError(f"W must be in {VALID_W}")

    @property
    def index_bits(self) -> int:
        return max(1, (self.n_levels - 1).bit_length())

    def bits_per_weight(self) -> float:
        """Storage cost per synapse (indexes dominate; table is amortized)."""
        return float(self.index_bits)


class QuantizedTensor(NamedTuple):
    idx: torch.Tensor       # int8, shape == original weight shape
    codebook: torch.Tensor  # (G, N) float32, W-bit fixed-point values
    scale: torch.Tensor     # (G,) float32 fixed-point step
    group_axis_size: int    # columns per group (0 = whole tensor)

    @property
    def shape(self):
        return tuple(self.idx.shape)


def _fixed_point(values: torch.Tensor, bit_width: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Snap codebook entries to signed W-bit fixed point (chip table format)."""
    qmax = 2.0 ** (bit_width - 1) - 1.0
    amax = torch.clamp(values.abs().amax(dim=-1), min=1e-8)
    # a tensor divisor: the card divides by a host scalar as a multiply
    # by its reciprocal, an ulp off the CPU's (and the reference's) quotient
    scale = amax / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(values / scale[..., None]), -qmax - 1, qmax)
    return q * scale[..., None], scale


def _quantile_linear(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """`jnp.quantile(x, qs)` (linear interpolation) by one sort.

    `torch.quantile` refuses inputs above 2**24 elements; a sort does not.
    """
    xs = torch.sort(x).values
    pos = qs.to(torch.float64) * (x.numel() - 1)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    hw = (pos - lo.to(torch.float64)).to(x.dtype)
    return xs[lo] * (1.0 - hw) + xs[hi] * hw


def _tree_colsum(m: torch.Tensor) -> torch.Tensor:
    """Column sums of an (M, N) f32 matrix by a pairwise tree over its
    rows: at each level row i adds row i + h (h = rows // 2) and an odd
    last row is added into row h - 1.  The adds are fixed by M alone, so
    the sums are bitwise equal on every device; `sum(dim=0)` splits the
    rows by the device's own reduction layout (on an H100 against the
    CPU, ARCH's per-core fits then differed in one index of 13.7 M).
    Reduces in place (`m` is overwritten) and returns a copy of the sums:
    a view would keep the whole of `m` alive."""
    while m.shape[0] > 1:
        h = m.shape[0] // 2
        odd = m.shape[0] % 2
        m[:h].add_(m[h:2 * h])
        if odd:
            m[h - 1].add_(m[2 * h])
        m = m[:h]
    return m[0].clone()


def _kmeans_1d(x: torch.Tensor, n: int, iters: int) -> torch.Tensor:
    """Lloyd's algorithm on a flat value vector -> (n,) sorted centroids."""
    # Percentile init is robust for bell-shaped weight distributions.
    qs = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) / n
    cents = _quantile_linear(x, qs)
    levels = torch.arange(n, device=x.device)
    for _ in range(iters):
        assign = torch.argmin((x[:, None] - cents[None, :]).abs(), dim=1)
        tot = torch.bincount(assign, minlength=n).to(x.dtype)
        # cluster sums as the reference's one-hot reduction, in an order
        # that depends on the size alone (an `index_add_` on the card adds
        # in the atomics' order, a `sum` in the device's layout)
        sums = _tree_colsum(torch.where(assign[:, None] == levels,
                                        x[:, None], 0.0))
        cents = torch.where(tot > 0, sums / torch.clamp(tot, min=1), cents)
    return torch.sort(cents).values


def _group_view(w: torch.Tensor, group_size: int
                ) -> tuple[torch.Tensor, int]:
    """Reshape (..., cols) -> (G, elems_per_group)."""
    if group_size <= 0 or group_size >= w.shape[-1]:
        return w.reshape(1, -1), 0
    if w.shape[-1] % group_size:
        raise ValueError("group_size must divide the last dim")
    flat = w.reshape(-1, w.shape[-1])
    g = w.shape[-1] // group_size
    return (flat.reshape(flat.shape[0], g, group_size)
            .permute(1, 0, 2).reshape(g, -1), group_size)


def quantize(w, cfg: CodebookConfig, device=None) -> QuantizedTensor:
    """Fit codebook(s) and assign every weight its nearest index.

    Runs on `device` (default: the card, see `repro_torch.resolve_device`)
    unless `w` is already a tensor, in which case it runs where `w` lies.
    """
    from repro_torch.device import resolve_device

    if isinstance(w, torch.Tensor) and device is None:
        w = w.to(torch.float32)
    else:
        w = torch.as_tensor(np.asarray(w, np.float32),
                            device=resolve_device(device))
    grouped, gsize = _group_view(w, cfg.group_size)
    cents = torch.stack([_kmeans_1d(v, cfg.n_levels, cfg.kmeans_iters)
                         for v in grouped])
    cents, scale = _fixed_point(cents, cfg.bit_width)
    if cfg.zero_level:
        # force one table entry to exact 0 (a "no synapse" level): pruned
        # weights then dequantize to 0.0 and drop out of the touch set
        zi = torch.argmin(cents.abs(), dim=-1)
        lvl = torch.arange(cents.shape[-1], device=cents.device)
        cents = torch.where(lvl[None, :] == zi[:, None],
                            torch.zeros_like(cents), cents)
    idx_g = torch.stack([
        torch.argmin((vals[:, None] - c[None, :]).abs(), dim=1)
        .to(torch.int8) for vals, c in zip(grouped, cents)])
    if gsize == 0:
        idx = idx_g.reshape(w.shape)
    else:
        rows = w.reshape(-1, w.shape[-1]).shape[0]
        g = w.shape[-1] // gsize
        idx = (idx_g.reshape(g, rows, gsize).permute(1, 0, 2)
               .reshape(w.shape))
    return QuantizedTensor(idx=idx, codebook=cents, scale=scale,
                           group_axis_size=gsize)


def quantization_error(w, cfg: CodebookConfig, device=None) -> torch.Tensor:
    """RMS relative error of a whole-tensor fit, as a 0-d f32 tensor —
    used by tests and the PTQ calibration report.  Runs where `quantize`
    runs (on `w`'s device when it is a tensor)."""
    q = quantize(w, cfg, device=device)
    w = torch.as_tensor(w if isinstance(w, torch.Tensor)
                        else np.asarray(w, np.float32)
                        ).to(q.idx.device, torch.float32)
    wq = dequantize(q)
    return torch.sqrt(torch.mean((w - wq) ** 2)) / torch.clamp(
        torch.sqrt(torch.mean(w ** 2)), min=1e-12)


def memory_bytes(shape: tuple[int, ...], cfg: CodebookConfig,
                 n_groups: int = 1) -> int:
    """Bytes to store a quantized tensor (indexes + tables), chip accounting."""
    n_elems = math.prod(shape)
    idx_bits = n_elems * cfg.index_bits
    table_bits = n_groups * cfg.n_levels * cfg.bit_width
    return (idx_bits + table_bits + 7) // 8


def project_to_codebook(values, codebook) -> torch.Tensor:
    """Nearest-level projection: float candidate weights -> int8 indexes.

    The on-chip plasticity constraint (paper C3): a learning rule may
    compute an update in float, but the synapse stores a codebook index,
    so every write lands on the nearest table level.

    `codebook` is a shared (N,) level vector, or an (N, cols) per-column
    table whose column j quantizes `values[..., j]`.  Ties resolve to the
    LOWEST index, which keeps the projection idempotent when a table holds
    duplicate levels; +inf rows (the lowering's unprogrammed levels) are
    never chosen.  The reference's argmin over a broadcast (..., L, cols)
    distance tensor would be L times the candidates' size (8.6 GB at the
    paper's widest learnable layer with B = 32), so this loops over the
    levels keeping the best distance and its index, replacing only on a
    strictly smaller distance: the same first-occurrence rule, the same
    single f32 subtraction and abs per distance, so the same indexes bit
    for bit, in about two candidate-sized temporaries.  A NaN distance
    wins as in `jnp.argmin`, the first one kept: a +inf candidate against
    a +inf level (the lowering's fill) keeps that level.
    """
    v = torch.as_tensor(values, dtype=torch.float32)
    cb = torch.as_tensor(codebook, dtype=torch.float32, device=v.device)
    if cb.dim() != 1 and (cb.dim() != 2 or cb.shape[-1] != v.shape[-1]):
        raise ValueError(
            f"codebook must be (N,) or (N, cols) with cols matching "
            f"values' last axis; got {tuple(cb.shape)} vs {tuple(v.shape)}")
    best = (v - cb[0]).abs_()
    idx = torch.zeros(v.shape, dtype=torch.int8, device=v.device)
    best.nan_to_num_(nan=-1.0, posinf=torch.inf)
    for level in range(1, cb.shape[0]):
        dist = (v - cb[level]).abs_()
        # jnp.argmin returns the first NaN: a NaN distance (a NaN level,
        # or +inf against +inf) becomes -1, below every real distance,
        # and a later -1 is not strictly below it
        dist.nan_to_num_(nan=-1.0, posinf=torch.inf)
        closer = dist < best
        idx.masked_fill_(closer, level)
        torch.minimum(best, dist, out=best)
    return idx


class _FakeQuant(torch.autograd.Function):
    """quantize -> dequantize forward, straight-through backward (the
    reference's `fake_quant` custom VJP)."""

    @staticmethod
    def forward(ctx, w, cfg):
        return dequantize(quantize(w, cfg))

    @staticmethod
    def backward(ctx, g):
        return g, None


_FQ_CACHE: dict = {}


def fake_quant(w: torch.Tensor, cfg_n: int, cfg_w: int) -> torch.Tensor:
    """QAT forward: quantize->dequantize with a whole-tensor codebook fit
    where `w` lies; the gradient passes straight through (STE).  The
    (N, W) config is built once per pair, as the reference caches its
    closure."""
    key = (cfg_n, cfg_w)
    if key not in _FQ_CACHE:
        _FQ_CACHE[key] = CodebookConfig(n_levels=cfg_n, bit_width=cfg_w)
    return _FakeQuant.apply(w, _FQ_CACHE[key])


def gather_index(idx: torch.Tensor, n_levels: int) -> torch.Tensor:
    """The int64 index JAX's gather reads for `idx` into an axis of
    `n_levels`: a negative index wraps by +L, then the index clamps into
    [0, L - 1], so -1, L and 127 read level L - 1 and -128 level 0.
    An int8 index with L <= 127 is wrapped and clamped in int8 (-128 + L
    and -1 + L cannot overflow), an eighth of the int64 traffic."""
    ix = idx if idx.dtype == torch.int8 and n_levels <= 127 else idx.long()
    ix = torch.where(ix < 0, ix + n_levels, ix).clamp_(0, n_levels - 1)
    return ix.long()


def dequantize(q: QuantizedTensor) -> torch.Tensor:
    """Reference dequantization: w = codebook[idx]."""
    ix = q.idx.long()
    if q.group_axis_size == 0:
        return q.codebook[0][ix]
    gsize = q.group_axis_size
    g = q.idx.shape[-1] // gsize
    flat = ix.reshape(-1, g, gsize)                      # (rows, G, gsize)
    groups = torch.arange(g, device=ix.device)[None, :, None]
    return q.codebook[groups, flat].reshape(q.idx.shape)


# ---------------------------------------------------------------------------
# Register-table round trip — the chip's actual storage format for codebooks
# ---------------------------------------------------------------------------
#
# `_fixed_point` snapped every centroid to `word * scale`, so the integer
# words are recoverable exactly; decode recomputes the identical f32
# product `word * scale`.

def codebook_to_words(codebook, scale, bit_width: int) -> np.ndarray:
    """(G, N) f32 codebook -> (G, N) int32 signed W-bit register words.

    Raises if any entry is not representable at `bit_width` (i.e. the
    codebook did not come from `quantize` at this W).
    """
    cb = np.asarray(torch.as_tensor(codebook).cpu(), np.float32)
    sc = np.asarray(torch.as_tensor(scale).cpu(), np.float32)[..., None]
    words = np.rint(cb / sc).astype(np.int64)
    if not np.array_equal(words.astype(np.float32) * sc, cb):
        raise ValueError("codebook entries are not word*scale exact — was it "
                         "produced by quantize() at this bit width?")
    lo, hi = -(2 ** (bit_width - 1)), 2 ** (bit_width - 1) - 1
    if words.min() < lo or words.max() > hi:
        raise ValueError(
            f"codebook words {words.min()}..{words.max()} exceed signed "
            f"{bit_width}-bit range [{lo}, {hi}]")
    return words.astype(np.int32)


def words_to_codebook(words, scale) -> torch.Tensor:
    """Inverse of `codebook_to_words`: bit-exact f32 reconstruction."""
    sc = torch.as_tensor(scale, dtype=torch.float32)
    w = torch.as_tensor(np.asarray(words), dtype=torch.float32,
                        device=sc.device)
    return w * sc[..., None]


def from_register_entry(words, scale, idx: torch.Tensor) -> torch.Tensor:
    """Dequantize an index tensor through one register-table entry
    (`words`, `scale`): the path the chip's SPEs take, a lookup of W-bit
    words; an index is taken by JAX's gather rule (`gather_index`)."""
    cb = words_to_codebook(np.asarray(words)[None, :],
                           torch.tensor([scale], dtype=torch.float32,
                                        device=idx.device))[0]
    return cb[gather_index(idx, cb.shape[0])]


def to_register_entries(q: QuantizedTensor, cfg: CodebookConfig
                        ) -> list[tuple[tuple[int, ...], float]]:
    """One `(words, scale)` register payload per codebook group."""
    words = codebook_to_words(q.codebook, q.scale, cfg.bit_width)
    scales = np.asarray(q.scale.cpu(), np.float32)
    return [(tuple(int(x) for x in words[g]), float(scales[g]))
            for g in range(words.shape[0])]


def register_entry_for_slice(q: QuantizedTensor, cfg: CodebookConfig,
                             neuron_lo: int, neuron_hi: int | None = None
                             ) -> tuple[tuple[int, ...], float]:
    """The (words, scale) payload a core holding columns
    [neuron_lo, neuron_hi) programs into its register table: the codebook
    group covering that slice (group 0 for whole-tensor codebooks).

    A core has exactly ONE table, so a slice that straddles a group
    boundary cannot be represented and raises.
    """
    entries = to_register_entries(q, cfg)
    if q.group_axis_size == 0:
        return entries[0]
    gs = q.group_axis_size
    gi = min(neuron_lo // gs, len(entries) - 1)
    if neuron_hi is not None and neuron_hi > neuron_lo:
        gi_last = min((neuron_hi - 1) // gs, len(entries) - 1)
        if gi_last != gi:
            raise ValueError(
                f"core slice [{neuron_lo}, {neuron_hi}) spans codebook "
                f"groups {gi}..{gi_last} (group_size={gs}) — one core holds "
                f"one table; re-partition on group boundaries or quantize "
                f"per core")
    return entries[gi]


def infer_bit_width(q: QuantizedTensor) -> int:
    """Smallest valid W whose signed range holds every codebook word."""
    last = None
    for wbits in VALID_W:
        try:
            codebook_to_words(q.codebook, q.scale, wbits)
            return wbits
        except ValueError as e:
            last = e
    raise ValueError(f"codebook not representable at any W in {VALID_W}: {last}")


def dequantize_via_registers(q: QuantizedTensor, bit_width: int | None = None
                             ) -> torch.Tensor:
    """Dequantize through the W-bit register-word round trip — exactly what
    the chip computes, and bit-identical to `dequantize(q)`."""
    wbits = bit_width or infer_bit_width(q)
    cb = words_to_codebook(codebook_to_words(q.codebook, q.scale, wbits),
                           q.scale)
    return dequantize(QuantizedTensor(idx=q.idx, codebook=cb, scale=q.scale,
                                      group_axis_size=q.group_axis_size))


# ---------------------------------------------------------------------------
# 4-bit index packing — the chip's real storage format for N=16 tables
# (log2(16) = 4 bits/synapse; two indexes per byte)
# ---------------------------------------------------------------------------
#
# uint8 has shifts in torch (uint16 does not), so the packing is the
# reference's uint8 arithmetic: an index outside [0, 16) wraps and
# truncates exactly as it does there.

def pack_indexes_4bit(idx: torch.Tensor) -> torch.Tensor:
    """int8 indexes in [0,16) -> packed uint8, two per byte (last dim
    halved; odd last dims are zero-padded)."""
    if idx.dtype != torch.int8:
        raise TypeError(f"pack_indexes_4bit takes int8 indexes, got "
                        f"{idx.dtype}")
    if int(idx.shape[-1]) % 2:
        idx = torch.nn.functional.pad(idx, (0, 1))
    lo = idx[..., 0::2].to(torch.uint8)
    hi = idx[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_indexes_4bit(packed: torch.Tensor, last_dim: int) -> torch.Tensor:
    """Inverse of pack_indexes_4bit; `last_dim` restores odd sizes."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    inter = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return inter[..., :last_dim]


def packed_memory_bytes(shape: tuple[int, ...], cfg: CodebookConfig,
                        n_groups: int = 1) -> int:
    """Bytes with 4-bit packing (N<=16): half the int8-index footprint."""
    n_elems = math.prod(shape)
    if cfg.n_levels <= 16:
        idx_bytes = (n_elems + 1) // 2
    else:
        idx_bytes = n_elems
    return idx_bytes + (n_groups * cfg.n_levels * cfg.bit_width + 7) // 8
