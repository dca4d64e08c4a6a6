"""Shared LM substrate: architecture configs, norms, RoPE, init, and the
projection hook `linear`.

Port of `repro.models.common`.  `init_dense` / `init_ones` return plain
tensors; the reference's logical axes, which its `Initializer` records
beside them, are `models.transformer.param_specs`, and the mesh layouts
built from them are DTensors (`distributed/sharding.py`).  On a mesh,
`linear` gathers a sharded sequence before a product whose weight is
split on the sequence's axis (tensor parallelism; `gather_rows` gathers
it once for the products of one input), runs any other product on each
device's rows, and `cross_entropy_loss` takes its vocab-parallel form
where the vocab is split, else runs on each device's rows.

Every 2-D weight product of the LM goes through `linear(x, w)`: a tensor
`w` is a plain `x @ w`; a `CodebookWeight` (C3 serving,
`quant/lm_quant.py`) is the `codebook_matmul` kernel, x @ cb[idx] with
the dequantization inside the kernel, where the reference computes
`x @ cb[idx].astype(dtype)`.  On a mesh each device launches the kernel
on its own shards (`_codebook_on_shards`): the kernel takes plain
tensors, never a DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import unpack_indexes_4bit
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Architecture configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024   # tokens per dispatch group (mesh-TF style)
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # hybrid (zamba2): one *shared* attention block every `attn_every` layers
    attn_every: int = 0
    # enc-dec (whisper): encoder layers + frame count from the stub frontend
    enc_layers: int = 0
    enc_frames: int = 1500
    # vlm (phi-3-vision): patch embeddings from the stub CLIP frontend
    n_patches: int = 0
    # misc
    rope_theta: float = 10000.0
    sliding_window: int = 0      # 0 = full causal attention
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # perf options (0/False = paper-faithful baseline)
    attn_chunk: int = 0          # >0: query-chunked attention (flash-style)
    kv_cache_dtype: Any = None   # e.g. torch.int8 for quantized KV cache
    quant_serving: Any = False   # C3 codebook weights in decode: True|"4bit"
    constrain_ffn_out: bool = False  # on a mesh: lay the ffn output out
                                     # before the residual add (train)
    remat_policy: str = "nothing"    # training: nothing | dots | everything
                                     # (models.transformer.REMAT_POLICIES)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists (ssm / hybrid)."""
        return self.family in ("ssm", "hybrid")

    # --- derived sizes -----------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops in roofline)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        dense_mlp = 3 * d * ff
        emb = v * d
        if self.family == "moe":
            moe = self.n_experts * 3 * d * ff + d * self.n_experts
            total = self.n_layers * (attn + moe) + 2 * emb + d
        elif self.family == "ssm":
            total = self.n_layers * self._ssm_layer_params() + 2 * emb + d
        elif self.family == "hybrid":
            total = (self.n_layers * self._ssm_layer_params()
                     + (attn + dense_mlp) + 2 * emb + d)  # one shared block
        elif self.family == "audio":
            enc = self.enc_layers * (attn + dense_mlp)
            dec = self.n_layers * (2 * attn + dense_mlp)  # self + cross
            total = enc + dec + 2 * emb + d
        else:  # dense, vlm
            total = self.n_layers * (attn + dense_mlp) + 2 * emb + d
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        act_moe = self.top_k * 3 * d * ff + d * self.n_experts
        return int(self.n_layers * (attn + act_moe) + 2 * self.vocab * d + d)

    def _ssm_layer_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        nh = d_in // self.ssm_head_dim
        n = self.ssm_state
        in_proj = d * (2 * d_in + 2 * n + nh)
        out_proj = d_in * d
        conv = (d_in + 2 * n) * self.ssm_conv
        return in_proj + out_proj + conv + 2 * nh + d_in


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_dense(gen: torch.Generator, shape: tuple[int, ...], dtype,
               scale: float | None = None) -> torch.Tensor:
    """Normal(0, scale) drawn in f32 on `gen`'s device, cast to `dtype`;
    `scale` defaults to fan_in ** -0.5 (the reference's
    `Initializer.dense`, one layer at a time instead of stacked)."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def init_ones(gen: torch.Generator, shape: tuple[int, ...], dtype
              ) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# Primitive layers (pure functions)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S); f32
    angles, split-halves layout."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class CodebookWeight(NamedTuple):
    """A (K, N) weight as int8 indexes into a codebook: the operand
    `linear` multiplies on the `codebook_matmul` kernel.  `cb` is f32 and
    already rounded to the serving type, so the kernel multiplies exactly
    the weights the reference's `cb[idx].astype(dtype)` holds.  With
    `packed`, `idx` holds two 4-bit indexes a byte, (K, N / 2) uint8: a
    DTensor's, unpacked on each device's own shard."""

    idx: torch.Tensor      # (K, N) int8, contiguous; (K, N / 2) if packed
    cb: torch.Tensor       # (L,) f32, L <= 16
    packed: bool = False


def _unpacked(idx: torch.Tensor, packed: bool) -> torch.Tensor:
    return unpack_indexes_4bit(idx, idx.shape[-1] * 2) if packed else idx


def gather_codebook(w: CodebookWeight) -> torch.Tensor:
    """cb[idx] as a dense tensor of cb's type; a DTensor `idx` gathers
    each device's own shard (its layout is the output's), the codebook
    replicated."""
    if not SH.is_dtensor(w.idx):
        return w.cb[_unpacked(w.idx, w.packed).long()]
    mesh = w.idx.device_mesh
    spec = SH.spec_of(w.idx.placements, w.idx.ndim, mesh)
    return SH.on_shards(lambda ix, cb: cb[_unpacked(ix, w.packed).long()],
                        mesh, (w.idx, w.cb), (spec, SH.P(None)), spec)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N) in x's type.  A `CodebookWeight`
    runs `ops.codebook_matmul` on x as a contiguous (M, K) matrix (on a
    CUDA tensor the kernel, or a raise; its plain version on the CPU);
    the f32 product is rounded to x's type, as the reference's product of
    two tensors of that type is; on a mesh, on each device's shards
    (`_codebook_on_shards`).  On a mesh a DTensor x's sequence is
    gathered where w is split on its axis (`_fold_ready`), else the
    product runs on each device's rows (`_on_rows`)."""
    if isinstance(w, CodebookWeight):
        if SH.is_dtensor(x) or SH.is_dtensor(w.idx):
            return _codebook_on_shards(x, w)
        idx = _unpacked(w.idx, w.packed)
        k, n = idx.shape
        out = ops.codebook_matmul(x.reshape(-1, k).contiguous(), idx, w.cb)
        return out.to(x.dtype).reshape(*x.shape[:-1], n)
    if x.ndim > 2 and SH.is_dtensor(x):
        x = _fold_ready(x, w)
        if _rows_split(x):
            return _on_rows(x, w)
        return _FoldReadyGrad.apply(x @ w)
    return x @ w


def _rows_split(x) -> bool:
    """Whether DTensor x (..., K) has a leading dim past the first (the
    sequence) sharded on a mesh axis, and its last dim whole."""
    return SH.entry_of(x, x.ndim - 1) is None and any(
        isinstance(p, SH.Shard) and 0 < p.dim < x.ndim - 1
        for p in x.placements)


def _on_rows(x, w):
    """x @ w on each device's rows of DTensor x (..., K), its sequence
    split (sequence parallelism through a product whose weight is not
    split on that axis, as a head-dim weight of a block whose heads it
    does not split is laid out): w's rows whole (an FSDP shard
    gathered), its columns on their own
    axis where x's rows leave it free, else whole; the output laid out as
    x's rows and w's columns."""
    mesh = x.device_mesh
    lead = tuple(SH.spec_of(x.placements, x.ndim, mesh))[:-1]
    pn = SH.free_of(SH.entry_of(w, 1), *lead) if SH.is_dtensor(w) else None
    return SH.on_shards(torch.matmul, mesh, (x, w),
                        (SH.P(*lead, None), SH.P(None, pn)),
                        SH.P(*lead, pn))


def gather_rows(x, *ws):
    """x (B, S, K) as the products x @ w of one block input, one for each
    of `ws`, read it: where any w is split on the axis x's sequence is
    split on (a tensor-parallel block), the sequence gathered once
    (`_fold_ready`) and shared by all of them, so `linear` gathers no
    more; else x as it is laid out, each product on each device's rows.
    A tuple, one entry per w."""
    if not SH.is_dtensor(x) or x.ndim < 3 or all(
            _fold_placements(x, w) == tuple(x.placements) for w in ws):
        return (x,) * len(ws)
    return (_fold_ready(x),) * len(ws)


def relaid(w, spec, mesh):
    """Weight `w` (a DTensor, or a `CodebookWeight` whose indexes are
    one) laid out by `spec` on `mesh`: DTensor's redistribution, which
    splits a replicated dim before it gathers a sharded one, so a device
    receives only its own slice; an uneven split is DTensor's."""
    t = w.idx if isinstance(w, CodebookWeight) else w
    t = SH.replicated(t, mesh)
    want = SH.placements(spec, mesh)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    return w._replace(idx=t) if isinstance(w, CodebookWeight) else t


def columns(w, a: int, b: int):
    """Columns [a, b) of a (K, N) weight: a tensor's slice, or a
    `CodebookWeight` of its indexes' slice (of a packed one, bytes
    [a / 2, b / 2); a and b even)."""
    if not isinstance(w, CodebookWeight):
        return w[:, a:b]
    step = 2 if w.packed else 1
    return w._replace(idx=w.idx[:, a // step:b // step])


def weight_spec(w, mesh):
    """The PartitionSpec of a 2-D product weight (a dense DTensor's, or a
    `CodebookWeight`'s indexes'); replicated for a plain tensor."""
    t = w.idx if isinstance(w, CodebookWeight) else w
    if not SH.is_dtensor(t):
        return SH.P(None, None)
    return SH.spec_of(t.placements, 2, mesh)


def divided_axis(x, w, candidates):
    """The mesh axis a product x @ w whose work every device of that axis
    would repeat is divided over, or None.  DTensor x (..., K) has its
    rows split on the axes w's rows are split on (FSDP's "embed", which
    the product then gathers), and the first of `candidates` that is a
    single axis of more than one device splitting neither x nor w is
    returned: each of its devices would multiply the same rows by the
    same weight.  A batch of one request (its rows replicated) keeps
    DTensor's route, the product on each device's slice of K."""
    mesh = x.device_mesh
    pk, pn = weight_spec(w, mesh)
    rows = SH.entry_of(x, 0)
    if pk is None or rows is None or SH._axis_names(pk) != \
            SH._axis_names(rows):
        return None
    used = {a for spec in (SH.spec_of(x.placements, x.ndim, mesh), (pk, pn))
            for e in spec if e is not None for a in SH._axis_names(e)}
    sizes = SH.mesh_sizes(mesh)
    for cand in candidates:
        if isinstance(cand, str) and cand in sizes and cand not in used \
                and sizes[cand] > 1:
            return cand
    return None


def _codebook_on_shards(x, w: CodebookWeight):
    """x @ cb[idx] on a mesh: each device launches the codebook product
    on its local x and idx (a 4-bit idx unpacked there), the codebook
    replicated.  x keeps its rows' layout (`_fold_ready`); idx keeps
    its own unless an axis of it is one x's rows are split on (FSDP's
    "data"), which is gathered.  idx split on N
    (column-parallel): the output is split on its last dim.  idx split
    on K (row-parallel): x's last dim is split alike and each device's
    product, rounded to x's type, is a partial sum, stacked on a new
    leading dim split over K's axes and summed (DTensor's reduction)."""
    mesh = (w.idx if SH.is_dtensor(w.idx) else x).device_mesh
    x = SH.replicated(x, mesh)
    x = _fold_ready(x, w)
    lead = tuple(SH.spec_of(x.placements, x.ndim, mesh))[:-1]
    pk, pn = (SH.spec_of(w.idx.placements, 2, mesh)
              if SH.is_dtensor(w.idx) else (None, None))
    pk = SH.nontrivial(SH.free_of(pk, *lead), mesh)
    pn = SH.free_of(pn, *lead, pk)
    dtype = x.dtype

    def local(xl, il, cb):
        il = _unpacked(il, w.packed)
        k, n = il.shape
        out = ops.codebook_matmul(xl.reshape(-1, k).contiguous(),
                                  il.contiguous(), cb.contiguous())
        out = out.to(dtype).reshape(*xl.shape[:-1], n)
        return out if pk is None else out[None]

    in_specs = (SH.P(*lead, pk), SH.P(pk, pn), SH.P(None))
    if pk is None:
        return SH.on_shards(local, mesh, (x, w.idx, w.cb), in_specs,
                            SH.P(*lead, pn))
    return SH.on_shards(local, mesh, (x, w.idx, w.cb), in_specs,
                        SH.P(pk, *lead, pn)).sum(dim=0)


def _split_axes(w):
    """The mesh axes a product's weight is split on (a dense DTensor's,
    or a `CodebookWeight`'s indexes'); none for a plain tensor."""
    t = w.idx if isinstance(w, CodebookWeight) else w
    if not SH.is_dtensor(t):
        return set()
    return {name for name, p in zip(t.device_mesh.mesh_dim_names,
                                    t.placements) if p.is_shard()}


def _fold_placements(x, w=None) -> tuple:
    """The placements `_fold_ready(x, w)` lays DTensor x out in."""
    names = x.device_mesh.mesh_dim_names
    axes = set(names) if w is None else _split_axes(w)
    return tuple(SH.Replicate() if isinstance(pl, SH.Shard)
                 and 0 < pl.dim < x.ndim - 1 and name in axes else pl
                 for name, pl in zip(names, x.placements))


def _fold_ready(x, w=None):
    """A DTensor (..., K) ready for a product with weight `w`: a shard of
    a leading dim past the first (the sequence, under sequence
    parallelism) is gathered where it lies on an axis `w` is split on
    (every such shard without `w`), as the reference's layout gathers it
    for a tensor-parallel product; the rest stay, and the product runs on
    each device's rows (`_on_rows`; a flatten of (B, S) with S sharded
    has no DTensor rule in torch 2.11 or needs a strided shard)."""
    want = _fold_placements(x, w)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


class _FoldReadyGrad(torch.autograd.Function):
    """Identity on a folded product's DTensor output whose gradient takes
    the output's own layout (a partial sum's gradient replicated): the
    product's backward folds the gradient as it folded the input, which a
    gradient arriving sequence-sharded (from the next residual layout)
    cannot be; and a gradient that DTensor left whole on an axis the
    output is split on (a split of the output's last dim, as mamba2's
    in_proj is split, gathers it) would have the weight's gradient
    computed whole on every device of that axis."""

    @staticmethod
    def forward(ctx, y):
        ctx.placements = tuple(SH.Replicate() if p.is_partial() else p
                               for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if not SH.is_dtensor(g) or tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def swiglu(x, wi, wg, wo):
    xi, xg = gather_rows(x, wi, wg)
    return linear(linear(xi, wi) * F.silu(linear(xg, wg)), wo)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       z_loss: float = 1e-4, *,
                       rules: SH.ShardingRules = SH.ShardingRules()
                       ) -> torch.Tensor:
    """Stable CE with z-loss, in f32; logits (..., V), labels (...,) int.
    With `mask`, the mean over the masked positions (at least one).  A
    DTensor `logits` on a mesh is laid out by `rules` and, its vocab
    split, takes the vocab-parallel form (`_vocab_parallel_terms`)."""
    if SH.is_dtensor(logits):
        logits, vocab_parallel = _vocab_layout(logits, rules)
        lse, ll = (_vocab_parallel_terms(logits, labels) if vocab_parallel
                   else _row_terms_on_shards(logits, labels))
    else:
        # One device keeps the plain f32 chain, not `_RowTerms`: at
        # mesh=None a training step issues the ops it issued before the
        # mesh came (tests/test_torch_mesh_train.py
        # `test_no_mesh_issues_the_one_device_ops` holds them to a
        # record), and the chain is what `_RowTerms` is held to bitwise.
        # Its cost is the f32 logits kept for the backward, a
        # (1, 4096, 49155) tensor of 0.8 GB at granite-3-2b B 1 x S 4096,
        # where a train_4k mesh device's rows would be 12 GiB.
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll + z_loss * lse ** 2
    if mask is not None:
        mask = mask.to(loss.dtype)
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()


def _vocab_layout(logits, rules: SH.ShardingRules):
    """DTensor logits (..., V) laid out as `rules` say (the batch on its
    axes, "vocab" on "model"), and whether the vocab dim is then split
    across devices.  A vocab that its axis does not divide (granite's
    49155 on 16) is split unevenly, as DTensor's product leaves it and
    as XLA pads it: gathering it whole for each device's rows would hold
    the rows' logits twice over (an all-gather's buffer and its
    concatenation, 12.9 GB on a granite train_4k device).  An axis of
    one device, or rules that name none, leave it whole."""
    mesh = logits.device_mesh
    nd = logits.ndim
    spec = SH.spec_for(tuple(logits.shape),
                       ("batch",) + (None,) * (nd - 2) + ("vocab",), mesh,
                       rules)
    if spec[-1] is None:
        spec = SH.P(*spec[:-1], _uneven_vocab_axis(logits.shape[-1], spec,
                                                   mesh, rules))
    split = SH.nontrivial(spec[-1], mesh) is not None
    if not split:
        spec = SH.P(*spec[:-1], None)
    want = SH.placements(spec, mesh)
    if tuple(logits.placements) != want:
        logits = logits.redistribute(mesh, want)
    return logits, split


def _uneven_vocab_axis(vocab: int, spec, mesh, rules: SH.ShardingRules):
    """The first single mesh axis the rules name for "vocab" that the
    other dims of `spec` leave free and that has no more devices than
    `vocab` has entries, or None."""
    sizes = SH.mesh_sizes(mesh)
    taken = {a for e in spec[:-1] if e is not None
             for a in SH._axis_names(e)}
    for cand in rules.get("vocab"):
        if isinstance(cand, str) and cand in sizes and cand not in taken \
                and sizes[cand] <= vocab:
            return cand
    return None


# f32 bytes of logits a slab of `_RowTerms` converts at a time
ROW_SLAB_BYTES = 2 ** 28


class _RowTerms(torch.autograd.Function):
    """(logsumexp, the label's logit) of each row of logits (..., V) in
    f32, the unsplit-vocab terms of `cross_entropy_loss` on each device's
    rows, a slab of ROW_SLAB_BYTES (in f32) at a time.  The ops and their
    gradient are the one-device ones (`logits.float()`, `logsumexp`,
    `gather`; exp(x - lse) times the lse gradient with the label's
    gradient added at its column, rounded to the logits' type), so a
    single slab is bitwise the one-device loss.  Only the logits in their
    own type are kept for the backward: autograd of the f32 chain keeps
    f32 copies of every row (the (16, 4096, 49155) logits of a train_4k
    device are 12 GiB in f32)."""

    @staticmethod
    def forward(ctx, logits, labels):
        flat = logits.reshape(-1, logits.shape[-1])
        idx = labels.reshape(-1, 1).long()
        lse = torch.empty(flat.shape[0], dtype=torch.float32,
                          device=flat.device)
        ll = torch.empty_like(lse)
        for rows in _row_slabs(flat):
            x = flat[rows].float()
            lse[rows] = torch.logsumexp(x, dim=-1)
            ll[rows] = torch.gather(x, -1, idx[rows])[:, 0]
        ctx.save_for_backward(flat, idx, lse)
        ctx.shape = logits.shape
        return lse.view(logits.shape[:-1]), ll.view(logits.shape[:-1])

    @staticmethod
    def backward(ctx, g_lse, g_ll):
        flat, idx, lse = ctx.saved_tensors
        zeros = torch.zeros_like(lse)
        g_lse = zeros if g_lse is None else g_lse.reshape(-1)
        g_ll = zeros if g_ll is None else g_ll.reshape(-1)
        grad = torch.empty_like(flat)
        for rows in _row_slabs(flat):
            d = g_lse[rows, None] * (flat[rows].float()
                                     - lse[rows, None]).exp()
            grad[rows] = d.scatter_add_(-1, idx[rows], g_ll[rows, None])
        return grad.view(ctx.shape), None


def _row_slabs(flat) -> list:
    """Row slices of (R, V) `flat` of at most ROW_SLAB_BYTES in f32."""
    step = max(1, ROW_SLAB_BYTES // (4 * flat.shape[1]))
    return [slice(i, i + step) for i in range(0, flat.shape[0], step)]


def _row_terms_on_shards(logits, labels):
    """(logsumexp, the label's logit) of DTensor logits (..., V) with the
    vocab dim whole: `_RowTerms` on each device's rows."""
    mesh = logits.device_mesh
    spec = SH.spec_of(logits.placements, logits.ndim, mesh)
    rows = SH.P(*tuple(spec)[:-1])
    return SH.on_shards(_RowTerms.apply, mesh, (logits, labels),
                        (spec, rows), (rows, rows))


def _vocab_parallel_terms(logits, labels):
    """(logsumexp, the label's logit) of DTensor logits (..., V) whose
    vocab dim is split across devices, in f32: the max is taken over the
    vocab and reduced, then each device sums the exponentials and picks
    the label's logit (the sum of its logits where its vocab ids equal
    the label) on its own slice (`SH.on_shards`), and the partial sums
    are reduced over the vocab's axes, so no device holds a full row and
    the backward stays on each device's slice.  An uneven split holds
    each device's `torch.chunk` slice of the vocabulary."""
    mesh = logits.device_mesh
    spec = SH.spec_of(logits.placements, logits.ndim, mesh)
    pv, rows = spec[-1], SH.P(*tuple(spec)[:-1])
    n = SH._axis_size(SH.mesh_sizes(mesh), pv)
    first = SH.shard_index(mesh, pv) * -(-logits.shape[-1] // n)
    m = logits.detach().amax(dim=-1)

    def local(x, labels, m):
        x = x.float()
        m = m.float()[..., None]
        ids = torch.arange(first, first + x.shape[-1], device=x.device)
        hit = labels.long()[..., None] == ids
        return (torch.exp(x - m).sum(dim=-1)[None],
                torch.where(hit, x, torch.zeros((), device=x.device)
                            ).sum(dim=-1)[None])

    parts = SH.P(pv, *rows)
    sumexp, ll = SH.on_shards(local, mesh, (logits, labels, m),
                              (spec, rows, rows), (parts, parts))
    return m.float() + torch.log(sumexp.sum(dim=0)), ll.sum(dim=0)
