"""GQA attention with RoPE, sliding window, prefill + decode KV-cache paths.

Port of `repro.models.attention`: causal self-attention for prefill and
decode, and the audio family's bidirectional `attention_encoder` and
`attention_cross` (plain SDPA, never the flash route).

Flash route: train / prefill self-attention goes through
`kernels.flash_attention` whenever the shape qualifies (`_flash_ok`: a
sequence that is a multiple of 128 and longer than 128, no sliding
window) and the kernel launches for it (`flash_attention.supports`: the
type, head dim and B·H); every other shape runs `_sdpa`, the reference's
default.  The choice is made before the call and is the same on the CPU
and the card: the hand-written kernel for CUDA tensors, its plain version
for CPU tensors.  The reference takes that route only under
``REPRO_FLASH_ATTENTION=1``, an opt-in for a TPU kernel that otherwise
runs in interpret mode; the port reads no such switch.  The route is
differentiable (`_FlashCore`): the backward is the exact gradient of the
reference SDPA, as the reference's custom VJP computes it.

On a mesh (DTensor q / k / v, `launch/steps.py`), each attention runs on
every device's own rows and heads through `local_map` (`_on_local_heads`):
the batch on the rules' batch axes, the heads on "model" when they
divide; kv heads that do not divide are repeated over their query group
first, so each device's kv heads are those its query heads read.  Heads
that do not divide leave the sequence split on "model" through the
block, as the reference's layout does: the block's weights are laid out
with their head dims whole (`_block_weights`), so its projections run on
each device's rows, and each device attends its own query
rows from their offset over the whole k / v (never the flash route,
whose causal mask starts at row 0).  The
flash kernel's wrapper takes plain contiguous tensors, so this is the
only way it runs on a mesh.  Decode and the prefill's cache writes work
on each device's cache shard (`distributed.sharding.decode_state_spec`):
a cache sharded over its positions (kv heads that do not divide) is read
flash-decoding style, the softmax's max, sum and product combined over
"model".
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 supports)
from repro_torch.models.common import (ArchConfig, CodebookWeight,
                                       apply_rope, gather_rows, init_dense,
                                       linear)

NEG_INF = -1e30


def _head_layout(q, k, rules: SH.ShardingRules):
    """(mesh, batch entry, heads entry, kv entry or "repeat") of the
    local attention for DTensor q (B, S, H, hd) and k (B, T, KV, hd) under
    `rules`: "repeat" when the heads divide the model axis and the kv
    heads do not."""
    mesh = q.device_mesh
    b, _, h, _ = q.shape
    pb, ph = SH.spec_for((b, h), ("batch", "heads"), mesh, rules)
    pk = SH.spec_for((b, k.shape[2]), ("batch", "kv_heads"), mesh, rules)[1]
    return mesh, pb, ph, ("repeat" if ph is not None and pk != ph else pk)


def _repeat_kv(t, h: int):
    """(B, T, KV, hd) -> (B, T, H, hd), each kv head over its group."""
    b, n, kv, hd = t.shape
    return t[:, :, :, None, :].expand(b, n, kv, h // kv, hd).reshape(
        b, n, h, hd)


def _on_local_heads(fn, q, k, v, rules: SH.ShardingRules):
    """`fn(q, k, v, offset) -> (B, S, H * hd)` on each device's rows and
    heads of DTensor q (B, S, H, hd), k / v (B, T, KV, hd), through
    `local_map`.  Heads that the model axis does not split leave the
    queries split by sequence (`_query_rows`): each device attends its
    rows, the first at position `offset`, over the whole k / v (gathered
    once), as the reference's layout keeps the sequence split on "model"
    through such a block; every other layout passes offset 0."""
    mesh, pb, ph, pk = _head_layout(q, k, rules)
    if pk == "repeat":
        k, v, pk = _repeat_kv(k, q.shape[2]), _repeat_kv(v, q.shape[2]), ph
    ps = _query_rows(q, pb, ph, rules)
    offset = _offset(mesh, ps, q.shape[1])
    return SH.on_shards(lambda q, k, v: fn(q, k, v, offset), mesh, (q, k, v),
                        (SH.P(pb, ps, ph, None), SH.P(pb, None, pk, None),
                         SH.P(pb, None, pk, None)), SH.P(pb, ps, ph))


def _query_rows(q, pb, ph, rules: SH.ShardingRules):
    """The mesh axis the queries' sequence is split on in the local
    attention: with the heads unsplit (`ph` None), the first candidate
    the rules name for "seq" that the batch leaves free and that divides
    the sequence; else None (every device the whole sequence)."""
    if ph is not None or q.shape[1] < 2:
        return None
    sizes = SH.mesh_sizes(q.device_mesh)
    for cand in rules.get("seq"):
        names = SH._axis_names(cand)
        if all(n in sizes for n in names) and SH.free_of(cand, pb) \
                and q.shape[1] % SH._axis_size(sizes, cand) == 0:
            return cand
    return None


def _flash_ok(cfg: ArchConfig, s: int) -> bool:
    return s % 128 == 0 and s > 128 and cfg.sliding_window <= 0


def _flash_route(q, k, cfg: ArchConfig) -> bool:
    """The flash route for q (B, S, H, hd) against k (B, T, KV, hd): the
    whole sequence's queries (S == T: the kernel's causal mask counts
    rows and columns from 0, so a device's rows at an offset take
    `_sdpa`), a qualifying sequence and a shape the kernel launches
    for."""
    b, s, h, hd = q.shape
    return s == k.shape[1] and _flash_ok(cfg, s) and supports(
        q.dtype, hd, b, h)


class _FlashCore(torch.autograd.Function):
    """The reference's `_flash_core` with its custom VJP.  Forward:
    `flash_attention` on (B, H, S, hd) q and (B, KV, S, hd) k / v (the
    kernel for CUDA tensors, its plain version for CPU tensors).
    Backward: the exact gradient of the reference SDPA with each kv head
    repeated over its group (the reference's `_flash_core_bwd`), by
    autograd of `flash_attention_plain` recomputed from the saved q, k, v:
    O(S·T) memory on the backward only, and no kernel launch."""

    @staticmethod
    def forward(ctx, qh, kh, vh):
        ctx.save_for_backward(qh, kh, vh)
        return flash_attention(qh, kh, vh, causal=True)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
            out = flash_attention_plain(*leaves, causal=True)
            return torch.autograd.grad(out, leaves, g.to(qh.dtype))


def _sdpa_flash(q, k, v):
    """Causal SDPA through the flash kernel.

    q (B,S,H,hd), k/v (B,S,kv,hd) -> (B,S,H*hd).  Numerics: online
    softmax in f32 — matches `_sdpa` to float tolerance, not bit-exactly.
    Differentiable through `_FlashCore`.
    """
    b, s, h, hd = q.shape
    out = _FlashCore.apply(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous())
    return out.transpose(1, 2).reshape(b, s, h * hd).to(v.dtype)


def init_attention(gen: torch.Generator, cfg: ArchConfig, n_layers: int,
                   cross: bool = False) -> dict:
    """One layer's self-attention weights, (in, out) layout; `n_layers`
    sets the `wo` scale.  `cross` adds the cross-attention's `xw*`."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": init_dense(gen, (d, h * hd), cfg.dtype),
        "wk": init_dense(gen, (d, kv * hd), cfg.dtype),
        "wv": init_dense(gen, (d, kv * hd), cfg.dtype),
        "wo": init_dense(gen, (h * hd, d), cfg.dtype,
                         scale=(h * hd) ** -0.5 / (2 * max(n_layers, 1)) ** 0.5),
    }
    if cross:
        p.update(xwq=init_dense(gen, (d, h * hd), cfg.dtype),
                 xwk=init_dense(gen, (d, kv * hd), cfg.dtype),
                 xwv=init_dense(gen, (d, kv * hd), cfg.dtype),
                 xwo=init_dense(gen, (h * hd, d), cfg.dtype))
    return p


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, kv, S_max, hd)
    v: torch.Tensor   # (B, kv, S_max, hd)


def _qkv(x, p, cfg: ArchConfig, positions, rope: bool = True,
         q_name="wq", k_name="wk", v_name="wv", *,
         rules: SH.ShardingRules = SH.ShardingRules()):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xq, xk, xv = gather_rows(x, p[q_name], p[k_name], p[v_name])
    q = _by_heads(linear(xq, p[q_name]), h, "heads", rules).reshape(
        b, s, h, hd)
    k = _by_heads(linear(xk, p[k_name]), kv, "kv_heads",
                  rules).reshape(b, s, kv, hd)
    v = _by_heads(linear(xv, p[v_name]), kv, "kv_heads",
                  rules).reshape(b, s, kv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads_unsplit(x, cfg: ArchConfig, rules: SH.ShardingRules
                   ) -> bool:
    """Whether the rules leave the heads of the attention of DTensor x
    (B, S, d) unsplit: the sequence then stays split on "model" through
    the block, as in the reference's layout (`_block_weights`)."""
    if not SH.is_dtensor(x) or x.shape[1] < 2:
        return False
    return SH.spec_for((x.shape[0], cfg.n_heads), ("batch", "heads"),
                       x.device_mesh, rules)[1] is None


def _block_weights(x, p, names, cfg: ArchConfig,
                   rules: SH.ShardingRules) -> dict:
    """{name: weight} of the projections of one attention block on x, as
    its products read them: where the rules leave the heads unsplit
    (`_heads_unsplit`), each weight with its head dim (wq / wk / wv
    columns, wo rows) whole, so `linear` runs every product on each
    device's rows of x and gathers the weight, not the sequence
    (whisper-tiny's 6 heads on 16 devices would otherwise gather the
    sequence for a product split inside the heads, then gather the
    projection back to whole heads); else the weights as they lie."""
    if not _heads_unsplit(x, cfg, rules):
        return {n: p[n] for n in names}
    return {n: _head_dim_whole(p[n], 0 if n.endswith("wo") else 1)
            for n in names}


def _head_dim_whole(w, dim: int):
    """Weight w (a DTensor, or a `CodebookWeight` of one) with its dim
    `dim` gathered on every mesh axis it is split on."""
    t = w.idx if isinstance(w, CodebookWeight) else w
    if not SH.is_dtensor(t) or SH.entry_of(t, dim) is None:
        return w
    want = tuple(SH.Replicate() if isinstance(pl, SH.Shard) and pl.dim == dim
                 else pl for pl in t.placements)
    t = t.redistribute(t.device_mesh, want)
    return w._replace(idx=t) if isinstance(w, CodebookWeight) else t


def _by_heads(y, n_heads: int, logical: str, rules: SH.ShardingRules):
    """A DTensor projection (B, S, n_heads * hd) laid out as the heads
    split it: rows on the batch axes, the heads on "model" when they
    divide it, else whole (a shard inside a head cannot be reshaped to
    (..., heads, hd)) with the sequence left as the product laid it out.
    A plain tensor passes through."""
    if not SH.is_dtensor(y):
        return y

    mesh = y.device_mesh
    pb, ph = SH.spec_for((y.shape[0], n_heads), ("batch", logical), mesh,
                         rules)
    ps = SH.entry_of(y, 1) if ph is None else None
    want = SH.placements(SH.P(pb, SH.free_of(ps, pb), ph), mesh)
    return y if tuple(y.placements) == want else y.redistribute(mesh, want)


def _sdpa(q, k, v, mask, cfg: ArchConfig):
    """q (B,S,H,hd), k/v (B,T,kv,hd) -> (B,S,H*hd); GQA via head grouping.

    Scores in f32 (the storage type's products are exact in f32), softmax
    in f32, probs cast back to the storage type for the PV product, which
    accumulates in f32 (the reference's preferred_element_type).  `mask`
    (B, S, T) bool, or None for full attention (the reference's all-true
    mask).
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    # each kv head's g query heads as rows of one product: (b, kv, g*s, hd)
    qg = q.reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b, kv, g * s, hd).float()
    kt = k.permute(0, 2, 3, 1).float()                  # (b, kv, hd, t)
    vt = v.permute(0, 2, 1, 3).float()                  # (b, kv, t, hd)
    scores = (qg @ kt).reshape(b, kv, g, s, t) / (hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype).float().reshape(b, kv, g * s, t) @ vt
    return (out.reshape(b, kv, g, s, hd).permute(0, 3, 1, 2, 4)
            .reshape(b, s, h * hd).to(v.dtype))


def _sdpa_chunked(q, k, v, cfg: ArchConfig, chunk: int, offset: int = 0):
    """Query-chunked attention (flash-style memory behaviour).

    Live score tensor shrinks from O(S·T) to O(chunk·T) per head.  Each
    chunk's softmax row is complete, so no online max/sum bookkeeping is
    needed; numerics match `_sdpa` exactly.  The queries are positions
    `offset` to `offset + S` of the keys' sequence.
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    outs = []
    for ci in range(s // chunk):
        m = causal_mask(chunk, cfg.sliding_window, offset + ci * chunk,
                        q.device, cols=t)
        qc = q[:, ci * chunk:(ci + 1) * chunk]
        outs.append(_sdpa(qc, k, v, m.expand(b, chunk, t), cfg))
    return torch.cat(outs, dim=1)


def causal_mask(s: int, window: int = 0, offset: int = 0, device=None,
                cols: int | None = None) -> torch.Tensor:
    """(s, s+offset) causal (optionally sliding-window) mask: rows are
    positions offset to offset + s; `cols` columns (positions from 0)
    when given."""
    rows = torch.arange(s, device=device)[:, None] + offset
    cols = torch.arange(s + offset if cols is None else cols,
                        device=device)[None, :]
    m = cols <= rows
    if window > 0:
        m &= cols > rows - window
    return m


def _self_attention(q, k, v, cfg: ArchConfig,
                    rules: SH.ShardingRules = SH.ShardingRules(),
                    offset: int = 0):
    """Causal self-attention of q (B, S, H, hd), positions `offset` to
    `offset + S`, over k / v (B, T, KV, hd) from position 0."""
    if SH.is_dtensor(q):
        return _on_local_heads(
            lambda q, k, v, off: _self_attention(q, k, v, cfg, rules, off),
            q, k, v, rules)
    b, s = q.shape[:2]
    t = k.shape[1]
    if _flash_route(q, k, cfg):
        return _sdpa_flash(q, k, v)
    if cfg.attn_chunk and s % cfg.attn_chunk == 0 and s > cfg.attn_chunk:
        return _sdpa_chunked(q, k, v, cfg, cfg.attn_chunk, offset)
    mask = causal_mask(s, cfg.sliding_window, offset, q.device, cols=t)
    return _sdpa(q, k, v, mask[None].expand(b, s, t), cfg)


def attention_train(x, p, cfg: ArchConfig, positions=None, *,
                    rules: SH.ShardingRules = SH.ShardingRules()):
    """Full self-attention forward (train / prefill compute).  `rules`
    lay a mesh's attention out (`distributed.sharding`)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    w = _block_weights(x, p, ("wq", "wk", "wv", "wo"), cfg, rules)
    q, k, v = _qkv(x, w, cfg, positions, rules=rules)
    return linear(_self_attention(q, k, v, cfg, rules), w["wo"])


def attention_encoder(x, p, cfg: ArchConfig, *,
                      rules: SH.ShardingRules = SH.ShardingRules()):
    """Bidirectional attention (whisper encoder)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    w = _block_weights(x, p, ("wq", "wk", "wv", "wo"), cfg, rules)
    q, k, v = _qkv(x, w, cfg, positions, rules=rules)
    return linear(_full_attention(q, k, v, cfg, rules), w["wo"])


def _full_attention(q, k, v, cfg: ArchConfig,
                    rules: SH.ShardingRules = SH.ShardingRules()):
    """`_sdpa` with no mask (every position sees every other)."""
    if SH.is_dtensor(q):
        return _on_local_heads(
            lambda q, k, v, _: _sdpa(q, k, v, None, cfg), q, k, v, rules)
    return _sdpa(q, k, v, None, cfg)


def attention_cross(x, enc_out, p, cfg: ArchConfig, *,
                    rules: SH.ShardingRules = SH.ShardingRules()):
    """Cross-attention: queries from decoder x, keys/values from encoder."""
    b, s, _ = x.shape
    t = enc_out.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    w = {**_block_weights(x, p, ("xwq", "xwo"), cfg, rules),
         **_block_weights(enc_out, p, ("xwk", "xwv"), cfg, rules)}
    ek, ev = gather_rows(enc_out, w["xwk"], w["xwv"])
    q = _by_heads(linear(x, w["xwq"]), h, "heads", rules).reshape(
        b, s, h, hd)
    k = _by_heads(linear(ek, w["xwk"]), kv, "kv_heads",
                  rules).reshape(b, t, kv, hd)
    v = _by_heads(linear(ev, w["xwv"]), kv, "kv_heads",
                  rules).reshape(b, t, kv, hd)
    return linear(_full_attention(q, k, v, cfg, rules), w["xwo"])


def attention_prefill(x, p, cfg: ArchConfig, cache_len: int,
                      cache: KVCache | None = None, *,
                      rules: SH.ShardingRules = SH.ShardingRules()):
    """Prefill: same compute as train + returns the populated KV cache.

    `cache`, when given, is a (B, kv, cache_len, hd) pair that receives
    k and v in place (the caller's layer slice of the stacked cache);
    otherwise new zero caches of x's type are made.
    """
    b, s, _ = x.shape
    if s > cache_len:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of "
                         f"{cache_len}")
    positions = torch.arange(s, device=x.device)[None, :]
    w = _block_weights(x, p, ("wq", "wk", "wv", "wo"), cfg, rules)
    q, k, v = _qkv(x, w, cfg, positions, rules=rules)
    out = _self_attention(q, k, v, cfg, rules)
    if cache is None:
        kc = torch.zeros((b, cfg.n_kv_heads, cache_len, cfg.hd),
                         dtype=x.dtype, device=x.device)
        cache = KVCache(kc, torch.zeros_like(kc))
    if SH.is_dtensor(cache.k):
        _write_prompt_shards(cache, k, v)
    else:
        cache.k[:, :, :s] = k.transpose(1, 2)
        cache.v[:, :, :s] = v.transpose(1, 2)
    return linear(out, w["wo"]), cache


def _cache_layout(cache_k):
    """(mesh, batch entry, heads entry, positions entry) of a DTensor
    cache (B, kv, S_max, hd), from its placements."""
    return (cache_k.device_mesh, SH.entry_of(cache_k, 0),
            SH.entry_of(cache_k, 1), SH.entry_of(cache_k, 2))


def _offset(mesh, entry, size: int) -> int:
    """This device's first index of a dim of `size` sharded on `entry`
    (an axis name or a tuple of them, pod-major)."""
    if entry is None:
        return 0
    n = SH._axis_size(SH.mesh_sizes(mesh), entry)
    return SH.shard_index(mesh, entry) * (size // n)


def _write_prompt_shards(cache: KVCache, k, v) -> None:
    """Prefill's cache write on a mesh: each device writes the prompt's
    positions that fall in its shard of the cache.  k / v (B, S, kv, hd)
    DTensors."""
    mesh, pb, ph, ps = _cache_layout(cache.k)
    want = SH.placements(SH.P(pb, None, ph, None), mesh)
    t_loc = cache.k.to_local().shape[2]
    off = _offset(mesh, ps, cache.k.shape[2])
    n = max(0, min(k.shape[1] - off, t_loc))
    for c, new in ((cache.k, k), (cache.v, v)):
        part = new.redistribute(mesh, want).to_local()[:, off:off + n]
        c.to_local()[:, :, :n] = part.transpose(1, 2)


KV_INT8_SCALE = 0.05    # fixed-point step for int8 KV caches (perf option)


def _quant_kv(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() / KV_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def _dequant_kv(x: torch.Tensor, out_dtype) -> torch.Tensor:
    if x.dtype == torch.int8:
        return (x.float() * KV_INT8_SCALE).to(out_dtype)
    return x


def attention_decode(x, p, cfg: ArchConfig, cache: KVCache,
                     pos: torch.Tensor, *,
                     rules: SH.ShardingRules = SH.ShardingRules()):
    """One-token decode against a (B, kv, S_max, hd) cache.

    `pos` is the current length (0-d int tensor, uniform across batch).
    The new token's k / v are written into `cache` in place, at slot
    `pos % S_max` (a ring buffer when the cache is smaller than the
    context, for sliding-window archs: the mask then admits the full
    rotated window; softmax is order-invariant, so causal semantics hold);
    the returned KVCache holds the same tensors.  int8 caches
    (cfg.kv_cache_dtype) store round(x / KV_INT8_SCALE).
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    positions = pos.reshape(1, 1)
    q, k, v = _qkv(x, p, cfg, positions, rules=rules)
    if SH.is_dtensor(cache.k):
        return linear(_decode_on_shards(q, k, v, cache, pos, cfg),
                      p["wo"]), cache
    t = cache.k.shape[2]
    write_pos = (pos % t).reshape(1).long()             # ring buffer when t<ctx
    cache.k.index_copy_(2, write_pos,
                        _quant_kv(k.transpose(1, 2), cache.k.dtype))
    cache.v.index_copy_(2, write_pos,
                        _quant_kv(v.transpose(1, 2), cache.v.dtype))

    slots = torch.arange(t, device=x.device)[None, :]
    mask = _decode_valid(slots, pos, t, cfg)[:, None, :].expand(b, 1, t)
    kd = _dequant_kv(cache.k, x.dtype).transpose(1, 2)
    vd = _dequant_kv(cache.v, x.dtype).transpose(1, 2)
    out = _sdpa(q, kd, vd, mask, cfg)
    return linear(out, p["wo"]), cache


def _decode_valid(slots, pos, t: int, cfg: ArchConfig):
    """The decode mask over cache slots (global slot numbers) of a cache
    of `t` slots."""
    valid = slots <= pos                                # normal operation
    if cfg.sliding_window > 0:
        if cfg.sliding_window < t:
            valid &= slots > pos - cfg.sliding_window
        else:                                           # ring buffer full
            valid = valid | (pos >= t)
    return valid


def _decode_on_shards(q, k, v, cache: KVCache, pos, cfg: ArchConfig):
    """One decode step's attention on each device's cache shard (the
    cache written in place there): q (B, 1, H, hd), k / v (B, 1, kv, hd)
    DTensors -> (B, 1, H * hd).  Heads-sharded caches take the query
    heads of their kv heads, each device attending over its whole cache
    shard by the one-device `_sdpa` (op for op the one-device step's
    attention of those heads); a positions-sharded cache sees every query
    head, and the softmax is combined over its axis: the max, then the
    sum and the value product (flash decoding)."""
    import torch.distributed._functional_collectives as funcol


    mesh, pb, ph, ps = _cache_layout(cache.k)
    t = cache.k.shape[2]
    t_loc = cache.k.to_local().shape[2]
    off = _offset(mesh, ps, t)
    axis = None if ps is None else mesh.mesh_dim_names.index(ps)

    def local(q, k, v, ck, cv):
        b, _, h, hd = q.shape
        kvh = k.shape[2]
        slot = pos % t
        here = (slot >= off) & (slot < off + t_loc)
        idx = torch.clamp(slot - off, 0, t_loc - 1).reshape(1).long()
        for c, new in ((ck, k), (cv, v)):
            new = _quant_kv(new.transpose(1, 2), c.dtype)
            c.index_copy_(2, idx, torch.where(here, new,
                                              c.index_select(2, idx)))
        slots = off + torch.arange(t_loc, device=q.device)[None, :]
        valid = _decode_valid(slots, pos, t, cfg)          # (1, t_loc)
        if axis is None:
            return _sdpa(q, _dequant_kv(ck, q.dtype).transpose(1, 2),
                         _dequant_kv(cv, q.dtype).transpose(1, 2),
                         valid[:, None, :].expand(b, 1, t_loc), cfg)
        g = h // kvh
        qg = q.reshape(b, kvh, g, hd).float()
        kd = _dequant_kv(ck, q.dtype).float()               # (b, kv, t, hd)
        vd = _dequant_kv(cv, q.dtype)
        scores = (qg @ kd.transpose(-1, -2)) / (hd ** 0.5)  # (b, kv, g, t)
        scores = torch.where(valid[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
        m = scores.amax(dim=-1, keepdim=True)
        if axis is not None:
            m = funcol.all_reduce(m, "max", (mesh, axis))
        e = torch.exp(scores - m)
        den = e.sum(dim=-1, keepdim=True)
        num = e.to(vd.dtype).float() @ vd.float()           # (b, kv, g, hd)
        if axis is not None:
            den = funcol.all_reduce(den, "sum", (mesh, axis))
            num = funcol.all_reduce(num, "sum", (mesh, axis))
        return (num / den).reshape(b, 1, h * hd).to(v.dtype)

    # q's heads and the new k / v's kv heads on the cache's heads axis
    hp = SH.P(pb, None, ph, None)
    cp = SH.P(pb, ph, ps, None)
    return SH.on_shards(local, mesh, (q, k, v, cache.k, cache.v),
                        (hp, hp, hp, cp, cp), SH.P(pb, None, ph))
