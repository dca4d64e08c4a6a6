"""The dry-run cells whose terms lay above 2x the reference's rows after
the sequence split: mamba2-130m decode, zamba2-2.7b's in_proj at prefill
and its embedding lookup at every decode step, each package's cell in a
subprocess of its own (tests/torch_dryrun_cells.py, all started at
once).

* mamba2-130m decode_32k: its 24 SSD heads do not divide the 16-way
  "model" axis, and every device of that axis ran in_proj, out_proj and
  the logits whole for its rows.  Each now runs its slice of every
  product (`common.divided_axis`): the port's FLOPs a device are the
  analytic count of that layout within FLOP_REL on both meshes, and on
  16 x 16 within BAND of the reference's.  (On 2 x 16 x 16 the
  reference gathers the whole unembedding and computes every device's
  rows against the whole vocabulary, 87 % of its FLOPs: ROADMAP Queue
  3.)
* mamba2-130m long_500k: a batch of one row keeps each product on each
  device's slice of K; the port's FLOPs are the analytic count of its
  products within FLOP_REL (the reference counts 2.15e4, its M = 1
  products rewritten into loop fusions that it counts as no FLOPs).
* zamba2-2.7b long_500k: the lookup moves the looked-up rows, not the
  table's d-shard; collective bytes within BAND on both meshes.
* zamba2-2.7b prefill_32k on 16 x 16, both packages cut to one
  shared-attention group (6 layers): in_proj runs one product per piece
  on the heads' columns (`mamba2._in_proj_pieces`), so no all-gather is
  as large as a device's rows of one layer's in_proj output, and the
  collective bytes are within BAND of the reference's at that depth.
"""
import math

import pytest

from torch_dryrun_cells import cells

pytest.importorskip("jax")

BAND = (0.5, 2.0)
FLOP_REL = 0.05
MESHES = {"16x16": False, "2x16x16": True}
PREFILL_LAYERS = 6


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    jobs = {f"repro_torch-mamba2-decode-{mesh}": (
        "repro_torch", "mamba2-130m", "decode_32k", mp)
        for mesh, mp in MESHES.items()}
    jobs["repro-mamba2-decode-16x16"] = (
        "repro", "mamba2-130m", "decode_32k", False)
    jobs["repro_torch-mamba2-long-16x16"] = (
        "repro_torch", "mamba2-130m", "long_500k", False)
    for pkg in ("repro_torch", "repro"):
        for mesh, mp in MESHES.items():
            jobs[f"{pkg}-zamba2-long-{mesh}"] = (
                pkg, "zamba2-2.7b", "long_500k", mp)
        jobs[f"{pkg}-zamba2-prefill-16x16"] = (
            pkg, "zamba2-2.7b", "prefill_32k", False, PREFILL_LAYERS)
    return cells(jobs, tmp_path_factory.mktemp("decode"))


def _cfg(arch):
    from repro_torch.configs import registry as TR

    return TR.get_arch(arch)


def _ratio(rows, name, mesh, section, key):
    port = rows[f"repro_torch-{name}-{mesh}"]
    ref = rows[f"repro-{name}-{mesh}"]
    assert port["mesh"] == ref["mesh"] == mesh
    return port[section][key] / ref[section][key]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mamba2_decode_divides_every_product_over_model(rows, mesh):
    """FLOPs a device: in_proj on each device's rows (128 over the batch
    axes) and its 1/16 of the z, x, B and C columns (dt's 24 whole),
    out_proj its 1/16 of K, the SSM step its 1/16 of the state's N, the
    logits its ceil(V / 16) of the vocabulary."""
    cfg = _cfg("mamba2-130m")
    d, n_l, v = cfg.d_model, cfg.n_layers, cfg.vocab
    d_in, n = 2 * d, cfg.ssm_state
    h, p, m = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, 16
    r = 128 // (32 if MESHES[mesh] else 16)
    layer = (2 * r * d * ((2 * d_in + 2 * n) // m + h)
             + 2 * r * d_in // m * d + 2 * r * h * (n // m) * p)
    want = n_l * layer + 2 * r * d * math.ceil(v / m)
    port = rows[f"repro_torch-mamba2-decode-{mesh}"]["roofline"]["hlo_flops"]
    assert abs(port - want) <= FLOP_REL * want, (port, want)
    if not MESHES[mesh]:
        ratio = _ratio(rows, "mamba2-decode", mesh, "roofline", "hlo_flops")
        assert BAND[0] <= ratio <= BAND[1], ratio


def test_mamba2_long_decode_flops_are_its_products(rows):
    """One row: every product on each device's 1/16 of K (the weights'
    "embed" split), the SSM step on its 1/16 of N."""
    cfg = _cfg("mamba2-130m")
    d, n_l, v = cfg.d_model, cfg.n_layers, cfg.vocab
    d_in, n = 2 * d, cfg.ssm_state
    h, p = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim
    cols = 2 * d_in + 2 * n + h
    want = (n_l * (2 * d // 16 * cols + 2 * d_in * d // 16
                   + 2 * h * n // 16 * p) + 2 * d // 16 * v)
    got = rows["repro_torch-mamba2-long-16x16"]["roofline"]["hlo_flops"]
    assert abs(got - want) <= FLOP_REL * want, (got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zamba2_long_decode_moves_only_the_looked_up_rows(rows, mesh):
    ratio = _ratio(rows, "zamba2-long", mesh, "roofline", "coll_bytes")
    assert BAND[0] <= ratio <= BAND[1], ratio


def test_zamba2_prefill_gathers_no_in_proj_output(rows):
    cfg = _cfg("zamba2-2.7b")
    d_in, n = 2 * cfg.d_model, cfg.ssm_state
    cols = 2 * d_in + 2 * n + d_in // cfg.ssm_head_dim
    output = 32 // 16 * 32768 * cols * 2            # bf16, one layer
    port = rows["repro_torch-zamba2-prefill-16x16"]
    assert 0 < port["collective_largest"]["all-gather"] < output
    ratio = _ratio(rows, "zamba2-prefill", "16x16", "roofline",
                   "coll_bytes")
    assert BAND[0] <= ratio <= BAND[1], ratio
