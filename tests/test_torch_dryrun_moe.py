"""granite-moe-1b-a400m's dry-run cells on (16, 16) against the
reference's (`repro.launch.dryrun`), each package's cell in a subprocess
of its own (tests/torch_dryrun_cells.py, the four started at once):

* decode_32k: FLOPs and collective bytes a device each at most 1.5x the
  reference's (a decode dispatch group spans every batch shard: each
  device routes every row, and the expert work is split over the expert
  stacks' "embed" axis, not repeated on each data rank), and the
  all-to-alls counted as all-to-alls wherever the reference counts one;
* train_4k: temp bytes within 0.5-2x of the reference's, every
  collective kind the reference counts counted, all-to-alls among them,
  and no all-gather whose output is as large as one device's rows of
  full-vocabulary logits (granite's 49155 vocab does not divide the
  16-way "model" axis: the loss runs vocab-parallel on an uneven split
  instead of gathering each row's logits).
"""
import pytest

from torch_dryrun_cells import cells

pytest.importorskip("jax")

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    return cells({f"{pkg}-{shape}": (pkg, ARCH, shape, False)
                  for pkg in ("repro_torch", "repro")
                  for shape in ("decode_32k", "train_4k")},
                 tmp_path_factory.mktemp("moe"))


def test_decode_cell_does_the_references_expert_work(rows):
    port = rows["repro_torch-decode_32k"]["roofline"]
    ref = rows["repro-decode_32k"]["roofline"]
    assert port["hlo_flops"] <= 1.5 * ref["hlo_flops"], (port, ref)
    assert port["coll_bytes"] <= 1.5 * ref["coll_bytes"], (port, ref)
    if ref["collective_ops"]["all-to-all"]:
        assert port["collective_ops"]["all-to-all"] > 0, port


def test_train_cell_temp_and_collectives_are_the_references(rows):
    from repro_torch.configs import registry as TR

    port, ref = rows["repro_torch-train_4k"], rows["repro-train_4k"]
    ratio = port["memory"]["temp_bytes"] / ref["memory"]["temp_bytes"]
    assert 0.5 <= ratio <= 2.0, (port["memory"], ref["memory"])
    ops = port["roofline"]["collective_ops"]
    assert ops["all-to-all"] > 0, ops
    for kind, n in ref["roofline"]["collective_ops"].items():
        if n:
            assert ops[kind] > 0, (kind, ops)
    cfg, shape = TR.get_arch(ARCH), TR.get_shape("train_4k")
    rows_logits = shape.global_batch // 16 * shape.seq_len * cfg.vocab * 2
    largest = port["collective_largest"]["all-gather"]
    assert 0 < largest < rows_logits, (largest, rows_logits)
