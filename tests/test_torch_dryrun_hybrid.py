"""zamba2-2.7b's train_4k dry-run cell on (2, 16, 16) against the
reference's (`repro.launch.dryrun`) and against the port's own cell on
(16, 16), each cell in a subprocess of its own
(tests/torch_dryrun_cells.py, the three started at once): FLOPs and
temp bytes a device within 0.5-2x of the reference's, and FLOPs a
device below the (16, 16) cell's, which holds twice the rows a device.
Each product's gradient takes the product's own layout
(`models/common.py` `_FoldReadyGrad`): DTensor had left mamba2's
in_proj gradient whole on "model" after the split of its output, and
computed that weight's gradient whole on each device there.
"""
import pytest

from torch_dryrun_cells import cells

pytest.importorskip("jax")

ARCH, SHAPE = "zamba2-2.7b", "train_4k"


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    return cells({"port": ("repro_torch", ARCH, SHAPE, True),
                  "ref": ("repro", ARCH, SHAPE, True),
                  "port-16x16": ("repro_torch", ARCH, SHAPE, False)},
                 tmp_path_factory.mktemp("hybrid"))


@pytest.mark.parametrize("term,section,key", [
    ("flops", "roofline", "hlo_flops"), ("temp", "memory", "temp_bytes")])
def test_multi_pod_train_cell_is_the_references(rows, term, section, key):
    port, ref = rows["port"], rows["ref"]
    assert port["mesh"] == ref["mesh"] == "2x16x16"
    ratio = port[section][key] / ref[section][key]
    assert 0.5 <= ratio <= 2.0, (term, port[section], ref[section])


def test_multi_pod_flops_are_below_the_single_pod_cells(rows):
    assert rows["port-16x16"]["mesh"] == "16x16"
    assert rows["port"]["roofline"]["hlo_flops"] < \
        rows["port-16x16"]["roofline"]["hlo_flops"]
