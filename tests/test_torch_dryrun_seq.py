"""mamba2-130m's and whisper-tiny's dry-run cells on (16, 16) against the
reference's (`repro.launch.dryrun`), each package's cell in a subprocess
of its own (tests/torch_dryrun_cells.py, the eight started at once).

Neither arch's heads divide the 16-way "model" axis (mamba2-130m's 24
SSD heads, whisper-tiny's 6 attention heads), so the sequence stays
split on "model" through their blocks, as in the reference's layout:
each device runs its own chunks of the SSD scan and its own query rows
of attention.  Before, every device of "model" ran every head over the
whole sequence (3.7x the reference's FLOPs at mamba2-130m prefill_32k,
14.4x at whisper-tiny's).  Held: in prefill_32k and train_4k, the
port's FLOPs, collective bytes and temp bytes a device each within
0.5-2x of the reference's (BAND).
"""
import pytest

from torch_dryrun_cells import cells

pytest.importorskip("jax")

ARCHS = ("mamba2-130m", "whisper-tiny")
SHAPES = ("prefill_32k", "train_4k")
BAND = (0.5, 2.0)


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    return cells({f"{pkg}-{arch}-{shape}": (pkg, arch, shape, False)
                  for pkg in ("repro_torch", "repro")
                  for arch in ARCHS for shape in SHAPES},
                 tmp_path_factory.mktemp("seq"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_is_within_the_band_of_the_reference(rows, arch, shape):
    port = rows[f"repro_torch-{arch}-{shape}"]
    ref = rows[f"repro-{arch}-{shape}"]
    terms = {"flops": (port["roofline"]["hlo_flops"],
                       ref["roofline"]["hlo_flops"]),
             "coll": (port["roofline"]["coll_bytes"],
                      ref["roofline"]["coll_bytes"]),
             "temp": (port["memory"]["temp_bytes"],
                      ref["memory"]["temp_bytes"])}
    ratios = {k: p / r for k, (p, r) in terms.items()}
    assert all(BAND[0] <= x <= BAND[1] for x in ratios.values()), ratios
