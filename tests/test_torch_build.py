"""The port's kernel build (`repro_torch.kernels.build`) on the CPU: the
library name carries a hash of the source, of every shared header and of
the flags, so an edit to any of them is never served a stale library.
Nothing here runs `nvcc`."""
from repro_torch.kernels import build


def _tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\nint k;\n')
    (csrc / "h.cuh").write_text("// helpers, v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_editing_a_header_changes_the_target(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    before = build._target("k")
    assert build._target("k") == before              # stable
    (csrc / "h.cuh").write_text("// helpers, v2\n")
    after = build._target("k")
    assert after != before
    assert after.parent == tmp_path / "_build" and after.suffix == ".so"


def test_adding_a_header_or_editing_the_source_changes_the_target(
        tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    first = build._target("k")
    (csrc / "more.cuh").write_text("// more helpers\n")
    second = build._target("k")
    (csrc / "k.cu").write_text('#include "h.cuh"\nint k2;\n')
    third = build._target("k")
    assert len({first, second, third}) == 3


def test_headers_are_not_compiled_on_their_own(tmp_path, monkeypatch):
    _tree(tmp_path, monkeypatch)
    assert build.sources() == ["k"]


def test_the_hopper_kernels_share_the_hashed_header():
    for name in ("flash_attention", "codebook_matmul"):
        assert '#include "hopper.cuh"' in (build.CSRC / f"{name}.cu"
                                           ).read_text()
    assert (build.CSRC / "hopper.cuh").exists()
