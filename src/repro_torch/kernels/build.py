"""Build and load the port's CUDA kernels: `nvcc` into a shared library
with a plain C interface, loaded with `ctypes`.

Every `.cu` file under `csrc/` is compiled at first use for `sm_90a`
into `_build/` beside this module (listed in `.gitignore`), under a name
that carries a hash of the source, so an edited source is never served a
stale library.  `build_all()` starts one `nvcc` per source at once and
waits for all of them; `library(name)` loads one, building it if needed.
Nothing here runs at import time: the CPU tests import the port without
`nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for `name` unless its library exists; None if built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)                  # atomic: readers see all or none
    out.with_suffix(".log").write_text(log)
    return log


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Compile every source in parallel; returns {name: nvcc output}."""
    started = {name: _start(name) for name in sources()}
    logs = {}
    try:
        for name, job in started.items():
            if job is None:
                log = _target(name).with_suffix(".log")
                logs[name] = log.read_text() if log.exists() else ""
            else:
                logs[name] = _finish(name, *job)
    finally:
        for job in started.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<name>.cu`, built if needed."""
    if name not in _loaded:
        job = _start(name)
        if job is not None:
            _finish(name, *job)
        lib = ctypes.CDLL(str(_target(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def check_operands(name: str, *specs) -> "torch.device":
    """Validate what a kernel takes.  Each spec is (tensor, dtype or tuple
    of dtypes, what); every tensor must have an allowed dtype, lie on the
    first one's device and be contiguous.  Returns that device, which
    decides the path: "cpu" runs the plain version, "cuda" the kernel, and
    any other device raises."""
    dev = specs[0][0].device
    for t, dtypes, what in specs:
        dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {what} must be "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def launch(name: str, fn: str, argtypes: list, *args) -> None:
    """Call the C launch function `fn` of `csrc/<name>.cu` (which returns a
    `cudaError_t`), binding its argument types on first use; raises with
    CUDA's message when the launch failed.  Every pointer and the stream
    are `c_void_p`, or ctypes would pass them as 32-bit ints."""
    lib = library(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    err = f(*args)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{fn}: launch failed: {msg}")
