"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object file, all
sources at once (one ``nvcc`` process each); the objects link into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/<hash>/`` at the repository root, keyed by
a hash of the sources and flags, so a checkout builds at first use and
reuses the build afterwards. Nothing here runs at import: the CPU tests
import every module, and this machine-independent module only touches
``nvcc`` when a kernel is first launched on a CUDA tensor (or
:func:`ensure_built` is called).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = ("flash_attention.cu", "decode_attention.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libllmc_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the build this process ran
build_log = ""  # nvcc/ptxas output of that build (registers, spills)


class KernelBuildError(RuntimeError):
    """nvcc failed, or the built library could not be loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def _key() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> None:
    """Compile every source in parallel, link, and move the library into
    ``out_dir`` atomically (a concurrent build in another process sees all or
    nothing)."""
    global build_seconds, build_log
    nvcc = _nvcc()
    t0 = time.monotonic()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=out_dir.parent))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs, failed = [], []
        for name, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise KernelBuildError(
                f"nvcc failed for {failed}:\n" + "\n".join(logs)
            )
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(logs))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).exists():
                raise
        build_log = "\n".join(logs)
        build_seconds = time.monotonic() - t0
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.llmc_flash_attention_bf16.argtypes = [
        p, p, p, p,            # q, k, v, o
        i, i, i, i, i, i, i,   # B, T, S, s_eff, Hq, Hkv, dh
        i, i, f, f,            # q_offset, window, softcap, scale
        p,                     # stream
    ]
    lib.llmc_flash_attention_bf16.restype = i
    lib.llmc_decode_attention_bf16.argtypes = [
        p, p, p,               # q, k, v
        p, p, p,               # pos, layer, row_start (device int32)
        p, p, p, p, p,         # part_m, part_l, part_acc, tickets (NULL at one split), out
        p, p,                  # m_out, l_out (NULL unless return_state)
        i, i, i, i, i,         # B, S, Hq, Hkv, dh
        i, i, i, f, f,         # kv_width, n_split, window, softcap, scale
        p,                     # stream
    ]
    lib.llmc_decode_attention_bf16.restype = i
    for fn in (lib.llmc_decode_attention_int8, lib.llmc_decode_attention_int8_w8a8):
        fn.argtypes = [
            p, p, p, p, p,         # q, k codes, v codes, k scales, v scales
            p, p, p,               # pos, layer, row_start (device int32)
            p, p, p, p, p,         # part_m, part_l, part_acc, tickets (NULL at one split), out
            p, p,                  # m_out, l_out (NULL unless return_state)
            i, i, i, i, i,         # B, S, Hq, Hkv, dh
            i, i, i, f, f,         # kv_width, n_split, window, softcap, scale
            p,                     # stream
        ]
        fn.restype = i
    lib.llmc_cuda_error_string.argtypes = [i]
    lib.llmc_cuda_error_string.restype = ctypes.c_char_p


def ensure_built() -> ctypes.CDLL:
    """The loaded kernel library, building it first if this checkout has
    no build for the current sources. Thread-safe; raises
    :class:`KernelBuildError` when nvcc or the load fails. The build or load
    is the one compile on the port's path: the installed attribution ledger
    books it (obs/attrib.py, the build sentinel)."""
    if _lib is not None:
        return _lib
    t0 = time.monotonic()
    lib, loaded = _load()
    if loaded:
        from llm_consensus_tpu_torch.obs import attrib

        led = attrib.ledger()
        if led is not None:
            led.note_build(time.monotonic() - t0)
    return lib


def _load() -> tuple[ctypes.CDLL, bool]:
    """``(library, whether this call built or loaded it)``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib, False
        out_dir = BUILD_ROOT / _key()
        if not (out_dir / LIB_NAME).exists():
            _build(out_dir)
        try:
            lib = ctypes.CDLL(str(out_dir / LIB_NAME))
        except OSError as err:
            raise KernelBuildError(f"loading {out_dir / LIB_NAME}: {err}") from err
        _bind(lib)
        _lib = lib
        return lib, True


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise :class:`KernelLaunchError` for a non-zero cudaError_t."""
    if err != 0:
        msg = lib.llmc_cuda_error_string(err).decode(errors="replace")
        raise KernelLaunchError(f"{name} launch failed: CUDA error {err} ({msg})")


class LaunchCounter:
    """Kernel launches of one wrapper: ``count`` is a plain integer that
    the wrapper raises by one per kernel launch (never on the CPU path).
    The lock keeps concurrent panel threads from losing increments."""

    def __init__(self) -> None:
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
