"""Build the CUDA sources under ``repro_torch/csrc`` with ``nvcc`` into one
shared library per kernel (plain C interface) and load it with ``ctypes``.

Each library is built at first use, for ``sm_90a``, into a directory that
git ignores (``src/repro_torch/_build`` or ``$REPRO_TORCH_BUILD_DIR``).  The
file name carries a hash of the source, every header under ``csrc`` and
the flags, so an edited source or header is never served from a stale
library.  :func:`build_all` starts one ``nvcc`` per source at once and
waits for all of them.

Every wrapper also has an abstract rule, the counterpart of
``pallas_call``'s abstract evaluation: given a fake tensor
(``FakeTensorMode``) or a ``meta`` tensor (:func:`is_abstract`), it runs
its argument checks (:func:`expect`, the head_dim / group / bits limits,
:func:`expect_rows` but for the addresses, which a fake tensor does not
have) and returns empty outputs of the kernel's shapes, dtypes and device,
before any library is loaded, any SM count is read or any address taken;
it counts neither a launch nor a plain call.  The shared-memory check
(:func:`check_smem`) needs the built library, so the abstract rule skips
it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
#: kernel name -> its translation unit (each includes ``common.cuh``;
#: ``flash_attention.cu`` and ``sparse_prefill.cu`` also ``attn_tile.cuh``,
#: ``paged_attention.cu`` and ``fused_decode.cu`` ``split_attn.cuh``,
#: ``centroid_score.cu`` and ``fused_decode.cu`` ``score_rows.cuh``).
SOURCES = {
    "fused_decode": "fused_decode.cu",
    "sparse_prefill": "sparse_prefill.cu",
    "centroid_score": "centroid_score.cu",
    "paged_attention": "paged_attention.cu",
    "pool_rank_keys": "pool_rank_keys.cu",
    "topk_threshold": "topk_threshold.cu",
    "flash_attention": "flash_attention.cu",
}
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
#: per kernel, the compiler's register / shared-memory report (``-Xptxas -v``).
PTXAS_REPORT: Dict[str, str] = {}


def build_dir() -> Path:
    d = Path(os.environ.get("REPRO_TORCH_BUILD_DIR", PKG / "_build"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, every header under
    ``CSRC`` (a source may include any of them) and the flags."""
    h = hashlib.sha256()
    for f in (CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library, all ``nvcc`` processes in parallel."""
    names = list(SOURCES if names is None else names)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        ), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        PTXAS_REPORT[n] = err
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]}:\n{err}")
            continue
        tmp.replace(paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


#: dynamic shared memory one thread block may use on Hopper (227 KB).
MAX_SMEM = 232448


def check_smem(nbytes: int, what: str):
    """Raise before a launch that would ask for more shared memory than a
    Hopper thread block can have."""
    if nbytes > MAX_SMEM:
        raise ValueError(
            f"{what}: needs {nbytes} bytes of shared memory per block, more "
            f"than the {MAX_SMEM} a Hopper block can use (context too long "
            "for the smallest block size)"
        )


def check(rc: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def expect_rows(Dp: int, what: str, **tensors):
    """Wrapper-side check for ``common.cuh::score_row``: a rank-key width
    that is a multiple of 32 and store rows, scale and zero on 16-byte
    boundaries (it reads them as 16-byte vectors)."""
    if Dp % 32:
        raise ValueError(f"{what}: rank-key width {Dp} is not a multiple of 32")
    for name, t in tensors.items():
        if t is not None and not is_abstract(t) and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def expect(t, dtype, shape, device, name: str):
    """Wrapper-side argument check: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def is_abstract(*tensors) -> bool:
    """True when any of ``tensors`` (None skipped) is a fake tensor or lies
    on ``meta``: the wrapper then takes its abstract rule."""
    from torch._subclasses.fake_tensor import is_fake

    return any(t is not None and (t.device.type == "meta" or is_fake(t))
               for t in tensors)
