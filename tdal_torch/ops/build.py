"""Build the port's CUDA kernels at first use, from the sources in the repository.

``kernels()`` compiles ``csrc/*.cu`` for ``sm_90a`` with ``nvcc`` into a shared library
with a plain C interface, ``build/tdal_torch_kernels/libtdal_torch_kernels.so``
(listed in ``.gitignore``), the first time a process launches a kernel, and loads it
with ``ctypes``. The sources include no PyTorch header, so the build takes seconds.
The returned object has ``encoder_tile()``, ``seg_encoder(...)`` and
``seg_decoder(...)`` taking tensors; each launches on PyTorch's current stream and
checks the launch with ``tdal_last_error()`` right after it. Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tdal_torch_kernels"
GENCODE = "-gencode=arch=compute_90a,code=sm_90a"


@functools.cache
def kernels():
    """The built kernels (built once per process)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("tdal_torch: no CUDA toolkit found to build the kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "libtdal_torch_kernels.so"
    # build under a temporary name, then rename: concurrent processes never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        str(Path(CUDA_HOME) / "bin" / "nvcc"), GENCODE, "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *sorted(map(str, CSRC.glob("*.cu"))),
    ]
    subprocess.run(cmd, check=True)
    os.replace(tmp, out)
    return _Kernels(out)


class _Kernels:
    """Tensor-level launchers over the plain C library of ``csrc/fused_pointnet.cu``.
    ``tdal_torch/ops/fused_pointnet.py`` has checked every tensor and allocated every
    output and scratch buffer before it calls in here."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.tdal_last_error.argtypes, lib.tdal_last_error.restype = [], I
        lib.tdal_encoder_tile.argtypes, lib.tdal_encoder_tile.restype = [], I
        lib.tdal_seg_encoder.argtypes = [P, I, I, I, P, P, P, P, I, I, P]
        lib.tdal_seg_encoder_reduce.argtypes = [P, I, I, P, P]
        lib.tdal_seg_decoder_gproj.argtypes = [P, I, P, P, P, I, P]
        lib.tdal_seg_decoder.argtypes = [P, P, I, I, P, P, P, P, P, I, P]
        for name in ("tdal_seg_encoder", "tdal_seg_encoder_reduce",
                     "tdal_seg_decoder_gproj", "tdal_seg_decoder"):
            getattr(lib, name).restype = None
        self._lib = lib

    def _check(self, what: str):
        err = self._lib.tdal_last_error()
        if err != 0:
            raise RuntimeError(f"tdal_torch: {what} launch failed (cudaError {err})")

    @staticmethod
    def _stream(t):
        import torch

        return torch.cuda.current_stream(t.device).cuda_stream

    @staticmethod
    def _ptr_array(ts):
        return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

    def encoder_tile(self) -> int:
        return self._lib.tdal_encoder_tile()

    def seg_encoder(self, pts, w, b, skip, partial, gmax, bf16: bool):
        B, N, cin = pts.shape
        n_tiles = partial.shape[1]
        s = self._stream(pts)
        self._lib.tdal_seg_encoder(
            pts.data_ptr(), B, N, cin, self._ptr_array(w), self._ptr_array(b),
            skip.data_ptr(), partial.data_ptr(), n_tiles, int(bf16), s,
        )
        self._check("seg_encoder")
        self._lib.tdal_seg_encoder_reduce(partial.data_ptr(), B, n_tiles, gmax.data_ptr(), s)
        self._check("seg_encoder_reduce")

    def seg_decoder(self, skip, gmax, w, b, lw, lb, gproj, out, bf16: bool):
        B, N, _ = skip.shape
        s = self._stream(skip)
        self._lib.tdal_seg_decoder_gproj(
            gmax.data_ptr(), B, w[0].data_ptr(), b[0].data_ptr(), gproj.data_ptr(),
            int(bf16), s,
        )
        self._check("seg_decoder_gproj")
        self._lib.tdal_seg_decoder(
            skip.data_ptr(), gproj.data_ptr(), B, N, self._ptr_array(w),
            self._ptr_array(b), lw.data_ptr(), lb.data_ptr(), out.data_ptr(),
            int(bf16), s,
        )
        self._check("seg_decoder")
