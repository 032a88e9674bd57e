"""Build the port's CUDA kernels at first use, from the sources in the repository.

``kernels()`` compiles every ``csrc/*.cu`` for ``sm_90a``, one ``nvcc`` process per
source, all started together, and links the objects into a shared library with a
plain C interface, ``build/tdal_torch_kernels/libtdal_torch_kernels-<digest>.so``
(listed in ``.gitignore``; the digest is that of the sources and the flags), the first
time a process launches a kernel; it loads it with ``ctypes``. A process that finds the
library of its digest already built (a rank spawned after its parent built it) loads
it with the build's log, which is kept beside it. The sources include no PyTorch
header, so the build takes seconds. The
returned object has one launcher per kernel taking tensors (``seg_encoder``,
``seg_decoder_gproj``, ``seg_decoder``, ``conv3x3_fwd_stats``, ``conv3x3_fwd``,
``conv3x3_wgrad``, ``conv3x3_dgrad_act``, each of the last four also in the row halo
form with ``halo=(top, bottom)``, and ``sparse_conv``) and a few geometry queries (tiles,
weight-stream bytes, wgrad chunks, shared memory, the sparse conv's tile rows); each
launcher runs on PyTorch's current stream and checks the launch with
``tdal_last_error()`` right after it.
``build_log`` keeps ``nvcc``'s ``-Xptxas -v`` report (registers, static shared memory,
spills per kernel). Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tdal_torch_kernels"
GENCODE = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [GENCODE, "-std=c++17", "-O3", "-Xptxas=-v", "-Xcompiler", "-fPIC"]


def _digest() -> str:
    """Of the sources (``*.cu`` and the headers they include) and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def kernels():
    """The built kernels (built once per process)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("tdal_torch: no CUDA toolkit found to build the kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    out = BUILD_DIR / f"libtdal_torch_kernels-{digest}.so"
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        return _Kernels(out, log.read_text())
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    # build under temporary names, then rename: concurrent processes never load a
    # half-written library
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        sources = sorted(CSRC.glob("*.cu"))
        procs = [
            subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(src), "-o", str(work / f"{src.stem}.o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src in sources
        ]
        logs = [p.communicate()[0] for p in procs]
        for src, p, text in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"tdal_torch: nvcc failed on {src.name}:\n{text}")
        lib = work / "lib.so"
        subprocess.run([nvcc, GENCODE, "-shared", "-o", str(lib),
                        *(str(work / f"{s.stem}.o") for s in sources)], check=True)
        (work / "log").write_text("".join(logs))
        os.replace(lib, out)
        os.replace(work / "log", log)  # last: a library with its log is complete
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return _Kernels(out, "".join(logs))


class _Kernels:
    """Tensor-level launchers over the plain C library of ``csrc/*.cu``.
    ``tdal_torch/ops/fused_pointnet.py`` and ``tdal_torch/ops/conv3x3.py`` have checked
    every tensor and allocated every output and scratch buffer before they call in
    here."""

    def __init__(self, path: Path, build_log: str = ""):
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        for name, args, res in (
            ("tdal_last_error", [], I),
            ("tdal_encoder_tile", [], I),
            ("tdal_seg_stream_bytes", [I, I], I),
            ("tdal_seg_smem", [I], I),
            ("tdal_seg_encoder", [P, I, I, I, P, P, P, P, P, I, I, P], None),
            ("tdal_seg_encoder_reduce", [P, I, I, P, P], None),
            ("tdal_seg_decoder_gproj", [P, I, P, P, P, I, P], None),
            ("tdal_seg_decoder", [P, P, I, I, P, P, P, P, P, I, P], None),
            ("tdal_conv3x3_tiles", [I, I], I),
            ("tdal_conv3x3_wgrad_chunks", [I, I], I),
            ("tdal_conv3x3_smem", [I, I], I),
            ("tdal_conv3x3_fwd_stats", [P, P, I, I, I, I, I, P, P, I, P, P, P, P, I, P],
             None),
            ("tdal_conv3x3_fwd", [P, P, I, I, I, I, I, P, P, I, P, I, P], None),
            ("tdal_conv3x3_wgrad", [P, P, I, I, I, I, I, P, P, I, I, P, P, I, P], None),
            ("tdal_conv3x3_dgrad_act", [P, P, P, I, I, I, I, I, P, P, P, P, P, I, P],
             None),
            ("tdal_conv3x3_fwd_stats_halo",
             [P, P, I, I, I, I, I, P, P, I, P, P, P, P, I, I, I, P], None),
            ("tdal_conv3x3_fwd_halo", [P, P, I, I, I, I, I, P, P, I, P, I, I, I, P], None),
            ("tdal_conv3x3_wgrad_halo",
             [P, P, I, I, I, I, I, P, P, I, I, P, P, I, I, I, P], None),
            ("tdal_conv3x3_dgrad_act_halo",
             [P, P, P, I, I, I, I, I, P, P, P, P, P, I, I, I, P], None),
            ("tdal_sparse_conv_tile_rows", [I], I),
            ("tdal_sparse_conv", [P, I, I, P, I, I, P, I, P, I, P, I, P], I),
        ):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        self._lib, self.path = lib, path
        self.build_log = build_log

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

    @staticmethod
    def _bf16(t) -> int:
        import torch

        return int(t.dtype == torch.bfloat16)

    def encoder_tile(self) -> int:
        return self._lib.tdal_encoder_tile()

    def seg_stream_bytes(self, decoder: bool, bf16: bool) -> int:
        """Bytes of the packed weight stream K1 (or K2) reads in that operand mode."""
        return self._lib.tdal_seg_stream_bytes(int(decoder), int(bf16))

    def seg_smem(self, which: int) -> int:
        """Dynamic shared memory of one block of K1's main kernel (0), K2's (1) or K2's
        gproj (2), bytes."""
        return self._lib.tdal_seg_smem(which)

    def seg_encoder(self, pts, w0, b, wstream, skip, partial, gmax, bf16: bool):
        B, N, cin = pts.shape
        n_tiles = partial.shape[1]
        s = self._stream(pts)
        self._lib.tdal_seg_encoder(
            pts.data_ptr(), B, N, cin, w0.data_ptr(), self._ptr_array(b), wstream.data_ptr(),
            skip.data_ptr(), partial.data_ptr(), n_tiles, int(bf16), s,
        )
        self._check("seg_encoder")
        self._lib.tdal_seg_encoder_reduce(partial.data_ptr(), B, n_tiles, gmax.data_ptr(), s)
        self._check("seg_encoder_reduce")

    def seg_decoder_gproj(self, gmax, wstream, b0, gproj, bf16: bool):
        self._lib.tdal_seg_decoder_gproj(
            gmax.data_ptr(), gmax.shape[0], wstream.data_ptr(), b0.data_ptr(),
            gproj.data_ptr(), int(bf16), self._stream(gmax),
        )
        self._check("seg_decoder_gproj")

    def seg_decoder(self, skip, gmax, b, wstream, lw, lb, gproj, out, bf16: bool):
        B, N, _ = skip.shape
        self.seg_decoder_gproj(gmax, wstream, b[0], gproj, bf16)
        self._lib.tdal_seg_decoder(
            skip.data_ptr(), gproj.data_ptr(), B, N, wstream.data_ptr(), self._ptr_array(b),
            lw.data_ptr(), lb.data_ptr(), out.data_ptr(), int(bf16), self._stream(skip),
        )
        self._check("seg_decoder")

    def conv3x3_tiles(self, H: int, W: int) -> int:
        return self._lib.tdal_conv3x3_tiles(H, W)

    def conv3x3_wgrad_chunks(self, C: int, Co: int) -> int:
        return self._lib.tdal_conv3x3_wgrad_chunks(C, Co)

    def conv3x3_smem(self, wgrad: bool, bf16: bool) -> int:
        """Dynamic shared memory of one block of the conv or the wgrad kernel, bytes."""
        return self._lib.tdal_conv3x3_smem(int(wgrad), int(bf16))

    # The conv launchers: ``halo=(top, bottom)`` other than (0, 0) calls the row halo
    # form (``csrc/conv3x3_halo.cu``) on a conv input of top + H + bottom rows, H the
    # output's; (0, 0) the whole-image entry point.

    def conv3x3_fwd_stats(self, x, w, in_scale, in_shift, in_act: bool, bias, y, partial,
                          stats, halo=(0, 0)):
        B, H, W, C = y.shape[0], y.shape[1], y.shape[2], x.shape[-1]
        args = (x.data_ptr(), w.data_ptr(), B, H, W, C, w.shape[-1], in_scale.data_ptr(),
                in_shift.data_ptr(), int(in_act), bias.data_ptr(), y.data_ptr(),
                partial.data_ptr(), stats.data_ptr())
        if tuple(halo) == (0, 0):
            self._lib.tdal_conv3x3_fwd_stats(*args, self._bf16(x), self._stream(x))
        else:
            self._lib.tdal_conv3x3_fwd_stats_halo(*args, *halo, self._bf16(x),
                                                  self._stream(x))
        self._check("conv3x3_fwd_stats")

    def conv3x3_fwd(self, x, w, scale, shift, relu: bool, y, halo=(0, 0)):
        B, H, W, C = y.shape[0], y.shape[1], y.shape[2], x.shape[-1]
        args = (x.data_ptr(), w.data_ptr(), B, H, W, C, w.shape[-1],
                None if scale is None else scale.data_ptr(), shift.data_ptr(), int(relu),
                y.data_ptr())
        if tuple(halo) == (0, 0):
            self._lib.tdal_conv3x3_fwd(*args, self._bf16(x), self._stream(x))
        else:
            self._lib.tdal_conv3x3_fwd_halo(*args, *halo, self._bf16(x), self._stream(x))
        self._check("conv3x3_fwd")

    def conv3x3_wgrad(self, x, gy, in_scale, in_shift, in_act: bool, splits: int, partial,
                      dw, halo=(0, 0)):
        B, H, W, C = gy.shape[0], gy.shape[1], gy.shape[2], x.shape[-1]
        args = (x.data_ptr(), gy.data_ptr(), B, H, W, C, gy.shape[-1], in_scale.data_ptr(),
                in_shift.data_ptr(), int(in_act), splits, partial.data_ptr(), dw.data_ptr())
        if tuple(halo) == (0, 0):
            self._lib.tdal_conv3x3_wgrad(*args, self._bf16(x), self._stream(x))
        else:
            self._lib.tdal_conv3x3_wgrad_halo(*args, *halo, self._bf16(x), self._stream(x))
        self._check("conv3x3_wgrad")

    def conv3x3_dgrad_act(self, gy, wt, x, s, t, dx, partial, stats, halo=(0, 0)):
        B, H, W, C = x.shape
        args = (gy.data_ptr(), wt.data_ptr(), x.data_ptr(), B, H, W, gy.shape[-1], C,
                s.data_ptr(), t.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                stats.data_ptr())
        if tuple(halo) == (0, 0):
            self._lib.tdal_conv3x3_dgrad_act(*args, self._bf16(gy), self._stream(gy))
        else:
            self._lib.tdal_conv3x3_dgrad_act_halo(*args, *halo, self._bf16(gy),
                                                  self._stream(gy))
        self._check("conv3x3_dgrad_act")

    def sparse_conv_tile_rows(self, cout: int) -> int:
        return self._lib.tdal_sparse_conv_tile_rows(cout)

    def sparse_conv(self, x, table, w, counts, y):
        """y = sum_k x[table[k]] @ w[k] (``csrc/sparse_conv.cu``)."""
        n_in, cin = x.shape
        taps, n_out = table.shape
        ok = self._lib.tdal_sparse_conv(
            x.data_ptr(), n_in, cin, table.data_ptr(), taps, n_out, w.data_ptr(),
            w.shape[-1], counts.data_ptr(), n_out // counts.numel(), y.data_ptr(),
            self._bf16(x), self._stream(x))
        if ok != 0:
            raise ValueError(f"tdal_torch: sparse_conv takes no {cin} -> {w.shape[-1]} "
                             f"conv of {taps} taps over {n_out} rows")
        self._check("sparse_conv")
