"""Posterior alignment on the GPU: the Hopper kernel behind jax.ffi.

`posterior_summary` has the contract of ops/align.py posterior_summary
(bit for bit, all six fields) and runs ops/cuda/align_kernel.cu, one
warp per alignment lane, with the DP rows in registers (in shared
memory for a full DP wider than 1024 columns) and only int16 hm rows in
band coordinates staged through device memory.

The kernel library is compiled from the sources beside this module with
nvcc for sm_90a at first use, or ahead of time with

    python -m consent_jax.ops.gpu_align

into a content-addressed `.so` next to the sources (gitignored).  On a
GPU a failed build or load raises; nothing falls back to the XLA scan.

On the CPU the same FFI target name is bound to ops/cuda/align_host.cc,
a host model of the kernel's recurrence built with g++ — the tests use
it to check this wrapper and the recurrence without a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from consent_jax.ops.align import PosteriorSummary, Scoring

TARGET = "consent_posterior_summary"
_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_SOURCES = {
    "gpu": ("align_kernel.cu", "align_core.h"),
    "cpu": ("align_host.cc", "align_core.h"),
}
_FFI_PLATFORM = {"gpu": "CUDA", "cpu": "cpu"}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the GPU "
        "aligner kernel cannot be built"
    )


def _command(platform: str, src: str, out: str) -> list:
    inc = jax.ffi.include_dir()
    if platform == "gpu":
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-I", inc, "-o", out, src]
    return ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", inc,
            "-o", out, src]


def library_path(platform: str) -> str:
    """Where the library for `platform` ('gpu' or 'cpu') is built: the
    name carries a hash of its sources and of the JAX FFI headers."""
    h = hashlib.sha256(jax.ffi.include_dir().encode())
    for name in _SOURCES[platform]:
        with open(os.path.join(_SRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(
        _SRC_DIR, f"libconsent_align_{platform}_{h.hexdigest()[:16]}.so"
    )


def build(platform: str = "gpu") -> str:
    """Compile the library for `platform` unless it is already built;
    return its path.  Raises RuntimeError with the compiler's output."""
    out = library_path(platform)
    if os.path.exists(out):
        return out
    src = os.path.join(_SRC_DIR, _SOURCES[platform][0])
    # build under a private name, then rename: concurrent builders
    # (test workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_SRC_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(_command(platform, src, tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the {platform} aligner library failed:\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def load(platform: str) -> ctypes.CDLL:
    """Build if needed, load, and register the FFI target for
    `platform` ('gpu': the CUDA kernel; 'cpu': the host model)."""
    lib = ctypes.CDLL(build(platform))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.ConsentPosteriorSummary),
        platform=_FFI_PLATFORM[platform],
    )
    if platform == "gpu":
        lib.consent_align_supported.argtypes = [ctypes.c_int] * 3
        lib.consent_align_supported.restype = ctypes.c_int
    return lib


def slot_count(Lr: int, band: int) -> int:
    """DP slots per row: the band, or the ref width padded to 128."""
    return band if band else max(128, -(-Lr // 128) * 128)


def gap_window(max_hgap: int, Lr: int, S: int) -> int:
    """The horizontal-gap window the XLA form scans (0 = unbounded):
    ops/align.py _prefix_max_exclusive doubles its shift up to the
    next power of two of max_hgap, and scans the whole row when
    max_hgap is 0 or not below the ref width."""
    if not max_hgap or max_hgap >= Lr:
        return 0
    w = 1 << (max_hgap - 1).bit_length()
    return 0 if w >= S else w


def check(Lq: int, Lr: int, sc: Scoring, platform: str | None = None
          ) -> None:
    """Raise ValueError unless a kernel variant serves (Lq, Lr, sc) on
    `platform` (default: JAX's first device).  Callers with fixed
    shapes (the consensus engine, the stitch aligner) ask once at set-up
    so that an unsupported knob fails there, not inside a jitted call."""
    platform = platform or jax.devices()[0].platform
    S = slot_count(Lr, sc.band)
    win = gap_window(sc.max_hgap, Lr, S)
    if Lq >= 2 ** 15:
        raise ValueError(f"query width {Lq} exceeds the kernel's int16 rows")
    if S % 32:
        raise ValueError(f"no aligner kernel for {S} slots per row")
    if platform == "gpu" and not load("gpu").consent_align_supported(
        int(sc.band > 0), S // 32, win
    ):
        raise ValueError(
            f"no aligner kernel compiled for band={sc.band}, {S} slots, "
            f"gap window {win} (ops/cuda/align_kernel.cu pick()): the "
            f"band must be 128 or 256 and the gap cap at most 32"
        )


def posterior_summary(
    q: jnp.ndarray,       # [N, Lq] codes
    q_len: jnp.ndarray,   # [N] int32
    r: jnp.ndarray,       # [N, Lr] codes
    r_len: jnp.ndarray,   # [N] int32
    sc: Scoring = Scoring(),
    d0: jnp.ndarray | None = None,   # [N] expected ref col of q[0] (band)
) -> PosteriorSummary:
    """ops/align.py posterior_summary through the FFI kernel of the
    default device's platform."""
    platform = jax.devices()[0].platform
    load(platform)
    N, Lq = q.shape
    Lr = r.shape[1]
    S = slot_count(Lr, sc.band)
    win = gap_window(sc.max_hgap, Lr, S)
    check(Lq, Lr, sc, platform)
    if d0 is None:
        d0 = jnp.zeros((N,), jnp.int32)
    i32 = jax.ShapeDtypeStruct((N, Lr), jnp.int32)
    opt, i_first, i_last, base, ins_pack, _hm = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((N,), jnp.int32), i32, i32, i32, i32,
         jax.ShapeDtypeStruct((N, Lq, S), jnp.int16)),
        vmap_method="sequential",
    )(
        jnp.asarray(q).astype(jnp.uint8), jnp.asarray(q_len, jnp.int32),
        jnp.asarray(r).astype(jnp.uint8), jnp.asarray(r_len, jnp.int32),
        jnp.asarray(d0, jnp.int32),
        band=np.int32(sc.band), window=np.int32(win),
        match=np.int32(sc.match), mismatch=np.int32(sc.mismatch),
        gap_open=np.int32(sc.gap_open), gap_extend=np.int32(sc.gap_extend),
    )
    return PosteriorSummary(
        opt=opt, matched=i_last >= 0, i_first=i_first, i_last=i_last,
        base=base, ins_pack=ins_pack,
    )


if __name__ == "__main__":
    print(build("gpu"))
