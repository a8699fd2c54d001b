"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc`
into `graph_detr4d_tpu_torch/_build/lib<name>-<hash>.so` (git-ignored) the
first time a wrapper needs it, and loaded with `ctypes`. The hash covers
the source, every shared header `csrc/*.cuh` (a source may include one)
and the flags, so an edited source or header is rebuilt. Nothing here
runs at import: the CPU tests import every module on a host without nvcc.

    python -c "from graph_detr4d_tpu_torch.ops import build; print(build.build())"

builds all kernels, one nvcc process per source, all started together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("msda", "deform_conv", "deform_conv_int8", "focal_loss",
           "hungarian", "voxelize", "iou3d")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# nvcc runs made by build() and their summed seconds (plain counters;
# serve.Engine.counters reads them: a kernel built again shows here)
builds = 0
build_s = 0.0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        f"{CSRC_DIR} at first use on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built: named by a hash of the source, the
    headers of `csrc` and the nvcc flags."""
    h = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, in parallel.

    Returns the seconds each nvcc took (0.0 for a library already built),
    and adds them to `builds` and `build_s`. Raises with nvcc's output if
    a compile fails.
    """
    global builds, build_s
    BUILD_DIR.mkdir(exist_ok=True)
    jobs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        builds += 1
        build_s += seconds[name]
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and load it."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
