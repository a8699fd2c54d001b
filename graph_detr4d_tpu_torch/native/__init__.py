"""Native image loader: ctypes bindings over `native/loader.cpp`
(counterpart of graph_detr4d_tpu/native, the same C ABI and source).

12 JPEG decodes per sample plus the fused resize/crop/flip (and
normalize) run in C++ threads outside the GIL. The library is compiled
with g++ and libjpeg at first use into the git-ignored
`graph_detr4d_tpu_torch/_build/libgrd4dloader-<hash>.so` (the hash covers
the source and the flags), never into the source tree. Where g++ or
libjpeg's headers are missing the build fails once, `available()` is
False and `unavailable_reason()` says why; callers check `available()`.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpthread")
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libgrd4dloader-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str:
    """Compile to a process- and thread-private name, then rename, so a
    concurrent process never loads a half-written file. Returns '' on
    success, else the compiler's message."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (proc.stderr or proc.stdout).strip().splitlines()[0]
    os.replace(tmp, out)
    return ""


@functools.lru_cache(maxsize=None)
def _load():
    """(library or None, reason it is unavailable); built once a process."""
    with _lock:
        out = library_path()
        if not out.exists():
            err = _build(out)
            if err:
                return None, err
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            return None, str(e)
    common = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_double,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int]
    lib.grd4d_load_images.restype = ctypes.c_int
    lib.grd4d_load_images.argtypes = common + [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.grd4d_load_images_u8.restype = ctypes.c_int
    lib.grd4d_load_images_u8.argtypes = common + [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    return lib, ""


def available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str:
    """Why the library did not build or load ('' when it is available)."""
    return _load()[1]


def load_images(
    paths,
    *,
    resize: float = 1.0,
    crop_xy=(0, 0),
    out_hw,
    flip: bool = False,
    mean=(123.675, 116.28, 103.53),  # RGB, img_norm_cfg
    std=(58.395, 57.12, 57.375),
    num_threads: int = 0,
    raw_uint8: bool = False,
) -> np.ndarray:
    """Decode and fused resize/crop/flip (and normalize) a camera set.

    Returns (len(paths), out_h, out_w, 3) float32, or raw uint8 with
    `raw_uint8=True` (no normalization: the device_normalize path).
    Raises RuntimeError on unreadable or corrupt files, or when the
    library is unavailable.
    """
    lib, reason = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {reason}")
    n = len(paths)
    out_h, out_w = out_hw
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    nt = num_threads or min(n, os.cpu_count() or 1)
    args = (c_paths, n, ctypes.c_double(resize), int(crop_xy[0]),
            int(crop_xy[1]), out_h, out_w, int(bool(flip)))
    if raw_uint8:
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        failed = lib.grd4d_load_images_u8(
            *args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nt)
    else:
        out = np.empty((n, out_h, out_w, 3), np.float32)
        mean_a = np.ascontiguousarray(mean, np.float32)
        std_a = np.ascontiguousarray(std, np.float32)
        failed = lib.grd4d_load_images(
            *args,
            mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nt)
    if failed:
        raise RuntimeError(f"native loader failed on {failed} image(s)")
    return out
