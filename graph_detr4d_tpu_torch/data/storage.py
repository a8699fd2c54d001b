"""Storage backend for dataset reads (counterpart of
graph_detr4d_tpu/data/storage.py; mmcv FileClient plus the petrel path
remapping of configs/detr4d/...12e.py:121-128, pipelines/loading.py:42,81).

A FileClient resolves logical dataset paths through an optional prefix
remap (`path_mapping`) and reads bytes from its backend: 'disk' (local
files, the default) or 'gcs' (Google Cloud Storage through fsspec and
gcsfs, imported at first use; without them it raises ImportError).

    client = FileClient(path_mapping={"./data/nuscenes": "gs://bkt/nusc"})
    img_bytes = client.get("./data/nuscenes/samples/CAM_FRONT/x.jpg")
"""

import os
from typing import Dict, Optional


class FileClient:
    def __init__(
        self,
        backend: str = "disk",
        path_mapping: Optional[Dict[str, str]] = None,
    ):
        if backend not in ("disk", "gcs"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.path_mapping = dict(path_mapping or {})
        self._fs = None

    def resolve(self, path: str) -> str:
        for src, dst in self.path_mapping.items():
            if path.startswith(src):
                path = dst + path[len(src):]
                break
        return path

    def _gcs(self):
        if self._fs is None:
            try:
                import gcsfs  # noqa: F401
                import fsspec

                self._fs = fsspec.filesystem("gs")
            except ImportError as e:
                raise ImportError(
                    "gcs backend requires fsspec+gcsfs; install them or "
                    "use backend='disk'"
                ) from e
        return self._fs

    def get(self, path: str) -> bytes:
        path = self.resolve(path)
        if path.startswith("gs://") or self.backend == "gcs":
            with self._gcs().open(path, "rb") as f:
                return f.read()
        with open(path, "rb") as f:
            return f.read()

    def exists(self, path: str) -> bool:
        path = self.resolve(path)
        if path.startswith("gs://") or self.backend == "gcs":
            return self._gcs().exists(path)
        return os.path.exists(path)


DEFAULT_CLIENT = FileClient()
