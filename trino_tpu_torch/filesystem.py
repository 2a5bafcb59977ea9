"""Filesystem SPI: one seam between storage consumers and where bytes live.

Reference: lib/trino-filesystem/.../TrinoFileSystem.java (+ the S3/GCS/Azure
implementations and plugin/trino-exchange-filesystem's
S3FileSystemExchangeStorage) — every reference component that persists state
(FTE spool, iceberg metadata/data, hive splits) goes through ONE interface so
remote object stores are a configuration choice, not a code change.

Port of trino_tpu/filesystem.py, copied.  The port's consumer is the
spill tier's spool (runtime/fte.py SpoolManager, under runtime/spill.py),
which resolves its filesystem through `filesystem_for(location)`:

  * plain paths / `file://` -> LocalFileSystem (the only implementation)
  * `s3://`, `gs://`, `abfs://` -> raises with the scheme name, so pointing
    the spool at an object store fails loudly at configuration time instead
    of scattering NotImplementedErrors at first IO

The interface is intentionally byte-oriented (read/write/list/delete/exists)
— the npz/parquet codecs stay in the consumers, matching the reference split
between TrinoFileSystem (bytes) and the format readers above it.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional


class FileSystem:
    """Byte-level storage operations under a root location."""

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def append(self, path: str, data: bytes) -> None:
        """Append bytes to a (possibly absent) file — the audit-log /
        JSONL-sink primitive.  NOT atomic across writers; callers needing
        single-writer semantics serialize themselves (an object-store
        implementation would express this as multipart upload parts)."""
        raise NotImplementedError

    def size(self, path: str) -> int:
        """Current byte size (0 when absent) — size-based log rotation."""
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Move a file, replacing any existing destination (log-segment
        rotation).  Default: copy-then-delete through the byte interface
        — correct anywhere, O(size); implementations with a native move
        (local os.replace, object-store server-side copy) override it."""
        self.write(dst, self.read(src))
        self.delete(src)

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> Iterable[str]:
        raise NotImplementedError

    def mtime(self, path: str) -> float:
        """Last-modified time, epoch seconds (spool GC ages files by it).
        Raises OSError when the path vanished."""
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def delete_recursive(self, path: str) -> None:
        """Remove a directory tree (spool/spill cleanup).  Lives on the SPI
        so cleanup follows the files to whatever storage hosts them — an
        object-store implementation expresses this as a prefix delete, not
        a local rmtree."""
        raise NotImplementedError

    def open_input(self, path: str):
        """File-like handle for libraries that stream (pyarrow, numpy)."""
        raise NotImplementedError

    def open_output(self, path: str):
        """Writable file-like handle (streaming writes; the local
        implementation writes in place — callers needing atomic publish
        use write())."""
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    """Reference analog: filesystem/local/LocalFileSystem.java."""

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish (spool/iceberg commits)

    def append(self, path: str, data: bytes) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "ab") as f:
            f.write(data)

    def size(self, path: str) -> int:
        try:
            return os.path.getsize(path)
        except OSError:
            return 0

    def rename(self, src: str, dst: str) -> None:
        d = os.path.dirname(dst)
        if d:
            os.makedirs(d, exist_ok=True)
        os.replace(src, dst)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def delete(self, path: str) -> None:
        if os.path.isfile(path):
            os.remove(path)

    def list(self, prefix: str) -> Iterable[str]:
        if not os.path.isdir(prefix):
            return []
        return sorted(
            os.path.join(prefix, n) for n in os.listdir(prefix)
        )

    def mtime(self, path: str) -> float:
        return os.path.getmtime(path)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete_recursive(self, path: str) -> None:
        import shutil

        shutil.rmtree(path, ignore_errors=True)

    def open_input(self, path: str):
        return open(path, "rb")

    def open_output(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        return open(path, "wb")


_REMOTE_SCHEMES = ("s3://", "gs://", "abfs://", "abfss://", "hdfs://")


def filesystem_for(location: Optional[str]) -> FileSystem:
    """Resolve the FileSystem for a location (the TrinoFileSystemFactory
    role).  Local paths and file:// resolve to LocalFileSystem; remote
    object-store schemes fail loudly until an implementation lands."""
    loc = location or ""
    for scheme in _REMOTE_SCHEMES:
        if loc.startswith(scheme):
            raise NotImplementedError(
                f"remote filesystem scheme {scheme!r} is not implemented on "
                "this build; storage locations (spool, iceberg, compile "
                "cache, prewarm manifests) must be local paths"
            )
    return LocalFileSystem()


def strip_scheme(location: str) -> str:
    return location[len("file://"):] if location.startswith("file://") else location
