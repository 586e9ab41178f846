"""Pluggable checkpoint/result storage: the port's copy of
``ray_tpu/train/storage.py`` (reference:
``python/ray/train/_internal/storage.py`` — StorageContext over a pyarrow
filesystem).

Multi-host training needs every worker to persist checkpoints to storage
all hosts can read. The reference reaches cloud buckets through pyarrow;
this runtime defines a minimal filesystem interface with three backends:

- ``LocalFilesystem`` — plain paths (same behavior as before),
- ``SharedDirFilesystem`` (``mock://``) — a host-shared directory tree
  addressed by URI, exercising the exact upload/download dataflow a cloud
  bucket would, without egress (tests use this as the "bucket"),
- cloud URIs (``gs://``, ``s3://``) — recognized and rejected with a
  clear error until a cloud SDK is available in the image.

Checkpoint dirs are *uploaded* (worker → storage) and *downloaded*
(storage → restoring worker); with LocalFilesystem both are no-ops on the
same host, preserving the zero-copy adoption dataflow.
"""
from __future__ import annotations

import os
import shutil
from typing import List, Tuple


class StorageFilesystem:
    """Tiny filesystem surface needed by checkpoint/result persistence."""

    scheme = ""

    def resolve(self, uri: str) -> str:
        """URI → concrete local path where the bytes live."""
        raise NotImplementedError

    def makedirs(self, uri: str) -> None:
        os.makedirs(self.resolve(uri), exist_ok=True)

    def exists(self, uri: str) -> bool:
        return os.path.exists(self.resolve(uri))

    def listdir(self, uri: str) -> List[str]:
        return sorted(os.listdir(self.resolve(uri)))

    def read_bytes(self, uri: str) -> bytes:
        with open(self.resolve(uri), "rb") as f:
            return f.read()

    def write_bytes(self, uri: str, data: bytes) -> None:
        path = self.resolve(uri)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def rmtree(self, uri: str) -> None:
        shutil.rmtree(self.resolve(uri), ignore_errors=True)

    def upload_dir(self, local_dir: str, uri: str) -> str:
        """Persist a local directory into storage; returns the storage URI."""
        dest = self.resolve(uri)
        if os.path.abspath(local_dir) != os.path.abspath(dest):
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.copytree(local_dir, dest)
        return uri

    def download_dir(self, uri: str, local_dir: str) -> str:
        """Materialize a storage directory locally; returns the local path."""
        src = self.resolve(uri)
        if os.path.abspath(src) == os.path.abspath(local_dir):
            return local_dir
        if os.path.exists(local_dir):
            shutil.rmtree(local_dir)
        shutil.copytree(src, local_dir)
        return local_dir

    def join(self, uri: str, *parts: str) -> str:
        return "/".join([uri.rstrip("/")] + [p.strip("/") for p in parts])


class LocalFilesystem(StorageFilesystem):
    scheme = ""

    def resolve(self, uri: str) -> str:
        if uri.startswith("file://"):
            uri = uri[len("file://"):]
        return os.path.abspath(os.path.expanduser(uri))


class SharedDirFilesystem(StorageFilesystem):
    """``mock://bucket/key`` → ``$RT_MOCK_FS_ROOT/bucket/key``.

    Stands in for a cloud bucket: every process on the host resolves the
    same URI to the same tree, and all IO goes through the filesystem
    interface (upload/download copies, no in-place adoption).
    """

    scheme = "mock"

    def __init__(self):
        self.root = os.environ.get(
            "RT_MOCK_FS_ROOT",
            os.path.join(os.environ.get("TMPDIR", "/tmp"), "rt_mock_fs"))

    def resolve(self, uri: str) -> str:
        assert uri.startswith("mock://"), uri
        return os.path.join(self.root, uri[len("mock://"):])


_CLOUD_SCHEMES = ("gs", "s3", "azure", "abfs")


def get_filesystem(path: str) -> Tuple[StorageFilesystem, str]:
    """(filesystem, uri) for a storage path. Local paths pass through."""
    scheme, sep, _ = path.partition("://")
    if not sep:
        return LocalFilesystem(), path
    if scheme == "file":
        return LocalFilesystem(), path
    if scheme == "mock":
        return SharedDirFilesystem(), path
    if scheme in _CLOUD_SCHEMES:
        raise ValueError(
            f"cloud storage scheme {scheme!r} needs a cloud SDK that is "
            "not bundled; mount the bucket (gcsfuse) and pass the mount "
            "path, or use mock:// shared-dir storage")
    raise ValueError(f"unknown storage scheme {scheme!r} in {path!r}")


def is_uri(path: str) -> bool:
    return "://" in path
