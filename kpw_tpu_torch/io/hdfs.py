"""HDFS sink behind the pluggable FileSystem interface.

The reference writes through Hadoop's ``FileSystem`` API resolved from the
mandatory ``fs.defaultFS`` (KafkaProtoParquetWriter.java:137-141) and
publishes files with an atomic ``rename`` (KPW.java:371-375).  Here the same
capability rides pyarrow's libhdfs binding
(``pyarrow.fs.HadoopFileSystem``), adapted to the seven-method
``kpw_tpu_torch.io.fs.FileSystem`` surface the writer runtime uses — so

    Builder().filesystem(HdfsFileSystem(host="namenode", port=8020))

targets a real cluster, while tests keep the in-memory stand-in
(``MemoryFileSystem``), mirroring the reference's MiniDFSCluster strategy
(SURVEY.md §4).  HDFS rename has the same atomicity contract the publish
protocol needs.  Connecting requires libhdfs + a Hadoop install
(CLASSPATH); constructing without them raises with guidance instead of
failing at first write.
"""

from __future__ import annotations

import posixpath

from .fs import FileSystem


class HdfsFileSystem(FileSystem):
    def __init__(self, host: str = "default", port: int = 8020,
                 user: str | None = None, replication: int | None = None,
                 **kwargs) -> None:
        try:
            from pyarrow.fs import HadoopFileSystem
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "HdfsFileSystem needs pyarrow with HDFS support") from e
        extra = dict(kwargs)
        if replication is not None:
            extra["replication"] = replication
        from pyarrow.fs import FileSelector, FileType

        self._FileType = FileType
        self._FileSelector = FileSelector
        try:
            self._fs = HadoopFileSystem(host, port, user=user, **extra)
        except Exception as e:  # libhdfs/CLASSPATH missing
            raise RuntimeError(
                "could not connect to HDFS — libhdfs and a Hadoop client "
                "install (CLASSPATH from `hadoop classpath --glob`) are "
                f"required: {e}") from e

    def mkdirs(self, path: str) -> None:
        self._fs.create_dir(path, recursive=True)

    def open_write(self, path: str):
        return self._fs.open_output_stream(path)

    def open_append(self, path: str):
        return self._fs.open_append_stream(path)

    def open_read(self, path: str):
        # random-access reader: Local/Memory open_read are seekable, and
        # parquet read-back (footer-first) requires seeks
        return self._fs.open_input_file(path)

    def rename(self, src: str, dst: str) -> None:
        self._fs.move(src, dst)  # HDFS NameNode rename: atomic

    def sync(self, path: str) -> None:
        # HDFS close() already waits for the write pipeline's replica acks
        # (the durability POSIX fsync provides locally); there is no
        # path-level fsync in the libhdfs surface, so sync is a no-op — but
        # keep the Local/Memory contract of raising on a lost file
        if not self.exists(path):
            raise FileNotFoundError(path)

    def sync_dir(self, path: str) -> None:
        pass  # namespace edits are journaled by the NameNode at rename time

    def exists(self, path: str) -> bool:
        return self._fs.get_file_info(path).type != self._FileType.NotFound

    def delete(self, path: str) -> None:
        # Parity with Local/Memory FS: delete() is a *file* operation —
        # raise on a directory (never recursively wipe published output)
        # and on a missing path.
        info = self._fs.get_file_info(path)
        if info.type == self._FileType.NotFound:
            raise FileNotFoundError(path)
        if info.type == self._FileType.Directory:
            raise IsADirectoryError(path)
        self._fs.delete_file(path)

    def size(self, path: str) -> int:
        info = self._fs.get_file_info(path)
        if info.type == self._FileType.NotFound:  # match Local/Memory FS:
            raise FileNotFoundError(path)  # never report a lost file as 0 B
        return int(info.size or 0)

    def list_files(self, path: str, extension: str | None = None,
                   recursive: bool = True) -> list[str]:
        sel = self._FileSelector(path, recursive=recursive,
                                 allow_not_found=True)
        out = []
        try:
            infos = self._fs.get_file_info(sel)
        except FileNotFoundError:
            # despite allow_not_found, pyarrow can raise when the
            # directory is being CREATED concurrently (observed racing a
            # recursive create_dir) — Local/Memory parity is an empty
            # listing for a dir that isn't fully there yet
            return out
        for info in infos:
            if info.type != self._FileType.File:
                continue
            if extension is None or info.path.endswith(extension):
                out.append(posixpath.join("/", info.path)
                           if not info.path.startswith("/") else info.path)
        return sorted(out)
