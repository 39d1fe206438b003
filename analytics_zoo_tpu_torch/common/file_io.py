"""Scheme-aware filesystem layer (counterpart of ``analytics_zoo_tpu/common/
file_io.py``): what the serving ``FileQueue``, model save/load and
``ImageSet.read`` use.

- Plain local paths go straight to the posix builtins.
- ``file://`` URIs are stripped to local paths.
- Any other ``scheme://`` URI dispatches to a filesystem registered with
  :func:`register_filesystem` (how tests put a fake remote store in), or
  else to an ``fsspec`` filesystem for the scheme. ``fsspec`` is imported
  only then, so a deployment that registers its filesystems never needs
  it.

Every remote operation runs behind the ``io.remote`` fault site and the
transient-failure retry policy (``failure.io_retries`` attempts with
``failure.io_backoff_s`` exponential backoff); local paths keep posix
semantics. :func:`replace` is atomic on posix and a copy and delete on an
object store, so multi-consumer protocols use :func:`create_exclusive`
there instead.
"""
from __future__ import annotations

import logging
import os
import posixpath
import re
import shutil
import time
from typing import Dict, List, Optional

from . import faults

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")

logger = logging.getLogger(__name__)

# scheme -> filesystem with fsspec's AbstractFileSystem surface (open,
# exists, isdir, ls, makedirs, rm_file, rm, mv); looked up before fsspec
_REGISTRY: Dict[str, object] = {}


def register_filesystem(scheme: str, fs) -> None:
    """Register (or override) the filesystem serving ``scheme://`` paths."""
    _REGISTRY[scheme] = fs


def unregister_filesystem(scheme: str) -> None:
    _REGISTRY.pop(scheme, None)


def _retryable(e: BaseException) -> bool:
    """Network and backend OSErrors (injected faults among them) retry; a
    filesystem's definite answers surface at once."""
    if isinstance(e, (FileNotFoundError, FileExistsError, IsADirectoryError,
                      NotADirectoryError, PermissionError)):
        return False
    return isinstance(e, (OSError, TimeoutError))


def _remote_op(op: str, path: str, fn):
    """One remote operation behind the ``io.remote`` fault site and the
    bounded exponential-backoff retry policy."""
    from .config import global_config
    cfg = global_config()
    retries = int(cfg.get("failure.io_retries") or 0)
    backoff = float(cfg.get("failure.io_backoff_s") or 0.0)
    attempt = 0
    while True:
        try:
            faults.inject("io.remote")
            return fn()
        except BaseException as e:
            if not _retryable(e) or attempt >= retries:
                raise
            delay = backoff * (2 ** attempt)
            logger.warning(
                "transient remote IO failure in %s(%r) (attempt %d/%d, "
                "retrying in %.2fs): %r", op, path, attempt + 1, retries,
                delay, e)
            time.sleep(delay)
            attempt += 1


def scheme_of(path: str) -> Optional[str]:
    m = _SCHEME_RE.match(str(path))
    return m.group(1) if m else None


def is_remote(path: str) -> bool:
    """True when the path needs a filesystem other than posix."""
    scheme = scheme_of(path)
    return scheme is not None and scheme != "file"


def local_path(path: str) -> str:
    """Strip a ``file://`` prefix; raise on a remote path."""
    scheme = scheme_of(path)
    if scheme == "file":
        return str(path)[len("file://"):]
    if scheme is not None:
        raise ValueError(f"{path!r} is not a local path")
    return str(path)


def _fs(path: str):
    scheme = scheme_of(path)
    if scheme in _REGISTRY:
        return _REGISTRY[scheme]
    try:
        import fsspec
    except ImportError as e:
        raise RuntimeError(
            f"path {path!r} needs fsspec for scheme {scheme!r}; install "
            f"fsspec or register_filesystem({scheme!r}, fs)") from e
    fs, _ = fsspec.core.url_to_fs(path)
    return fs


def join(path: str, *parts: str) -> str:
    """Scheme-preserving join (posix separators for URIs)."""
    if is_remote(path) or scheme_of(path) == "file":
        return posixpath.join(str(path), *parts)
    return os.path.join(str(path), *parts)


def fopen(path: str, mode: str = "r", encoding: Optional[str] = None):
    """Open a local path or a ``scheme://`` URI. Object stores cannot
    append: a new remote file opened ``'a'`` is written, an existing one
    raises."""
    kw = {} if "b" in mode else {"encoding": encoding}
    if not is_remote(path):
        return open(local_path(path), mode, **kw)
    fs = _fs(path)
    if "a" in mode:
        if _remote_op("exists", path, lambda: fs.exists(str(path))):
            raise ValueError(
                f"append mode is not supported on existing remote objects "
                f"({path!r})")
        mode = mode.replace("a", "w")
    return _remote_op("open", path, lambda: fs.open(str(path), mode, **kw))


_warned_non_exclusive: set = set()


def create_exclusive(path: str, data: bytes = b"") -> None:
    """Create ``path``, raising ``FileExistsError`` if it exists: the claim
    marker of multi-consumer queues. Atomic on posix (``O_EXCL``). Remote,
    the backend's exclusive-create mode where it has one, else an exists
    check and a write (best effort: two consumers inside that window may
    both win; ``RedisQueue`` gives a hard guarantee)."""
    if not is_remote(path):
        fd = os.open(local_path(path), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        return
    fs = _fs(path)
    try:
        f = _remote_op("create_exclusive", path,
                       lambda: fs.open(str(path), "xb"))
    except FileExistsError:
        raise
    except (ValueError, NotImplementedError):
        # only "mode unsupported" degrades: a transient OSError propagates
        scheme = scheme_of(path)
        if scheme not in _warned_non_exclusive:
            _warned_non_exclusive.add(scheme)
            logger.warning(
                "backend for %s lacks exclusive-create; claim markers "
                "degrade to a non-atomic exists-check + write", scheme)
        if _remote_op("exists", path, lambda: fs.exists(str(path))):
            raise FileExistsError(path)
        f = _remote_op("open", path, lambda: fs.open(str(path), "wb"))
    with f:
        f.write(data)


def exists(path: str) -> bool:
    if not is_remote(path):
        return os.path.exists(local_path(path))
    return bool(_remote_op("exists", path,
                           lambda: _fs(path).exists(str(path))))


def isdir(path: str) -> bool:
    if not is_remote(path):
        return os.path.isdir(local_path(path))
    return bool(_remote_op("isdir", path,
                           lambda: _fs(path).isdir(str(path))))


def listdir(path: str, refresh: bool = False) -> List[str]:
    """Child basenames, as ``os.listdir``. ``refresh`` drops a remote
    filesystem's cached listing first, so a polling consumer sees what
    other processes wrote."""
    if not is_remote(path):
        return os.listdir(local_path(path))
    fs = _fs(path)
    if refresh:
        try:
            fs.invalidate_cache(str(path))
        except Exception:
            pass  # a backend without a listing cache
    names = _remote_op("listdir", path,
                       lambda: fs.ls(str(path), detail=False))
    return [posixpath.basename(str(n).rstrip("/")) for n in names]


def makedirs(path: str, exist_ok: bool = True) -> None:
    if not is_remote(path):
        os.makedirs(local_path(path), exist_ok=exist_ok)
        return
    try:
        _remote_op("makedirs", path,
                   lambda: _fs(path).makedirs(str(path), exist_ok=exist_ok))
    except FileExistsError:
        if not exist_ok:
            raise


def remove(path: str) -> None:
    if not is_remote(path):
        os.remove(local_path(path))
        return
    _remote_op("remove", path, lambda: _fs(path).rm_file(str(path)))


def rmtree(path: str) -> None:
    if not is_remote(path):
        shutil.rmtree(local_path(path))
        return
    _remote_op("rmtree", path,
               lambda: _fs(path).rm(str(path), recursive=True))


def replace(src: str, dst: str) -> None:
    """Rename ``src`` over ``dst``: ``os.replace`` locally (atomic), the
    store's ``mv`` remotely (not atomic)."""
    if not is_remote(src) and not is_remote(dst):
        os.replace(local_path(src), local_path(dst))
        return
    if scheme_of(src) != scheme_of(dst):
        raise ValueError(f"cross-scheme replace: {src!r} -> {dst!r}")
    fs = _fs(src)

    def mv():
        # some backends' mv refuses to clobber: drop the target first
        if fs.exists(str(dst)):
            fs.rm_file(str(dst))
        fs.mv(str(src), str(dst))

    _remote_op("replace", src, mv)
