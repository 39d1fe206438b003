"""Local-path subset of ``analytics_zoo_tpu/common/file_io.py``: what the
serving ``FileQueue``, model save/load and ``ImageSet.read`` use.
``file://`` URIs are stripped to local paths; other ``scheme://`` URIs
(object stores) are not ported yet and raise."""
from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")


def scheme_of(path: str) -> Optional[str]:
    m = _SCHEME_RE.match(str(path))
    return m.group(1) if m else None


def is_remote(path: str) -> bool:
    scheme = scheme_of(path)
    return scheme is not None and scheme != "file"


def local_path(path: str) -> str:
    """Strip a ``file://`` prefix; raise on any other scheme."""
    scheme = scheme_of(path)
    if scheme == "file":
        return str(path)[len("file://"):]
    if scheme is not None:
        raise ValueError(f"{path!r}: remote {scheme}:// paths are not "
                         f"supported by the torch port yet")
    return str(path)


def join(path: str, *parts: str) -> str:
    return os.path.join(local_path(path), *parts)


def fopen(path: str, mode: str = "r", encoding: Optional[str] = None):
    kw = {} if "b" in mode else {"encoding": encoding}
    return open(local_path(path), mode, **kw)


def exists(path: str) -> bool:
    return os.path.exists(local_path(path))


def isdir(path: str) -> bool:
    return os.path.isdir(local_path(path))


def listdir(path: str) -> List[str]:
    return os.listdir(local_path(path))


def makedirs(path: str, exist_ok: bool = True) -> None:
    os.makedirs(local_path(path), exist_ok=exist_ok)


def remove(path: str) -> None:
    os.remove(local_path(path))


def rmtree(path: str) -> None:
    shutil.rmtree(local_path(path))


def replace(src: str, dst: str) -> None:
    """Atomic rename of ``src`` over ``dst`` (``os.replace``)."""
    os.replace(local_path(src), local_path(dst))
