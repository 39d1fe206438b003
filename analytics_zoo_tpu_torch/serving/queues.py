"""Queue backends for serving (counterpart of ``analytics_zoo_tpu/serving/
queues.py``): ``QueueBackend``, the local-spool ``FileQueue`` and
``make_queue``.

The spool layout (``requests/``, ``claimed/``, ``results/``), the file
names and the JSON records are the JAX package's, so a JAX client and a
port server share a spool, and a port client and a JAX server do too.
Requests are claimed by atomic rename. Remote ``scheme://`` spools and
``RedisQueue`` are later slices.
"""
from __future__ import annotations

import hashlib
import json
import logging
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..common import file_io
from ..common.utils import wall_clock

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

#: admission classes in CLAIM priority order; shed consumes them in reverse
CRITICALITY_LANES = ("critical", "default", "sheddable")
_CLAIM_RANK = {lane: i for i, lane in enumerate(CRITICALITY_LANES)}
_SHED_RANK = {lane: i for i, lane in enumerate(reversed(CRITICALITY_LANES))}
#: FileQueue filename lane tag ("{ts}-{uuid}.{tag}.json")
_LANE_TAG = {"critical": "c", "default": "d", "sheddable": "s"}
_TAG_LANE = {v: k for k, v in _LANE_TAG.items()}


def criticality_of(payload: Dict[str, Any]) -> str:
    """The request's admission class; unknown values mean ``default``."""
    lane = payload.get("criticality")
    return lane if lane in _CLAIM_RANK else "default"


class QueueBackend:
    """enqueue/claim requests; put/get results."""

    def enqueue(self, uri: str, payload: Dict[str, Any]) -> None:
        raise NotImplementedError

    def claim_batch(self, max_items: int) -> List[Tuple[str, Dict[str, Any]]]:
        """Atomically claim up to ``max_items`` pending requests."""
        raise NotImplementedError

    def put_result(self, uri: str, value: Dict[str, Any]) -> None:
        raise NotImplementedError

    def get_result(self, uri: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def shed(self, max_pending: int,
             reason: str = "shed: queue overloaded") -> List[str]:
        """Remove requests beyond ``max_pending`` (sheddable lane first,
        oldest first within a lane) and post ``{"error": reason,
        "retriable": True}`` for each. Returns the shed uris."""
        raise NotImplementedError


class FileQueue(QueueBackend):
    def __init__(self, root: str):
        self.root = root
        self.req_dir = file_io.join(root, "requests")
        self.claim_dir = file_io.join(root, "claimed")
        self.res_dir = file_io.join(root, "results")
        for d in (self.req_dir, self.claim_dir, self.res_dir):
            file_io.makedirs(d, exist_ok=True)

    @staticmethod
    def _record_name(payload: Dict[str, Any]) -> str:
        """Wall-clock stamp (FIFO within a lane) + uniquifier + lane tag."""
        tag = _LANE_TAG[criticality_of(payload)]
        return (f"{int(wall_clock() * 1e9):020d}-"
                f"{uuid.uuid4().hex[:8]}.{tag}.json")

    @staticmethod
    def _lane_of_name(name: str) -> str:
        parts = name.split(".")
        if len(parts) >= 3 and parts[-2] in _TAG_LANE:
            return _TAG_LANE[parts[-2]]
        return "default"

    def enqueue(self, uri: str, payload: Dict[str, Any]) -> None:
        name = self._record_name(payload)
        tmp = file_io.join(self.req_dir, "." + name)
        with file_io.fopen(tmp, "w") as f:
            f.write(json.dumps({"uri": uri, **payload}))
        file_io.replace(tmp, file_io.join(self.req_dir, name))

    def _flatten_batches(self, names: List[str]) -> List[str]:
        """Move the members of ``batch-*`` dirs (published in one rename by
        the JAX package's ``FileQueue.enqueue_many``) into the spool, one
        atomic rename each (a racing consumer's loss is skipped), and return
        the claimable names."""
        out = [n for n in names if not n.startswith("batch-")]
        for bname in names:
            if not bname.startswith("batch-"):
                continue
            bdir = file_io.join(self.req_dir, bname)
            try:
                members = file_io.listdir(bdir)
            except OSError:
                continue
            for m in members:
                try:
                    file_io.replace(file_io.join(bdir, m),
                                    file_io.join(self.req_dir, m))
                    out.append(m)
                except OSError:
                    pass  # another consumer moved it first
            try:
                if not file_io.listdir(bdir):
                    file_io.rmtree(bdir)
            except OSError:
                pass
        return out

    def _claim_one(self, name: str) -> Optional[str]:
        """Claim by atomic rename into ``claimed/``; None if another
        consumer won."""
        dst = file_io.join(self.claim_dir, name)
        try:
            file_io.replace(file_io.join(self.req_dir, name), dst)
        except OSError:
            return None
        return dst

    def _listed(self, rank) -> List[str]:
        names = self._flatten_batches(file_io.listdir(self.req_dir))
        return sorted((n for n in names if not n.startswith(".")),
                      key=lambda n: (rank[self._lane_of_name(n)], n))

    def _read_claimed(self, name: str, path: str
                      ) -> Optional[Dict[str, Any]]:
        """Read a claimed record and remove it; None if it is malformed."""
        try:
            with file_io.fopen(path) as f:
                rec = json.loads(f.read())
            if not isinstance(rec, dict) or "uri" not in rec:
                raise ValueError("record has no uri")
            return rec
        except (ValueError, OSError):
            logger.warning("dropping malformed request file %s", name)
            return None
        finally:
            try:
                file_io.remove(path)
            except OSError:
                pass

    def claim_batch(self, max_items: int) -> List[Tuple[str, Dict[str, Any]]]:
        """Claim in priority-lane order (critical, default, sheddable),
        FIFO within a lane."""
        out: List[Tuple[str, Dict[str, Any]]] = []
        for name in self._listed(_CLAIM_RANK):
            if len(out) >= max_items:
                break
            path = self._claim_one(name)
            if path is None:
                continue
            rec = self._read_claimed(name, path)
            if rec is not None:
                out.append((rec["uri"], rec))
        return out

    def shed(self, max_pending: int,
             reason: str = "shed: queue overloaded") -> List[str]:
        names = self._listed(_SHED_RANK)
        dropped: List[str] = []
        for name in names[:max(0, len(names) - max_pending)]:
            path = self._claim_one(name)  # exclusive: N shedders, one winner
            if path is None:
                continue
            rec = self._read_claimed(name, path)
            if rec is not None:
                self.put_result(rec["uri"],
                                {"error": reason, "retriable": True})
                dropped.append(rec["uri"])
        return dropped

    @staticmethod
    def _result_key(uri: str) -> str:
        return hashlib.md5(uri.encode()).hexdigest()

    def put_result(self, uri: str, value: Dict[str, Any]) -> None:
        key = self._result_key(uri)
        tmp = file_io.join(self.res_dir, "." + key)
        with file_io.fopen(tmp, "w") as f:
            f.write(json.dumps({"uri": uri, **value}))
        file_io.replace(tmp, file_io.join(self.res_dir, key + ".json"))

    def get_result(self, uri: str) -> Optional[Dict[str, Any]]:
        path = file_io.join(self.res_dir, self._result_key(uri) + ".json")
        if not file_io.exists(path):
            return None
        with file_io.fopen(path) as f:
            return json.loads(f.read())

    def all_results(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for name in file_io.listdir(self.res_dir):
            if name.startswith("."):
                continue
            with file_io.fopen(file_io.join(self.res_dir, name)) as f:
                rec = json.loads(f.read())
            out[rec["uri"]] = rec
        return out


def make_queue(src: str) -> QueueBackend:
    """``dir:///path``, ``file:///path`` or a plain path -> FileQueue.
    Remote spools and ``host:port`` (Redis) are not ported yet."""
    if src.startswith("dir://"):
        return FileQueue(src[len("dir://"):])
    if file_io.is_remote(src):
        raise NotImplementedError(
            f"queue src {src!r}: remote spools are not ported yet; use a "
            f"dir:///path file queue")
    head = src.split(":")[0]
    if ":" in src and "/" not in head and file_io.scheme_of(src) is None:
        raise NotImplementedError(
            f"queue src {src!r}: RedisQueue is not ported yet; use a "
            f"dir:///path file queue")
    return FileQueue(file_io.local_path(src))
