"""Queue backends for serving (counterpart of ``analytics_zoo_tpu/serving/
queues.py``): ``QueueBackend``, the spool ``FileQueue``, ``RedisQueue`` and
``make_queue``, and the image payload codec ``encode_image`` /
``decode_image``.

The spool layout (``requests/``, ``claimed/``, ``results/``), the file
names and the JSON records are the JAX package's, so a JAX client and a
port server share a spool, and a port client and a JAX server do too.
Local spools claim a request by atomic rename; ``scheme://`` spools (through
``common/file_io.py``) by an exclusive-create claim marker, reaped once it
is older than the claim lease. ``RedisQueue`` keeps the reference's wire
contract (a stream per criticality lane, results in ``result:<uri>``
hashes); it imports ``redis`` only when it is not given a client.
"""
from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..common import file_io
from ..common.utils import wall_clock

logger = logging.getLogger("analytics_zoo_tpu_torch.serving")

#: admission classes in CLAIM priority order; shed consumes them in reverse
CRITICALITY_LANES = ("critical", "default", "sheddable")
_CLAIM_RANK = {lane: i for i, lane in enumerate(CRITICALITY_LANES)}
_SHED_ORDER = tuple(reversed(CRITICALITY_LANES))
_SHED_RANK = {lane: i for i, lane in enumerate(_SHED_ORDER)}
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

    def enqueue_many(self, items: Sequence[Tuple[str, Dict[str, Any]]]
                     ) -> None:
        """Enqueue ``(uri, payload)`` records; backends override this with
        one publish a batch, the default loops."""
        for uri, payload in items:
            self.enqueue(uri, payload)

    def claim_batch(self, max_items: int) -> List[Tuple[str, Dict[str, Any]]]:
        """Atomically claim up to ``max_items`` pending requests."""
        raise NotImplementedError

    def put_result(self, uri: str, value: Dict[str, Any]) -> None:
        raise NotImplementedError

    def get_result(self, uri: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def pending_count(self) -> int:
        """Requests waiting to be claimed."""
        raise NotImplementedError

    def trim(self, max_pending: int) -> int:
        """Drop requests beyond ``max_pending`` without answering them
        (sheddable lane first); returns the count. The serve loops use
        :meth:`shed`."""
        raise NotImplementedError

    def shed(self, max_pending: int,
             reason: str = "shed: queue overloaded") -> List[str]:
        """Remove requests beyond ``max_pending`` (sheddable lane first,
        oldest first within a lane) and post ``{"error": reason,
        "retriable": True}`` for each. Returns the shed uris."""
        raise NotImplementedError

    def discard_result(self, uri: str) -> bool:
        """Drop ``uri``'s result, if any (the hedged client reaps its
        losing copy so). True when a record was removed."""
        return False


class FileQueue(QueueBackend):
    #: a remote claim marker older than this belongs to a consumer that
    #: died between claim and cleanup, and is reaped (at-least-once past a
    #: crash)
    CLAIM_LEASE_S = 300.0

    def __init__(self, root: str, claim_lease_s: Optional[float] = None,
                 results_root: Optional[str] = None):
        """``results_root`` puts the results under another spool's
        ``results/``: a fleet instance claims from its own spool and
        answers into the front's, where the clients poll."""
        self.root = root
        self.req_dir = file_io.join(root, "requests")
        self.claim_dir = file_io.join(root, "claimed")
        self.res_dir = file_io.join(results_root if results_root else root,
                                    "results")
        self.claim_lease_s = (claim_lease_s if claim_lease_s is not None
                              else self.CLAIM_LEASE_S)
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

    def enqueue_many(self, items: Sequence[Tuple[str, Dict[str, Any]]]
                     ) -> None:
        """Write the records into a hidden staging dir and publish them
        with one directory rename (a ``batch-*`` dir that consumers
        flatten). Remote spools rename by copy and delete, so they loop
        over :meth:`enqueue`."""
        items = list(items)
        if not items:
            return
        if file_io.is_remote(self.req_dir):
            for uri, payload in items:
                self.enqueue(uri, payload)
            return
        stage = file_io.join(self.req_dir, f".stage-{uuid.uuid4().hex[:8]}")
        file_io.makedirs(stage, exist_ok=True)
        for uri, payload in items:
            name = self._record_name(payload)
            with file_io.fopen(file_io.join(stage, name), "w") as f:
                f.write(json.dumps({"uri": uri, **payload}))
        batch = file_io.join(
            self.req_dir,
            f"batch-{int(wall_clock() * 1e9):020d}-{uuid.uuid4().hex[:8]}")
        file_io.replace(stage, batch)

    def _flatten_batches(self, names: List[str]) -> List[str]:
        """Move the members of ``batch-*`` dirs into the spool, one atomic
        rename each (a racing consumer's loss is skipped), and return the
        claimable names."""
        out = [n for n in names if not n.startswith("batch-")]
        for bname in names:
            if not bname.startswith("batch-"):
                continue
            bdir = file_io.join(self.req_dir, bname)
            try:
                members = file_io.listdir(bdir, refresh=True)
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
                if not file_io.listdir(bdir, refresh=True):
                    file_io.rmtree(bdir)
            except OSError:
                pass
        return out

    def _listed(self, rank) -> List[str]:
        try:
            names = self._flatten_batches(
                file_io.listdir(self.req_dir, refresh=True))
        except FileNotFoundError:
            return []
        return sorted((n for n in names if not n.startswith(".")),
                      key=lambda n: (rank[self._lane_of_name(n)], n))

    @staticmethod
    def _read_raw(path: str) -> Optional[str]:
        try:
            with file_io.fopen(path, "rb") as f:
                return f.read().decode()
        except (OSError, ValueError):
            return None

    def _read_stamp(self, path: str) -> Optional[float]:
        """A marker's stamp (reap locks hold ``stamp:token``); None when
        it vanished (the claim completed) or is unreadable."""
        raw = self._read_raw(path)
        if raw is None:
            return None
        try:
            return float(raw.split(":")[0] or 0)
        except ValueError:
            return None

    def _reap_marker(self, marker: str) -> bool:
        """Take over a claim marker older than the lease. Only the
        exclusive-create winner of ``<marker>.reap`` may remove and
        recreate it; a reap lock older than two leases is cleared for a
        later pass. True when this consumer now holds the claim."""
        stamp = self._read_stamp(marker)
        if stamp is None or wall_clock() - stamp < self.claim_lease_s:
            return False
        reap_lock = marker + ".reap"
        token = f"{wall_clock()!r}:{uuid.uuid4().hex}"
        try:
            file_io.create_exclusive(reap_lock, token.encode())
        except OSError:
            lock_stamp = self._read_stamp(reap_lock)
            if (lock_stamp is not None
                    and wall_clock() - lock_stamp >= 2 * self.claim_lease_s):
                try:
                    file_io.remove(reap_lock)
                except OSError:
                    pass
            return False
        try:
            # re-validate under the lock: an earlier reaper's fresh claim
            # must survive
            stamp = self._read_stamp(marker)
            if stamp is None or wall_clock() - stamp < self.claim_lease_s:
                return False
            try:
                file_io.remove(marker)
            except OSError:
                pass
            try:
                file_io.create_exclusive(marker,
                                         repr(wall_clock()).encode())
            except OSError:
                return False  # a fresh consumer slipped in: it owns it
            return True
        finally:
            if self._read_raw(reap_lock) == token:  # still ours
                try:
                    file_io.remove(reap_lock)
                except OSError:
                    pass

    def _claim_one(self, name: str) -> Optional[str]:
        """Claim one request; the path to read it from, or None if another
        consumer won. Local: atomic rename into ``claimed/``. Remote: an
        exclusive-create marker in ``claimed/`` (a remote rename is a copy
        and delete), or the reaping of an expired one."""
        src = file_io.join(self.req_dir, name)
        if not file_io.is_remote(src):
            dst = file_io.join(self.claim_dir, name)
            try:
                file_io.replace(src, dst)
            except OSError:
                return None
            return dst
        marker = file_io.join(self.claim_dir, name + ".claim")
        try:
            file_io.create_exclusive(marker, repr(wall_clock()).encode())
        except OSError:
            if not self._reap_marker(marker):
                return None
        return src

    def _remove_claimed(self, name: str, path: str) -> None:
        """Clean up a consumed claim: the request first, the marker last
        (a marker removed first would let another consumer re-claim)."""
        cleanup = list(dict.fromkeys(
            (path, file_io.join(self.req_dir, name))))
        if file_io.is_remote(path):
            cleanup.append(file_io.join(self.claim_dir, name + ".claim"))
        for p in cleanup:
            try:
                file_io.remove(p)
            except OSError:
                pass

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
            self._remove_claimed(name, path)

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

    def trim(self, max_pending: int) -> int:
        names = self._listed(_SHED_RANK)
        dropped = 0
        for name in names[:max(0, len(names) - max_pending)]:
            try:
                file_io.remove(file_io.join(self.req_dir, name))
                dropped += 1
            except OSError:
                pass
        return dropped

    def pending_count(self) -> int:
        """Requests in the spool, members of published batch dirs
        included (read only: counting moves nothing)."""
        try:
            names = file_io.listdir(self.req_dir, refresh=True)
        except FileNotFoundError:
            return 0
        count = 0
        for n in names:
            if n.startswith("."):
                continue
            if not n.startswith("batch-"):
                count += 1
                continue
            try:
                count += sum(1 for m in file_io.listdir(
                    file_io.join(self.req_dir, n), refresh=True)
                    if not m.startswith("."))
            except OSError:
                pass
        return count

    @staticmethod
    def _result_key(uri: str) -> str:
        return hashlib.md5(uri.encode()).hexdigest()

    def put_result(self, uri: str, value: Dict[str, Any]) -> None:
        key = self._result_key(uri)
        # a temporary name of this writer's own: two writers of one uri
        # (a stream adopted from an instance that was only slow) must not
        # rename each other's file away
        tmp = file_io.join(self.res_dir,
                           f".{key}.{os.getpid()}-{threading.get_ident()}")
        with file_io.fopen(tmp, "w") as f:
            f.write(json.dumps({"uri": uri, **value}))
        file_io.replace(tmp, file_io.join(self.res_dir, key + ".json"))

    def get_result(self, uri: str) -> Optional[Dict[str, Any]]:
        path = file_io.join(self.res_dir, self._result_key(uri) + ".json")
        if not file_io.exists(path):
            return None
        with file_io.fopen(path) as f:
            return json.loads(f.read())

    def discard_result(self, uri: str) -> bool:
        try:
            file_io.remove(file_io.join(self.res_dir,
                                        self._result_key(uri) + ".json"))
            return True
        except OSError:
            return False

    def all_results(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for name in file_io.listdir(self.res_dir, refresh=True):
            if name.startswith("."):
                continue
            with file_io.fopen(file_io.join(self.res_dir, name)) as f:
                rec = json.loads(f.read())
            out[rec["uri"]] = rec
        return out


class RedisQueue(QueueBackend):
    """The reference wire contract: XADD to ``image_stream`` (and a sibling
    stream for each other criticality lane), consumer-group reads, results
    HSET at ``result:<uri>``. Delivery is at-least-once past a crash: an
    entry is XACKed only after its result lands, and :meth:`claim_batch`
    XAUTOCLAIMs entries idle past ``claim_lease_s``. Imports ``redis``
    only when no ``client`` is given."""

    STREAM = "image_stream"
    GROUP = "serving"
    #: a pending entry idle this long belongs to a consumer presumed dead
    CLAIM_LEASE_S = 60.0

    def __init__(self, host: str = "localhost", port: int = 6379,
                 claim_lease_s: Optional[float] = None, client=None,
                 stream: Optional[str] = None, group: Optional[str] = None):
        if client is None:
            import redis
            client = redis.StrictRedis(host=host, port=port, db=0)
        self.db = client
        if stream:
            self.STREAM = stream
        if group:
            self.GROUP = group
        # one consumer a server: XREADGROUP '>' hands each entry to one
        # consumer of the group
        self.consumer = f"consumer-{uuid.uuid4().hex[:12]}"
        self.claim_lease_s = (claim_lease_s if claim_lease_s is not None
                              else self.CLAIM_LEASE_S)
        self._lane_streams = {"critical": f"{self.STREAM}:crit",
                              "default": self.STREAM,
                              "sheddable": f"{self.STREAM}:shed"}
        # uri -> (stream, entry id): claimed, not answered yet
        self._unacked: Dict[str, Tuple[str, Any]] = {}
        for lane in CRITICALITY_LANES:
            try:
                self.db.xgroup_create(self._lane_streams[lane], self.GROUP,
                                      mkstream=True)
            except Exception:
                pass  # the group exists

    def enqueue(self, uri: str, payload: Dict[str, Any]) -> None:
        self.db.xadd(self._lane_streams[criticality_of(payload)],
                     {"uri": uri, "data": json.dumps(payload)})

    def enqueue_many(self, items: Sequence[Tuple[str, Dict[str, Any]]]
                     ) -> None:
        """One pipelined round trip a batch, in submission order."""
        items = list(items)
        if not items:
            return
        pipe = self.db.pipeline()
        for uri, payload in items:
            pipe.xadd(self._lane_streams[criticality_of(payload)],
                      {"uri": uri, "data": json.dumps(payload)})
        pipe.execute()

    def _reclaim_stale(self, stream: str, max_items: int) -> List:
        """XAUTOCLAIM entries idle past the lease (none where the server
        lacks the command)."""
        try:
            resp = self.db.xautoclaim(
                stream, self.GROUP, self.consumer,
                min_idle_time=int(self.claim_lease_s * 1000.0),
                count=max_items)
        except Exception:
            return []
        if isinstance(resp, (list, tuple)) and len(resp) >= 2:
            return list(resp[1] or [])
        return []

    def claim_batch(self, max_items: int) -> List[Tuple[str, Dict[str, Any]]]:
        out: List[Tuple[str, Dict[str, Any]]] = []
        for lane in CRITICALITY_LANES:
            room = max_items - len(out)
            if room <= 0:
                break
            stream = self._lane_streams[lane]
            entries = self._reclaim_stale(stream, room)
            if len(entries) < room:
                resp = self.db.xreadgroup(self.GROUP, self.consumer,
                                          {stream: ">"},
                                          count=room - len(entries),
                                          block=10)
                for _, fresh in resp or []:
                    entries.extend(fresh)
            for eid, fields in entries:
                uri = fields[b"uri"].decode()
                payload = json.loads(fields[b"data"].decode())
                out.append((uri, {"uri": uri, **payload}))
                self._unacked[uri] = (stream, eid)  # acked with its result
        return out

    def put_result(self, uri: str, value: Dict[str, Any]) -> None:
        self.db.hset(f"result:{uri}", mapping={
            k: json.dumps(v) for k, v in value.items()})
        claim = self._unacked.pop(uri, None)
        if claim is not None:
            stream, eid = claim
            self.db.xack(stream, self.GROUP, eid)

    def get_result(self, uri: str) -> Optional[Dict[str, Any]]:
        raw = self.db.hgetall(f"result:{uri}")
        if not raw:
            return None
        return {k.decode(): json.loads(v.decode()) for k, v in raw.items()}

    def discard_result(self, uri: str) -> bool:
        try:
            return bool(self.db.delete(f"result:{uri}"))
        except Exception:
            return False

    def _stream_pending(self, stream: str) -> int:
        """The group's undelivered lag where the server reports it, else
        XLEN."""
        try:
            for g in self.db.xinfo_groups(stream):
                if g.get("name") in (self.GROUP, self.GROUP.encode()):
                    lag = g.get("lag")
                    if lag is not None:
                        return int(lag)
        except Exception:
            pass
        try:
            return int(self.db.xlen(stream))
        except Exception:
            return 0

    def pending_count(self) -> int:
        return sum(self._stream_pending(self._lane_streams[lane])
                   for lane in CRITICALITY_LANES)

    def consumer_pending(self) -> Dict[str, int]:
        """Claimed-not-acked entries by consumer (XINFO CONSUMERS over the
        lane streams); ``{}`` where the server lacks the command."""
        out: Dict[str, int] = {}
        ok = False
        for lane in CRITICALITY_LANES:
            try:
                consumers = self.db.xinfo_consumers(
                    self._lane_streams[lane], self.GROUP)
            except Exception:
                continue
            ok = True
            for c in consumers:
                name = c.get("name")
                if isinstance(name, bytes):
                    name = name.decode()
                if name is not None:
                    out[str(name)] = (out.get(str(name), 0)
                                      + int(c.get("pending") or 0))
        return out if ok else {}

    def trim(self, max_pending: int) -> int:
        before = self.pending_count()
        excess = before - max_pending
        for lane in _SHED_ORDER:
            if excess <= 0:
                break
            stream = self._lane_streams[lane]
            depth = self._stream_pending(stream)
            cut = min(excess, depth)
            if cut > 0:
                self.db.xtrim(stream, maxlen=depth - cut)
                excess -= cut
        return max(0, before - self.pending_count())

    def shed(self, max_pending: int,
             reason: str = "shed: queue overloaded") -> List[str]:
        dropped: List[str] = []
        excess = self.pending_count() - max_pending
        for lane in _SHED_ORDER:
            while excess > 0:
                stream = self._lane_streams[lane]
                resp = self.db.xreadgroup(self.GROUP, self.consumer,
                                          {stream: ">"}, count=excess,
                                          block=10)
                entries = [e for _, es in resp or [] for e in es]
                if not entries:
                    break
                for eid, fields in entries:
                    uri = fields[b"uri"].decode()
                    self.put_result(uri,
                                    {"error": reason, "retriable": True})
                    self.db.xack(stream, self.GROUP, eid)
                    dropped.append(uri)
                excess -= len(entries)
        return dropped


def make_queue(src: str) -> QueueBackend:
    """``dir:///path``, a path or a ``scheme://`` URI -> FileQueue;
    ``host:port`` -> RedisQueue."""
    if src.startswith("dir://"):
        return FileQueue(src[len("dir://"):])
    if file_io.scheme_of(src) is not None:
        return FileQueue(src)
    if ":" in src and os.sep not in src.split(":")[0]:
        host, port = src.rsplit(":", 1)
        try:
            return RedisQueue(host, int(port))
        except ImportError as e:
            raise RuntimeError(
                f"queue src {src!r} needs the redis package; use a "
                f"dir:///path file queue instead") from e
    return FileQueue(src)


def encode_image(img) -> str:
    """ndarray (HWC) or encoded bytes -> base64 string: an array is
    encoded as jpg by ``cv2.imencode``, bytes pass through unencoded."""
    if isinstance(img, (bytes, bytearray)):
        return base64.b64encode(bytes(img)).decode()
    import cv2
    import numpy as np
    ok, buf = cv2.imencode(".jpg", np.asarray(img))
    if not ok:
        raise ValueError("image encode failed")
    return base64.b64encode(buf.tobytes()).decode()


def decode_image(b64: str):
    """base64 image payload -> HWC uint8 array in BGR order
    (``cv2.imdecode(..., IMREAD_COLOR)``)."""
    import cv2
    import numpy as np
    buf = np.frombuffer(base64.b64decode(b64), np.uint8)
    img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("image decode failed")
    return img
