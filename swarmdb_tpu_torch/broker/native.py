"""NativeBroker — ctypes binding over the C++ partitioned log engine.

A copy of ``swarmdb_tpu/broker/native.py`` over the port's own copy of the
engine, ``broker/cpp/broker.cpp``: the same ``Broker`` ABC as
``LocalBroker``, the same on-disk segment format and the same fetch buffer
layout (``_REC_HDR``), so a log directory written by either package opens
in the other. Durable partitioned logs, consumer-group offsets, retention
and blocking consumption, with no external brokers.

The library is built at first use with the JAX package's Makefile flags,

    g++ -O2 -std=c++17 -fPIC -shared -pthread -o _build/libswarmbroker-<hash>.so broker/cpp/broker.cpp

into ``swarmdb_tpu_torch/_build/`` (never into the source folder). The
name carries a hash of the source and flags, so an edited ``broker.cpp``
never loads a stale library. Several processes may start the first build
together (pytest-xdist workers): the build runs under a file lock into a
temporary name and ``os.replace`` puts it in place. ``SWARMDB_BROKER_LIB``
names a prebuilt library (a ThreadSanitizer build, say) that is loaded as
it is, with no build.

One deliberate difference from the JAX engine: topic names that start
with ``__`` are accepted except the offsets log's own ``__offsets__``
prefix, so the HA epoch topic (``__swarmdb_ha``, ``broker/replica.py``)
can live in a native log. The JAX engine refuses every ``__`` name, and an
HA node over it dies at its first promotion (ROADMAP.md queue 3). A JAX
engine opening a port log skips the ``__swarmdb_ha`` folder and reads
every other topic.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import logging
import os
import struct
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..utils.sync import make_lock
from .base import Broker, BrokerError, Record, TopicMeta, UnknownTopicError

logger = logging.getLogger("swarmdb_tpu_torch.broker")

SOURCE = Path(__file__).resolve().parent / "cpp" / "broker.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: ``swarmdb_tpu/broker/cpp/Makefile``'s flags (less its warnings)
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_REC_HDR = struct.Struct("<qdii")  # offset, ts, key_len, val_len

_build_lock = make_lock("broker.native._build_lock")
# swarmlint: guarded-by[_build_lock]: _build_state
_build_state: Dict[str, Optional[bool]] = {"ok": None}


def library_path() -> Path:
    """Where the library for this source and these flags lives: a
    prebuilt ``SWARMDB_BROKER_LIB``, else ``_build/libswarmbroker-<hash>.so``."""
    override = os.environ.get("SWARMDB_BROKER_LIB")
    if override:
        return Path(override)
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libswarmbroker-{h.hexdigest()[:12]}.so"


def _compile(out: Path) -> None:
    """Build ``out`` under a file lock shared by every process of this
    checkout: the winner compiles into a private name and renames it in
    place, the others wait and find it there."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libswarmbroker.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
               str(SOURCE)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True,
                           timeout=300)
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()


def build_native() -> bool:
    """Build the library if it is missing; True if it is now present.
    A prebuilt ``SWARMDB_BROKER_LIB`` is never built. A failed build (no
    compiler) is logged once per process and remembered."""
    out = library_path()
    if out.exists():
        return True
    if os.environ.get("SWARMDB_BROKER_LIB"):
        return False
    with _build_lock:
        if _build_state["ok"] is False:
            return False
        try:
            _compile(out)
        except (OSError, subprocess.SubprocessError) as exc:
            detail = getattr(exc, "stderr", "") or ""
            logger.warning("native broker build failed: %s %s", exc, detail)
            _build_state["ok"] = False
            return False
        _build_state["ok"] = True
        return True


def native_available(autobuild: bool = True) -> bool:
    if autobuild:
        return build_native()
    return library_path().exists()


_libs: Dict[str, ctypes.CDLL] = {}


def _load() -> ctypes.CDLL:
    path = str(library_path())
    lib = _libs.get(path)
    if lib is not None:
        return lib
    if not native_available():
        raise ImportError(
            f"the native broker library {path} could not be built "
            "(is a C++17 compiler on PATH? set CXX to name one)")
    lib = ctypes.CDLL(path)
    c = ctypes.c_char_p
    lib.swb_open.restype = ctypes.c_void_p
    lib.swb_open.argtypes = [c]
    lib.swb_open2.restype = ctypes.c_void_p
    lib.swb_open2.argtypes = [c, ctypes.c_int]
    lib.swb_durable_offset.restype = ctypes.c_longlong
    lib.swb_durable_offset.argtypes = [ctypes.c_void_p, c, ctypes.c_int]
    lib.swb_wait_durable.restype = ctypes.c_int
    lib.swb_wait_durable.argtypes = [ctypes.c_void_p, c, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_double]
    lib.swb_shutdown.argtypes = [ctypes.c_void_p]
    lib.swb_create_topic.restype = ctypes.c_int
    lib.swb_create_topic.argtypes = [ctypes.c_void_p, c, ctypes.c_int,
                                     ctypes.c_longlong]
    lib.swb_list_topics_json.restype = ctypes.POINTER(ctypes.c_char)
    lib.swb_list_topics_json.argtypes = [ctypes.c_void_p]
    lib.swb_free_buf.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.swb_create_partitions.restype = ctypes.c_int
    lib.swb_create_partitions.argtypes = [ctypes.c_void_p, c, ctypes.c_int]
    lib.swb_append.restype = ctypes.c_longlong
    lib.swb_append.argtypes = [ctypes.c_void_p, c, ctypes.c_int, c,
                               ctypes.c_int, c, ctypes.c_int, ctypes.c_double]
    lib.swb_fetch.restype = ctypes.c_longlong
    lib.swb_fetch.argtypes = [ctypes.c_void_p, c, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_uint8),
                              ctypes.c_longlong,
                              ctypes.POINTER(ctypes.c_int)]
    lib.swb_end_offset.restype = ctypes.c_longlong
    lib.swb_end_offset.argtypes = [ctypes.c_void_p, c, ctypes.c_int]
    lib.swb_begin_offset.restype = ctypes.c_longlong
    lib.swb_begin_offset.argtypes = [ctypes.c_void_p, c, ctypes.c_int]
    lib.swb_wait_for_data.restype = ctypes.c_int
    lib.swb_wait_for_data.argtypes = [ctypes.c_void_p, c, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_double]
    lib.swb_commit_offset.argtypes = [ctypes.c_void_p, c, c, ctypes.c_int,
                                      ctypes.c_longlong]
    lib.swb_committed_offset.restype = ctypes.c_longlong
    lib.swb_committed_offset.argtypes = [ctypes.c_void_p, c, c, ctypes.c_int]
    lib.swb_trim_older_than.restype = ctypes.c_longlong
    lib.swb_trim_older_than.argtypes = [ctypes.c_void_p, c, ctypes.c_double]
    lib.swb_flush.argtypes = [ctypes.c_void_p]
    # two threads loading at once bind the same handle twice: harmless
    return _libs.setdefault(path, lib)


class NativeBroker(Broker):
    """Durable partitioned-log broker backed by the C++ engine."""

    def __init__(self, log_dir: Optional[str] = None,
                 sync_interval_ms: int = 5) -> None:
        self._lib = _load()
        if log_dir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="swarmbroker_")
            log_dir = self._tmp.name
        else:
            self._tmp = None
            os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._h = self._lib.swb_open2(log_dir.encode(), sync_interval_ms)
        if not self._h:
            raise BrokerError(f"swb_open failed for {log_dir}")
        self._fetch_cap = 1 << 18
        self._fetch_bufs = threading.local()  # reused per thread, no memset
        self._closed = False

    # -- admin ---------------------------------------------------------------

    def create_topic(self, name: str, num_partitions: int,
                     retention_ms: int = 7 * 24 * 3600 * 1000) -> bool:
        r = self._lib.swb_create_topic(
            self._h, name.encode(), num_partitions, retention_ms
        )
        if r < 0:
            raise BrokerError(f"create_topic({name}) failed")
        return r == 1

    def list_topics(self) -> Dict[str, TopicMeta]:
        p = self._lib.swb_list_topics_json(self._h)
        try:
            raw = ctypes.cast(p, ctypes.c_char_p).value or b"{}"
        finally:
            self._lib.swb_free_buf(p)
        return {
            name: TopicMeta(name, nparts, ret)
            for name, (nparts, ret) in json.loads(raw.decode()).items()
        }

    def create_partitions(self, name: str, new_total: int) -> None:
        if self._lib.swb_create_partitions(self._h, name.encode(), new_total) < 0:
            raise UnknownTopicError(name)

    # -- data plane ----------------------------------------------------------

    def append(self, topic: str, partition: int, value: bytes,
               key: Optional[bytes] = None,
               timestamp: Optional[float] = None) -> int:
        off = self._lib.swb_append(
            self._h, topic.encode(), partition,
            key, -1 if key is None else len(key),
            value, len(value),
            timestamp if timestamp is not None else time.time(),
        )
        if off < 0:
            raise UnknownTopicError(f"{topic}[{partition}]")
        return int(off)

    def _fetch_buf(self) -> "np.ndarray":
        """Per-thread reusable buffer (np.empty: no zero-fill, unlike a
        fresh ctypes array, which would memset ~1 MB per message)."""
        buf = getattr(self._fetch_bufs, "buf", None)
        if buf is None or buf.nbytes < self._fetch_cap:
            buf = np.empty(self._fetch_cap, np.uint8)
            self._fetch_bufs.buf = buf
        return buf

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int = 256) -> List[Record]:
        while True:
            buf = self._fetch_buf()
            count = ctypes.c_int(0)
            n = self._lib.swb_fetch(
                self._h, topic.encode(), partition, offset, max_records,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                buf.nbytes, ctypes.byref(count),
            )
            if n == -1:
                raise UnknownTopicError(f"{topic}[{partition}]")
            if n < -1:  # first record needs -n bytes
                self._fetch_cap = max(self._fetch_cap * 2, int(-n))
                continue
            break
        out: List[Record] = []
        raw = buf[: int(n)].tobytes()
        pos = 0
        for _ in range(count.value):
            off, ts, klen, vlen = _REC_HDR.unpack_from(raw, pos)
            pos += _REC_HDR.size
            key = None
            if klen >= 0:
                key = raw[pos: pos + klen]
                pos += klen
            value = raw[pos: pos + vlen]
            pos += vlen
            out.append(Record(topic, partition, off, key, value, ts))
        return out

    def end_offset(self, topic: str, partition: int) -> int:
        off = self._lib.swb_end_offset(self._h, topic.encode(), partition)
        if off < 0:
            raise UnknownTopicError(f"{topic}[{partition}]")
        return int(off)

    def begin_offset(self, topic: str, partition: int) -> int:
        off = self._lib.swb_begin_offset(self._h, topic.encode(), partition)
        if off < 0:
            raise UnknownTopicError(f"{topic}[{partition}]")
        return int(off)

    def wait_for_data(self, topic: str, partition: int, offset: int,
                      timeout_s: float) -> bool:
        return self._lib.swb_wait_for_data(
            self._h, topic.encode(), partition, offset, timeout_s
        ) == 1

    # -- consumer-group offsets ---------------------------------------------

    def commit_offset(self, group: str, topic: str, partition: int,
                      offset: int) -> None:
        self._lib.swb_commit_offset(
            self._h, group.encode(), topic.encode(), partition, offset
        )

    def committed_offset(self, group: str, topic: str,
                         partition: int) -> Optional[int]:
        off = self._lib.swb_committed_offset(
            self._h, group.encode(), topic.encode(), partition
        )
        return None if off < 0 else int(off)

    # -- retention / durability ---------------------------------------------

    def _check_open(self) -> None:
        if self._closed or self._h is None:
            raise BrokerError("broker is closed")

    def durable_offset(self, topic: str, partition: int) -> int:
        self._check_open()
        off = self._lib.swb_durable_offset(self._h, topic.encode(), partition)
        if off == -2:
            # poisoned by a failed fsync: records can never become durable
            raise BrokerError(
                f"{topic}[{partition}]: partition poisoned by fsync failure"
            )
        if off < 0:
            raise UnknownTopicError(f"{topic}[{partition}]")
        return int(off)

    def wait_durable(self, topic: str, partition: int, offset: int,
                     timeout_s: float) -> bool:
        self._check_open()
        return self._lib.swb_wait_durable(
            self._h, topic.encode(), partition, offset, timeout_s
        ) == 1

    def trim_older_than(self, topic: str, cutoff_ts: float) -> int:
        n = self._lib.swb_trim_older_than(self._h, topic.encode(), cutoff_ts)
        if n < 0:
            raise UnknownTopicError(topic)
        return int(n)

    def flush(self) -> None:
        self._lib.swb_flush(self._h)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._lib.swb_flush(self._h)
        self._lib.swb_shutdown(self._h)
        self._h = None
        if self._tmp is not None:
            self._tmp.cleanup()
