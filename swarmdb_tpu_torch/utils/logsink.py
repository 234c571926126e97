"""Production log sink: size-rotated, compressed, retention-bounded file
logging. A copy of ``swarmdb_tpu/utils/logsink.py``, on stdlib logging:

- ``LOG_FILE`` enables the sink (absent = console-only, unchanged).
- ``LOG_ROTATE_BYTES`` (default 10 MB) size-based rotation.
- ``LOG_BACKUP_COUNT`` (default 7) bounded retention — the oldest archive
  is deleted when the count is exceeded (the stdlib handler's own
  mechanism, equivalent to the reference's retention window).
- ``LOG_COMPRESS`` (default 1) gzips each rotated file.
"""

from __future__ import annotations

import gzip
import logging
import logging.handlers
import os
import shutil
from typing import Optional

DEFAULT_FORMAT = (
    "%(asctime)s | %(levelname)-8s | %(name)s:%(funcName)s:%(lineno)d "
    "- %(message)s"
)


class CompressedRotatingFileHandler(logging.handlers.RotatingFileHandler):
    """RotatingFileHandler whose archives are gzipped.

    Uses the documented namer/rotator hooks: archives are ``<file>.N.gz``
    and backupCount still bounds retention (rollover shifts .1.gz -> .2.gz
    etc. via the namer, so the stdlib deletion logic keeps working).
    """

    def __init__(self, *args, compress: bool = True, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if compress:
            self.namer = lambda name: name + ".gz"
            self.rotator = self._gzip_rotator

    @staticmethod
    def _gzip_rotator(source: str, dest: str) -> None:
        with open(source, "rb") as fin, gzip.open(dest, "wb") as fout:
            shutil.copyfileobj(fin, fout)
        os.remove(source)


def configure_logging(
    log_file: Optional[str] = None,
    *,
    level: Optional[str] = None,
    rotate_bytes: Optional[int] = None,
    backup_count: Optional[int] = None,
    compress: Optional[bool] = None,
    fmt: str = DEFAULT_FORMAT,
) -> Optional[logging.Handler]:
    """Configure root logging; returns the file handler if one was added.

    Explicit arguments win over the LOG_* env vars; everything defaults to
    the reference deployment's values (10 MB / 7 archives / compressed).
    """
    level = level or os.environ.get("LOG_LEVEL", "INFO")
    logging.basicConfig(level=level)
    # basicConfig is a no-op when handlers already exist (embedding apps,
    # pytest): still honor the requested level
    logging.getLogger().setLevel(level)
    log_file = log_file or os.environ.get("LOG_FILE")
    if not log_file:
        return None
    if rotate_bytes is None:
        rotate_bytes = int(os.environ.get("LOG_ROTATE_BYTES",
                                          str(10 * 1024 * 1024)))
    if backup_count is None:
        backup_count = int(os.environ.get("LOG_BACKUP_COUNT", "7"))
    if compress is None:
        compress = os.environ.get("LOG_COMPRESS", "1") == "1"
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    handler = CompressedRotatingFileHandler(
        log_file, maxBytes=rotate_bytes, backupCount=backup_count,
        compress=compress,
    )
    handler.setFormatter(logging.Formatter(fmt))
    handler.setLevel(level)
    logging.getLogger().addHandler(handler)
    return handler
