"""Named daemon threads whose crash is logged, never silent.

The subset of the JAX package's ``utils/threads.py`` that the worker's
cluster loops need: ``spawn`` starts a daemon thread whose top-level
handler logs the traceback of an uncaught exception. The loops it runs
catch their own per-tick errors, so a crash that reaches it is a bug.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Tuple

logger = logging.getLogger(__name__)


def spawn(root: str, target: Callable[..., Any],
          args: Tuple = ()) -> threading.Thread:
    """A started daemon thread named ``root`` running ``target(*args)``;
    a crash is logged with its traceback."""

    def run() -> None:
        try:
            target(*args)
        except Exception:  # noqa: BLE001 — logged, never silent
            logger.exception("thread %r crashed", root)

    t = threading.Thread(target=run, name=root, daemon=True)
    t.start()
    return t
