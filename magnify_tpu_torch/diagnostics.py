"""The package's logging channel.

One stdlib logger, ``magnify_tpu_torch``, so a host program can route the
package's warnings (the chip grid's sparse-edge warnings, for one). The
port's own copy of the logger of ``magnify_tpu.diagnostics``; the stage
timers and the profiler wrapper there have no counterpart here.
"""

from __future__ import annotations

import logging

__all__ = ["log"]

log = logging.getLogger("magnify_tpu_torch")
