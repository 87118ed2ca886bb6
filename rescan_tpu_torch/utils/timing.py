"""Stage wall-clock instrumentation.

The reference instruments every stage with ``msh_time_now`` pairs and prints
stage-prefixed log lines ("IO:", "POSE_PROPOSAL:", "GREEDY STEP:", ...;
SURVEY.md §5). We keep the same prefixes so existing log-scraping works,
and additionally accumulate a per-stage timing dict for benchmarking.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

STAGE_TIMINGS: Dict[str, float] = defaultdict(float)


@contextlib.contextmanager
def stage_timer(name: str, fmt: str | None = None, verbose: bool = True) -> Iterator[None]:
    """Time a block; accumulate under ``name``; optionally print ``fmt % secs``."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    STAGE_TIMINGS[name] += dt
    if verbose and fmt:
        print(fmt % dt)


def reset_timings() -> None:
    STAGE_TIMINGS.clear()
