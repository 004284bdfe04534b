"""The program's own spans in a traced window: torch.profiler ranges the
port opens around each stage of its entry paths and each kernel wrapper
(feat3dnet_tpu_torch/utils/profiling.py), named `f3d.<path>.<stage>`, or
`f3d.<path>.<stage>#<id>` where the span carries a unit, request or step
id. A reader finds nothing, and gives None, in a program without them."""
from __future__ import annotations

from typing import List, Optional


def base(name: str) -> str:
    """A span's name without its id."""
    return name.split("#", 1)[0]


def durations_ms(trace, match) -> List[float]:
    """Milliseconds of each host span of `trace` whose name (less its id)
    `match(name)` accepts, on every recorded thread."""
    return [(b - a) * 1e-3 for a, b, n in trace.host if match(base(n))]


def mean_ms(trace, name: str) -> Optional[float]:
    """The mean duration of the span `name`; None where it did not occur."""
    d = durations_ms(trace, lambda n: n == name)
    return sum(d) / len(d) if d else None


def per_unit_ms(trace, match, units: int) -> Optional[float]:
    """The spans `match` accepts, their total over `units`; None where none
    occurred or no unit was done."""
    d = durations_ms(trace, match)
    return sum(d) / units if d and units else None
