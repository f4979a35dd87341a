"""What the metric readers share: a serving run's requests, tokens and gaps
inside its window.  A reader takes the run record a driver returned."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple


def in_window(run: Dict, t: float) -> bool:
    w0, w1 = run["window"]
    return w0 <= t <= w1


def window_tokens(run: Dict) -> Iterator[Tuple[Dict, int]]:
    """(request, index of the token) of every token handed to a client in
    the window; index 0 is the prefill's, the others a decode step's."""
    for r in run["requests"]:
        for k, t in enumerate(r["times"]):
            if in_window(run, t):
                yield r, k
