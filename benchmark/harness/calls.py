"""The window of the trace kinds: calls back to back until ``--seconds``.

A call ends on the host with its answer read back (a frame, a float), so
the host clock follows the card.  The window closes when the first call
that ends past ``--seconds`` ends; the rate counts the rays of every call
completed in it over its whole length.  Calls drawn from the seed, and the
last, keep their answers for the comparison.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import common


def sampled(seed):
    """Call indices whose answers are kept: the first, one drawn from the
    seed among the first 64, and (added by the window) the last."""
    return {0, int(np.random.default_rng([seed, 1]).integers(1, 64))}


def window(cell, call, keep, light=lambda answer: answer):
    """Run ``call(i)`` for i = 0, 1, ... until ``cell.seconds`` have passed.
    Returns (t_open, t_close, calls, {i: answer}): the last call's answer
    whole, the other kept calls' as ``light`` reduces them (an answer that
    holds device memory is not held across later calls)."""
    kept = {}
    t_open = time.perf_counter()
    deadline = t_open + cell.seconds
    ends = [t_open]
    i = 0
    while True:
        answer = call(i)
        now = time.perf_counter()
        ends.append(now)
        if now >= deadline:
            kept[i] = answer
            took = 1e3 * np.diff(ends)
            common.log(f"call ms: median {np.median(took):.2f}, p10 {np.percentile(took, 10):.2f}, "
                       f"p90 {np.percentile(took, 90):.2f}, max {took.max():.2f}")
            return t_open, now, i + 1, kept
        if i in keep:
            kept[i] = light(answer)
        answer = None
        i += 1
