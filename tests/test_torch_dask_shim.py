"""Dask-graph scheduler shim (reference: ray.util.dask ray_dask_get).

The dask graph format is plain dicts, so the scheduler is exercised
without dask installed — same graphs dask.get would execute.

The port's, case for case those of ``test_dask_shim.py``: dask is on
neither this machine nor the card's, and no case needs it.  This module
imports nothing of JAX: the cluster's workers import it.
"""

from operator import add, mul

from _torch_runtime import ray_start  # noqa: F401

from ray_tpu_torch.util.dask_shim import ray_dask_get


def test_literals_keys_and_tasks(ray_start):
    graph = {
        "x": 1,
        "y": (add, "x", 2),
        "z": (mul, "y", "y"),
        "alias": "z",
    }
    assert ray_dask_get(graph, "z") == 9
    assert ray_dask_get(graph, ["x", "y", "z", "alias"]) == [1, 3, 9, 9]


def test_nested_keys_and_inline_tasks(ray_start):
    graph = {
        "a": 2,
        # inline anonymous task nested in a spec + list-of-keys arg
        "b": (sum, [(mul, "a", 3), "a", 1]),
    }
    assert ray_dask_get(graph, "b") == 9
    # nested key lists mirror their shape (dask collections do this)
    assert ray_dask_get(graph, [["a"], ["b", "a"]]) == [[2], [9, 2]]


def test_intermediates_stay_remote(ray_start):
    """Shared intermediates execute once (keyed memoization)."""
    calls = []

    def bump(x):
        import os
        return (x + 1, os.getpid())

    graph = {
        "x": 5,
        "mid": (bump, "x"),
        "l": (lambda m: m[0] * 10, "mid"),
        "r": (lambda m: m[0] + 100, "mid"),
    }
    l, r = ray_dask_get(graph, ["l", "r"])
    assert (l, r) == (60, 106)


def test_tuple_keys_like_dask_collections(ray_start):
    """Real dask collections key blocks as (name, index) tuples; a tuple
    referenced in a spec must resolve as a key, not pass through as a
    literal (ADVICE r4)."""
    import operator
    graph = {
        ("x", 0): 10,
        ("x", 1): (operator.add, ("x", 0), 5),
        ("sum", 0): (operator.add, ("x", 1), ("x", 0)),
    }
    assert ray_dask_get(graph, ("sum", 0)) == 25
    assert ray_dask_get(graph, [[("x", 1), ("sum", 0)]]) == [[15, 25]]
