"""DAG node types and execution.

Design analog: reference ``python/ray/dag/dag_node.py`` (DAGNode),
``function_node.py`` (FunctionNode), ``input_node.py`` (InputNode).
``fn.bind(*args)`` builds the graph; ``node.execute(input)`` submits every
task with parent ObjectRefs as arguments — intermediates never touch the
driver.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """A lazily-bound computation; children are found in args/kwargs."""

    def __init__(self, args: Tuple, kwargs: Dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal --------------------------------------------------------

    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def topo_order(self) -> List["DAGNode"]:
        """Children-before-parents order over the reachable graph."""
        seen: Dict[int, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for c in node._children():
                visit(c)
            order.append(node)

        visit(self)
        return order

    # -- execution --------------------------------------------------------

    def execute(self, *input_args, **input_kwargs):
        """Submit the whole graph; returns this node's result handle
        (an ObjectRef for FunctionNode, a list for MultiOutputNode)."""
        resolved: Dict[int, Any] = {}
        for node in self.topo_order():
            resolved[id(node)] = node._execute_self(resolved, input_args,
                                                    input_kwargs)
        return resolved[id(self)]

    def _resolve(self, value, resolved):
        return resolved[id(value)] if isinstance(value, DAGNode) else value

    def _execute_self(self, resolved, input_args, input_kwargs):
        raise NotImplementedError


class InputNode(DAGNode):
    """Placeholder for execute()-time input (reference input_node.py).

    Usable as a context manager for parity with the reference's
    ``with InputNode() as x:`` idiom."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_self(self, resolved, input_args, input_kwargs):
        if input_kwargs:
            raise TypeError("InputNode takes a single positional input")
        if len(input_args) != 1:
            raise TypeError(
                f"dag.execute() takes exactly one input for InputNode "
                f"(got {len(input_args)})")
        return input_args[0]


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args: Tuple, kwargs: Dict):
        super().__init__(args, kwargs)
        self._fn = remote_function

    @property
    def name(self) -> str:
        return getattr(self._fn, "__name__",
                       getattr(self._fn, "_name", "fn"))

    def _execute_self(self, resolved, input_args, input_kwargs):
        args = [self._resolve(a, resolved) for a in self._bound_args]
        kwargs = {k: self._resolve(v, resolved)
                  for k, v in self._bound_kwargs.items()}
        return self._fn.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several leaves as one executable (reference
    multi_output_node); execute() returns their handles as a list."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_self(self, resolved, input_args, input_kwargs):
        return [self._resolve(a, resolved) for a in self._bound_args]
