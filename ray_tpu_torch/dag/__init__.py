"""Lazy task DAGs.

Design analog: reference ``python/ray/dag/`` — DAGNode (dag_node.py),
FunctionNode/InputNode built via ``fn.bind(...)``; the graph executes by
submitting the underlying tasks with parent outputs as ObjectRef args (so
the object store, not the driver, carries intermediate data).
"""

from ray_tpu_torch.dag.dag_node import (DAGNode, FunctionNode, InputNode,
                                  MultiOutputNode)

__all__ = ["DAGNode", "FunctionNode", "InputNode", "MultiOutputNode"]
