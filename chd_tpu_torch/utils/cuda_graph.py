"""CUDA-graph replay of fixed-shape solver steps.

The kinematic solvers run hundreds of identical iterations, each thousands
of small kernels launched from Python. A step with fixed shapes and no host
sync can be captured once into a ``torch.cuda.CUDAGraph`` and replayed: the
same kernels on the same inputs, launched by one call, as ``jax.jit``
launches ``chd_tpu``'s whole loop. The eager path stays; a caller opts in by
creating a ``GraphCache`` and passing it to the solver, and reuses it across
calls so each step shape is captured once.

Each capture is the span ``graphs.capture`` of ``utils.profiling`` (warm-up
and capture), whose attributes ``kernel_nodes`` and ``copy_nodes`` count
the graph's kernels and copies.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from .profiling import span

Step = Callable[[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]], Tuple[torch.Tensor, ...]]


class _Entry:
    def __init__(self, graph, state, args):
        self.graph = graph
        self.state = state  # static state tensors: read and written by each replay
        self.args = args    # static argument tensors: read by each replay


class GraphCache:
    """Captured steps, keyed by what fixes their kernels (the caller's key:
    the step's function, config and shapes)."""

    def __init__(self):
        self.entries: Dict[Hashable, _Entry] = {}
        self.constants: Dict[Hashable, Any] = {}
        self.captures = 0

    def constant(self, key: Hashable, make: Callable[[], Any]) -> Any:
        """``make()``, once per key: device constants that captured steps
        read (index tensors, masks) live as long as the cache and its
        graphs, and the same objects serve every later call."""
        if key not in self.constants:
            self.constants[key] = make()
        return self.constants[key]

    def run(self, key: Hashable, step: Step, state: Sequence[torch.Tensor],
            args: Sequence[torch.Tensor], iters: int) -> Tuple[torch.Tensor, ...]:
        """``iters`` times ``state = step(state, args)``, by graph replay.

        ``step`` must launch the same kernels for every input of these
        shapes, sync nothing with the host and copy nothing from it. Returns
        fresh tensors holding the final state."""
        entry = self.entries.get(key)
        if entry is None:
            entry = self._capture(step, state, args)
            self.entries[key] = entry
        for s, v in zip(entry.state, state):
            s.copy_(v)
        for a, v in zip(entry.args, args):
            a.copy_(v)
        for _ in range(iters):
            entry.graph.replay()
        return tuple(s.clone() for s in entry.state)

    def _capture(self, step: Step, state, args) -> _Entry:
        with span("graphs.capture") as sp:
            static_state = tuple(s.clone() for s in state)
            static_args = tuple(a.clone() for a in args)
            # warm up on a side stream (lazy initialisation of handles and
            # workspaces must not land in the capture), on copies of the state
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(tuple(s.clone() for s in static_state), static_args)
            torch.cuda.current_stream().wait_stream(side)
            # the graph is kept past its capture to count its nodes
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                new = step(static_state, static_args)
                for s, n in zip(static_state, new):
                    s.copy_(n)
            sp.attrs["kernel_nodes"], sp.attrs["copy_nodes"] = node_counts(
                graph.raw_cuda_graph())
            graph.instantiate()
        self.captures += 1
        return _Entry(graph, static_state, static_args)


def graphs_for(device, graphs: Optional[GraphCache]) -> Optional[GraphCache]:
    """The cache a solve on ``device`` replays through: ``graphs`` where
    given, else a fresh one on CUDA and None (eager) elsewhere."""
    if graphs is None and torch.device(device).type == "cuda":
        return GraphCache()
    return graphs


def constant(graphs: Optional[GraphCache], key: Hashable, make: Callable[[], Any]) -> Any:
    """``graphs.constant(key, make)``, or ``make()`` without a cache."""
    return make() if graphs is None else graphs.constant(key, make)


_CU_GRAPH_NODE_TYPE_KERNEL, _CU_GRAPH_NODE_TYPE_MEMCPY = 0, 1


def node_counts(raw_graph: int) -> Tuple[int, int]:
    """(kernel nodes, copy nodes) of a captured ``cudaGraph_t`` (the top
    level of ``CUDAGraph.raw_cuda_graph()``). A replay launches the kernels,
    and runs each device-to-device copy node as a copy kernel of the
    driver's own. Counted through the CUDA driver the process has loaded,
    whose ``CUgraph`` a runtime graph is."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphGetNodes.restype = cu.cuGraphNodeGetType.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    _cu_check(cu.cuGraphGetNodes(raw_graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu_check(cu.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind = ctypes.c_int(-1)
    kernels = copies = 0
    for node in nodes[:n.value]:
        _cu_check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        kernels += kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
        copies += kind.value == _CU_GRAPH_NODE_TYPE_MEMCPY
    return kernels, copies


def _cu_check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA driver error {err}")
