"""CUDA graphs in the port; no other module captures one. ``StaticGraph``
replays a function over static inputs for both owners: a task's control
step (``envs/base.py::GraphedStep``) and PQL's learner phases
(``algos/base.py::PhaseGraphs``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc

import torch

from pql_tpu_torch.ops import kernels
from pql_tpu_torch.utils import trace


@contextlib.contextmanager
def collected_gc():
    """Collect garbage now and none in the block (a graph capture): a dead
    reference cycle that holds a CUDA graph, collected while a stream
    captures, destroys that graph mid-capture and invalidates the capture
    ("operation not permitted when stream is capturing"); torch.cuda.graph
    collects nothing first."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@functools.cache
def _libcuda():
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphNodeGetType.restype = ctypes.c_int
    return cuda


def graph_kernel_nodes(graph) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a captured ``torch.cuda.CUDAGraph`` made
    with ``keep_graph=True``, counted by libcuda (cuGraphGetNodes,
    cuGraphNodeGetType): the kernel launches of one replay. A profile of an
    eager step of ~100k launches may lose kernel records (62,491 of 99,948
    in one run), a count of the graph's nodes does not."""
    cuda = _libcuda()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed to count the graph's nodes")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, ctypes.cast(nodes, ctypes.c_void_p), ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed to list the graph's nodes")
    kind, kernel_nodes = ctypes.c_int(), 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernel_nodes += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernel_nodes, n.value


def _tree_map(f, x):
    """``x``, a tensor or dicts, tuples and lists of them, with ``f`` applied to each tensor."""
    if isinstance(x, dict):
        return {k: _tree_map(f, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(f, v) for v in x)
    return f(x) if isinstance(x, torch.Tensor) else x


def _leaves(x) -> list[torch.Tensor]:
    """The tensors of ``x``, each dict's in the order of its sorted keys, so
    that two nests with the same keys line up whatever their insertion order."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def side_stream(device: torch.device, fn, *args):
    """``fn(*args)`` run eagerly on a side stream of ``device``, as the first
    run of work that a graph will capture must be (lazily made handles and
    pools); the current stream waits for it, and the output's tensors are
    marked in use there. Off CUDA just ``fn(*args)``."""
    if device.type != "cuda":
        return fn(*args)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn(*args)
    main.wait_stream(side)
    for x in _leaves(out):
        x.record_stream(main)
    return out


def capture_graph(fn, device: torch.device, captured=contextlib.nullcontext(),
                  instantiated=contextlib.nullcontext()):
    """``fn()`` captured in a CUDA graph on ``device`` (inside the context
    ``captured``, such as a tracer span), not run, then instantiated (inside
    ``instantiated``): (the graph, fn's output, the graph's kernel nodes as
    libcuda counts them)."""
    with torch.cuda.device(device):
        with captured:
            graph = torch.cuda.CUDAGraph(keep_graph=True)  # instantiated apart, to be timed; its nodes stay countable
            with collected_gc(), torch.cuda.graph(graph):
                out = fn()
        with instantiated:
            graph.instantiate()
    return graph, out, graph_kernel_nodes(graph)[0]


def _take_back(counts: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    """What ``counts`` gained since it read ``before``, taken back out of it."""
    made = {k: n - before.get(k, 0) for k, n in counts.items() if n != before.get(k, 0)}
    counts.clear()
    counts.update(before)
    return made


class StaticGraph:
    """``fn(*inputs)`` captured once as a CUDA graph over static copies of
    ``inputs`` (tensors, or dicts, tuples and lists of them). Each call
    checks the inputs' nesting and shapes, copies them in, replays, and
    returns clones of fn's outputs, so none aliases a buffer the next replay
    overwrites. All else fn touches (parameters, optimizer state, a ring) is
    read in place and must keep its storage; fn must not sync with the host.
    The capture runs fn's Python but no kernel, so the launches the kernels'
    wrappers count during it (``kernels.LAUNCHES``, the tracer's counters)
    are taken back (``launches``, ``counts``) and made by each replay.

    The tracer: counters ``<layer>.graph_captures`` at the capture and
    ``<layer>.graph_replays`` and ``<layer>.graph_kernels`` (``kernels``, the
    graph's kernel nodes) at each call; spans ``<layer>.graph_in`` and
    ``<layer>.graph_replay`` of each call. The owner names the other spans
    (None: not made): ``warmup`` runs fn once eagerly off the capture, then
    synchronizes (without one, fn has run on a side stream already);
    ``capture`` holds the capture, and the instantiation too unless
    ``instantiate`` names a span of its own for it; ``out`` the clones.
    ``build_s``: the set-up spans' host seconds by keyword, None with the
    tracer off."""

    def __init__(self, fn, inputs: tuple, layer: str, *, warmup: str | None = None, capture: str,
                 instantiate: str | None = None, out: str | None = None):
        static = _tree_map(torch.Tensor.clone, inputs)
        self.buffers = _leaves(static)
        self.shapes = _tree_map(lambda x: x.shape, inputs)
        self.layer, self.out_span = layer, out
        device = self.buffers[0].device
        named = dict(warmup=warmup, capture=capture, instantiate=instantiate)
        spans = {k: trace.span(name) for k, name in named.items() if name is not None}
        if warmup is not None:
            with spans["warmup"]:
                side_stream(device, fn, *static)
                torch.cuda.synchronize(device)
        launched, counted = dict(kernels.LAUNCHES), dict(trace.counters())
        none = contextlib.nullcontext()
        outer, inner = ((spans["capture"], (none, none)) if instantiate is None  # one span over both
                        else (none, (spans["capture"], spans["instantiate"])))
        with outer:
            self.graph, self.out, self.kernels = capture_graph(lambda: fn(*static), device, *inner)
        self.launches = _take_back(kernels.LAUNCHES, launched)
        self.counts = _take_back(trace.counters(), counted)
        self.build_s = {k: span.seconds for k, span in spans.items()}
        trace.count(f"{layer}.graph_captures")

    def __call__(self, *inputs):
        with trace.span(f"{self.layer}.graph_in"):
            shapes = _tree_map(lambda x: x.shape, inputs)
            if shapes != self.shapes:
                raise ValueError(f"graph inputs {shapes}, captured as {self.shapes}")
            for buf, x in zip(self.buffers, _leaves(inputs)):
                buf.copy_(x)
        with trace.span(f"{self.layer}.graph_replay"):
            self.graph.replay()
        for name, n in self.launches.items():
            kernels.LAUNCHES[name] += n
        for name, n in self.counts.items():
            trace.count(name, n)
        trace.count(f"{self.layer}.graph_replays")
        trace.count(f"{self.layer}.graph_kernels", self.kernels)
        with trace.span(self.out_span) if self.out_span is not None else contextlib.nullcontext():
            return _tree_map(torch.Tensor.clone, self.out)
