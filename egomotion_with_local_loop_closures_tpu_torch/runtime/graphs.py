"""Captured CUDA graphs of the frame steps: the port's counterpart of the
JAX package's ``jax.jit`` over ``runtime/pipeline.py::process_interval``.

The JAX package runs a keyframe interval as one compiled XLA program.  On
CUDA the counterpart is a captured graph: a frame step's ~24k kernel
launches are recorded once and replayed by one call, so the host no longer
dispatches them one by one.  :func:`run_step` keeps a per-process cache of
captured ``torch.cuda.CUDAGraph`` objects, one for each step function
(``pipeline._track_refine_step``, ``pipeline._keyframe_step``) and key
``(cfg, replay, init_rotation given, the state's structure, shapes and
dtypes, device)``; the shapes carry the video axis of a batched state
and H, W.  ``cfg`` decides the loop window (``_needs_window``) and the
iteration counts, so it is part of the key as a whole.  All graphs of
one device and video axis share one memory pool, whatever their key (the
loop window's, the replay's and the plain steps of LC mode): a replay's
outputs are cloned out before any other graph replays, so a later capture
may reuse what an earlier one freed.

A capture follows PyTorch's recipe: the step runs once eagerly on a side
stream (lazy initialisations: cuBLAS and cuSOLVER handles and workspaces,
K3's library), then is captured on that stream under ``torch.cuda.graph``
from static copies of its inputs.  A replay

- copies the caller's state tensors, the frame and the rotation, if any,
  into the static inputs;
- replays the graph on the current stream;
- clones every output out of the pool (an output that is a static input
  returns the caller's own tensor, which holds the same values): callers
  keep old states and snapshots (the loop window, LC mode's batch records,
  recovery, checkpoints), and the next replay overwrites the pool.

Nothing is read back to the host.  The step bodies launch the same kernels
in the same order as when they run eagerly, and no step sums with a float
atomic (the keyframe step's propagate merges in a fixed order,
``ops/propagate_kernel.py``), so a replay gives the eager step's bits.

The launch counts of the port's hand-written kernels, K3
(``ops/reg_kernel.launches``), K1 (``ops/gn_kernel.launches``), K2
(``ops/stereo_kernel.launches``) and propagate's merge
(``ops/propagate_kernel.launches``): the warm-up's launches are counted
apart (each module's ``warmup_launches``), and the capture's wrapper
calls, which launch nothing, are counted only to check the graph: its
kernel nodes of these, found by their functions' names, must be as
many, wrapper by wrapper.  Each replay adds those nodes
to ``launches``, so the counts are the launches of the replays, as on the
eager path.

A failed capture or replay raises: nothing falls back to running the step
eagerly on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch.ops import (
    gn_kernel, propagate_kernel, reg_kernel, stereo_kernel)

# the modules of the hand-written kernels whose launches a graph counts,
# by the name of the kernel: K3, K1, K2 and propagate's merge
_KERNELS = {"k3": reg_kernel, "k1": gn_kernel, "k2": stereo_kernel,
            "merge": propagate_kernel}

# CUgraphNodeType values of libcuda's graph API
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


class _KernelNodeParams(ctypes.Structure):
    """libcuda's CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def tree_flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """The tensors of a tree of dataclasses, tuples (named or not) and
    None, depth first, and a hashable spec to rebuild it."""
    leaves: List[torch.Tensor] = []
    return leaves, _spec(tree, leaves)


def _spec(node, leaves: List[torch.Tensor]):
    # module-level recursion: a recursive closure would make a reference
    # cycle holding the leaves until the garbage collector runs
    if isinstance(node, torch.Tensor):
        leaves.append(node)
        return None
    if node is None:
        return "none"
    if isinstance(node, tuple):
        return (type(node), None, tuple(_spec(c, leaves) for c in node))
    names = tuple(f.name for f in dataclasses.fields(node))
    return (type(node), names,
            tuple(_spec(getattr(node, n), leaves) for n in names))


def tree_unflatten(spec, leaves: List[torch.Tensor]):
    return _build(spec, iter(leaves))


def _build(spec, leaves: Iterator[torch.Tensor]):
    if spec is None:
        return next(leaves)
    if spec == "none":
        return None
    typ, names, children = spec
    built = [_build(c, leaves) for c in children]
    if names is not None:
        return typ(**dict(zip(names, built)))
    return typ(*built) if typ is not tuple else tuple(built)


@dataclasses.dataclass
class Graph:
    """One captured step: its graph, static inputs and outputs, and what
    its capture recorded."""
    graph: torch.cuda.CUDAGraph
    static_in: List[torch.Tensor]
    static_out: List[torch.Tensor]
    out_spec: Any
    # output leaf -> input leaf, for outputs that are static inputs
    through: Dict[int, int]
    # per kernel ("k3", "k1", "k2", "merge"): its nodes by wrapper, so the
    # launches of one replay, and the launches of the eager warm-up
    kernel_nodes: Dict[str, Dict[str, int]]
    warmup: Dict[str, Dict[str, int]]
    pool: Tuple[int, int]
    lead: Tuple[int, ...]       # the video axis, () for one video
    capture_s: float            # warm-up and capture, host seconds
    instantiate_s: float
    nodes: Dict[str, int]       # graph nodes by type


# (step function, key) -> its graph; (device, video axis) -> pool handle
_graphs: Dict[tuple, Graph] = {}
_pools: Dict[tuple, Tuple[int, int]] = {}
_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _check(err: int, call: str) -> None:
    if err != 0:
        raise RuntimeError(f"{call} failed: CUresult {err}")


def _graph_nodes(graph: torch.cuda.CUDAGraph
                 ) -> Tuple[Dict[str, int], Dict[str, Dict[str, int]]]:
    """The nodes of a captured (not yet instantiated) graph by type, from
    ``raw_cuda_graph()`` and libcuda's cuGraphGetNodes (the runtime's
    cudaGraphGetNodes), and its K3, K1, K2 and merge kernel nodes by
    wrapper (``{"k3": {...}, "k1": {...}, "k2": {...}, "merge": {...}}``),
    from each kernel node's function
    (cuGraphKernelNodeGetParams) and its name (cuFuncGetName, or
    cuKernelGetName for a library kernel)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cuda.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts: Dict[str, int] = {}
    ours = _zero_counts()
    kind = ctypes.c_int(0)
    params = _KernelNodeParams()
    name = ctypes.c_char_p()
    for node in nodes:
        node = ctypes.c_void_p(node)
        _check(cuda.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        typ = _NODE_TYPES.get(kind.value, "other")
        counts[typ] = counts.get(typ, 0) + 1
        if typ != "kernel":
            continue
        _check(cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        if params.func:
            _check(cuda.cuFuncGetName(ctypes.byref(name),
                                      ctypes.c_void_p(params.func)),
                   "cuFuncGetName")
        else:
            _check(cuda.cuKernelGetName(ctypes.byref(name),
                                        ctypes.c_void_p(params.kern)),
                   "cuKernelGetName")
        for label, mod in _KERNELS.items():
            wrapper = mod.wrapper_of(name.value.decode())
            if wrapper is not None:
                ours[label][wrapper] += 1
    return counts, ours


def _zero_counts() -> Dict[str, Dict[str, int]]:
    return {label: {k: 0 for k in mod.launches}
            for label, mod in _KERNELS.items()}


@contextlib.contextmanager
def _counting_into(counts: Dict[str, Dict[str, int]]) -> Iterator[None]:
    """Each kernel module's wrapper calls into ``counts[label]`` while the
    block runs."""
    with contextlib.ExitStack() as stack:
        for label, mod in _KERNELS.items():
            stack.enter_context(mod.counting_into(counts[label]))
        yield


def _capture(fn: Callable, leaves: List[torch.Tensor], spec,
             pool: Tuple[int, int], lead: Tuple[int, ...],
             device: torch.device) -> Graph:
    """Warm ``fn`` up on the device's side stream, capture it there from
    static copies of ``leaves`` into ``pool``, and instantiate it."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    stream = _streams[device]
    static_in = [t.detach().clone(memory_format=torch.contiguous_format)
                 for t in leaves]
    warm, calls = _zero_counts(), _zero_counts()
    t0 = time.perf_counter()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream), _counting_into(warm):
        fn(*tree_unflatten(spec, static_in))            # warm-up
    torch.cuda.current_stream(device).wait_stream(stream)
    for label, mod in _KERNELS.items():
        for k, n in warm[label].items():
            mod.warmup_launches[k] += n
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, pool=pool, stream=stream), \
            _counting_into(calls):
        out = fn(*tree_unflatten(spec, static_in))
    t1 = time.perf_counter()
    nodes, ours = _graph_nodes(graph)
    if ours != calls:
        raise RuntimeError(f"the captured graph holds the kernel nodes "
                           f"{ours}, but the capture made the wrapper calls "
                           f"{calls}")
    graph.instantiate()
    t2 = time.perf_counter()
    out_leaves, out_spec = tree_flatten(out)
    ids = {id(t): i for i, t in enumerate(static_in)}
    through = {j: ids[id(t)] for j, t in enumerate(out_leaves)
               if id(t) in ids}
    return Graph(graph=graph, static_in=static_in, static_out=out_leaves,
                 out_spec=out_spec, through=through, kernel_nodes=ours,
                 warmup=warm, pool=pool,
                 lead=lead, capture_s=t1 - t0, instantiate_s=t2 - t1,
                 nodes=nodes)


def run_step(fn: Callable, state, image: torch.Tensor, cfg, replay: bool,
             init_rotation: Optional[torch.Tensor]):
    """``fn(state, image, cfg, replay, init_rotation)`` through its
    captured graph, capturing it on the first call of its key.  ``state``
    and ``image`` (and ``init_rotation``, if given) are CUDA tensors on
    one device; returns what ``fn`` returns, every tensor a new one (or
    the caller's own, where the step passes an input through)."""
    leaves, spec = tree_flatten((state, image, init_rotation))
    device = image.device
    sig = tuple((tuple(t.shape), t.dtype) for t in leaves)
    key = (fn, (cfg, replay, init_rotation is not None, spec, sig, device))
    with torch.cuda.device(device):
        g = _graphs.get(key)
        if g is None:
            lead = tuple(state.prev_wrt_kf.shape[:-1])
            if (device, lead) not in _pools:
                _pools[(device, lead)] = torch.cuda.graph_pool_handle()

            def body(state, image, init_rotation):
                return fn(state, image, cfg, replay, init_rotation)

            g = _graphs[key] = _capture(body, leaves, spec,
                                        _pools[(device, lead)], lead, device)
        for dst, src in zip(g.static_in, leaves):
            dst.copy_(src)
        g.graph.replay()
    for label, mod in _KERNELS.items():
        mod.add_launches(g.kernel_nodes[label])
    clones: Dict[int, torch.Tensor] = {}
    out = []
    for j, t in enumerate(g.static_out):
        if j in g.through:
            out.append(leaves[g.through[j]])
        else:
            if id(t) not in clones:
                clones[id(t)] = t.clone()
            out.append(clones[id(t)])
    return tree_unflatten(g.out_spec, out)


def release(lead: Optional[Tuple[int, ...]] = None) -> None:
    """Drop the captured graphs, all of them or those whose states have
    the video axis ``lead`` ((V,), or () for one video), and give their
    pools' memory back to the card.  The graphs stay cached until then,
    as ``jax.jit`` keeps its programs: a process that runs several
    configurations holds one pool per device and video axis."""
    for key in [k for k, g in _graphs.items()
                if lead is None or g.lead == lead]:
        g = _graphs.pop(key)
        g.graph.reset()
    live = {g.pool for g in _graphs.values()}
    for pk in [pk for pk, p in _pools.items() if p not in live]:
        del _pools[pk]
    torch.cuda.empty_cache()


def idle_pool_bytes(device) -> int:
    """Bytes that the live graphs' pools hold on ``device`` and no
    tensor uses: reserved by the caching allocator, but only a capture
    into the pool can use them."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    pools = {tuple(p) for (dev, _), p in _pools.items() if dev == device}
    if not pools:
        return 0
    return sum(seg["total_size"] - seg["allocated_size"]
               for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg.get("segment_pool_id", ())) in pools)


def pool_bytes(pool: Tuple[int, int]) -> int:
    """Bytes the caching allocator holds for a graph pool (its segments
    in ``torch.cuda.memory_snapshot()``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def stats() -> List[dict]:
    """One line per captured graph: the step, its key's config, replay,
    rotation and video axis, capture and instantiate seconds, nodes by
    type, the hand-written kernels' launches a replay and of the warm-up,
    and the pool's bytes."""
    rows = []
    for key, g in _graphs.items():
        fn, (cfg, replay_, rot, _, sig, device) = key
        rows.append(dict(step=fn.__name__.lstrip("_"), replay=replay_,
                         init_rotation=rot, lead=g.lead,
                         device=str(device), capture_s=g.capture_s,
                         instantiate_s=g.instantiate_s, nodes=dict(g.nodes),
                         **{label: dict(g.kernel_nodes[label])
                            for label in _KERNELS},
                         **{f"warmup_{label}": dict(g.warmup[label])
                            for label in _KERNELS},
                         pool=g.pool,
                         pool_bytes=pool_bytes(g.pool), cfg=cfg))
    return rows
