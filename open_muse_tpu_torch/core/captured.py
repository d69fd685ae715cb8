"""One replayed CUDA graph a call: the port's counterpart of the JAX
package's ``ModelMixin._jit_cache`` / ``jit_apply`` and of the jitted
decode loops and ``compile_text2image``.

``captured(owner, key, fn, *tensors, modules=...)`` runs ``fn(*tensors)``:

- on CPU tensors, eagerly (the route the tests take);
- on CUDA tensors, through a graph cached for ``owner`` under ``key`` (the
  static arguments ``fn`` closes over), the inputs' shapes, dtypes and
  devices, and the device, dtype and ``data_ptr`` of every parameter and
  buffer of ``modules``: a model moved with ``.to()`` or rebuilt captures
  afresh instead of replaying stale pointers (and its old graphs are
  dropped).  The first call copies the inputs into static buffers, runs
  ``fn`` once on a side stream (cuBLAS keeps a workspace a stream; the
  kernels' library is built and loaded there), then captures ``fn`` on that
  stream.  Every call copies its inputs into the static buffers, replays
  the graph and returns clones of the outputs, so that the next replay
  cannot overwrite what a caller holds.  A capture that fails raises: the
  eager body never runs in its place.

``fn`` must do no host work that a replay would skip or freeze: no
``.item()``, no pageable host-to-device copy, no noise drawn on the host.
Each kernel wrapper counts a Python call, and a replay makes none, so the
wrappers' count deltas are recorded at capture and added at every replay:
``kernels.launch_counts()`` stays exact.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from .. import kernels

__all__ = ["captured", "capture_on", "replay", "pointer_key", "graph_count", "last_capture"]

# owner -> {(weights, key): _Graph}
_CACHES: "weakref.WeakKeyDictionary[Any, Dict[tuple, _Graph]]" = weakref.WeakKeyDictionary()
# what the most recent capture recorded: its key, seconds (warm-up included)
# and the wrappers' launches a replay adds
last_capture: Dict[str, Any] = {}


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    outputs: Any
    launches: Dict[str, int]


def _map(fn, obj):
    """``fn`` on every tensor of a tensor / tuple / list / dict / None."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if obj is None:
        return None
    raise TypeError(f"captured functions return tensors, got {type(obj).__name__}")


def pointer_key(tensors) -> tuple:
    """(device, dtype, data_ptr) of every tensor: what a graph reads by
    pointer."""
    return tuple((t.device, t.dtype, t.data_ptr()) for t in tensors)


def weights_key(modules) -> tuple:
    """``pointer_key`` of every parameter and buffer of ``modules``."""
    return pointer_key(t for m in modules for t in (*m.parameters(), *m.buffers()))


def graph_count(owner) -> int:
    """The graphs cached for ``owner``."""
    return len(_CACHES.get(owner, ()))


def capture_on(stream, fn: Callable, what, generators=()):
    """Capture ``fn()`` on ``stream`` (after its warm-up there) into a new
    graph: (graph, outputs, the wrappers' launch counts the capture
    recorded).  The counts are restored, since a capture launches nothing; a
    capture that fails raises, naming ``what``.  ``generators``: CUDA
    generators ``fn`` draws from besides the default one, registered with
    the graph so that every replay draws anew and advances them."""
    before = kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    try:
        for generator in generators:
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, stream=stream):
            outputs = fn()
    except Exception as exc:
        raise RuntimeError(f"CUDA graph capture of {what!r} failed; nothing runs eagerly in "
                           f"its place") from exc
    finally:
        launched = kernels.launch_counts()
        for wrapper in kernels.WRAPPERS:
            wrapper.launches = before[wrapper.__name__]
    torch.cuda.current_stream().wait_stream(stream)
    return graph, outputs, {name: launched[name] - before[name] for name in before
                            if launched[name] != before[name]}


def replay(graph: torch.cuda.CUDAGraph, launches: Dict[str, int]) -> None:
    """Replay ``graph`` and add the launch counts its capture recorded."""
    graph.replay()
    for wrapper in kernels.WRAPPERS:
        wrapper.launches += launches.get(wrapper.__name__, 0)


def _capture(fn, tensors, key) -> _Graph:
    t0 = time.perf_counter()
    inputs = tuple(t.clone(memory_format=torch.contiguous_format) for t in tensors)
    stream = torch.cuda.Stream(device=inputs[0].device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the warm-up launches for real, and counts
        fn(*inputs)
    graph, outputs, delta = capture_on(stream, lambda: fn(*inputs), key)
    last_capture.clear()
    last_capture.update(key=key, seconds=time.perf_counter() - t0, launches=dict(delta))
    return _Graph(graph, inputs, outputs, delta)


def captured(owner, key, fn: Callable, *tensors: torch.Tensor, modules=()):
    """``fn(*tensors)``: eagerly when every tensor lies on the CPU, else by
    replaying the CUDA graph cached for ``owner`` under ``key`` (captured
    on the first call).  ``key`` holds what ``fn`` closes over."""
    if all(t.device.type == "cpu" for t in tensors):
        return fn(*tensors)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"captured {key!r}: inputs on {sorted(map(str, devices))}; pass "
                         f"them all on one CUDA device or all on the CPU")
    weights = weights_key(modules)
    signature = tuple((tuple(t.shape), t.dtype) for t in tensors)
    cache = _CACHES.setdefault(owner, {})
    entry = cache.get((weights, key, signature))
    if entry is None:
        for stale in [k for k in cache if k[0] != weights]:  # moved or rebuilt weights
            del cache[stale]
        entry = cache[(weights, key, signature)] = _capture(fn, tensors, key)
    else:
        for static, t in zip(entry.inputs, tensors):
            static.copy_(t)
    replay(entry.graph, entry.launches)
    return _map(torch.clone, entry.outputs)
