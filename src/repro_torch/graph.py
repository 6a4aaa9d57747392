"""Compiled steps on the card: one policy for capturing a step as a CUDA graph.

The reference jits three steps: the join's map -> exchange -> reduce
(`core/executor.py`), the decode step (`serve/serve_step.py`) and the train
step (`train/train_step.py`).  Their counterpart here, on the card with
kernels, is a CUDA graph, and all three follow the policy kept in
`CapturedStep` (no counterpart in the reference):

  * a binding's first call runs eagerly: the warm-up, where each kernel's
    first call happens (library builds and attributes, descriptors and
    tables uploaded, cuBLAS handles, autograd's device threads);
  * its second call captures the step with `torch.cuda.graph` into a memory
    pool and replays it;
  * later calls copy their inputs into the graph's static buffers and
    replay, launching nothing else from the host;
  * a call on another binding runs eagerly and frees the graph, and the
    next call on that binding captures anew.

A binding is where each tensor that the step reads or writes by address
lies (`binding`: the parameters, a cache, optimizer states), with its
shape, strides and dtype, and the shapes and dtypes of the inputs that are
copied in.  A graph holds those addresses, so the step must update what it
is given in place: a capture after which a bound tensor lies elsewhere
raises, as does a capture that fails.  There is no eager fallback.  The
caller keeps its own part: what it binds, what it copies in, and its
copy-on-replay (a replay writes over the graph's outputs, so each caller
says how what it returned survives the next one).  The counters are
`eager_calls`, `captures` and `replays`.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def binding(obj) -> Any:
    """Where each tensor of `obj` (a module's parameters; dicts, tuples and
    lists of tensors; None) lies, with its shape, strides and dtype; other
    leaves as they are.  A graph replays only on an equal binding."""
    if isinstance(obj, torch.nn.Module):
        return tuple(binding(t) for t in obj.parameters())
    if isinstance(obj, dict):
        return tuple((k, binding(v)) for k, v in obj.items())
    if isinstance(obj, (tuple, list)):
        return tuple(binding(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return (obj.data_ptr(), obj.shape, obj.stride(), obj.dtype,
                obj.device)
    return obj


class CapturedStep:
    """`self(bound, inputs)` is `fn(*bound, *inputs)`, eager or a replay
    of a CUDA graph (see the module's docstring).  `bound` is read where it
    lies; `inputs` are copied into static buffers of their shapes and
    dtypes on `device`.  `pool()` gives the memory pool a capture allocates
    from (None: a pool of the graph's own); `before_graph()` runs before
    every capture and replay (the join step gives its live results tensors
    of their own there); `own(out)` is what a graphed call returns of the
    graph's outputs (a copy that no later replay overwrites), the outputs
    themselves by default.  `graphed=False`, or a device other than the
    card, runs every call eagerly."""

    def __init__(self, fn: Callable, device: torch.device, *,
                 pool: Callable[[], Any] | None = None,
                 before_graph: Callable[[], None] | None = None,
                 own: Callable[[Any], Any] | None = None):
        self.fn, self.device = fn, torch.device(device)
        self.pool, self.before_graph, self.own = pool, before_graph, own
        self.eager_calls = self.captures = self.replays = 0
        self.key = self.graph = self.static = self.out = None

    def __call__(self, bound: tuple, inputs: tuple, graphed: bool = True):
        if not (graphed and self.device.type == "cuda"):
            self.eager_calls += 1
            return self.fn(*bound, *inputs)
        key = (binding(bound), tuple((x.shape, x.dtype) for x in inputs))
        if key != self.key:            # a first call, or other tensors
            self.key = key
            self.graph = self.static = self.out = None
            self.eager_calls += 1
            return self.fn(*bound, *inputs)
        if self.before_graph is not None:
            self.before_graph()
        if self.graph is None:
            self.capture(bound, inputs)
        for dst, src in zip(self.static, inputs):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.out if self.own is None else self.own(self.out)

    def capture(self, bound: tuple, inputs: tuple) -> None:
        """Capture `fn(*bound, *static)` into a graph (not run: the next
        replay runs it), with static buffers shaped as `inputs`."""
        before = binding(bound)
        self.static = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                       for x in inputs]
        graph = torch.cuda.CUDAGraph()
        pool = None if self.pool is None else self.pool()
        with torch.cuda.graph(graph, pool=pool):
            self.out = self.fn(*bound, *self.static)
        if binding(bound) != before:
            raise RuntimeError("the step replaced a tensor it was given "
                               "while it was captured; a graph cannot "
                               "hold that step")
        self.graph = graph
        self.captures += 1
