"""Serve-step builders: prefill and batched greedy decode on one device.

`build_decode_step` / `build_prefill` return the functions the serving
engine calls, with the device they run on; they run without autograd, so
a model a trainer has made trainable serves as a frozen one does.  The
reference also builds mesh shardings for parameters and caches; on one
card there are none.

The compiled decode step.  The reference jits its decode step; here, on
the card with `params.use_kernels`, the step is a CUDA graph.  Its first
call runs eagerly (the warm-up: the histogram kernel's build and
attributes, the dispatch plan's tables uploaded), its second captures the
step with `torch.cuda.graph` into a memory pool of its own and replays
it, and later calls copy the tokens and positions into the graph's int32
buffers and replay, launching nothing else from the host.  A graph reads
the tensors it captured by address, so it is bound to the parameters and
the cache it ran on (every family writes its cache in place).  A call on
other tensors (another cache; encdec's `enc_out` or vlm's `vis` replaced
by `api.prefill`) never replays it: that call frees the graph and runs
eagerly, and the next call on the same tensors captures anew.  The step
holds one graph at a time, and its next tokens come back as a fresh
tensor, which no later replay overwrites.  `ServeFns` counts the calls run
eagerly, the captures and the replays.  A capture that fails raises.  The
CPU and the plain versions (`use_kernels=False`) run every call eagerly.
`build_prefill` stays eager (the reference jits it): a prefill's time is
mostly device work, which a graph does not shorten, and a graph for each
prompt shape would pin that shape's activations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..core.executor import resolve_device
from ..models import api


@dataclass
class ServeFns:
    decode: Callable | None
    prefill: Callable | None
    device: torch.device
    batch: int | None = None       # decode: the slots the cache holds
    max_seq: int | None = None     # decode: the cache's length
    compiled: "_Step | None" = None   # decode: its graph and its counters

    @property
    def eager_calls(self) -> int:
        """Decode calls that ran eagerly."""
        return self.compiled.eager_calls

    @property
    def captures(self) -> int:
        """Decode graphs captured."""
        return self.compiled.captures

    @property
    def replays(self) -> int:
        """Decode calls answered by a replay."""
        return self.compiled.replays


class _Step:
    """The decode step, eager or a CUDA graph bound to the tensors it
    captured (see the module's docstring).  `self(bound, inputs, graphed)`
    is `fn(*bound, *inputs)`: on the graph, `bound` (the parameters and
    the cache) is read where it lies and `inputs` (tokens, positions) are
    copied into int32 buffers."""

    def __init__(self, device: torch.device, fn: Callable):
        self.device, self.fn = device, fn
        self.eager_calls = self.captures = self.replays = 0
        self.key = self.graph = self.static = self.out = None

    def __call__(self, bound: tuple, inputs: tuple, graphed: bool
                 ) -> torch.Tensor:
        if not (graphed and self.device.type == "cuda"):
            self.eager_calls += 1
            return self.fn(*bound, *inputs)
        key = (_binding(bound), tuple(x.shape for x in inputs))
        if key != self.key:            # a first call, or other tensors
            self.key = key
            self.graph = self.static = self.out = None
            self.eager_calls += 1
            return self.fn(*bound, *inputs)
        if self.graph is None:
            self._capture(bound)
        for dst, src in zip(self.static, inputs):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.out.clone()

    def _capture(self, bound: tuple) -> None:
        self.static = [torch.empty(shape, dtype=torch.int32,
                                   device=self.device)
                       for shape in self.key[1]]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self.fn(*bound, *self.static)
        if _binding(bound) != self.key[0]:
            raise RuntimeError("the step replaced a tensor it was given "
                               "while it was captured; a graph cannot "
                               "hold that step")
        self.graph = graph
        self.captures += 1


def _binding(obj):
    """Where each tensor of `obj` (a module's parameters; dicts, tuples and
    lists of tensors; None) lies, with its shape, strides and dtype; other
    leaves as they are.  A graph replays only on an equal binding."""
    if isinstance(obj, torch.nn.Module):
        return tuple(_binding(t) for t in obj.parameters())
    if isinstance(obj, dict):
        return tuple((k, _binding(v)) for k, v in obj.items())
    if isinstance(obj, (tuple, list)):
        return tuple(_binding(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return (obj.data_ptr(), obj.shape, obj.stride(), obj.dtype,
                obj.device)
    return obj


def build_decode_step(cfg: ArchConfig, batch: int, max_seq: int, *,
                      device=None) -> ServeFns:
    """decode(params, cache, tokens (B,1), pos (B,)) -> (next token (B,)
    int32, cache): one step of every slot, greedy on the last position.
    The cache (the family's `init_cache` tree for `batch` slots and
    `max_seq` positions) is updated in place; one of other shapes is
    refused.  On the card with kernels the step is a CUDA graph (tokens
    and positions copied into int32 buffers)."""
    dev = resolve_device(device)
    want = cache_shapes(cfg, batch, max_seq)

    def step(params, cache, tokens, pos):
        lg, _ = api.decode_step(params, cfg, cache,
                                {"tokens": tokens.to(dev)}, pos.to(dev))
        # Greedy sampling on the card: serving returns token ids, not logits.
        return torch.argmax(lg[:, -1], dim=-1).to(torch.int32)

    compiled = _Step(dev, step)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        got = cache_shapes_of(cache)
        if not _fits(got, want):
            raise ValueError(f"cache of shapes {got}; the step was built for "
                             f"{batch} slots and {max_seq} positions: {want}")
        return compiled((params, cache), (tokens, pos),
                        params.use_kernels), cache

    return ServeFns(decode=decode, prefill=None, device=dev, batch=batch,
                    max_seq=max_seq, compiled=compiled)


def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The shapes of the family's `init_cache(cfg, batch, max_seq)` tree
    (None where it holds None), from meta tensors."""
    return cache_shapes_of(api.init_cache(cfg, batch, max_seq,
                                          device="meta"))


def cache_shapes_of(cache):
    if isinstance(cache, dict):
        return {k: cache_shapes_of(v) for k, v in cache.items()}
    return None if cache is None else tuple(cache.shape)


def _fits(got, want, key: str = "") -> bool:
    """`got` has `want`'s keys and shapes; the one exception is encdec's
    `enc_out`, whose rows prefill sets to the prompt's S // enc_ratio."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and got.keys() == want.keys()
                and all(_fits(got[k], want[k], k) for k in want))
    if key == "enc_out" and got is not None:
        return got[0] == want[0] and got[2:] == want[2:]
    return got == want


def build_prefill(cfg: ArchConfig, *, device=None) -> ServeFns:
    """prefill(params, batch) -> last-position logits (B, padded_vocab): a
    full forward over the prompts that never makes full-sequence logits."""
    dev = resolve_device(device)
    api.family_module(cfg)

    @torch.no_grad()
    def prefill_fn(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = api.forward(params, cfg, batch, last_only=True)
        return logits[:, -1]

    return ServeFns(decode=None, prefill=prefill_fn, device=dev)
