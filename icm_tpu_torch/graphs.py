"""CUDA graphs: a program captured once and replayed with one launch.

The JAX package answers its host's dispatch cost by compiling a whole
program once (the scan wire, ``icm_tpu/models/scan_codec.py``); on the
card the counterpart of one compiled program is one captured CUDA graph.
:class:`GraphCache` keeps the captured programs of one owner (a codec),
keyed by a static signature the owner gives (shapes, direction, escape
tier) under :func:`weights_version` of the owner's model: the owner
calls :meth:`GraphCache.refresh` before its programs, so that a weight
changed in place or another activation policy captures again instead of
replaying what stale weights computed.

A program is a Python function of tensors that returns a tuple of
tensors. :meth:`GraphCache.run` on the card:

- the first time a key is seen, copies the inputs into static buffers,
  runs the function once launch by launch on a side stream (every kernel
  module is then loaded and every ``cudaFuncSetAttribute`` of the hand
  kernels made, which capture does not allow), captures it into a graph
  with a private memory pool, and records what the capture added to the
  kernels' launch counters;
- then, and on every later call, copies the inputs into the static
  buffers, replays the graph, adds the recorded launches to the counters
  (a replay runs no Python, so the wrappers cannot count it) and returns
  the static outputs. The next replay overwrites them: callers clone what
  they hand out.

A capture that fails raises; there is no fallback. On the CPU, and with
``enabled=False`` on the card, :meth:`GraphCache.run` calls the function
directly: the same launches, one by one.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, Hashable, Sequence, Tuple

import torch

from .coding import device_rans as _rans
from .nn import gdn_fused as _gdn
from .nn import window_attention as _attn
from .nn.layers import activation_dtype

# the launch counters of the hand kernels: Counters keyed by (dtype, head
# width or channels)
_COUNTERS = {"window_attention": _attn.LAUNCHES, "gdn_forward": _gdn.FWD_LAUNCHES,
             "gdn_backward": _gdn.BWD_LAUNCHES}
# and the lane coder's plain integers
_RANS_COUNTERS = ("ENCODE_LAUNCHES", "DECODE_LAUNCHES")


def by_dtype(counter: Counter) -> Counter:
    """A kernel's launches keyed by (dtype, width) -> keyed by dtype."""
    out: Counter = Counter()
    for key, n in counter.items():
        out[key[0]] += n
    return +out


def launch_counts() -> Dict[str, Counter]:
    """A snapshot of every hand kernel's launch counter."""
    snap = {name: c.copy() for name, c in _COUNTERS.items()}
    for name in _RANS_COUNTERS:
        snap[name] = Counter({None: getattr(_rans, name)})
    return snap


def _diff(after: dict, before: dict) -> Dict[str, Counter]:
    return {name: after[name] - before[name] for name in after}


def _add(delta: Dict[str, Counter], sign: int = 1) -> None:
    for name, counts in delta.items():
        for key, n in counts.items():
            if name in _COUNTERS:
                _COUNTERS[name][key] += sign * n
                if _COUNTERS[name][key] == 0:
                    del _COUNTERS[name][key]
            else:
                setattr(_rans, name, getattr(_rans, name) + sign * n)


def weights_version(model: torch.nn.Module) -> tuple:
    """What a captured program of ``model`` depends on beyond its inputs:
    each parameter's version counter and storage, and the activation
    policy. An in-place update or a reload changes it."""
    return (activation_dtype(),) + tuple(
        (p._version, p.data_ptr()) for p in model.parameters())


class _Graphed:
    """One captured program: static inputs, the graph, static outputs."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        self.fn = fn
        self.static_in = [t.clone() for t in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # launch by launch, before capture
            fn(*self.static_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        # capture empties the allocator's cache itself; emptied first, the
        # memory reserved during capture is the graph's own pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(self.graph):
                self.static_out = tuple(fn(*self.static_in))
        finally:
            # the wrappers counted launches that only went into the graph
            self.launches = _diff(launch_counts(), before)
            _add(self.launches, -1)
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def __call__(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        if len(inputs) != len(self.static_in):
            raise ValueError(f"{len(inputs)} inputs for a program of {len(self.static_in)}")
        for dst, src in zip(self.static_in, inputs):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"input {tuple(src.shape)} {src.dtype} for a static "
                                 f"{tuple(dst.shape)} {dst.dtype}")
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        _add(self.launches)
        return self.static_out


class GraphCache:
    """Captured programs by key (see the module docstring). ``enabled``:
    capture and replay on the card; False runs every program launch by
    launch there too (for holding replays against launches)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._graphs: Dict[Hashable, _Graphed] = {}
        self._version = None

    def refresh(self, version: tuple) -> bool:
        """``version``: :func:`weights_version` of the weights the owner's
        programs read. When it differs from the last one, every captured
        program is dropped and True returned: the owner rebuilds what it
        derives from the weights."""
        if version == self._version:
            return False
        self._graphs.clear()
        self._version = version
        return True

    def run(self, key: Hashable, fn: Callable,
            inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)``, replayed from the graph of ``key`` on the card
        (captured at the key's first call)."""
        if not (self.enabled and inputs[0].is_cuda):
            return tuple(fn(*inputs))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graphed(fn, inputs)
        return g(inputs)

    def __len__(self) -> int:
        return len(self._graphs)

    def stats(self) -> Dict[Hashable, dict]:
        """Per key: capture seconds, pool bytes and launches per replay."""
        return {k: {"capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                    "launches": {name: sum(c.values()) for name, c in g.launches.items()
                                 if sum(c.values())}}
                for k, g in self._graphs.items()}

    def graphs(self) -> Dict[Hashable, "_Graphed"]:
        return dict(self._graphs)
