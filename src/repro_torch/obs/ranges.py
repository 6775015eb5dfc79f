"""The port's profiler ranges: a name for each stage of a training step,
free when no profiler records.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler records, and a shared null context otherwise: one flag check.

``stage(name)`` decorates a function that is one stage of the model
(``entry`` and ``halve`` mark a stage written inline). While
a profiler records, the function runs inside ``span(name)`` and the stage
gets a backward half, the range ``backward(name)``. Gradient hooks on the
stage's outputs open it when the first of their gradients arrives; hooks
on the stage's last autograd nodes, those with an edge to an input or to
a leaf (the LoRA leaves), close it once the last of them that the
backward runs has run. So the stage's backward kernels lie inside it,
also where none of its inputs needs a gradient (the first layer's input
comes from the frozen embedding) but its LoRA leaves do. The hooks change
no gradient and no order of the backward: a traced step's graph and
outputs are an untraced one's. With no profiler recording nothing is
registered.

Under remat (non-reentrant checkpoint) a layer's forward ranges recur in
its recompute, inside the layer's backward half; the recompute registers
no hooks, so each backward half occurs once.

The names, in the order a training step meets them (the MoE layer's four
and the kernels' own ranges keep their names in ``models/moe`` and
``kernels/``):
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _profiler

from repro_torch.utils.tree import flatten

TRAIN_STEP = "train step"       # the whole step: the program's step count
EMBED = "embed"                 # no backward half: the table is frozen
BLOCK = "block"                 # a decoder layer; its residual adds
NORM = "norm"
ROPE = "rope"
SSM_MIXER = "ssm mixer"
SSM_CONV = "ssm conv"           # the causal conv and its splits
SSM_GATED_NORM = "ssm gated norm"
LORA_MATMUL = "ops.lora_matmul"
ATTENTION = "ops.attention"
SSD = "ops.ssd"
HEAD = "head"                   # the final norm and the logits
LOSS = "loss"                   # the task loss and the MoE aux loss
OPTIM = "optim"                 # the clip and AdamW
KERNELS_BUILD = "kernels build"  # nvcc, when a kernel is not built yet
KERNELS_LOAD = "kernels load"   # a kernel library's first load

_NULL = contextlib.nullcontext()


def backward(name: str) -> str:
    """The name of a stage's backward half."""
    return f"{name} backward"


def span(name: str):
    """A profiler range while a profiler records, else a null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def _needs_grad(x) -> bool:
    return torch.is_tensor(x) and x.requires_grad


class _BackwardHalf:
    """One stage call's backward half: opened by the first gradient of an
    output, closed after the last of ``last`` (the stage's nodes with an
    edge out of it) that this backward runs."""

    def __init__(self, name: str, outputs: list, last: list):
        self.name, self.last, self.handle, self.left = name, last, None, 0
        for x in outputs:
            # one hook a tensor, opening the halves of the stages that
            # return it outermost first (an inner stage registers first)
            halves = getattr(x, "_backward_halves", None)
            if halves is None:
                halves = x._backward_halves = []
                x.register_hook(functools.partial(_open_all, halves))
            halves.append(self)
        for node in last:
            node.register_hook(self._ran)

    def _open(self):
        if not self.last:             # opened already
            return
        last, self.last = self.last, []
        self.left = sum(map(torch._C._will_engine_execute_node, last))
        if self.left:
            self.handle = torch.ops.profiler._record_function_enter_new(
                self.name, None)

    def _ran(self, grad_inputs, grad_outputs):
        if self.handle is None:
            return
        self.left -= 1
        if not self.left:
            torch.ops.profiler._record_function_exit._RecordFunction(
                self.handle)
            self.handle = None


def _open_all(halves: list, grad) -> None:
    for half in reversed(halves):
        half._open()


def entry(*inputs):
    """Where a stage's backward half will close: the autograd nodes of its
    inputs (tensors, or trees of them) at the stage's start; None unless a
    profiler records under grad mode outside a recompute (which runs
    inside the backward). For a stage written inline::

        with span(name):
            start = entry(x)
            ...
            halve(name, start, y)
    """
    if not (_profiler._is_profiler_enabled and torch.is_grad_enabled()
            and torch._C._current_graph_task_id() == -1):
        return None
    return {x.grad_fn for x in flatten(inputs)[0]
            if _needs_grad(x) and x.grad_fn is not None}


def halve(name: str, start, *outputs) -> None:
    """Gives the stage ``name``, begun at ``start`` (:func:`entry`), the
    backward half between its ``outputs`` and its inputs."""
    if start is None:
        return
    outs = [x for x in flatten(outputs)[0]
            if _needs_grad(x) and x.grad_fn is not None]
    last = _last_nodes(start, outs)
    if last:
        _BackwardHalf(backward(name), outs, last)


def _last_nodes(stop: set, outputs: list) -> list:
    """The autograd nodes between the ``stop`` nodes and ``outputs`` with an
    edge to a stop node or to a leaf."""
    todo = list({x.grad_fn for x in outputs} - stop)
    seen, last = set(todo), []
    while todo:
        node = todo.pop()
        edge_out = False
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if nxt in stop or hasattr(nxt, "variable"):    # a leaf
                edge_out = True
            elif nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
        if edge_out:
            last.append(node)
    return last


def stage(name: str):
    """Decorator: the function is the stage ``name`` (see the module's
    docstring); its arguments are the inputs, its result the outputs."""
    def decorate(fn):
        @functools.wraps(fn)
        def staged(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                start = entry(args, kwargs)
                out = fn(*args, **kwargs)
                halve(name, start, out)
                return out
        return staged
    return decorate
