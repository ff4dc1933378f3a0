"""DAG modules (``tnn_tpu.nn.graph``): named nodes over named inputs, with
multiple inputs and outputs, and the ``Add`` / ``Concat`` joins.

A ``Graph`` is sorted once at construction (Kahn's algorithm): a cycle,
an input no node or graph input provides, a duplicate node name or an
unknown output raises there with the JAX package's message. The forward
runs the nodes in that order; the parameter and state trees are keyed by
node name, as the JAX graph's are, and the config round trip stores each
node's module config beside its inputs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.module import Module, config_module, register_module


@register_module("add")
class Add(Module):
    """Elementwise n-ary sum of its inputs."""

    def forward(self, *xs, train=False, generator=None):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    def output_shape(self, *input_shapes):
        return tuple(input_shapes[0])


@register_module("concat")
class Concat(Module):
    """Its inputs concatenated along ``axis``."""

    def __init__(self, axis: int = -1, name=None, policy=None):
        super().__init__(name=name, policy=policy)
        self.axis = int(axis)

    def forward(self, *xs, train=False, generator=None):
        return torch.cat(xs, dim=self.axis)

    def output_shape(self, *input_shapes):
        shapes = [list(s) for s in input_shapes]
        ax = self.axis if self.axis >= 0 else len(shapes[0]) + self.axis
        out = list(shapes[0])
        out[ax] = sum(s[ax] for s in shapes)
        return tuple(out)

    def _config(self):
        return {"axis": self.axis}


class GraphNode:
    """One named node: a module and the names of its inputs."""

    def __init__(self, name: str, module: Module, inputs: Sequence[str]):
        self.name = str(name)
        self.module = module
        self.inputs = [str(i) for i in inputs]


@register_module("graph")
class Graph(Module):
    """A DAG of named nodes over the graph's named inputs.

    ``nodes`` holds (name, module, input names) tuples or ``GraphNode``s;
    ``inputs`` names the positional inputs ("input" by default);
    ``outputs`` the returned values (default: every node no other node
    consumes, in declaration order), a tuple when there are several.
    ``build`` takes one input's shape, or a list of shapes for several
    inputs.
    """

    def __init__(self, nodes: Sequence, inputs: Sequence[str] = ("input",),
                 outputs: Optional[Sequence[str]] = None, name=None,
                 policy=None):
        super().__init__(name=name, policy=policy)
        self.nodes: List[GraphNode] = [
            n if isinstance(n, GraphNode) else GraphNode(*n) for n in nodes]
        self.node_modules = nn.ModuleList(n.module for n in self.nodes)
        self.inputs = [str(i) for i in inputs]
        names = [n.name for n in self.nodes]
        dupes = {x for x in names if names.count(x) > 1}
        if dupes or set(names) & set(self.inputs):
            raise ValueError(
                f"duplicate node names: {sorted(dupes) or 'vs inputs'}")
        known = set(self.inputs) | set(names)
        for n in self.nodes:
            missing = [i for i in n.inputs if i not in known]
            if missing:
                raise ValueError(f"node {n.name!r} consumes unknown "
                                 f"{missing}")
        if outputs is None:
            consumed = {i for n in self.nodes for i in n.inputs}
            outputs = [n.name for n in self.nodes if n.name not in consumed]
        self.outputs = [str(o) for o in outputs]
        for o in self.outputs:
            if o not in known:
                raise ValueError(f"unknown output {o!r}")
        self._order = self._toposort()

    def _toposort(self) -> List[GraphNode]:
        by_name = {n.name: n for n in self.nodes}
        indeg = {n.name: sum(1 for i in n.inputs if i in by_name)
                 for n in self.nodes}
        consumers: Dict[str, List[str]] = {}
        for n in self.nodes:
            for i in n.inputs:
                if i in by_name:
                    consumers.setdefault(i, []).append(n.name)
        ready = [n.name for n in self.nodes if indeg[n.name] == 0]
        order = []
        while ready:
            cur = ready.pop(0)
            order.append(by_name[cur])
            for c in consumers.get(cur, ()):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.nodes):
            cyc = sorted(set(by_name) - {n.name for n in order})
            raise ValueError(f"graph has a cycle through {cyc}")
        return order

    def _shapes(self, input_shapes) -> List[Tuple[int, ...]]:
        if len(self.inputs) == 1 and all(isinstance(d, int)
                                         for d in input_shapes):
            input_shapes = [input_shapes]
        if len(input_shapes) != len(self.inputs):
            raise ValueError(f"graph takes {len(self.inputs)} inputs "
                             f"({self.inputs}), got {len(input_shapes)}")
        return [tuple(int(d) for d in s) for s in input_shapes]

    def build(self, input_shape, device):
        self.device = torch.device(device)
        shapes = dict(zip(self.inputs, self._shapes(input_shape)))
        for node in self._order:
            ins = [shapes[i] for i in node.inputs]
            if len(ins) == 1:
                shapes[node.name] = node.module.build(ins[0], self.device)
            else:
                if isinstance(node.module, Graph):
                    node.module.build(ins, self.device)
                node.module.device = self.device
                shapes[node.name] = node.module.output_shape(*ins)
        outs = tuple(shapes[o] for o in self.outputs)
        return outs[0] if len(outs) == 1 else outs

    def init(self, input_shape, *, device="cuda", seed: Optional[int] = 0):
        """``Module.init`` for per-sample shapes: one shape, or a list of
        them for several inputs."""
        from ..utils.device import resolve_device

        shapes = [(1,) + s for s in self._shapes(input_shape)]
        self.build(shapes, resolve_device(device))
        if seed is not None:
            self.init_params(seed)
        return self

    def _param_slots(self):
        for node in self.nodes:
            for path, owner, attr in node.module._param_slots():
                yield (node.name,) + path, owner, attr

    def _state_slots(self):
        for node in self.nodes:
            for path, owner, attr in node.module._state_slots():
                yield (node.name,) + path, owner, attr

    def forward(self, *xs, train=False, generator=None):
        values = dict(zip(self.inputs, xs))
        for node in self._order:
            values[node.name] = node.module(
                *[values[i] for i in node.inputs], train=train,
                generator=generator)
        outs = tuple(values[o] for o in self.outputs)
        return outs[0] if len(outs) == 1 else outs

    def output_shape(self, *input_shapes):
        shapes = dict(zip(self.inputs, input_shapes))
        for node in self._order:
            shapes[node.name] = node.module.output_shape(
                *[tuple(shapes[i]) for i in node.inputs])
        outs = tuple(shapes[o] for o in self.outputs)
        return outs[0] if len(outs) == 1 else outs

    def _config(self):
        return {"nodes": [{"name": n.name, "inputs": n.inputs,
                           "module": n.module.get_config()}
                          for n in self.nodes],
                "inputs": list(self.inputs),
                "outputs": list(self.outputs)}

    @classmethod
    def from_config(cls, cfg):
        cfg = dict(cfg)
        nodes = [GraphNode(d["name"], config_module(d["module"]),
                           d["inputs"]) for d in cfg.pop("nodes")]
        return super().from_config({"nodes": nodes, **cfg})
