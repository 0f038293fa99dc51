"""Typed op-graph IR, CNN half (the port's copy of repro.compiler.graph).

A flat, topologically ordered tuple of typed op nodes, each naming its
input edges (producer node ids) and the parameter-tree paths it reads.
`build_graph(CNNConfig)` lowers the paper's CNN zoo into it.

Node kinds and the engine that executes them:

  ConvOp    -> Conv PE (im2col GEMM; `first_layer=True` routes the stem to
               the Low-Channel Conv Unit; may carry a fused `Epilogue`)
  DwcOp     -> DWC PE (same optional fused `Epilogue`)
  AddOp     -> MISC core (residual add + NL epilogue)
  PoolOp    -> MISC core ("max" | "avg" | "global")
  ConcatOp  -> bank interleave (channel concat; free at the memory level)
  LinearOp  -> Conv PE (classifier head)
  InputOp   -> the program input placeholder (edge 0: the image)

A node's id doubles as the id of its output edge, so per-edge metadata
(calibrated activation scales) is keyed by node id.  The LM op kinds and
`lower_transformer` come with the LM slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.config import CNNConfig

# A path into the params tree, e.g. ("stages", 2, 0, "w1").
ParamPath = Tuple


@dataclass(frozen=True)
class OpNode:
    id: int
    inputs: Tuple[int, ...]


@dataclass(frozen=True)
class Epilogue:
    """An in-kernel tail fused into a Conv PE / DWC PE launch.

    `passes.fuse_epilogues` collapses Conv/DWC -> {residual Add, pool tail}
    chains into one fused node carrying this spec, so the whole chain is a
    single engine launch.  add=True appends the residual operand as the
    node's LAST input edge; `add_act` is the absorbed AddOp's act.  `pool`
    is an absorbed tail pool ("avg" | "global" | "max").

    `mid_scale` / `add_scale` are the static-plan interior requant points:
    the scales the absorbed conv / add output edges carried in the unfused
    graph.  The fused kernel quantize-dequantizes at exactly those points,
    so fused static execution is bit-identical to the unfused program.
    0.0 = dynamic program (no static plan; the chain stays f32).
    """
    add: bool = False
    add_act: str = "none"
    pool: str = "none"               # none | avg | global | max
    pool_kernel: int = 0
    pool_stride: int = 0
    mid_scale: float = 0.0           # absorbed conv/dwc output edge scale
    add_scale: float = 0.0           # absorbed add output edge scale
                                     # (set only when a pool follows the add)

    @property
    def stages(self) -> str:
        """Human-readable chain, e.g. "add+relu|global"."""
        parts = []
        if self.add:
            parts.append("add" if self.add_act == "none"
                         else f"add+{self.add_act}")
        if self.pool != "none":
            parts.append(self.pool)
        return "|".join(parts)


@dataclass(frozen=True)
class InputOp(OpNode):
    pass


@dataclass(frozen=True)
class ConvOp(OpNode):
    w: ParamPath = ()
    b: Optional[ParamPath] = None
    stride: int = 1
    padding: str = "SAME"
    act: str = "none"
    first_layer: bool = False        # route through the Low-Channel unit
    epilogue: Optional[Epilogue] = None   # fused MISC tail (fuse_epilogues)


@dataclass(frozen=True)
class DwcOp(OpNode):
    w: ParamPath = ()
    b: Optional[ParamPath] = None
    stride: int = 1
    padding: str = "SAME"
    act: str = "none"
    epilogue: Optional[Epilogue] = None   # fused MISC tail (fuse_epilogues)


@dataclass(frozen=True)
class AddOp(OpNode):
    act: str = "none"


@dataclass(frozen=True)
class PoolOp(OpNode):
    pool: str = "max"                # max | avg | global
    kernel: int = 2
    stride: int = 2


@dataclass(frozen=True)
class ConcatOp(OpNode):
    pass                             # channel (last-axis) concat


@dataclass(frozen=True)
class LinearOp(OpNode):
    """Classifier GEMM on the Conv PE."""
    w: ParamPath = ()
    b: Optional[ParamPath] = None
    act: str = "none"
    epilogue: Optional[Epilogue] = None


@dataclass(frozen=True)
class Graph:
    """Topologically ordered op list; nodes[i].id == i."""
    nodes: Tuple[OpNode, ...]
    output: int
    name: str = ""

    def consumers(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {n.id: [] for n in self.nodes}
        for n in self.nodes:
            for i in n.inputs:
                out[i].append(n.id)
        return out

    def count(self, cls) -> int:
        return sum(isinstance(n, cls) for n in self.nodes)


def get_param(params, path: Optional[ParamPath]):
    """Resolve a ParamPath against the (possibly quantized) params tree.
    None (an op with no bias) resolves to None."""
    if path is None:
        return None
    v = params
    for k in path:
        v = v[k]
    return v


class _Builder:
    def __init__(self):
        self.nodes: List[OpNode] = []

    def add(self, cls, inputs, **attrs) -> int:
        nid = len(self.nodes)
        self.nodes.append(cls(id=nid, inputs=tuple(inputs), **attrs))
        return nid


def build_graph(cfg: CNNConfig) -> Graph:
    """Lower a CNNConfig to the engine op-graph.  Channel bookkeeping here
    must match models.cnn.cnn_schema, which owns the parameter shapes."""
    b = _Builder()
    x = b.add(InputOp, [])
    x = b.add(ConvOp, [x], w=("stem_w",), b=("stem_b",),
              stride=cfg.stem_stride, act="relu", first_layer=True)
    ch = cfg.stem_ch
    for si, st in enumerate(cfg.stages):
        for r in range(st.repeat):
            stride = st.stride if r == 0 else 1
            p: ParamPath = ("stages", si, r)
            if st.kind == "conv":
                x = b.add(ConvOp, [x], w=p + ("w",), b=p + ("b",),
                          stride=stride, act="relu")
                ch = st.out_ch
            elif st.kind == "bottleneck":
                h = b.add(ConvOp, [x], w=p + ("w1",), b=p + ("b1",),
                          act="relu")
                h = b.add(ConvOp, [h], w=p + ("w2",), b=p + ("b2",),
                          stride=stride, act="relu")
                h = b.add(ConvOp, [h], w=p + ("w3",), b=p + ("b3",))
                skip = x
                if ch != st.out_ch or stride != 1:
                    skip = b.add(ConvOp, [x], w=p + ("wskip",),
                                 b=p + ("bskip",), stride=stride)
                x = b.add(AddOp, [h, skip], act="relu")
                ch = st.out_ch
            elif st.kind == "inverted":
                h = b.add(ConvOp, [x], w=p + ("we",), b=p + ("be",),
                          act="relu6")
                h = b.add(DwcOp, [h], w=p + ("wd",), b=p + ("bd",),
                          stride=stride, act="relu6")
                h = b.add(ConvOp, [h], w=p + ("wp",), b=p + ("bp",))
                if stride == 1 and ch == st.out_ch:
                    x = b.add(AddOp, [h, x])
                else:
                    x = h
                ch = st.out_ch
            elif st.kind == "dwsep":
                h = b.add(DwcOp, [x], w=p + ("wd",), b=p + ("bd",),
                          stride=stride, act="relu")
                x = b.add(ConvOp, [h], w=p + ("wp",), b=p + ("bp",),
                          act="relu")
                ch = st.out_ch
            elif st.kind == "fire":
                sq = b.add(ConvOp, [x], w=p + ("ws",), b=p + ("bs",),
                           stride=stride, act="relu")
                e1 = b.add(ConvOp, [sq], w=p + ("w1",), b=p + ("b1",),
                           act="relu")
                e3 = b.add(ConvOp, [sq], w=p + ("w3",), b=p + ("b3",),
                           act="relu")
                x = b.add(ConcatOp, [e1, e3])
                ch = st.out_ch
            elif st.kind == "pool":
                x = b.add(PoolOp, [x], pool="max", kernel=st.kernel,
                          stride=st.stride)
            else:
                raise ValueError(f"unknown stage kind {st.kind!r}")
    x = b.add(PoolOp, [x], pool="global")
    x = b.add(LinearOp, [x], w=("head_w",), b=("head_b",))
    return Graph(tuple(b.nodes), output=x, name=cfg.name)
