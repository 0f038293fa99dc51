"""CNN zoo parameter schema (the port's copy of repro.models.cnn.cnn_schema).

Every model lowers through the compiler (repro_torch.compiler) to an engine
op-graph; this module owns the parameter shapes that graph reads.  Stage
kinds: conv, bottleneck, inverted, dwsep, fire, pool (see build_graph).
"""
from __future__ import annotations

from repro_torch.core.config import CNNConfig
from repro_torch.models.params import ParamSpec


def _conv_spec(k: int, ic: int, oc: int) -> ParamSpec:
    return ParamSpec((k, k, ic, oc), "he")


def _bias_spec(oc: int) -> ParamSpec:
    return ParamSpec((oc,), "zeros")


def _dwc_spec(k: int, c: int) -> ParamSpec:
    # depthwise taps: fan-in k*k per channel -> He over the window
    return ParamSpec((k, k, c), "he")


def cnn_schema(cfg: CNNConfig) -> dict:
    s = {"stem_w": ParamSpec((cfg.stem_kernel, cfg.stem_kernel,
                              cfg.input_ch, cfg.stem_ch), "he"),
         "stem_b": _bias_spec(cfg.stem_ch),
         "stages": []}
    ch = cfg.stem_ch
    for st in cfg.stages:
        blocks = []
        for r in range(st.repeat):
            stride = st.stride if r == 0 else 1
            if st.kind == "conv":
                blocks.append({"w": _conv_spec(st.kernel, ch, st.out_ch),
                               "b": _bias_spec(st.out_ch)})
                ch = st.out_ch
            elif st.kind == "bottleneck":
                mid = st.out_ch // 4
                blk = {"w1": _conv_spec(1, ch, mid), "b1": _bias_spec(mid),
                       "w2": _conv_spec(st.kernel, mid, mid),
                       "b2": _bias_spec(mid),
                       "w3": _conv_spec(1, mid, st.out_ch),
                       "b3": _bias_spec(st.out_ch)}
                if ch != st.out_ch or stride != 1:
                    blk["wskip"] = _conv_spec(1, ch, st.out_ch)
                    blk["bskip"] = _bias_spec(st.out_ch)
                blocks.append(blk)
                ch = st.out_ch
            elif st.kind == "inverted":
                mid = ch * st.expand
                blocks.append({"we": _conv_spec(1, ch, mid),
                               "be": _bias_spec(mid),
                               "wd": _dwc_spec(st.kernel, mid),
                               "bd": _bias_spec(mid),
                               "wp": _conv_spec(1, mid, st.out_ch),
                               "bp": _bias_spec(st.out_ch)})
                ch = st.out_ch
            elif st.kind == "dwsep":
                blocks.append({"wd": _dwc_spec(st.kernel, ch),
                               "bd": _bias_spec(ch),
                               "wp": _conv_spec(1, ch, st.out_ch),
                               "bp": _bias_spec(st.out_ch)})
                ch = st.out_ch
            elif st.kind == "fire":
                sq = st.out_ch // 8
                blocks.append({"ws": _conv_spec(1, ch, sq),
                               "bs": _bias_spec(sq),
                               "w1": _conv_spec(1, sq, st.out_ch // 2),
                               "b1": _bias_spec(st.out_ch // 2),
                               "w3": _conv_spec(3, sq, st.out_ch // 2),
                               "b3": _bias_spec(st.out_ch // 2)})
                ch = st.out_ch
            elif st.kind == "pool":
                blocks.append({})
            else:
                raise ValueError(st.kind)
        s["stages"].append(blocks)
    s["head_w"] = ParamSpec((ch, cfg.num_classes))
    s["head_b"] = _bias_spec(cfg.num_classes)
    return s
