"""Config registry (the port's copy of repro.configs): the LM archs the
port serves, plus the reduced smoke variants its CPU tests run.

    get_arch("qwen2-1.5b")            # full width
    reduced(get_arch("qwen2-1.5b"))   # 2 layers, d=128 (the tests' size)

The CNN zoo lives in configs/cnn_zoo.py.  Archs join the registry with the
slice that serves them: qwen2-1.5b and gemma2-2b (local ring layers,
softcaps, post-norms, scaled embeddings) on the compiled programs,
falcon-mamba-7b and recurrentgemma-2b (RG-LRU blocks and local ring
attention) on the eager path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.falcon_mamba_7b import ARCH as FALCON_MAMBA_7B
from repro_torch.configs.gemma2_2b import ARCH as GEMMA2_2B
from repro_torch.configs.qwen2_1_5b import ARCH as QWEN2_1_5B
from repro_torch.configs.recurrentgemma_2b import ARCH as RECURRENTGEMMA_2B
from repro_torch.core.config import ArchConfig

ARCHS: Dict[str, ArchConfig] = {a.name: a for a in [
    QWEN2_1_5B, GEMMA2_2B, RECURRENTGEMMA_2B, FALCON_MAMBA_7B]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def reduced(arch: ArchConfig) -> ArchConfig:
    """Same family, tiny dimensions (the reference's `reduced`, over the
    fields the port's ArchConfig has)."""
    n_layers = max(2, len(arch.block_pattern))
    nh = 4
    nkv = max(1, min(arch.n_kv_heads, nh * arch.n_kv_heads // arch.n_heads)) \
        if arch.n_heads >= nh else arch.n_kv_heads
    nkv = max(1, nkv)
    if nh % nkv != 0:
        nkv = 1
    return dataclasses.replace(
        arch,
        name=arch.name + "-smoke",
        n_layers=n_layers,
        d_model=128, n_heads=nh, n_kv_heads=nkv, head_dim=32,
        d_ff=0 if arch.d_ff == 0 else 256,
        vocab_size=512,
        local_window=min(arch.local_window, 64),
        n_experts=min(arch.n_experts, 4) if arch.n_experts else 0,
        encoder_layers=min(arch.encoder_layers, 2),
        lru_width=128 if arch.lru_width else 0,
        max_seq_len=4096,
    )
