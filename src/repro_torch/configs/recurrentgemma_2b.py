"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 2:1 pattern
(two recurrent blocks per local-attention block).  Sub-quadratic: runs
long_500k.  [arXiv:2402.19427; hf]"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("recurrent", "recurrent", "local"),
    local_window=2048, lru_width=2560, conv_kernel=4,
    mlp_act="gelu", tie_embeddings=True, emb_scale=True,
    subquadratic=True,
)
