"""qwen2-1.5b [dense]: GQA with QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, block_pattern=("global",), mlp_act="silu",
    tie_embeddings=True, rope_theta=1_000_000.0,
)
