"""gemma2-2b [dense]: local+global alternating attention, logit softcaps,
pre+post block norms, scaled embeddings.  [arXiv:2408.00118; hf]"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab_size=256000, head_dim=256,
    block_pattern=("local", "global"), local_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    mlp_act="gelu", tie_embeddings=True,
    post_norms=True, emb_scale=True,
)
