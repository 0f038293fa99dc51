"""falcon-mamba-7b [ssm]: attention-free mamba1; d_ff=0 (no MLP blocks);
ssm_state=16.  Sub-quadratic: runs long_500k.  [arXiv:2410.05355; unverified]"""
from repro_torch.core.config import ArchConfig

ARCH = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=65024,
    block_pattern=("mamba",), ssm_state=16, ssm_expand=2, conv_kernel=4,
    tie_embeddings=False, subquadratic=True,
)
