"""din [recsys] — embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
target-attention interaction [arXiv:1706.06978; paper]."""

from repro_torch.models.recsys import DinConfig

FULL = DinConfig(
    name="din", n_items=1_000_000, n_cats=10_000, embed_dim=18, seq_len=100,
    attn_mlp=(80, 40), mlp=(200, 80),
)
