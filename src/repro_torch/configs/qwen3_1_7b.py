"""Qwen3-1.7B — dense GQA with qk_norm [hf:Qwen/Qwen3-1.7B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab_size=151936, head_dim=128, qk_norm=True, tie_embeddings=True,
    # production parallelism (EXPERIMENTS.md §Perf)
    parallelism="fsdp", head_fsdp=False, q_block=512,
    source="hf:Qwen/Qwen3-8B family; hf",
)
