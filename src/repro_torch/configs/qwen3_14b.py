"""Qwen3-14B — dense GQA with qk_norm [hf:Qwen/Qwen3-14B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
    vocab_size=151936, head_dim=128, qk_norm=True,
    # production parallelism (EXPERIMENTS.md §Perf)
    parallelism="fsdp", head_fsdp=False, q_block=512,
    source="hf:Qwen/Qwen3-8B family; hf",
)
