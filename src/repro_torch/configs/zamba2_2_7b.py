"""Zamba2-2.7B — Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_version=2, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6,
    # production parallelism (EXPERIMENTS.md §Perf)
    parallelism="fsdp", head_fsdp=False, q_block=512,
    source="arXiv:2411.15242; hf",
)
