"""Falcon-Mamba-7B — attention-free Mamba1 [arXiv:2410.05355; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=65024, ssm_state=16, ssm_version=1, ssm_expand=2,
    # production parallelism (EXPERIMENTS.md §Perf)
    head_fsdp=False, microbatches=8,
    source="arXiv:2410.05355; unverified",
)
