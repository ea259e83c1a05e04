"""Granite-3.0-2B — dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=49155, head_dim=64,
    # production parallelism (EXPERIMENTS.md §Perf)
    parallelism="fsdp", head_fsdp=False, q_block=512,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
