"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
    vocab_size=32000, head_dim=80, sliding_window=4096,
    # production parallelism (EXPERIMENTS.md §Perf)
    parallelism="fsdp", head_fsdp=False, q_block=512,
    source="arXiv:2401.16818; hf",
)
